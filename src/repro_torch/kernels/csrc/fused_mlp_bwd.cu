// Backward of the fused (gated) MLP for NVIDIA Hopper (sm_90a).  It has no
// TPU kernel: it is the counterpart of XLA's autodiff of the reference's
// streamed MLP, src/repro/models/layers.py:531 _mlp_streamed (a scan over
// d_ff tiles).  With x (M, D), Wg / Wu (D, F), Wd (F, D) and the cotangent
// dy (M, D), all of one type (f32 or bf16):
//
//   g = x . Wg, u = x . Wu (recomputed: the forward saves no hidden),
//   dh = dy . Wd^T,
//   gated    h = act(g) u,  du = dh act(g),  dg = dh u act'(g)
//   ungated  h = act(u),    du = dh act'(u)
//   dWd = h^T . dy,  dWu = x^T . du,  dWg = x^T . dg,
//   dx = du . Wu^T + dg . Wg^T,
//
// each gradient in the inputs' type.  Three kernels a call, each a plain
// tiled product whose reduction a block walks in order (no atomics, no
// split: the same inputs give the same bits):
//
//   hidden  one block per (HM rows of M, HN columns of F) tile: g, u and
//           dh over all of D, then h, du and dg written once to a scratch
//           the wrapper allocates (4 bytes an element each);
//   wgrad   one block per output tile (GM x GN) of dWd (F, D), dWu and dWg
//           (D, F), all in one launch, summing over all M rows;
//   dx      one block per output tile of dx (M, D), summing over F (and,
//           gated, over F again for the gate's term).
//
// What bounds it: 12 M D F operations beyond the forward's, 3.34 ms at
// llama3.2-1b's train microbatch (M 16384, D 2048, F 8192) on the bf16
// tensor cores; the recompute of g and u adds 4 M D F.  The scratch adds
// bytes the bound does not count: h, du and dg written once and read once
// each, 1.61 GB at that shape, 0.48 ms at 3.35 TB/s.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, helpers in
// mma_bf16.cuh), operand chunks staged by cp.async STAGES deep.  h, du and
// dg are f32; each enters its products as a bf16 high part and a bf16 low
// part (h - hi), two scratch planes, two mma: any one of them rounded to
// bf16 alone spends 0.15-0.28 of the 1e-2 rule in the CPU emulation
// (chip_smoke.mlp_bwd_split), hi + lo 3e-4.  x, the weights and dy are bf16
// already.  f32 runs on the CUDA cores, so that f32 keeps f32 accuracy
// (TF32 would miss 5e-4): a 64 x 64 output tile a block, 4 x 4 a thread.
//
// Plain C interface (loaded with ctypes): the kernels allocate nothing and
// do not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_act.cuh"
#include "mma_bf16.cuh"

namespace {

using mlp_act::activate;
using mlp_act::activate_grad;
using namespace mma_bf16;

constexpr int THREADS = 256;
constexpr int PAD = 8;   // bf16 of padding a shared row (ldmatrix banks)

struct Dims {
  int M, D, F, act, gated, vec;
};

// g, u, dh of one element -> h, du, dg (dg only gated)
__device__ __forceinline__ void hidden_of(const Dims& p, float gv, float uv,
                                          float dhv, float& h, float& du,
                                          float& dg) {
  if (p.gated) {
    const float a = activate(p.act, gv);
    h = a * uv;
    du = dhv * a;
    dg = dhv * uv * activate_grad(p.act, gv);
  } else {
    h = activate(p.act, uv);
    du = dhv * activate_grad(p.act, uv);
    dg = 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: the hidden kernel
// ---------------------------------------------------------------------------

constexpr int HM = 128, HN = 64;           // rows of M, columns of F a block
constexpr int KC = 32;                     // depth of a staged chunk
constexpr int STAGES = 3;
constexpr int HKP = KC + PAD;              // pitch of x, dy and Wd chunks
constexpr int HNP = HN + PAD;              // pitch of Wu and Wg chunks
constexpr int H_STAGE = 2 * HM * HKP + 2 * KC * HNP + HN * HKP;
constexpr size_t H_SMEM = (size_t)2 * STAGES * H_STAGE;

// planes of the scratch, each M x F: bf16 h hi, h lo, du hi, du lo, dg hi,
// dg lo; f32 h, du, dg
struct Hidden {
  const uint16_t *x, *wg, *wu, *wd, *dy;
  uint16_t* planes;
};

// pairs (e0, e1) of columns (col, col + 1) of row `row` into plane k as hi
// and lo parts
__device__ __forceinline__ void store_hilo(uint16_t* planes, size_t plane,
                                           int k, size_t off, float e0,
                                           float e1, bool pair, bool second) {
  uint32_t hi, lo;
  split2(e0, e1, hi, lo);
  uint16_t* ph = planes + (size_t)(2 * k) * plane + off;
  uint16_t* pl = ph + plane;
  if (pair) {
    *reinterpret_cast<uint32_t*>(ph) = hi;
    *reinterpret_cast<uint32_t*>(pl) = lo;
  } else {
    ph[0] = (uint16_t)(hi & 0xffffu);
    pl[0] = (uint16_t)(lo & 0xffffu);
    if (second) {
      ph[1] = (uint16_t)(hi >> 16);
      pl[1] = (uint16_t)(lo >> 16);
    }
  }
}

// 8 warps as 4 along M x 2 along F: a warp's tile is 32 rows x 32 columns,
// two m16 tiles x four n8 blocks, for each of g, u and dh
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_hidden_mma(const Hidden P, const Dims p) {
  extern __shared__ __align__(16) unsigned char smem_hidden[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_hidden);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int tiles_f = (p.F + HN - 1) / HN;
  const int m0 = (blockIdx.x / tiles_f) * HM;
  const int f0 = (blockIdx.x % tiles_f) * HN;
  const int nk = (p.D + KC - 1) / KC;
  const bool vec = p.vec != 0;

  auto issue = [&](int c) {
    uint16_t* sx = ring + (c % STAGES) * H_STAGE;
    uint16_t* sdy = sx + HM * HKP;
    uint16_t* su = sdy + HM * HKP;
    uint16_t* sg = su + KC * HNP;
    uint16_t* sd = sg + KC * HNP;
    const int k0 = c * KC;
    load_tile<HM, KC, THREADS>(sx, HKP, P.x + (size_t)m0 * p.D + k0, p.D,
                               p.M - m0, p.D - k0, vec, tid);
    load_tile<HM, KC, THREADS>(sdy, HKP, P.dy + (size_t)m0 * p.D + k0, p.D,
                               p.M - m0, p.D - k0, vec, tid);
    load_tile<KC, HN, THREADS>(su, HNP, P.wu + (size_t)k0 * p.F + f0, p.F,
                               p.D - k0, p.F - f0, vec, tid);
    if (p.gated)
      load_tile<KC, HN, THREADS>(sg, HNP, P.wg + (size_t)k0 * p.F + f0, p.F,
                                 p.D - k0, p.F - f0, vec, tid);
    load_tile<HN, KC, THREADS>(sd, HKP, P.wd + (size_t)f0 * p.D + k0, p.D,
                               p.F - f0, p.D - k0, vec, tid);
  };

  float au[2][4][4], ag[2][4][4], ad[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) au[i][j][e] = ag[i][j][e] = ad[i][j][e] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nk) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk c is in; every warp is done with chunk c - 1
    if (c + STAGES - 1 < nk) issue(c + STAGES - 1);
    cp_async_commit();
    const uint16_t* sx = ring + (c % STAGES) * H_STAGE;
    const uint16_t* sdy = sx + HM * HKP;
    const uint16_t* su = sdy + HM * HKP;
    const uint16_t* sg = su + KC * HNP;
    const uint16_t* sd = sg + KC * HNP;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t ax[2][4], ay[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = (wm * 32 + mt * 16) * HKP + kk * 16;
        ldmatrix_a(ax[mt], sx + r, HKP, lane);
        ldmatrix_a(ay[mt], sdy + r, HKP, lane);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int col = wn * 32 + np * 16;
        uint32_t b[4];
        ldmatrix_b_kn(b, su + kk * 16 * HNP + col, HNP, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(au[mt][2 * np], ax[mt], b[0], b[1]);
          mma(au[mt][2 * np + 1], ax[mt], b[2], b[3]);
        }
        if (p.gated) {
          ldmatrix_b_kn(b, sg + kk * 16 * HNP + col, HNP, lane);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(ag[mt][2 * np], ax[mt], b[0], b[1]);
            mma(ag[mt][2 * np + 1], ax[mt], b[2], b[3]);
          }
        }
        ldmatrix_b_nk(b, sd + col * HKP + kk * 16, HKP, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(ad[mt][2 * np], ay[mt], b[0], b[1]);
          mma(ad[mt][2 * np + 1], ay[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const size_t plane = (size_t)p.M * p.F;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * 32 + mt * 16 + g + 8 * hf;
        const int col = f0 + wn * 32 + nb * 8 + 2 * t4;
        if (row >= p.M || col >= p.F) continue;
        float h[2], du[2], dg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          hidden_of(p, ag[mt][nb][2 * hf + e], au[mt][nb][2 * hf + e],
                    ad[mt][nb][2 * hf + e], h[e], du[e], dg[e]);
        const size_t off = (size_t)row * p.F + col;
        const bool second = col + 1 < p.F, pair = vec && second;
        store_hilo(P.planes, plane, 0, off, h[0], h[1], pair, second);
        store_hilo(P.planes, plane, 1, off, du[0], du[1], pair, second);
        if (p.gated)
          store_hilo(P.planes, plane, 2, off, dg[0], dg[1], pair, second);
      }
}

// ---------------------------------------------------------------------------
// bf16 route: the weight-gradient and dx products
// ---------------------------------------------------------------------------

constexpr int GM = 128, GN = 128;          // an output tile
// a chunk of A or B in either layout: (tile x KC) or (KC x tile), padded
constexpr int G_OPND = (GM * (KC + PAD) > KC * (GM + PAD)) ? GM * (KC + PAD)
                                                           : KC * (GM + PAD);
constexpr int G_STAGE = 4 * G_OPND;        // A hi, A lo, B hi, B lo
constexpr size_t G_SMEM = (size_t)2 * STAGES * G_STAGE;
static_assert(GM == GN, "one operand size for A and B");

// one term of a product: sum over k of A[m, k] B[k, n]; a_lo / b_lo are
// the low planes of an f32 operand carried as hi + lo (else null).  A is
// stored (rows x k) or, A_KM, (k x rows); B (k x cols) or, B_NK,
// (cols x k); ld in elements
struct Term {
  const void *a, *a_lo, *b, *b_lo;
  long long lda, ldb;
};

// out (rows x cols, leading dimension ldc) = the sum of its terms; its
// tiles are the blocks first_tile .. first_tile + tiles - 1 of the launch
struct Problem {
  Term t[2];
  int nterms, rows, cols, k, tiles_n, first_tile;
  void* out;
  long long ldc;
};

struct Problems {
  Problem q[3];
  int count, vec;
};

__device__ __forceinline__ int problem_of(const Problems& Q) {
  int i = 0;
  while (i + 1 < Q.count && (int)blockIdx.x >= Q.q[i + 1].first_tile) ++i;
  return i;
}

// one output tile of a problem of Q.  8 warps as 2 along the rows x 4 along
// the columns: a warp's tile is 64 x 32, four m16 tiles x four n8 blocks
template <bool A_KM, bool B_NK>
__device__ __forceinline__ void gemm_mma(const Problems& Q, uint16_t* ring) {
  const Problem& P = Q.q[problem_of(Q)];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int tile = (int)blockIdx.x - P.first_tile;
  const int m0 = (tile / P.tiles_n) * GM, n0 = (tile % P.tiles_n) * GN;
  const int nk = (P.k + KC - 1) / KC;
  const int total = P.nterms * nk;
  const bool vec = Q.vec != 0;
  constexpr int AP = A_KM ? GM + PAD : KC + PAD;   // pitches
  constexpr int BP = B_NK ? KC + PAD : GN + PAD;

  auto load_a = [&](uint16_t* dst, const uint16_t* a, long long ld, int k0) {
    if constexpr (A_KM)
      load_tile<KC, GM, THREADS>(dst, AP, a + (size_t)k0 * ld + m0, ld,
                                 P.k - k0, P.rows - m0, vec, tid);
    else
      load_tile<GM, KC, THREADS>(dst, AP, a + (size_t)m0 * ld + k0, ld,
                                 P.rows - m0, P.k - k0, vec, tid);
  };
  auto load_b = [&](uint16_t* dst, const uint16_t* b, long long ld, int k0) {
    if constexpr (B_NK)
      load_tile<GN, KC, THREADS>(dst, BP, b + (size_t)n0 * ld + k0, ld,
                                 P.cols - n0, P.k - k0, vec, tid);
    else
      load_tile<KC, GN, THREADS>(dst, BP, b + (size_t)k0 * ld + n0, ld,
                                 P.k - k0, P.cols - n0, vec, tid);
  };
  auto issue = [&](int c) {
    const Term& T = P.t[c / nk];
    const int k0 = (c % nk) * KC;
    uint16_t* st = ring + (c % STAGES) * G_STAGE;
    load_a(st, static_cast<const uint16_t*>(T.a), T.lda, k0);
    if (T.a_lo != nullptr)
      load_a(st + G_OPND, static_cast<const uint16_t*>(T.a_lo), T.lda, k0);
    load_b(st + 2 * G_OPND, static_cast<const uint16_t*>(T.b), T.ldb, k0);
    if (T.b_lo != nullptr)
      load_b(st + 3 * G_OPND, static_cast<const uint16_t*>(T.b_lo), T.ldb,
             k0);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < total) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < total) issue(c + STAGES - 1);
    cp_async_commit();
    const Term& T = P.t[c / nk];
    const bool alo = T.a_lo != nullptr, blo = T.b_lo != nullptr;
    const uint16_t* sa = ring + (c % STAGES) * G_STAGE;
    const uint16_t* sb = sa + 2 * G_OPND;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t b[2][4], bl[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int col = wn * 32 + np * 16;
        const int at = B_NK ? col * BP + kk * 16 : kk * 16 * BP + col;
        if constexpr (B_NK) {
          ldmatrix_b_nk(b[np], sb + at, BP, lane);
          if (blo) ldmatrix_b_nk(bl[np], sb + G_OPND + at, BP, lane);
        } else {
          ldmatrix_b_kn(b[np], sb + at, BP, lane);
          if (blo) ldmatrix_b_kn(bl[np], sb + G_OPND + at, BP, lane);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm * 64 + mt * 16;
        const int at = A_KM ? kk * 16 * AP + row : row * AP + kk * 16;
        uint32_t a[4], al[4];
        if constexpr (A_KM) {
          ldmatrix_a_trans(a, sa + at, AP, lane);
          if (alo) ldmatrix_a_trans(al, sa + G_OPND + at, AP, lane);
        } else {
          ldmatrix_a(a, sa + at, AP, lane);
          if (alo) ldmatrix_a(al, sa + G_OPND + at, AP, lane);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma(acc[mt][2 * np], a, b[np][0], b[np][1]);
          mma(acc[mt][2 * np + 1], a, b[np][2], b[np][3]);
          if (alo) {
            mma(acc[mt][2 * np], al, b[np][0], b[np][1]);
            mma(acc[mt][2 * np + 1], al, b[np][2], b[np][3]);
          }
          if (blo) {
            mma(acc[mt][2 * np], a, bl[np][0], bl[np][1]);
            mma(acc[mt][2 * np + 1], a, bl[np][2], bl[np][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  uint16_t* out = static_cast<uint16_t*>(P.out);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * hf;
        const int col = n0 + wn * 32 + nb * 8 + 2 * t4;
        if (row >= P.rows || col >= P.cols) continue;
        const uint32_t pk =
            pack_bf16x2(acc[mt][nb][2 * hf], acc[mt][nb][2 * hf + 1]);
        uint16_t* o = out + (size_t)row * P.ldc + col;
        if (vec && col + 1 < P.cols) {
          *reinterpret_cast<uint32_t*>(o) = pk;
        } else {
          o[0] = (uint16_t)(pk & 0xffffu);
          if (col + 1 < P.cols) o[1] = (uint16_t)(pk >> 16);
        }
      }
}

// dWd = h^T dy, dWu = x^T du, dWg = x^T dg: A and B both stored (k x ...)
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_wgrad_mma(const Problems Q) {
  extern __shared__ __align__(16) unsigned char smem_wgrad[];
  gemm_mma<true, false>(Q, reinterpret_cast<uint16_t*>(smem_wgrad));
}

// dx = du Wu^T + dg Wg^T: A stored (rows x k), B (cols x k)
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_dx_mma(const Problems Q) {
  extern __shared__ __align__(16) unsigned char smem_dx[];
  gemm_mma<false, true>(Q, reinterpret_cast<uint16_t*>(smem_dx));
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores, a 64 x 64 tile a block, 4 x 4 a thread
// ---------------------------------------------------------------------------

constexpr int FT = 64;        // the tile, both ways, of every f32 kernel
constexpr int FK = 16;        // depth of a chunk
constexpr int FP = FT + 4;    // pitch of a shared row (float4-aligned)

// a (FK x FT) chunk of a row-major matrix into s[k][i]: element (i, k) of
// the tile at `src` + i * ld_i + k * ld_k, zeros past (lim_i, lim_k);
// k_fast: neighbouring threads take neighbouring k (k contiguous in
// memory), else neighbouring i
__device__ __forceinline__ void load_f32(float* s, const float* src,
                                         long long ld_i, long long ld_k,
                                         int lim_i, int lim_k, bool k_fast,
                                         int tid) {
  for (int e = tid; e < FK * FT; e += THREADS) {
    const int k = k_fast ? e % FK : e / FT;
    const int i = k_fast ? e / FK : e % FT;
    s[k * FP + i] = (i < lim_i && k < lim_k)
                        ? src[(size_t)i * ld_i + (size_t)k * ld_k]
                        : 0.f;
  }
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float* a,
                                       const float* b) {
  const float4 av = *reinterpret_cast<const float4*>(a);
  const float4 bv = *reinterpret_cast<const float4*>(b);
  const float ar[4] = {av.x, av.y, av.z, av.w};
  const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
}

struct HiddenF32 {
  const float *x, *wg, *wu, *wd, *dy;
  float* planes;   // h, du, dg
};

__global__ void __launch_bounds__(THREADS)
mlp_bwd_hidden_f32(const HiddenF32 P, const Dims p) {
  __shared__ __align__(16) float sx[FK * FP], sdy[FK * FP], su[FK * FP],
      sg[FK * FP], sd[FK * FP];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles_f = (p.F + FT - 1) / FT;
  const int m0 = (blockIdx.x / tiles_f) * FT;
  const int f0 = (blockIdx.x % tiles_f) * FT;
  float au[4][4] = {}, ag[4][4] = {}, ad[4][4] = {};
  for (int k0 = 0; k0 < p.D; k0 += FK) {
    __syncthreads();
    load_f32(sx, P.x + (size_t)m0 * p.D + k0, p.D, 1, p.M - m0, p.D - k0,
             true, tid);
    load_f32(sdy, P.dy + (size_t)m0 * p.D + k0, p.D, 1, p.M - m0, p.D - k0,
             true, tid);
    load_f32(su, P.wu + (size_t)k0 * p.F + f0, 1, p.F, p.F - f0, p.D - k0,
             false, tid);
    if (p.gated)
      load_f32(sg, P.wg + (size_t)k0 * p.F + f0, 1, p.F, p.F - f0, p.D - k0,
               false, tid);
    load_f32(sd, P.wd + (size_t)f0 * p.D + k0, p.D, 1, p.F - f0, p.D - k0,
             true, tid);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < FK; ++k) {
      fma4x4(au, sx + k * FP + ty * 4, su + k * FP + tx * 4);
      if (p.gated) fma4x4(ag, sx + k * FP + ty * 4, sg + k * FP + tx * 4);
      fma4x4(ad, sdy + k * FP + ty * 4, sd + k * FP + tx * 4);
    }
  }
  const size_t plane = (size_t)p.M * p.F;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = f0 + tx * 4 + j;
      if (row >= p.M || col >= p.F) continue;
      float h, du, dg;
      hidden_of(p, ag[i][j], au[i][j], ad[i][j], h, du, dg);
      const size_t off = (size_t)row * p.F + col;
      P.planes[off] = h;
      P.planes[plane + off] = du;
      if (p.gated) P.planes[2 * plane + off] = dg;
    }
}

template <bool A_KM, bool B_NK>
__device__ __forceinline__ void gemm_f32(const Problems& Q, float* sa,
                                         float* sb) {
  const Problem& P = Q.q[problem_of(Q)];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tile = (int)blockIdx.x - P.first_tile;
  const int m0 = (tile / P.tiles_n) * FT, n0 = (tile % P.tiles_n) * FT;
  float acc[4][4] = {};
  for (int t = 0; t < P.nterms; ++t) {
    const float* a = static_cast<const float*>(P.t[t].a);
    const float* b = static_cast<const float*>(P.t[t].b);
    const long long lda = P.t[t].lda, ldb = P.t[t].ldb;
    for (int k0 = 0; k0 < P.k; k0 += FK) {
      __syncthreads();
      if (A_KM)
        load_f32(sa, a + (size_t)k0 * lda + m0, 1, lda, P.rows - m0,
                 P.k - k0, false, tid);
      else
        load_f32(sa, a + (size_t)m0 * lda + k0, lda, 1, P.rows - m0,
                 P.k - k0, true, tid);
      if (B_NK)
        load_f32(sb, b + (size_t)n0 * ldb + k0, ldb, 1, P.cols - n0,
                 P.k - k0, true, tid);
      else
        load_f32(sb, b + (size_t)k0 * ldb + n0, 1, ldb, P.cols - n0,
                 P.k - k0, false, tid);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < FK; ++k)
        fma4x4(acc, sa + k * FP + ty * 4, sb + k * FP + tx * 4);
    }
  }
  float* out = static_cast<float*>(P.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < P.rows && col < P.cols)
        out[(size_t)row * P.ldc + col] = acc[i][j];
    }
}

__global__ void __launch_bounds__(THREADS)
mlp_bwd_wgrad_f32(const Problems Q) {
  __shared__ __align__(16) float sa[FK * FP], sb[FK * FP];
  gemm_f32<true, false>(Q, sa, sb);
}

__global__ void __launch_bounds__(THREADS)
mlp_bwd_dx_f32(const Problems Q) {
  __shared__ __align__(16) float sa[FK * FP], sb[FK * FP];
  gemm_f32<false, true>(Q, sa, sb);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int tiles(int rows, int cols, int tm, int tn) {
  return ((rows + tm - 1) / tm) * ((cols + tn - 1) / tn);
}

// appends a problem of `nterms` terms to Q, its tiles after the last one's
Problem& add(Problems& Q, int rows, int cols, int k, void* out,
             long long ldc, int tile) {
  Problem& P = Q.q[Q.count];
  P = Problem{};
  P.rows = rows; P.cols = cols; P.k = k; P.out = out; P.ldc = ldc;
  P.tiles_n = (cols + tile - 1) / tile;
  P.first_tile = Q.count == 0 ? 0
                              : Q.q[Q.count - 1].first_tile +
                                    tiles(Q.q[Q.count - 1].rows,
                                          Q.q[Q.count - 1].cols, tile, tile);
  ++Q.count;
  return P;
}

int total_tiles(const Problems& Q, int tile) {
  const Problem& L = Q.q[Q.count - 1];
  return L.first_tile + tiles(L.rows, L.cols, tile, tile);
}

template <typename K>
int launch_dyn(K kern, size_t smem, int grid, cudaStream_t s,
               const Problems& Q) {
  kern<<<grid, THREADS, smem, s>>>(Q);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores).  act: 0
// silu, 1 gelu (tanh), 2 relu, 3 squared relu.  wg and dwg may be null when
// gated is 0.  hidden holds (gated ? 3 : 2) x M x F x 4 bytes: bf16 the hi
// and lo planes of h, du (and dg); f32 h, du (and dg).  Launches the hidden
// kernel, the weight-gradient kernel and the dx kernel on `stream`, in
// that order.
extern "C" int fused_mlp_bwd_launch(
    const void* x, const void* wg, const void* wu, const void* wd,
    const void* dy, void* dx, void* dwg, void* dwu, void* dwd, void* hidden,
    int dtype, int M, int D, int F, int act, int gated, void* stream) {
  if (M < 1 || D < 1 || F < 1 || act < 0 || act > 3 ||
      (dtype != 0 && dtype != 1) || hidden == nullptr ||
      (gated && (wg == nullptr || dwg == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dims p;
  p.M = M; p.D = D; p.F = F; p.act = act; p.gated = gated ? 1 : 0;
  const size_t plane = (size_t)M * F;
  const int tile = dtype == 1 ? GM : FT;
  const int hm = dtype == 1 ? HM : FT, hn = dtype == 1 ? HN : FT;
  const long long hidden_tiles = (long long)((M + hm - 1) / hm) *
                                 ((F + hn - 1) / hn);
  const long long dx_tiles = (long long)((M + tile - 1) / tile) *
                             ((D + tile - 1) / tile);
  if (hidden_tiles > 2147483647LL || dx_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;

  // the scratch's planes: bf16 hi / lo pairs, f32 one each
  const int per = dtype == 1 ? 2 : 1;
  const size_t esize = dtype == 1 ? 2 : 4;
  char* base = static_cast<char*>(hidden);
  auto plane_ptr = [&](int k, int part) -> void* {
    return base + ((size_t)k * per + part) * plane * esize;
  };
  auto lo = [&](int k) -> const void* {
    return dtype == 1 ? plane_ptr(k, 1) : nullptr;
  };

  // the weight gradients: dWd (F, D) = h^T dy; dWu (D, F) = x^T du; dWg
  // (D, F) = x^T dg — A stored (k x rows), B (k x cols)
  Problems W{};
  {
    Problem& P = add(W, F, D, M, dwd, D, tile);
    P.nterms = 1;
    P.t[0] = Term{plane_ptr(0, 0), lo(0), dy, nullptr, F, D};
  }
  for (int k = 1; k <= (gated ? 2 : 1); ++k) {
    Problem& P = add(W, D, F, M, k == 1 ? dwu : dwg, F, tile);
    P.nterms = 1;
    P.t[0] = Term{x, nullptr, plane_ptr(k, 0), lo(k), D, F};
  }
  // dx (M, D) = du Wu^T + dg Wg^T — A stored (rows x k), B (cols x k)
  Problems X{};
  {
    Problem& P = add(X, M, D, F, dx, D, tile);
    P.nterms = gated ? 2 : 1;
    P.t[0] = Term{plane_ptr(1, 0), lo(1), wu, nullptr, F, F};
    if (gated) P.t[1] = Term{plane_ptr(2, 0), lo(2), wg, nullptr, F, F};
  }

  if (dtype == 1) {
    // 16-byte pieces need rows of whole pieces and 16-byte aligned bases
    const uintptr_t bases =
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wg) |
        reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
        reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
        reinterpret_cast<uintptr_t>(dwg) | reinterpret_cast<uintptr_t>(dwu) |
        reinterpret_cast<uintptr_t>(dwd) | reinterpret_cast<uintptr_t>(hidden);
    p.vec = D % 8 == 0 && F % 8 == 0 && (bases & 15) == 0;
    W.vec = X.vec = p.vec;
    static const cudaError_t a0 = cudaFuncSetAttribute(
        mlp_bwd_hidden_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)H_SMEM);
    static const cudaError_t a1 = cudaFuncSetAttribute(
        mlp_bwd_wgrad_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G_SMEM);
    static const cudaError_t a2 = cudaFuncSetAttribute(
        mlp_bwd_dx_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G_SMEM);
    if (a0 != cudaSuccess) return (int)a0;
    if (a1 != cudaSuccess) return (int)a1;
    if (a2 != cudaSuccess) return (int)a2;
    Hidden H{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wg),
             static_cast<const uint16_t*>(wu), static_cast<const uint16_t*>(wd),
             static_cast<const uint16_t*>(dy), static_cast<uint16_t*>(hidden)};
    if (!gated) H.wg = H.wu;   // never read
    mlp_bwd_hidden_mma<<<(int)hidden_tiles, THREADS, H_SMEM, s>>>(H, p);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    rc = launch_dyn(mlp_bwd_wgrad_mma, G_SMEM, total_tiles(W, tile), s, W);
    if (rc) return rc;
    return launch_dyn(mlp_bwd_dx_mma, G_SMEM, total_tiles(X, tile), s, X);
  }
  p.vec = 0;
  HiddenF32 H{static_cast<const float*>(x), static_cast<const float*>(wg),
              static_cast<const float*>(wu), static_cast<const float*>(wd),
              static_cast<const float*>(dy), static_cast<float*>(hidden)};
  if (!gated) H.wg = H.wu;     // never read
  mlp_bwd_hidden_f32<<<(int)hidden_tiles, THREADS, 0, s>>>(H, p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = launch_dyn(mlp_bwd_wgrad_f32, 0, total_tiles(W, tile), s, W);
  if (rc) return rc;
  return launch_dyn(mlp_bwd_dx_f32, 0, total_tiles(X, tile), s, X);
}

extern "C" const char* fused_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
