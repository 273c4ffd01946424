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
//   hidden  one block per (rows of M, columns of F) tile: g, u and dh over
//           all of D, then h, du and dg written once to a scratch the
//           wrapper allocates (4 bytes an element each);
//   wgrad   one block per output tile of dWd, dWu and dWg, all in one
//           launch, summing over all M rows;
//   dx      one block per output tile of dx (M, D), summing over F (and,
//           gated, over F again for the gate's term).
//
// What bounds it: 12 M D F operations beyond the forward's, 3.34 ms at
// llama3.2-1b's train microbatch (M 16384, D 2048, F 8192) on the bf16
// tensor cores; the recompute of g and u adds 4 M D F.  The scratch adds
// bytes the bound does not count: h, du and dg written once and read once
// each, 1.61 GB at that shape, 0.48 ms at 3.35 TB/s.  h, du and dg are f32
// and enter every bf16 product as a bf16 high part and a bf16 low part (h -
// hi), two scratch planes, two products into one f32 accumulator: any one
// of them rounded to bf16 alone spends 0.15-0.28 of the 1e-2 rule in the
// CPU emulation (chip_smoke.mlp_bwd_split), hi + lo 3e-4.  So the products
// do 26 M D F operations of tensor-core work with the lo parts.
//
// Three routes, the planner's (dse.plan_mlp_bwd_blocks):
//
//   wgmma      bf16 where TMA can read every operand (D and F multiples of
//              8, bases 16-byte aligned).  Each block is a producer
//              warpgroup, whose one thread keeps TMA loads of 64-deep
//              chunks in flight into a ring of 128-byte-swizzled slots
//              (mbarrier full / empty pairs), and two consumer warpgroups
//              issuing wgmma.mma_async on the slots as they land, reading
//              every operand where it lies (K-major or MN-major; no
//              transposed copy; helpers in wgmma_bf16.cuh).  hidden: a
//              128 x 64 tile (64 x 64 a consumer; g, u, dh: 96 accumulator
//              registers), 4 slots; h, du and dg formed in registers
//              (the activation and its derivative from one sigmoid or
//              tanh: computing each alone, two expf and two correctly
//              rounded divisions an element, took 2.5 of the kernel's 6
//              ms), staged swizzled in shared memory as the six planes
//              and stored by TMA.  wgrad: C[f, d] = sum over the
//              rows of A[m, f] B[m, d] for (A, B) = (h, dy) -> dWd, (du, x)
//              -> dWu^T, (dg, x) -> dWg^T, 128 x 256 tiles (64 x 256 a
//              consumer: 128 accumulator registers), A and B MN-major, 3
//              slots; dx: 128 x 256 tiles of (M, D), A (du, dg) and B (Wu,
//              Wg) K-major, 3 slots.  Tiles and slots as timed on an H100
//              (scripts/mlp_bwd_variants.py, which builds the alternatives
//              from this source): the hidden kernel's 4 slots beat 3 by
//              2-5 %; its 128 x 128 tile lost 23-25 % with 32-deep chunks
//              (5 slots) and with 64-deep ones (2 slots); the products'
//              2 slots and one group left in flight were level or slower.
//   mma        bf16 shapes TMA cannot describe: mma.sync m16n8k16 (helpers
//              in mma_bf16.cuh), operand chunks staged by cp.async STAGES
//              deep, one block of 8 warps an SM.
//   cuda_core  f32, so that f32 keeps f32 accuracy (TF32 would miss 5e-4):
//              a 64 x 64 output tile a block, 4 x 4 a thread.
//
// x, the weights and dy are bf16 already on both bf16 routes.
//
// Plain C interface (loaded with ctypes): the kernels allocate nothing and
// do not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_act.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using mlp_act::activate_and_grad;
using namespace mma_bf16;
namespace wg = wgmma_bf16;

constexpr int THREADS = 256;
constexpr int PAD = 8;   // bf16 of padding a shared row (ldmatrix banks)

struct Dims {
  int M, D, F, act, gated, vec;
};

// g, u, dh of one element -> h, du, dg (dg only gated)
__device__ __forceinline__ void hidden_of(const Dims& p, float gv, float uv,
                                          float dhv, float& h, float& du,
                                          float& dg) {
  float a, da;
  if (p.gated) {
    activate_and_grad(p.act, gv, a, da);
    h = a * uv;
    du = dhv * a;
    dg = dhv * uv * da;
  } else {
    activate_and_grad(p.act, uv, a, da);
    h = a;
    du = dhv * da;
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
// bf16 route "wgmma": warp-specialised blocks, TMA into a ring, wgmma
// ---------------------------------------------------------------------------
//
// A block is three warpgroups: warpgroup 0 is the producer (one thread
// issues every TMA load, the rest idle on 40 registers), warpgroups 1 and 2
// the consumers (232 registers each), each owning 64 rows of the block's
// tile.  The ring's slots have a `full` barrier (the producer's expected
// bytes landed) and an `empty` one (each of the 8 consumer warps done with
// the slot: its wgmma of the slot waited for).  A consumer waits for each
// chunk's products before it releases the chunk's slot (timed against
// keeping one group in flight: 1 % faster, and simpler); the other
// consumer's products keep the tensor cores busy meanwhile.

constexpr int WG_THREADS = 384;            // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int BK = 64;                     // k of a chunk: one 128-byte row
constexpr int ROW_BYTES = BK * 2;
constexpr int SLAB = 64 * ROW_BYTES;       // a 64-row box, 8 KB
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// the hidden kernel: HWM rows of M (64 a consumer) x HWN columns of F, its
// chunks HBK deep (rows of H_ROW bytes, swizzled over H_ROW)
constexpr int HWM = 128, HWN = 64;
constexpr int HBK = 64;
constexpr int H_STAGES = 4;
constexpr int H_ROW = HBK * 2;
// x and dy (HWM x HBK, K-major), Wu and Wg (HBK x HWN, MN-major: boxes of
// HBK x HBK, H_WBOX bytes), Wd (HWN x HBK, K-major)
constexpr int H_X = HWM * H_ROW, H_W = HWN * H_ROW, H_WBOX = HBK * H_ROW;
constexpr int H_STAGE_BYTES = 2 * H_X + 3 * H_W;
// the epilogue stages six planes of 64 x HWN a consumer in the ring
constexpr int H_OUT_BYTES = 2 * 6 * (HWN / 64) * SLAB;
constexpr int H_RING = H_STAGES * H_STAGE_BYTES > H_OUT_BYTES
                           ? H_STAGES * H_STAGE_BYTES
                           : H_OUT_BYTES;
constexpr size_t H_WG_SMEM = (size_t)H_RING + 1024;

// the product kernels: an output tile of GWM x GWN (64 x GWN a consumer)
constexpr int GWM = 128, GWN = 256;
constexpr int G_STAGES = 3;
// A hi and A lo (GWM x BK), B (GWN x BK), either layout
constexpr int G_A = GWM * ROW_BYTES, G_B = GWN * ROW_BYTES;
constexpr int G_STAGE_BYTES = 2 * G_A + G_B;
constexpr size_t G_WG_SMEM = (size_t)G_STAGES * G_STAGE_BYTES + 1024;

// tiles of rows_t x cols_t walked in bands of `group` row tiles (all of a
// band's column tiles, row tile fastest), so that a wave of blocks shares
// both operands in L2
__device__ __forceinline__ void band_order(int b, int rows_t, int cols_t,
                                           int group, int& tr, int& tc) {
  const int per = group * cols_t, band = b / per, first = band * group;
  const int rows = min(group, rows_t - first), in = b - band * per;
  tr = first + in % rows;
  tc = in / rows;
}

template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
}

// the producer's wait for slot c % STAGES to be free (every chunk before
// c that used it consumed)
template <int STAGES>
__device__ __forceinline__ void wait_slot(uint64_t* empty, int c) {
  if (c >= STAGES) wg::mbar_wait(&empty[c % STAGES], ((c / STAGES) - 1) & 1);
}

// a consumer warp's release of slot c % STAGES
template <int STAGES>
__device__ __forceinline__ void release_slot(uint64_t* empty, int c) {
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&empty[c % STAGES]);
}

struct HiddenMaps {
  CUtensorMap x, dy;        // (M, D): boxes HWM x HBK
  CUtensorMap wu, wg;       // (D, F): boxes HBK x HBK
  CUtensorMap wd;           // (F, D): boxes HWN x HBK
  CUtensorMap planes;       // (planes, M, F): boxes 1 x 64 x 64, stored
};

// GATED a template parameter: every wgmma of a k step is issued
// unconditionally
template <bool GATED>
__global__ void __launch_bounds__(WG_THREADS, 1)
mlp_bwd_hidden_wgmma(const __grid_constant__ HiddenMaps T, const Dims p) {
  extern __shared__ unsigned char smem_hw[];
  __shared__ __align__(8) uint64_t full[H_STAGES], empty[H_STAGES];
  unsigned char* ring = wg::align1024(smem_hw);
  const int tid = threadIdx.x, wgi = tid / 128;
  int tm, tf;
  band_order((int)blockIdx.x, (p.M + HWM - 1) / HWM, (p.F + HWN - 1) / HWN,
             8, tm, tf);
  const int m0 = tm * HWM, f0 = tf * HWN;
  const int nk = (p.D + HBK - 1) / HBK;
  init_ring<H_STAGES>(full, empty);

  if (wgi == 0) {
    wg::regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      const uint32_t bytes = H_STAGE_BYTES - (GATED ? 0 : H_W);
      for (int c = 0; c < nk; ++c) {
        wait_slot<H_STAGES>(empty, c);
        unsigned char* st = ring + (c % H_STAGES) * H_STAGE_BYTES;
        uint64_t* bar = &full[c % H_STAGES];
        const int k0 = c * HBK;
        wg::mbar_expect_tx(bar, bytes);
        wg::tma_load_2d(st, T.x, bar, k0, m0);
        wg::tma_load_2d(st + H_X, T.dy, bar, k0, m0);
        for (int j = 0; j < HWN / HBK; ++j) {
          wg::tma_load_2d(st + 2 * H_X + j * H_WBOX, T.wu, bar,
                          f0 + HBK * j, k0);
          if (GATED)
            wg::tma_load_2d(st + 2 * H_X + H_W + j * H_WBOX, T.wg, bar,
                            f0 + HBK * j, k0);
        }
        wg::tma_load_2d(st + 2 * H_X + 2 * H_W, T.wd, bar, k0, f0);
      }
    }
    return;
  }

  wg::regs_inc<CONSUMER_REGS>();
  const int w = wgi - 1;                 // rows 64 w .. of the tile
  // the accumulators start at each one's first product (scale_d 0): no
  // instruction but a wgmma ever defines them inside the loop
  constexpr int R = HWN / 2;             // accumulator registers of each
  float au[R], ag[R], ad[R];
  for (int c = 0; c < nk; ++c) {
    wg::mbar_wait(&full[c % H_STAGES], (c / H_STAGES) & 1);
    const unsigned char* st = ring + (c % H_STAGES) * H_STAGE_BYTES;
    // K-major: 8 rows an atom (SBO), a k16 step 32 bytes into the row;
    // MN-major: boxes of HBK columns H_WBOX apart (LBO), 8 k an atom, a k16
    // step 16 rows
    constexpr uint32_t SBO = 8 * H_ROW, MN_STEP = 16 * H_ROW;
    const uint64_t dx = wg::make_desc<H_ROW>(st + w * 64 * H_ROW, 16, SBO);
    const uint64_t ddy =
        wg::make_desc<H_ROW>(st + H_X + w * 64 * H_ROW, 16, SBO);
    const uint64_t du = wg::make_desc<H_ROW>(st + 2 * H_X, H_WBOX, SBO);
    const uint64_t dg =
        wg::make_desc<H_ROW>(st + 2 * H_X + H_W, H_WBOX, SBO);
    const uint64_t dd = wg::make_desc<H_ROW>(st + 2 * H_X + 2 * H_W, 16, SBO);
    wg::fence_regs(au);
    wg::fence_regs(ag);
    wg::fence_regs(ad);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HBK / 16; ++kk) {
      const uint64_t ak = wg::desc_advance(dx, 32 * kk);
      const int scale = c > 0 || kk > 0;
      wg::wgmma_m64<HWN, 0, 1>(au, ak, wg::desc_advance(du, MN_STEP * kk),
                               scale);
      if constexpr (GATED)
        wg::wgmma_m64<HWN, 0, 1>(ag, ak, wg::desc_advance(dg, MN_STEP * kk),
                                 scale);
      wg::wgmma_m64<HWN, 0, 0>(ad, wg::desc_advance(ddy, 32 * kk),
                               wg::desc_advance(dd, 32 * kk), scale);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(au);
    wg::fence_regs(ag);
    wg::fence_regs(ad);
    release_slot<H_STAGES>(empty, c);
  }

  // h, du, dg as hi and lo planes, staged 128-byte swizzled in the ring
  // (every consumer is past its last read of it) and stored by TMA
  wg::named_sync(1, 2 * 128);
  constexpr int nplanes = GATED ? 6 : 4, boxes = HWN / 64;
  unsigned char* stage = ring + (size_t)w * 6 * boxes * SLAB;
  const int lane = tid & 31, r0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < HWN / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf, col = 8 * j + 2 * q;
      float h[2], du[2], dg[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        hidden_of(p, ag[4 * j + 2 * hf + e], au[4 * j + 2 * hf + e],
                  ad[4 * j + 2 * hf + e], h[e], du[e], dg[e]);
      // plane k's box of this column at stage + (k * boxes + box) * SLAB
      unsigned char* at =
          stage + (col / 64) * SLAB + wg::swizzle128(r, col % 64);
      uint32_t hi, lo;
      split2(h[0], h[1], hi, lo);
      *reinterpret_cast<uint32_t*>(at + 0 * boxes * SLAB) = hi;
      *reinterpret_cast<uint32_t*>(at + 1 * boxes * SLAB) = lo;
      split2(du[0], du[1], hi, lo);
      *reinterpret_cast<uint32_t*>(at + 2 * boxes * SLAB) = hi;
      *reinterpret_cast<uint32_t*>(at + 3 * boxes * SLAB) = lo;
      if constexpr (GATED) {
        split2(dg[0], dg[1], hi, lo);
        *reinterpret_cast<uint32_t*>(at + 4 * boxes * SLAB) = hi;
        *reinterpret_cast<uint32_t*>(at + 5 * boxes * SLAB) = lo;
      }
    }
  wg::fence_async_shared();
  wg::named_sync(2 + w, 128);
  if ((tid & 127) == 0) {
    for (int k = 0; k < nplanes; ++k)
      for (int b = 0; b < boxes; ++b)
        wg::tma_store_3d(T.planes, stage + (k * boxes + b) * SLAB,
                         f0 + 64 * b, m0 + 64 * w, k);
    wg::tma_store_commit_and_wait();
  }
}

// the weight-gradient and dx products on one pattern: out (rows x D) =
// the sum over terms of A_t . B_t, each A an f32 operand as a bf16 hi and
// a bf16 lo plane; dx is one problem of one or two terms (du against Wu,
// dg against Wg; A (M, F) and B (D, F) both K-major), the weight gradients
// two or three problems of one term (C[f, d] = sum over rows of A[m, f]
// B[m, d]: h against dy -> dWd, du and dg against x -> dWu^T, dWg^T; A and
// B both MN-major).  Maps and outputs are indexed problem + term.
struct GemmMaps {
  CUtensorMap a_hi[3], a_lo[3], b[3];
};

struct GemmArgs {
  void* out[3];
  int transposed[3];        // out[d * rows + r] instead of out[r * D + d]
  int problems, terms, rows, cols, k;
};

// one output tile of a problem; `ring` the kernel's dynamic shared memory,
// full / empty its G_STAGES barriers
template <bool MN>
__device__ __forceinline__ void gemm_wgmma(const GemmMaps& T,
                                           const GemmArgs& P,
                                           unsigned char* smem,
                                           uint64_t* full, uint64_t* empty) {
  unsigned char* ring = wg::align1024(smem);
  const int tid = threadIdx.x, wgi = tid / 128;
  const int tiles_r = (P.rows + GWM - 1) / GWM;
  const int tiles_c = (P.cols + GWN - 1) / GWN;
  const int prob = (int)blockIdx.x / (tiles_r * tiles_c);
  const int tile = (int)blockIdx.x - prob * tiles_r * tiles_c;
  const int r0 = (tile / tiles_c) * GWM, n0 = (tile % tiles_c) * GWN;
  const int nk = (P.k + BK - 1) / BK;
  const int total = P.terms * nk;
  init_ring<G_STAGES>(full, empty);

  if (wgi == 0) {
    wg::regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      for (int c = 0; c < total; ++c) {
        wait_slot<G_STAGES>(empty, c);
        const int t = prob + c / nk, k0 = (c % nk) * BK;
        unsigned char* st = ring + (c % G_STAGES) * G_STAGE_BYTES;
        uint64_t* bar = &full[c % G_STAGES];
        wg::mbar_expect_tx(bar, G_STAGE_BYTES);
        if constexpr (MN) {
          for (int j = 0; j < GWM / 64; ++j) {
            wg::tma_load_2d(st + j * SLAB, T.a_hi[t], bar, r0 + 64 * j, k0);
            wg::tma_load_2d(st + G_A + j * SLAB, T.a_lo[t], bar, r0 + 64 * j,
                            k0);
          }
          for (int j = 0; j < GWN / 64; ++j)
            wg::tma_load_2d(st + 2 * G_A + j * SLAB, T.b[t], bar,
                            n0 + 64 * j, k0);
        } else {
          wg::tma_load_2d(st, T.a_hi[t], bar, k0, r0);
          wg::tma_load_2d(st + G_A, T.a_lo[t], bar, k0, r0);
          wg::tma_load_2d(st + 2 * G_A, T.b[t], bar, k0, n0);
        }
      }
    }
    return;
  }

  wg::regs_inc<CONSUMER_REGS>();
  const int w = wgi - 1;                 // rows 64 w .. of the tile
  constexpr uint32_t LBO = MN ? SLAB : 16;
  constexpr uint32_t STEP = MN ? 2048 : 32;   // bytes of a k16 step
  float acc[128];              // defined by its first product (scale_d 0)
  for (int c = 0; c < total; ++c) {
    wg::mbar_wait(&full[c % G_STAGES], (c / G_STAGES) & 1);
    const unsigned char* st = ring + (c % G_STAGES) * G_STAGE_BYTES;
    const uint64_t ahi = wg::make_desc(st + w * SLAB, LBO, 1024);
    const uint64_t alo = wg::make_desc(st + G_A + w * SLAB, LBO, 1024);
    const uint64_t b = wg::make_desc(st + 2 * G_A, LBO, 1024);
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t bk = wg::desc_advance(b, STEP * kk);
      wg::wgmma_m64n256<MN, MN>(acc, wg::desc_advance(ahi, STEP * kk), bk,
                                c > 0 || kk > 0);
      wg::wgmma_m64n256<MN, MN>(acc, wg::desc_advance(alo, STEP * kk), bk,
                                1);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    release_slot<G_STAGES>(empty, c);
  }

  uint16_t* out = static_cast<uint16_t*>(P.out[prob]);
  const bool tr = P.transposed[prob] != 0;
  const int lane = tid & 31, q = lane & 3;
  const int row0 = r0 + 64 * w + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < GWN / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + 8 * hf, col = n0 + 8 * j + 2 * q;
      if (r >= P.rows || col >= P.cols) continue;   // cols % 8 == 0
      const uint32_t v = pack_bf16x2(acc[4 * j + 2 * hf],
                                     acc[4 * j + 2 * hf + 1]);
      if (tr) {
        out[(size_t)col * P.rows + r] = (uint16_t)(v & 0xffffu);
        out[(size_t)(col + 1) * P.rows + r] = (uint16_t)(v >> 16);
      } else {
        *reinterpret_cast<uint32_t*>(out + (size_t)r * P.cols + col) = v;
      }
    }
}

// dWd = h^T dy, dWu = x^T du, dWg = x^T dg (A and B MN-major)
__global__ void __launch_bounds__(WG_THREADS, 1)
mlp_bwd_wgrad_wgmma(const __grid_constant__ GemmMaps T, const GemmArgs P) {
  extern __shared__ unsigned char smem_ww[];
  __shared__ __align__(8) uint64_t full[G_STAGES], empty[G_STAGES];
  gemm_wgmma<true>(T, P, smem_ww, full, empty);
}

// dx = du Wu^T + dg Wg^T (A and B K-major)
__global__ void __launch_bounds__(WG_THREADS, 1)
mlp_bwd_dx_wgmma(const __grid_constant__ GemmMaps T, const GemmArgs P) {
  extern __shared__ unsigned char smem_xw[];
  __shared__ __align__(8) uint64_t full[G_STAGES], empty[G_STAGES];
  gemm_wgmma<false>(T, P, smem_xw, full, empty);
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

// the wgmma route's three launches: tensor maps for this call's pointers,
// then hidden, weight gradients, dx.  planes(k, part): the scratch's plane
// of operand k (h, du, dg), part 0 hi, 1 lo
template <typename PlanePtr>
int launch_wgmma(const void* x, const void* wg_, const void* wu,
                 const void* wd, const void* dy, void* dx, void* dwg,
                 void* dwu, void* dwd, void* hidden, PlanePtr planes,
                 const Dims& p, cudaStream_t s) {
  static const cudaError_t a0 = cudaFuncSetAttribute(
      mlp_bwd_hidden_wgmma<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)H_WG_SMEM);
  static const cudaError_t a3 = cudaFuncSetAttribute(
      mlp_bwd_hidden_wgmma<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)H_WG_SMEM);
  static const cudaError_t a1 = cudaFuncSetAttribute(
      mlp_bwd_wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G_WG_SMEM);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      mlp_bwd_dx_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G_WG_SMEM);
  if (a0 != cudaSuccess) return (int)a0;
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  if (a3 != cudaSuccess) return (int)a3;
  const int M = p.M, D = p.D, F = p.F, gated = p.gated;
  if (!gated) wg_ = wu;                  // never read
  int rc = 0;
  auto map = [&](CUtensorMap* m, const void* base, int rows, int cols,
                 int box_rows, int box_cols = BK) {
    if (rc == 0)
      rc = (int)wg::bf16_map_2d(m, base, rows, cols, box_rows, box_cols);
  };

  HiddenMaps H;
  map(&H.x, x, M, D, HWM, HBK);
  map(&H.dy, dy, M, D, HWM, HBK);
  map(&H.wu, wu, D, F, HBK, HBK);
  map(&H.wg, wg_, D, F, HBK, HBK);
  map(&H.wd, wd, F, D, HWN, HBK);
  if (rc == 0) {
    const uint64_t dims[3] = {(uint64_t)F, (uint64_t)M,
                              (uint64_t)(gated ? 6 : 4)};
    const uint64_t strides[2] = {(uint64_t)F * 2, (uint64_t)M * F * 2};
    const uint32_t box[3] = {64, 64, 1};
    rc = (int)wg::bf16_map(&H.planes, hidden, 3, dims, strides, box);
  }
  if (rc) return rc;
  const long long hidden_tiles = (long long)((M + HWM - 1) / HWM) *
                                 ((F + HWN - 1) / HWN);
  if (gated)
    mlp_bwd_hidden_wgmma<true>
        <<<(int)hidden_tiles, WG_THREADS, H_WG_SMEM, s>>>(H, p);
  else
    mlp_bwd_hidden_wgmma<false>
        <<<(int)hidden_tiles, WG_THREADS, H_WG_SMEM, s>>>(H, p);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  // weight gradients: C[f, d] = sum over the M rows of A[m, f] B[m, d]
  GemmMaps W;
  GemmArgs WA{};
  WA.problems = gated ? 3 : 2;
  WA.terms = 1;
  WA.rows = F; WA.cols = D; WA.k = M;
  void* outs[3] = {dwd, dwu, dwg};
  for (int t = 0; t < WA.problems; ++t) {
    map(&W.a_hi[t], planes(t, 0), M, F, 64);
    map(&W.a_lo[t], planes(t, 1), M, F, 64);
    map(&W.b[t], t == 0 ? dy : x, M, D, 64);
    WA.out[t] = outs[t];
    WA.transposed[t] = t == 0 ? 0 : 1;
  }
  if (rc) return rc;
  const int wgrad_tiles = WA.problems * ((F + GWM - 1) / GWM) *
                          ((D + GWN - 1) / GWN);
  mlp_bwd_wgrad_wgmma<<<wgrad_tiles, WG_THREADS, G_WG_SMEM, s>>>(W, WA);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  // dx = du Wu^T (+ dg Wg^T): the terms walked in turn
  GemmMaps X;
  GemmArgs XA{};
  XA.problems = 1;
  XA.terms = gated ? 2 : 1;
  XA.rows = M; XA.cols = D; XA.k = F;
  XA.out[0] = dx;
  for (int t = 0; t < XA.terms; ++t) {
    map(&X.a_hi[t], planes(1 + t, 0), M, F, GWM);
    map(&X.a_lo[t], planes(1 + t, 1), M, F, GWM);
    map(&X.b[t], t == 0 ? wu : wg_, D, F, GWN);
  }
  if (rc) return rc;
  const long long dx_tiles = (long long)((M + GWM - 1) / GWM) *
                             ((D + GWN - 1) / GWN);
  mlp_bwd_dx_wgmma<<<(int)dx_tiles, WG_THREADS, G_WG_SMEM, s>>>(X, XA);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  route (the planner's): 0 cuda_core
// (f32, CUDA cores), 1 mma (bf16, mma.sync), 2 wgmma (bf16, wgmma fed by
// TMA: D and F multiples of 8, every base 16-byte aligned).  act: 0 silu,
// 1 gelu (tanh), 2 relu, 3 squared relu.  wg and dwg may be null when
// gated is 0.  hidden holds (gated ? 3 : 2) x M x F x 4 bytes: bf16 the hi
// and lo planes of h, du (and dg); f32 h, du (and dg).  Launches the hidden
// kernel, the weight-gradient kernel and the dx kernel on `stream`, in
// that order.  A route the dtype or the shape does not take is refused
// (cudaErrorInvalidValue), never replaced by another.
extern "C" int fused_mlp_bwd_launch(
    const void* x, const void* wg, const void* wu, const void* wd,
    const void* dy, void* dx, void* dwg, void* dwu, void* dwd, void* hidden,
    int dtype, int route, int M, int D, int F, int act, int gated,
    void* stream) {
  if (M < 1 || D < 1 || F < 1 || act < 0 || act > 3 ||
      (dtype != 0 && dtype != 1) || hidden == nullptr ||
      (gated && (wg == nullptr || dwg == nullptr)) ||
      (dtype == 0 ? route != 0 : route != 1 && route != 2))
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
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wg) |
      reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
      reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
      reinterpret_cast<uintptr_t>(dwg) | reinterpret_cast<uintptr_t>(dwu) |
      reinterpret_cast<uintptr_t>(dwd) | reinterpret_cast<uintptr_t>(hidden);
  // TMA's rule, the planner's (dse.plan_mlp_bwd_blocks): 16-byte row
  // strides and bases
  const bool tma_ok = D % 8 == 0 && F % 8 == 0 && (bases & 15) == 0;
  if (route == 2) {
    if (!tma_ok) return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, wg, wu, wd, dy, dx, dwg, dwu, dwd, hidden,
                        plane_ptr, p, s);
  }

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
    p.vec = tma_ok;
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
