// Mamba-2 SSD (state-space duality) chunked scan for NVIDIA Hopper
// (sm_90a).  Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py:26
// _ssd_kernel.  Per tile of QT positions (cum_t = sum_{i<=t} dt_i a,
// within the tile):
//
//   y_intra[t] = sum_{s<=t} exp(cum_t - cum_s) dt_s (c_t . b_s) x_s
//   y_inter[t] = exp(cum_t) c_t . S
//   S         <- exp(cum_last) S + sum_s exp(cum_last - cum_s) dt_s x_s (x) b_s
//
// x (B, L, H, P) and b, c (B, L, N) in T (f32 or bf16), with the strides
// of their batch and position axes given (the model hands in column
// slices of one projection, so nothing is copied); dt (B, L, H) and
// a (H,) f32; init state (B, H, P, N) f32.  y (B, L, H, P) in T (the sum
// is f32, rounded once), final state (B, H, P, N) f32.  For training the
// caller may pass a states buffer (B, H, n_tiles, P, N) f32: the kernel
// then writes the state entering each of its tiles, which the backward
// (mamba2_ssd_bwd.cu) reads -- the SSD's counterpart of attention's lse.
// Serving passes none and runs an instantiation without the write
// (SAVE = false).
//
// Both routes keep the TPU kernel's walk: one block owns a (batch, head)
// (or HB heads of one batch row) and walks the positions a tile at a time
// -- the sequential chunk grid axis becomes this loop -- so x, b, c and
// dt are read once, y is written once and the state never leaves the
// chip.  The chunked scan is exact for any chunk length, so the tile does
// not depend on the caller's chunk; a ragged last tile is masked (dt, x,
// b and c read as 0 past L, which leaves cum and the state untouched).
// exp(cum_t - cum_s) is taken only for s <= t (above the diagonal it
// would overflow for a decaying a and is not needed).
//
// What bounds it: at mamba2-1.3b prefill (B 4, L 1024, H 64, P 64, N 128)
// a call moves about 87 MB and does about 10 GFLOP, so the card's bound
// is bytes (26 us at 3.35 TB/s).  A block's walk is serial, so what
// bounds a kernel is the latency of one tile's chain of products.
//
// bf16 (mamba2_ssd_mma_kernel): every product of a tile runs on the
// tensor cores, mma.sync m16n8k16 bf16 -> f32 (helpers in mma_bf16.cuh).
// 256 threads (8 warps) per head; P and N are held padded with zeros to
// 64 and 128.
//   c.b^T   c and b are bf16 inputs: exact products, f32 sums.  A warp
//           owns 16 rows t and walks 16-column chunks of s <= t (the
//           wholly masked chunks above the diagonal are skipped).
//   gating  G = (c.b^T) exp(cum_t - cum_s) dt_s stays in the warp's
//           accumulator registers, f32, and becomes the A operand of
//           G.x as a bf16 high part plus a bf16 low part (G - hi): two
//           mma, 16 significant bits.
//   y       acc = c.S^T over N (S as hi + lo parts in shared memory),
//           scaled by exp(cum_t) row by row, then acc += G.x.
//   state   the (P, N) f32 state lives in mma accumulator registers for
//           the whole walk (a warp owns 16 x 64 of it, 32 floats a
//           thread): each tile scales it by exp(cum_last) and adds
//           (x w)^T . b, where x^T comes from ldmatrix.trans, is scaled
//           by w_s = dt_s exp(cum_last - cum_s) in f32 and enters as
//           hi + lo.  It reaches shared memory only as hi/lo bf16, the B
//           operand of the next tile's carried term.  The initial state
//           is read once and the final state written once, in f32.
// Each f32 operand enters as hi + lo because bf16 alone costs too much.
// Emulated on the CPU at mamba2-1.3b's widths against the reference, two
// seeded draws (tests/test_torch_mamba2_ssd.py): rounding G to bf16 alone
// puts y at 1.9-2.1x its tolerance, S alone y at 0.9-1.3x, x w alone the
// state at 3.2-4.9x; with every operand as hi + lo, y uses 0.57-0.60 of
// its tolerance (one bf16 step of y) and the state 0.004-0.008.
// exp is the fast one, __expf (ex2.approx of x log2 e; 2 + 1.17 |x| ulp,
// so about 1e-5 relative at |x| = 100), far inside what bf16 operands
// allow.
// The next tile's x, b, c (16-byte cp.async rows of the strided column
// slices) and dt (4-byte cp.async) stream into a second buffer while this
// tile computes; an unaligned stride or pointer takes the element path of
// mma_bf16.cuh's tile loader instead.  The cumulative sums, exp and the
// gating stay f32 on the CUDA cores.  HB heads per block (one 8-warp
// group each) share the b and c tiles (ngroups = 1).
//
// f32 (mamba2_ssd_kernel): the CUDA cores, so that f32 keeps f32 accuracy.
// 256 threads as 16 x 16 (ty, tx), thread (ty, tx) owning rows ty + 16 i
// and columns tx + 16 j of each small matrix product out of shared
// memory (row operand broadcast, column operand on distinct banks: rows
// of c, b and S have an odd pitch); the state lives in shared memory; 32
// positions a tile, so two blocks share an SM.  The causal half of c.b^T
// is skipped where a whole 16 x 16 sub-tile lies above the diagonal.
//
// Plain C interface (loaded with ctypes): the kernels allocate nothing
// and do not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for

// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------

constexpr int GROUP = 256;        // threads per head: 8 warps
constexpr int PP = 64;            // head dim as the tiles hold it
constexpr int NN = 128;           // state dim as the tiles hold it
constexpr int CPITCH = NN + 8;    // bf16 row pitch of the c, b and state tiles
constexpr int XPITCH = PP + 8;    // bf16 row pitch of the x tile

struct MmaParams {
  int L, H, P, N, head_groups, vec_x, vec_bc;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

// bytes of shared memory, and where each tile lies
template <int QT, int HB>
struct MmaSmem {
  static constexpr int CB = QT * CPITCH;           // one c or b tile
  static constexpr int XT = QT * XPITCH;           // one x tile
  static constexpr int ST = PP * CPITCH;           // the state's hi or lo
  // c and b, two stages each, shared by the block's heads
  static constexpr size_t SHARED = 2 * 2 * (size_t)CB * 2;
  // per head: x (two stages), the state's hi and lo, dt (two stages),
  // cum, exp(cum), w, exp(cum_last) padded to 16 bytes
  static constexpr size_t HEAD = (2 * (size_t)XT + 2 * (size_t)ST) * 2 +
                                 5 * (size_t)QT * 4 + 16;
  static constexpr size_t BYTES = SHARED + HB * HEAD;
};

// 4 bytes global -> shared, asynchronously (dt: one float a position)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
}

// the thread's state fragments -> hi and lo tiles in shared memory
__device__ __forceinline__ void write_state(uint16_t* shi, uint16_t* slo,
                                            const float (&st)[8][4], int row,
                                            int col) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t hi, lo;
      split2(st[j][2 * half], st[j][2 * half + 1], hi, lo);
      const int off = (row + 8 * half) * CPITCH + col + 8 * j;
      *reinterpret_cast<uint32_t*>(shi + off) = hi;
      *reinterpret_cast<uint32_t*>(slo + off) = lo;
    }
}

template <int QT, int HB, bool SAVE>
__global__ void __launch_bounds__(GROUP * HB, 2 / HB)
mamba2_ssd_mma_kernel(const uint16_t* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const uint16_t* __restrict__ bm,
                      const uint16_t* __restrict__ cm,
                      const float* __restrict__ s0,
                      uint16_t* __restrict__ y, float* __restrict__ sf,
                      float* __restrict__ states, const MmaParams p) {
  constexpr int MT = QT / 16;     // 16-row m-tiles of a position tile
  constexpr int YN = MT;          // 8-column n-tiles of y a warp owns
  constexpr int PER = QT / 32;    // positions a lane in the scan
  using S = MmaSmem<QT, HB>;
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  uint16_t* cs0 = reinterpret_cast<uint16_t*>(ssd_smem);  // [2][QT][CPITCH]
  uint16_t* bs0 = cs0 + 2 * S::CB;                     // [2][QT][CPITCH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = warp >> 3, gw = warp & 7, gtid = tid & (GROUP - 1);
  const int g = lane >> 2, tq = lane & 3;
  uint16_t* xs0 = reinterpret_cast<uint16_t*>(ssd_smem + S::SHARED +
                                              hg * S::HEAD);  // [2][QT][XPITCH]
  uint16_t* shi = xs0 + 2 * S::XT;     // [PP][CPITCH] the state's hi part
  uint16_t* slo = shi + S::ST;         // [PP][CPITCH] and its lo part
  float* dts0 = reinterpret_cast<float*>(slo + S::ST);  // [2][QT]
  float* cum = dts0 + 2 * QT;          // [QT]
  float* ecum = cum + QT;              // [QT] exp(cum_t)
  float* wgt = ecum + QT;              // [QT] dt_s exp(cum_last - cum_s)
  float* dec = wgt + QT;               // [1]  exp(cum_last)

  const int b = blockIdx.x / p.head_groups;
  const int h = (blockIdx.x - b * p.head_groups) * HB + hg;
  const bool active = h < p.H;         // a group past H only loads and waits
  const int hh = active ? h : 0;
  const int P = p.P, N = p.N;
  const float ah = a[hh];

  const uint16_t* xb = x + b * p.x_sb + (size_t)hh * P;
  const uint16_t* bb = bm + b * p.b_sb;
  const uint16_t* cb = cm + b * p.c_sb;
  const float* dtb = dt + (size_t)b * p.L * p.H + hh;

  // tile [l0, l0 + QT) into stage st: c, b (all threads), x and dt (the
  // head's group); zeros past L and past P / N
  auto issue = [&](int l0, int st) {
    const int qv = min(QT, p.L - l0);
    load_tile<QT, NN, GROUP * HB>(cs0 + st * S::CB, CPITCH,
                                  cb + l0 * p.c_sl, p.c_sl, qv, N,
                                  p.vec_bc, tid);
    load_tile<QT, NN, GROUP * HB>(bs0 + st * S::CB, CPITCH,
                                  bb + l0 * p.b_sl, p.b_sl, qv, N,
                                  p.vec_bc, tid);
    load_tile<QT, PP, GROUP>(xs0 + st * S::XT, XPITCH, xb + l0 * p.x_sl,
                             p.x_sl, active ? qv : 0, P, p.vec_x, gtid);
    if (gtid < QT) {
      float* d = dts0 + st * QT + gtid;
      if (active && gtid < qv)
        cp_async4(d, dtb + (size_t)(l0 + gtid) * p.H);
      else
        *d = 0.f;
    }
    cp_async_commit();
  };

  // the state: warp gw owns rows 16 (gw & 3) .. +15 and columns
  // 64 (gw >> 2) .. +63; this thread rows srow, srow + 8 and columns
  // scol + 8 j, +1
  const int srow = 16 * (gw & 3) + g, scol = 64 * (gw >> 2) + 2 * tq;
  const size_t state_off = ((size_t)b * p.H + hh) * P * N;
  float st[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = srow + 8 * (e >> 1), c = scol + 8 * j + (e & 1);
      st[j][e] = (active && r < P && c < N) ? s0[state_off + (size_t)r * N + c]
                                            : 0.f;
    }
  write_state(shi, slo, st, srow, scol);

  issue(0, 0);
  const int ntiles = (p.L + QT - 1) / QT;
  for (int k = 0; k < ntiles; ++k) {
    const int l0 = k * QT, stg = k & 1, qv = min(QT, p.L - l0);
    cp_async_wait<0>();
    __syncthreads();  // tile k has landed; the last tile's state is written
    if (k + 1 < ntiles) issue(l0 + QT, stg ^ 1);
    const uint16_t* cs = cs0 + stg * S::CB;
    const uint16_t* bs = bs0 + stg * S::CB;
    const uint16_t* xs = xs0 + stg * S::XT;
    const float* dts = dts0 + stg * QT;
    if (SAVE && active) {  // the state entering tile k
      float* sk = states + (((size_t)b * p.H + h) * ntiles + k) * P * N;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = srow + 8 * (e >> 1), c = scol + 8 * j + (e & 1);
          if (r < P && c < N) sk[(size_t)r * N + c] = st[j][e];
        }
    }

    // cum: inclusive prefix sum of dt a over the tile, one warp a head
    if (gw == 0) {
      float v[PER], s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[i] = dts[PER * lane + i] * ah;
        s += v[i];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += o;
      }
      float c = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) c = 0.f;
      float cl[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        c += v[i];
        cl[i] = c;
      }
      const float last = __shfl_sync(0xffffffffu, cl[PER - 1], 31);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int t = PER * lane + i;
        cum[t] = cl[i];
        ecum[t] = __expf(cl[i]);
        wgt[t] = dts[t] * __expf(last - cl[i]);
      }
      if (lane == 0) dec[0] = __expf(last);
    }
    __syncthreads();

    // y: warp gw owns rows 16 mt .. +15 and columns pb .. pb + 8 YN - 1
    {
      const int mt = gw % MT, pb = (gw / MT) * YN * 8;
      const uint16_t* crow = cs + 16 * mt * CPITCH;
      float acc[YN][4];
#pragma unroll
      for (int j = 0; j < YN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      // the carried term c . S^T over N, S as hi + lo
#pragma unroll 2
      for (int kk = 0; kk < NN / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_a(af, crow + 16 * kk, CPITCH, lane);
#pragma unroll
        for (int jj = 0; jj < YN / 2; ++jj) {
          uint32_t bh[4], bl[4];
          const int off = (pb + 16 * jj) * CPITCH + 16 * kk;
          ldmatrix_b_nk(bh, shi + off, CPITCH, lane);
          ldmatrix_b_nk(bl, slo + off, CPITCH, lane);
          mma(acc[2 * jj], af, bh[0], bh[1]);
          mma(acc[2 * jj + 1], af, bh[2], bh[3]);
          mma(acc[2 * jj], af, bl[0], bl[1]);
          mma(acc[2 * jj + 1], af, bl[2], bl[3]);
        }
      }
      const int t0 = 16 * mt + g, t1 = t0 + 8;
      const float cum0 = cum[t0], cum1 = cum[t1];
      {
        const float e0 = ecum[t0], e1 = ecum[t1];
#pragma unroll
        for (int j = 0; j < YN; ++j) {
          acc[j][0] *= e0; acc[j][1] *= e0;
          acc[j][2] *= e1; acc[j][3] *= e1;
        }
      }
      // the intra term, 16 positions s at a time up to the diagonal
      for (int sc = 0; sc <= mt; ++sc) {
        float cbv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
        for (int kk = 0; kk < NN / 16; ++kk) {
          uint32_t af[4], bf[4];
          ldmatrix_a(af, crow + 16 * kk, CPITCH, lane);
          ldmatrix_b_nk(bf, bs + 16 * sc * CPITCH + 16 * kk, CPITCH, lane);
          mma(cbv[0], af, bf[0], bf[1]);
          mma(cbv[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = 16 * sc + 8 * j + 2 * tq + (e & 1);
            const int t = (e < 2) ? t0 : t1;
            const float ct = (e < 2) ? cum0 : cum1;
            cbv[j][e] = (s <= t) ? cbv[j][e] * __expf(ct - cum[s]) * dts[s]
                                 : 0.f;
          }
        uint32_t gh[4], gl[4];
        split2(cbv[0][0], cbv[0][1], gh[0], gl[0]);
        split2(cbv[0][2], cbv[0][3], gh[1], gl[1]);
        split2(cbv[1][0], cbv[1][1], gh[2], gl[2]);
        split2(cbv[1][2], cbv[1][3], gh[3], gl[3]);
#pragma unroll
        for (int jj = 0; jj < YN / 2; ++jj) {
          uint32_t xf[4];
          ldmatrix_b_kn(xf, xs + 16 * sc * XPITCH + pb + 16 * jj, XPITCH,
                        lane);
          mma(acc[2 * jj], gh, xf[0], xf[1]);
          mma(acc[2 * jj + 1], gh, xf[2], xf[3]);
          mma(acc[2 * jj], gl, xf[0], xf[1]);
          mma(acc[2 * jj + 1], gl, xf[2], xf[3]);
        }
      }
      if (active) {
        uint16_t* yb = y + ((size_t)b * p.L * p.H + h) * P;
#pragma unroll
        for (int j = 0; j < YN; ++j) {
          const int pc = pb + 8 * j + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = half ? t1 : t0;
            if (t >= qv || pc >= P) continue;
            uint16_t* yr = yb + (size_t)(l0 + t) * p.H * P + pc;
            const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
            if ((P & 1) == 0) {
              *reinterpret_cast<uint32_t*>(yr) = pack_bf16x2(v0, v1);
            } else {
              const uint32_t v = pack_bf16x2(v0, v1);
              yr[0] = (uint16_t)(v & 0xffffu);
              if (pc + 1 < P) yr[1] = (uint16_t)(v >> 16);
            }
          }
        }
      }
    }

    // S = exp(cum_last) S + (x w)^T . b, accumulated in registers
    {
      const float d = dec[0];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= d;
      const int prow = 16 * (gw & 3), ncol = 64 * (gw >> 2);
#pragma unroll
      for (int ks = 0; ks < QT / 16; ++ks) {
        uint32_t xa[4], ahi[4], alo[4];
        ldmatrix_a_trans(xa, xs + 16 * ks * XPITCH + prow, XPITCH, lane);
        const int s = 16 * ks + 2 * tq;
        const float w0 = wgt[s], w1 = wgt[s + 1];
        const float w8 = wgt[s + 8], w9 = wgt[s + 9];
        scale_split(xa[0], w0, w1, ahi[0], alo[0]);
        scale_split(xa[1], w0, w1, ahi[1], alo[1]);
        scale_split(xa[2], w8, w9, ahi[2], alo[2]);
        scale_split(xa[3], w8, w9, ahi[3], alo[3]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          ldmatrix_b_kn(bf, bs + 16 * ks * CPITCH + ncol + 16 * jj, CPITCH,
                        lane);
          mma(st[2 * jj], ahi, bf[0], bf[1]);
          mma(st[2 * jj + 1], ahi, bf[2], bf[3]);
          mma(st[2 * jj], alo, bf[0], bf[1]);
          mma(st[2 * jj + 1], alo, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every read of the old state's hi and lo is done
    write_state(shi, slo, st, srow, scol);
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = srow + 8 * (e >> 1), c = scol + 8 * j + (e & 1);
      if (r < P && c < N) sf[state_off + (size_t)r * N + c] = st[j][e];
    }
}

template <int QT, int HB, bool SAVE>
int launch_mma(const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, const float* s0, void* y,
               float* sf, float* states, MmaParams p, int B,
               cudaStream_t stream) {
  auto kern = mamba2_ssd_mma_kernel<QT, HB, SAVE>;
  constexpr size_t smem = MmaSmem<QT, HB>::BYTES;
  static_assert(smem <= (size_t)MAX_SMEM, "SSD tile exceeds shared memory");
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  p.head_groups = (p.H + HB - 1) / HB;
  const long long blocks = (long long)B * p.head_groups;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kern<<<(int)blocks, GROUP * HB, smem, stream>>>(
      static_cast<const uint16_t*>(x), dt, a,
      static_cast<const uint16_t*>(bm), static_cast<const uint16_t*>(cm), s0,
      static_cast<uint16_t*>(y), sf, states, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
// positions per tile: 32 keeps a block at 79 KB of shared memory (P 64,
// N 128), so two blocks share an SM; 64 positions (133 KB) ran slower
constexpr int QT = 32;
constexpr int TQ = QT / 16;       // tile rows / columns per thread
constexpr int GP = QT + 1;        // pitch of the gated c.b tile
constexpr int PER = QT / 32;      // positions per lane in the scan
constexpr int MAX_P = 64;         // head dim the register tiles cover
constexpr int MAX_N = 128;        // state dim the register tiles cover
constexpr int TP = MAX_P / 16;
constexpr int TN = MAX_N / 16;

struct Params {
  int L, H, P, N, NP;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename T, bool SAVE>
__global__ void __launch_bounds__(THREADS)
mamba2_ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ sf,
                  float* __restrict__ states, const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int NP = p.NP, P = p.P, N = p.N;
  float* cs = smem;                   // [QT][NP]  c of the tile
  float* bs = cs + QT * NP;           // [QT][NP]  b of the tile
  float* xs = bs + QT * NP;           // [QT][P]   x of the tile (this head)
  float* G = xs + QT * P;             // [QT][GP]  gated c.b, 0 above the diagonal
  float* S = G + QT * GP;             // [P][NP]   the state
  float* cum = S + P * NP;            // [QT]
  float* dts = cum + QT;              // [QT]
  float* ecum = dts + QT;             // [QT]      exp(cum_t)
  float* wgt = ecum + QT;             // [QT]      dt_s exp(cum_last - cum_s)
  float* dec = wgt + QT;              // [1]       exp(cum_last)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const float ah = a[h];
  const size_t state_off = (size_t)bh * P * N;

  for (int i = tid; i < P * N; i += THREADS) {
    const int pi = i / N, n = i - pi * N;
    S[pi * NP + n] = s0[state_off + i];
  }

  const T* xb = x + b * p.x_sb + (size_t)h * P;
  const T* bb = bm + b * p.b_sb;
  const T* cb = cm + b * p.c_sb;
  const float* dtb = dt + (size_t)b * p.L * p.H + h;
  T* yb = y + ((size_t)b * p.L * p.H + h) * P;

  const int ntiles = (p.L + QT - 1) / QT;
  for (int l0 = 0; l0 < p.L; l0 += QT) {
    const int qv = min(QT, p.L - l0);
    __syncthreads();  // the last tile's reads are done, S is written
    if (SAVE) {  // the state entering this tile
      float* sk = states + ((size_t)bh * ntiles + l0 / QT) * P * N;
      for (int i = tid; i < P * N; i += THREADS) {
        const int pi = i / N, n = i - pi * N;
        sk[i] = S[pi * NP + n];
      }
    }
    for (int i = tid; i < QT * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      float cv = 0.f, bv = 0.f;
      if (t < qv) {
        cv = to_f32(cb[(l0 + t) * p.c_sl + n]);
        bv = to_f32(bb[(l0 + t) * p.b_sl + n]);
      }
      cs[t * NP + n] = cv;
      bs[t * NP + n] = bv;
    }
    for (int i = tid; i < QT * P; i += THREADS) {
      const int t = i / P, pp = i - t * P;
      xs[i] = t < qv ? to_f32(xb[(l0 + t) * p.x_sl + pp]) : 0.f;
    }
    if (tid < QT) dts[tid] = tid < qv ? dtb[(size_t)(l0 + tid) * p.H] : 0.f;
    __syncthreads();

    // cum: inclusive prefix sum of dt a over the tile, one warp, PER
    // consecutive positions a lane
    if (tid < 32) {
      float v[PER], s = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        v[k] = dts[PER * tid + k] * ah;
        s += v[k];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += o;
      }
      float c = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) c = 0.f;
      float cl[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        c += v[k];
        cl[k] = c;
      }
      const float last = __shfl_sync(0xffffffffu, cl[PER - 1], 31);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = PER * tid + k;
        cum[i] = cl[k];
        ecum[i] = expf(cl[k]);
        wgt[i] = dts[i] * expf(last - cl[k]);
      }
      if (tid == 0) dec[0] = expf(last);
    }
    __syncthreads();

    // G[t][s] = (c_t . b_s) exp(cum_t - cum_s) dt_s for s <= t, else 0
    {
      float acc[TQ][TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float av[TQ], bv[TQ];
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          av[i] = cs[(ty + 16 * i) * NP + n];
          bv[i] = bs[(tx + 16 * i) * NP + n];
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)  // j > i lies wholly above the diagonal
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          const int s = tx + 16 * j;
          float g = 0.f;
          if (s <= t) g = acc[i][j] * expf(cum[t] - cum[s]) * dts[s];
          G[t * GP + s] = g;
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_s G[t][s] x[s][p] + exp(cum_t) sum_n c[t][n] S[p][n]
    {
      float yi[TQ][TP], ye[TQ][TP];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) { yi[i][j] = 0.f; ye[i][j] = 0.f; }
      int pc[TP];
#pragma unroll
      for (int j = 0; j < TP; ++j) pc[j] = min(tx + 16 * j, P - 1);
      for (int s = 0; s < qv; ++s) {
        float av[TQ], xv[TP];
#pragma unroll
        for (int i = 0; i < TQ; ++i) av[i] = G[(ty + 16 * i) * GP + s];
#pragma unroll
        for (int j = 0; j < TP; ++j) xv[j] = xs[s * P + pc[j]];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j) yi[i][j] = fmaf(av[i], xv[j], yi[i][j]);
      }
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float av[TQ], sv[TP];
#pragma unroll
        for (int i = 0; i < TQ; ++i) av[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < TP; ++j) sv[j] = S[pc[j] * NP + n];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j) ye[i][j] = fmaf(av[i], sv[j], ye[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int t = ty + 16 * i;
        if (t >= qv) continue;
        T* yrow = yb + (size_t)(l0 + t) * p.H * P;
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          const int pp = tx + 16 * j;
          if (pp < P) store(yrow + pp, yi[i][j] + ecum[t] * ye[i][j]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S[p][n] = exp(cum_last) S[p][n] + sum_s (x[s][p] w_s) b[s][n]
    {
      float u[TP][TN];
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) u[i][j] = 0.f;
      int pr[TP], nc[TN];
#pragma unroll
      for (int i = 0; i < TP; ++i) pr[i] = min(ty + 16 * i, P - 1);
#pragma unroll
      for (int j = 0; j < TN; ++j) nc[j] = min(tx + 16 * j, N - 1);
      for (int s = 0; s < qv; ++s) {
        const float ws = wgt[s];
        float xv[TP], bv[TN];
#pragma unroll
        for (int i = 0; i < TP; ++i) xv[i] = xs[s * P + pr[i]] * ws;
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = bs[s * NP + nc[j]];
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) u[i][j] = fmaf(xv[i], bv[j], u[i][j]);
      }
      const float d = dec[0];
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        const int pp = ty + 16 * i;
        if (pp >= P) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = tx + 16 * j;
          if (n < N) S[pp * NP + n] = S[pp * NP + n] * d + u[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    const int pi = i / N, n = i - pi * N;
    sf[state_off + i] = S[pi * NP + n];
  }
}

template <typename T, bool SAVE>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* s0, void* y, float* sf,
           float* states, const Params& p, int blocks, cudaStream_t stream) {
  auto kern = mamba2_ssd_kernel<T, SAVE>;
  const size_t smem = 4 * (2 * (size_t)QT * p.NP + (size_t)QT * p.P +
                           (size_t)QT * (QT + 1) + (size_t)p.P * p.NP +
                           4 * QT + 1);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), s0, static_cast<T*>(y), sf, states, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// dtype codes (x, b, c, y): 0 float32 (CUDA cores: block_l 32, one head
// a block), 1 bfloat16 (tensor cores: block_l 32 with one head a block,
// or 64 with two).  Strides are in elements; x's (H, P) axes, b's and c's
// N axis, dt, a, the states and y are contiguous.  tile_states, when not
// null, receives the state entering each tile, (B, H, ceil(L / block_l),
// P, N) f32.
extern "C" int mamba2_ssd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* s0, void* y, void* sf, void* tile_states,
    int dtype, int B,
    int L, int H, int P, int N, long long x_sb, long long x_sl,
    long long b_sb, long long b_sl, long long c_sb, long long c_sl,
    int block_l, int heads_per_block, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || P > MAX_P ||
      N > MAX_N || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* s0f = static_cast<const float*>(s0);
  float* sff = static_cast<float*>(sf);
  float* stf = static_cast<float*>(tile_states);
  if (dtype == 1) {
    MmaParams p;
    p.L = L; p.H = H; p.P = P; p.N = N; p.head_groups = 0;
    p.x_sb = x_sb; p.x_sl = x_sl; p.b_sb = b_sb; p.b_sl = b_sl;
    p.c_sb = c_sb; p.c_sl = c_sl;
    // 16-byte rows: every row start and column piece on a 16-byte boundary
    p.vec_x = aligned16(x) && x_sb % 8 == 0 && x_sl % 8 == 0 && P % 8 == 0;
    p.vec_bc = aligned16(bm) && aligned16(cm) && b_sb % 8 == 0 &&
               b_sl % 8 == 0 && c_sb % 8 == 0 && c_sl % 8 == 0 &&
               N % 8 == 0;
    if (block_l == 32 && heads_per_block == 1)
      return stf ? launch_mma<32, 1, true>(x, dtf, af, bm, cm, s0f, y, sff,
                                           stf, p, B, s)
                 : launch_mma<32, 1, false>(x, dtf, af, bm, cm, s0f, y, sff,
                                            stf, p, B, s);
    if (block_l == 64 && heads_per_block == 2)
      return stf ? launch_mma<64, 2, true>(x, dtf, af, bm, cm, s0f, y, sff,
                                           stf, p, B, s)
                 : launch_mma<64, 2, false>(x, dtf, af, bm, cm, s0f, y, sff,
                                            stf, p, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (block_l != QT || heads_per_block != 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.L = L; p.H = H; p.P = P; p.N = N;
  p.NP = (N % 2) ? N : N + 1;  // odd pitch: conflict-free column reads
  p.x_sb = x_sb; p.x_sl = x_sl; p.b_sb = b_sb; p.b_sl = b_sl;
  p.c_sb = c_sb; p.c_sl = c_sl;
  const long long blocks = (long long)B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  return stf ? launch<float, true>(x, dtf, af, bm, cm, s0f, y, sff, stf, p,
                                   (int)blocks, s)
             : launch<float, false>(x, dtf, af, bm, cm, s0f, y, sff, stf, p,
                                    (int)blocks, s);
}

extern "C" const char* mamba2_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
