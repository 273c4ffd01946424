// Backward of the Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a).
// No TPU kernel to replace: the reference trains Mamba-2 by XLA's autodiff
// of src/repro/kernels/ref.py:300 ssd_chunked (called at
// src/repro/models/mamba2.py:107); this is its counterpart, as
// flash_attention_bwd.cu is the counterpart of the reference's custom VJP
// of attention.
//
// Per tile of BQ positions (cum_t = sum_{i<=t} dt_i a within the tile,
// E_ts = exp(cum_t - cum_s) for s <= t, D = exp(cum_last), g_s =
// exp(cum_last - cum_s), w_s = dt_s g_s) the forward computed
//
//   y_t   = sum_{s<=t} E_ts dt_s (c_t . b_s) x_s + exp(cum_t) S c_t
//   S'    = D S + sum_s w_s x_s (x) b_s
//
// so, with dy the cotangent of y, S = S_k the state entering tile k and
// dS = dS_k the cotangent of the state leaving it:
//
//   G_ts  = (c_t . b_s) E_ts dt_s,  Gd_ts = (dy_t . x_s) E_ts dt_s,
//   K_ts  = (c_t . b_s)(dy_t . x_s) E_ts                     (s <= t)
//   Z_s   = dS b_s,  Y_s = x_s^T dS,  u_t = dy_t^T S,  V_s = x_s . Z_s,
//   I_t   = c_t . u_t
//   dx_s  = sum_{t>=s} G_ts dy_t + w_s Z_s
//   dc_t  = sum_{s<=t} Gd_ts b_s + exp(cum_t) u_t
//   db_s  = sum_{t>=s} Gd_ts c_t + w_s Y_s
//   dS_{k-1} = D dS_k + sum_t exp(cum_t) dy_t (x) c_t
//   dcum_t = sum_s K_ts dt_s - dt_t sum_{t'} K_t't + exp(cum_t) I_t - w_t V_t
//            (+ D sum(dS * S) + sum_s w_s V_s at the tile's last position)
//   ddt_s = sum_t K_ts + g_s V_s + a revcum(dcum)_s,
//   da   += sum_s dt_s revcum(dcum)_s
//
// where revcum is the reverse inclusive cumsum within the tile (cum is a
// cumsum of dt a).  The carried dS enters a tile's sums only through Z, Y
// and sum(dS * S), and its recurrence's increment does not depend on it.
// So the backward is two kernels (Mamba-2's own backward splits the same
// way):
//
// 1. the dS pass (mamba2_ssd_bwd_pass_kernel): one block per (batch row,
//    head) walks the tiles last to first and runs the recurrence alone,
//    writing every dS_k to a (B, H, n_tiles, P, N) f32 buffer; its last
//    carry is the initial state's gradient.
// 2. the tile kernel (mamba2_ssd_bwd_tile_kernel): every (batch row, tile,
//    group of HB heads) is a block of its own, in parallel, reading the
//    forward's saved S_k (mamba2_ssd.cu writes it when asked, on tiles of
//    the same BQ) and the pass's dS_k.
//
// exp is taken only where s <= t and for differences that are <= 0 (a < 0
// < dt), so every factor lies in (0, 1]: the gradient stays finite where
// the plain ssd_chunked -- which takes exp of the whole (t, s) difference
// and masks afterwards -- gives 0 * inf = NaN above the diagonal.  A ragged
// last tile reads x, b, c, dy and dt as 0 past L, which leaves cum and
// every sum untouched.
//
// Deterministic: no float atomics.  b and c are shared by every head, so
// a tile block sums db and dc over its HB heads in a fixed order and writes
// them as (B, ceil(H / HB), L, N) f32 partials, which the caller sums in a
// fixed order; da leaves as one partial per (batch row, head, tile); every
// other output element has one writer.
//
// What bounds it: at mamba2-1.3b's train microbatch (B 4, L 4096, H 64,
// P 64, N 128, bf16) the backward must read x, dy, b, c, dt and write dx,
// db, dc, ddt -- about 0.44 GB, 0.13 ms at 3.35 TB/s -- and does about
// 82 GFLOP, 0.08 ms at the bf16 tensor-core rate: bytes.  The two-kernel
// design moves more: the saved states (1.07 GB), dS_k written and read
// (2 x 1.07 GB) and the partials (0.07 GB written and read at HB 16),
// about 3.9 GB in all, 1.17 ms at 3.35 TB/s -- its floor.  Every product
// is small (32 positions), so what a kernel has to do is keep the card's
// memory busy:
//
//   pass   one block of 8 warps per (batch row, head): 256 blocks at the
//          train shape, all resident at once (128 registers, two an SM).
//          Warp w carries rows 16 (w & 3) .. +15 and columns 64 (w >> 2)
//          .. +63 of dS in mma accumulator registers.  Per tile: dS_k
//          written from the registers (the stores need no wait), then dS
//          = D dS + (exp(cum) dy)^T c on mma.sync m16n8k16 -- c is a bf16
//          input, exact; exp(cum) dy enters as bf16 hi + lo (scaled from
//          the bf16 dy fragment, as the forward scales x) -- 32 mma a
//          warp.  c is read once per head (a block per 16 rows of P read
//          it four times, and was slower on the card); the next tile's c,
//          dy and dt arrive by cp.async while this one computes; each
//          warp runs the tile's 32-position scan itself, so a tile takes
//          one barrier.  Its floor is writing dS_k, 1.07 GB.
//   tile   one block of 8 warps per (batch row, tile, HB heads): 2048
//          blocks at the train shape (HB 16), 104 KB of shared memory
//          each, two an SM (128 registers).  c.b^T once per block (shared
//          by the heads); per head x, dy by cp.async and S_k, dS_k read
//          once as float4, their products
//          sum(dS * S) taken in f32 on the way and each split into bf16
//          hi + lo tiles.  On mma.sync (f32 sums): dy.x^T and c.b^T (bf16
//          inputs, exact), Z = b.dS^T, u = dy.S, Y = x.dS (one operand hi
//          + lo), then G^T.dy (G hi + lo); a warp owns a 16 x 8 piece of
//          the (t, s) tile, so G, Gd and K are formed in its registers
//          (exp only where s <= t) and K's row and column sums leave by
//          shuffles.  Gd is summed over the block's heads in registers
//          and enters dc = Gd.b and db = Gd^T.c once, as hi + lo; e u and
//          w Y are added head by head to accumulators that stay in
//          registers.  dcum, its reverse cumsum, ddt and da: one warp, a
//          lane a position, f32 on the CUDA cores.  Its floor is reading
//          S_k and dS_k, 2.15 GB; the staging is synchronous, so a block
//          leaves the memory idle while it computes and the other block on
//          its SM has to cover it.
//
// Why hi + lo: emulated on the CPU at the train length
// (chip_smoke.ssd_bwd_split, tests/test_torch_ssd_bwd.py), rounding any one
// of G, Gd, S, dS or exp(cum) dy to bf16 alone uses 0.48-1.45 of the
// card's bf16 rule; with every one as hi + lo the formula uses 5e-4 of it.
//
// f32 inputs take the same two kernels on the CUDA cores in f32, so that
// f32 keeps f32 accuracy: mamba2_ssd_bwd_pass_f32_kernel, one block of 4
// warps per (batch row, head, 16 rows of P), thread (ty, tx) carrying rows
// ty + 4 i and columns tx + 32 j; mamba2_ssd_bwd_tile_f32_kernel, 16 x 16
// threads, each owning rows ty + 16 i and columns tx + 16 j of every small
// product out of shared memory.
//
// Plain C interface (loaded with ctypes): the kernels allocate nothing and
// do not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for
constexpr int BQ = 32;            // positions a tile: the forward's tile
constexpr int MAX_P = 64;         // widest head dim
constexpr int MAX_N = 128;        // widest state dim
constexpr int HB = 16;            // heads a tile block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int L, H, P, N, ntiles, groups, NP, XP;
  int vec_x, vec_bc, vec_dy, vec_st;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

// inclusive prefix sum over the warp's lanes, a lane a position
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// reverse inclusive prefix sum over the warp's lanes
__device__ __forceinline__ float warp_rscan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(FULL, v, off);
    if (lane + off < 32) v += o;
  }
  return v;
}

// the sum over the warp's lanes, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores
// ---------------------------------------------------------------------------

constexpr int PP = 64;             // head dim as the tiles hold it
constexpr int NN = 128;            // state dim as the tiles hold it
constexpr int CPITCH = NN + 8;     // bf16 pitch of c, b and the state tiles
constexpr int XPITCH = PP + 8;     // bf16 pitch of the x and dy tiles
constexpr int GPITCH = BQ + 8;     // bf16 pitch of the (t, s) tiles
constexpr int PASS_THREADS = 256;  // 8 warps: 4 row slices x 2 column halves
constexpr int TILE_THREADS = 256;  // 8 warps

// shared memory of the dS pass: c and dy (bf16) and dt (f32), two stages
// each
constexpr int PASS_STAGES = 2;
constexpr int PASS_SMEM = PASS_STAGES * (2 * BQ * CPITCH + 2 * BQ * XPITCH +
                                         4 * BQ);
static_assert(PASS_SMEM <= 48 * 1024, "the pass's tiles are static");

// shared memory of the tile kernel, and where each tile lies: bf16 c, b,
// x, dy, the state's and dS's hi and lo parts, G's (later Gd's) hi and lo;
// then f32 dt, cum, exp(cum), g, w, the partial sums of K's rows (4 x BQ)
// and columns (2 x BQ), of V (4 x BQ) and I (4 x BQ), 8 per-warp partials
// of sum(dS * S), and two scalars
struct TileSmem {
  static constexpr int CB = BQ * CPITCH;
  static constexpr int XT = BQ * XPITCH;
  static constexpr int ST = PP * CPITCH;
  static constexpr int GT = BQ * GPITCH;
  static constexpr int BYTES =
      2 * (2 * CB + 2 * XT + 4 * ST + 2 * GT) + 4 * (19 * BQ + 8 + 2);
};
static_assert(TileSmem::BYTES <= MAX_SMEM, "tile kernel exceeds smem");

// 4 bytes global -> shared, asynchronously (dt: one float a position)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void st32(uint16_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four f32 -> bf16 hi and lo parts at hi + off, lo + off (8-byte aligned)
__device__ __forceinline__ void store_split4(uint16_t* hi, uint16_t* lo,
                                             int off, float4 v) {
  uint32_t h0, l0, h1, l1;
  split2(v.x, v.y, h0, l0);
  split2(v.z, v.w, h1, l1);
  *reinterpret_cast<uint2*>(hi + off) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo + off) = make_uint2(l0, l1);
}

__global__ void __launch_bounds__(PASS_THREADS, 2)
mamba2_ssd_bwd_pass_kernel(const uint16_t* __restrict__ dy,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const uint16_t* __restrict__ cm,
                           const float* __restrict__ dsf,
                           float* __restrict__ dsk, float* __restrict__ ds0,
                           const Params p) {
  // [PASS_STAGES][BQ][CPITCH], [PASS_STAGES][BQ][XPITCH], [PASS_STAGES][BQ]
  __shared__ __align__(16) uint16_t cs0[PASS_STAGES * BQ * CPITCH];
  __shared__ __align__(16) uint16_t dys0[PASS_STAGES * BQ * XPITCH];
  __shared__ __align__(16) float dts0[PASS_STAGES * BQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int P = p.P, N = p.N, nt = p.ntiles;
  const float ah = a[h];
  const uint16_t* cb = cm + b * p.c_sb;
  const long long dy_ld = (long long)p.H * P;
  const uint16_t* dyb = dy + ((size_t)b * p.L * p.H + h) * P;
  const float* dtb = dt + (size_t)b * p.L * p.H + h;

  // the carried dS: warp w holds rows prow .. +15 and columns ncol .. +63,
  // this thread rows prow + g, +8 and columns ncol + 8 j + 2 tq, +1
  const int prow = 16 * (warp & 3), ncol = 64 * (warp >> 2);
  const size_t st_off = (size_t)bh * P * N;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = prow + g + 8 * (e >> 1);
      const int c = ncol + 8 * j + 2 * tq + (e & 1);
      acc[j][e] = (dsf != nullptr && r < P && c < N)
                      ? dsf[st_off + (size_t)r * N + c]
                      : 0.f;
    }

  // tile k into stage st: c, dy and dt, zeros past L
  auto issue = [&](int k, int st) {
    const int l0 = k * BQ, qv = min(BQ, p.L - l0);
    load_tile<BQ, NN, PASS_THREADS>(cs0 + st * BQ * CPITCH, CPITCH,
                                    cb + l0 * p.c_sl, p.c_sl, qv, N,
                                    p.vec_bc, tid);
    load_tile<BQ, PP, PASS_THREADS>(dys0 + st * BQ * XPITCH, XPITCH,
                                    dyb + (size_t)l0 * dy_ld, dy_ld, qv, P,
                                    p.vec_dy, tid);
    if (tid < BQ) {
      float* d = dts0 + st * BQ + tid;
      if (tid < qv)
        cp_async4(d, dtb + (size_t)(l0 + tid) * p.H);
      else
        *d = 0.f;
    }
    cp_async_commit();
  };

  issue(nt - 1, 0);
  for (int k = nt - 1, it = 0; k >= 0; --k, ++it) {
    const int st = it & 1;
    // dS_k, the cotangent of the state leaving tile k
    {
      float* out = dsk + ((size_t)bh * nt + k) * P * N;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = prow + g + 8 * half, c = ncol + 8 * j + 2 * tq;
          if (r >= P || c >= N) continue;
          float* o = out + (size_t)r * N + c;
          if ((N & 1) == 0) {
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
          } else {
            o[0] = acc[j][2 * half];
            if (c + 1 < N) o[1] = acc[j][2 * half + 1];
          }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // tile k has landed; the other stage's reads are done
    if (k > 0) issue(k - 1, st ^ 1);
    const uint16_t* cs = cs0 + st * BQ * CPITCH;
    const uint16_t* dys = dys0 + st * BQ * XPITCH;
    // cum over the tile, each warp for itself
    const float cum = warp_scan(dts0[st * BQ + lane] * ah, lane);
    const float ecum = expf(cum);
    const float dec = expf(__shfl_sync(FULL, cum, 31));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= dec;
    // + (exp(cum) dy)^T c: A[p][t] = exp(cum_t) dy[t][p] from the
    // transposing load of dy, scaled in f32 and split hi + lo
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      uint32_t xa[4], ahi[4], alo[4];
      ldmatrix_a_trans(xa, dys + 16 * ks * XPITCH + prow, XPITCH, lane);
      const int t = 16 * ks + 2 * tq;
      const float e0 = __shfl_sync(FULL, ecum, t);
      const float e1 = __shfl_sync(FULL, ecum, t + 1);
      const float e8 = __shfl_sync(FULL, ecum, t + 8);
      const float e9 = __shfl_sync(FULL, ecum, t + 9);
      scale_split(xa[0], e0, e1, ahi[0], alo[0]);
      scale_split(xa[1], e0, e1, ahi[1], alo[1]);
      scale_split(xa[2], e8, e9, ahi[2], alo[2]);
      scale_split(xa[3], e8, e9, ahi[3], alo[3]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[4];
        ldmatrix_b_kn(bf, cs + 16 * ks * CPITCH + ncol + 16 * jj, CPITCH,
                      lane);
        mma(acc[2 * jj], ahi, bf[0], bf[1]);
        mma(acc[2 * jj + 1], ahi, bf[2], bf[3]);
        mma(acc[2 * jj], alo, bf[0], bf[1]);
        mma(acc[2 * jj + 1], alo, bf[2], bf[3]);
      }
    }
  }
  // the carry below tile 0: the initial state's gradient
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = prow + g + 8 * (e >> 1);
      const int c = ncol + 8 * j + 2 * tq + (e & 1);
      if (r < P && c < N) ds0[st_off + (size_t)r * N + c] = acc[j][e];
    }
}

// S_k and dS_k (f32, P x N, row-major) -> hi and lo bf16 tiles (PP x NN,
// zeros past P and N); returns this thread's share of sum(dS * S), in f32
__device__ __forceinline__ float stage_states(
    uint16_t* shi, uint16_t* slo, uint16_t* dhi, uint16_t* dlo,
    const float* __restrict__ sk, const float* __restrict__ dk, int P, int N,
    bool vec, int tid) {
  float part = 0.f;
  if (vec) {  // N % 4 == 0: 64 rows of 32 float4 slots, 8 a thread
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float4 sv[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = tid + TILE_THREADS * (4 * half + i);
        const int r = slot >> 5, c = (slot & 31) * 4;
        if (r < P && c < N) {
          sv[i] = __ldg(reinterpret_cast<const float4*>(sk + r * N + c));
          dv[i] = __ldg(reinterpret_cast<const float4*>(dk + r * N + c));
        } else {
          sv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          dv[i] = sv[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = tid + TILE_THREADS * (4 * half + i);
        const int off = (slot >> 5) * CPITCH + (slot & 31) * 4;
        part = fmaf(sv[i].x, dv[i].x, part);
        part = fmaf(sv[i].y, dv[i].y, part);
        part = fmaf(sv[i].z, dv[i].z, part);
        part = fmaf(sv[i].w, dv[i].w, part);
        store_split4(shi, slo, off, sv[i]);
        store_split4(dhi, dlo, off, dv[i]);
      }
    }
  } else {
    for (int i = tid; i < PP * NN; i += TILE_THREADS) {
      const int r = i / NN, c = i - r * NN;
      float sv = 0.f, dv = 0.f;
      if (r < P && c < N) {
        sv = sk[r * N + c];
        dv = dk[r * N + c];
      }
      part = fmaf(sv, dv, part);
      const int off = r * CPITCH + c;
      const __nv_bfloat16 s1 = __float2bfloat16_rn(sv);
      const __nv_bfloat16 d1 = __float2bfloat16_rn(dv);
      shi[off] = __bfloat16_as_ushort(s1);
      slo[off] = __bfloat16_as_ushort(
          __float2bfloat16_rn(sv - __bfloat162float(s1)));
      dhi[off] = __bfloat16_as_ushort(d1);
      dlo[off] = __bfloat16_as_ushort(
          __float2bfloat16_rn(dv - __bfloat162float(d1)));
    }
  }
  return part;
}

__global__ void __launch_bounds__(TILE_THREADS, 2)
mamba2_ssd_bwd_tile_kernel(const uint16_t* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const uint16_t* __restrict__ bm,
                           const uint16_t* __restrict__ cm,
                           const float* __restrict__ states,
                           const uint16_t* __restrict__ dy,
                           const float* __restrict__ dsk,
                           uint16_t* __restrict__ dx, float* __restrict__ ddt,
                           float* __restrict__ dbp, float* __restrict__ dcp,
                           float* __restrict__ dap, const Params p) {
  using S = TileSmem;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  uint16_t* cs = reinterpret_cast<uint16_t*>(tile_smem);  // [BQ][CPITCH]
  uint16_t* bs = cs + S::CB;                              // [BQ][CPITCH]
  uint16_t* xs = bs + S::CB;                              // [BQ][XPITCH]
  uint16_t* dys = xs + S::XT;                             // [BQ][XPITCH]
  uint16_t* shi = dys + S::XT;                            // [PP][CPITCH] x 4
  uint16_t* slo = shi + S::ST;
  uint16_t* dshi = slo + S::ST;
  uint16_t* dslo = dshi + S::ST;
  uint16_t* gh = dslo + S::ST;                            // [BQ][GPITCH] x 2
  uint16_t* gl = gh + S::GT;
  float* dts = reinterpret_cast<float*>(gl + S::GT);      // [BQ]
  float* cum = dts + BQ;                                  // [BQ]
  float* ecum = cum + BQ;                                 // [BQ] exp(cum_t)
  float* gq = ecum + BQ;                                  // [BQ] g_s
  float* wq = gq + BQ;                                    // [BQ] w_s
  float* rowk_p = wq + BQ;    // [4][BQ] sum_s K_ts dt_s over a warp's s
  float* colk_p = rowk_p + 4 * BQ;  // [2][BQ] sum_t K_ts over a warp's t
  float* v_p = colk_p + 2 * BQ;     // [4][BQ] V over a warp's p
  float* i_p = v_p + 4 * BQ;        // [4][BQ] I over a warp's n
  float* red = i_p + 4 * BQ;        // [8] per-warp sum(dS * S)
  float* scal = red + 8;            // sum(dS * S), exp(cum_last)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // warp w owns rows 16 mrow .. +15 of every 32-row product, columns
  // 8 cq .. +7 of the (t, s) tile, 16 cq .. +15 of the P-wide products
  // (Z, dx) and 32 cq .. +31 of the N-wide ones (u, Y, dc, db)
  const int mrow = warp & 1, cq = warp >> 1;
  const int r0 = 16 * mrow + g, r1 = r0 + 8;   // this thread's rows
  const int s0 = 8 * cq + 2 * tq;              // its (t, s) columns s0, +1
  // the piece lies wholly above the diagonal (s >= 16 > t): zero
  const bool upper = mrow == 0 && cq >= 2;
  int blk = blockIdx.x;
  const int grp = blk % p.groups;
  blk /= p.groups;
  const int k = blk % p.ntiles, b = blk / p.ntiles;
  const int l0 = k * BQ, qv = min(BQ, p.L - l0);
  const int P = p.P, N = p.N;
  const int h0 = grp * HB, h1 = min(p.H, h0 + HB);

  load_tile<BQ, NN, TILE_THREADS>(cs, CPITCH, cm + b * p.c_sb + l0 * p.c_sl,
                                  p.c_sl, qv, N, p.vec_bc, tid);
  load_tile<BQ, NN, TILE_THREADS>(bs, CPITCH, bm + b * p.b_sb + l0 * p.b_sl,
                                  p.b_sl, qv, N, p.vec_bc, tid);
  cp_async_commit();

  float dcacc[4][4], dbacc[4][4], gdsum[4], cbv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dcacc[j][e] = 0.f;
      dbacc[j][e] = 0.f;
    }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    gdsum[e] = 0.f;
    cbv[e] = 0.f;
  }

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // every read of the last head's tiles is done
    load_tile<BQ, PP, TILE_THREADS>(
        xs, XPITCH, x + b * p.x_sb + l0 * p.x_sl + (size_t)h * P, p.x_sl, qv,
        P, p.vec_x, tid);
    load_tile<BQ, PP, TILE_THREADS>(
        dys, XPITCH, dy + (((size_t)b * p.L + l0) * p.H + h) * P,
        (long long)p.H * P, qv, P, p.vec_dy, tid);
    cp_async_commit();
    if (tid < BQ)
      dts[tid] = tid < qv ? dt[((size_t)b * p.L + l0 + tid) * p.H + h] : 0.f;
    {
      const size_t off = (((size_t)b * p.H + h) * p.ntiles + k) * P * N;
      const float part = warp_sum(stage_states(
          shi, slo, dshi, dslo, states + off, dsk + off, P, N, p.vec_st, tid));
      if (lane == 0) red[warp] = part;
    }
    cp_async_wait<0>();
    __syncthreads();  // x, dy, dt (and at the first head c, b) have landed
    const float ah = a[h];
    if (warp == 0) {
      const float c = warp_scan(dts[lane] * ah, lane);
      const float last = __shfl_sync(FULL, c, 31);
      const float gg = expf(last - c);
      cum[lane] = c;
      ecum[lane] = expf(c);
      gq[lane] = gg;
      wq[lane] = dts[lane] * gg;
      if (lane == 0) {
        float dd = 0.f;
        for (int i = 0; i < TILE_THREADS / 32; ++i) dd += red[i];
        scal[0] = dd;
        scal[1] = expf(last);
      }
    }
    if (h == h0 && !upper) {  // c.b^T, once a block
#pragma unroll
      for (int kk = 0; kk < NN / 16; ++kk) {
        uint32_t af[4], bf[2];
        ldmatrix_a(af, cs + 16 * mrow * CPITCH + 16 * kk, CPITCH, lane);
        ldmatrix_b_nk1(bf, bs + 8 * cq * CPITCH + 16 * kk, CPITCH, lane);
        mma(cbv, af, bf[0], bf[1]);
      }
    }
    __syncthreads();  // cum, exp(cum), g, w are written

    // (a) the warp's piece of the (t, s) tile: dy.x^T, then G, Gd and K
    {
      float mv[4] = {0.f, 0.f, 0.f, 0.f};
      if (!upper) {
#pragma unroll
        for (int kk = 0; kk < PP / 16; ++kk) {
          uint32_t af[4], bf[2];
          ldmatrix_a(af, dys + 16 * mrow * XPITCH + 16 * kk, XPITCH, lane);
          ldmatrix_b_nk1(bf, xs + 8 * cq * XPITCH + 16 * kk, XPITCH, lane);
          mma(mv, af, bf[0], bf[1]);
        }
      }
      float gv[4], kv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = e < 2 ? r0 : r1, s = s0 + (e & 1);
        float gg = 0.f, gd = 0.f, kk = 0.f;
        if (s <= t) {
          const float ee = expf(cum[t] - cum[s]), d = dts[s];
          gg = cbv[e] * ee * d;
          gd = mv[e] * ee * d;
          kk = cbv[e] * mv[e] * ee;
        }
        gv[e] = gg;
        gdsum[e] += gd;
        kv[e] = kk;
      }
      uint32_t hi, lo;
      split2(gv[0], gv[1], hi, lo);
      st32(gh + r0 * GPITCH + s0, hi);
      st32(gl + r0 * GPITCH + s0, lo);
      split2(gv[2], gv[3], hi, lo);
      st32(gh + r1 * GPITCH + s0, hi);
      st32(gl + r1 * GPITCH + s0, lo);
      const float d0 = dts[s0], d1 = dts[s0 + 1];
      float ra = fmaf(kv[1], d1, kv[0] * d0), rb = fmaf(kv[3], d1, kv[2] * d0);
      float ca = kv[0] + kv[2], cb = kv[1] + kv[3];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ra += __shfl_xor_sync(FULL, ra, off);
        rb += __shfl_xor_sync(FULL, rb, off);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        ca += __shfl_xor_sync(FULL, ca, off);
        cb += __shfl_xor_sync(FULL, cb, off);
      }
      if (tq == 0) {
        rowk_p[cq * BQ + r0] = ra;
        rowk_p[cq * BQ + r1] = rb;
      }
      if (g == 0) {
        colk_p[mrow * BQ + s0] = ca;
        colk_p[mrow * BQ + s0 + 1] = cb;
      }
    }

    // (b) Z = b.dS^T (rows s, columns p), kept for dx; V
    float zacc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) zacc[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < NN / 16; ++kk) {
      uint32_t af[4], bh[4], bl[4];
      ldmatrix_a(af, bs + 16 * mrow * CPITCH + 16 * kk, CPITCH, lane);
      ldmatrix_b_nk(bh, dshi + 16 * cq * CPITCH + 16 * kk, CPITCH, lane);
      ldmatrix_b_nk(bl, dslo + 16 * cq * CPITCH + 16 * kk, CPITCH, lane);
      mma(zacc[0], af, bh[0], bh[1]);
      mma(zacc[1], af, bh[2], bh[3]);
      mma(zacc[0], af, bl[0], bl[1]);
      mma(zacc[1], af, bl[2], bl[3]);
    }
    {
      float va = 0.f, vb = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int pc = 16 * cq + 8 * j + 2 * tq;
        const uint32_t xa = ld32(xs + r0 * XPITCH + pc);
        const uint32_t xb = ld32(xs + r1 * XPITCH + pc);
        va = fmaf(bf16_lo(xa), zacc[j][0], va);
        va = fmaf(bf16_hi(xa), zacc[j][1], va);
        vb = fmaf(bf16_lo(xb), zacc[j][2], vb);
        vb = fmaf(bf16_hi(xb), zacc[j][3], vb);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        va += __shfl_xor_sync(FULL, va, off);
        vb += __shfl_xor_sync(FULL, vb, off);
      }
      if (tq == 0) {
        v_p[cq * BQ + r0] = va;
        v_p[cq * BQ + r1] = vb;
      }
    }

    // (c) u = dy.S (rows t, columns n): I, and dc += exp(cum_t) u_t
    {
      float uacc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) uacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_a(af, dys + 16 * mrow * XPITCH + 16 * kk, XPITCH, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bh[4], bl[4];
          const int off = 16 * kk * CPITCH + 32 * cq + 16 * jj;
          ldmatrix_b_kn(bh, shi + off, CPITCH, lane);
          ldmatrix_b_kn(bl, slo + off, CPITCH, lane);
          mma(uacc[2 * jj], af, bh[0], bh[1]);
          mma(uacc[2 * jj + 1], af, bh[2], bh[3]);
          mma(uacc[2 * jj], af, bl[0], bl[1]);
          mma(uacc[2 * jj + 1], af, bl[2], bl[3]);
        }
      }
      const float e0 = ecum[r0], e1 = ecum[r1];
      float ia = 0.f, ib = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 32 * cq + 8 * j + 2 * tq;
        const uint32_t ca = ld32(cs + r0 * CPITCH + n);
        const uint32_t cb = ld32(cs + r1 * CPITCH + n);
        ia = fmaf(bf16_lo(ca), uacc[j][0], ia);
        ia = fmaf(bf16_hi(ca), uacc[j][1], ia);
        ib = fmaf(bf16_lo(cb), uacc[j][2], ib);
        ib = fmaf(bf16_hi(cb), uacc[j][3], ib);
        dcacc[j][0] = fmaf(e0, uacc[j][0], dcacc[j][0]);
        dcacc[j][1] = fmaf(e0, uacc[j][1], dcacc[j][1]);
        dcacc[j][2] = fmaf(e1, uacc[j][2], dcacc[j][2]);
        dcacc[j][3] = fmaf(e1, uacc[j][3], dcacc[j][3]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ia += __shfl_xor_sync(FULL, ia, off);
        ib += __shfl_xor_sync(FULL, ib, off);
      }
      if (tq == 0) {
        i_p[cq * BQ + r0] = ia;
        i_p[cq * BQ + r1] = ib;
      }
    }

    // (d) Y = x.dS (rows s, columns n): db += w_s Y_s
    {
      float yacc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_a(af, xs + 16 * mrow * XPITCH + 16 * kk, XPITCH, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bh[4], bl[4];
          const int off = 16 * kk * CPITCH + 32 * cq + 16 * jj;
          ldmatrix_b_kn(bh, dshi + off, CPITCH, lane);
          ldmatrix_b_kn(bl, dslo + off, CPITCH, lane);
          mma(yacc[2 * jj], af, bh[0], bh[1]);
          mma(yacc[2 * jj + 1], af, bh[2], bh[3]);
          mma(yacc[2 * jj], af, bl[0], bl[1]);
          mma(yacc[2 * jj + 1], af, bl[2], bl[3]);
        }
      }
      const float w0 = wq[r0], w1 = wq[r1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dbacc[j][0] = fmaf(w0, yacc[j][0], dbacc[j][0]);
        dbacc[j][1] = fmaf(w0, yacc[j][1], dbacc[j][1]);
        dbacc[j][2] = fmaf(w1, yacc[j][2], dbacc[j][2]);
        dbacc[j][3] = fmaf(w1, yacc[j][3], dbacc[j][3]);
      }
    }
    __syncthreads();  // G's hi and lo and every partial sum are written

    // (e) dx = G^T.dy + w Z (rows s, columns p); the block t < 16 <= s of
    // G^T's k is zero
    {
      float acc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int ks = mrow; ks < BQ / 16; ++ks) {
        uint32_t ahi[4], alo[4], bf[4];
        ldmatrix_a_trans(ahi, gh + 16 * ks * GPITCH + 16 * mrow, GPITCH,
                         lane);
        ldmatrix_a_trans(alo, gl + 16 * ks * GPITCH + 16 * mrow, GPITCH,
                         lane);
        ldmatrix_b_kn(bf, dys + 16 * ks * XPITCH + 16 * cq, XPITCH, lane);
        mma(acc[0], ahi, bf[0], bf[1]);
        mma(acc[1], ahi, bf[2], bf[3]);
        mma(acc[0], alo, bf[0], bf[1]);
        mma(acc[1], alo, bf[2], bf[3]);
      }
      const float w0 = wq[r0], w1 = wq[r1];
      uint16_t* dxb = dx + (((size_t)b * p.L + l0) * p.H + h) * P;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int pc = 16 * cq + 8 * j + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r1 : r0;
          if (r >= qv || pc >= P) continue;
          const float w = half ? w1 : w0;
          const uint32_t v =
              pack_bf16x2(fmaf(w, zacc[j][2 * half], acc[j][2 * half]),
                          fmaf(w, zacc[j][2 * half + 1], acc[j][2 * half + 1]));
          uint16_t* o = dxb + (size_t)r * p.H * P + pc;
          if ((P & 1) == 0) {
            st32(o, v);
          } else {
            o[0] = (uint16_t)(v & 0xffffu);
            if (pc + 1 < P) o[1] = (uint16_t)(v >> 16);
          }
        }
      }
    }

    // (f) dcum, then ddt and da: warp 0, a lane a position
    if (warp == 0) {
      const int t = lane;
      const float rowk = rowk_p[t] + rowk_p[BQ + t] + rowk_p[2 * BQ + t] +
                         rowk_p[3 * BQ + t];
      const float colk = colk_p[t] + colk_p[BQ + t];
      const float v = v_p[t] + v_p[BQ + t] + v_p[2 * BQ + t] + v_p[3 * BQ + t];
      const float iv =
          i_p[t] + i_p[BQ + t] + i_p[2 * BQ + t] + i_p[3 * BQ + t];
      const float d = dts[t], w = wq[t];
      float dcum = rowk - d * colk + ecum[t] * iv - w * v;
      const float wv = warp_sum(w * v);
      if (t == BQ - 1) dcum += scal[1] * scal[0] + wv;
      const float rc = warp_rscan(dcum, lane);
      if (t < qv)
        ddt[((size_t)b * p.L + l0 + t) * p.H + h] = colk + gq[t] * v + ah * rc;
      const float dap_t = warp_sum(d * rc);
      if (t == 0) dap[((size_t)b * p.H + h) * p.ntiles + k] = dap_t;
    }
  }

  // dc += Gd.b and db += Gd^T.c, Gd summed over the block's heads
  __syncthreads();  // every read of the last head's G is done
  {
    uint32_t hi, lo;
    split2(gdsum[0], gdsum[1], hi, lo);
    st32(gh + r0 * GPITCH + s0, hi);
    st32(gl + r0 * GPITCH + s0, lo);
    split2(gdsum[2], gdsum[3], hi, lo);
    st32(gh + r1 * GPITCH + s0, hi);
    st32(gl + r1 * GPITCH + s0, lo);
  }
  __syncthreads();
  for (int ks = 0; ks <= mrow; ++ks) {  // s <= t: the block s >= 16 > t is 0
    uint32_t ahi[4], alo[4];
    ldmatrix_a(ahi, gh + 16 * mrow * GPITCH + 16 * ks, GPITCH, lane);
    ldmatrix_a(alo, gl + 16 * mrow * GPITCH + 16 * ks, GPITCH, lane);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t bf[4];
      ldmatrix_b_kn(bf, bs + 16 * ks * CPITCH + 32 * cq + 16 * jj, CPITCH,
                    lane);
      mma(dcacc[2 * jj], ahi, bf[0], bf[1]);
      mma(dcacc[2 * jj + 1], ahi, bf[2], bf[3]);
      mma(dcacc[2 * jj], alo, bf[0], bf[1]);
      mma(dcacc[2 * jj + 1], alo, bf[2], bf[3]);
    }
  }
  for (int ks = mrow; ks < BQ / 16; ++ks) {  // t >= s
    uint32_t ahi[4], alo[4];
    ldmatrix_a_trans(ahi, gh + 16 * ks * GPITCH + 16 * mrow, GPITCH, lane);
    ldmatrix_a_trans(alo, gl + 16 * ks * GPITCH + 16 * mrow, GPITCH, lane);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t bf[4];
      ldmatrix_b_kn(bf, cs + 16 * ks * CPITCH + 32 * cq + 16 * jj, CPITCH,
                    lane);
      mma(dbacc[2 * jj], ahi, bf[0], bf[1]);
      mma(dbacc[2 * jj + 1], ahi, bf[2], bf[3]);
      mma(dbacc[2 * jj], alo, bf[0], bf[1]);
      mma(dbacc[2 * jj + 1], alo, bf[2], bf[3]);
    }
  }
  const size_t part_off = (((size_t)b * p.groups + grp) * p.L + l0) * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 32 * cq + 8 * j + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= qv || n >= N) continue;
      float* oc = dcp + part_off + (size_t)r * N + n;
      float* ob = dbp + part_off + (size_t)r * N + n;
      if ((N & 1) == 0) {
        *reinterpret_cast<float2*>(oc) =
            make_float2(dcacc[j][2 * half], dcacc[j][2 * half + 1]);
        *reinterpret_cast<float2*>(ob) =
            make_float2(dbacc[j][2 * half], dbacc[j][2 * half + 1]);
      } else {
        oc[0] = dcacc[j][2 * half];
        ob[0] = dbacc[j][2 * half];
        if (n + 1 < N) {
          oc[1] = dcacc[j][2 * half + 1];
          ob[1] = dbacc[j][2 * half + 1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;      // 16 x 16
constexpr int TQ = BQ / 16;       // tile rows / columns a thread owns
constexpr int TP = MAX_P / 16;
constexpr int TN = MAX_N / 16;
constexpr int GP = BQ + 1;        // pitch of the (t, s) tiles
constexpr int PASS_ROWS = 16;      // rows of P an f32 pass block carries
constexpr int PASS_F32_THREADS = 128;  // 4 x 32: rows ty + 4 i, cols tx + 32 j

__global__ void __launch_bounds__(PASS_F32_THREADS)
mamba2_ssd_bwd_pass_f32_kernel(const float* __restrict__ dy,
                               const float* __restrict__ dt,
                               const float* __restrict__ a,
                               const float* __restrict__ cm,
                               const float* __restrict__ dsf,
                               float* __restrict__ dsk,
                               float* __restrict__ ds0, const Params p) {
  __shared__ float cs[BQ * MAX_N];        // [BQ][MAX_N]
  __shared__ float dys[BQ * PASS_ROWS];   // [BQ][16]
  const int tid = threadIdx.x, lane = tid & 31, ty = tid >> 5, tx = lane;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int p0 = blockIdx.y * PASS_ROWS;
  const int prow = min(PASS_ROWS, p.P - p0);
  const int N = p.N, nt = p.ntiles;
  const float ah = a[h];
  const float* cb = cm + b * p.c_sb;
  const float* dyb = dy + ((size_t)b * p.L * p.H + h) * p.P + p0;
  const float* dtb = dt + (size_t)b * p.L * p.H + h;
  const size_t st_off = (size_t)bh * p.P * N;

  float acc[4][4];  // rows ty + 4 i, columns tx + 32 j of the slice
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 4 * i, c = tx + 32 * j;
      acc[i][j] = (dsf != nullptr && r < prow && c < N)
                      ? dsf[st_off + (size_t)(p0 + r) * N + c]
                      : 0.f;
    }
  for (int k = nt - 1; k >= 0; --k) {
    const int l0 = k * BQ, qv = min(BQ, p.L - l0);
    __syncthreads();  // the last tile's reads are done
    for (int i = tid; i < BQ * MAX_N; i += PASS_F32_THREADS) {
      const int t = i / MAX_N, n = i - t * MAX_N;
      cs[i] = (t < qv && n < N) ? cb[(l0 + t) * p.c_sl + n] : 0.f;
    }
    for (int i = tid; i < BQ * PASS_ROWS; i += PASS_F32_THREADS) {
      const int t = i / PASS_ROWS, r = i - t * PASS_ROWS;
      dys[i] = (t < qv && r < prow)
                   ? dyb[(size_t)(l0 + t) * p.H * p.P + r]
                   : 0.f;
    }
    {
      float* out = dsk + (((size_t)bh * nt + k) * p.P + p0) * N;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 4 * i, c = tx + 32 * j;
          if (r < prow && c < N) out[(size_t)r * N + c] = acc[i][j];
        }
    }
    const float dtv = lane < qv ? dtb[(size_t)(l0 + lane) * p.H] : 0.f;
    const float cum = warp_scan(dtv * ah, lane);
    const float ecum = expf(cum);
    const float dec = expf(__shfl_sync(FULL, cum, 31));
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= dec;
    for (int t = 0; t < BQ; ++t) {
      const float e = __shfl_sync(FULL, ecum, t);
      float gv[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = dys[t * PASS_ROWS + ty + 4 * i] * e;
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = cs[t * MAX_N + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], cv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 4 * i, c = tx + 32 * j;
      if (r < prow && c < N) ds0[st_off + (size_t)(p0 + r) * N + c] = acc[i][j];
    }
}

// the sum of v over the 16 lanes that share a ty (lanes 0-15 and 16-31 of
// a warp are two rows), in a fixed order
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
mamba2_ssd_bwd_tile_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ dt,
                               const float* __restrict__ a,
                               const float* __restrict__ bm,
                               const float* __restrict__ cm,
                               const float* __restrict__ states,
                               const float* __restrict__ dy,
                               const float* __restrict__ dsk,
                               float* __restrict__ dx,
                               float* __restrict__ ddt,
                               float* __restrict__ dbp,
                               float* __restrict__ dcp,
                               float* __restrict__ dap, const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int NP = p.NP, XP = p.XP, P = p.P, N = p.N;
  float* cs = smem;                  // [BQ][NP] c of the tile
  float* bs = cs + BQ * NP;          // [BQ][NP] b of the tile
  float* xs = bs + BQ * NP;          // [BQ][XP] x of the tile (this head)
  float* dys = xs + BQ * XP;         // [BQ][XP] dy of the tile
  float* S = dys + BQ * XP;          // [P][NP]  the state entering the tile
  float* dS = S + P * NP;            // [P][NP]  cotangent of the state out
  float* G = dS + P * NP;            // [BQ][GP] (c_t . b_s) E_ts dt_s
  float* Gd = G + BQ * GP;           // [BQ][GP] (dy_t . x_s) E_ts dt_s
  float* K = Gd + BQ * GP;           // [BQ][GP] (c_t . b_s)(dy_t . x_s) E_ts
  float* dts = K + BQ * GP;          // [BQ]
  float* cum = dts + BQ;             // [BQ]
  float* ecum = cum + BQ;            // [BQ] exp(cum_t)
  float* gq = ecum + BQ;             // [BQ] exp(cum_last - cum_s)
  float* vv = gq + BQ;               // [BQ] V_s
  float* iv = vv + BQ;               // [BQ] I_t
  float* red = iv + BQ;              // [8]  per-warp partials of sum(dS * S)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  int blk = blockIdx.x;
  const int grp = blk % p.groups;
  blk /= p.groups;
  const int k = blk % p.ntiles, b = blk / p.ntiles;
  const int l0 = k * BQ, qv = min(BQ, p.L - l0);
  const int h0 = grp * HB, h1 = min(p.H, h0 + HB);

  for (int i = tid; i < BQ * N; i += THREADS) {
    const int t = i / N, n = i - t * N;
    float cv = 0.f, bv = 0.f;
    if (t < qv) {
      cv = cm[b * p.c_sb + (l0 + t) * p.c_sl + n];
      bv = bm[b * p.b_sb + (l0 + t) * p.b_sl + n];
    }
    cs[t * NP + n] = cv;
    bs[t * NP + n] = bv;
  }

  // the clamped columns of this thread (reads stay inside the tiles; the
  // writes past P or N are skipped)
  int pc[TP], nc[TN];
#pragma unroll
  for (int j = 0; j < TP; ++j) pc[j] = min(tx + 16 * j, P - 1);
#pragma unroll
  for (int j = 0; j < TN; ++j) nc[j] = min(tx + 16 * j, N - 1);

  // dc and db of rows ty + 16 i, columns tx + 16 j, summed over the heads
  float dcacc[TQ][TN], dbacc[TQ][TN];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      dcacc[i][j] = 0.f;
      dbacc[i][j] = 0.f;
    }

  for (int h = h0; h < h1; ++h) {
    const float ah = a[h];
    __syncthreads();  // the last head's reads are done
    for (int i = tid; i < BQ * P; i += THREADS) {
      const int t = i / P, pp = i - t * P;
      float xv = 0.f, gv = 0.f;
      if (t < qv) {
        xv = x[b * p.x_sb + (l0 + t) * p.x_sl + (size_t)h * P + pp];
        gv = dy[(((size_t)b * p.L + l0 + t) * p.H + h) * P + pp];
      }
      xs[t * XP + pp] = xv;
      dys[t * XP + pp] = gv;
    }
    {
      const size_t off = (((size_t)b * p.H + h) * p.ntiles + k) * P * N;
      for (int i = tid; i < P * N; i += THREADS) {
        const int pi = i / N, n = i - pi * N;
        S[pi * NP + n] = states[off + i];
        dS[pi * NP + n] = dsk[off + i];
      }
    }
    if (tid < BQ)
      dts[tid] = tid < qv ? dt[((size_t)b * p.L + l0 + tid) * p.H + h] : 0.f;
    __syncthreads();

    if (warp == 0) {
      const float s = warp_scan(dts[lane] * ah, lane);
      const float last = __shfl_sync(FULL, s, 31);
      cum[lane] = s;
      ecum[lane] = expf(s);
      gq[lane] = expf(last - s);
    }
    __syncthreads();

    // phase 1.  (a) the (t, s) tiles; (b) sum(dS * S); (c) Z, V; (d) u, I
    // and dc += exp(cum) u; (e) Y and db += w Y.  Z stays in registers.
    {
      float cbv[TQ][TQ], mv[TQ][TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) { cbv[i][j] = 0.f; mv[i][j] = 0.f; }
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
            cbv[i][j] = fmaf(av[i], bv[j], cbv[i][j]);
      }
#pragma unroll 4
      for (int q = 0; q < P; ++q) {
        float av[TQ], bv[TQ];
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          av[i] = dys[(ty + 16 * i) * XP + q];
          bv[i] = xs[(tx + 16 * i) * XP + q];
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)
            mv[i][j] = fmaf(av[i], bv[j], mv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          const int s = tx + 16 * j;
          float g = 0.f, gd = 0.f, kk = 0.f;
          if (s <= t) {
            const float e = expf(cum[t] - cum[s]);
            g = cbv[i][j] * e * dts[s];
            gd = mv[i][j] * e * dts[s];
            kk = cbv[i][j] * mv[i][j] * e;
          }
          G[t * GP + s] = g;
          Gd[t * GP + s] = gd;
          K[t * GP + s] = kk;
        }
      }
    }
    {
      float part = 0.f;
      for (int i = tid; i < P * N; i += THREADS) {
        const int pi = i / N, n = i - pi * N;
        part = fmaf(dS[pi * NP + n], S[pi * NP + n], part);
      }
      part = warp_sum(part);
      if (lane == 0) red[warp] = part;
    }
    float z[TQ][TP];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TP; ++j) z[i][j] = 0.f;
    // Z[s][p] = sum_n b[s][n] dS[p][n]
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      float bv[TQ], sv[TP];
#pragma unroll
      for (int i = 0; i < TQ; ++i) bv[i] = bs[(ty + 16 * i) * NP + n];
#pragma unroll
      for (int j = 0; j < TP; ++j) sv[j] = dS[pc[j] * NP + n];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) z[i][j] = fmaf(bv[i], sv[j], z[i][j]);
    }
    {
      // u[t][n] = sum_p dy[t][p] S[p][n];  Y[s][n] = sum_p x[s][p] dS[p][n]
      float u[TQ][TN], yv[TQ][TN];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) { u[i][j] = 0.f; yv[i][j] = 0.f; }
#pragma unroll 2
      for (int q = 0; q < P; ++q) {
        float gv[TQ], xv[TQ], sv[TN], dv[TN];
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          gv[i] = dys[(ty + 16 * i) * XP + q];
          xv[i] = xs[(ty + 16 * i) * XP + q];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          sv[j] = S[q * NP + nc[j]];
          dv[j] = dS[q * NP + nc[j]];
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            u[i][j] = fmaf(gv[i], sv[j], u[i][j]);
            yv[i][j] = fmaf(xv[i], dv[j], yv[i][j]);
          }
      }
      // V_s = x_s . Z_s and I_t = c_t . u_t, over this thread's columns and
      // then its row's 16 lanes; dc += exp(cum_t) u_t, db += w_s Y_s
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int r = ty + 16 * i;
        const float e = ecum[r], w = dts[r] * gq[r];
        float v = 0.f, wi = 0.f;
#pragma unroll
        for (int j = 0; j < TP; ++j)
          if (tx + 16 * j < P) v = fmaf(xs[r * XP + pc[j]], z[i][j], v);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (tx + 16 * j < N) wi = fmaf(cs[r * NP + nc[j]], u[i][j], wi);
          dcacc[i][j] = fmaf(e, u[i][j], dcacc[i][j]);
          dbacc[i][j] = fmaf(w, yv[i][j], dbacc[i][j]);
        }
        v = sum16(v);
        wi = sum16(wi);
        if (tx == 0) {
          vv[r] = v;
          iv[r] = wi;
        }
      }
    }
    __syncthreads();

    // phase 2: dx, the intra terms of dc and db (rows ty + 16 i), and in
    // warp 0 dcum -> ddt and da
    {
      float acc[TQ][TP];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) acc[i][j] = 0.f;
      for (int t = 0; t < BQ; ++t) {
        float gv[TQ], dv[TP];
#pragma unroll
        for (int i = 0; i < TQ; ++i) gv[i] = G[t * GP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TP; ++j) dv[j] = dys[t * XP + pc[j]];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j)
            acc[i][j] = fmaf(gv[i], dv[j], acc[i][j]);
      }
      float* dxb = dx + (((size_t)b * p.L + l0) * p.H + h) * P;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int s = ty + 16 * i;
        if (s >= qv) continue;
        const float w = dts[s] * gq[s];
        float* row = dxb + (size_t)s * p.H * P;
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          const int pp = tx + 16 * j;
          if (pp < P) row[pp] = fmaf(w, z[i][j], acc[i][j]);
        }
      }
    }
    for (int s = 0; s < BQ; ++s) {
      float g1[TQ], g2[TQ], bv[TN], cv[TN];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        g1[i] = Gd[(ty + 16 * i) * GP + s];  // Gd[t = row][s]
        g2[i] = Gd[s * GP + ty + 16 * i];    // Gd[t = s][s = row]
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bv[j] = bs[s * NP + nc[j]];
        cv[j] = cs[s * NP + nc[j]];
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          dcacc[i][j] = fmaf(g1[i], bv[j], dcacc[i][j]);
          dbacc[i][j] = fmaf(g2[i], cv[j], dbacc[i][j]);
        }
    }
    if (warp == 0) {  // dcum, then ddt and da, a lane a position
      const int t = lane;
      float rowk = 0.f, colk = 0.f;
      for (int s = 0; s < BQ; ++s) {
        rowk = fmaf(K[t * GP + s], dts[s], rowk);
        colk += K[s * GP + t];
      }
      const float d = dts[t], g = gq[t], w = d * g, v = vv[t];
      float dcum = rowk - d * colk + ecum[t] * iv[t] - w * v;
      const float wv = warp_sum(w * v);
      if (t == BQ - 1) {
        float dd = 0.f;
        for (int i = 0; i < THREADS / 32; ++i) dd += red[i];
        dcum += expf(cum[BQ - 1]) * dd + wv;
      }
      const float rc = warp_rscan(dcum, lane);
      if (t < qv)
        ddt[((size_t)b * p.L + l0 + t) * p.H + h] = colk + g * v + ah * rc;
      const float dap_t = warp_sum(d * rc);
      if (t == 0) dap[((size_t)b * p.H + h) * p.ntiles + k] = dap_t;
    }
  }
  const size_t part_off = (((size_t)b * p.groups + grp) * p.L + l0) * N;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int r = ty + 16 * i;
    if (r >= qv) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 16 * j;
      if (n >= N) continue;
      dcp[part_off + (size_t)r * N + n] = dcacc[i][j];
      dbp[part_off + (size_t)r * N + n] = dbacc[i][j];
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// dtype codes (x, b, c, dy, dx): 0 float32 (CUDA cores), 1 bfloat16
// (tensor cores).  Strides are in elements: x's (H, P) axes and b's and
// c's N axis are contiguous, with their batch and position strides given;
// dt, a, tile_states (B, H, n_tiles, P, N) with n_tiles = ceil(L /
// block_l), dy and every output are contiguous.  state_grad may be null
// (zeros).  ds_tiles (B, H, n_tiles, P, N) f32 is the pass's scratch: dS_k
// for every tile.  Outputs: dx (B, L, H, P) in the input dtype, ddt (B, L,
// H), db and dc partials (B, ceil(H / HB), L, N), da partials (B, H,
// n_tiles) and the initial state's gradient (B, H, P, N), all f32 but dx.
// The grids are the planner's (dse.plan_ssd_bwd_blocks): the pass's
// (pass_x, pass_y) blocks, (B H, 1) in bf16 and (B H, row blocks of
// PASS_ROWS) in f32, and the tile kernel's (tile_b, tile_k, tile_g) = (B,
// n_tiles, head groups of HB); a grid that does not cover the problem
// exactly once is refused.  Launches the pass, then the tile kernel, on
// `stream`.
extern "C" int mamba2_ssd_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* tile_states, const void* dy,
    const void* state_grad, void* ds_tiles, void* dx, void* ddt,
    void* db_part, void* dc_part, void* da_part, void* d_init_state,
    int dtype, int B, int L, int H, int P, int N, long long x_sb,
    long long x_sl, long long b_sb, long long b_sl, long long c_sb,
    long long c_sl, int block_l, int pass_x, int pass_y, int tile_b,
    int tile_k, int tile_g, void* stream) {
  // `covers(n, w, m)`: n blocks of width w cover m, none of them empty
  auto covers = [](long long n, long long w, long long m) {
    return n >= 1 && (n - 1) * w < m && m <= n * w;
  };
  if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || P > MAX_P ||
      N > MAX_N || (dtype != 0 && dtype != 1) || block_l != BQ ||
      pass_x != (long long)B * H || tile_b != B || !covers(tile_k, BQ, L) ||
      !covers(tile_g, HB, H) ||
      !(dtype == 1 ? pass_y == 1 : covers(pass_y, PASS_ROWS, P)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.L = L; p.H = H; p.P = P; p.N = N;
  p.ntiles = tile_k;
  p.groups = tile_g;
  p.NP = N | 1;  // odd pitches: conflict-free column reads (f32)
  p.XP = P | 1;
  p.x_sb = x_sb; p.x_sl = x_sl; p.b_sb = b_sb; p.b_sl = b_sl;
  p.c_sb = c_sb; p.c_sl = c_sl;
  // 16-byte rows: every row start and column piece on a 16-byte boundary
  p.vec_x = aligned16(x) && x_sb % 8 == 0 && x_sl % 8 == 0 && P % 8 == 0;
  p.vec_bc = aligned16(bm) && aligned16(cm) && b_sb % 8 == 0 &&
             b_sl % 8 == 0 && c_sb % 8 == 0 && c_sl % 8 == 0 && N % 8 == 0;
  p.vec_dy = aligned16(dy) && P % 8 == 0;
  p.vec_st = aligned16(tile_states) && aligned16(ds_tiles) && N % 4 == 0;
  const long long tile_blocks = (long long)tile_b * tile_k * tile_g;
  if (tile_blocks > 2147483647LL || pass_y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* stf = static_cast<const float*>(tile_states);
  const float* dsf = static_cast<const float*>(state_grad);
  float* dsk = static_cast<float*>(ds_tiles);
  float* ddtf = static_cast<float*>(ddt);
  float* dbf = static_cast<float*>(db_part);
  float* dcf = static_cast<float*>(dc_part);
  float* daf = static_cast<float*>(da_part);
  float* ds0 = static_cast<float*>(d_init_state);
  cudaError_t err;
  if (dtype == 1) {
    mamba2_ssd_bwd_pass_kernel<<<(unsigned)pass_x, PASS_THREADS, 0, s>>>(
        static_cast<const uint16_t*>(dy), dtf, af,
        static_cast<const uint16_t*>(cm), dsf, dsk, ds0, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // once (thread-safe static initialisation)
    static const cudaError_t attr = cudaFuncSetAttribute(
        mamba2_ssd_bwd_tile_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TileSmem::BYTES);
    if (attr != cudaSuccess) return (int)attr;
    mamba2_ssd_bwd_tile_kernel<<<(unsigned)tile_blocks, TILE_THREADS,
                                 TileSmem::BYTES, s>>>(
        static_cast<const uint16_t*>(x), dtf, af,
        static_cast<const uint16_t*>(bm), static_cast<const uint16_t*>(cm),
        stf, static_cast<const uint16_t*>(dy), dsk,
        static_cast<uint16_t*>(dx), ddtf, dbf, dcf, daf, p);
    return (int)cudaGetLastError();
  }
  const dim3 pass_grid((unsigned)pass_x, (unsigned)pass_y);
  mamba2_ssd_bwd_pass_f32_kernel<<<pass_grid, PASS_F32_THREADS, 0, s>>>(
      static_cast<const float*>(dy), dtf, af, static_cast<const float*>(cm),
      dsf, dsk, ds0, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = 4 * (2 * (size_t)BQ * p.NP + 2 * (size_t)BQ * p.XP +
                           2 * (size_t)p.P * p.NP + 3 * (size_t)BQ * GP +
                           6 * BQ + 8);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr_f32 = cudaFuncSetAttribute(
      mamba2_ssd_bwd_tile_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr_f32 != cudaSuccess) return (int)attr_f32;
  mamba2_ssd_bwd_tile_f32_kernel<<<(unsigned)tile_blocks, THREADS, smem, s>>>(
      static_cast<const float*>(x), dtf, af, static_cast<const float*>(bm),
      static_cast<const float*>(cm), stf, static_cast<const float*>(dy), dsk,
      static_cast<float*>(dx), ddtf, dbf, dcf, daf, p);
  return (int)cudaGetLastError();
}

extern "C" const char* mamba2_ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
