// Mamba-2 SSD (state-space duality) chunked scan for NVIDIA Hopper
// (sm_90a), CUDA cores, f32 arithmetic.  Replaces the TPU kernel
// src/repro/kernels/mamba2_ssd.py:26 _ssd_kernel.  Per chunk of QT
// positions (cum_t = sum_{i<=t} dt_i a, within the chunk):
//
//   y_intra[t] = sum_{s<=t} exp(cum_t - cum_s) dt_s (c_t . b_s) x_s
//   y_inter[t] = exp(cum_t) c_t . S
//   S         <- exp(cum_last) S + sum_s exp(cum_last - cum_s) dt_s x_s (x) b_s
//
// x (B, L, H, P) and b, c (B, L, N) in T (f32 or bf16), with the strides
// of their batch and position axes given (the model hands in column
// slices of one projection, so nothing is copied); dt (B, L, H) and
// a (H,) f32; init state (B, H, P, N) f32.  y (B, L, H, P) in T (the sum
// is f32, rounded once), final state (B, H, P, N) f32.
//
// One block owns one (batch, head) and walks the positions QT = 32 at a
// time: the TPU kernel's sequential chunk grid axis becomes this loop, and
// the head's (P, N) state lives in shared memory across it.  Heads
// are independent, so B x H blocks run in parallel.  The chunked scan
// is exact for any chunk length, so the block's own tile does not depend
// on the caller's chunk; a ragged last tile is masked (dt, x, b and c
// read as 0 past L, which leaves cum and the state untouched).
//
// Per tile, every product is a small matrix product out of shared memory:
// 256 threads as 16 x 16 (ty, tx), thread (ty, tx) owning rows
// ty + 16 i and columns tx + 16 j of the output, so that within a warp the
// row operand is 2 addresses (broadcast) and the column operand 16
// consecutive or odd-pitched ones (no bank conflicts; rows of c, b and S
// have an odd pitch).  exp(cum_t - cum_s) is computed only for s <= t
// (above the diagonal it would overflow for a decaying a and is not
// needed); the causal half of c . b^T is skipped where a whole 16 x 16
// sub-tile lies above the diagonal.
//
// At mamba2-1.3b prefill (B 4, L 1024, H 64, P 64, N 128) a call moves
// about 87 MB and does about 10 GFLOP: the bound is bytes (26 us at
// 3.35 TB/s); this kernel is limited by shared-memory traffic on the CUDA
// cores and by one block per (batch, head).  With 32-position tiles two
// blocks share an SM, and all B x H blocks run in one wave.
//
// Plain C interface (loaded with ctypes): the kernel allocates nothing
// and does not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for

struct Params {
  int L, H, P, N, NP;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba2_ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ sf, const Params p) {
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

  for (int l0 = 0; l0 < p.L; l0 += QT) {
    const int qv = min(QT, p.L - l0);
    __syncthreads();  // the last tile's reads are done, S is written
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

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* s0, void* y, float* sf,
           const Params& p, int blocks, cudaStream_t stream) {
  auto kern = mamba2_ssd_kernel<T>;
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
      static_cast<const T*>(cm), s0, static_cast<T*>(y), sf, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes (x, b, c, y): 0 float32, 1 bfloat16.  Strides are in
// elements; x's (H, P) axes, b's and c's N axis, dt, a, the states and y
// are contiguous.
extern "C" int mamba2_ssd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* s0, void* y, void* sf, int dtype, int B,
    int L, int H, int P, int N, long long x_sb, long long x_sl,
    long long b_sb, long long b_sl, long long c_sb, long long c_sl,
    void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || P > MAX_P ||
      N > MAX_N || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.L = L; p.H = H; p.P = P; p.N = N;
  p.NP = (N % 2) ? N : N + 1;  // odd pitch: conflict-free column reads
  p.x_sb = x_sb; p.x_sl = x_sl; p.b_sb = b_sb; p.b_sl = b_sl;
  p.c_sb = c_sb; p.c_sl = c_sl;
  const long long blocks = (long long)B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* s0f = static_cast<const float*>(s0);
  float* sff = static_cast<float*>(sf);
  if (dtype == 0)
    return launch<float>(x, dtf, af, bm, cm, s0f, y, sff, p, (int)blocks,
                         s);
  return launch<__nv_bfloat16>(x, dtf, af, bm, cm, s0f, y, sff, p,
                               (int)blocks, s);
}

extern "C" const char* mamba2_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
