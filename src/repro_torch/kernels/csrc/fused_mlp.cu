// Fused (gated) MLP for NVIDIA Hopper (sm_90a), CUDA cores, f32
// arithmetic.  Replaces the TPU kernel
// src/repro/kernels/fused_mlp.py:37 _fused_mlp_kernel:
//
//   out = down(act(x . Wg) * (x . Wu))      (gated)
//   out = down(act(x . Wu))                 (ungated)
//
// with the (M, F) hidden never written to device memory.  At prefill
// (M in the thousands) it is bound by operations; at decode (M of a few
// rows) by the bytes of the three weight matrices.
//
// x (M, D), Wg / Wu (D, F), Wd (F, D), all of one type T (f32 or bf16);
// out (M, D) in T.  Every product and the hidden are f32; only the output
// is rounded to T.
//
// One block owns R rows of x and a range of hidden columns (a "split" of
// F) and walks that range BF = 64 columns at a time: the TPU kernel's
// sequential f grid axis becomes this loop.  The block's x rows sit in
// shared memory as f32, transposed (d-major) so a thread reads its R
// values with vector loads.  Per hidden tile:
//
//   phase A  up and gate (R x BF) = x_tile . W[:, tile]: 256 threads as
//            64 hidden columns x 4 slices of D, each thread sums its slice
//            for all R rows (every weight element is read once per block
//            and used R times); the 4 slices meet in shared memory, the
//            activation and the gate product give the hidden tile h;
//   phase B  acc (R x D) += h . Wd[tile, :]: thread t keeps the output
//            columns t, t + 256, ... (C of them) for all R rows in
//            registers, so the (R, D) accumulator never leaves the block.
//
// R x C = 64 accumulators per thread (C = D / 256 rounded up to a power
// of two, R = 64 / C capped at 16) bounds D at 256 x 32 = 8192.  When the
// rows alone give too few blocks to fill the card (decode), F is split
// across blocks: each writes an f32 partial (R, D) to a workspace and a
// second pass sums the partials in split order and rounds — a fixed
// order, so the result does not depend on scheduling.
//
// Plain C interface (loaded with ctypes): the kernels allocate nothing
// and do not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BF = 64;            // hidden columns per tile
constexpr int DSLICES = THREADS / BF;
constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for

struct Params {
  int M, D, F, act, gated, tiles_per_split, splits;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

// 0 silu, 1 gelu (tanh form, as jax.nn.gelu), 2 relu, 3 squared relu
__device__ __forceinline__ float activate(int act, float v) {
  switch (act) {
    case 0: return v / (1.f + expf(-v));
    case 1: {
      const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(inner));
    }
    case 2: return fmaxf(v, 0.f);
    default: {
      const float r = fmaxf(v, 0.f);
      return r * r;
    }
  }
}

// R consecutive floats from shared memory (R is 2, 4, 8 or 16)
template <int R>
__device__ __forceinline__ void load_rows(const float* src, float (&dst)[R]) {
  if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(src + 4 * g);
      dst[4 * g] = t.x; dst[4 * g + 1] = t.y;
      dst[4 * g + 2] = t.z; dst[4 * g + 3] = t.w;
    }
  }
}

template <typename T, int R, int C>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                 const T* __restrict__ wu, const T* __restrict__ wd,
                 T* __restrict__ out, float* __restrict__ part,
                 const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // [D][R]  x rows, d-major
  float* red = xs + (size_t)p.D * R;       // [2][DSLICES][BF][R] partial up / gate
  float* hs = red + 2 * DSLICES * BF * R;  // [BF][R] hidden tile

  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.splits;
  const int m0 = (blockIdx.x / p.splits) * R;
  const int rows = min(R, p.M - m0);

  for (int i = tid; i < R * p.D; i += THREADS) {
    const int r = i / p.D, d = i - r * p.D;
    xs[d * R + r] = r < rows ? to_f32(x[(size_t)(m0 + r) * p.D + d]) : 0.f;
  }

  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[r][j] = 0.f;

  const int fl = tid % BF, slice = tid / BF;
  const int n_tiles = (p.F + BF - 1) / BF;
  const int t_begin = split * p.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_split);

  for (int t = t_begin; t < t_end; ++t) {
    const int f0 = t * BF;
    const int f = f0 + fl;
    __syncthreads();  // xs is written; the last tile's reads of hs are done

    // phase A: this thread's slice of D for hidden column f, all R rows
    float u[R], g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) { u[r] = 0.f; g[r] = 0.f; }
    if (f < p.F) {
      const T* wu_col = wu + f;
      const T* wg_col = wg + f;
#pragma unroll 4
      for (int d = slice; d < p.D; d += DSLICES) {
        float xv[R];
        load_rows<R>(xs + d * R, xv);
        const float vu = to_f32(wu_col[(size_t)d * p.F]);
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = fmaf(xv[r], vu, u[r]);
        if (p.gated) {
          const float vg = to_f32(wg_col[(size_t)d * p.F]);
#pragma unroll
          for (int r = 0; r < R; ++r) g[r] = fmaf(xv[r], vg, g[r]);
        }
      }
    }
    float* red_u = red + (slice * BF + fl) * R;
    float* red_g = red + ((DSLICES + slice) * BF + fl) * R;
#pragma unroll
    for (int r = 0; r < R; ++r) { red_u[r] = u[r]; red_g[r] = g[r]; }
    __syncthreads();
    for (int e = tid; e < BF * R; e += THREADS) {
      const int c = e / R, r = e - c * R;
      float su = 0.f, sg = 0.f;
#pragma unroll
      for (int s = 0; s < DSLICES; ++s) {
        su += red[(s * BF + c) * R + r];
        sg += red[((DSLICES + s) * BF + c) * R + r];
      }
      float h = p.gated ? activate(p.act, sg) * su : activate(p.act, su);
      hs[c * R + r] = (f0 + c < p.F) ? h : 0.f;
    }
    __syncthreads();

    // phase B: acc += h . Wd[f0 .. f0 + BF, :]
    const int kn = min(BF, p.F - f0);
#pragma unroll 2
    for (int k = 0; k < kn; ++k) {
      float hv[R];
      load_rows<R>(hs + k * R, hv);
      const T* wrow = wd + (size_t)(f0 + k) * p.D;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int d = tid + THREADS * j;
        if (d < p.D) {
          const float w = to_f32(wrow[d]);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] = fmaf(hv[r], w, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int d = tid + THREADS * j;
      if (d >= p.D) continue;
      const size_t off = (size_t)(m0 + r) * p.D + d;
      if (p.splits == 1)
        store(out + off, acc[r][j]);
      else
        part[(size_t)split * p.M * p.D + off] = acc[r][j];
    }
  }
}

// out = sum over splits of part, in split order, rounded to T
template <typename T>
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ part, T* __restrict__ out,
                    int splits, long long n) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
    store(out + i, s);
  }
}

size_t smem_bytes(int R, int D) {
  return 4 * ((size_t)D * R + 2 * DSLICES * BF * R + (size_t)BF * R);
}

template <typename T, int R, int C>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* out, float* part, const Params& p, cudaStream_t stream) {
  auto kern = fused_mlp_kernel<T, R, C>;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = smem_bytes(R, p.D);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long m_tiles = (p.M + R - 1) / R;
  const long long blocks = m_tiles * p.splits;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kern<<<(int)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(out), part, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long n = (long long)p.M * p.D;
  const long long grid = (n + THREADS - 1) / THREADS;
  sum_partials_kernel<T><<<(int)(grid < 65535 ? grid : 65535), THREADS, 0,
                           stream>>>(part, static_cast<T*>(out), p.splits, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rc(const void* x, const void* wg, const void* wu, const void* wd,
              void* out, float* part, const Params& p, int rows, int cols,
              cudaStream_t s) {
  if (rows == 16 && cols == 1) return launch<T, 16, 1>(x, wg, wu, wd, out, part, p, s);
  if (rows == 16 && cols == 2) return launch<T, 16, 2>(x, wg, wu, wd, out, part, p, s);
  if (rows == 16 && cols == 4) return launch<T, 16, 4>(x, wg, wu, wd, out, part, p, s);
  if (rows == 8 && cols == 8) return launch<T, 8, 8>(x, wg, wu, wd, out, part, p, s);
  if (rows == 4 && cols == 16) return launch<T, 4, 16>(x, wg, wu, wd, out, part, p, s);
  if (rows == 2 && cols == 32) return launch<T, 2, 32>(x, wg, wu, wd, out, part, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  act: 0 silu, 1 gelu (tanh), 2 relu,
// 3 squared relu.  wg may be null when gated is 0.  (rows, cols) is one of
// the instantiated tiles; part holds splits x M x D floats when splits > 1.
extern "C" int fused_mlp_launch(
    const void* x, const void* wg, const void* wu, const void* wd, void* out,
    void* part, int dtype, int M, int D, int F, int act, int gated,
    int rows, int cols, int tiles_per_split, int splits, void* stream) {
  if (M < 1 || D < 1 || F < 1 || act < 0 || act > 3 ||
      (dtype != 0 && dtype != 1) || tiles_per_split < 1 || splits < 1 ||
      D > THREADS * cols || (gated && wg == nullptr) ||
      (splits > 1 && part == nullptr) ||
      (long long)(splits - 1) * tiles_per_split * BF >= F)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.M = M; p.D = D; p.F = F; p.act = act; p.gated = gated ? 1 : 0;
  p.tiles_per_split = tiles_per_split; p.splits = splits;
  if (!gated) wg = wu;  // never read
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (dtype == 0)
    return launch_rc<float>(x, wg, wu, wd, out, pf, p, rows, cols, s);
  return launch_rc<__nv_bfloat16>(x, wg, wu, wd, out, pf, p, rows, cols, s);
}

extern "C" const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
