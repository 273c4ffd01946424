// Line-buffer streaming conv2d for NVIDIA Hopper (sm_90a), CUDA cores only.
//
// NHWC conv of an *unpadded* frame x (B,H,W,Cin) with w (KH,KW,Cin,Cout),
// explicit top/left pads (bottom/right follow from the output extent),
// stride s, and an optional relu / squared_relu epilogue on the
// accumulator.  Output (B,Ho,Wo,Cout) is int32 for integer inputs
// (arithmetic mod 2^32, done in uint32_t because signed overflow is
// undefined in C++) and f32 for f32/bf16 inputs (plain FMA, no TF32).
//
// One block owns (batch sample, band of output rows, W tile, Cout tile).
// It walks its band top to bottom, `rows_step` output rows at a time.
// The input rows a step needs live in a ring in shared memory,
// `ring_rows = (rows_step-1)*s + KH` slots deep; advancing one step only
// loads the rows that were not needed before, so every input row is read
// from device memory once per band.  That ring is the line buffer.  The
// Cout tile of the weights is loaded once and stays in shared memory for
// the block's life.  Padding is a predicated load that writes zero.
// Both operands are widened to the 32-bit accumulate type as they enter
// shared memory, so the inner loop is the same for every input type.
//
// Each thread computes a TP x TC register tile (4 pixels along W times 4
// consecutive output channels); per (kh,kw,ci) it reads one 16-byte
// weight vector and TP scalars.  Every output element is the same
// sequential sum over (kh, kw, ci) whatever the tiling, so results do
// not depend on band, step, tile sizes or batch.
//
// Plain C interface (loaded with ctypes): the kernel allocates nothing
// and does not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 4;  // output pixels per thread (along W)
constexpr int TC = 4;  // output channels per thread
constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for

struct ConvParams {
  int B, H, W, Cin, KH, KW, Cout, Ho, Wo;
  int stride, pad_t, pad_l, epilogue;
  int band, rows_step, w_tile, c_tile;
  int n_wtiles, n_ctiles, ring_rows, slot_cols, cin_p;
};

template <typename A>
struct alignas(16) Vec4 {
  A v[4];
};

__device__ __forceinline__ uint32_t widen(int8_t v) { return (uint32_t)(int32_t)v; }
__device__ __forceinline__ uint32_t widen(uint8_t v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t widen(int16_t v) { return (uint32_t)(int32_t)v; }
__device__ __forceinline__ uint32_t widen(int32_t v) { return (uint32_t)v; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// epilogue codes: 0 none, 1 relu, 2 squared_relu
__device__ __forceinline__ uint32_t finish(uint32_t v, int epilogue) {
  if (epilogue == 0) return v;
  uint32_t r = ((int32_t)v > 0) ? v : 0u;
  return epilogue == 1 ? r : r * r;  // the square wraps mod 2^32
}
__device__ __forceinline__ float finish(float v, int epilogue) {
  if (epilogue == 0) return v;
  float r = (v < 0.f) ? 0.f : v;  // NaN passes through
  return epilogue == 1 ? r : r * r;
}

template <typename T, typename A>
__global__ void __launch_bounds__(256)
conv2d_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     A* __restrict__ out, const ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* ws = reinterpret_cast<A*>(smem_raw);  // [KH*KW*Cin][c_tile]
  const int taps = p.KH * p.KW * p.Cin;
  A* ring = ws + (size_t)taps * p.c_tile;  // [ring_rows][slot_cols][cin_p]
  const int slot_stride = p.slot_cols * p.cin_p;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int wt = blockIdx.x % p.n_wtiles, ct = blockIdx.x / p.n_wtiles;
  const int band0 = blockIdx.y * p.band;  // first output row of the band
  const int b = blockIdx.z;
  const int co0 = ct * p.c_tile, ow0 = wt * p.w_tile;
  const int ih0 = band0 * p.stride - p.pad_t;  // input row of ring row 0
  const int iw0 = ow0 * p.stride - p.pad_l;    // input col of slot col 0
  const int band_rows = min(p.band, p.Ho - band0);

  // the weight tile: resident for the block's life
  for (int i = tid; i < taps * p.c_tile; i += nthreads) {
    const int t = i / p.c_tile, c = i - t * p.c_tile;
    const int co = co0 + c;
    ws[i] = (co < p.Cout) ? widen(w[(size_t)t * p.Cout + co]) : A(0);
  }

  const T* xb = x + (size_t)b * p.H * p.W * p.Cin;
  const int row_elems = p.slot_cols * p.Cin;
  const int cgs = p.c_tile / TC, pgs = p.w_tile / TP;
  const int items = p.rows_step * pgs * cgs;
  int loaded_end = 0;  // ring rows [0, loaded_end) have been loaded

  for (int r0 = 0; r0 < band_rows; r0 += p.rows_step) {
    // bring in the rows this step needs and no earlier step loaded
    const int need0 = r0 * p.stride, need1 = need0 + p.ring_rows;
    const int from = max(need0, loaded_end);
    const int n_new = (need1 - from) * row_elems;
    for (int i = tid; i < n_new; i += nthreads) {
      const int r = i / row_elems, j = i - r * row_elems;
      const int col = j / p.Cin, ci = j - col * p.Cin;
      const int rr = from + r;
      const int ih = ih0 + rr, iw = iw0 + col;
      A v = A(0);
      if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
        v = widen(xb[((size_t)ih * p.W + iw) * p.Cin + ci]);
      ring[(rr % p.ring_rows) * slot_stride + col * p.cin_p + ci] = v;
    }
    loaded_end = need1;
    __syncthreads();

    for (int it = tid; it < items; it += nthreads) {
      const int cg = it % cgs;
      const int rest = it / cgs;
      const int pg = rest % pgs, rs = rest / pgs;
      const int orow = r0 + rs;
      if (orow >= band_rows) continue;
      A acc[TP][TC];
#pragma unroll
      for (int a = 0; a < TP; ++a)
#pragma unroll
        for (int q = 0; q < TC; ++q) acc[a][q] = A(0);

      const int rel0 = orow * p.stride;
      const int px_stride = p.stride * p.cin_p;
      for (int kh = 0; kh < p.KH; ++kh) {
        const A* xrow = ring + ((rel0 + kh) % p.ring_rows) * slot_stride +
                        pg * TP * px_stride;
        const A* wrow = ws + (size_t)kh * p.KW * p.Cin * p.c_tile + cg * TC;
        for (int kw = 0; kw < p.KW; ++kw) {
          const A* xp = xrow + kw * p.cin_p;
          const A* wp = wrow + (size_t)kw * p.Cin * p.c_tile;
          // unrolled so several iterations' loads are in flight at once:
          // with few warps per SM nothing else hides shared-memory latency
#pragma unroll 4
          for (int ci = 0; ci < p.Cin; ++ci) {
            const Vec4<A> wv =
                *reinterpret_cast<const Vec4<A>*>(wp + (size_t)ci * p.c_tile);
#pragma unroll
            for (int a = 0; a < TP; ++a) {
              const A xv = xp[a * px_stride + ci];
#pragma unroll
              for (int q = 0; q < TC; ++q) acc[a][q] += xv * wv.v[q];
            }
          }
        }
      }

      const int oh = band0 + orow;
#pragma unroll
      for (int a = 0; a < TP; ++a) {
        const int ow = ow0 + pg * TP + a;
        if (ow >= p.Wo) continue;
        A* o = out + (((size_t)b * p.Ho + oh) * p.Wo + ow) * p.Cout;
#pragma unroll
        for (int q = 0; q < TC; ++q) {
          const int co = co0 + cg * TC + q;
          if (co < p.Cout) o[co] = finish(acc[a][q], p.epilogue);
        }
      }
    }
    __syncthreads();  // the next step overwrites ring slots
  }
}

template <typename T, typename A>
int launch(const void* x, const void* w, void* out, const ConvParams& p,
           int threads, size_t smem, cudaStream_t stream) {
  auto kern = conv2d_stream_kernel<T, A>;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int n_bands = (p.Ho + p.band - 1) / p.band;
  dim3 grid(p.n_wtiles * p.n_ctiles, n_bands, p.B);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(x),
                                        static_cast<const T*>(w),
                                        static_cast<A*>(out), p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 int8, 1 uint8, 2 int16, 3 int32, 4 float32, 5 bfloat16
extern "C" int conv2d_stream_launch(
    const void* x, const void* w, void* out, int dtype, int B, int H, int W,
    int Cin, int KH, int KW, int Cout, int Ho, int Wo, int stride, int pad_t,
    int pad_l, int epilogue, int band, int rows_step, int w_tile, int c_tile,
    int threads, void* stream) {
  if (B < 1 || Ho < 1 || Wo < 1 || Cin < 1 || Cout < 1 || stride < 1 ||
      band < 1 || rows_step < 1 || rows_step > band || w_tile < TP ||
      w_tile % TP || c_tile < TC || c_tile % TC || threads < 32 ||
      threads > 256 || threads % 32 || epilogue < 0 || epilogue > 2)
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.KH = KH; p.KW = KW; p.Cout = Cout;
  p.Ho = Ho; p.Wo = Wo; p.stride = stride; p.pad_t = pad_t; p.pad_l = pad_l;
  p.epilogue = epilogue; p.band = band; p.rows_step = rows_step;
  p.w_tile = w_tile; p.c_tile = c_tile;
  p.n_wtiles = (Wo + w_tile - 1) / w_tile;
  p.n_ctiles = (Cout + c_tile - 1) / c_tile;
  p.ring_rows = (rows_step - 1) * stride + KH;
  p.slot_cols = (w_tile - 1) * stride + KW;
  p.cin_p = Cin | 1;  // odd pixel pitch: pixel groups land on distinct banks
  const size_t smem =
      4 * ((size_t)KH * KW * Cin * c_tile +
           (size_t)p.ring_rows * p.slot_cols * p.cin_p);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int n_bands = (Ho + band - 1) / band;
  if (n_bands > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<int8_t, uint32_t>(x, w, out, p, threads, smem, s);
    case 1: return launch<uint8_t, uint32_t>(x, w, out, p, threads, smem, s);
    case 2: return launch<int16_t, uint32_t>(x, w, out, p, threads, smem, s);
    case 3: return launch<int32_t, uint32_t>(x, w, out, p, threads, smem, s);
    case 4: return launch<float, float>(x, w, out, p, threads, smem, s);
    case 5: return launch<__nv_bfloat16, float>(x, w, out, p, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* conv2d_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
