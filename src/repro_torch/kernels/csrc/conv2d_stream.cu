// Line-buffer streaming conv2d for NVIDIA Hopper (sm_90a), CUDA cores.
// Replaces the TPU kernel src/repro/kernels/conv2d_stream.py:70
// _conv_stream_kernel.
//
// NHWC conv of an *unpadded* frame x (B,H,W,Cin) with w (KH,KW,Cin,Cout),
// explicit top/left pads (bottom/right follow from the output extent),
// stride s, and an optional relu / squared_relu epilogue on the
// accumulator.  Output (B,Ho,Wo,Cout) is int32 for integer inputs
// (arithmetic mod 2^32, done in uint32_t because signed overflow is
// undefined in C++) and f32 for f32/bf16 inputs (plain FMA, no TF32).
//
// What bounds it: the main path's convs are int32 (KV260's int32
// weights), and no tensor-core instruction multiplies 32-bit integers, so
// the CUDA cores' integer multiply-add rate does: 64 a clock an SM at
// compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
// instructions), half the f32 FMA rate.  At 224^2 x 136 -> 136, 3x3
// (deep_cascade_224) that is 8.4 G multiply-adds, >= 0.50 ms.  What keeps
// a kernel from that rate is shared memory: its capacity (how large a tile
// a block can hold, so how many threads have work) and its bandwidth
// (loads per multiply-add).
//
// One block owns (batch sample, band of output rows, W tile, Cout tile)
// and walks its band top to bottom, `rows_step` output rows a step.  Each
// thread owns a TP x TC register tile -- TP output pixels along W
// (interleaved: pixel pg + pgs * a, so neighbouring threads read
// neighbouring pixels) times TC consecutive output channels -- and the
// block has exactly one thread per tile of a step, so every thread has
// work.  Tiles are 8 x 8 (64 accumulators; per input channel and tap a
// thread makes 8 + 2 shared-memory loads for 64 multiply-adds), or 4 x 4
// and 2 x 4 for convs whose outputs are too few to fill the card with 8 x
// 8 tiles.  The accumulators stay in registers across the whole K =
// KH*KW*Cin loop of a step.
//
// The K loop runs Cin in chunks of CK = 8 channels, and within a chunk
// over (kh, kw, ci).  The chunk is a constant, never the plan's, so every
// output element is the same sequential sum whatever the band, step, tile
// sizes or batch, and float results are bit-identical across plans.  Two
// ways to hold the operands, chosen by the planner:
//
//   resident (small convs: the zoo, Cin 1-32; 4 x 4 and 2 x 4 tiles
//     only): the whole KH*KW*Cin*c_tile
//     weight tile stays in shared memory for the block's life, and the
//     input rows a step needs live in a ring `ring_rows = (rows_step-1)*s
//     + KH` slots deep holding every channel; a step loads only the rows
//     no earlier step loaded, so each input row is read from device memory
//     once per band (the line buffer).  No pipeline: small convs pay none.
//   streamed (Cin of 100 and more): per (step, group of stage_chunks
//     chunks) one stage holds each chunk's KH*KW*CK*c_tile weight slice
//     and its slab of the step's ring_rows input rows; two stages, filled
//     by cp.async (16 bytes a thread, 32-bit types with 16-byte rows)
//     while the other computes.  Grouping chunks into a stage changes no
//     sum's order; it only spends fewer barriers on a deep Cin.  The halo
//     rows of a step (ring_rows - rows_step*s of them) are read again
//     from L2 by the next step, and the weights once per step: the line
//     buffer's guarantee is traded for tiles that no longer hold all of
//     Cin, so c_tile covers a Cout like 136 in one to three tiles and two
//     blocks share an SM.  The planner reports the bytes a
//     launch moves into shared memory.
//
// Operands are widened to the 32-bit accumulate type as they enter
// shared memory (the cp.async route takes 32-bit types only; narrower
// ones, and unaligned rows, take element loads), so the inner loop is the
// same for every input type.  Padding is a predicated load that writes
// zero.
//
// Plain C interface (loaded with ctypes): the kernel allocates nothing
// and does not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 8;             // input channels per chunk of the K loop
constexpr int CKP = 12;           // pixel pitch of a streamed slab (words)
constexpr int STAGES = 2;         // streamed stages in shared memory
constexpr int MAX_THREADS = 256;  // threads a block at most
constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for

struct ConvParams {
  int B, H, W, Cin, KH, KW, Cout, Ho, Wo;
  int stride, pad_t, pad_l, epilogue;
  int band, rows_step, w_tile, c_tile, streamed, stage_chunks;
  int n_wtiles, n_ctiles, ring_rows, slot_cols, px_pitch, pgs, cgs;
  int vec_x, vec_w, vec_out, threads;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// acc += x[ci] * w[ci] for one input channel ci of one tap
template <typename A, int TP, int TC>
__device__ __forceinline__ void mac_channel(A (&acc)[TP][TC],
                                            const A* __restrict__ xp,
                                            const A* __restrict__ wp,
                                            int px_step, int ci) {
  A wv[TC];
#pragma unroll
  for (int q4 = 0; q4 < TC / 4; ++q4) {
    const Vec4<A> v = *reinterpret_cast<const Vec4<A>*>(wp + 4 * q4);
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[4 * q4 + q] = v.v[q];
  }
#pragma unroll
  for (int a = 0; a < TP; ++a) {
    const A xv = xp[a * px_step + ci];
#pragma unroll
    for (int q = 0; q < TC; ++q) acc[a][q] += xv * wv[q];
  }
}

// acc += the products of one Cin chunk (ck channels): for kh, kw, ci.
// xs: the chunk's first channel of ring slot 0, column 0 (pixel pitch
// px_pitch, slot pitch slot_stride); ws: the chunk's first weight row of
// tap (0, 0) (tap_rows rows of c_tile a tap); row0: the ring slot of the
// thread's first input row, wrapped modulo `wrap` (0: no wrap)
template <typename A, int TP, int TC>
__device__ __forceinline__ void mac_chunk(
    A (&acc)[TP][TC], const A* __restrict__ xs, const A* __restrict__ ws,
    const ConvParams& p, int slot_stride, int tap_rows, int row0, int wrap,
    int pg, int cg, int ck) {
  // the small tiles unroll a whole chunk (eight channels' loads in
  // flight, no loop overhead on a short loop); the 8 x 8 tile's 64
  // accumulators leave registers for one channel at a time
  constexpr bool wide = TP * TC >= 64;
  const int px_step = p.pgs * p.stride * p.px_pitch;  // next pixel of the tile
  for (int kh = 0; kh < p.KH; ++kh) {
    int row = row0 + kh;
    if (wrap) row %= wrap;
    const A* xrow = xs + row * slot_stride + pg * p.stride * p.px_pitch;
    const A* wrow = ws + kh * p.KW * tap_rows * p.c_tile + cg * TC;
    for (int kw = 0; kw < p.KW; ++kw) {
      const A* xp = xrow + kw * p.px_pitch;
      const A* wp = wrow + kw * tap_rows * p.c_tile;
      if (!wide && ck == CK) {
#pragma unroll
        for (int ci = 0; ci < CK; ++ci)
          mac_channel<A, TP, TC>(acc, xp, wp + ci * p.c_tile, px_step, ci);
      } else {
#pragma unroll 1
        for (int ci = 0; ci < ck; ++ci)
          mac_channel<A, TP, TC>(acc, xp, wp + ci * p.c_tile, px_step, ci);
      }
    }
  }
}

template <typename T, typename A, int TP, int TC>
__global__ void __launch_bounds__(MAX_THREADS, 2)
conv2d_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     A* __restrict__ out, const ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* smem = reinterpret_cast<A*>(smem_raw);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int pg = tid % p.pgs, rest = tid / p.pgs;
  const int cg = rest % p.cgs, rs = rest / p.cgs;
  // one register tile a thread; on the resident route a block may carry
  // more threads, which only load (a small conv's fill is latency)
  const bool has_tile = rs < p.rows_step;
  const int wt = blockIdx.x % p.n_wtiles, ct = blockIdx.x / p.n_wtiles;
  const int band0 = blockIdx.y * p.band;  // first output row of the band
  const int b = blockIdx.z;
  const int co0 = ct * p.c_tile, ow0 = wt * p.w_tile;
  const int ih0 = band0 * p.stride - p.pad_t;  // input row of band row 0
  const int iw0 = ow0 * p.stride - p.pad_l;    // input col of slot col 0
  const int band_rows = min(p.band, p.Ho - band0);
  const int slot_stride = p.slot_cols * p.px_pitch;
  const T* xb = x + (size_t)b * p.H * p.W * p.Cin;
  const int steps = (band_rows + p.rows_step - 1) / p.rows_step;
  const int n_chunks = (p.Cin + CK - 1) / CK;

  A acc[TP][TC];
  auto store_tile = [&](int r0) {
    const int orow = r0 + rs;
    if (orow >= band_rows) return;
    const int oh = band0 + orow;
    const int co = co0 + cg * TC;
    if (co >= p.Cout) return;
#pragma unroll
    for (int a = 0; a < TP; ++a) {
      const int ow = ow0 + pg + p.pgs * a;
      if (ow >= p.Wo) continue;
      A* o = out + (((size_t)b * p.Ho + oh) * p.Wo + ow) * p.Cout + co;
      if (p.vec_out) {  // Cout % 4 == 0: 16-byte stores of whole groups
#pragma unroll
        for (int q4 = 0; q4 < TC / 4; ++q4) {
          if (co + 4 * q4 >= p.Cout) break;
          Vec4<A> v;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v.v[q] = finish(acc[a][4 * q4 + q], p.epilogue);
          *reinterpret_cast<Vec4<A>*>(o + 4 * q4) = v;
        }
      } else {
#pragma unroll
        for (int q = 0; q < TC; ++q)
          if (co + q < p.Cout) o[q] = finish(acc[a][q], p.epilogue);
      }
    }
  };
  auto zero_acc = [&]() {
#pragma unroll
    for (int a = 0; a < TP; ++a)
#pragma unroll
      for (int q = 0; q < TC; ++q) acc[a][q] = A(0);
  };

  // resident: the weight tile for the block's life, every channel of the
  // ring's rows; a step loads only the rows it needs first.  Only the
  // small tiles have this route: it would push the 8 x 8 tile's registers
  // past 128 (spills), and convs wide enough for 8 x 8 tiles stream
  if constexpr (TP * TC < 64) {
    if (!p.streamed) {
      const int taps = p.KH * p.KW * p.Cin;
      A* ws = smem;  // [KH*KW*Cin][c_tile]
      A* ring = ws + (size_t)taps * p.c_tile;  // [rows][cols][px_pitch]
      // unrolled: four loads a thread in flight, the fill of a small conv
      // is latency, not bandwidth
#pragma unroll 4
      for (int i = tid; i < taps * p.c_tile; i += nthreads) {
        const int t = i / p.c_tile, c = i - t * p.c_tile;
        const int co = co0 + c;
        ws[i] = (co < p.Cout) ? widen(w[(size_t)t * p.Cout + co]) : A(0);
      }
      const int row_elems = p.slot_cols * p.Cin;
      int loaded_end = 0;  // ring rows [0, loaded_end) have been loaded
      for (int r0 = 0; r0 < band_rows; r0 += p.rows_step) {
        const int need0 = r0 * p.stride, need1 = need0 + p.ring_rows;
        const int from = max(need0, loaded_end);
        const int n_new = (need1 - from) * row_elems;
#pragma unroll 4
        for (int i = tid; i < n_new; i += nthreads) {
          const int r = i / row_elems, j = i - r * row_elems;
          const int col = j / p.Cin, ci = j - col * p.Cin;
          const int rr = from + r;
          const int ih = ih0 + rr, iw = iw0 + col;
          A v = A(0);
          if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
            v = widen(xb[((size_t)ih * p.W + iw) * p.Cin + ci]);
          ring[(rr % p.ring_rows) * slot_stride + col * p.px_pitch + ci] = v;
        }
        loaded_end = need1;
        __syncthreads();
        zero_acc();
        if (has_tile && r0 + rs < band_rows) {
          const int row0 = (r0 + rs) * p.stride;
          for (int k = 0; k < n_chunks; ++k)
            mac_chunk<A, TP, TC>(acc, ring + k * CK,
                                 ws + (size_t)k * CK * p.c_tile, p,
                                 slot_stride, p.Cin, row0, p.ring_rows, pg,
                                 cg, min(CK, p.Cin - k * CK));
        }
        if (has_tile) store_tile(r0);
        __syncthreads();  // the next step overwrites ring slots
      }
      return;
    }
  }

  // streamed: job j = (step j / groups, chunks G (j % groups) .. + G - 1),
  // G = stage_chunks; stage j % 2 holds the job's G chunk slabs
  const int wslab = p.KH * p.KW * CK * p.c_tile;
  const int chunk_elems = wslab + p.ring_rows * slot_stride;
  const int G = p.stage_chunks;
  const int groups = (n_chunks + G - 1) / G;
  // chunk k's weight slice [KH*KW][CK][c_tile] and input slab
  // [ring_rows][slot_cols][CKP] at ws, for the step's rows from in0
  auto load_chunk = [&](A* ws, int k, int in0) {
    const int c0 = k * CK, ck = min(CK, p.Cin - c0);
    A* xs = ws + wslab;
    // the chunk's weight rows: (tap, ci) -> c_tile channels
    const int wrows = p.KH * p.KW * ck;
    if (p.vec_w) {
      const int pieces = p.c_tile / 4;
#pragma unroll 1
      for (int i = tid; i < wrows * pieces; i += nthreads) {
        const int r = i / pieces, c = (i - r * pieces) * 4;
        const int tap = r / ck, ci = r - tap * ck;
        A* d = ws + (tap * CK + ci) * p.c_tile + c;
        if (co0 + c < p.Cout)
          cp_async16(d, w + ((size_t)tap * p.Cin + c0 + ci) * p.Cout + co0 + c);
        else
          *reinterpret_cast<Vec4<A>*>(d) = Vec4<A>{};
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < wrows * p.c_tile; i += nthreads) {
        const int r = i / p.c_tile, c = i - r * p.c_tile;
        const int tap = r / ck, ci = r - tap * ck;
        const int co = co0 + c;
        ws[(tap * CK + ci) * p.c_tile + c] =
            (co < p.Cout)
                ? widen(w[((size_t)tap * p.Cin + c0 + ci) * p.Cout + co])
                : A(0);
      }
    }
    // the chunk's slab of the step's input rows
    const int pixels = p.ring_rows * p.slot_cols;
    if (p.vec_x) {  // 32-bit type, Cin % 4 == 0: ck is 4 or 8
      const int pieces = ck / 4;
#pragma unroll 1
      for (int i = tid; i < pixels * pieces; i += nthreads) {
        const int px = i / pieces, c = (i - px * pieces) * 4;
        const int r = px / p.slot_cols, col = px - r * p.slot_cols;
        const int ih = ih0 + in0 + r, iw = iw0 + col;
        A* d = xs + px * CKP + c;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
          cp_async16(d, xb + ((size_t)ih * p.W + iw) * p.Cin + c0 + c);
        else
          *reinterpret_cast<Vec4<A>*>(d) = Vec4<A>{};
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < pixels * ck; i += nthreads) {
        const int px = i / ck, ci = i - px * ck;
        const int r = px / p.slot_cols, col = px - r * p.slot_cols;
        const int ih = ih0 + in0 + r, iw = iw0 + col;
        A v = A(0);
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
          v = widen(xb[((size_t)ih * p.W + iw) * p.Cin + c0 + ci]);
        xs[px * CKP + ci] = v;
      }
    }
  };
  auto issue = [&](int j) {
    const int step = j / groups, k0 = (j - step * groups) * G;
    A* stage = smem + (size_t)(j % STAGES) * G * chunk_elems;
    const int in0 = step * p.rows_step * p.stride;  // band-relative row
#pragma unroll 1
    for (int g = 0; g < G && k0 + g < n_chunks; ++g)
      load_chunk(stage + (size_t)g * chunk_elems, k0 + g, in0);
    cp_async_commit();
  };

  const int jobs = steps * groups;
  issue(0);
  for (int j = 0; j < jobs; ++j) {
    cp_async_wait_all();
    __syncthreads();  // job j has landed; job j-1's stage is free
    if (j + 1 < jobs) issue(j + 1);
    const int step = j / groups, grp = j - step * groups;
    const int r0 = step * p.rows_step;
    if (grp == 0) zero_acc();
    if (r0 + rs < band_rows) {
      const A* stage = smem + (size_t)(j % STAGES) * G * chunk_elems;
      for (int g = 0, k = grp * G; g < G && k < n_chunks; ++g, ++k) {
        const A* ws = stage + (size_t)g * chunk_elems;
        mac_chunk<A, TP, TC>(acc, ws + wslab, ws, p, slot_stride, CK,
                             rs * p.stride, 0, pg, cg,
                             min(CK, p.Cin - k * CK));
      }
    }
    if (grp == groups - 1) store_tile(r0);
  }
}

template <typename T, typename A, int TP, int TC>
int launch(const void* x, const void* w, void* out, const ConvParams& p,
           size_t smem, cudaStream_t stream) {
  auto kern = conv2d_stream_kernel<T, A, TP, TC>;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int n_bands = (p.Ho + p.band - 1) / p.band;
  dim3 grid(p.n_wtiles * p.n_ctiles, n_bands, p.B);
  kern<<<grid, p.threads, smem, stream>>>(static_cast<const T*>(x),
                                        static_cast<const T*>(w),
                                        static_cast<A*>(out), p);
  return (int)cudaGetLastError();
}

template <typename T, typename A>
int launch_tile(const void* x, const void* w, void* out, const ConvParams& p,
                int tp, int tc, size_t smem, cudaStream_t s) {
  if (tp == 8 && tc == 8) return launch<T, A, 8, 8>(x, w, out, p, smem, s);
  if (tp == 4 && tc == 4) return launch<T, A, 4, 4>(x, w, out, p, smem, s);
  if (tp == 2 && tc == 4) return launch<T, A, 2, 4>(x, w, out, p, smem, s);
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// dtype codes: 0 int8, 1 uint8, 2 int16, 3 int32, 4 float32, 5 bfloat16.
// Register tiles (tile_pixels x tile_channels): 8 x 8, 4 x 4, 2 x 4; the
// block has a thread for each of its rows_step * (w_tile / tile_pixels) *
// (c_tile / tile_channels) tiles and, on the resident route, may have more
// that only load (`threads`, at most 256).
extern "C" int conv2d_stream_launch(
    const void* x, const void* w, void* out, int dtype, int B, int H, int W,
    int Cin, int KH, int KW, int Cout, int Ho, int Wo, int stride, int pad_t,
    int pad_l, int epilogue, int band, int rows_step, int w_tile, int c_tile,
    int tile_pixels, int tile_channels, int streamed, int stage_chunks,
    int threads, void* stream) {
  if (B < 1 || Ho < 1 || Wo < 1 || Cin < 1 || Cout < 1 || stride < 1 ||
      band < 1 || rows_step < 1 || rows_step > band || tile_pixels < 1 ||
      tile_channels < 4 || w_tile < tile_pixels || w_tile % tile_pixels ||
      c_tile < tile_channels || c_tile % tile_channels || stage_chunks < 1 ||
      epilogue < 0 ||
      epilogue > 2 || dtype < 0 || dtype > 5)
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.KH = KH; p.KW = KW; p.Cout = Cout;
  p.Ho = Ho; p.Wo = Wo; p.stride = stride; p.pad_t = pad_t; p.pad_l = pad_l;
  p.epilogue = epilogue; p.band = band; p.rows_step = rows_step;
  p.w_tile = w_tile; p.c_tile = c_tile; p.streamed = streamed ? 1 : 0;
  p.stage_chunks = stage_chunks;
  p.n_wtiles = (Wo + w_tile - 1) / w_tile;
  p.n_ctiles = (Cout + c_tile - 1) / c_tile;
  p.ring_rows = (rows_step - 1) * stride + KH;
  p.slot_cols = (w_tile - 1) * stride + KW;
  p.pgs = w_tile / tile_pixels;
  p.cgs = c_tile / tile_channels;
  // resident: odd pixel pitch, pixel groups land on distinct banks
  p.px_pitch = p.streamed ? CKP : (Cin | 1);
  const bool wide = dtype == 3 || dtype == 4;  // 32-bit: cp.async as is
  p.vec_x = p.streamed && wide && Cin % 4 == 0 && aligned16(x);
  p.vec_w = p.streamed && wide && Cout % 4 == 0 && aligned16(w);
  p.vec_out = Cout % 4 == 0 && aligned16(out);
  const long long tiles = (long long)rows_step * p.pgs * p.cgs;
  p.threads = threads;
  // a thread for every tile; more, which only load, on the resident route
  if (threads > MAX_THREADS || threads < tiles ||
      (p.streamed && threads != tiles) ||
      (!p.streamed && tile_pixels * tile_channels >= 64))  // no such route
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      p.streamed
          ? 4 * (size_t)STAGES * stage_chunks *
                ((size_t)KH * KW * CK * c_tile +
                 (size_t)p.ring_rows * p.slot_cols * CKP)
          : 4 * ((size_t)KH * KW * Cin * c_tile +
                 (size_t)p.ring_rows * p.slot_cols * p.px_pitch);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int n_bands = (Ho + band - 1) / band;
  if (n_bands > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tp = tile_pixels, tc = tile_channels;
  switch (dtype) {
    case 0: return launch_tile<int8_t, uint32_t>(x, w, out, p, tp, tc, smem, s);
    case 1: return launch_tile<uint8_t, uint32_t>(x, w, out, p, tp, tc, smem,
                                                 s);
    case 2: return launch_tile<int16_t, uint32_t>(x, w, out, p, tp, tc, smem,
                                                 s);
    case 3: return launch_tile<int32_t, uint32_t>(x, w, out, p, tp, tc, smem,
                                                 s);
    case 4: return launch_tile<float, float>(x, w, out, p, tp, tc, smem, s);
    default:
      return launch_tile<__nv_bfloat16, float>(x, w, out, p, tp, tc, smem, s);
  }
}

extern "C" const char* conv2d_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
