// Fused (gated) MLP for NVIDIA Hopper (sm_90a).  Replaces the TPU kernel
// src/repro/kernels/fused_mlp.py:37 _fused_mlp_kernel:
//
//   out = down(act(x . Wg) * (x . Wu))      (gated)
//   out = down(act(x . Wu))                 (ungated)
//
// with the (M, F) hidden never written to device memory.  At prefill (M
// in the thousands) it is bound by operations (412 GFLOP at llama3.2-1b,
// M 4096); at decode (M of a few rows) by the bytes of the three weight
// matrices (100 MB).  x (M, D), Wg / Wu (D, F), Wd (F, D), all of one type
// (f32 or bf16); out (M, D) in that type.  Two routes, by the dtype code:
//
// bf16: the tensor cores (fused_mlp_mma_kernel).  A thread-block cluster
// of C <= 8 CTAs owns BM rows of x and splits D: CTA i owns the DS columns
// [i*DS, (i+1)*DS), keeps its (BM, DS) f32 accumulator in registers (BM x
// DS <= 16384: 64 floats a thread) and its (BM, DS) slice of x in shared
// memory as bf16.  The cluster walks its range of hidden tiles, BF = 64
// columns at a time (the TPU kernel's sequential f axis becomes this
// loop); per tile t
//   (a) each CTA computes its partial up (and gate) products over its D
//       slice by mma.sync m16n8k16 (a split-K over the cluster) and
//       writes them to shared memory;
//   (b) every CTA sums its share of the BM x BF partials of all C CTAs
//       through distributed shared memory in rank order 0 .. C-1 (a fixed
//       order: the result does not depend on scheduling), applies the
//       activation and the gate product in f32, splits h into a bf16 high
//       part and a bf16 low part (h - hi) and writes both into the h tile
//       of every CTA (two h tiles alternate by t);
//   (c) acc += hi . Wd[tile, slice] + lo . Wd[tile, slice] by mma.sync.
// Two phases of the cluster barrier a tile order (a), (b) and (c); each
// is split into arrive and wait with a tile's mma work between them, so
// the down product of tile t-1 runs while tile t's partials meet.  The
// weights stream through a ring of three 36 KB shared-memory stages
// filled by cp.async two chunks ahead; each weight element is read from
// L2 once per row tile for the whole cluster and used BM times.  h enters
// the down product as hi + lo, 16 significant bits, where the Pallas
// kernel keeps f32 (24): h rounded to bf16 alone, as the JAX model's own
// streamed loop (src/repro/models/layers.py:536-554) rounds it, missed
// the 1e-2 tolerance with squared relu (one more mma per step buys the
// low part).  When the row tiles alone leave the card idle (decode), the
// hidden axis is also split across clusters: each writes an f32 partial
// (M, D) and a second pass sums the partials in split order and rounds.
// Rows pad to the mma's 16 with zeros; ragged D and F and unaligned
// weights take element loads into the same tiles.
//
// f32: the CUDA cores (fused_mlp_kernel), so that f32 keeps f32 accuracy
// (TF32 would miss 5e-4).  One block owns R rows of x (in shared memory
// as f32, d-major) and a range of hidden columns, and walks it BF = 64
// columns at a time:
//   phase A  up and gate (R x BF): 256 threads as 64 hidden columns x 4
//            slices of D, the slices meet in shared memory, the
//            activation and the gate product give the hidden tile h (f32);
//   phase B  acc (R x D) += h . Wd[tile, :]: thread t keeps the output
//            columns t, t + 256, ... (C of them) for all R rows.
// R x C = 64 accumulators per thread (C = D / 256 rounded up to a power
// of two, R = 64 / C capped at 16) bounds D at 256 x 32 = 8192.  At
// decode F is split across blocks with the same second pass.
//
// Plain C interface (loaded with ctypes): the kernels allocate nothing
// and do not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mlp_act.cuh"
#include "mma_bf16.cuh"

namespace {

using mlp_act::activate;

constexpr int THREADS = 256;
constexpr int BF = 64;            // hidden columns per tile
constexpr int DSLICES = THREADS / BF;
constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for

struct Params {
  int M, D, F, act, gated, tiles_per_split, splits;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
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

// the second pass over n = M * D outputs, after a split hidden axis
template <typename T>
int sum_partials(const float* part, T* out, int splits, long long n,
                 cudaStream_t stream) {
  const long long grid = (n + THREADS - 1) / THREADS;
  sum_partials_kernel<T><<<(int)(grid < 65535 ? grid : 65535), THREADS, 0,
                           stream>>>(part, out, splits, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores, one thread-block cluster per row tile
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int MMA_WARPS = THREADS / 32;
constexpr int KC = 128;                       // rows of Wu / Wg per chunk
constexpr int STAGES = 3;                     // ring depth
constexpr int WPITCH = BF + 8;                // row pitch of a Wu / Wg chunk
constexpr int RPITCH = BF + 4;                // row pitch of the f32 partials
constexpr int HPITCH = BF + 8;                // row pitch of an h tile
constexpr int ACC_ELEMS = 16384;              // BM x DS: 64 floats a thread
constexpr int MAX_CLUSTER = 8;                // portable cluster size

// the two halves of cluster.sync(), so that work can sit between them:
// arrive publishes this CTA's shared-memory writes (release), wait returns
// once every CTA of the cluster has arrived and makes theirs visible
// (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct MmaParams {
  int M, D, F, act, gated, tiles_per_split, vec;
#ifdef FUSED_MLP_PROBE
  int probe;
#endif
};

#ifdef FUSED_MLP_PROBE
// A timing build only (nvcc -DFUSED_MLP_PROBE, into a library of its own;
// the package's library is built without it): probe bits switch parts of
// the bf16 kernel off so that the rest can be timed, and the result is
// then wrong.  1 the cluster exchange (b) and its barriers, 2 the mma of
// (a) and (c), 4 the weight loads.
int g_probe = 0;
#endif

template <int BM, int DS>
struct MmaShape {
  static constexpr int WM = BM / 16;            // warps along the rows
  static constexpr int WN = MMA_WARPS / WM;     // warps along the columns
  static constexpr int NA = BF / WN;            // (a): hidden cols a warp
  static constexpr int NC = DS / WN;            // (c): output cols a warp
  static constexpr int XPITCH = DS + 8;         // x slice and Wd chunk rows
  static constexpr int KCD = ACC_ELEMS / DS < BF ? ACC_ELEMS / DS : BF;
                                                // rows of Wd per chunk
  static constexpr int STAGE_ELEMS = 2 * KC * WPITCH;  // bf16 of a stage
  static constexpr int CHA = DS / KC;           // (a) chunks a hidden tile
  static constexpr int CHC = BF / KCD;          // (c) chunks a hidden tile
  static constexpr int PER_TILE = CHA + CHC;
  static_assert(BM * DS <= ACC_ELEMS && DS % KC == 0, "tile");
  static_assert(NC % 16 == 0 && NA % 8 == 0 && KCD % 16 == 0, "warp tile");
  static_assert(KCD * XPITCH <= STAGE_ELEMS, "a Wd chunk fits a stage");
};

// the ring, the x slice, two h tiles of two bf16 parts each, and the
// up / gate partials (f32)
template <int BM, int DS>
constexpr size_t mma_smem_bytes() {
  using S = MmaShape<BM, DS>;
  return 2 * ((size_t)STAGES * S::STAGE_ELEMS + (size_t)BM * S::XPITCH +
              4 * (size_t)BM * HPITCH) +
         4 * 2 * (size_t)BM * RPITCH;
}

template <int BM, int DS>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_mma_kernel(const uint16_t* __restrict__ x,
                     const uint16_t* __restrict__ wg,
                     const uint16_t* __restrict__ wu,
                     const uint16_t* __restrict__ wd,
                     uint16_t* __restrict__ out, float* __restrict__ part,
                     const MmaParams p) {
  using namespace mma_bf16;
  using S = MmaShape<BM, DS>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_mlp[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_mlp);  // [STAGES][..]
  uint16_t* xs = ring + STAGES * S::STAGE_ELEMS;           // [BM][XPITCH]
  uint16_t* hs = xs + BM * S::XPITCH;     // [tile & 1][hi, lo][BM][HPITCH]
  float* ru = reinterpret_cast<float*>(hs + 4 * BM * HPITCH);  // [BM][RPITCH]
  float* rg = ru + BM * RPITCH;                                // [BM][RPITCH]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int d0 = rank * DS;               // this CTA's first column of D
  const int n_tiles = (p.F + BF - 1) / BF;
  const int t_begin = split * p.tiles_per_split;
  const int t_count = min(n_tiles, t_begin + p.tiles_per_split) - t_begin;
  const int total = t_count * S::PER_TILE;
  const bool vc = p.vec != 0;
#ifdef FUSED_MLP_PROBE
  const bool exchange = !(p.probe & 1), compute = !(p.probe & 2),
             loads = !(p.probe & 4);
#else
  constexpr bool exchange = true, compute = true, loads = true;
#endif

  // chunk c of this CTA's weight stream -> ring stage c % STAGES, each
  // within this CTA's D slice.  A(t): CHA chunks of KC rows of Wu (and
  // Wg) for hidden tile t; C(t): CHC chunks of KCD rows of Wd.  They are
  // used in the order A(0), then A(s), C(s-1) for s = 1 .. n-1, then
  // C(n-1): the down product of a tile runs one step behind its up
  // product, while the cluster's barrier for the next tile completes.
  auto issue = [&](int c) {
    int tile, j;
    if (c < S::CHA) {
      tile = 0; j = c;
    } else {
      const int c2 = c - S::CHA;
      const int s = 1 + c2 / S::PER_TILE, r = c2 % S::PER_TILE;
      if (s < t_count) {
        tile = r < S::CHA ? s : s - 1;
        j = r;
      } else {
        tile = t_count - 1;
        j = S::CHA + r;
      }
    }
    const int f0 = (t_begin + tile) * BF;
    uint16_t* st = ring + (c % STAGES) * S::STAGE_ELEMS;
    if (j < S::CHA) {
      const int r0 = d0 + j * KC;
      const size_t off = (size_t)r0 * p.F + f0;
      load_tile<KC, BF, THREADS>(st, WPITCH, wu + off, p.F, p.D - r0,
                                 p.F - f0, vc, tid);
      if (p.gated)
        load_tile<KC, BF, THREADS>(st + KC * WPITCH, WPITCH, wg + off, p.F,
                                   p.D - r0, p.F - f0, vc, tid);
    } else {
      const int r0 = f0 + (j - S::CHA) * S::KCD;
      load_tile<S::KCD, DS, THREADS>(st, S::XPITCH,
                                     wd + (size_t)r0 * p.D + d0, p.D,
                                     p.F - r0, p.D - d0, vc, tid);
    }
  };

  // the x slice (rows past M and columns past D are zeros) and the first
  // STAGES - 1 chunks
  load_tile<BM, DS, THREADS>(xs, S::XPITCH, x + (size_t)m0 * p.D + d0, p.D,
                             p.M - m0, p.D - d0, vc, tid);
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < total && loads) issue(c);
    cp_async_commit();
  }

  float acc[S::NC / 8][4];
#pragma unroll
  for (int j = 0; j < S::NC / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // step t: A(t) -> [wait B(t-1)] partials -> arrive A(t) -> C(t-1) ->
  // wait A(t) -> h(t) into every CTA -> arrive B(t).  One cluster barrier
  // phase (A) orders "partials written" before the reads; the other (B)
  // orders "partials read, h written" before the next partials and the
  // down product.  Each wait sits behind a tile's worth of mma work.
  int c = 0;
  for (int t = 0; t <= t_count; ++t) {
    if (t < t_count) {   // (a) partial up and gate over this CTA's slice
      float u[S::NA / 8][4], gt[S::NA / 8][4];
#pragma unroll
      for (int j = 0; j < S::NA / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] = gt[j][e] = 0.f;
      for (int j = 0; j < S::CHA; ++j, ++c) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (c + STAGES - 1 < total && loads) issue(c + STAGES - 1);
        cp_async_commit();
        if (!compute) continue;
        const uint16_t* su = ring + (c % STAGES) * S::STAGE_ELEMS + wn * S::NA;
        const uint16_t* sg = su + KC * WPITCH;
        const uint16_t* xa = xs + wm * 16 * S::XPITCH + j * KC;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_a(a, xa + kk * 16, S::XPITCH, lane);
          if constexpr (S::NA >= 16) {
#pragma unroll
            for (int np = 0; np < S::NA / 16; ++np) {
              uint32_t b[4];
              ldmatrix_b_kn(b, su + kk * 16 * WPITCH + np * 16, WPITCH, lane);
              mma(u[2 * np], a, b[0], b[1]);
              mma(u[2 * np + 1], a, b[2], b[3]);
              if (p.gated) {
                ldmatrix_b_kn(b, sg + kk * 16 * WPITCH + np * 16, WPITCH,
                              lane);
                mma(gt[2 * np], a, b[0], b[1]);
                mma(gt[2 * np + 1], a, b[2], b[3]);
              }
            }
          } else {
            uint32_t b[2];
            ldmatrix_b_kn1(b, su + kk * 16 * WPITCH, WPITCH, lane);
            mma(u[0], a, b[0], b[1]);
            if (p.gated) {
              ldmatrix_b_kn1(b, sg + kk * 16 * WPITCH, WPITCH, lane);
              mma(gt[0], a, b[0], b[1]);
            }
          }
        }
      }
      // B(t-1): every CTA has read the partials of tile t-1 and written
      // h(t-1)
      if (t > 0 && exchange) cluster_wait();
#pragma unroll
      for (int nb = 0; nb < S::NA / 8; ++nb) {
        const int r = wm * 16 + g, col = wn * S::NA + nb * 8 + 2 * t4;
        *reinterpret_cast<float2*>(ru + r * RPITCH + col) =
            make_float2(u[nb][0], u[nb][1]);
        *reinterpret_cast<float2*>(ru + (r + 8) * RPITCH + col) =
            make_float2(u[nb][2], u[nb][3]);
        if (p.gated) {
          *reinterpret_cast<float2*>(rg + r * RPITCH + col) =
              make_float2(gt[nb][0], gt[nb][1]);
          *reinterpret_cast<float2*>(rg + (r + 8) * RPITCH + col) =
              make_float2(gt[nb][2], gt[nb][3]);
        }
      }
      if (exchange) cluster_arrive();        // A(t): partials written
    } else if (exchange) {
      cluster_wait();                        // B(t-1)
    }

    if (t >= 1) {   // (c) acc += h(t-1) . Wd[tile t-1, slice], hi then lo
      const uint16_t* hb = hs + ((t - 1) & 1) * 2 * BM * HPITCH;
      for (int j = 0; j < S::CHC; ++j, ++c) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (c + STAGES - 1 < total && loads) issue(c + STAGES - 1);
        cp_async_commit();
        if (!compute) continue;
        const uint16_t* sd = ring + (c % STAGES) * S::STAGE_ELEMS + wn * S::NC;
        const uint16_t* ha = hb + wm * 16 * HPITCH + j * S::KCD;
#pragma unroll
        for (int kk = 0; kk < S::KCD / 16; ++kk) {
          uint32_t a[4], al[4];
          ldmatrix_a(a, ha + kk * 16, HPITCH, lane);
          ldmatrix_a(al, ha + BM * HPITCH + kk * 16, HPITCH, lane);
#pragma unroll
          for (int np = 0; np < S::NC / 16; ++np) {
            uint32_t b[4];
            ldmatrix_b_kn(b, sd + kk * 16 * S::XPITCH + np * 16, S::XPITCH,
                          lane);
            mma(acc[2 * np], a, b[0], b[1]);
            mma(acc[2 * np], al, b[0], b[1]);
            mma(acc[2 * np + 1], a, b[2], b[3]);
            mma(acc[2 * np + 1], al, b[2], b[3]);
          }
        }
      }
    }

    if (t < t_count && exchange) {   // (b) h(t) into every CTA
      cluster_wait();                        // A(t)
      // pairs of columns, shared by the cluster's threads; a pair's C
      // loads are all issued before the sums, which run in rank order
      uint16_t* hw = hs + (t & 1) * 2 * BM * HPITCH;
      for (int e = rank * THREADS + tid; e < BM * BF / 2; e += THREADS * C) {
        const int r = e / (BF / 2), col = (e % (BF / 2)) * 2;
        const int at = r * RPITCH + col;
        float2 vu[MAX_CLUSTER], vg[MAX_CLUSTER];
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q) {
          if (q >= C) break;
          vu[q] = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(ru, q) + at);
          if (p.gated)
            vg[q] = *reinterpret_cast<const float2*>(
                cluster.map_shared_rank(rg, q) + at);
        }
        float su0 = 0.f, su1 = 0.f, sg0 = 0.f, sg1 = 0.f;
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q) {
          if (q >= C) break;
          su0 += vu[q].x; su1 += vu[q].y;
          if (p.gated) { sg0 += vg[q].x; sg1 += vg[q].y; }
        }
        const float h0 = p.gated ? activate(p.act, sg0) * su0
                                 : activate(p.act, su0);
        const float h1 = p.gated ? activate(p.act, sg1) * su1
                                 : activate(p.act, su1);
        // h = hi + lo, both bf16: 16 significant bits for (c)
        const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
        const uint32_t hv = *reinterpret_cast<const uint32_t*>(&hi);
        const uint32_t lv = pack_bf16x2(h0 - __low2float(hi),
                                        h1 - __high2float(hi));
        for (int q = 0; q < C; ++q) {
          uint16_t* hq = cluster.map_shared_rank(hw, q) + r * HPITCH + col;
          *reinterpret_cast<uint32_t*>(hq) = hv;
          *reinterpret_cast<uint32_t*>(hq + BM * HPITCH) = lv;
        }
      }
      cluster_arrive();                      // B(t): h(t) written
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nb = 0; nb < S::NC / 8; ++nb) {
    const int col = d0 + wn * S::NC + nb * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 16 + g + 8 * h;
      if (r >= p.M || col >= p.D) continue;
      const float v0 = acc[nb][2 * h], v1 = acc[nb][2 * h + 1];
      if (gridDim.z == 1) {
        uint16_t* o = out + (size_t)r * p.D + col;
        const uint32_t pk = pack_bf16x2(v0, v1);
        if (vc && col + 1 < p.D) {
          *reinterpret_cast<uint32_t*>(o) = pk;
        } else {
          o[0] = (uint16_t)(pk & 0xffffu);
          if (col + 1 < p.D) o[1] = (uint16_t)(pk >> 16);
        }
      } else {
        float* o = part + ((size_t)split * p.M + r) * p.D + col;
        o[0] = v0;
        if (col + 1 < p.D) o[1] = v1;
      }
    }
  }
}

template <int BM, int DS>
int launch_mma(const void* x, const void* wg, const void* wu, const void* wd,
               void* out, float* part, const MmaParams& p, int cluster,
               int splits, cudaStream_t stream) {
  auto kern = fused_mlp_mma_kernel<BM, DS>;
  const size_t smem = mma_smem_bytes<BM, DS>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long m_tiles = (p.M + BM - 1) / BM;
  if (m_tiles > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (unsigned)m_tiles, splits);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const uint16_t*>(x),
      static_cast<const uint16_t*>(wg), static_cast<const uint16_t*>(wu),
      static_cast<const uint16_t*>(wd), static_cast<uint16_t*>(out), part, p);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return sum_partials(part, static_cast<__nv_bfloat16*>(out), splits,
                      (long long)p.M * p.D, stream);
}

template <int DS>
int launch_bm(const void* x, const void* wg, const void* wu, const void* wd,
              void* out, float* part, const MmaParams& p, int rows,
              int cluster, int splits, cudaStream_t s) {
  if (rows == 16)
    return launch_mma<16, DS>(x, wg, wu, wd, out, part, p, cluster, splits, s);
  if constexpr (32 * DS <= ACC_ELEMS)
    if (rows == 32)
      return launch_mma<32, DS>(x, wg, wu, wd, out, part, p, cluster, splits,
                                s);
  if constexpr (64 * DS <= ACC_ELEMS)
    if (rows == 64)
      return launch_mma<64, DS>(x, wg, wu, wd, out, part, p, cluster, splits,
                                s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

size_t smem_bytes(int R, int D) {
  return 4 * ((size_t)D * R + 2 * DSLICES * BF * R + (size_t)BF * R);
}

template <int R, int C>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* out, float* part, const Params& p, cudaStream_t stream) {
  auto kern = fused_mlp_kernel<float, R, C>;
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
      static_cast<const float*>(x), static_cast<const float*>(wg),
      static_cast<const float*>(wu), static_cast<const float*>(wd),
      static_cast<float*>(out), part, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  return sum_partials(part, static_cast<float*>(out), p.splits,
                      (long long)p.M * p.D, stream);
}

int launch_rc(const void* x, const void* wg, const void* wu, const void* wd,
              void* out, float* part, const Params& p, int rows, int cols,
              cudaStream_t s) {
  if (rows == 16 && cols == 1) return launch<16, 1>(x, wg, wu, wd, out, part, p, s);
  if (rows == 16 && cols == 2) return launch<16, 2>(x, wg, wu, wd, out, part, p, s);
  if (rows == 16 && cols == 4) return launch<16, 4>(x, wg, wu, wd, out, part, p, s);
  if (rows == 8 && cols == 8) return launch<8, 8>(x, wg, wu, wd, out, part, p, s);
  if (rows == 4 && cols == 16) return launch<4, 16>(x, wg, wu, wd, out, part, p, s);
  if (rows == 2 && cols == 32) return launch<2, 32>(x, wg, wu, wd, out, part, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifdef FUSED_MLP_PROBE
extern "C" void fused_mlp_set_probe(int bits) { g_probe = bits; }
#endif

// dtype codes: 0 float32 (CUDA cores: `rows` rows of x per block, `cols`
// output columns per thread, cluster 1), 1 bfloat16 (tensor cores: `rows`
// = BM, `cols` = the D columns of one CTA, `cluster` CTAs per row tile).
// act: 0 silu, 1 gelu (tanh), 2 relu, 3 squared relu.  wg may be null
// when gated is 0.  part holds splits x M x D floats when splits > 1.
extern "C" int fused_mlp_launch(
    const void* x, const void* wg, const void* wu, const void* wd, void* out,
    void* part, int dtype, int M, int D, int F, int act, int gated,
    int rows, int cols, int cluster, int tiles_per_split, int splits,
    void* stream) {
  if (M < 1 || D < 1 || F < 1 || act < 0 || act > 3 ||
      (dtype != 0 && dtype != 1) || tiles_per_split < 1 || splits < 1 ||
      (gated && wg == nullptr) || (splits > 1 && part == nullptr) ||
      (long long)(splits - 1) * tiles_per_split * BF >= F)
    return (int)cudaErrorInvalidValue;
  if (!gated) wg = wu;  // never read
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (dtype == 1) {
    if (cluster < 1 || cluster > MAX_CLUSTER || (long long)cluster * cols < D ||
        (long long)(cluster - 1) * cols >= D)
      return (int)cudaErrorInvalidValue;
    MmaParams p;
    p.M = M; p.D = D; p.F = F; p.act = act; p.gated = gated ? 1 : 0;
    p.tiles_per_split = tiles_per_split;
#ifdef FUSED_MLP_PROBE
    p.probe = g_probe;
#endif
    // 16-byte pieces need rows of whole pieces and 16-byte aligned bases
    p.vec = D % 8 == 0 && F % 8 == 0 &&
            ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wg) |
              reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
              reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    switch (cols) {
      case 128: return launch_bm<128>(x, wg, wu, wd, out, pf, p, rows, cluster, splits, s);
      case 256: return launch_bm<256>(x, wg, wu, wd, out, pf, p, rows, cluster, splits, s);
      case 512: return launch_bm<512>(x, wg, wu, wd, out, pf, p, rows, cluster, splits, s);
      case 1024: return launch_bm<1024>(x, wg, wu, wd, out, pf, p, rows, cluster, splits, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (cluster != 1 || D > THREADS * cols) return (int)cudaErrorInvalidValue;
  Params p;
  p.M = M; p.D = D; p.F = F; p.act = act; p.gated = gated ? 1 : 0;
  p.tiles_per_split = tiles_per_split; p.splits = splits;
  return launch_rc(x, wg, wu, wd, out, pf, p, rows, cols, s);
}

extern "C" const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
