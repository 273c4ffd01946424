// Streaming attention backward for NVIDIA Hopper (sm_90a): the gradient of
// flash_attention.cu's forward.  The reference has no TPU kernel for it:
// this is the counterpart of its XLA custom VJP,
// src/repro/models/layers.py:209 _blockwise_attention_bwd, which
// recomputes each (query block, key block) score tile from the saved
// log-sum-exp instead of storing the (Sq, Sk) probability matrix.  From
// (q, k, v, out, lse, dout) it computes, per visible (query, key) pair,
//
//   delta = rowsum(dout * out)       p  = exp(s - lse),  s = q.k
//   dv += p^T . dout                 dp = dout . v^T
//   ds  = p * (dp - delta)           dq += ds . k   (times scale at the end)
//   dk += ds^T . q
//
// with q pre-scaled (the forward's input) and dq returned for the
// unscaled q, as the reference's VJP does.  What bounds it: five
// (bq x bk x D) products a visible tile pair — operations, not bytes; at
// llama3.2-1b's train shape (B 4, 32/8 heads of 64, S 4096, causal) 0.69
// ms at the bf16 tensor-core peak.  Seven products are done (s and dp are
// recomputed by the dq pass), so 0.97 ms is this design's own floor.
//
// Deterministic by construction — no float atomics, every sum in a fixed
// order.  Three kernels a call:
//  * delta per query row, one warp a row;
//  * dK/dV: one block per (batch*KV head, key tile) holds its K and V
//    tiles and the dK, dV accumulators in registers and walks the g query
//    heads of its GQA group and, for each, the query tiles that see the
//    key tile: the sum over the group and over query tiles happens inside
//    the block, in order;
//  * dQ: one block per (batch*query head, query tile) walks the visible
//    key tiles (a second pass that recomputes s and dp) and accumulates dq
//    in registers.
// Key tiles wholly above the causal diagonal are skipped in both passes,
// as in the forward; ragged Sq / Sk edges are masked here.  A query row
// that sees no key is 0 in the forward (flash_attention.cu), so all its
// probabilities are taken as 0 here and it contributes no gradient.
//
// Layout, as the forward: q, out, dout (B*Hq, Sq, D); k, v (B*Hkv, Sk,
// D); lse, delta (B*Hq, Sq) f32; query head bh reads KV head (bh / Hq) *
// Hkv + (bh % Hq) / group.  Causal: query row r (absolute position r +
// q_offset) sees key c iff r + q_offset >= c.  Grads out in the input
// type.  Three routes, the planner's (dse.plan_attn_bwd_blocks):
//
// bf16 "wgmma" (attn_bwd_*_wgmma_kernel; a head of 64 or 128, 16-byte
// aligned bases): warpgroup products fed by TMA, a producer warpgroup and
// two consumers a block; dK/dV blocks of 128 keys walking query tiles of
// 64 rows, dQ blocks of 128 query rows walking key tiles of 64; each
// consumer issues a tile's products as one batch, so one's exp and dS
// math runs beside the other's products (the section below).  At
// llama3.2-1b's train shape on an H100 the two kernels reach ≈ 430 and
// 470 TFLOP/s of their four and three products (PERF.md).
//
// bf16 "mma" (attn_bwd_*_mma_kernel; other heads, unaligned bases):
// mma.sync m16n8k16 with f32 accumulation, 4 warps a block, each warp 16
// keys (dK/dV) or 16 query rows (dQ); tiles of 64 stream through shared
// memory as bf16 in a cp.async double buffer.  Every product reads its
// operands as tiles already laid out for it (ldmatrix, ldmatrix.trans): no
// transposed copy.
//
// On both bf16 routes P (for dV) and dS (for dK, dQ) are rounded to bf16
// as they become tensor-core operands, as FA2 does; s, p, dp and ds
// themselves stay f32.
//
// f32 "cuda_core": (attn_bwd_dkdv_kernel, attn_bwd_dq_kernel), every
// product in f32 from f32 tiles in shared memory, rows of DP + 4 floats
// (DP: the head padded to 16, 32, 64 or 128 with zeros; (DP + 4) / 4 is
// odd, so the 16-byte loads of 8 neighbouring rows hit 8 different bank
// groups).  Of the 256 threads, (ty, tx) = (tid / 16, tid % 16) owns the
// score entries of query rows ty + 16 i and keys tx + 16 j (i, j < 4)
// and, of the gradient accumulators, rows ty * 4 + i and head columns by
// tx.
//
// Plain C interface (loaded with ctypes): the kernels allocate nothing
// (delta is a scratch buffer of the caller) and do not synchronise; the
// launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

namespace wg = wgmma_bf16;

constexpr int THREADS = 256;
constexpr int BQ = 64;            // query rows a tile
constexpr int BK = 64;            // keys a tile
constexpr int PT = BK + 4;        // pitch of the (64 x 64) p / ds tiles
constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for

struct Params {
  int Sq, Sk, D, Hq, Hkv, group, causal, q_offset, n_qt, n_kt;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// `rows` rows of a row-major (ld = D) global matrix into shared memory as
// f32 rows of DP + 4, zeros past row_lim and past column D
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int rows,
                                          int row_lim, int D, int tid) {
  constexpr int DS = DP + 4;
  for (int i = tid; i < rows * DP; i += THREADS) {
    const int r = i / DP, d = i - r * DP;
    dst[r * DS + d] = (r < row_lim && d < D) ? ld(src + (size_t)r * D + d)
                                             : 0.f;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two shared tiles
template <int DP>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int DS = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * DS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * DS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// head column of a thread's j-th accumulator: runs of 4 (16-byte loads)
// once the padded head is 64 wide or more, else one column in 16
template <int DPT>
__device__ __forceinline__ int out_col(int tx, int j) {
  if constexpr (DPT >= 4)
    return (j / 4) * 64 + tx * 4 + (j % 4);
  else
    return tx + 16 * j;
}

template <int DPT>
__device__ __forceinline__ void load_cols(float (&dst)[DPT], const float* row,
                                          int tx) {
  if constexpr (DPT >= 4) {
#pragma unroll
    for (int g = 0; g < DPT / 4; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(row + g * 64 + tx * 4);
      dst[4 * g] = t.x; dst[4 * g + 1] = t.y;
      dst[4 * g + 2] = t.z; dst[4 * g + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DPT; ++j) dst[j] = row[out_col<DPT>(tx, j)];
  }
}

// query row qrow sees key `key` (either route's parameters)
template <typename P>
__device__ __forceinline__ bool visible(const P& p, int qrow, int key) {
  return qrow < p.Sq && key < p.Sk && (!p.causal || qrow + p.q_offset >= key);
}

// two neighbouring f32 values of a row as bf16 at columns c, c + 1 (one
// 32-bit store where the row allows it)
__device__ __forceinline__ void store_pair(uint16_t* row, int c, int D,
                                           bool vec, float v0, float v1) {
  const uint32_t pk = mma_bf16::pack_bf16x2(v0, v1);
  if (vec && c + 1 < D) {
    *reinterpret_cast<uint32_t*>(row + c) = pk;
  } else {
    if (c < D) row[c] = (uint16_t)(pk & 0xffffu);
    if (c + 1 < D) row[c + 1] = (uint16_t)(pk >> 16);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (THREADS / 32) + warp;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(ld(g + d), ld(o + d), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const Params p) {
  constexpr int DS = DP + 4;
  constexpr int DPT = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [BK][DS]
  float* vs = ks + BK * DS;       // [BK][DS]
  float* qs = vs + BK * DS;       // [BQ][DS]
  float* dos = qs + BQ * DS;      // [BQ][DS]
  float* ps = dos + BQ * DS;      // [BQ][PT]  p
  float* dss = ps + BQ * PT;      // [BQ][PT]  ds
  float* ls = dss + BQ * PT;      // [BQ]      lse of the tile's rows
  float* dl = ls + BQ;            // [BQ]      delta of the tile's rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.x / p.n_kt;          // batch * Hkv + head
  const int k0 = (blockIdx.x - bkv * p.n_kt) * BK;
  const int kn = min(BK, p.Sk - k0);
  const int b = bkv / p.Hkv, h = bkv - b * p.Hkv;
  load_rows<T, DP>(ks, k + ((size_t)bkv * p.Sk + k0) * p.D, BK, kn, p.D, tid);
  load_rows<T, DP>(vs, v + ((size_t)bkv * p.Sk + k0) * p.D, BK, kn, p.D, tid);

  float adk[4][DPT], adv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  // the first query row that sees key k0; earlier tiles see none of these
  const int r_begin = p.causal ? max(0, k0 - p.q_offset) : 0;
  for (int gi = 0; gi < p.group; ++gi) {
    const int bh = b * p.Hq + h * p.group + gi;
    for (int q0 = (r_begin / BQ) * BQ; q0 < p.Sq; q0 += BQ) {
      const int qn = min(BQ, p.Sq - q0);
      const size_t row0 = (size_t)bh * p.Sq + q0;
      __syncthreads();    // the last tile's reads of qs / dos / ps / dss
      load_rows<T, DP>(qs, q + row0 * p.D, BQ, qn, p.D, tid);
      load_rows<T, DP>(dos, dout + row0 * p.D, BQ, qn, p.D, tid);
      if (tid < BQ) {
        ls[tid] = tid < qn ? lse[row0 + tid] : 0.f;
        dl[tid] = tid < qn ? delta[row0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<DP>(s, qs, ks, ty, tx);
      tile_dot<DP>(dp, dos, vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float li = ls[r], di = dl[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float pr =
              visible(p, q0 + r, k0 + c) ? expf(s[i][j] - li) : 0.f;
          ps[r * PT + c] = pr;
          dss[r * PT + c] = pr * (dp[i][j] - di);
        }
      }
      __syncthreads();

      // dv[c] += sum_r p[r][c] dout[r];  dk[c] += sum_r ds[r][c] q[r]
      for (int r = 0; r < qn; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(ps + r * PT + ty * 4);
        const float4 dd = *reinterpret_cast<const float4*>(dss + r * PT + ty * 4);
        const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
        const float da[4] = {dd.x, dd.y, dd.z, dd.w};
        float dov[DPT], qv[DPT];
        load_cols<DPT>(dov, dos + r * DS, tx);
        load_cols<DPT>(qv, qs + r * DS, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            adv[i][j] = fmaf(pa[i], dov[j], adv[i][j]);
            adk[i][j] = fmaf(da[i], qv[j], adk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty * 4 + i;
    if (c >= kn) continue;
    const size_t off = ((size_t)bkv * p.Sk + k0 + c) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int col = out_col<DPT>(tx, j);
      if (col < p.D) {
        st(dk + off + col, adk[i][j]);
        st(dv + off + col, adv[i][j]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   const Params p) {
  constexpr int DS = DP + 4;
  constexpr int DPT = DP / 16;
  constexpr int QT = BQ + 4;      // pitch of dsT
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BQ][DS]
  float* dos = qs + BQ * DS;      // [BQ][DS]
  float* ks = dos + BQ * DS;      // [BK][DS]
  float* vs = ks + BK * DS;       // [BK][DS]
  float* dsT = vs + BK * DS;      // [BK][QT]  ds, transposed
  float* ls = dsT + BK * QT;      // [BQ]
  float* dl = ls + BQ;            // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x / p.n_qt;
  // the heaviest causal tiles (last query rows) start first
  const int q0 = (p.n_qt - 1 - (blockIdx.x - bh * p.n_qt)) * BQ;
  const int qn = min(BQ, p.Sq - q0);
  const int kvh = (bh / p.Hq) * p.Hkv + (bh % p.Hq) / p.group;
  const size_t row0 = (size_t)bh * p.Sq + q0;
  load_rows<T, DP>(qs, q + row0 * p.D, BQ, qn, p.D, tid);
  load_rows<T, DP>(dos, dout + row0 * p.D, BQ, qn, p.D, tid);
  if (tid < BQ) {
    ls[tid] = tid < qn ? lse[row0 + tid] : 0.f;
    dl[tid] = tid < qn ? delta[row0 + tid] : 0.f;
  }

  float adq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adq[i][j] = 0.f;

  // keys past the tile's last visible one are never loaded
  const int k_end = p.causal ? min(p.Sk, q0 + qn + p.q_offset) : p.Sk;
  const T* kb = k + (size_t)kvh * p.Sk * p.D;
  const T* vb = v + (size_t)kvh * p.Sk * p.D;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int kn = min(BK, p.Sk - k0);
    __syncthreads();      // the last tile's reads of ks / vs / dsT
    load_rows<T, DP>(ks, kb + (size_t)k0 * p.D, BK, kn, p.D, tid);
    load_rows<T, DP>(vs, vb + (size_t)k0 * p.D, BK, kn, p.D, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<DP>(s, qs, ks, ty, tx);
    tile_dot<DP>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float li = ls[r], di = dl[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pr =
            visible(p, q0 + r, k0 + c) ? expf(s[i][j] - li) : 0.f;
        dsT[c * QT + r] = pr * (dp[i][j] - di);
      }
    }
    __syncthreads();

    // dq[r] += sum_c ds[r][c] k[c]
    for (int c = 0; c < kn; ++c) {
      const float4 dd = *reinterpret_cast<const float4*>(dsT + c * QT + ty * 4);
      const float da[4] = {dd.x, dd.y, dd.z, dd.w};
      float kv[DPT];
      load_cols<DPT>(kv, ks + c * DS, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) adq[i][j] = fmaf(da[i], kv[j], adq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= qn) continue;
    T* o = dq + (row0 + r) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int col = out_col<DPT>(tx, j);
      if (col < p.D) st(o + col, adq[i][j] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps, 16 keys or query rows each
constexpr float LOG2E = 1.4426950408889634f;

// six bf16 tiles of 64 rows, rows padded by 8 elements, and (the dK/dV
// kernel) two stages of lse and delta
constexpr size_t mma_smem_bytes(int dp) {
  return 2 * (size_t)6 * 64 * (dp + 8) + 4 * 64 * sizeof(float);
}

// dK and dV of one (batch*KV head, 64-key tile); warp w owns keys 16w ..
// 16w + 15 of the tile.  Per query tile of a head of the group, with the
// tile's Q and dO in shared memory (a cp.async double buffer, the next
// tile landing while this one is used):
//   S^T = K.Q^T (16 keys x 64 queries, f32), P^T = exp(S^T - lse)
//   dV += P^T.dO   (P^T repacked as bf16 A fragments)
//   dP^T = V.dO^T, dS^T = P^T (dP^T - delta)
//   dK += dS^T.Q   (dS^T repacked as bf16 A fragments)
// K and V come through ldmatrix (A), Q^T and dO^T as the (n x k) B tiles
// that Q and dO already are, Q and dO as (k x n) B tiles by the
// transposing ldmatrix: no transposed copy anywhere.
// heads up to 64 wide: three blocks an SM (at most 170 registers)
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, DP <= 64 ? 3 : 1)
attn_bwd_dkdv_mma_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                         const Params p, const int vec) {
  using namespace mma_bf16;
  constexpr int PITCH = DP + 8;
  constexpr int KD = DP / 16;   // k-steps over the head
  constexpr int NT = DP / 8;    // 8-column blocks of dK, dV
  constexpr int NQ = BQ / 8;    // 8-query blocks of S^T
  extern __shared__ __align__(16) uint16_t smem_mma[];
  uint16_t* ks = smem_mma;                  // [BK][PITCH]
  uint16_t* vs = ks + BK * PITCH;           // [BK][PITCH]
  uint16_t* qs = vs + BK * PITCH;           // [2][BQ][PITCH]
  uint16_t* dos = qs + 2 * BQ * PITCH;      // [2][BQ][PITCH]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * PITCH);  // [2][BQ]
  float* dl = ls + 2 * BQ;                                      // [2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bkv = blockIdx.x / p.n_kt;
  const int k0 = (blockIdx.x - bkv * p.n_kt) * BK;
  const int kn = min(BK, p.Sk - k0);
  const int b = bkv / p.Hkv, h = bkv - b * p.Hkv;
  const bool vc = vec != 0;
  load_tile<BK, DP, MMA_THREADS>(ks, PITCH, k + ((size_t)bkv * p.Sk + k0) * p.D,
                                 p.D, kn, p.D, vc, tid);
  load_tile<BK, DP, MMA_THREADS>(vs, PITCH, v + ((size_t)bkv * p.Sk + k0) * p.D,
                                 p.D, kn, p.D, vc, tid);

  // query tiles that see the key tile, per head of the group
  const int qt_begin = (p.causal ? max(0, k0 - p.q_offset) : 0) / BQ;
  const int n_vis = max(0, p.n_qt - qt_begin);
  const int n_it = p.group * n_vis;
  auto stage_tile = [&](int it, int st) {
    const int gi = it / n_vis;
    const int q0 = (qt_begin + it - gi * n_vis) * BQ;
    const int qn = min(BQ, p.Sq - q0);
    const size_t row0 = (size_t)(b * p.Hq + h * p.group + gi) * p.Sq + q0;
    load_tile<BQ, DP, MMA_THREADS>(qs + st * BQ * PITCH, PITCH,
                                   q + row0 * p.D, p.D, qn, p.D, vc, tid);
    load_tile<BQ, DP, MMA_THREADS>(dos + st * BQ * PITCH, PITCH,
                                   dout + row0 * p.D, p.D, qn, p.D, vc, tid);
    if (tid < BQ) {   // lse in base 2, for exp2f
      ls[st * BQ + tid] = tid < qn ? lse[row0 + tid] * LOG2E : 0.f;
      dl[st * BQ + tid] = tid < qn ? delta[row0 + tid] : 0.f;
    }
  };
  if (n_it > 0) stage_tile(0, 0);
  cp_async_commit();

  float dkc[NT][4], dvc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkc[j][e] = dvc[j][e] = 0.f;
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: + 0 and + 8

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) stage_tile(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();        // everything but the tile just asked for
    __syncthreads();
    const int gi = it / n_vis;
    const int q0 = (qt_begin + it - gi * n_vis) * BQ;
    const uint16_t* qt = qs + st * BQ * PITCH;
    const uint16_t* dt = dos + st * BQ * PITCH;
    const float* lt = ls + st * BQ;
    const float* dlt = dl + st * BQ;

    // S^T = K.Q^T, then P^T
    float s[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_a(a, ks + warp * 16 * PITCH + kk * 16, PITCH, lane);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_b_nk(bb, qt + np * 16 * PITCH + kk * 16, PITCH, lane);
        mma(s[2 * np], a, bb[0], bb[1]);
        mma(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // a tile that the mask leaves whole needs no test per element
    const int kw = k0 + warp * 16;
    const bool whole = q0 + BQ <= p.Sq && kw + 16 <= p.Sk &&
                       (!p.causal || q0 + p.q_offset >= kw + 15);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t4 + (e & 1);
        s[j][e] = (whole || visible(p, q0 + ql, key0 + (e >> 1) * 8))
                      ? exp2f(fmaf(s[j][e], LOG2E, -lt[ql])) : 0.f;
      }

    // dV += P^T.dO
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_b_kn(bb, dt + kk * 16 * PITCH + np * 16, PITCH, lane);
        mma(dvc[2 * np], a, bb[0], bb[1]);
        mma(dvc[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // dP^T = V.dO^T, then dS^T = P^T (dP^T - delta)
    float ds[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_a(a, vs + warp * 16 * PITCH + kk * 16, PITCH, lane);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_b_nk(bb, dt + np * 16 * PITCH + kk * 16, PITCH, lane);
        mma(ds[2 * np], a, bb[0], bb[1]);
        mma(ds[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = s[j][e] * (ds[j][e] - dlt[j * 8 + 2 * t4 + (e & 1)]);

    // dK += dS^T.Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_b_kn(bb, qt + kk * 16 * PITCH + np * 16, PITCH, lane);
        mma(dkc[2 * np], a, bb[0], bb[1]);
        mma(dkc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();   // this stage is read before stage_tile refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int kl = warp * 16 + g + 8 * h2;
    if (kl >= kn) continue;
    const size_t off = ((size_t)bkv * p.Sk + k0 + kl) * p.D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t4;
      store_pair(dk + off, c, p.D, vc, dkc[j][2 * h2], dkc[j][2 * h2 + 1]);
      store_pair(dv + off, c, p.D, vc, dvc[j][2 * h2], dvc[j][2 * h2 + 1]);
    }
  }
}

// dQ of one (batch*query head, 64-row tile); warp w owns rows 16w ..
// 16w + 15, their Q and dO held in registers as A fragments.  Per key
// tile (a cp.async double buffer; tiles above the causal diagonal never
// loaded): S = Q.K^T, P = exp(S - lse), dP = dO.V^T, dS = P (dP -
// delta), dQ += dS.K with dS repacked as bf16 A fragments; K^T and V^T are
// the (n x k) B tiles that K and V already are, K the (k x n) B tile by
// the transposing ldmatrix.
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, DP <= 64 ? 3 : 1)
attn_bwd_dq_mma_kernel(const uint16_t* __restrict__ q,
                       const uint16_t* __restrict__ k,
                       const uint16_t* __restrict__ v,
                       const uint16_t* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       uint16_t* __restrict__ dq, const Params p,
                       const int vec) {
  using namespace mma_bf16;
  constexpr int PITCH = DP + 8;
  constexpr int KD = DP / 16;
  constexpr int NT = DP / 8;
  constexpr int NS = BK / 8;    // 8-key blocks of S
  extern __shared__ __align__(16) uint16_t smem_mma[];
  uint16_t* qs = smem_mma;                  // [BQ][PITCH]
  uint16_t* dos = qs + BQ * PITCH;          // [BQ][PITCH]
  uint16_t* ks = dos + BQ * PITCH;          // [2][BK][PITCH]
  uint16_t* vs = ks + 2 * BK * PITCH;       // [2][BK][PITCH]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.n_qt;
  // the heaviest causal tiles (last query rows) start first
  const int q0 = (p.n_qt - 1 - (blockIdx.x - bh * p.n_qt)) * BQ;
  const int qn = min(BQ, p.Sq - q0);
  const int kvh = (bh / p.Hq) * p.Hkv + (bh % p.Hq) / p.group;
  const size_t row0 = (size_t)bh * p.Sq + q0;
  const uint16_t* kb = k + (size_t)kvh * p.Sk * p.D;
  const uint16_t* vb = v + (size_t)kvh * p.Sk * p.D;
  const bool vc = vec != 0;

  const int k_end = p.causal ? min(p.Sk, q0 + qn + p.q_offset) : p.Sk;
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  load_tile<BQ, DP, MMA_THREADS>(qs, PITCH, q + row0 * p.D, p.D, qn, p.D, vc,
                                 tid);
  load_tile<BQ, DP, MMA_THREADS>(dos, PITCH, dout + row0 * p.D, p.D, qn, p.D,
                                 vc, tid);
  if (n_kt > 0) {
    load_tile<BK, DP, MMA_THREADS>(ks, PITCH, kb, p.D, p.Sk, p.D, vc, tid);
    load_tile<BK, DP, MMA_THREADS>(vs, PITCH, vb, p.D, p.Sk, p.D, vc, tid);
  }
  cp_async_commit();

  // rows g and g + 8 of this warp's 16
  const int ra = warp * 16 + g, rb = ra + 8;
  // lse in base 2, for exp2f
  const float lse_a = ra < qn ? lse[row0 + ra] * LOG2E : 0.f;
  const float lse_b = rb < qn ? lse[row0 + rb] * LOG2E : 0.f;
  const float dl_a = ra < qn ? delta[row0 + ra] : 0.f;
  const float dl_b = rb < qn ? delta[row0 + rb] : 0.f;
  float dqc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dqc[j][0] = dqc[j][1] = dqc[j][2] = dqc[j][3] = 0.f;
  uint32_t qf[KD][4], df[KD][4];

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    const int k0 = it * BK;
    if (it + 1 < n_kt) {
      const int k1 = k0 + BK;
      load_tile<BK, DP, MMA_THREADS>(ks + (st ^ 1) * BK * PITCH, PITCH,
                                     kb + (size_t)k1 * p.D, p.D, p.Sk - k1,
                                     p.D, vc, tid);
      load_tile<BK, DP, MMA_THREADS>(vs + (st ^ 1) * BK * PITCH, PITCH,
                                     vb + (size_t)k1 * p.D, p.D, p.Sk - k1,
                                     p.D, vc, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_a(qf[kk], qs + warp * 16 * PITCH + kk * 16, PITCH, lane);
        ldmatrix_a(df[kk], dos + warp * 16 * PITCH + kk * 16, PITCH, lane);
      }
    }
    const uint16_t* kt = ks + st * BK * PITCH;
    const uint16_t* vt = vs + st * BK * PITCH;

    // S = Q.K^T, then P
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_b_nk(bb, kt + np * 16 * PITCH + kk * 16, PITCH, lane);
        mma(s[2 * np], qf[kk], bb[0], bb[1]);
        mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
      }
    // a tile that the mask leaves whole needs no test per element
    const bool whole = k0 + BK <= p.Sk && q0 + warp * 16 + 16 <= p.Sq &&
                       (!p.causal || q0 + warp * 16 + p.q_offset >= k0 + BK - 1);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t4 + (e & 1);
        const bool second = e >= 2;
        s[j][e] = (whole || visible(p, q0 + (second ? rb : ra), key))
                      ? exp2f(fmaf(s[j][e], LOG2E, second ? -lse_b : -lse_a))
                      : 0.f;
      }

    // dP = dO.V^T, then dS = P (dP - delta)
    float ds[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_b_nk(bb, vt + np * 16 * PITCH + kk * 16, PITCH, lane);
        mma(ds[2 * np], df[kk], bb[0], bb[1]);
        mma(ds[2 * np + 1], df[kk], bb[2], bb[3]);
      }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      ds[j][0] = s[j][0] * (ds[j][0] - dl_a);
      ds[j][1] = s[j][1] * (ds[j][1] - dl_a);
      ds[j][2] = s[j][2] * (ds[j][2] - dl_b);
      ds[j][3] = s[j][3] * (ds[j][3] - dl_b);
    }

    // dQ += dS.K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_b_kn(bb, kt + kk * 16 * PITCH + np * 16, PITCH, lane);
        mma(dqc[2 * np], a, bb[0], bb[1]);
        mma(dqc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();   // this stage is read before the next load refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = h2 ? rb : ra;
    if (r >= qn) continue;
    uint16_t* orow = dq + (row0 + r) * p.D;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store_pair(orow, j * 8 + 2 * t4, p.D, vc, dqc[j][2 * h2] * p.scale,
                 dqc[j][2 * h2 + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 route "wgmma": warpgroup products fed by TMA (heads of 64 or 128)
// ---------------------------------------------------------------------------
//
// A block is three warpgroups.  Warpgroup 0 is the producer: its thread 0
// issues every TMA load (3-D maps (D, S, B*H): a box past the ragged S
// edge reads zeros and never the next head's rows); in the dK/dV kernel
// its warp 1 copies the lse (times log2 e) and delta of each staged query
// tile beside it, loading them before it waits for the slot; the rest
// idle on PRODUCER_REGS registers.  Warpgroups 1 and 2 are the consumers,
// 64 keys (dK/dV) or 64 query rows (dQ) each: the M of every product.
// Tiles sit in shared memory as TMA writes them, 128-byte swizzled boxes
// of 64 bf16 across (a 128-wide head is two boxes side by side), and every
// product reads them where they lie through K- or MN-major descriptors:
// no transposed copy.  At a head of 64 the operand a consumer reads at
// every tile (K and V, or Q and dO) is held in registers instead
// (ldmatrix once a block), which halves the shared-memory bytes of the S
// and dP products.  P and dS become the A operands of the dV, dK and dQ
// products straight from the accumulators that computed them (the
// register-A form), rounded to bf16 there as the mma.sync route rounds
// them.
//
// What bounds it, beside products of N 64 that run well under the
// tensor cores' peak, is the math between them: one exp2 (the
// special-function unit) and the bf16 packing of P and dS per (query,
// key) pair in each pass, against 8 (dK/dV) or 6 (dQ) flops a pair per
// head element on the tensor cores — at a head of 64 comparable times
// (each of the two costs ≈ 12 % of a call, PERF.md).  So each consumer
// keeps its products in one batch a tile (the last tile's dV and dK, or
// dQ, and the next tile's S and dP), which the tensor cores run while
// the other consumer does its math; making the consumers take turns on
// named barriers measured 2-3 % slower.  A ring slot is released when
// both consumers' products of it are done; every sum runs in a fixed
// order.

constexpr int WG_THREADS = 384;          // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int WG_KEYS = 128;             // dK/dV: keys a block
constexpr int WG_QSTEP = 64;             // dK/dV: query rows a ring slot
constexpr int WG_ROWS = 128;             // dQ: query rows a block
constexpr int WG_KSTEP = 64;             // dQ: keys a ring slot
constexpr int WG_STAGES = 4;             // ring slots (6 ran 44 % slower)
constexpr int BOX_ROW = 128;             // bytes of a box row: 64 bf16
constexpr uint32_t SBO = 8 * BOX_ROW;    // 8 rows: one swizzle atom
constexpr uint32_t MN_STEP = 16 * BOX_ROW;   // a k16 step down an MN box

// shared memory of the two kernels at a head of DH (dse.attn_bwd_smem_bytes
// holds the same formula): dK/dV the K and V tiles of WG_KEYS rows, then
// WG_STAGES slots of a Q and a dO tile of WG_QSTEP rows and their lse and
// delta (2 x WG_QSTEP floats); dQ the Q and dO tiles of WG_ROWS rows, then
// WG_STAGES slots of a K and a V tile of WG_KSTEP rows; each plus 1024
// bytes to align it
constexpr size_t wg_dkdv_smem(int dh) {
  return (size_t)2 * WG_KEYS * dh * 2 +
         (size_t)WG_STAGES * (2 * WG_QSTEP * dh * 2 + 2 * WG_QSTEP * 4) +
         1024;
}
constexpr size_t wg_dq_smem(int dh) {
  return (size_t)2 * WG_ROWS * dh * 2 +
         (size_t)WG_STAGES * 2 * WG_KSTEP * dh * 2 + 1024;
}
static_assert(wg_dkdv_smem(128) <= MAX_SMEM && wg_dq_smem(128) <= MAX_SMEM,
              "the D = 128 wgmma tiles must fit one block's shared memory");

struct WgMaps {
  CUtensorMap q, dout;      // (D, Sq, B*Hq)
  CUtensorMap k, v;         // (D, Sk, B*Hkv)
};

struct WgParams {
  int Sq, Sk, Hq, Hkv, group, causal, q_offset, bhq, bhkv;
  float scale;
  const float* lse;         // (B*Hq, Sq)
  const float* delta;       // (B*Hq, Sq)
  uint16_t* dq;             // (B*Hq, Sq, D)
  uint16_t* dk;             // (B*Hkv, Sk, D)
  uint16_t* dv;
};

// 2^x by the special-function unit, subnormal results flushed to 0 (a p
// that small is 0 in every sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a consumer warp's release of a ring slot (its products of it waited for)
__device__ __forceinline__ void wg_release(uint64_t* empty) {
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(empty);
}

// `row` .. of head `bh` of a 3-D map, all DH columns, as boxes of 64
// columns side by side (box_bytes apart) at dst, completing on bar
template <int DH>
__device__ __forceinline__ void wg_load_tile(unsigned char* dst,
                                             const CUtensorMap& map,
                                             uint64_t* bar, int row, int bh,
                                             int box_bytes) {
#pragma unroll
  for (int c = 0; c < DH / 64; ++c)
    wg::tma_load_3d(dst + c * box_bytes, map, bar, 64 * c, row, bh);
}

// a consumer's (64 x DH) accumulator times `mul` as bf16 into a row-major
// (rows x DH) output, its rows from row0, those below `limit` only
template <int DH>
__device__ __forceinline__ void wg_store(uint16_t* out,
                                         const float (&d)[DH / 2], int row0,
                                         int limit, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r = row0 + ((threadIdx.x & 127) >> 5) * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= limit) continue;
    uint16_t* o = out + (size_t)(r + 8 * h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j + 2 * q) =
          wg::bf16x2(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
  }
}

// dK and dV of one (batch*KV head, WG_KEYS-key tile).  Blocks run key-tile
// major: key tile 0 of every head (causal: the most query tiles) first.
// The block walks the query tiles of WG_QSTEP rows that see its keys, for
// each head of the group in turn; consumer w owns keys 64 w .. 64 w + 63
// and, per tile:
//   S^T = K.Q^T, dP^T = V.dO^T      (A = K, V K-major; B = Q, dO K-major)
//   P^T = exp2(S^T log2 e - lse log2 e), dS^T = P^T (dP^T - delta)
//   dV += P^T.dO, dK += dS^T.Q      (A from registers; B = dO, Q MN-major)
// A tile that none of a consumer's keys is seen by is skipped; only the
// diagonal and ragged tiles test each element.
template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ WgMaps T,
                           const WgParams p) {
  constexpr int NB = DH / 64;                  // boxes across the head
  constexpr int KBOX = WG_KEYS * BOX_ROW;      // a K / V box: 16 KB
  constexpr int QBOX = WG_QSTEP * BOX_ROW;     // a Q / dO box: 8 KB
  constexpr int SLOT = 2 * NB * QBOX;
  extern __shared__ unsigned char smem_wg[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES], kvbar;
  unsigned char* ks = wg::align1024(smem_wg);
  unsigned char* vs = ks + NB * KBOX;
  unsigned char* ring = vs + NB * KBOX;
  float* lsd = reinterpret_cast<float*>(ring + WG_STAGES * SLOT);

  const int tid = threadIdx.x, wgi = tid / 128;
  const int kt = (int)blockIdx.x / p.bhkv;
  const int bkv = (int)blockIdx.x - kt * p.bhkv;
  const int k0 = kt * WG_KEYS;
  const int b = bkv / p.Hkv, h = bkv - b * p.Hkv;
  const int n_qt = (p.Sq + WG_QSTEP - 1) / WG_QSTEP;
  const int qt_begin = (p.causal ? max(0, k0 - p.q_offset) : 0) / WG_QSTEP;
  const int n_vis = max(0, n_qt - qt_begin);
  const int n_it = p.group * n_vis;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      wg::mbar_init(&full[s], 1 + 32);     // the TMA thread, warp 1's lanes
      wg::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    wg::mbar_init(&kvbar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    wg::regs_dec<PRODUCER_REGS>();
    const int warp = tid >> 5, lane = tid & 31;
    if (tid == 0) {
      wg::mbar_expect_tx(&kvbar, 2 * NB * KBOX);
      wg_load_tile<DH>(ks, T.k, &kvbar, k0, bkv, KBOX);
      wg_load_tile<DH>(vs, T.v, &kvbar, k0, bkv, KBOX);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % WG_STAGES;
        if (it >= WG_STAGES)
          wg::mbar_wait(&empty[s], ((it / WG_STAGES) - 1) & 1);
        const int gi = it / n_vis;
        const int q0 = (qt_begin + it - gi * n_vis) * WG_QSTEP;
        const int bh = b * p.Hq + h * p.group + gi;
        unsigned char* st = ring + s * SLOT;
        wg::mbar_expect_tx(&full[s], SLOT);
        wg_load_tile<DH>(st, T.q, &full[s], q0, bh, QBOX);
        wg_load_tile<DH>(st + NB * QBOX, T.dout, &full[s], q0, bh, QBOX);
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % WG_STAGES;
        const int gi = it / n_vis;
        const int q0 = (qt_begin + it - gi * n_vis) * WG_QSTEP;
        const size_t row0 =
            (size_t)(b * p.Hq + h * p.group + gi) * p.Sq + q0;
        // loaded before the slot is free: their latency passes in the wait
        float lv[WG_QSTEP / 32], dl[WG_QSTEP / 32];
#pragma unroll
        for (int i = 0; i < WG_QSTEP / 32; ++i) {
          const int r = lane + 32 * i;
          const bool in = q0 + r < p.Sq;
          lv[i] = in ? p.lse[row0 + r] * LOG2E : 0.f;   // base 2, for exp2
          dl[i] = in ? p.delta[row0 + r] : 0.f;
        }
        if (it >= WG_STAGES)
          wg::mbar_wait(&empty[s], ((it / WG_STAGES) - 1) & 1);
        float* l = lsd + s * 2 * WG_QSTEP;
#pragma unroll
        for (int i = 0; i < WG_QSTEP / 32; ++i) {
          l[lane + 32 * i] = lv[i];
          l[WG_QSTEP + lane + 32 * i] = dl[i];
        }
        wg::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  wg::regs_inc<CONSUMER_REGS>();
  const int w = wgi - 1;
  const int kw = k0 + 64 * w;                  // this consumer's first key
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int key0 = kw + ((tid & 127) >> 5) * 16 + g;   // + 0 and + 8
  // A = this consumer's 64 rows of K and V: at a head of 64 held in
  // registers (the block's whole walk reads them), at 128 read K-major
  // from shared memory (a k16 step 32 bytes into the row, the next 64 of
  // the head a box on)
  const uint64_t da_k = wg::make_desc(ks + w * 64 * BOX_ROW, 16, SBO);
  const uint64_t da_v = wg::make_desc(vs + w * 64 * BOX_ROW, 16, SBO);
  constexpr bool REG_A = DH == 64;
  uint32_t ka[REG_A ? 4 : 1][4], va[REG_A ? 4 : 1][4];
  // the accumulators start at each one's first product (scale_d 0)
  float dk[DH / 2], dv[DH / 2], sc[32], dp[32];
  int started = 0;
  wg::mbar_wait(&kvbar, 0);
  if constexpr (REG_A) {
    const int r0 = 64 * w + ((tid & 127) >> 5) * 16;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::ldmatrix_a_sw128(ka[kk], ks, r0, kk);
      wg::ldmatrix_a_sw128(va[kk], vs, r0, kk);
    }
  }

  // A pipeline of one tile: at step t a consumer finishes `cur` (its S^T
  // and dP^T products done: P^T, dS^T), then issues cur's dV and dK
  // products and tile t's S^T and dP^T as one batch, which the tensor
  // cores run while the other consumer does its math.  `held` is the tile
  // whose dV and dK products may be in flight: its slot is released once
  // they are waited for.  A tile that none of this consumer's keys is seen
  // by is released at once.
  int cur = -1, held = -1;
  uint32_t pa[4][4], da[4][4];
  for (int t = 0; t <= n_it; ++t) {
    if (cur >= 0) {
      const int s = cur % WG_STAGES;
      const int gi = cur / n_vis;
      const int q0 = (qt_begin + cur - gi * n_vis) * WG_QSTEP;
      const float* lt = lsd + s * 2 * WG_QSTEP;
      wg::wgmma_wait<0>();
      wg::fence_regs(sc);
      wg::fence_regs(dp);
      wg::fence_regs(dv);
      wg::fence_regs(dk);
      if (held >= 0) wg_release(&empty[held % WG_STAGES]);
      held = -1;
      // P^T; accumulator column 8 j + 2 q + (e & 1) is the tile's query
      // row.  Only the diagonal and ragged tiles test each element
      const bool whole = q0 + WG_QSTEP <= p.Sq && kw + 64 <= p.Sk &&
                         (!p.causal || q0 + p.q_offset >= kw + 63);
      if (whole) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lt + 8 * j + 2 * q);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = exp2_ftz(
                fmaf(sc[4 * j + e], LOG2E, (e & 1) ? -l2.y : -l2.x));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lt + 8 * j + 2 * q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x =
                fmaf(sc[4 * j + e], LOG2E, (e & 1) ? -l2.y : -l2.x);
            sc[4 * j + e] = visible(p, q0 + 8 * j + 2 * q + (e & 1),
                                    key0 + 8 * (e >> 1))
                                ? exp2_ftz(x) : 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) wg::a_from_acc(pa[i], sc, i);
      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(lt + WG_QSTEP + 8 * j + 2 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) wg::a_from_acc(da[i], dp, i);
    }

    int vis = 0;
    if (t < n_it) {
      const int gi = t / n_vis;
      const int q0 = (qt_begin + t - gi * n_vis) * WG_QSTEP;
      vis = kw < p.Sk && !(p.causal && q0 + WG_QSTEP - 1 + p.q_offset < kw);
      wg::mbar_wait(&full[t % WG_STAGES], (t / WG_STAGES) & 1);
    }
    if (cur >= 0) {
      // dV += P^T.dO, dK += dS^T.Q (B = dO, Q MN-major: 64 of the head a
      // box, LBO apart)
      const unsigned char* qs = ring + (cur % WG_STAGES) * SLOT;
      const uint64_t dbm_do = wg::make_desc(qs + NB * QBOX, QBOX, SBO);
      const uint64_t dbm_q = wg::make_desc(qs, QBOX, SBO);
      wg::wgmma_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wg::wgmma_m64_rs<DH, 1>(dv, pa[i],
                                wg::desc_advance(dbm_do, MN_STEP * i),
                                started || i > 0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wg::wgmma_m64_rs<DH, 1>(dk, da[i],
                                wg::desc_advance(dbm_q, MN_STEP * i),
                                started || i > 0);
      started = 1;
      held = cur;
    }
    if constexpr (DH == 128) {
      // at a head of 128 the dK and dV accumulators (128 registers) leave
      // no room for the A operands of these products beside the next S^T
      // and dP^T: wait for these, then issue those into cleared
      // accumulators
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(dv);
      wg::fence_regs(dk);
      if (held >= 0) wg_release(&empty[held % WG_STAGES]);
      held = -1;
    }
    if (vis) {
      // S^T = K.Q^T and dP^T = V.dO^T (B = Q, dO K-major)
      const unsigned char* qs = ring + (t % WG_STAGES) * SLOT;
      const uint64_t db_q = wg::make_desc(qs, 16, SBO);
      const uint64_t db_do = wg::make_desc(qs + NB * QBOX, 16, SBO);
      if constexpr (DH == 128) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      }
      wg::fence_regs(sc);
      wg::fence_regs(dp);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t b =
            wg::desc_advance(db_q, (kk / 4) * QBOX + (kk % 4) * 32);
        if constexpr (REG_A)
          wg::wgmma_m64_rs<64, 0>(sc, ka[kk], b, kk > 0);
        else
          wg::wgmma_m64n64<0, 0>(
              sc, wg::desc_advance(da_k, (kk / 4) * KBOX + (kk % 4) * 32), b,
              kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t b =
            wg::desc_advance(db_do, (kk / 4) * QBOX + (kk % 4) * 32);
        if constexpr (REG_A)
          wg::wgmma_m64_rs<64, 0>(dp, va[kk], b, kk > 0);
        else
          wg::wgmma_m64n64<0, 0>(
              dp, wg::desc_advance(da_v, (kk / 4) * KBOX + (kk % 4) * 32), b,
              kk > 0);
      }
    }
    wg::wgmma_commit();
    if (t < n_it && !vis) wg_release(&empty[t % WG_STAGES]);
    cur = vis ? t : -1;
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(dv);
  wg::fence_regs(dk);
  if (held >= 0) wg_release(&empty[held % WG_STAGES]);

  if (!started) {       // no query row sees these keys: gradients 0
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  }
  const size_t base = (size_t)bkv * p.Sk * DH;
  wg_store<DH>(p.dk + base, dk, kw, p.Sk, 1.f);
  wg_store<DH>(p.dv + base, dv, kw, p.Sk, 1.f);
}

// dQ of one (batch*query head, WG_ROWS-row tile).  Blocks run tile major,
// the last query tiles (causal: the most keys) of every head first.  Q
// and dO are loaded once; the key tiles of WG_KSTEP keys that the block's
// rows see stream through the ring in order (tiles above the diagonal
// never loaded).  Consumer w owns rows 64 w .. 64 w + 63 and, per tile:
//   S = Q.K^T, dP = dO.V^T           (A = Q, dO K-major; B = K, V K-major)
//   P = exp2(S log2 e - lse log2 e), dS = P (dP - delta)
//   dQ += dS.K                       (A from registers; B = K MN-major)
// then stores dQ times scale.
template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ WgMaps T,
                         const WgParams p) {
  constexpr int NB = DH / 64;
  constexpr int QBOX = WG_ROWS * BOX_ROW;      // a Q / dO box: 16 KB
  constexpr int KBOX = WG_KSTEP * BOX_ROW;     // a K / V box: 8 KB
  constexpr int SLOT = 2 * NB * KBOX;
  extern __shared__ unsigned char smem_wg[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES], qbar;
  unsigned char* qs = wg::align1024(smem_wg);
  unsigned char* dos = qs + NB * QBOX;
  unsigned char* ring = dos + NB * QBOX;

  const int tid = threadIdx.x, wgi = tid / 128;
  const int n_qb = (p.Sq + WG_ROWS - 1) / WG_ROWS;
  const int t = (int)blockIdx.x / p.bhq;
  const int bh = (int)blockIdx.x - t * p.bhq;
  const int q0 = (n_qb - 1 - t) * WG_ROWS;
  const int qn = min(WG_ROWS, p.Sq - q0);
  const int kvh = (bh / p.Hq) * p.Hkv + (bh % p.Hq) / p.group;
  const int k_end = p.causal ? min(p.Sk, q0 + qn + p.q_offset) : p.Sk;
  const int n_kt = k_end > 0 ? (k_end + WG_KSTEP - 1) / WG_KSTEP : 0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    wg::mbar_init(&qbar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    wg::regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      wg::mbar_expect_tx(&qbar, 2 * NB * QBOX);
      wg_load_tile<DH>(qs, T.q, &qbar, q0, bh, QBOX);
      wg_load_tile<DH>(dos, T.dout, &qbar, q0, bh, QBOX);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % WG_STAGES;
        if (it >= WG_STAGES)
          wg::mbar_wait(&empty[s], ((it / WG_STAGES) - 1) & 1);
        unsigned char* st = ring + s * SLOT;
        wg::mbar_expect_tx(&full[s], SLOT);
        wg_load_tile<DH>(st, T.k, &full[s], it * WG_KSTEP, kvh, KBOX);
        wg_load_tile<DH>(st + NB * KBOX, T.v, &full[s], it * WG_KSTEP, kvh,
                         KBOX);
      }
    }
    return;
  }

  wg::regs_inc<CONSUMER_REGS>();
  const int w = wgi - 1;
  const int qw = q0 + 64 * w;                  // this consumer's first row
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ra = qw + ((tid & 127) >> 5) * 16 + g, rb = ra + 8;
  const size_t hrow = (size_t)bh * p.Sq;
  // lse in base 2, for exp2
  const float lse_a = ra < p.Sq ? p.lse[hrow + ra] * LOG2E : 0.f;
  const float lse_b = rb < p.Sq ? p.lse[hrow + rb] * LOG2E : 0.f;
  const float dl_a = ra < p.Sq ? p.delta[hrow + ra] : 0.f;
  const float dl_b = rb < p.Sq ? p.delta[hrow + rb] : 0.f;
  // A = this consumer's 64 rows of Q and dO: as K and V in the dK/dV
  // kernel, in registers at a head of 64
  const uint64_t da_q = wg::make_desc(qs + w * 64 * BOX_ROW, 16, SBO);
  const uint64_t da_do = wg::make_desc(dos + w * 64 * BOX_ROW, 16, SBO);
  constexpr bool REG_A = DH == 64;
  constexpr int KN = WG_KSTEP;                 // N of the S and dP products
  uint32_t qa[REG_A ? 4 : 1][4], oa[REG_A ? 4 : 1][4];
  float dq[DH / 2], sc[KN / 2], dp[KN / 2];
  int started = 0;
  wg::mbar_wait(&qbar, 0);
  if constexpr (REG_A) {
    const int r0 = 64 * w + ((tid & 127) >> 5) * 16;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::ldmatrix_a_sw128(qa[kk], qs, r0, kk);
      wg::ldmatrix_a_sw128(oa[kk], dos, r0, kk);
    }
  }

  // the dK/dV kernel's pipeline: at step t finish `cur` (dS), then issue
  // cur's dQ product and tile t's S and dP products as one batch
  int cur = -1, held = -1;
  uint32_t da[KN / 16][4];
  for (int t = 0; t <= n_kt; ++t) {
    if (cur >= 0) {
      const int k0 = cur * WG_KSTEP;
      wg::wgmma_wait<0>();
      wg::fence_regs(sc);
      wg::fence_regs(dp);
      wg::fence_regs(dq);
      if (held >= 0) wg_release(&empty[held % WG_STAGES]);
      held = -1;
      // P, then dS = P (dP - delta); accumulator column 8 j + 2 q + (e & 1)
      // is the tile's key.  Only the diagonal and ragged tiles test each
      // element
      const bool whole = k0 + WG_KSTEP <= p.Sk && qw + 64 <= p.Sq &&
                         (!p.causal || qw + p.q_offset >= k0 + WG_KSTEP - 1);
      if (whole) {
#pragma unroll
        for (int j = 0; j < KN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool second = e >= 2;
            const float pr = exp2_ftz(
                fmaf(sc[4 * j + e], LOG2E, second ? -lse_b : -lse_a));
            dp[4 * j + e] = pr * (dp[4 * j + e] - (second ? dl_b : dl_a));
          }
      } else {
#pragma unroll
        for (int j = 0; j < KN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool second = e >= 2;
            const float x =
                fmaf(sc[4 * j + e], LOG2E, second ? -lse_b : -lse_a);
            const float pr = visible(p, second ? rb : ra,
                                     k0 + 8 * j + 2 * q + (e & 1))
                                 ? exp2_ftz(x) : 0.f;
            dp[4 * j + e] = pr * (dp[4 * j + e] - (second ? dl_b : dl_a));
          }
      }
#pragma unroll
      for (int i = 0; i < KN / 16; ++i) wg::a_from_acc(da[i], dp, i);
    }

    int vis = 0;
    if (t < n_kt) {
      vis = qw < p.Sq &&
            !(p.causal && qw + 63 + p.q_offset < t * WG_KSTEP);
      wg::mbar_wait(&full[t % WG_STAGES], (t / WG_STAGES) & 1);
    }
    if (cur >= 0) {
      // dQ += dS.K (B = K MN-major)
      const uint64_t dbm_k =
          wg::make_desc(ring + (cur % WG_STAGES) * SLOT, KBOX, SBO);
      wg::wgmma_fence();
#pragma unroll
      for (int i = 0; i < KN / 16; ++i)
        wg::wgmma_m64_rs<DH, 1>(dq, da[i],
                                wg::desc_advance(dbm_k, MN_STEP * i),
                                started || i > 0);
      started = 1;
      held = cur;
    }
    if (vis) {
      // S = Q.K^T and dP = dO.V^T (B = K, V K-major)
      const unsigned char* kt = ring + (t % WG_STAGES) * SLOT;
      const uint64_t db_k = wg::make_desc(kt, 16, SBO);
      const uint64_t db_v = wg::make_desc(kt + NB * KBOX, 16, SBO);
      wg::fence_regs(sc);
      wg::fence_regs(dp);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t b =
            wg::desc_advance(db_k, (kk / 4) * KBOX + (kk % 4) * 32);
        if constexpr (REG_A)
          wg::wgmma_m64_rs<KN, 0>(sc, qa[kk], b, kk > 0);
        else
          wg::wgmma_m64<KN, 0, 0>(
              sc, wg::desc_advance(da_q, (kk / 4) * QBOX + (kk % 4) * 32), b,
              kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint64_t b =
            wg::desc_advance(db_v, (kk / 4) * KBOX + (kk % 4) * 32);
        if constexpr (REG_A)
          wg::wgmma_m64_rs<KN, 0>(dp, oa[kk], b, kk > 0);
        else
          wg::wgmma_m64<KN, 0, 0>(
              dp, wg::desc_advance(da_do, (kk / 4) * QBOX + (kk % 4) * 32), b,
              kk > 0);
      }
    }
    wg::wgmma_commit();
    if (t < n_kt && !vis) wg_release(&empty[t % WG_STAGES]);
    cur = vis ? t : -1;
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(dq);
  if (held >= 0) wg_release(&empty[held % WG_STAGES]);

  if (!started) {       // rows that see no key pass no gradient
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
  }
  wg_store<DH>(p.dq + hrow * DH, dq, qw, p.Sq, p.scale);
}

constexpr size_t dkdv_smem(int dp) {
  return 4 * ((size_t)(BK + BK + BQ + BQ) * (dp + 4) + 2 * BQ * PT + 2 * BQ);
}
constexpr size_t dq_smem(int dp) {
  return 4 * ((size_t)(BQ + BQ + BK + BK) * (dp + 4) + BK * (BQ + 4) + 2 * BQ);
}
static_assert(dkdv_smem(128) <= MAX_SMEM && dq_smem(128) <= MAX_SMEM,
              "the D = 128 tiles must fit one block's shared memory");

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const Params& p, int bhq, int bhkv,
           cudaStream_t s) {
  auto kdkdv = attn_bwd_dkdv_kernel<T, DP>;
  auto kdq = attn_bwd_dq_kernel<T, DP>;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkdv_smem(DP));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(DP));
  }();
  if (attr != cudaSuccess) return (int)attr;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)bhq * p.Sq;
  const long long n_delta = (rows + THREADS / 32 - 1) / (THREADS / 32);
  attn_bwd_delta_kernel<T><<<(unsigned)n_delta, THREADS, 0, s>>>(
      static_cast<const T*>(out), dot, delta, rows, p.D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdkdv<<<(unsigned)((long long)bhkv * p.n_kt), THREADS, dkdv_smem(DP), s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdq<<<(unsigned)((long long)bhq * p.n_qt), THREADS, dq_smem(DP), s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dp(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, const Params& p, int bhq, int bhkv,
              cudaStream_t s) {
  if (p.D <= 16)
    return launch<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, bhq,
                         bhkv, s);
  if (p.D <= 32)
    return launch<T, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, bhq,
                         bhkv, s);
  if (p.D <= 64)
    return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, bhq,
                         bhkv, s);
  return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, bhq,
                        bhkv, s);
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const Params& p, int bhq, int bhkv,
               int vec, cudaStream_t s) {
  auto kdkdv = attn_bwd_dkdv_mma_kernel<DP>;
  auto kdq = attn_bwd_dq_mma_kernel<DP>;
  const size_t smem = mma_smem_bytes(DP);
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const uint16_t* qt = static_cast<const uint16_t*>(q);
  const uint16_t* kt = static_cast<const uint16_t*>(k);
  const uint16_t* vt = static_cast<const uint16_t*>(v);
  const uint16_t* dot = static_cast<const uint16_t*>(dout);
  const long long rows = (long long)bhq * p.Sq;
  const long long n_delta = (rows + THREADS / 32 - 1) / (THREADS / 32);
  attn_bwd_delta_kernel<__nv_bfloat16><<<(unsigned)n_delta, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), delta, rows, p.D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdkdv<<<(unsigned)((long long)bhkv * p.n_kt), MMA_THREADS, smem, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), p, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdq<<<(unsigned)((long long)bhq * p.n_qt), MMA_THREADS, smem, s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<uint16_t*>(dq), p, vec);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const float* lse,
                 float* delta, void* dq, void* dk, void* dv, const Params& p,
                 int bhq, int bhkv, cudaStream_t s) {
  auto kdkdv = attn_bwd_dkdv_wgmma_kernel<DH>;
  auto kdq = attn_bwd_dq_wgmma_kernel<DH>;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)wg_dkdv_smem(DH));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)wg_dq_smem(DH));
  }();
  if (attr != cudaSuccess) return (int)attr;
  // 3-D maps (D, S, B*H) for this call's pointers: the dK/dV kernel's
  // boxes are WG_QSTEP rows of Q and dO and WG_KEYS of K and V, the dQ
  // kernel's WG_ROWS and WG_KSTEP
  int rc = 0;
  auto map = [&](CUtensorMap* m, const void* base, int rows, int heads,
                 int box_rows) {
    const uint64_t dims[3] = {(uint64_t)DH, (uint64_t)rows, (uint64_t)heads};
    const uint64_t strides[2] = {(uint64_t)DH * 2, (uint64_t)rows * DH * 2};
    const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
    if (rc == 0) rc = (int)wg::bf16_map(m, base, 3, dims, strides, box);
  };
  WgMaps A, B;
  map(&A.q, q, p.Sq, bhq, WG_QSTEP);
  map(&A.dout, dout, p.Sq, bhq, WG_QSTEP);
  map(&A.k, k, p.Sk, bhkv, WG_KEYS);
  map(&A.v, v, p.Sk, bhkv, WG_KEYS);
  map(&B.q, q, p.Sq, bhq, WG_ROWS);
  map(&B.dout, dout, p.Sq, bhq, WG_ROWS);
  map(&B.k, k, p.Sk, bhkv, WG_KSTEP);
  map(&B.v, v, p.Sk, bhkv, WG_KSTEP);
  if (rc) return rc;
  WgParams w;
  w.Sq = p.Sq; w.Sk = p.Sk; w.Hq = p.Hq; w.Hkv = p.Hkv; w.group = p.group;
  w.causal = p.causal; w.q_offset = p.q_offset; w.bhq = bhq; w.bhkv = bhkv;
  w.scale = p.scale; w.lse = lse; w.delta = delta;
  w.dq = static_cast<uint16_t*>(dq);
  w.dk = static_cast<uint16_t*>(dk);
  w.dv = static_cast<uint16_t*>(dv);
  const long long rows = (long long)bhq * p.Sq;
  const long long n_delta = (rows + THREADS / 32 - 1) / (THREADS / 32);
  attn_bwd_delta_kernel<__nv_bfloat16><<<(unsigned)n_delta, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), delta, rows, p.D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_kb = (p.Sk + WG_KEYS - 1) / WG_KEYS;
  const long long n_qb = (p.Sq + WG_ROWS - 1) / WG_ROWS;
  kdkdv<<<(unsigned)(n_kb * bhkv), WG_THREADS, wg_dkdv_smem(DH), s>>>(A, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdq<<<(unsigned)(n_qb * bhq), WG_THREADS, wg_dq_smem(DH), s>>>(B, w);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  route (the planner's,
// dse.plan_attn_bwd_blocks): 0 cuda_core (f32, CUDA cores), 1 mma (bf16,
// mma.sync), 2 wgmma (bf16, wgmma fed by TMA: a head of 64 or 128, every
// base 16-byte aligned).  A route the dtype or the shape does not take is
// refused (cudaErrorInvalidValue), never replaced by another.  q is the
// forward's (pre-scaled) query; dq comes back multiplied by `scale`, the
// gradient of the unscaled query.  delta: f32 scratch of B*Hq*Sq.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int route, int BHq, int Sq, int Sk, int D, int Hq,
    int Hkv, int causal, int q_offset, float scale, void* stream) {
  if (BHq < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 128 || Hq < 1 ||
      Hkv < 1 || Hq % Hkv || BHq % Hq || (dtype != 0 && dtype != 1) ||
      (dtype == 0 ? route != 0 : route != 1 && route != 2))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.Sq = Sq; p.Sk = Sk; p.D = D; p.Hq = Hq; p.Hkv = Hkv;
  p.group = Hq / Hkv; p.causal = causal ? 1 : 0; p.q_offset = q_offset;
  p.n_qt = (Sq + BQ - 1) / BQ;
  p.n_kt = (Sk + BK - 1) / BK;
  p.scale = scale;
  const int bhkv = BHq / Hq * Hkv;
  if ((long long)BHq * p.n_qt > 2147483647LL ||
      (long long)bhkv * p.n_kt > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dp<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, p,
                            BHq, bhkv, s);
  // 16-byte pieces need 8-element rows and 16-byte aligned bases
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  const int vec = D % 8 == 0 && (bases & 15) == 0;
  // TMA's rule, the planner's: a head of one or two 64-wide boxes and
  // 16-byte aligned bases
  const bool tma_ok = (D == 64 || D == 128) && (bases & 15) == 0;
  if (route == 2) {
    if (!tma_ok) return (int)cudaErrorInvalidValue;
    return D == 64 ? launch_wgmma<64>(q, k, v, out, dout, lse, delta, dq, dk,
                                      dv, p, BHq, bhkv, s)
                   : launch_wgmma<128>(q, k, v, out, dout, lse, delta, dq,
                                       dk, dv, p, BHq, bhkv, s);
  }
  const int dp = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
  switch (dp) {
    case 16:
      return launch_mma<16>(q, k, v, out, dout, lse, delta, dq, dk, dv, p,
                            BHq, bhkv, vec, s);
    case 32:
      return launch_mma<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, p,
                            BHq, bhkv, vec, s);
    case 64:
      return launch_mma<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, p,
                            BHq, bhkv, vec, s);
    default:
      return launch_mma<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, p,
                             BHq, bhkv, vec, s);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
