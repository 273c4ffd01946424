// KV-streaming flash attention (forward) for NVIDIA Hopper (sm_90a).
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:25
// _flash_kernel.  At the LM path's shapes it is bound by operations, not
// bytes (each K/V tile is reused by a whole query tile): 17 GFLOP against
// 42 MB at llama3.2-1b's prefill.  Two routes, chosen by the dtype code:
//
// bf16: the tensor cores (FA2-style, flash_attention_mma_kernel).  One
// block of 4 warps owns (bh, 64 query rows); warp w owns rows 16w..16w+15.
// The query tile goes to registers once as mma A fragments.  Key and value
// tiles of 64 keys stream through shared memory as bf16 in a cp.async
// double buffer (tile i+1 lands while tile i is used).  S = Q.K^T is
// mma.sync m16n8k16 into f32 registers (K through ldmatrix); the online
// softmax runs in registers, a row's max and sum over the 4 threads of a
// quad by two xor-shuffles; P is repacked from C fragments into A
// fragments as bf16 without touching shared memory; O += P.V by mma with V
// through ldmatrix.trans; O, m and l stay f32 in registers.  P is rounded
// to bf16 for P.V while l sums the f32 p (the usual FA2 choice; the
// Pallas kernel keeps P in f32).  Heads narrower than a multiple of 16 are
// padded with zeros in shared memory (DP = 16, 32, 64 or 128).
//
// f32: the CUDA cores (flash_attention_kernel), so that f32 keeps f32
// accuracy (TF32 would miss 2e-5).  256 threads as 16 x 16 (ty, tx); K
// (transposed) and V are f32 in shared memory; thread (ty, tx) owns query
// rows ty*TM .. ty*TM+TM-1 (TM = BQ/16): of the score tile it holds keys
// tx*4 .. tx*4+3, of the output DPT columns; a row's max and sum are 4
// xor-shuffles within a half-warp.
//
// Both: q (B*Hq, Sq, D), pre-scaled; k, v (B*Hkv, Sk, D); out (B*Hq, Sq,
// D) in q's type.  Query head bh reads KV head (bh / Hq) * Hkv + (bh % Hq)
// / group, group = Hq / Hkv (GQA).  Under `causal`, query row r (absolute
// position r + q_offset) sees key c iff r + q_offset >= c.  Masked scores
// are -1e30 and their probabilities 0; a row that sees no key at all
// writes 0 (l == 0 divides by 1).  One block per (bh, query tile) walks
// the keys BK = 64 at a time: the sequential KV grid axis of the TPU
// kernel becomes this loop.  Key tiles wholly above the causal diagonal
// are never loaded (they would leave m unchanged, give alpha = 1 and p =
// 0); the diagonal tile and the ragged Sq / Sk edges are masked here, so
// any length works; the heaviest causal tiles (last query rows) start
// first.
//
// For training both routes also write each row's log-sum-exp, lse = m +
// log(l) (l replaced by 1 where it is 0), which the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from; serving
// passes a null lse and pays nothing for it.
//
// Plain C interface (loaded with ctypes): the kernels allocate nothing
// and do not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int TN = BK / 16;       // keys per thread in the score tile
constexpr int PAD = 4;            // floats after each shared-memory row
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for

struct Params {
  int Sq, Sk, D, Hq, Hkv, group, causal, q_offset, n_qt;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// output column of a thread's j-th value: 16 threads side by side, in
// runs of 4 (16-byte loads) once the head is 64 wide or more
template <int DPT>
__device__ __forceinline__ int out_col(int tx, int j) {
  if constexpr (DPT >= 4)
    return (j / 4) * 64 + tx * 4 + (j % 4);
  else
    return tx + 16 * j;
}

template <typename T, int TM, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, const Params p) {
  constexpr int BQ = 16 * TM;
  constexpr int QS = BQ + PAD;  // row pitch of qT
  constexpr int KS = BK + PAD;  // row pitch of kT and ps
  constexpr int DV = 16 * DPT;  // row pitch of vs (head padded with zeros)
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;               // [D][QS]   query tile, transposed
  float* kT = qT + p.D * QS;      // [D][KS]   key tile, transposed
  float* vs = kT + p.D * KS;      // [BK][DV]  value tile
  float* ps = vs + BK * DV;       // [BQ][KS]  probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x / p.n_qt;
  // the heaviest causal tiles (last query rows) start first
  const int qt = p.n_qt - 1 - (blockIdx.x - bh * p.n_qt);
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, p.Sq - q0);
  const int kvh = (bh / p.Hq) * p.Hkv + (bh % p.Hq) / p.group;
  const T* qb = q + ((size_t)bh * p.Sq + q0) * p.D;
  const T* kb = k + (size_t)kvh * p.Sk * p.D;
  const T* vb = v + (size_t)kvh * p.Sk * p.D;

  for (int i = tid; i < BQ * p.D; i += THREADS) {
    const int r = i / p.D, d = i - r * p.D;
    qT[d * QS + r] = (r < q_rows) ? to_f32(qb[(size_t)r * p.D + d]) : 0.f;
  }
  // head columns D..DV of the value tile are never loaded: zero them once
  const int dpad = DV - p.D;
  for (int i = tid; i < BK * dpad; i += THREADS) {
    const int c = i / dpad;
    vs[c * DV + p.D + (i - c * dpad)] = 0.f;
  }

  float m[TM], l[TM], acc[TM][DPT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // keys past the tile's last visible one are never loaded
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + q_rows - 1 + p.q_offset + 1);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int kn = min(BK, p.Sk - k0);
    __syncthreads();  // the last tile's reads of kT / vs / ps are done
    for (int i = tid; i < BK * p.D; i += THREADS) {
      const int c = i / p.D, d = i - c * p.D;
      float kv = 0.f, vv = 0.f;
      if (c < kn) {
        const size_t off = (size_t)(k0 + c) * p.D + d;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      kT[d * KS + c] = kv;
      vs[c * DV + d] = vv;
    }
    __syncthreads();

    // scores of rows ty*TM+i against keys k0 + tx*TN + j
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < p.D; ++d) {
      float qa[TM];
      const float* qrow = qT + d * QS + ty * TM;
      if constexpr (TM == 4) {
        const float4 t = *reinterpret_cast<const float4*>(qrow);
        qa[0] = t.x; qa[1] = t.y; qa[2] = t.z; qa[3] = t.w;
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) qa[i] = qrow[i];
      }
      const float4 kk = *reinterpret_cast<const float4*>(kT + d * KS + tx * TN);
      const float kc[TN] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty * TM + i + p.q_offset;
      bool vis[TN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx * TN + j;
        vis[j] = col < p.Sk && (!p.causal || qpos >= col);
        if (!vis[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float pr[TN], sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        pr[j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pr[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty * TM + i) * KS + tx * TN) =
          make_float4(pr[0], pr[1], pr[2], pr[3]);
    }
    __syncthreads();

    // acc += P . V over the keys of this tile (p is 0 past kn)
    for (int c0 = 0; c0 < kn; c0 += 4) {
      float4 pp[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pp[i] = *reinterpret_cast<const float4*>(ps + (ty * TM + i) * KS + c0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (c0 + u) * DV;
        float vv[DPT];
        if constexpr (DPT >= 4) {
#pragma unroll
          for (int g = 0; g < DPT / 4; ++g) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
            vv[4 * g] = t.x; vv[4 * g + 1] = t.y;
            vv[4 * g + 2] = t.z; vv[4 * g + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < DPT; ++j) vv[j] = vrow[out_col<DPT>(tx, j)];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float pu = u == 0 ? pp[i].x : u == 1 ? pp[i].y
                         : u == 2 ? pp[i].z : pp[i].w;
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pu, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= q_rows) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * p.Sq + q0 + r] = m[i] + logf(safe_l);
    T* o = out + ((size_t)bh * p.Sq + q0 + r) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = out_col<DPT>(tx, j);
      if (c < p.D) store(o + c, acc[i][j] / safe_l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps, 16 query rows each
constexpr int MMA_BQ = 64;         // query rows per block
constexpr float LOG2E = 1.4426950408889634f;

// shared memory of one block: the query tile and two stages of key and
// value tiles, bf16, rows padded by 8 elements
constexpr size_t mma_smem_bytes(int dp) {
  return 2 * (size_t)(MMA_BQ + 4 * BK) * (dp + 8);
}

// heads up to 64 wide: four blocks an SM (at most 128 registers a
// thread); 128 wide: the registers the kernel wants (faster on the card
// than a cap that spills)
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, DP <= 64 ? 4 : 1)
flash_attention_mma_kernel(const uint16_t* __restrict__ q,
                           const uint16_t* __restrict__ k,
                           const uint16_t* __restrict__ v,
                           uint16_t* __restrict__ out,
                           float* __restrict__ lse, const Params p,
                           const int vec) {
  using namespace mma_bf16;
  constexpr int PITCH = DP + 8;
  constexpr int KD = DP / 16;   // k-steps of Q.K^T
  constexpr int NT = DP / 8;    // 8-column blocks of O
  constexpr int NS = BK / 8;    // 8-key blocks of S
  extern __shared__ __align__(16) uint16_t smem_mma[];
  uint16_t* qs = smem_mma;                  // [BQ][PITCH]
  uint16_t* ks = qs + MMA_BQ * PITCH;       // [2][BK][PITCH]
  uint16_t* vs = ks + 2 * BK * PITCH;       // [2][BK][PITCH]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.n_qt;
  const int qt = p.n_qt - 1 - (blockIdx.x - bh * p.n_qt);
  const int q0 = qt * MMA_BQ;
  const int q_rows = min(MMA_BQ, p.Sq - q0);
  const int kvh = (bh / p.Hq) * p.Hkv + (bh % p.Hq) / p.group;
  const uint16_t* qb = q + ((size_t)bh * p.Sq + q0) * p.D;
  const uint16_t* kb = k + (size_t)kvh * p.Sk * p.D;
  const uint16_t* vb = v + (size_t)kvh * p.Sk * p.D;
  const bool vc = vec != 0;

  // keys past the tile's last visible one are never loaded
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + q_rows + p.q_offset);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  load_tile<MMA_BQ, DP, MMA_THREADS>(qs, PITCH, qb, p.D, q_rows, p.D, vc,
                                     tid);
  if (n_kt > 0) {
    load_tile<BK, DP, MMA_THREADS>(ks, PITCH, kb, p.D, p.Sk, p.D, vc, tid);
    load_tile<BK, DP, MMA_THREADS>(vs, PITCH, vb, p.D, p.Sk, p.D, vc, tid);
  }
  cp_async_commit();

  // rows g and g + 8 of this warp's 16
  const int row0 = q0 + warp * 16 + g;   // query index; + 8 for the second
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t qf[KD][4];

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    const int k0 = it * BK;
    if (it + 1 < n_kt) {       // the next tile lands while this one is used
      const int k1 = k0 + BK;
      uint16_t* kd = ks + (st ^ 1) * BK * PITCH;
      uint16_t* vd = vs + (st ^ 1) * BK * PITCH;
      load_tile<BK, DP, MMA_THREADS>(kd, PITCH, kb + (size_t)k1 * p.D, p.D,
                                     p.Sk - k1, p.D, vc, tid);
      load_tile<BK, DP, MMA_THREADS>(vd, PITCH, vb + (size_t)k1 * p.D, p.D,
                                     p.Sk - k1, p.D, vc, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();        // everything but the tile just asked for
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_a(qf[kk], qs + warp * 16 * PITCH + kk * 16, PITCH, lane);
    }
    const uint16_t* kt = ks + st * BK * PITCH;
    const uint16_t* vt = vs + st * BK * PITCH;

    // S = Q . K^T: 16 rows x 64 keys per warp, f32
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldmatrix_b_nk(b, kt + np * 16 * PITCH + kk * 16, PITCH, lane);
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask the ragged edge and the causal diagonal
    const bool edge = k0 + BK > p.Sk ||
                      (p.causal && k0 + BK - 1 > q0 + warp * 16 + p.q_offset);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qpos = row0 + (e >> 1) * 8 + p.q_offset;
          if (col >= p.Sk || (p.causal && qpos < col)) s[j][e] = NEG_INF;
        }
    }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = exp2f((m[h] - m_new) * LOG2E);
      const float ms = m_new * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float pr =
              s[j][e] == NEG_INF ? 0.f : exp2f(fmaf(s[j][e], LOG2E, -ms));
          s[j][e] = pr;
          sum += pr;
        }
      l[h] = l[h] * alpha[h] + sum;   // this thread's columns; quad-summed
      m[h] = m_new;                   // at the end
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // O += P . V, P repacked as bf16 A fragments, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_b_kn(b, vt + kk * 16 * PITCH + np * 16, PITCH, lane);
        mma(o[2 * np], a, b[0], b[1]);
        mma(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // this stage is read before the next load refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r >= q_rows) continue;
    const float safe_l = l[h] > 0.f ? l[h] : 1.f;
    if (lse != nullptr && t4 == 0)
      lse[(size_t)bh * p.Sq + q0 + r] = m[h] + logf(safe_l);
    const float inv = 1.f / safe_l;
    uint16_t* orow = out + ((size_t)bh * p.Sq + q0 + r) * p.D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t4;
      const float v0 = o[j][2 * h] * inv, v1 = o[j][2 * h + 1] * inv;
      if (vc && c + 1 < p.D) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16x2(v0, v1);
      } else {
        const uint32_t pk = pack_bf16x2(v0, v1);
        if (c < p.D) orow[c] = (uint16_t)(pk & 0xffffu);
        if (c + 1 < p.D) orow[c + 1] = (uint16_t)(pk >> 16);
      }
    }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, const Params& p, int n_blocks, int vec,
               cudaStream_t stream) {
  auto kern = flash_attention_mma_kernel<DP>;
  const size_t smem = mma_smem_bytes(DP);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<n_blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), lse, p,
      vec);
  return (int)cudaGetLastError();
}

// the head padded to a multiple of 16 that is instantiated
int mma_head_pad(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int TM, int DPT>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, const Params& p, int n_blocks, size_t smem,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, TM, DPT>;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<n_blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, p);
  return (int)cudaGetLastError();
}

template <typename T, int TM>
int launch_dpt(const void* q, const void* k, const void* v, void* out,
               float* lse, const Params& p, int n_blocks, size_t smem,
               cudaStream_t s) {
  if (p.D <= 32)
    return launch<T, TM, 2>(q, k, v, out, lse, p, n_blocks, smem, s);
  if (p.D <= 64)
    return launch<T, TM, 4>(q, k, v, out, lse, p, n_blocks, smem, s);
  return launch<T, TM, 8>(q, k, v, out, lse, p, n_blocks, smem, s);
}

template <typename T>
int launch_tm(const void* q, const void* k, const void* v, void* out,
              float* lse, const Params& p, int block_q, int n_blocks,
              size_t smem, cudaStream_t s) {
  if (block_q == 64)
    return launch_dpt<T, 4>(q, k, v, out, lse, p, n_blocks, smem, s);
  return launch_dpt<T, 2>(q, k, v, out, lse, p, n_blocks, smem, s);
}

}  // namespace

// dtype codes: 0 float32 (CUDA cores; block_q 32 or 64), 1 bfloat16
// (tensor cores; block_q 64).  lse: null (serving), or f32 (B*Hq, Sq)
// that receives each row's m + log(l), l replaced by 1 where it is 0 (the
// reference's safe_l) — what the backward kernel recomputes p from.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int dtype,
    int BHq, int Sq, int Sk, int D, int Hq, int Hkv, int causal,
    int q_offset, int block_q, void* stream) {
  if (BHq < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 128 || Hq < 1 ||
      Hkv < 1 || Hq % Hkv || BHq % Hq ||
      (dtype == 0 && block_q != 32 && block_q != 64) ||
      (dtype == 1 && block_q != MMA_BQ) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.Sq = Sq; p.Sk = Sk; p.D = D; p.Hq = Hq; p.Hkv = Hkv;
  p.group = Hq / Hkv; p.causal = causal ? 1 : 0; p.q_offset = q_offset;
  p.n_qt = (Sq + block_q - 1) / block_q;
  const long long n_blocks = (long long)BHq * p.n_qt;
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // 16-byte pieces need 8-element rows and 16-byte aligned bases
    const int vec = D % 8 == 0 &&
                    ((reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) |
                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    switch (mma_head_pad(D)) {
      case 16:
        return launch_mma<16>(q, k, v, out, lse, p, (int)n_blocks, vec, s);
      case 32:
        return launch_mma<32>(q, k, v, out, lse, p, (int)n_blocks, vec, s);
      case 64:
        return launch_mma<64>(q, k, v, out, lse, p, (int)n_blocks, vec, s);
      default:
        return launch_mma<128>(q, k, v, out, lse, p, (int)n_blocks, vec, s);
    }
  }
  const int dpt = D <= 32 ? 2 : D <= 64 ? 4 : 8;
  const size_t smem =
      4 * ((size_t)D * (block_q + PAD) + (size_t)D * (BK + PAD) +
           (size_t)BK * 16 * dpt + (size_t)block_q * (BK + PAD));
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  return launch_tm<float>(q, k, v, out, lse, p, block_q, (int)n_blocks, smem,
                         s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
