// KV-streaming flash attention (forward) for NVIDIA Hopper (sm_90a),
// CUDA cores, f32 arithmetic.  Replaces the TPU kernel
// src/repro/kernels/flash_attention.py:25 _flash_kernel.  At the LM
// path's shapes it is bound by operations, not bytes (each K/V tile is
// reused by a whole query tile); the design keeps every operand in shared
// memory and the row state in registers, and skips masked tiles.
//
// q (B*Hq, Sq, D), pre-scaled; k, v (B*Hkv, Sk, D); out (B*Hq, Sq, D) in
// q's type (f32 or bf16).  Query head bh reads KV head
// (bh / Hq) * Hkv + (bh % Hq) / group, group = Hq / Hkv (GQA).  Under
// `causal`, query row r (absolute position r + q_offset) sees key c iff
// r + q_offset >= c.  Masked scores are -1e30 and their probabilities 0;
// a row that sees no key at all writes 0 (l == 0 divides by 1).
//
// One block owns (bh, tile of BQ query rows) and walks the keys BK = 64
// at a time: the sequential KV grid axis of the TPU kernel becomes this
// loop.  Per key tile it loads K (transposed) and V into shared memory as
// f32, computes the BQ x BK score tile, updates each row's running max m,
// denominator l and numerator acc (all f32, in registers), writes the
// probabilities to shared memory and accumulates P.V.  Tiles that lie
// wholly above the causal diagonal are never loaded: they would leave m
// unchanged, give alpha = 1 and p = 0.  Ragged Sq / Sk edges are masked
// here, so any length works.
//
// Threads: 256 as 16 x 16 (ty, tx).  Thread (ty, tx) owns query rows
// ty*TM .. ty*TM+TM-1 (TM = BQ/16): of the score tile it holds keys
// tx*4 .. tx*4+3, of the output DPT columns.  A row's 16 threads sit in
// one half-warp, so its max and sum are 4 xor-shuffles.
//
// Plain C interface (loaded with ctypes): the kernel allocates nothing
// and does not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

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
                       const Params p) {
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
    T* o = out + ((size_t)bh * p.Sq + q0 + r) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = out_col<DPT>(tx, j);
      if (c < p.D) store(o + c, acc[i][j] / safe_l);
    }
  }
}

template <typename T, int TM, int DPT>
int launch(const void* q, const void* k, const void* v, void* out,
           const Params& p, int n_blocks, size_t smem, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, TM, DPT>;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<n_blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

template <typename T, int TM>
int launch_dpt(const void* q, const void* k, const void* v, void* out,
               const Params& p, int n_blocks, size_t smem, cudaStream_t s) {
  if (p.D <= 32) return launch<T, TM, 2>(q, k, v, out, p, n_blocks, smem, s);
  if (p.D <= 64) return launch<T, TM, 4>(q, k, v, out, p, n_blocks, smem, s);
  return launch<T, TM, 8>(q, k, v, out, p, n_blocks, smem, s);
}

template <typename T>
int launch_tm(const void* q, const void* k, const void* v, void* out,
              const Params& p, int block_q, int n_blocks, size_t smem,
              cudaStream_t s) {
  if (block_q == 64) return launch_dpt<T, 4>(q, k, v, out, p, n_blocks, smem, s);
  return launch_dpt<T, 2>(q, k, v, out, p, n_blocks, smem, s);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  block_q: 32 or 64.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int BHq, int Sq, int Sk, int D, int Hq, int Hkv, int causal,
    int q_offset, int block_q, void* stream) {
  if (BHq < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 128 || Hq < 1 ||
      Hkv < 1 || Hq % Hkv || BHq % Hq || (block_q != 32 && block_q != 64) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.Sq = Sq; p.Sk = Sk; p.D = D; p.Hq = Hq; p.Hkv = Hkv;
  p.group = Hq / Hkv; p.causal = causal ? 1 : 0; p.q_offset = q_offset;
  p.n_qt = (Sq + block_q - 1) / block_q;
  const int dpt = D <= 32 ? 2 : D <= 64 ? 4 : 8;
  const size_t smem =
      4 * ((size_t)D * (block_q + PAD) + (size_t)D * (BK + PAD) +
           (size_t)BK * 16 * dpt + (size_t)block_q * (BK + PAD));
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long n_blocks = (long long)BHq * p.n_qt;
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tm<float>(q, k, v, out, p, block_q, (int)n_blocks, smem, s);
  return launch_tm<__nv_bfloat16>(q, k, v, out, p, block_q, (int)n_blocks,
                                  smem, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
