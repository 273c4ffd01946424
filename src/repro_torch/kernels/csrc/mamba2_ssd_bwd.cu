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
// so, with dy the cotangent of y and dS that of S' (the state leaving the
// tile), walking the tiles last to first and carrying dS:
//
//   G_ts  = (c_t . b_s) E_ts dt_s,  Gd_ts = (dy_t . x_s) E_ts dt_s,
//   K_ts  = (c_t . b_s)(dy_t . x_s) E_ts                     (s <= t)
//   Z_s   = dS b_s,  Y_s = x_s^T dS,  u_t = dy_t^T S,  V_s = x_s . Z_s,
//   I_t   = c_t . u_t
//   dx_s  = sum_{t>=s} G_ts dy_t + w_s Z_s
//   dc_t  = sum_{s<=t} Gd_ts b_s + exp(cum_t) u_t
//   db_s  = sum_{t>=s} Gd_ts c_t + w_s Y_s
//   dS_in = D dS + sum_t exp(cum_t) dy_t (x) c_t          (carried back)
//   dcum_t = sum_s K_ts dt_s - dt_t sum_{t'} K_t't + exp(cum_t) I_t - w_t V_t
//            (+ D sum(dS * S) + sum_s w_s V_s at the tile's last position)
//   ddt_s = sum_t K_ts + g_s V_s + a revcum(dcum)_s,
//   da   += sum_s dt_s revcum(dcum)_s
//
// where revcum is the reverse inclusive cumsum within the tile (cum is a
// cumsum of dt a).  The state entering each tile, S, is the forward's own:
// mamba2_ssd.cu writes it when asked (tile_states), with tiles of the same
// BQ, so nothing is recomputed here.  exp is taken only where s <= t and
// for differences that are <= 0 (a < 0 < dt), so every factor lies in
// (0, 1]: the gradient stays finite where the plain ssd_chunked -- which
// takes exp of the whole (t, s) difference and masks afterwards -- gives
// 0 * inf = NaN above the diagonal.  A ragged last tile reads x, b, c, dy
// and dt as 0 past L, which leaves cum and every sum untouched.
//
// Deterministic: no float atomics.  One block owns one (batch row, head);
// b and c are shared by every head, so db and dc are written as per-head
// partials (B, H, L, N) f32 that the caller sums over H in a fixed order,
// and da as one partial per (batch row, head) summed over B by the
// caller; every other output element has one writer.
//
// What bounds it: at mamba2-1.3b's train microbatch (B 4, L 4096, H 64,
// P 64, N 128, bf16) the backward must read x, dy, b, c, dt and write dx,
// db, dc, ddt -- about 0.43 GB, 0.13 ms at 3.35 TB/s -- and does about
// twice the forward's products, about 0.08 ms at the bf16 tensor-core
// rate: bytes.  This first kernel is simple and right rather than fast:
// every product runs on the CUDA cores in f32 out of shared memory (bf16
// inputs are widened as they are loaded; dx rounds once to bf16), 256
// threads as 16 x 16 (ty, tx), thread (ty, tx) owning rows ty + 16 i and
// columns tx + 16 j of each small product (row operand broadcast, column
// operand on distinct banks: rows have an odd pitch).  About 129 KB of
// shared memory at P 64, N 128: one block an SM, and a block's walk is
// serial, so its time is the latency of a tile's chain of products.
//
// Plain C interface (loaded with ctypes): the kernel allocates nothing and
// does not synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // 227 KB: the most one block may ask for
constexpr int BQ = 32;            // positions a tile: the forward's tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int MAX_P = 64;         // head dim the register tiles cover
constexpr int MAX_N = 128;        // state dim the register tiles cover
constexpr int TQ = BQ / 16;       // tile rows / columns a thread owns
constexpr int TP = MAX_P / 16;
constexpr int TN = MAX_N / 16;
constexpr int GP = BQ + 1;        // pitch of the (t, s) tiles

struct Params {
  int L, H, P, N, NP, XP, ntiles;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the sum of v over the 16 lanes that share a ty (lanes 0-15 and 16-31 of
// a warp are two rows), in a fixed order
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba2_ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ bm,
                      const T* __restrict__ cm,
                      const float* __restrict__ states,
                      const T* __restrict__ dy,
                      const float* __restrict__ dsf, T* __restrict__ dx,
                      float* __restrict__ ddt, float* __restrict__ dbp,
                      float* __restrict__ dcp, float* __restrict__ dap,
                      float* __restrict__ ds0, const Params p) {
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
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const float ah = a[h];
  const size_t state_off = (size_t)bh * P * N;

  for (int i = tid; i < P * N; i += THREADS) {
    const int pi = i / N, n = i - pi * N;
    dS[pi * NP + n] = dsf != nullptr ? dsf[state_off + i] : 0.f;
  }

  const T* xb = x + b * p.x_sb + (size_t)h * P;
  const T* bb = bm + b * p.b_sb;
  const T* cb = cm + b * p.c_sb;
  const float* dtb = dt + (size_t)b * p.L * p.H + h;
  const T* dyb = dy + ((size_t)b * p.L * p.H + h) * P;
  T* dxb = dx + ((size_t)b * p.L * p.H + h) * P;
  float* ddtb = ddt + (size_t)b * p.L * p.H + h;
  float* dbb = dbp + (size_t)bh * p.L * N;
  float* dcb = dcp + (size_t)bh * p.L * N;

  // the clamped columns of this thread (reads stay inside the tiles; the
  // writes past P or N are skipped)
  int pc[TP], nc[TN], pr[TP];
#pragma unroll
  for (int j = 0; j < TP; ++j) {
    pc[j] = min(tx + 16 * j, P - 1);
    pr[j] = min(ty + 16 * j, P - 1);
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) nc[j] = min(tx + 16 * j, N - 1);

  float da_acc = 0.f;  // warp 0, lane 0: this (batch row, head)'s da
  for (int k = p.ntiles - 1; k >= 0; --k) {
    const int l0 = k * BQ, qv = min(BQ, p.L - l0);
    __syncthreads();  // the last tile's reads are done, dS is written
    for (int i = tid; i < BQ * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      float cv = 0.f, bv = 0.f;
      if (t < qv) {
        cv = to_f32(cb[(l0 + t) * p.c_sl + n]);
        bv = to_f32(bb[(l0 + t) * p.b_sl + n]);
      }
      cs[t * NP + n] = cv;
      bs[t * NP + n] = bv;
    }
    for (int i = tid; i < BQ * P; i += THREADS) {
      const int t = i / P, pp = i - t * P;
      float xv = 0.f, gv = 0.f;
      if (t < qv) {
        xv = to_f32(xb[(l0 + t) * p.x_sl + pp]);
        gv = to_f32(dyb[(size_t)(l0 + t) * p.H * P + pp]);
      }
      xs[t * XP + pp] = xv;
      dys[t * XP + pp] = gv;
    }
    {
      const float* sk = states + ((size_t)bh * p.ntiles + k) * P * N;
      for (int i = tid; i < P * N; i += THREADS) {
        const int pi = i / N, n = i - pi * N;
        S[pi * NP + n] = sk[i];
      }
    }
    if (tid < BQ) dts[tid] = tid < qv ? dtb[(size_t)(l0 + tid) * p.H] : 0.f;
    __syncthreads();

    // cum: inclusive prefix sum of dt a over the tile, a lane a position
    if (warp == 0) {
      float s = dts[lane] * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += o;
      }
      const float last = __shfl_sync(0xffffffffu, s, 31);
      cum[lane] = s;
      ecum[lane] = expf(s);
      gq[lane] = expf(last - s);
    }
    __syncthreads();

    // phase 1.  (a) the (t, s) tiles; (b) sum(dS * S); (c) Z, V; (d) u, I;
    // (e) Y.  Z, u and Y stay in registers for phase 2.
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
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) red[warp] = part;
    }
    float z[TQ][TP], u[TQ][TN], yv[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int j = 0; j < TP; ++j) z[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) { u[i][j] = 0.f; yv[i][j] = 0.f; }
    }
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
    // u[t][n] = sum_p dy[t][p] S[p][n];  Y[s][n] = sum_p x[s][p] dS[p][n]
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
    // then its row's 16 lanes
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int r = ty + 16 * i;
      float v = 0.f, w = 0.f;
#pragma unroll
      for (int j = 0; j < TP; ++j)
        if (tx + 16 * j < P) v = fmaf(xs[r * XP + pc[j]], z[i][j], v);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (tx + 16 * j < N) w = fmaf(cs[r * NP + nc[j]], u[i][j], w);
      v = sum16(v);
      w = sum16(w);
      if (tx == 0) {
        vv[r] = v;
        iv[r] = w;
      }
    }
    __syncthreads();

    // phase 2: dx, dc, db (rows ty + 16 i), the carried dS (rows ty + 16 i
    // of P), and in warp 0 dcum -> ddt and da
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
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int s = ty + 16 * i;
        if (s >= qv) continue;
        const float w = dts[s] * gq[s];
        T* row = dxb + (size_t)(l0 + s) * p.H * P;
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          const int pp = tx + 16 * j;
          if (pp < P) store(row + pp, fmaf(w, z[i][j], acc[i][j]));
        }
      }
    }
    {
      float ac[TQ][TN], ab[TQ][TN];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) { ac[i][j] = 0.f; ab[i][j] = 0.f; }
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
            ac[i][j] = fmaf(g1[i], bv[j], ac[i][j]);
            ab[i][j] = fmaf(g2[i], cv[j], ab[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int r = ty + 16 * i;
        if (r >= qv) continue;
        const float e = ecum[r], w = dts[r] * gq[r];
        float* crow = dcb + (size_t)(l0 + r) * N;
        float* brow = dbb + (size_t)(l0 + r) * N;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = tx + 16 * j;
          if (n >= N) continue;
          crow[n] = fmaf(e, u[i][j], ac[i][j]);
          brow[n] = fmaf(w, yv[i][j], ab[i][j]);
        }
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
      float wv = w * v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wv += __shfl_xor_sync(0xffffffffu, wv, off);
      if (t == BQ - 1) {
        float dd = 0.f;
        for (int i = 0; i < THREADS / 32; ++i) dd += red[i];
        dcum += expf(cum[BQ - 1]) * dd + wv;
      }
      // reverse inclusive cumsum over the lanes
      float rc = dcum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, rc, off);
        if (t + off < 32) rc += o;
      }
      if (t < qv) ddtb[(size_t)(l0 + t) * p.H] = colk + g * v + ah * rc;
      float dap_t = d * rc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dap_t += __shfl_xor_sync(0xffffffffu, dap_t, off);
      if (t == 0) da_acc += dap_t;
    }
    {
      // dS <- D dS + sum_t exp(cum_t) dy_t (x) c_t; each thread reads and
      // writes only its own elements, and every other read of dS in this
      // tile came before the barrier above
      const float dec = expf(cum[BQ - 1]);
      float acc[TP][TN];
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      for (int t = 0; t < BQ; ++t) {
        const float e = ecum[t];
        float gv[TP], cv[TN];
#pragma unroll
        for (int i = 0; i < TP; ++i) gv[i] = dys[t * XP + pr[i]] * e;
#pragma unroll
        for (int j = 0; j < TN; ++j) cv[j] = cs[t * NP + nc[j]];
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(gv[i], cv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        const int pp = ty + 16 * i;
        if (pp >= P) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = tx + 16 * j;
          if (n < N) dS[pp * NP + n] = fmaf(dec, dS[pp * NP + n], acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    const int pi = i / N, n = i - pi * N;
    ds0[state_off + i] = dS[pi * NP + n];
  }
  if (tid == 0) dap[bh] = da_acc;
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* states, const void* dy,
           const float* dsf, void* dx, float* ddt, float* dbp, float* dcp,
           float* dap, float* ds0, const Params& p, int blocks,
           cudaStream_t stream) {
  auto kern = mamba2_ssd_bwd_kernel<T>;
  const size_t smem = 4 * (2 * (size_t)BQ * p.NP + 2 * (size_t)BQ * p.XP +
                           2 * (size_t)p.P * p.NP + 3 * (size_t)BQ * GP +
                           6 * BQ + 8);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // once per instantiation (thread-safe static initialisation)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), states, static_cast<const T*>(dy), dsf,
      static_cast<T*>(dx), ddt, dbp, dcp, dap, ds0, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes (x, b, c, dy, dx): 0 float32, 1 bfloat16; both take the
// same f32 CUDA-core arithmetic.  Strides are in elements: x's (H, P)
// axes and b's and c's N axis are contiguous, with their batch and
// position strides given; dt, a, tile_states (B, H, ceil(L / block_l),
// P, N), dy and every output are contiguous.  state_grad may be null
// (zeros).  Outputs: dx (B, L, H, P) in the input dtype, ddt (B, L, H),
// db and dc partials (B, H, L, N), da partials (B, H) and the initial
// state's gradient (B, H, P, N), all f32 but dx.
extern "C" int mamba2_ssd_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* tile_states, const void* dy,
    const void* state_grad, void* dx, void* ddt, void* db_part,
    void* dc_part, void* da_part, void* d_init_state, int dtype, int B,
    int L, int H, int P, int N, long long x_sb, long long x_sl,
    long long b_sb, long long b_sl, long long c_sb, long long c_sl,
    int block_l, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || P > MAX_P ||
      N > MAX_N || (dtype != 0 && dtype != 1) || block_l != BQ)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  Params p;
  p.L = L; p.H = H; p.P = P; p.N = N;
  p.NP = N | 1;  // odd pitches: conflict-free column reads
  p.XP = P | 1;
  p.ntiles = (L + BQ - 1) / BQ;
  p.x_sb = x_sb; p.x_sl = x_sl; p.b_sb = b_sb; p.b_sl = b_sl;
  p.c_sb = c_sb; p.c_sl = c_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* stf = static_cast<const float*>(tile_states);
  const float* dsf = static_cast<const float*>(state_grad);
  float* ddtf = static_cast<float*>(ddt);
  float* dbf = static_cast<float*>(db_part);
  float* dcf = static_cast<float*>(dc_part);
  float* daf = static_cast<float*>(da_part);
  float* ds0 = static_cast<float*>(d_init_state);
  if (dtype == 1)
    return launch<uint16_t>(x, dtf, af, bm, cm, stf, dy, dsf, dx, ddtf, dbf,
                            dcf, daf, ds0, p, (int)blocks, s);
  return launch<float>(x, dtf, af, bm, cm, stf, dy, dsf, dx, ddtf, dbf, dcf,
                       daf, ds0, p, (int)blocks, s);
}

extern "C" const char* mamba2_ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
