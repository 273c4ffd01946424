// Fragment helpers for bf16 tensor-core products on Hopper (sm_90a), shared
// by the attention, fused-MLP and SSD kernels.
//
// The product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// C (16 x 8, f32) += A (16 x 16, bf16) . B (16 x 8, bf16), one warp.  With
// g = lane / 4 and t = lane % 4 a thread holds
//   A: a[0] = (row g,   k 2t..2t+1)   a[1] = (row g+8, k 2t..2t+1)
//      a[2] = (row g,   k 2t+8..+9)   a[3] = (row g+8, k 2t+8..+9)
//   B: b[0] = (k 2t..2t+1, col g)     b[1] = (k 2t+8..+9, col g)
//   C: c[0..1] = (row g, cols 2t, 2t+1)   c[2..3] = (row g+8, same cols)
// (two bf16 in one 32-bit register, the lower column in the low half).
//
// Operands come from shared-memory tiles that are row-major with a row
// pitch of (width + 8) bf16: 16 bytes of padding put the eight rows that
// one ldmatrix phase reads into eight different bank groups.
//   A row-major (rows x k):            ldmatrix_a       (x4)
//   B stored as (cols x k), row-major:  ldmatrix_b_nk   (x4: two 8-col blocks)
//                                       ldmatrix_b_nk1  (x2: one block)
//   B stored as (k x cols), row-major:  ldmatrix_b_kn   (x4.trans: two blocks)
//                                       ldmatrix_b_kn1  (x2.trans: one block)
//   A stored as (k x rows), row-major:  ldmatrix_a_trans (x4.trans)
// An f32 operand enters as a bf16 high part plus a bf16 low part (split2,
// scale_split): two mma, about 16 significant bits.
// Tiles arrive through cp.async (16 bytes a thread, global -> shared, L2
// only), committed in groups and waited for with cp_async_wait<N>.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A fragment of a 16 x 16 tile at p (row-major, pitch in elements): lane l
// points at row l % 16, column 8 * (l / 16)
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4],
                                           const uint16_t* tile, int pitch,
                                           int lane) {
  const uint16_t* p = tile + (lane & 15) * pitch + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)) : "memory");
}

// B fragments of two 8-column blocks (cols 0..7 -> b[0], b[1]; cols 8..15
// -> b[2], b[3]) from a tile stored (cols x k) row-major, 16 k deep
__device__ __forceinline__ void ldmatrix_b_nk(uint32_t (&b)[4],
                                              const uint16_t* tile, int pitch,
                                              int lane) {
  const uint16_t* p = tile + ((lane & 7) + ((lane >> 4) << 3)) * pitch +
                      ((lane >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_u32(p)) : "memory");
}

// the same for one 8-column block (lanes 0..15 give the addresses)
__device__ __forceinline__ void ldmatrix_b_nk1(uint32_t (&b)[2],
                                               const uint16_t* tile,
                                               int pitch, int lane) {
  const uint16_t* p = tile + (lane & 7) * pitch + ((lane >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1]) : "r"(smem_u32(p)) : "memory");
}

// B fragments of two 8-column blocks from a tile stored (k x cols)
// row-major, 16 k deep: the transposing load
__device__ __forceinline__ void ldmatrix_b_kn(uint32_t (&b)[4],
                                              const uint16_t* tile, int pitch,
                                              int lane) {
  const uint16_t* p = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                      (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_u32(p)) : "memory");
}

// the same for one 8-column block (lanes 0..15 give the addresses)
__device__ __forceinline__ void ldmatrix_b_kn1(uint32_t (&b)[2],
                                               const uint16_t* tile,
                                               int pitch, int lane) {
  const uint16_t* p = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1]) : "r"(smem_u32(p)) : "memory");
}

// c += a . b on the tensor cores, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even), lo in
// the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the C fragments of two neighbouring 8-column blocks (columns 0..15 of a
// 16-row tile) -> the A fragment of that 16 x 16 tile, rounded to bf16,
// without touching shared memory
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// A fragment of a 16 x 16 tile stored transposed, (k x m) row-major:
// ldmatrix.trans of the four 8 x 8 blocks (m 0-7 | 8-15) x (k 0-7 | 8-15)
__device__ __forceinline__ void ldmatrix_a_trans(uint32_t (&a)[4],
                                                 const uint16_t* tile,
                                                 int pitch, int lane) {
  const uint16_t* p = tile + ((lane & 7) + (lane >> 4) * 8) * pitch +
                      ((lane >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)) : "memory");
}

// two f32 -> a bf16 high part and a bf16 low part (v - hi), packed
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(v0 - __low2float(h), v1 - __high2float(h));
}

// a packed pair of bf16 times (w0, w1) in f32, split into hi and lo
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  split2(__uint_as_float(v << 16) * w0, __uint_as_float(v & 0xffff0000u) * w1,
         hi, lo);
}

// a (rows x cols) tile of a row-major global matrix (leading dimension ld
// elements) into shared memory (row pitch `pitch`), zeros where row >=
// row_lim or col >= col_lim.  vec: cp.async in 16-byte pieces (src, ld and
// col_lim multiples of 8 elements, src 16-byte aligned); else element by
// element, synchronously.  Either way the caller's next __syncthreads()
// after cp_async_wait makes the tile visible.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(uint16_t* dst, int pitch,
                                          const uint16_t* src, long long ld,
                                          int row_lim, int col_lim, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int PIECES = COLS / 8;
#pragma unroll 4
    for (int i = tid; i < ROWS * PIECES; i += THREADS) {
      const int r = i / PIECES, c = (i - r * PIECES) * 8;
      uint16_t* d = dst + r * pitch + c;
      if (r < row_lim && c < col_lim)
        cp_async16(d, src + r * ld + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i - r * COLS;
      dst[r * pitch + c] =
          (r < row_lim && c < col_lim) ? src[r * ld + c] : (uint16_t)0;
    }
  }
}

}  // namespace mma_bf16
