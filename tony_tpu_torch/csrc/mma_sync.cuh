// Building blocks for tensor-core kernels on sm_80+ (used here on sm_90a):
// asynchronous global->shared copies (cp.async), fragment loads from shared
// memory (ldmatrix) and the warp-wide bf16 product mma.sync.m16n8k16 with
// fp32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g in [0, 8),
// t in [0, 4)), each 32-bit register holding two bf16 values, the lower
// column in the low half:
//   A (16 x 16, row major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                           a2 = (g, 2t+8..),   a3 = (g + 8, 2t+8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16 x 8, fp32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..)
// So the C tiles of columns [16j, 16j + 8) and [16j + 8, 16j + 16), packed
// to bf16 pairs, are exactly the A fragment of k-slice j: a product's result
// feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `valid` false zero-fills the
// destination and reads nothing (src must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + ROWS) of one head into a shared bf16
// tile with row stride D + 8 (the 16-byte pad keeps ldmatrix free of bank
// conflicts), 16 bytes a thread; rows at or past n_rows are zero-filled.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t row_stride, int row0,
                                                int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * kChunks % THREADS == 0, "tile not a whole pass");
#pragma unroll
  for (int pass = 0; pass < ROWS * kChunks / THREADS; ++pass) {
    const int i = threadIdx.x + pass * THREADS;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* from =
        src + (valid ? (int64_t)(row0 + r) * row_stride + c : 0);
    cp_async_16(dst + r * (D + 8) + c, from, valid);
  }
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of every lane receives its part of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed on the way to the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A (16 x 16 bf16) * B (16 x 8 bf16), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k-slice j from the fp32 C tiles 2j and 2j + 1 of a
// product's result, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Lane offsets into a row-major [rows][ld] bf16 tile in shared memory for
// one ldmatrix_x4 over the 16 x 16 block at (row0, col0):
// - a_frag: the block as an A operand (rows = M, cols = K);
// - b_frag: the block holds B^T (rows = N, cols = K), giving the B
//   fragments of the n-tiles row0..row0+7 (r0, r1) and row0+8.. (r2, r3);
// - b_frag_trans (with ldmatrix_x4_trans): the block holds B (rows = K,
//   cols = N), giving the B fragments of the n-tiles col0..col0+7 (r0, r1)
//   and col0+8.. (r2, r3).
__device__ __forceinline__ int a_frag(int lane, int row0, int col0, int ld) {
  return (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_frag(int lane, int row0, int col0, int ld) {
  return (row0 + (lane & 7) + (lane >> 4) * 8) * ld + col0 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int b_frag_trans(int lane, int row0, int col0,
                                            int ld) {
  return (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0 +
         (lane >> 4) * 8;
}

}  // namespace tc
