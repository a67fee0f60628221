// Warp-level tensor-core helpers for Hopper (sm_90a): 16-byte cp.async
// staging, ldmatrix loads and mma.sync.m16n8k16 in bf16 with fp32
// accumulators, and the bf16 hi/lo split that keeps an fp32 operand to
// about 16 bits of mantissa through two products.
//
// Fragment layouts of m16n8k16 (lane = 4 * grp + tig):
//   A (16 x 16, row-major): a[0] (row grp, cols 2tig, 2tig+1), a[1] (row grp+8,
//     same cols), a[2] (row grp, cols 2tig+8, +9), a[3] (row grp+8, cols 2tig+8, +9);
//   B (16 x 8, k x n):      b0 (k 2tig, 2tig+1; col grp), b1 (k 2tig+8, +9; col grp);
//   C (16 x 8, fp32):       c[0], c[1] (row grp, cols 2tig, 2tig+1), c[2], c[3] (row grp+8).
// Each 32-bit register holds two bf16 values, the lower column (or k) in the
// low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace warp_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

// 4-byte asynchronous copy global -> shared (both 4-byte aligned), through L1
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// the same copy reading only src_bytes (0 or 16) of gmem and zero-filling the
// rest, so a masked copy needs no branch around it
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

// close the group of copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c += a b on the tensor cores (bf16 in, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo with hi and lo in bf16, for two values at once
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// An 8 x 8 bf16 matrix held one register a lane (row lane / 4, columns
// 2 (lane % 4), +1), transposed across the warp into the same layout
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The A fragment of M^T from the A fragment of a 16 x 16 matrix M: each
// 8 x 8 quadrant transposed, the off-diagonal two swapped
__device__ __forceinline__ void transpose_a(const uint32_t a[4], uint32_t t[4]) {
  t[0] = movmatrix_t(a[0]);
  t[1] = movmatrix_t(a[2]);
  t[2] = movmatrix_t(a[1]);
  t[3] = movmatrix_t(a[3]);
}

// The A fragment (16 x 16) of two C tiles side by side (columns 0-7 and
// 8-15), split into hi and lo parts.
__device__ __forceinline__ void split_a(const float c[2][4], uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* v = c[i >> 1] + (i & 1) * 2;
    split_bf16(v[0], v[1], hi[i], lo[i]);
  }
}

}  // namespace warp_mma
