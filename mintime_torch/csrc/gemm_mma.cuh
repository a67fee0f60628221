// Tensor-core product tiles for Hopper (sm_90a): bf16 operands staged into
// shared memory by 16-byte cp.async with XOR-swizzled rows, fragments by
// ldmatrix (.trans where the operand's contiguous axis is not k), mma.sync
// m16n8k16 with fp32 accumulators (csrc/warp_mma.cuh).
//
// Two tile layouts, both 32 deep in k (BK):
//   "kc" [rows][32]: k contiguous, 64-byte rows of four 16-byte chunks; chunk
//        c of row r sits at c ^ ((r >> 1) & 3), so the eight rows an ldmatrix
//        reads fall on distinct banks;
//   "rc" [32][cols]: rows or columns contiguous (cols = 64 or 128), chunk c of
//        k-row r at c ^ (r & 7).
// A row-major A (m, k) or a B given as (n, k) takes "kc"; a column-major A
// (A[k][m]) or a row-major B (B[k][n]) takes "rc".
//
// gemm_tile() is the core: one block of 8 warps (2 along m x 4 along n, a
// warp 64 x 32) accumulates a 128 x 128 output tile over k in [kb, ke)
// through a ring of STAGES stages, keeping STAGES - 1 stages of copies in
// flight while the tensor cores work on the oldest. Rows, columns and k past
// the operands' ends are zero-filled, so any k range and ragged edges work;
// the contiguous axes must be whole 16-byte chunks (multiples of 8).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace gemm_mma {

typedef __nv_bfloat16 bf16;

constexpr int BK = 32;
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;  // blocks an SM, for the register budget
constexpr int STAGES = 4;
constexpr int WM = 64;  // warp tile rows
constexpr int WN = 32;  // warp tile columns
constexpr int MT = WM / 16;
constexpr int NT = WN / 8;
constexpr int A_ELEMS = BM * BK;  // one stage of A
constexpr int B_ELEMS = BN * BK;  // one stage of B
constexpr size_t SMEM_BYTES = size_t(STAGES) * (A_ELEMS + B_ELEMS) * sizeof(bf16);

__device__ __forceinline__ int kc_off(int r, int c) { return r * BK + ((c ^ ((r >> 1) & 3)) << 3); }

__device__ __forceinline__ int rc_off(int r, int c, int cols) {
  return r * cols + ((c ^ (r & 7)) << 3);
}

// rows [row0, row0 + rows) x k [k0, k0 + 32) of g (g[row * ld + k]) into a
// "kc" tile; zeros past nrows or ke
__device__ __forceinline__ void stage_kc(bf16* tile, const bf16* g, int ld, int row0, int rows,
                                         int nrows, int k0, int ke, int tid, int nthreads) {
  for (int i = tid; i < rows * 4; i += nthreads) {
    const int r = i >> 2;
    const int c = i & 3;
    const bool live = row0 + r < nrows && k0 + 8 * c < ke;
    warp_mma::cp_async16_zfill(tile + kc_off(r, c),
                               live ? g + size_t(row0 + r) * ld + k0 + 8 * c : g, live ? 16 : 0);
  }
}

// k [k0, k0 + 32) x columns [col0, col0 + cols) of g (g[k * ld + col]) into
// an "rc" tile; zeros past ke or ncols
__device__ __forceinline__ void stage_rc(bf16* tile, const bf16* g, int ld, int k0, int ke,
                                         int col0, int cols, int ncols, int tid, int nthreads) {
  const int cpr = cols >> 3;
  for (int i = tid; i < BK * cpr; i += nthreads) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    const bool live = k0 + r < ke && col0 + 8 * c < ncols;
    warp_mma::cp_async16_zfill(tile + rc_off(r, c, cols),
                               live ? g + size_t(k0 + r) * ld + col0 + 8 * c : g, live ? 16 : 0);
  }
}

// A fragment (rows m0 .. m0 + 15, k kk .. kk + 15) of a "kc" tile
__device__ __forceinline__ void frag_a_kc(uint32_t a[4], const bf16* tile, int m0, int kk,
                                          int lane) {
  const int i = lane >> 3;
  warp_mma::ldmatrix_x4(a, tile + kc_off(m0 + (lane & 7) + ((i & 1) << 3), (kk >> 3) + (i >> 1)));
}

// A fragment of an "rc" tile holding A[k][m]
__device__ __forceinline__ void frag_a_rc(uint32_t a[4], const bf16* tile, int m0, int kk,
                                          int cols, int lane) {
  const int i = lane >> 3;
  warp_mma::ldmatrix_x4_trans(
      a, tile + rc_off(kk + (lane & 7) + ((i >> 1) << 3), (m0 >> 3) + (i & 1), cols));
}

// B fragments of two n8 tiles (n0 .. n0 + 15) of an "rc" tile holding B[k][n]:
// b[0], b[1] for columns n0 .. n0 + 7, b[2], b[3] for n0 + 8 .. n0 + 15
__device__ __forceinline__ void frag_b_rc(uint32_t b[4], const bf16* tile, int n0, int kk,
                                          int cols, int lane) {
  const int i = lane >> 3;
  warp_mma::ldmatrix_x4_trans(
      b, tile + rc_off(kk + (lane & 7) + ((i & 1) << 3), (n0 >> 3) + (i >> 1), cols));
}

// the same from a "kc" tile holding B as (n, k)
__device__ __forceinline__ void frag_b_kc(uint32_t b[4], const bf16* tile, int n0, int kk,
                                          int lane) {
  const int i = lane >> 3;
  warp_mma::ldmatrix_x4(b, tile + kc_off(n0 + (lane & 7) + ((i >> 1) << 3), (kk >> 3) + (i & 1)));
}

// One product operand pair: A (m, k) row-major (a_col false: A[m * lda + k])
// or column-major (a_col true: A[k * lda + m]), B row-major (B[k * ldb + n]).
struct Operands {
  const bf16* A;
  int lda;
  bool a_col;
  const bf16* B;
  int ldb;
  int M, N;
};

// Accumulate the 128 x 128 tile at (m0, n0) of A @ B over k in [kb, ke) into
// acc (zeroed here). smem: SMEM_BYTES, 16-byte aligned. All 256 threads call
// it; on return no copy is in flight and smem may be reused after a
// __syncthreads().
__device__ __forceinline__ void gemm_tile(const Operands& op, int m0, int n0, int kb, int ke,
                                          bf16* smem, float acc[MT][NT][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp >> 2) * WM;
  const int wn0 = (warp & 3) * WN;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto stage = [&](int slot, int k0) {
    bf16* a = smem + slot * (A_ELEMS + B_ELEMS);
    bf16* b = a + A_ELEMS;
    if (op.a_col)
      stage_rc(a, op.A, op.lda, k0, ke, m0, BM, op.M, tid, THREADS);
    else
      stage_kc(a, op.A, op.lda, m0, BM, op.M, k0, ke, tid, THREADS);
    stage_rc(b, op.B, op.ldb, k0, ke, n0, BN, op.N, tid, THREADS);
  };

  const int nk = (ke - kb + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage(s, kb + s * BK);
    warp_mma::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    warp_mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    if (kt + STAGES - 1 < nk) stage((kt + STAGES - 1) % STAGES, kb + (kt + STAGES - 1) * BK);
    warp_mma::cp_async_commit();
    const bf16* a = smem + (kt % STAGES) * (A_ELEMS + B_ELEMS);
    const bf16* b = a + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // every fragment of the 16-deep step first, then the products, so the
      // loads' latency is paid once a step and not before each row tile
      uint32_t af[MT][4], bf[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) frag_b_rc(bf[j], b, wn0 + 16 * j, kk, BN, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (op.a_col)
          frag_a_rc(af[i], a, wm0 + 16 * i, kk, BM, lane);
        else
          frag_a_kc(af[i], a, wm0 + 16 * i, kk, lane);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          warp_mma::mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  warp_mma::cp_async_wait<0>();
}

// Where acc[i][j][e] lands in the tile: row and column within the 128 x 128
__device__ __forceinline__ int acc_row(int i, int e) {
  return ((threadIdx.x >> 5) >> 2) * WM + 16 * i + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int j) {
  return ((threadIdx.x >> 5) & 3) * WN + 8 * j + 2 * (threadIdx.x & 3);
}

}  // namespace gemm_mma
