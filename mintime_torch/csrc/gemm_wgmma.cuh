// Warpgroup tensor-core products for Hopper (sm_90a): wgmma.mma_async
// m64nNk16 with bf16 operands and fp32 accumulators, both operands K-major in
// 128-byte-swizzled shared memory and read through matrix descriptors, in a
// ring of stages that TMA (cp.async.bulk.tensor) fills, each copy completing
// on the stage's mbarrier.
//
// A block is one producer warp and two consumer warpgroups (THREADS = 288):
// warps 0-3 and 4-7 each own 64 rows of the block's 128-row tile, warp 8
// issues the copies from one lane. A stage holds A (128 rows x 64 k, 16 KB)
// and B (N rows x 64 k), each 128-byte row of 64 bf16 stored with its eight
// 16-byte chunks permuted, chunk c of row r at c ^ (r % 8), which is what TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B and what a descriptor of layout
// SWIZZLE_128B reads; every stage starts on a 1024-byte boundary (eight such
// rows, the pattern's period). A k16 step within the stage moves both
// descriptors' start by 32 bytes.
//
// Ring protocol: full[s] (one arrival, the producer's arrive.expect_tx, plus
// the bytes of its copies) and empty[s] (one arrival from each consumer
// warpgroup once its products on stage s are complete). Use k-th of slot s:
// consumers wait full[s] at parity (k & 1), the producer waits empty[s] at
// parity ((k - 1) & 1) before refilling it.
//
// Accumulator layout of m64nNk16 (fp32, N / 2 registers a thread): in warp w
// of the warpgroup, lane = 4 * grp + tig, register i holds row 16 w + grp +
// 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 tig + (i & 1).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm_wgmma {

constexpr int BK = 64;                       // k of a stage: one 128-byte swizzle row
constexpr int BM = 128;                      // rows of a block's tile
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int A_BYTES = BM * BK * 2;         // one stage of A

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival, announcing the bytes its copies will deliver
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// the box of `map` at coordinates (c0 innermost, c1) into dst, counted on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a K-major tile of 128-byte swizzled rows at `tile` (1024-byte
// aligned, or 32-byte steps into such a tile along k): start address >> 4,
// leading offset 1 (unused by this layout), stride 1024 bytes between groups
// of eight rows, layout SWIZZLE_128B.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return uint64_t((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a fence
// or a wait (the products write the registers asynchronously)
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N) += A (64 x 16) B (N x 16)^T from descriptors; scale-d = 1
template <int N>
struct Mma;

template <>
struct Mma<8> {
  __device__ __forceinline__ static void run(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<16> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---- the ring --------------------------------------------------------------

template <int N, int STAGES>
struct Ring {
  static_assert(N % 8 == 0 && (N * BK * 2) % 1024 == 0, "whole 1024-byte B tiles");
  static constexpr int B_BYTES = N * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the stages, and 1024 bytes to align the first
  static constexpr size_t SMEM_BYTES = size_t(STAGES) * STAGE_BYTES + 1024;

  uint8_t* base;  // stage s at base + s * STAGE_BYTES: A, then B
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ uint8_t* a(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint8_t* b(int s) const { return base + s * STAGE_BYTES + A_BYTES; }

  // thread 0 sets the barriers up; every thread of the block calls it
  __device__ __forceinline__ void init(uint8_t* smem, uint64_t* full_bars, uint64_t* empty_bars) {
    base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
    full = full_bars;
    empty = empty_bars;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMERS);
      }
      mbar_init_fence();
    }
    __syncthreads();
  }

  // The producer lane: nk stages, load(slot, kt) issuing the copies of stage
  // kt into slot (STAGE_BYTES in all, counted on full[slot]).
  template <class Load>
  __device__ __forceinline__ void produce(int nk, Load load) const {
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
      mbar_expect_tx(&full[s], STAGE_BYTES);
      load(s, kt);
    }
  }

  // A consumer warpgroup: acc (zeroed here) = its 64 rows of A times B^T over
  // nk stages. `live` false (rows past the operand's end, uniform over the
  // warpgroup) skips the products but keeps the ring's count.
  __device__ __forceinline__ void consume(int nk, bool live, float (&acc)[N / 2]) const {
    const int wg = threadIdx.x / 128;
    const bool lead = threadIdx.x % 128 == 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      if (live) {
        const uint64_t da = desc_sw128(a(s) + wg * 64 * BK * 2);
        const uint64_t db = desc_sw128(b(s));
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) Mma<N>::run(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        // the products of stage kt - 1 are done: release its slot
        wgmma_wait<1>();
        fence_acc(acc);
      }
      if (kt > 0 && lead) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (nk > 0 && lead) mbar_arrive(&empty[(nk - 1) % STAGES]);
  }
};

// Where accumulator register i of this thread lands in the block's 128-row
// tile (the warpgroup's rows included)
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x;
  return (t / 128) * 64 + ((t % 128) / 32) * 16 + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// the 256 consumer threads only (named barrier 1; the producer warp keeps out)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// ---- tensor maps (host) ----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime's entry-point
// query, so the library links nothing beyond the runtime; null if not found
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &got);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    const bool ok = err == cudaSuccess && got == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor of `rank` dimensions (dims[0] innermost and contiguous,
// strides in bytes of dims 1..rank-1) read in boxes of `box` elements,
// 128-byte swizzled (box[0] = 64), elements past the ends read as zeros.
// Returns false if libcuda refuses it.
inline bool bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank), const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace gemm_wgmma
