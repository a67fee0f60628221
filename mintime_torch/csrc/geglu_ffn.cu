// GEGLU feed-forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: mintime_tpu/ops/pallas_ffn.py::_fwd_kernel (reached through
// _fwd_call and geglu_ffn). It computes
//     h    = bf16(x @ W0^T + b0)                  (fp32 accumulation)
//     prod = bf16(h[:, :H] * gelu_erf(h[:, H:]))   (gate math in fp32)
//     out  = bf16(prod @ W1^T + b1)                (fp32 accumulation)
// with W0 (2H, D) and W1 (D, H) in PyTorch's Linear layout, D a multiple of
// 64 (the models use 512 and 256) and H a multiple of 64.
//
// Bound on an H100: tensor-core operations at the token rows. At M = 6272,
// D = 512, H = 2048 one call is 2*M*(D*2H + H*D) = 39.5 GFLOP, about 40 us
// at 989 TFLOP/s; at M = 81920, D = 256, H = 1024 it is 129 GFLOP, 0.13 ms.
// At the CLS rows (M = 8) it is bytes: W0 and W1 once (6.3 MB at D = 512,
// 1.9 us at 3.35 TB/s).
//
// Design: two launches on csrc/gemm_wgmma.cuh's warpgroup products (a
// TMA ring of 128-byte-swizzled tiles, one producer warp and two
// consumer warpgroups, a block's tile 128 rows), plus an ordered reduce when
// the output tiles are too few for the card:
//   A. geglu_ffn_up_kernel: a block owns a row tile and `up` hidden columns; its B
//      tile is W0's rows [h0, h0 + up) (val) and [H + h0, H + h0 + up)
//      (gate), one 3-D box of W0 seen as (2, H, D), so val column c and
//      gate column c sit in the same tile. The epilogue adds b0, rounds to
//      bf16, runs the exact GELU gate in fp32 and writes prod (M, H) in bf16
//      with 16-byte stores.
//   B. geglu_ffn_down_kernel: out = prod W1^T + b1 in tiles of `down` output
//      columns; with S > 1 slices of k = H each block writes fp32 partials,
//   C. geglu_ffn_down_reduce_kernel: which are summed in slice order with b1
//      (no atomics: reruns give the same bits).
// ops/geglu_ffn.py::fwd_plan picks `up`, `down` and the slices so that each
// launch has at least a block per SM: wide tiles (64 hidden columns, 128
// output columns) at the token rows, narrow ones and split slices at a few
// rows. The TPU kernel fused the two products so that the (M, 2H)
// intermediate stayed in VMEM; here prod makes one round trip through device
// memory: 25.7 MB at D = 512, M = 6272 (about 15 us at 3.35 TB/s, and it
// fits the 50 MB L2), 168 MB at D = 256, M = 81920 (about 0.1 ms). Keeping
// it on chip needs a (128-row, D) fp32 accumulator a block, later work.
// Rows past M are read as zeros by the copies and never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_wgmma.cuh"

typedef __nv_bfloat16 bf16;
using gemm_wgmma::BK;
using gemm_wgmma::BM;
using gemm_wgmma::THREADS;

namespace {

constexpr int PRODUCER = gemm_wgmma::CONSUMERS * 128;  // first thread of the producer warp

// stages of the ring by tile width: two blocks an SM either way
template <int N>
struct Tile {
  static constexpr int STAGES = N >= 128 ? 3 : 6;
  using Ring = gemm_wgmma::Ring<N, STAGES>;
  static constexpr int LD = N + 8;  // fp32 row of the staged accumulators
  static_assert(size_t(BM) * LD * 4 <= size_t(STAGES) * Ring::STAGE_BYTES,
                "the staged tile fits in the ring");
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// V = 4 or 8 consecutive bf16 at p (8 V-byte aligned) as floats, in one load
template <int V>
__device__ __forceinline__ void load_bf16(float (&f)[V], const bf16* p) {
  using Vec = typename std::conditional<V == 8, uint4, uint2>::type;
  const Vec u = *reinterpret_cast<const Vec*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Every consumer writes its accumulators into the fp32 tile st [BM][LD],
// which overlays the ring: first every warpgroup's products must be done.
template <int N>
__device__ __forceinline__ void stage_acc(float* st, const float (&acc)[N / 2]) {
  gemm_wgmma::consumers_sync();
#pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    *reinterpret_cast<float2*>(st + gemm_wgmma::acc_row(i) * Tile<N>::LD + gemm_wgmma::acc_col(i)) =
        make_float2(acc[i], acc[i + 1]);
  gemm_wgmma::consumers_sync();
}

// Launch A. Grid (H / (N / 2), ceil(M / 128)).
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
geglu_ffn_up_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w0_map, const bf16* __restrict__ b0,
                    bf16* __restrict__ prod, int M, int D, int hidden) {
  constexpr int UP = N / 2;  // hidden columns of the block, val and gate each
  extern __shared__ uint8_t smem[];
  __shared__ uint64_t full[Tile<N>::STAGES], empty[Tile<N>::STAGES];
  typename Tile<N>::Ring ring;
  ring.init(smem, full, empty);
  const int h0 = blockIdx.x * UP;
  const int row0 = blockIdx.y * BM;
  const int nk = D / BK;

  if (threadIdx.x >= PRODUCER) {
    const CUtensorMap* xm = &x_map;
    const CUtensorMap* wm = &w0_map;
    if (threadIdx.x == PRODUCER)
      ring.produce(nk, [&](int s, int kt) {
        gemm_wgmma::tma_load_2d(ring.a(s), xm, kt * BK, row0, &ring.full[s]);
        gemm_wgmma::tma_load_3d(ring.b(s), wm, kt * BK, h0, 0, &ring.full[s]);
      });
    return;
  }
  float acc[N / 2];
  ring.consume(nk, row0 + (threadIdx.x / 128) * 64 < M, acc);
  float* st = reinterpret_cast<float*>(ring.base);
  stage_acc<N>(st, acc);

  // bias, bf16 rounding, exact GELU gate, bf16 product: V columns of a row
  // a thread, always the same columns, so their biases load once
  constexpr int V = UP < 8 ? UP : 8;
  constexpr int GROUPS = UP / V;
  static_assert(PRODUCER % GROUPS == 0, "a thread keeps its columns from row to row");
  constexpr int LD = Tile<N>::LD;
  const int c = (threadIdx.x % GROUPS) * V;
  float bv[V], bg[V];
  load_bf16<V>(bv, b0 + h0 + c);
  load_bf16<V>(bg, b0 + hidden + h0 + c);
  for (int r = threadIdx.x / GROUPS; r < BM && row0 + r < M; r += PRODUCER / GROUPS) {
    float hv[2 * V];  // val columns c .. c + V - 1, then their gate columns
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      *reinterpret_cast<float4*>(hv + j) = *reinterpret_cast<const float4*>(st + r * LD + c + j);
      *reinterpret_cast<float4*>(hv + V + j) =
          *reinterpret_cast<const float4*>(st + r * LD + UP + c + j);
    }
    __align__(16) bf16 p[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float val = bf16_round(hv[j] + bv[j]);
      const float gate = bf16_round(hv[V + j] + bg[j]);
      p[j] = __float2bfloat16(val * (0.5f * gate * (1.0f + erff(gate * 0.70710678118654752f))));
    }
    bf16* dst = prod + size_t(row0 + r) * hidden + h0 + c;
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(p);
  }
}

// Launch B. Grid (D / N, ceil(M / 128), S); slice z covers k = H in
// [z * kchunk, min(H, (z + 1) * kchunk)). With S = 1 it writes out (bf16,
// + b1), else its fp32 partial to part + z * M * D.
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
geglu_ffn_down_kernel(const __grid_constant__ CUtensorMap prod_map,
                const __grid_constant__ CUtensorMap w1_map, const bf16* __restrict__ b1,
                bf16* __restrict__ out, float* __restrict__ part, int M, int D, int hidden,
                int kchunk) {
  extern __shared__ uint8_t smem[];
  __shared__ uint64_t full[Tile<N>::STAGES], empty[Tile<N>::STAGES];
  typename Tile<N>::Ring ring;
  ring.init(smem, full, empty);
  const int n0 = blockIdx.x * N;
  const int row0 = blockIdx.y * BM;
  const int kb = blockIdx.z * kchunk;
  const int nk = (min(hidden, kb + kchunk) - kb) / BK;

  if (threadIdx.x >= PRODUCER) {
    const CUtensorMap* pm = &prod_map;
    const CUtensorMap* wm = &w1_map;
    if (threadIdx.x == PRODUCER)
      ring.produce(nk, [&](int s, int kt) {
        gemm_wgmma::tma_load_2d(ring.a(s), pm, kb + kt * BK, row0, &ring.full[s]);
        gemm_wgmma::tma_load_2d(ring.b(s), wm, kb + kt * BK, n0, &ring.full[s]);
      });
    return;
  }
  float acc[N / 2];
  ring.consume(nk, row0 + (threadIdx.x / 128) * 64 < M, acc);
  float* st = reinterpret_cast<float*>(ring.base);
  stage_acc<N>(st, acc);

  // 8 columns of a row a thread, always the same columns: 16 bytes of bf16
  // out, or 32 of fp32 partials
  constexpr int GROUPS = N / 8;
  static_assert(PRODUCER % GROUPS == 0, "a thread keeps its columns from row to row");
  constexpr int LD = Tile<N>::LD;
  float* dst_part = gridDim.z > 1 ? part + size_t(blockIdx.z) * M * D : nullptr;
  const int c = (threadIdx.x % GROUPS) * 8;
  float bias[8];
  load_bf16<8>(bias, b1 + n0 + c);
  for (int r = threadIdx.x / GROUPS; r < BM && row0 + r < M; r += PRODUCER / GROUPS) {
    const float4 lo = *reinterpret_cast<const float4*>(st + r * LD + c);
    const float4 hi = *reinterpret_cast<const float4*>(st + r * LD + c + 4);
    const size_t at = size_t(row0 + r) * D + n0 + c;
    if (dst_part != nullptr) {
      *reinterpret_cast<float4*>(dst_part + at) = lo;
      *reinterpret_cast<float4*>(dst_part + at + 4) = hi;
    } else {
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      __align__(16) bf16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(v[j] + bias[j]);
      *reinterpret_cast<uint4*>(out + at) = *reinterpret_cast<const uint4*>(o);
    }
  }
}

// out = bf16(b1 + the S partials summed in slice order), one thread an element
__global__ void __launch_bounds__(256)
geglu_ffn_down_reduce_kernel(const float* __restrict__ part, const bf16* __restrict__ b1,
                       bf16* __restrict__ out, int M, int D, int slices) {
  const size_t n = size_t(M) * D;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < slices; ++s) a += part[s * n + i];
    out[i] = __float2bfloat16(a + __bfloat162float(b1[i % D]));
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <int N>
int launch_up(const CUtensorMap& xm, const CUtensorMap& wm, const bf16* b0, bf16* prod, int M,
              int D, int hidden, cudaStream_t s) {
  constexpr size_t smem = Tile<N>::Ring::SMEM_BYTES;
  cudaError_t err = allow_smem(geglu_ffn_up_kernel<N>, smem);
  if (err != cudaSuccess) return int(err);
  geglu_ffn_up_kernel<N><<<dim3(hidden / (N / 2), (M + BM - 1) / BM), THREADS, smem, s>>>(
      xm, wm, b0, prod, M, D, hidden);
  return int(cudaGetLastError());
}

template <int N>
int launch_down(const CUtensorMap& pm, const CUtensorMap& wm, const bf16* b1, bf16* out,
                float* part, int M, int D, int hidden, int slices, int kchunk, cudaStream_t s) {
  constexpr size_t smem = Tile<N>::Ring::SMEM_BYTES;
  cudaError_t err = allow_smem(geglu_ffn_down_kernel<N>, smem);
  if (err != cudaSuccess) return int(err);
  geglu_ffn_down_kernel<N><<<dim3(D / N, (M + BM - 1) / BM, slices), THREADS, smem, s>>>(
      pm, wm, b1, out, part, M, D, hidden, kchunk);
  return int(cudaGetLastError());
}

}  // namespace

// The plan of ops/geglu_ffn.py::fwd_plan: `up` hidden columns a launch-A
// block (64, 8 or 4), `down` output columns a launch-B block (128 or 16),
// `slices` of k = H of `kchunk` each (a multiple of 64). Scratch from the
// caller: prod (M, H) bf16 and, with slices > 1, partial (slices, M, D) fp32.
// Every pointer 16-byte aligned. Returns a cudaError_t; cudaErrorNotSupported
// if libcuda cannot describe the operands to TMA.
extern "C" int geglu_ffn_fwd(const void* x, const void* w0, const void* b0, const void* w1,
                             const void* b1, void* out, void* prod, void* partial, int M,
                             int dim, int hidden, int up, int down, int slices, int kchunk,
                             void* stream) {
  if (M <= 0 || dim <= 0 || dim % BK != 0 || hidden <= 0 || hidden % BK != 0 ||
      (up != 64 && up != 8 && up != 4) || (down != 128 && down != 16) || dim % down != 0 ||
      slices < 1 || kchunk <= 0 || kchunk % BK != 0 ||
      size_t(slices - 1) * kchunk >= size_t(hidden) || size_t(slices) * kchunk < size_t(hidden) ||
      (slices > 1) != (partial != nullptr) || prod == nullptr)
    return int(cudaErrorInvalidValue);
  using gemm_wgmma::bf16_map;
  // x (M, D) and prod (M, H) in boxes of 128 rows x 64 k; W0 seen as (2, H,
  // D) in boxes of 2 x up rows x 64 k (val rows, then gate rows); W1 (D, H)
  // in boxes of `down` rows x 64 k
  CUtensorMap xm, w0m, pm, w1m;
  const cuuint64_t x_dims[2] = {cuuint64_t(dim), cuuint64_t(M)};
  const cuuint64_t x_strides[1] = {cuuint64_t(dim) * 2};
  const cuuint32_t rows_box[2] = {BK, BM};
  const cuuint64_t w0_dims[3] = {cuuint64_t(dim), cuuint64_t(hidden), 2};
  const cuuint64_t w0_strides[2] = {cuuint64_t(dim) * 2, cuuint64_t(hidden) * dim * 2};
  const cuuint32_t w0_box[3] = {BK, cuuint32_t(up), 2};
  const cuuint64_t p_dims[2] = {cuuint64_t(hidden), cuuint64_t(M)};
  const cuuint64_t h_strides[1] = {cuuint64_t(hidden) * 2};
  const cuuint64_t w1_dims[2] = {cuuint64_t(hidden), cuuint64_t(dim)};
  const cuuint32_t w1_box[2] = {BK, cuuint32_t(down)};
  if (!bf16_map(&xm, x, 2, x_dims, x_strides, rows_box) ||
      !bf16_map(&w0m, w0, 3, w0_dims, w0_strides, w0_box) ||
      !bf16_map(&pm, prod, 2, p_dims, h_strides, rows_box) ||
      !bf16_map(&w1m, w1, 2, w1_dims, h_strides, w1_box))
    return int(cudaErrorNotSupported);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* b0b = static_cast<const bf16*>(b0);
  const bf16* b1b = static_cast<const bf16*>(b1);
  bf16* prodb = static_cast<bf16*>(prod);
  bf16* outb = static_cast<bf16*>(out);
  float* part = static_cast<float*>(partial);
  int err = up == 64  ? launch_up<128>(xm, w0m, b0b, prodb, M, dim, hidden, s)
            : up == 8 ? launch_up<16>(xm, w0m, b0b, prodb, M, dim, hidden, s)
                      : launch_up<8>(xm, w0m, b0b, prodb, M, dim, hidden, s);
  if (err != 0) return err;
  err = down == 128 ? launch_down<128>(pm, w1m, b1b, outb, part, M, dim, hidden, slices, kchunk, s)
                    : launch_down<16>(pm, w1m, b1b, outb, part, M, dim, hidden, slices, kchunk, s);
  if (err != 0 || slices == 1) return err;
  const size_t wanted = (size_t(M) * dim + 255) / 256;
  geglu_ffn_down_reduce_kernel<<<unsigned(wanted < 1024 ? wanted : 1024), 256, 0, s>>>(
      part, b1b, outb, M, dim, slices);
  return int(cudaGetLastError());
}
