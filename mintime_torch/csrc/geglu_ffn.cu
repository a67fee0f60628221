// Fused GEGLU feed-forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: mintime_tpu/ops/pallas_ffn.py::_fwd_kernel (reached through
// _fwd_call and geglu_ffn). It computes
//     h    = bf16(x @ W0^T + b0)                  (fp32 accumulation)
//     prod = bf16(h[:, :H] * gelu_erf(h[:, H:]))   (gate math in fp32)
//     out  = bf16(prod @ W1^T + b1)                (fp32 accumulation)
// with W0 (2H, D) and W1 (D, H) in PyTorch's Linear layout. The model width
// D is a template parameter, instantiated for 512 (the Size-Invariant
// TimeSformer) and 256 (the Convolutional TimeSformer).
//
// Bound on an H100: tensor-core operations. At M = 6272 rows, D = 512,
// H = 2048 one call is 2*M*(D*2H + H*D) = 39.5 GFLOP, about 40 us at
// 989 TFLOP/s; its bytes (x, out, W0, W1 once) are about 19 MB, about 6 us
// at 3.35 TB/s. At M = 81920, D = 256, H = 1024 it is 129 GFLOP, 0.13 ms.
//
// Design: one block of 8 warps per 32-row tile keeps the whole (32, D)
// fp32 output in WMMA accumulator fragments (D / 8 registers a thread). It walks
// the hidden width in chunks of 64: the val and gate columns of a chunk come
// from the x tile held in shared memory, the bias, bf16 rounding and exact
// GELU run in fp32 in shared memory, and the bf16 product feeds the
// down-projection straight into the accumulators. The (M, 2H) intermediate
// never reaches device memory, which is what the TPU kernel bought too. The
// ragged last tile is masked (zero rows in, no rows out) instead of padded.
// When the row tiles are too few to fill the card (the CLS rows: M = batch),
// the grid's second axis splits the hidden width: each block writes its fp32
// partial sum to a scratch buffer and a second launch adds the partials, the
// bias and rounds, so a call of 8 rows uses 32 SMs instead of one.
// The weight fragments are read from L2 by every block; making the operand
// loads asynchronous (TMA, wgmma) is the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;         // rows per block
constexpr int HC = 64;         // hidden columns per chunk (val and gate each)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RT = BM / 16;            // row tiles per block
constexpr int HS_LD = 2 * HC + 4;      // fp32
constexpr int PS_LD = HC + 8;          // bf16
constexpr size_t HS_BYTES = size_t(BM) * HS_LD * 4;
constexpr size_t PS_BYTES = size_t(BM) * PS_LD * 2;
constexpr size_t ST_BYTES = size_t(WARPS) * 256 * 4;

static_assert(2 * HC / 16 == WARPS, "one up-projection column tile per warp");

// the constants that follow the model width D
template <int D>
struct Width {
  static_assert(D % (16 * WARPS) == 0, "whole output column tiles for every warp");
  static constexpr int OT = D / 16 / WARPS;  // output column tiles per warp
  static constexpr int XS_LD = D + 8;        // bf16, padded against bank conflicts
  static constexpr size_t XS_BYTES = size_t(BM) * XS_LD * 2;
  static constexpr size_t SMEM_BYTES = XS_BYTES + HS_BYTES + PS_BYTES + ST_BYTES;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
geglu_ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                 const bf16* __restrict__ b0, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, bf16* __restrict__ out,
                 float* __restrict__ partial, int M, int hidden) {
  constexpr int OT = Width<D>::OT;
  constexpr int XS_LD = Width<D>::XS_LD;
  constexpr size_t XS_BYTES = Width<D>::XS_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* hs = reinterpret_cast<float*>(smem + XS_BYTES);
  bf16* ps = reinterpret_cast<bf16*>(smem + XS_BYTES + HS_BYTES);
  float* stage = reinterpret_cast<float*>(smem + XS_BYTES + HS_BYTES + PS_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * BM;
  // this block's share of the hidden width, in whole chunks
  const int chunks = hidden / HC;
  const int h_begin = int(blockIdx.y) * chunks / int(gridDim.y) * HC;
  const int h_end = (int(blockIdx.y) + 1) * chunks / int(gridDim.y) * HC;

  // x tile into shared memory, 16 bytes a thread; rows past M are zero
  for (int i = tid; i < BM * (D / 8); i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < M) v = *reinterpret_cast<const uint4*>(x + size_t(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = v;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][OT];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int t = 0; t < OT; ++t) wmma::fill_fragment(acc[rt][t], 0.0f);
  __syncthreads();

  for (int h0 = h_begin; h0 < h_end; h0 += HC) {
    // up-projection: warp w owns column tile w of [val chunk | gate chunk]
    {
      const int n0 = warp < WARPS / 2 ? h0 + warp * 16 : hidden + h0 + (warp - WARPS / 2) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(hacc[rt], 0.0f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag;
        wmma::load_matrix_sync(bfrag, w0 + size_t(n0) * D + k, D);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, xs + rt * 16 * XS_LD + k, XS_LD);
          wmma::mma_sync(hacc[rt], afrag, bfrag, hacc[rt]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
        wmma::store_matrix_sync(hs + rt * 16 * HS_LD + warp * 16, hacc[rt], HS_LD,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // bias, bf16 rounding, exact GELU gate, bf16 product
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC;
      const int c = i % HC;
      const float val = bf16_round(hs[r * HS_LD + c] + __bfloat162float(b0[h0 + c]));
      const float gate =
          bf16_round(hs[r * HS_LD + HC + c] + __bfloat162float(b0[hidden + h0 + c]));
      const float g = 0.5f * gate * (1.0f + erff(gate * 0.70710678118654752f));
      ps[r * PS_LD + c] = __float2bfloat16(val * g);
    }
    __syncthreads();

    // down-projection of the chunk into the (BM, D) accumulators
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
        wmma::load_matrix_sync(afrag[rt], ps + rt * 16 * PS_LD + kk, PS_LD);
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        const int n0 = (warp * OT + t) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag;
        wmma::load_matrix_sync(bfrag, w1 + size_t(n0) * hidden + h0 + kk, hidden);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) wmma::mma_sync(acc[rt][t], afrag[rt], bfrag, acc[rt][t]);
      }
    }
    // no barrier needed here: the next chunk rewrites hs (last read before
    // the barrier above) and writes ps only after its own first barrier
  }

  // epilogue: + b1, bf16, masked store of the valid rows; with a split
  // hidden width, the fp32 partial sum of the valid rows instead
  float* st = stage + warp * 256;
  float* part = partial == nullptr ? nullptr : partial + size_t(blockIdx.y) * M * D;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      wmma::store_matrix_sync(st, acc[rt][t], 16, wmma::mem_row_major);
      __syncwarp();
      const int n0 = (warp * OT + t) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16;
        const int c = e % 16;
        const int row = row0 + rt * 16 + r;
        if (row >= M) continue;
        if (part != nullptr)
          part[size_t(row) * D + n0 + c] = st[e];
        else
          out[size_t(row) * D + n0 + c] = __float2bfloat16(st[e] + __bfloat162float(b1[n0 + c]));
      }
      __syncwarp();
    }
  }
}

// out = bf16(sum over the splits of partial + b1), one thread an element
__global__ void geglu_split_reduce_kernel(const float* __restrict__ partial,
                                          const bf16* __restrict__ b1, bf16* __restrict__ out,
                                          int M, int D, int splits) {
  const size_t n = size_t(M) * D;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < splits; ++s) a += partial[s * n + i];
    out[i] = __float2bfloat16(a + __bfloat162float(b1[i % D]));
  }
}

template <int D>
int launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
           void* out, void* partial, int M, int hidden, int splits, cudaStream_t s) {
  constexpr size_t smem = Width<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      geglu_ffn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((M + BM - 1) / BM, splits);
  geglu_ffn_kernel<D><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w0), static_cast<const bf16*>(b0),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1), static_cast<bf16*>(out),
      static_cast<float*>(partial), M, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  const int threads = 256;
  const size_t wanted = (size_t(M) * D + threads - 1) / threads;
  const int blocks = wanted < 1024 ? int(wanted) : 1024;
  geglu_split_reduce_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const bf16*>(b1), static_cast<bf16*>(out),
      M, D, splits);
  return int(cudaGetLastError());
}

}  // namespace

// dim: the model width, 512 or 256. splits: how many blocks share the hidden
// width of a row tile; with splits > 1, partial is fp32 scratch of
// splits * M * dim elements.
extern "C" int geglu_ffn_fwd(const void* x, const void* w0, const void* b0, const void* w1,
                             const void* b1, void* out, void* partial, int M, int dim,
                             int hidden, int splits, void* stream) {
  if (hidden <= 0 || hidden % HC != 0 || M <= 0 || splits < 1 || splits > hidden / HC ||
      (splits > 1) != (partial != nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 512) return launch<512>(x, w0, b0, w1, b1, out, partial, M, hidden, splits, s);
  if (dim == 256) return launch<256>(x, w0, b0, w1, b1, out, partial, M, hidden, splits, s);
  return int(cudaErrorInvalidValue);
}
