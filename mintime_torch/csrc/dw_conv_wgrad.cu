// Weight gradient of the depthwise convolution (stride 1, SAME padding) for
// Hopper (sm_90a): bf16 NHWC x and dy in, fp32 (K, K, 1, C) out.
//
// Replaces: experiments/dw_conv_bwd_pallas_vs_xla.py::_flat_kernel,
// ::_chan_kernel and ::_roll_kernel (reached through pl_flat_wgrad,
// pl_chan_wgrad and pl_roll_wgrad). The three compute one function in three
// TPU lane layouts,
//   dW[kh, kw, 0, c] = sum_{n, oh, ow} x_pad[n, oh+kh, ow+kw, c] * dy[n, oh, ow, c]
// with x_pad the input with K/2 zeros around H and W, for K = 3 and 5.
// (_roll_kernel returns it with its taps flipped, a fault of that probe;
// this kernel computes the gradient itself.)
//
// Bound on an H100: memory. It reads x and dy once and writes K*K*C floats:
// at the probe's 512 images of 112 x 112 x 32 that is 822 MB, 0.245 ms at
// 3.35 TB/s; its 2*K*K*N*H*W*C fp32 operations take 0.055 ms at the CUDA
// cores' 67 TFLOP/s.
//
// Design: a streaming reduction. The TPU kernels carried the sum from one
// sequential grid step to the next in their output block; here blocks run
// in parallel, so each owns (a slice of the N*H output rows, a tile of up
// to 64 channels) and writes its fp32 partial sums to (chunks, K, K, C); a
// second launch adds the chunks in order. No atomics, so a rerun gives the
// same bits. A block walks its rows keeping the K input rows that the
// current output row needs in a ring in shared memory (one new row a step,
// zeros outside the image), with the dy row beside them, so x and dy are
// each read from device memory about once. A thread owns one channel pair
// and a strided set of output columns and keeps its pair's K*K sums in
// registers; at the end the block adds its threads' sums in a fixed order.
// The number of chunks is picked from the shape alone (about eight blocks an
// SM), so the order of the sums is fixed for a shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int THREADS = 256;
constexpr int CT = 64;                   // channels of a block's tile
constexpr int SMEM_BYTES = 48 * 1024;
constexpr int TARGET_BLOCKS = 8 * 132;   // about eight blocks for each of the H100's SMs

int tile_channels(int C) { return C >= CT ? CT : (C + 1) / 2 * 2; }

size_t smem_bytes(int W, int K, int ct) {
  const size_t ring = size_t(K) * (W + K - 1) * ct * sizeof(bf16);
  const size_t dyrow = size_t(W) * ct * sizeof(bf16);
  return (ring + dyrow + 15) / 16 * 16 + THREADS * sizeof(float2);
}

__device__ __forceinline__ float2 load_pair(const bf16* p, int c, int C, bool even) {
  if (even) return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
  return make_float2(c < C ? __bfloat162float(p[0]) : 0.0f,
                     c + 1 < C ? __bfloat162float(p[1]) : 0.0f);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     float* __restrict__ partial, int N, int H, int W, int C, int ct,
                     int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAD = K / 2;
  const int WP = W + K - 1;
  const int NP = ct / 2;             // channel pairs of the tile
  bf162* ring = reinterpret_cast<bf162*>(smem);       // [K][WP][NP]
  bf162* dys = ring + K * WP * NP;                    // [W][NP]
  float2* red = reinterpret_cast<float2*>(
      smem + (size_t(K * WP + W) * NP * sizeof(bf162) + 15) / 16 * 16);  // [THREADS]
  const int chunk = blockIdx.x;
  const int c0 = blockIdx.y * ct;
  const int PIX = THREADS / NP;      // column lanes
  const int tid = threadIdx.x;
  const int pp = tid % NP;
  const int lane_col = tid / NP;
  const int c = c0 + 2 * pp;
  const bool even = C % 2 == 0;
  const bool active = lane_col < PIX && c < C;
  const size_t row_stride = size_t(W) * C;
  const i64 rows = i64(N) * H;
  const i64 r0 = rows * chunk / chunks;
  const i64 r1 = rows * (chunk + 1) / chunks;

  float2 acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = make_float2(0.0f, 0.0f);

  for (i64 r = r0; r < r1; ++r) {
    const int n = int(r / H);
    const int oh = int(r % H);
    const int first = (r == r0 || oh == 0) ? oh - PAD : oh + PAD;  // input rows not in the ring
    const int nload = oh + PAD - first + 1;
    __syncthreads();  // the previous row's reads of the ring slot and dys are done
    for (int i = tid; i < (nload * WP + W) * NP; i += THREADS) {
      const int p = i % NP;
      const int cc = c0 + 2 * p;
      float2 v = make_float2(0.0f, 0.0f);
      if (i < nload * WP * NP) {  // an input row of the ring, with its halo
        const int col = i / NP % WP;
        const int ih = first + i / NP / WP;
        const int iw = col - PAD;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W && cc < C)
          v = load_pair(x + (size_t(n) * H + ih) * row_stride + size_t(iw) * C + cc, cc, C, even);
        ring[(((ih + K) % K) * WP + col) * NP + p] = __floats2bfloat162_rn(v.x, v.y);
      } else {  // the dy row
        const int col = (i - nload * WP * NP) / NP;
        if (cc < C)
          v = load_pair(dy + (size_t(n) * H + oh) * row_stride + size_t(col) * C + cc, cc, C, even);
        dys[col * NP + p] = __floats2bfloat162_rn(v.x, v.y);
      }
    }
    __syncthreads();
    if (active) {
      for (int col = lane_col; col < W; col += PIX) {
        const float2 g = __bfloat1622float2(dys[col * NP + pp]);
#pragma unroll
        for (int kh = 0; kh < K; ++kh) {
          const bf162* xrow = ring + ((oh - PAD + kh + K) % K) * WP * NP;
#pragma unroll
          for (int kw = 0; kw < K; ++kw) {
            const float2 v = __bfloat1622float2(xrow[(col + kw) * NP + pp]);
            acc[kh * K + kw].x = fmaf(v.x, g.x, acc[kh * K + kw].x);
            acc[kh * K + kw].y = fmaf(v.y, g.y, acc[kh * K + kw].y);
          }
        }
      }
    }
  }

  // the block's sums: column lanes of each channel pair added in order
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    __syncthreads();
    red[tid] = active ? acc[t] : make_float2(0.0f, 0.0f);
    __syncthreads();
    if (tid < NP && c0 + 2 * tid < C) {
      float2 s = make_float2(0.0f, 0.0f);
      for (int l = 0; l < PIX; ++l) {
        s.x += red[l * NP + tid].x;
        s.y += red[l * NP + tid].y;
      }
      float* o = partial + (i64(chunk) * K * K + t) * C + c0 + 2 * tid;
      o[0] = s.x;
      if (c0 + 2 * tid + 1 < C) o[1] = s.y;
    }
  }
}

// dW[i] = sum over chunks in order of partial[chunk][i], i over K*K*C
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int chunks, int kkc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kkc) return;
  float s = 0.0f;
  for (int j = 0; j < chunks; ++j) s += partial[i64(j) * kkc + i];
  out[i] = s;
}

}  // namespace

// The number of row slices (chunks) the kernel splits N*H into for this
// shape, or 0 when the kernel does not take it.
extern "C" int dw_conv_wgrad_chunks(int N, int H, int W, int C, int K) {
  if ((K != 3 && K != 5) || N < 1 || H < 1 || W < 1 || C < 1) return 0;
  const int ct = tile_channels(C);
  const int tiles = (C + ct - 1) / ct;
  if (smem_bytes(W, K, ct) > SMEM_BYTES || tiles > 65535) return 0;
  const i64 rows = i64(N) * H;
  const i64 want = (TARGET_BLOCKS + tiles - 1) / tiles;
  return int(want < rows ? want : rows);
}

// x, dy (N, H, W, C) bf16 contiguous; partial (chunks, K, K, C) fp32 scratch;
// out (K, K, 1, C) fp32. chunks from dw_conv_wgrad_chunks.
extern "C" int dw_conv_wgrad(const void* x, const void* dy, void* partial, void* out, int N,
                             int H, int W, int C, int K, int chunks, void* stream) {
  if (chunks < 1 || chunks != dw_conv_wgrad_chunks(N, H, W, C, K))
    return int(cudaErrorInvalidValue);
  const int ct = tile_channels(C);
  const dim3 grid(chunks, (C + ct - 1) / ct);
  const size_t smem = smem_bytes(W, K, ct);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* db = static_cast<const bf16*>(dy);
  float* pf = static_cast<float*>(partial);
  if (K == 3)
    wgrad_partial_kernel<3><<<grid, THREADS, smem, s>>>(xb, db, pf, N, H, W, C, ct, chunks);
  else
    wgrad_partial_kernel<5><<<grid, THREADS, smem, s>>>(xb, db, pf, N, H, W, C, ct, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int kkc = K * K * C;
  wgrad_reduce_kernel<<<(kkc + 255) / 256, 256, 0, s>>>(pf, static_cast<float*>(out), chunks, kkc);
  return int(cudaGetLastError());
}
