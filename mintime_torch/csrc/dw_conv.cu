// Depthwise convolution (stride 1, SAME padding) fused with bias and SiLU,
// for Hopper (sm_90a): bf16 NHWC in and out, fp32 weights, bias and sums.
//
// Replaces: experiments/dw_conv_pallas_vs_xla.py::dw_kernel (reached through
// pallas_dwconv). It computes, with x_pad the input with K/2 zeros around H
// and W,
//   y = sum_{kh, kw} x_pad[n, h+kh, w+kw, c] * w[kh, kw, c]   (fp32, kh outer)
//   out = bf16((y + b[c]) * sigmoid(y + b[c]))
// for K = 3 and 5, the EfficientNet-B0 depthwise layers.
//
// Bound on an H100: memory. At the probe's 512 images of 112 x 112 x 32 a
// call reads x once and writes out once (2 * 411 MB): 0.245 ms at
// 3.35 TB/s; its 2*K*K*N*H*W*C fp32 operations (3.7 GFLOP) take 0.055 ms at
// the 67 TFLOP/s of the CUDA cores.
//
// Design: the TPU kernel flattened (W, C) into its 128-wide lanes so that
// C = 32 or 144 filled them, and shifted whole rows by kw*C. On Hopper the
// natural layout is channel-innermost already: one 256-thread block owns
// (image, tile of TH output rows, tile of up to 64 channels) and stages the
// tile's TH + K - 1 input rows with their halo in shared memory (zeros
// outside the image), so each input element is read from device memory
// about (TH + K - 1) / TH times. A thread owns one channel pair (bf16x2
// loads and stores when C is even) and walks the tile's pixels, with its
// pair's K*K weights in registers; lanes of a warp read neighbouring pairs,
// so shared-memory reads are conflict-free. TH is the most rows whose halo
// tile fits 48 KB. A ragged last channel tile is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int THREADS = 256;
constexpr int CT = 64;                  // channels of a block's tile
constexpr int SMEM_BYTES = 48 * 1024;   // the halo tile's budget

// channels of a tile: all of C (rounded up to a pair) when C <= CT
int tile_channels(int C) { return C >= CT ? CT : (C + 1) / 2 * 2; }

// a channel pair of x as floats; the second is 0 past C
__device__ __forceinline__ float2 load_pair(const bf16* p, int c, int C, bool even) {
  if (even) return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
  return make_float2(c < C ? __bfloat162float(p[0]) : 0.0f,
                     c + 1 < C ? __bfloat162float(p[1]) : 0.0f);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
dw_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int H, int W, int C,
               int TH, int ct) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf162* xs = reinterpret_cast<bf162*>(smem);  // [TH + K - 1][W + K - 1][ct / 2]
  constexpr int PAD = K / 2;
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * ct;
  const int h0 = blockIdx.x * TH;
  const int WP = W + K - 1;
  const int NP = ct / 2;                // channel pairs of the tile
  const int PIX = THREADS / NP;         // pixel lanes
  const int tid = threadIdx.x;
  const int pp = tid % NP;
  const int lane_pix = tid / NP;
  const bool even = C % 2 == 0;
  const size_t row_stride = size_t(W) * C;
  const bf16* img = x + size_t(n) * H * row_stride;

  const int rows = min(TH, H - h0) + K - 1;
  for (int i = tid; i < rows * WP * NP; i += THREADS) {
    const int p = i % NP;
    const int col = i / NP % WP;
    const int r = i / NP / WP;
    const int ih = h0 + r - PAD;
    const int iw = col - PAD;
    const int c = c0 + 2 * p;
    float2 v = make_float2(0.0f, 0.0f);
    if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < C)
      v = load_pair(img + ih * row_stride + size_t(iw) * C + c, c, C, even);
    xs[(r * WP + col) * NP + p] = __floats2bfloat162_rn(v.x, v.y);
  }

  const int c = c0 + 2 * pp;
  float2 wr[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wr[t] = make_float2(c < C ? w[t * C + c] : 0.0f, c + 1 < C ? w[t * C + c + 1] : 0.0f);
  const float b0 = c < C ? bias[c] : 0.0f;
  const float b1 = c + 1 < C ? bias[c + 1] : 0.0f;
  __syncthreads();
  if (lane_pix >= PIX || c >= C) return;

  const int npix = (rows - K + 1) * W;
  for (int q = lane_pix; q < npix; q += PIX) {
    const int r = q / W;
    const int col = q % W;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int kh = 0; kh < K; ++kh)
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        const float2 v = __bfloat1622float2(xs[((r + kh) * WP + col + kw) * NP + pp]);
        a0 = fmaf(v.x, wr[kh * K + kw].x, a0);
        a1 = fmaf(v.y, wr[kh * K + kw].y, a1);
      }
    const float y0 = a0 + b0;
    const float y1 = a1 + b1;
    const float s0 = y0 * (1.0f / (1.0f + expf(-y0)));
    const float s1 = y1 * (1.0f / (1.0f + expf(-y1)));
    bf16* o = out + (size_t(n) * H + h0 + r) * row_stride + size_t(col) * C + c;
    if (even) {
      *reinterpret_cast<bf162*>(o) = __floats2bfloat162_rn(s0, s1);
    } else {
      o[0] = __float2bfloat16(s0);
      if (c + 1 < C) o[1] = __float2bfloat16(s1);
    }
  }
}

}  // namespace

// x, out (N, H, W, C) bf16 and w (K, K, C), b (C,) fp32, all contiguous.
extern "C" int dw_conv_bias_silu_fwd(const void* x, const void* w, const void* b, void* out,
                                     int N, int H, int W, int C, int K, void* stream) {
  if ((K != 3 && K != 5) || N < 1 || H < 1 || W < 1 || C < 1 || N > 65535)
    return int(cudaErrorInvalidValue);
  const int ct = tile_channels(C);
  const int tiles = (C + ct - 1) / ct;
  const size_t row_bytes = size_t(W + K - 1) * ct * sizeof(bf16);
  const int fit = int(SMEM_BYTES / row_bytes) - (K - 1);  // output rows whose halo tile fits
  if (fit < 1 || tiles > 65535) return int(cudaErrorInvalidValue);
  const int TH = fit < H ? fit : H;
  const size_t smem = size_t(TH + K - 1) * row_bytes;
  const dim3 grid((H + TH - 1) / TH, tiles, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bfp = static_cast<const float*>(b);
  bf16* ob = static_cast<bf16*>(out);
  if (K == 3)
    dw_conv_kernel<3><<<grid, THREADS, smem, s>>>(xb, wf, bfp, ob, H, W, C, TH, ct);
  else
    dw_conv_kernel<5><<<grid, THREADS, smem, s>>>(xb, wf, bfp, ob, H, W, C, TH, ct);
  return int(cudaGetLastError());
}
