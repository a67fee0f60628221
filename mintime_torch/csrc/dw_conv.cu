// Depthwise convolution (stride 1, SAME padding) for Hopper (sm_90a): bf16
// NHWC in and out, fp32 sums, in two variants of one kernel.
//
// * Bias + SiLU. Replaces experiments/dw_conv_pallas_vs_xla.py::dw_kernel
//   (reached through pallas_dwconv). With x_pad the input with K/2 zeros
//   around H and W, fp32 (K, K, C) weights and a (C,) bias,
//     y = sum_{kh, kw} x_pad[n, h+kh, w+kw, c] * w[kh, kw, c]   (fp32, kh outer)
//     out = bf16((y + b[c]) * sigmoid(y + b[c]))
//   for K = 3 and 5, the EfficientNet-B0 depthwise layers.
// * Plain 3 x 3, Xception's SeparableConv.conv1 (the JAX package leaves it to
//   XLA: no TPU kernel), its weights read as the module holds them in the
//   compute dtype, (C, 1, 3, 3) = (C, 9) bf16 in memory, widened to fp32 in
//   registers, with an optional ReLU prologue (the ReLU in front of the layer,
//   applied to each input as it leaves shared memory; the zero halo stays zero
//   under it, so the result is exact):
//     out = bf16(sum_{kh, kw} relu?(x_pad)[n, h+kh, w+kw, c] * w[c, kh, kw])
//
// Bound on an H100: memory. A call reads x once and writes out once: at 1,536
// images of 109 x 109 x 128 (Xception's largest), 2 * 2.34 GB, 2.79 ms at
// 3.35 TB/s; its 2*K*K*N*H*W*C fp32 operations (42 GFLOP) take 0.63 ms at the
// 67 TFLOP/s of the CUDA cores.
//
// Design. One block owns (image, tile of ct channels) and walks the image's
// height. It holds a ring of K + 1 padded input rows in dynamic shared memory
// ([K + 1][WP][ct] bf16, WP = the row with its K - 1 halo columns, rounded up
// to whole column groups): while it computes output row r from ring rows
// r .. r + K - 1, it stages input row r + K by 16-byte cp.async, eight
// channels a copy, zero-filled above and below the image. Every input element
// is read from device memory once. The halo columns are zeroed once and never
// written again; the first row's barrier orders that before any read. A
// thread owns one channel pair and R = 7 consecutive output columns (the last
// group of a row masked where 7 does not divide W): for each kernel row it
// reads the K + R - 1 inputs its columns see into registers and slides over
// them, so shared-memory reads per output fall from K*K to K*(K + R - 1)/R;
// its pair's K*K weights stay in registers. Each output sums its taps in the
// order the plain version does (kh outer, kw inner, one fmaf chain from 0),
// then (bias + SiLU only) bias, SiLU (__expf: a few ulp of fp32, far below the
// one bf16 rounding that follows) and one rounding to bf16. The plan (ct,
// threads) comes from the caller (ops/dw_conv.py::plan): on this card the
// latency of the one row in flight is hidden by several blocks an SM, so the
// plan keeps tiles of at most 64 channels and two row items a thread (a
// deeper ring and blocks that walk several images measured no faster).
// Channel counts that are not a multiple of 8 are staged element by element
// and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int R = 7;  // output columns a thread

// what a launch computes around its sums
enum Mode { BIAS_SILU, PLAIN, RELU_PLAIN };

__device__ __forceinline__ float2 pair_at(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float silu(float y) { return y * (1.0f / (1.0f + __expf(-y))); }

// max(v, 0) that keeps a NaN, as torch's relu does
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

template <int K, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
dw_conv_kernel(const bf16* __restrict__ x, const void* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int H, int W, int C,
               int ct, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  constexpr int PAD = K / 2;
  constexpr int SLOTS = K + 1;
  const int n = blockIdx.y;
  const int c0 = blockIdx.x * ct;
  const int groups = (W + R - 1) / R;  // column groups of a row
  const int WP = groups * R + K - 1;
  const int row_elems = WP * ct;
  const int np = ct / 2;               // channel pairs of the tile
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t row_stride = size_t(W) * C;
  const bf16* img = x + size_t(n) * H * row_stride;

  // zero the halo columns of every slot once: staging never writes them
  const int halo = WP - W;  // PAD on the left, the rest on the right
  for (int i = tid; i < SLOTS * halo * ct / 2; i += nt) {
    const int c2 = i % (ct / 2);
    const int col = i / (ct / 2) % halo;
    const int slot = i / (ct / 2) / halo;
    reinterpret_cast<uint32_t*>(ring + slot * row_elems + (col < PAD ? col : col + W) * ct)[c2] = 0u;
  }

  // padded row pr (input row pr - PAD) into its slot, interior columns only
  auto stage = [&](int pr) {
    const int ih = pr - PAD;
    const bool in_image = ih >= 0 && ih < H;
    bf16* dst = ring + (pr % SLOTS) * row_elems + PAD * ct;
    const bf16* src = img + size_t(in_image ? ih : 0) * row_stride + c0;
    if (vec) {
      const int cpr = ct / 8;  // 16-byte copies per pixel
      for (int i = tid; i < W * cpr; i += nt) {
        const int col = i / cpr;
        const int q = i - col * cpr;
        const bool live = in_image && c0 + 8 * q < C;
        warp_mma::cp_async16_zfill(dst + col * ct + 8 * q,
                                   live ? src + size_t(col) * C + 8 * q : img, live ? 16 : 0);
      }
    } else {
      for (int i = tid; i < W * ct; i += nt) {
        const int col = i / ct;
        const int c = i - col * ct;
        dst[col * ct + c] = in_image && c0 + c < C ? src[size_t(col) * C + c] : __float2bfloat16(0.0f);
      }
    }
  };

  for (int pr = 0; pr < K; ++pr) {
    stage(pr);
    warp_mma::cp_async_commit();
  }

  const int items = groups * np;
  int wp = -1;  // the channel pair whose weights and bias the registers hold
  float2 wr[K * K];
  float b0 = 0.0f, b1 = 0.0f;
  for (int r = 0; r < H; ++r) {
    if (r + 1 < H) stage(r + K);  // the last padded row is r + K = H + K - 2 at r = H - 2
    warp_mma::cp_async_commit();
    warp_mma::cp_async_wait<1>();
    __syncthreads();

    for (int it = tid; it < items; it += nt) {
      const int p = it % np;
      const int g = it / np;
      const int c = c0 + 2 * p;
      if (c >= C) continue;
      if (p != wp) {
        if (MODE == BIAS_SILU) {
          const float* wf = static_cast<const float*>(w);
#pragma unroll
          for (int t = 0; t < K * K; ++t)
            wr[t] = make_float2(wf[t * C + c], c + 1 < C ? wf[t * C + c + 1] : 0.0f);
          b0 = bias[c];
          b1 = c + 1 < C ? bias[c + 1] : 0.0f;
        } else {
          const bf16* wb = static_cast<const bf16*>(w) + size_t(c) * K * K;
#pragma unroll
          for (int t = 0; t < K * K; ++t)
            wr[t] = make_float2(__bfloat162float(wb[t]),
                                c + 1 < C ? __bfloat162float(wb[K * K + t]) : 0.0f);
        }
        wp = p;
      }
      float a0[R], a1[R];
#pragma unroll
      for (int j = 0; j < R; ++j) a0[j] = a1[j] = 0.0f;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        const bf16* src = ring + ((r + kh) % SLOTS) * row_elems + (g * R) * ct + 2 * p;
        float2 v[K + R - 1];
#pragma unroll
        for (int t = 0; t < K + R - 1; ++t) {
          v[t] = pair_at(src + t * ct);
          if (MODE == RELU_PLAIN) v[t] = make_float2(relu(v[t].x), relu(v[t].y));
        }
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int kw = 0; kw < K; ++kw) {
            a0[j] = fmaf(v[j + kw].x, wr[kh * K + kw].x, a0[j]);
            a1[j] = fmaf(v[j + kw].y, wr[kh * K + kw].y, a1[j]);
          }
      }
      bf16* o = out + (size_t(n) * H + r) * row_stride + size_t(g * R) * C + c;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (g * R + j >= W) break;
        float s0 = a0[j], s1 = a1[j];
        if (MODE == BIAS_SILU) {
          s0 = silu(s0 + b0);
          s1 = silu(s1 + b1);
        }
        if (C % 2 == 0) {
          *reinterpret_cast<bf162*>(o + size_t(j) * C) = __floats2bfloat162_rn(s0, s1);
        } else {
          o[size_t(j) * C] = __float2bfloat16(s0);
          if (c + 1 < C) o[size_t(j) * C + 1] = __float2bfloat16(s1);
        }
      }
    }
    __syncthreads();  // the next stage overwrites the slot row r just read
  }
}

template <int K, int MODE>
int launch(const bf16* x, const void* w, const float* b, bf16* out, int N, int H, int W, int C,
           int ct, int threads, cudaStream_t s) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || N > 65535 || ct < 2 || ct % 2 ||
      (C + ct - 1) / ct > 65535 || threads < 32 || threads % 32 || threads > MAX_THREADS)
    return int(cudaErrorInvalidValue);
  const bool vec = C % 8 == 0 && ct % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int groups = (W + R - 1) / R;
  const size_t smem = size_t(K + 1) * (groups * R + K - 1) * ct * sizeof(bf16);
  if (smem > size_t(MAX_SMEM)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(dw_conv_kernel<K, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((C + ct - 1) / ct, N);
  dw_conv_kernel<K, MODE><<<grid, threads, smem, s>>>(x, w, b, out, H, W, C, ct, vec);
  return int(cudaGetLastError());
}

}  // namespace

// x, out (N, H, W, C) bf16 and w (K, K, C), b (C,) fp32, all contiguous.
// The plan: ct channels a block (even; a multiple of 8 when C is), threads a
// block (a multiple of 32, at most 512).
extern "C" int dw_conv_bias_silu_fwd(const void* x, const void* w, const void* b, void* out,
                                     int N, int H, int W, int C, int K, int ct,
                                     int threads, void* stream) {
  if (K != 3 && K != 5) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* bfp = static_cast<const float*>(b);
  bf16* ob = static_cast<bf16*>(out);
  return K == 3 ? launch<3, BIAS_SILU>(xb, w, bfp, ob, N, H, W, C, ct, threads, s)
                : launch<5, BIAS_SILU>(xb, w, bfp, ob, N, H, W, C, ct, threads, s);
}

// x, out (N, H, W, C) bf16 and w (C, 3, 3) bf16, all contiguous; relu != 0
// applies max(x, 0) to the input first. The plan as above.
extern "C" int dw_conv3x3_fwd(const void* x, const void* w, void* out, int N, int H, int W,
                              int C, int relu, int ct, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  return relu ? launch<3, RELU_PLAIN>(xb, w, nullptr, ob, N, H, W, C, ct, threads, s)
              : launch<3, PLAIN>(xb, w, nullptr, ob, N, H, W, C, ct, threads, s);
}
