// The CLS row of divided attention, spread over many blocks: one query (the
// CLS token's) over itself and the G*L token keys of its (b, h), for Hopper
// (sm_90a), bf16 in and out, fp32 inside. Shared by csrc/divided_attention.cu
// (row 3, the whole-slice forward) and csrc/chunked_attention.cu (row 8, the
// attention probe's variant G).
//
// Three launches over `chunks` chunks of the G*L keys (fp32 scratch (B, H,
// G*L + chunks * (DH + 2)) from the caller), the rounding of the TPU's
// whole-slice kernel (mintime_tpu/ops/pallas_attention.py::_divided_kernel)
// and of the plain version (mintime_torch/ops/divided_attention.py::
// _cls_row_out): cls_row_logits_kernel writes each key's logit (8 lanes a
// key, 16-byte loads) and the chunk's max; cls_row_pv_kernel takes the
// global max m = max(chunk maxima, the CLS self-logit), p = exp(s - m)
// rounded to bf16 with that m, and writes the chunk's sum of p (fp32) and of
// bf16(p) v; cls_row_reduce_kernel sums the chunks in order and divides:
// out = (sum bf16(p) v + ps v_cls) / (sum p + ps). No atomics: reruns give
// the same bits. q is scaled by dh^-0.5 in bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cls_row {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

constexpr int DH = 64;          // head width
constexpr int CLS_THREADS = 256;
constexpr int PART = DH + 2;    // a CLS chunk's scratch: sum bf16(p) v (DH), sum p, max

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide reduction over the block's warps; every thread gets the result
template <bool IS_MAX>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < warps ? red[lane] : (IS_MAX ? -INFINITY : 0.0f);
  return IS_MAX ? warp_max(v) : warp_sum(v);
}

// The 8 values at cols c .. c+7 of a bf16 row, from one 16-byte load
__device__ __forceinline__ void load8(float x[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// The CLS row's global max m = max(chunk maxima, self logit) and its self
// logit ls, the same bits in every block that asks
__device__ void cls_max_and_self(float& m, float& ls, const float* part, int chunks,
                                 const bf16* cls, int qoff, int koff, float scale, float* red) {
  __shared__ float self_logit;
  if (threadIdx.x < 32) {
    const int d = threadIdx.x;
    const float s = warp_sum(bf16_round(bf(cls[qoff + d]) * scale) * bf(cls[koff + d]) +
                             bf16_round(bf(cls[qoff + d + 32]) * scale) * bf(cls[koff + d + 32]));
    if (d == 0) self_logit = s;
  }
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) mx = fmaxf(mx, part[c * PART + DH + 1]);
  mx = block_reduce<true>(mx, red);  // its barriers also publish self_logit
  ls = self_logit;
  m = fmaxf(mx, ls);
}

// CLS launch 1: the logits of chunk c of the G*L keys, 8 lanes a key
// (16-byte loads), and the chunk's max
__global__ void __launch_bounds__(CLS_THREADS)
cls_row_logits_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                      const bf16* __restrict__ qkvc, i64 scb, const float* __restrict__ row_bias,
                      i64 rb_b, i64 rb_g, i64 rb_l, float* __restrict__ scratch, int G, int L,
                      int H, int chunks, float scale) {
  __shared__ float red[CLS_THREADS / 32];
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int N = G * L;
  const int per = (N + chunks - 1) / chunks;
  const int t0 = c * per;
  const int t1 = min(N, t0 + per);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane & 7;   // the lane's 8 dimensions
  const int slot = lane >> 3; // the lane's key of the warp's four
  const int inner = H * DH;
  const bf16* base = qkv + b * sb;
  const int koff = inner + h * DH + sub * 8;
  float* lg = scratch + (i64(b) * H + h) * (N + chunks * PART);
  float q[8];
  load8(q, qkvc + b * scb + h * DH + sub * 8);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = bf16_round(q[i] * scale);

  float mx = -INFINITY;
  for (int tb = t0 + warp * 4; tb < t1; tb += CLS_THREADS / 8) {  // warp-uniform
    const int t = tb + slot;
    const int g = t / L;
    const int l = t % L;
    float k[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (t < t1) load8(k, base + g * sg + l * sl + koff);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(q[i], k[i], s);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (t < t1) {
      if (row_bias != nullptr) s += row_bias[b * rb_b + g * rb_g + l * rb_l];
      if (sub == 0) lg[t] = s;
      mx = fmaxf(mx, s);
    }
  }
  mx = block_reduce<true>(mx, red);
  if (threadIdx.x == 0) lg[N + c * PART + DH + 1] = mx;
}

// CLS launch 2: p = exp(s - m) with the global max m over chunk c's keys;
// the chunk's sum of p and of bf16(p) v
__global__ void __launch_bounds__(CLS_THREADS)
cls_row_pv_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                  const bf16* __restrict__ qkvc, i64 scb, float* __restrict__ scratch, int G,
                  int L, int H, int chunks, float scale) {
  __shared__ float red[CLS_THREADS / 32];
  __shared__ float accw[CLS_THREADS / 32][DH];
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int N = G * L;
  const int per = (N + chunks - 1) / chunks;
  const int t0 = c * per;
  const int t1 = min(N, t0 + per);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane & 7;
  const int slot = lane >> 3;
  const int inner = H * DH;
  const bf16* base = qkv + b * sb;
  const bf16* cls = qkvc + b * scb;
  float* lg = scratch + (i64(b) * H + h) * (N + chunks * PART);
  float* part = lg + N;
  float m, ls;
  cls_max_and_self(m, ls, part, chunks, cls, h * DH, inner + h * DH, scale, red);

  const int voff = 2 * inner + h * DH + sub * 8;
  float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float z = 0.0f;
  for (int tb = t0 + warp * 4; tb < t1; tb += CLS_THREADS / 8) {  // warp-uniform
    const int t = tb + slot;
    if (t < t1) {
      const float p = expf(lg[t] - m);
      const float pb = bf16_round(p);
      float v[8];
      load8(v, base + (t / L) * sg + (t % L) * sl + voff);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(pb, v[i], acc[i]);
      if (sub == 0) z += p;
    }
  }
  // the warp's four keys a step, then the warps, in a fixed order
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  }
  if (slot == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) accw[warp][sub * 8 + i] = acc[i];
  z = block_reduce<false>(z, red);  // its barriers also publish accw
  if (threadIdx.x < DH) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < CLS_THREADS / 32; ++w) a += accw[w][threadIdx.x];
    part[c * PART + threadIdx.x] = a;
  }
  if (threadIdx.x == 0) part[c * PART + DH] = z;
}

// CLS launch 3: the chunks summed in order, the CLS key's own term, the
// sum divided out
__global__ void __launch_bounds__(DH)
cls_row_reduce_kernel(const bf16* __restrict__ qkvc, i64 scb, const float* __restrict__ scratch,
                      bf16* __restrict__ out_cls, i64 ocb, int N, int H, int chunks,
                      float scale) {
  __shared__ float red[DH / 32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int inner = H * DH;
  const bf16* cls = qkvc + b * scb;
  const float* part = scratch + (i64(b) * H + h) * (N + chunks * PART) + N;
  float m, ls;
  cls_max_and_self(m, ls, part, chunks, cls, h * DH, inner + h * DH, scale, red);
  float acc = 0.0f, z = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    acc += part[c * PART + d];
    z += part[c * PART + DH];
  }
  const float ps = expf(ls - m);
  out_cls[b * ocb + h * DH + d] =
      __float2bfloat16((acc + ps * bf(cls[2 * inner + h * DH + d])) / (z + ps));
}

// The three launches of the CLS row of B videos of G groups of L keys, H
// heads: qkv read through (B, G, L) strides and qkvc through its batch
// stride (16-byte aligned starts and strides, checked by the caller),
// row_bias fp32 through (B, G, L) strides or null; scratch as above.
inline cudaError_t launch_cls_row(const bf16* qkv, i64 sb, i64 sg, i64 sl, const bf16* qkvc,
                                  i64 scb, const float* row_bias, i64 rb_b, i64 rb_g, i64 rb_l,
                                  float* scratch, int chunks, bf16* out_cls, i64 ocb, int B,
                                  int G, int L, int H, float scale, cudaStream_t s) {
  cls_row_logits_kernel<<<dim3(H, chunks, B), CLS_THREADS, 0, s>>>(
      qkv, sb, sg, sl, qkvc, scb, row_bias, rb_b, rb_g, rb_l, scratch, G, L, H, chunks, scale);
  cls_row_pv_kernel<<<dim3(H, chunks, B), CLS_THREADS, 0, s>>>(qkv, sb, sg, sl, qkvc, scb,
                                                               scratch, G, L, H, chunks, scale);
  cls_row_reduce_kernel<<<dim3(H, B), DH, 0, s>>>(qkvc, scb, scratch, out_cls, ocb, G * L, H,
                                                  chunks, scale);
  return cudaGetLastError();
}

}  // namespace cls_row
