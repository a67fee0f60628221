// Divided space-time attention with a CLS row for Hopper (sm_90a), bf16.
//
// Replaces: mintime_tpu/ops/pallas_attention.py::_divided_kernel (reached
// through _fwd_call, _divided_attention_core and divided_attention).
// Input is packed qkv (B, G, L, 3*H*dh) with columns [q | k | v], each
// head-major (PyTorch's to_qkv layout), read through (B, G, L) strides so
// the time axis needs no transpose, plus the CLS row's packed qkv
// (B, 3*H*dh); starts and strides 16-byte aligned.
//   token rows: softmax over [CLS key | the L keys of the group] + seq_bias
//               (fp32, (B, L, 1+L), column 0 = CLS key), bf16 probabilities,
//               then P @ [v_cls; V] with fp32 accumulation, the CLS term last;
//   CLS row:    one query over all G*L keys (+ row_bias) and itself, with
//               unnormalised bf16 probabilities before PV and the sum
//               divided out at the end, as the TPU kernel does.
// q is scaled by dh^-0.5 in bf16; masks arrive as finite biases
// (-0.7 * f32 max), never -inf.
//
// Bound on an H100: memory. Per call at B = 8 (G*L = 784, H*dh = 512) it
// reads qkv once (6272 * 1536 * 2 B = 19.3 MB) and writes out (6.4 MB):
// about 8 us at 3.35 TB/s; its arithmetic is a few hundred MFLOP.
//
// Design: the TPU held a whole batch slice (2.4 MB) in VMEM; a GPU block
// cannot, so the work splits into launches that each own what they write.
//   * token rows: token_rows_mma_kernel (csrc/attn_rows_mma.cuh, launched
//     by the token-row forward above 16 frames too), a block of up to four
//     warps per (b, g, h), stages the group's K and V (CLS as row 0) by 16-byte
//     cp.async into swizzled bf16 rows (68 KB at L = 256), and each warp
//     runs attn_rows::attend_rows (csrc/attn_rows_mma.cuh) over 16 query
//     rows at a time: S and PV on mma.sync tiles, two passes over S, P
//     rounded after normalising. With dh = 64 the scale 1/8 is a power of
//     two, so bf16(q / 8) = q / 8 exactly: q is read as it is, straight into
//     A fragments, and the scale is applied to S. One block a group, its
//     warps looping over the 16-row tiles, reads K and V once and was as
//     fast as a block per four tiles at L = 80-256; at L <= 64 it took half
//     to a third of the time of the scalar kernel it replaced (a warp per
//     query row, a lane per key; H100, device time by chip_smoke.device_ms);
//   * CLS row, in three launches over cls_chunks chunks of the G*L keys
//     (fp32 scratch (B, H, G*L + chunks * (dh + 2)) from the wrapper):
//     cls_row_logits_kernel writes each key's logit (8 lanes a key, 16-byte
//     loads) and the chunk's max; cls_row_pv_kernel takes the global max
//     m = max(chunk maxima, the CLS self-logit), p = exp(s - m) rounded to
//     bf16 with that m, and writes the chunk's sum of p (fp32) and of
//     bf16(p) v; cls_row_reduce_kernel sums the chunks in order and divides:
//     out = (sum bf16(p) v + ps v_cls) / (sum p + ps). No atomics: reruns
//     give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_rows_mma.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int DH = 64;          // head width
constexpr int MAXL = 256;       // longest attended sequence of the token rows
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

bool aligned16(const void* p, i64 elems) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && elems % 8 == 0;
}

}  // namespace

// cls_chunks: chunks of the G*L keys of the CLS row; cls_scratch: fp32
// (B, H, G*L + cls_chunks * (dh + 2)).
extern "C" int divided_attention_fwd(const void* qkv, i64 sb, i64 sg, i64 sl, const void* qkvc,
                                     i64 scb, const void* seq_bias, const void* row_bias,
                                     i64 rb_b, i64 rb_g, i64 rb_l, void* out, i64 ob, i64 og,
                                     i64 ol, void* out_cls, i64 ocb, void* cls_scratch,
                                     int cls_chunks, int B, int G, int L, int H, int dh,
                                     void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || B > 65535 || G > 65535 ||
      cls_chunks < 1 || cls_chunks > G * L || cls_chunks > 65535)
    return int(cudaErrorInvalidValue);
  // 16-byte loads: aligned starts and strides
  if (!aligned16(qkv, sb) || !aligned16(qkv, sg) || !aligned16(qkv, sl) || !aligned16(qkvc, scb))
    return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(DH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* qc = static_cast<const bf16*>(qkvc);
  const float* sbias = static_cast<const float*>(seq_bias);
  const float* rbias = static_cast<const float*>(row_bias);
  float* scratch = static_cast<float*>(cls_scratch);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err = attn_rows::launch_token_rows_mma(q, sb, sg, sl, qc, scb, sbias, o, ob, og, ol,
                                                     B, G, L, H, scale, s);
  if (err != cudaSuccess) return int(err);
  cls_row_logits_kernel<<<dim3(H, cls_chunks, B), CLS_THREADS, 0, s>>>(
      q, sb, sg, sl, qc, scb, rbias, rb_b, rb_g, rb_l, scratch, G, L, H, cls_chunks, scale);
  cls_row_pv_kernel<<<dim3(H, cls_chunks, B), CLS_THREADS, 0, s>>>(q, sb, sg, sl, qc, scb,
                                                                   scratch, G, L, H, cls_chunks,
                                                                   scale);
  cls_row_reduce_kernel<<<dim3(H, B), DH, 0, s>>>(qc, scb, scratch,
                                                  static_cast<bf16*>(out_cls), ocb, G * L, H,
                                                  cls_chunks, scale);
  return int(cudaGetLastError());
}
