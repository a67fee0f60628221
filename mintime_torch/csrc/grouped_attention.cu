// Grouped attention with a CLS key and value over pre-split q, k, v, for
// Hopper (sm_90a), bf16 in and out, fp32 inside.
//
// Replaces: mintime_tpu/ops/pallas_attention.py::_kernel (reached through
// fused_grouped_attention, the v1 kernel). Inputs are q, k, v (B*H, G, L, D)
// with q pre-scaled, k_cls and v_cls (B*H, D), and an optional additive
// bias (B, L, 1+L) fp32 shared over heads and groups (column 0 the CLS key).
// Per (b*h, g) and query row r:
//   P   = bf16(softmax([q_r k_cls | q_r K^T] + bias[b, r]))   (fp32 logits)
//   out = bf16(P[1:] V + P[0] v_cls)                            (fp32 sums)
// Masks arrive as finite biases (-0.7 * f32 max), never -inf.
//
// Bound on an H100: memory. At the flagship's B = 8, H = 8, G*L = 784,
// D = 64 a call reads q, k, v once and writes out (4 * 6.4 MB): 7.7 us at
// 3.35 TB/s; its arithmetic, 4*B*H*G*L*(1+L)*D, is at most 0.2 GFLOP.
//
// Design: the TPU kernel took a whole (b*h) slice per grid step and batched
// its groups through the MXU. Here one 4-warp block owns one (b*h, g) (3136
// blocks on the time axis, 1024 on the space axis), in the style of
// csrc/token_rows_attention.cu: the group's K and V (the CLS pair as row 0)
// sit in shared memory as fp32, each warp takes one query row at a time,
// lane t computes the logit of key t (up to 65 keys, three a lane), shuffles
// give the max and the sum, and the bf16 probabilities in shared memory feed
// PV with each lane owning D/32 output dimensions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef long long i64;

namespace {

constexpr int MAXD = 64;        // widest head
constexpr int MAXL = 64;        // longest group (the space axis' 49)
constexpr int MAXT = (MAXL + 1 + 31) / 32;  // keys per lane (CLS + L)
constexpr int WARPS = 4;
constexpr int KLD = MAXD + 1;   // padded fp32 rows: lane t reads key t conflict-free

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

__global__ void __launch_bounds__(WARPS * 32)
grouped_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ kc,
                         const bf16* __restrict__ vc, const float* __restrict__ bias,
                         bf16* __restrict__ out, int G, int L, int D, int H) {
  __shared__ float ks[MAXL + 1][KLD];
  __shared__ float vs[MAXL + 1][MAXD];
  __shared__ float qs[WARPS][MAXD];
  __shared__ float ps[WARPS][MAXL + 1];

  const int g = blockIdx.x;
  const int p = blockIdx.y;  // b * H + h
  const int b = p / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int T = L + 1;  // CLS key + L keys
  const i64 base = (i64(p) * G + g) * L * D;

  for (int i = tid; i < T * D; i += WARPS * 32) {
    const int r = i / D;
    const int d = i % D;
    ks[r][d] = bf(r == 0 ? kc[i64(p) * D + d] : k[base + (r - 1) * D + d]);
    vs[r][d] = bf(r == 0 ? vc[i64(p) * D + d] : v[base + (r - 1) * D + d]);
  }
  __syncthreads();

  for (int r = warp; r < L; r += WARPS) {
    for (int d = lane; d < D; d += 32) qs[warp][d] = bf(q[base + r * D + d]);
    __syncwarp();

    float logit[MAXT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      float s = -INFINITY;
      if (t < T) {
        float a = 0.0f;
        for (int e = 0; e < D; ++e) a = fmaf(qs[warp][e], ks[t][e], a);
        if (bias != nullptr) a += bias[(i64(b) * L + r) * T + t];
        s = a;
      }
      logit[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      const float e = t < T ? expf(logit[j] - mx) : 0.0f;
      logit[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      if (t < T) ps[warp][t] = bf16_round(logit[j] / sum);
    }
    __syncwarp();

    // P[1:] V first, then the CLS value, as the TPU kernel adds them
    for (int d = lane; d < D; d += 32) {
      float a = 0.0f;
      for (int t = 1; t < T; ++t) a = fmaf(ps[warp][t], vs[t][d], a);
      a = fmaf(ps[warp][0], vs[0][d], a);
      out[base + r * D + d] = __float2bfloat16(a);
    }
    __syncwarp();  // qs and ps are rewritten for the next row
  }
}

}  // namespace

// q, k, v, out (B*H, G, L, D) and kc, vc (B*H, D) contiguous; bias (B, L, 1+L)
// contiguous fp32 or null.
extern "C" int grouped_attention_fwd(const void* q, const void* k, const void* v, const void* kc,
                                     const void* vc, const void* bias, void* out, int B, int H,
                                     int G, int L, int D, void* stream) {
  if (D < 2 || D > MAXD || D % 2 || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 ||
      i64(B) * H > 65535)
    return int(cudaErrorInvalidValue);
  grouped_attention_kernel<<<dim3(G, B * H), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(kc), static_cast<const bf16*>(vc), static_cast<const float*>(bias),
      static_cast<bf16*>(out), G, L, D, H);
  return int(cudaGetLastError());
}
