// Token rows of the divided space-time attention, tiled over groups, for
// Hopper (sm_90a), bf16 in and out, fp32 inside.
//
// Replaces: mintime_tpu/ops/pallas_attention.py::_token_rows_kernel (reached
// through _token_rows_fwd_call, _token_rows_core and divided_attention when
// a slice exceeds the whole-slice budget: the Convolutional TimeSformer's
// time axis, G = 1280 channel groups of L = 8 frames, H = 6 heads of 64).
// Input is packed qkv (B, G, L, 3*H*dh) with columns [q | k | v], each
// head-major (PyTorch's to_qkv layout), read through arbitrary (B, G, L)
// strides so the time axis needs no transpose, plus the CLS row's packed qkv
// (B, 3*H*dh). Per (b, g, h), with q~ = bf16(q * dh^-0.5):
//   P   = bf16(softmax([q~ k_cls | q~ K^T] + seq_bias))   (fp32 logits)
//   out = bf16(P[:, 1:] V + P[:, 0] v_cls)                 (fp32 sums)
// seq_bias (B, L, 1+L) fp32, column 0 the CLS key, is optional; masks are
// finite biases (-0.7 * f32 max), never -inf. The CLS row itself is not
// computed here (mintime_torch/ops/token_rows.py::cls_row_plain).
//
// Bound on an H100: memory. At B = 8, G = 1280, L = 8, H*dh = 384 a call
// reads qkv once (81920 * 1152 * 2 B = 189 MB) and writes out (63 MB):
// 0.075 ms at 3.35 TB/s. Its arithmetic, 4*B*G*H*L*(L+1)*dh = 1.8 GFLOP, is
// far below the tensor-core rate.
//
// Design: the TPU kernel tiled G to fit VMEM and looped over heads. Here a
// warp owns one (b, g, h), so the 61440 groups of almost no work each fill a
// warp and not a block; four warps a block, h fastest, so a block's warps
// read neighbouring 128-byte pieces of the same rows. The warp stages the
// group's K and V (CLS as row 0) in its own shared memory as fp32, lane t
// computes the logit of key t for one query row at a time, shuffles give the
// max and the sum, the bf16 probabilities go to shared memory, and each lane
// then owns two output dimensions for PV. Each element of qkv is read from
// device memory once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int DH = 64;          // head width: two dimensions a lane
constexpr int MAXL = 64;        // longest attended sequence (frame counts up to 32; the probe's 49 patches)
constexpr int MAXT = (MAXL + 1 + 31) / 32;  // keys per lane (CLS + L)
constexpr int WARPS = 4;
constexpr int KLD = DH + 1;     // padded fp32 rows: lane t reads key t conflict-free

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
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

// fp32 words of one warp's shared memory: vs [T][DH], ks [T][KLD], qs [DH], ps [T]
int warp_floats(int L) {
  const int T = L + 1;
  return (T * DH + T * KLD + DH + T + 1) / 2 * 2;  // even: each warp's vs is 8-byte aligned
}

__global__ void __launch_bounds__(WARPS * 32)
token_rows_fwd_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                      const bf16* __restrict__ qkvc, i64 scb,
                      const float* __restrict__ seq_bias, bf16* __restrict__ out, i64 ob,
                      i64 og, i64 ol, int B, int G, int L, int H, int wfloats, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const i64 item = i64(blockIdx.x) * WARPS + warp;  // (b, g, h), h fastest
  if (item >= i64(B) * G * H) return;  // no block-wide barrier below
  const int h = int(item % H);
  const int g = int(item / H % G);
  const int b = int(item / H / G);
  const int T = L + 1;  // CLS key + L keys
  float* vs = smem + warp * wfloats;  // first, for its float2 reads
  float* ks = vs + T * DH;
  float* qs = ks + T * KLD;
  float* ps = qs + DH;
  const int inner = H * DH;
  const bf16* base = qkv + b * sb + g * sg;
  const bf16* cls = qkvc + b * scb;
  const int d = 2 * lane;
  const int qoff = h * DH + d;
  const int koff = inner + h * DH + d;
  const int voff = 2 * inner + h * DH + d;

  for (int r = 0; r < T; ++r) {
    const bf16* row = r == 0 ? cls : base + (r - 1) * sl;
    const float2 k = load2(row + koff);
    const float2 v = load2(row + voff);
    ks[r * KLD + d] = k.x;
    ks[r * KLD + d + 1] = k.y;
    *reinterpret_cast<float2*>(vs + r * DH + d) = v;
  }

  for (int r = 0; r < L; ++r) {
    const float2 q = load2(base + r * sl + qoff);
    qs[d] = bf16_round(q.x * scale);
    qs[d + 1] = bf16_round(q.y * scale);
    __syncwarp();

    float logit[MAXT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      float s = -INFINITY;
      if (t < T) {
        float a = 0.0f;
#pragma unroll 16
        for (int e = 0; e < DH; ++e) a = fmaf(qs[e], ks[t * KLD + e], a);
        if (seq_bias != nullptr) a += seq_bias[(i64(b) * L + r) * T + t];
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
      if (t < T) ps[t] = bf16_round(logit[j] / sum);
    }
    __syncwarp();

    // P[:, 1:] V first, then the CLS value, as the TPU kernel adds them
    float2 acc = make_float2(0.0f, 0.0f);
    for (int t = 1; t < T; ++t) {
      const float2 v = *reinterpret_cast<const float2*>(vs + t * DH + d);
      acc.x = fmaf(ps[t], v.x, acc.x);
      acc.y = fmaf(ps[t], v.y, acc.y);
    }
    acc.x = fmaf(ps[0], vs[d], acc.x);
    acc.y = fmaf(ps[0], vs[d + 1], acc.y);
    *reinterpret_cast<bf162*>(out + b * ob + g * og + r * ol + h * DH + d) =
        __floats2bfloat162_rn(acc.x, acc.y);
    __syncwarp();  // qs and ps are rewritten for the next row
  }
}

}  // namespace

// Strides are in elements; every pointer 4-byte aligned and every stride even
// (the wrapper checks), so pairs of bf16 move as one word.
extern "C" int token_rows_attention_fwd(const void* qkv, i64 sb, i64 sg, i64 sl,
                                        const void* qkvc, i64 scb, const void* seq_bias,
                                        void* out, i64 ob, i64 og, i64 ol, int B, int G, int L,
                                        int H, int dh, void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1)
    return int(cudaErrorInvalidValue);
  const i64 blocks = (i64(B) * G * H + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  const int wfloats = warp_floats(L);
  const size_t smem = size_t(WARPS) * wfloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(token_rows_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const float scale = 1.0f / sqrtf(float(DH));
  token_rows_fwd_kernel<<<unsigned(blocks), WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), sb, sg, sl, static_cast<const bf16*>(qkvc), scb,
      static_cast<const float*>(seq_bias), static_cast<bf16*>(out), ob, og, ol, B, G, L, H,
      wfloats, scale);
  return int(cudaGetLastError());
}
