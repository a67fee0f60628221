// Divided space-time attention with a CLS row for Hopper (sm_90a), bf16.
//
// Replaces: mintime_tpu/ops/pallas_attention.py::_divided_kernel (reached
// through _fwd_call, _divided_attention_core and divided_attention).
// Input is packed qkv (B, G, L, 3*H*dh) with columns [q | k | v], each
// head-major (PyTorch's to_qkv layout), read through arbitrary (B, G, L)
// strides so the time axis needs no transpose, plus the CLS row's packed
// qkv (B, 3*H*dh).
//   token rows: softmax over [CLS key | the L keys of the group] + seq_bias
//               (fp32, (B, L, 1+L), column 0 = CLS key), bf16 probabilities,
//               then P @ [v_cls; V] with fp32 accumulation;
//   CLS row:    one query over all G*L keys (+ row_bias) and itself, with
//               unnormalised bf16 probabilities before PV and the sum
//               divided out at the end, as the TPU kernel does.
// q is scaled by dh^-0.5 in bf16 inside; masks arrive as finite biases
// (-0.7 * f32 max), never -inf.
//
// Bound on an H100: memory. Per call at B = 8 (G*L = 784, H*dh = 512) it
// reads qkv once (6272 * 1536 * 2 B = 19.3 MB) and writes out (6.4 MB):
// about 8 us at 3.35 TB/s; its arithmetic is a few hundred MFLOP.
//
// Design: the TPU held a whole batch slice (2.4 MB) in VMEM; a GPU block
// cannot, so the work splits in two launches.
//   * token rows: one 4-warp block per (b, g, h) stages the group's K and V
//     (CLS as row 0) in dynamic shared memory as bf16, sized by the actual L
//     (68 KB at L = 256), in rows padded to 66 values so that lane t reads
//     key t's pair of dimensions conflict-free; each warp takes one query
//     row at a time: lane t computes the logits of keys t, t + 32, ...
//     (NT keys a lane, 3 up to L = 64, 9 up to L = 256), warp shuffles give
//     max and sum, and the bf16 probabilities in shared memory feed PV, a
//     lane owning a pair of output dimensions.
//   * CLS row: one 8-warp block per (b, h) computes the G*L logits into
//     shared memory (a warp per key), a block-wide max and sum, then PV with
//     64 threads per dimension group over the keys.
// Each element of qkv is read from device memory once by the token-row
// launch and the k and v halves once more by the CLS launch (mostly from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int DH = 64;          // head width
constexpr int MAXL = 256;       // longest attended sequence of the token rows
constexpr int TOK_WARPS = 4;
constexpr int CLS_THREADS = 256;
constexpr int KVLD = DH + 2;    // padded bf16 rows (33 words): lane t reads key t conflict-free

// keys a lane takes in the token rows (CLS + L keys over 32 lanes)
constexpr int keys_per_lane(int L) { return (L + 1 + 31) / 32; }

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

template <int NT>
__global__ void __launch_bounds__(TOK_WARPS * 32)
token_rows_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                  const bf16* __restrict__ qkvc, i64 scb,
                  const float* __restrict__ seq_bias, bf16* __restrict__ out, i64 ob,
                  i64 og, i64 ol, int L, int H, float scale) {
  extern __shared__ __align__(16) unsigned char tok_smem[];
  __shared__ float qs[TOK_WARPS][DH];
  __shared__ float ps[TOK_WARPS][NT * 32];

  const int h = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int inner = H * DH;
  const int T = L + 1;  // CLS key + L keys
  bf16* ks = reinterpret_cast<bf16*>(tok_smem);  // [T][KVLD]
  bf16* vs = ks + T * KVLD;                      // [T][KVLD]
  const bf16* base = qkv + b * sb + g * sg;
  const bf16* cls = qkvc + b * scb;
  const int qoff = h * DH;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;

  for (int i = tid; i < T * DH; i += TOK_WARPS * 32) {
    const int r = i / DH;
    const int d = i % DH;
    const bf16* row = r == 0 ? cls : base + (r - 1) * sl;
    ks[r * KVLD + d] = row[koff + d];
    vs[r * KVLD + d] = row[voff + d];
  }
  __syncthreads();

  for (int r = warp; r < L; r += TOK_WARPS) {
    const bf16* qrow = base + r * sl + qoff;
    qs[warp][lane] = bf16_round(bf(qrow[lane]) * scale);
    qs[warp][lane + 32] = bf16_round(bf(qrow[lane + 32]) * scale);
    __syncwarp();

    float logit[NT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int t = lane + 32 * j;
      float s = -INFINITY;
      if (t < T) {
        const bf162* krow = reinterpret_cast<const bf162*>(ks + t * KVLD);
        float a = 0.0f;
#pragma unroll 8
        for (int d2 = 0; d2 < DH / 2; ++d2) {
          const float2 kv = __bfloat1622float2(krow[d2]);
          a = fmaf(qs[warp][2 * d2], kv.x, a);
          a = fmaf(qs[warp][2 * d2 + 1], kv.y, a);
        }
        if (seq_bias != nullptr) a += seq_bias[(i64(b) * L + r) * T + t];
        s = a;
      }
      logit[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int t = lane + 32 * j;
      const float e = t < T ? expf(logit[j] - mx) : 0.0f;
      logit[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int t = lane + 32 * j;
      if (t < T) ps[warp][t] = bf16_round(logit[j] / sum);
    }
    __syncwarp();

    // lane owns dimensions 2*lane and 2*lane + 1
    float a0 = 0.0f, a1 = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float p = ps[warp][t];
      const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(vs + t * KVLD + 2 * lane));
      a0 = fmaf(p, v.x, a0);
      a1 = fmaf(p, v.y, a1);
    }
    bf16* orow = out + b * ob + g * og + r * ol + h * DH;
    *reinterpret_cast<bf162*>(orow + 2 * lane) = __floats2bfloat162_rn(a0, a1);
    __syncwarp();
  }
}

template <int NT>
cudaError_t launch_token_rows(dim3 grid, cudaStream_t s, const bf16* qkv, i64 sb, i64 sg, i64 sl,
                              const bf16* qkvc, i64 scb, const float* seq_bias, bf16* out,
                              i64 ob, i64 og, i64 ol, int L, int H, float scale) {
  const int smem = 2 * (L + 1) * KVLD * int(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(token_rows_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  token_rows_kernel<NT><<<grid, TOK_WARPS * 32, smem, s>>>(qkv, sb, sg, sl, qkvc, scb, seq_bias,
                                                           out, ob, og, ol, L, H, scale);
  return cudaGetLastError();
}

// block-wide reduction over CLS_THREADS threads; every thread gets the result
template <bool IS_MAX>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < CLS_THREADS / 32 ? red[lane] : (IS_MAX ? -INFINITY : 0.0f);
  return IS_MAX ? warp_max(v) : warp_sum(v);
}

__global__ void __launch_bounds__(CLS_THREADS)
cls_row_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
               const bf16* __restrict__ qkvc, i64 scb, const float* __restrict__ row_bias,
               i64 rb_b, i64 rb_g, i64 rb_l, bf16* __restrict__ out_cls, i64 ocb, int G,
               int L, int H, float scale) {
  extern __shared__ float lg[];  // G*L logits, then unnormalised probabilities
  __shared__ float qs[DH];
  __shared__ float red[CLS_THREADS / 32];
  __shared__ float accp[CLS_THREADS / DH][DH];
  __shared__ float self_logit;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int inner = H * DH;
  const int N = G * L;
  const bf16* base = qkv + b * sb;
  const bf16* cls = qkvc + b * scb;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;

  if (tid < DH) qs[tid] = bf16_round(bf(cls[h * DH + tid]) * scale);
  __syncthreads();

  if (warp == 0) {
    const float s = warp_sum(qs[lane] * bf(cls[koff + lane]) +
                             qs[lane + 32] * bf(cls[koff + lane + 32]));
    if (lane == 0) self_logit = s;
  }
  for (int t = warp; t < N; t += CLS_THREADS / 32) {
    const int g = t / L;
    const int l = t % L;
    const bf16* krow = base + g * sg + l * sl + koff;
    const float s = warp_sum(qs[lane] * bf(krow[lane]) + qs[lane + 32] * bf(krow[lane + 32]));
    if (lane == 0)
      lg[t] = s + (row_bias != nullptr ? row_bias[b * rb_b + g * rb_g + l * rb_l] : 0.0f);
  }
  __syncthreads();

  const float ls = self_logit;
  float mx = ls;
  for (int t = tid; t < N; t += CLS_THREADS) mx = fmaxf(mx, lg[t]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.0f;
  for (int t = tid; t < N; t += CLS_THREADS) {
    const float e = expf(lg[t] - mx);
    lg[t] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);  // its barriers also publish lg
  const float ps = expf(ls - mx);
  const float z = sum + ps;

  const int grp = tid / DH;
  const int d = tid % DH;
  float a = 0.0f;
  for (int t = grp; t < N; t += CLS_THREADS / DH) {
    const int g = t / L;
    const int l = t % L;
    a = fmaf(bf16_round(lg[t]), bf(base[g * sg + l * sl + voff + d]), a);
  }
  accp[grp][d] = a;
  __syncthreads();
  if (tid < DH) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < CLS_THREADS / DH; ++k) acc += accp[k][tid];
    const float vc = bf(cls[voff + tid]);
    out_cls[b * ocb + h * DH + tid] = __float2bfloat16((acc + ps * vc) / z);
  }
}

}  // namespace

extern "C" int divided_attention_fwd(const void* qkv, i64 sb, i64 sg, i64 sl, const void* qkvc,
                                     i64 scb, const void* seq_bias, const void* row_bias,
                                     i64 rb_b, i64 rb_g, i64 rb_l, void* out, i64 ob, i64 og,
                                     i64 ol, void* out_cls, i64 ocb, int B, int G, int L, int H,
                                     int dh, void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || G > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  const size_t cls_smem = size_t(G) * L * sizeof(float);
  if (cls_smem > 48 * 1024) return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(DH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, G, B);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* qc = static_cast<const bf16*>(qkvc);
  const float* sbias = static_cast<const float*>(seq_bias);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err =
      L <= 64 ? launch_token_rows<keys_per_lane(64)>(grid, s, q, sb, sg, sl, qc, scb, sbias, o,
                                                     ob, og, ol, L, H, scale)
              : launch_token_rows<keys_per_lane(MAXL)>(grid, s, q, sb, sg, sl, qc, scb, sbias, o,
                                                       ob, og, ol, L, H, scale);
  if (err != cudaSuccess) return int(err);
  cls_row_kernel<<<dim3(H, B), CLS_THREADS, cls_smem, s>>>(
      static_cast<const bf16*>(qkv), sb, sg, sl, static_cast<const bf16*>(qkvc), scb,
      static_cast<const float*>(row_bias), rb_b, rb_g, rb_l, static_cast<bf16*>(out_cls), ocb,
      G, L, H, scale);
  return int(cudaGetLastError());
}
