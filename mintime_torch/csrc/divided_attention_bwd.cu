// Backward of the divided space-time attention with a CLS row for Hopper
// (sm_90a), bf16 in and out, fp32 inside.
//
// Replaces: mintime_tpu/ops/pallas_attention.py::_divided_bwd_kernel
// (reached through _bwd_call and the custom_vjp of
// _divided_attention_core). Inputs are the forward's packed qkv (B, G, L,
// 3*H*dh) with columns [q | k | v] (read through any (B, G, L) strides), the
// CLS row's qkv (B, 3*H*dh), the biases, and the cotangents of the token
// outputs (B, G, L, H*dh, any strides) and of the CLS output (B, H*dh).
// Outputs are d_qkv in the layout of qkv and d_qkvc (B, 3*H*dh). With q~ the
// bf16-rounded q * dh^-0.5 and softmaxes recomputed in fp32:
//   token rows of group g:  P = softmax([q~ k_cls | q~ K^T] + seq_bias)
//     dS = P * (dO [v_cls | V]^T - rowsum(dO [v_cls | V]^T * P))
//     dq = dh^-0.5 dS [k_cls; K],  dK += dS^T q~,  dV += P^T dO,
//     and dk_cls, dv_cls collect column 0 of dS^T q~ and P^T dO over every g;
//   CLS row:  p = softmax over [self | the G*L keys + row_bias] of q~_cls,
//     s_dot = sum p * (d_cls . v), dl = p * (d_cls . v - s_dot),
//     dq_cls = dh^-0.5 sum dl k,  dk += dl q~_cls,  dv += p d_cls.
// Bias gradients are not produced (the JAX package returns zeros). Masks are
// finite biases (-0.7 * f32 max), never -inf.
//
// Bound on an H100: memory. At B = 8 (G*L = 784, H*dh = 512) a call reads qkv
// (19.3 MB) and the token cotangent (6.4 MB) and writes d_qkv (19.3 MB):
// about 14 us at 3.35 TB/s; its arithmetic is under a GFLOP.
//
// Design. The TPU kernel held a whole batch slice in VMEM and summed over
// groups inside one grid cell. Here three launches in order, each owning
// its outputs (deterministic, no atomics):
//   1. attn_bwd_cls_row_kernel, one 8-warp block per (b, h): recomputes the
//      CLS row's logits over all G*L keys in shared memory, its max, sum and
//      s_dot, writes dq_cls, and leaves (max, sum, s_dot) and the CLS row's
//      own terms of dk_cls and dv_cls for the later launches;
//   2. attn_bwd_token_rows_kernel, one 4-warp block per (b, g, h): stages
//      q~, K, V and dO of the group (CLS key as row 0) in shared memory as
//      fp32, recomputes each row's softmax with a warp per query row, adds
//      the CLS row's terms to each key from the scalars of launch 1, writes
//      dq, dk, dv, and writes the group's partial dk_cls and dv_cls;
//   3. attn_bwd_cls_reduce_kernel, per (b, h): sums the partials over g in
//      order and writes dk_cls and dv_cls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef long long i64;

namespace {

constexpr int DH = 64;          // head width
constexpr int MAXL = 64;        // longest attended sequence of the token rows
constexpr int MAXT = (MAXL + 1 + 31) / 32;  // keys per lane (CLS + L)
constexpr int TOK_WARPS = 4;
constexpr int TOK_THREADS = TOK_WARPS * 32;
constexpr int CLS_THREADS = 256;
constexpr int KLD = DH + 1;     // padded fp32 rows: lane t reads row t conflict-free

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
attn_bwd_cls_row_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                        const bf16* __restrict__ qkvc, i64 scb,
                        const float* __restrict__ row_bias, i64 rb_b, i64 rb_g, i64 rb_l,
                        const bf16* __restrict__ dcls, i64 dcb, bf16* __restrict__ dqkvc,
                        i64 ocb, float* __restrict__ stats, float* __restrict__ cls_kv, int G,
                        int L, int H, float scale) {
  extern __shared__ float dyn[];  // p (G*L), then d_cls . v (G*L)
  __shared__ float qs[DH];
  __shared__ float dcs[DH];
  __shared__ float red[CLS_THREADS / 32];
  __shared__ float accp[CLS_THREADS / DH][DH];
  __shared__ float self_logit, self_dps;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int inner = H * DH;
  const int N = G * L;
  float* pr = dyn;
  float* dpr = dyn + N;
  const bf16* base = qkv + b * sb;
  const bf16* cls = qkvc + b * scb;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;

  if (tid < DH) {
    qs[tid] = bf16_round(bf(cls[h * DH + tid]) * scale);
    dcs[tid] = bf(dcls[b * dcb + h * DH + tid]);
  }
  __syncthreads();

  if (warp == 0) {
    const float s = warp_sum(qs[lane] * bf(cls[koff + lane]) +
                             qs[lane + 32] * bf(cls[koff + lane + 32]));
    if (lane == 0) self_logit = s;
  } else if (warp == 1) {
    const float s = warp_sum(dcs[lane] * bf(cls[voff + lane]) +
                             dcs[lane + 32] * bf(cls[voff + lane + 32]));
    if (lane == 0) self_dps = s;
  }
  for (int t = warp; t < N; t += CLS_THREADS / 32) {
    const bf16* row = base + (t / L) * sg + (t % L) * sl;
    const float s = warp_sum(qs[lane] * bf(row[koff + lane]) + qs[lane + 32] * bf(row[koff + lane + 32]));
    const float dp = warp_sum(dcs[lane] * bf(row[voff + lane]) +
                              dcs[lane + 32] * bf(row[voff + lane + 32]));
    if (lane == 0) {
      pr[t] = s + (row_bias != nullptr
                       ? row_bias[b * rb_b + (t / L) * rb_g + (t % L) * rb_l] : 0.0f);
      dpr[t] = dp;
    }
  }
  __syncthreads();

  const float ls = self_logit;
  const float dps = self_dps;
  float mx = ls;
  for (int t = tid; t < N; t += CLS_THREADS) mx = fmaxf(mx, pr[t]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.0f;
  for (int t = tid; t < N; t += CLS_THREADS) {
    const float e = expf(pr[t] - mx);
    pr[t] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  const float z = sum + expf(ls - mx);
  const float ps = expf(ls - mx) / z;
  float sd = 0.0f;
  for (int t = tid; t < N; t += CLS_THREADS) {
    const float p = pr[t] / z;
    pr[t] = p;
    sd += p * dpr[t];
  }
  const float s_dot = block_reduce<false>(sd, red) + ps * dps;
  for (int t = tid; t < N; t += CLS_THREADS) pr[t] = pr[t] * (dpr[t] - s_dot);  // dl
  const float dls = ps * (dps - s_dot);
  __syncthreads();

  const int grp = tid / DH;
  const int d = tid % DH;
  float a = 0.0f;
  for (int t = grp; t < N; t += CLS_THREADS / DH)
    a = fmaf(pr[t], bf(base[(t / L) * sg + (t % L) * sl + koff + d]), a);
  accp[grp][d] = a;
  __syncthreads();
  if (tid < DH) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < CLS_THREADS / DH; ++k) acc += accp[k][tid];
    acc += dls * bf(cls[koff + tid]);
    dqkvc[b * ocb + h * DH + tid] = __float2bfloat16(scale * acc);
    float* kv = cls_kv + (size_t(b) * H + h) * 2 * DH;
    kv[tid] = dls * qs[tid];
    kv[DH + tid] = ps * dcs[tid];
  }
  if (tid == 0) {
    float* st = stats + (size_t(b) * H + h) * 3;
    st[0] = mx;
    st[1] = z;
    st[2] = s_dot;
  }
}

__global__ void __launch_bounds__(TOK_THREADS)
attn_bwd_token_rows_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                           const bf16* __restrict__ qkvc, i64 scb,
                           const float* __restrict__ seq_bias, const float* __restrict__ row_bias,
                           i64 rb_b, i64 rb_g, i64 rb_l, const bf16* __restrict__ dtok, i64 db,
                           i64 dg, i64 dl, const bf16* __restrict__ dcls, i64 dcb,
                           const float* __restrict__ stats, bf16* __restrict__ dqkv, i64 ob,
                           i64 og, i64 ol, float* __restrict__ kv_part, int G, int L, int H,
                           float scale) {
  extern __shared__ float sm[];
  const int T = L + 1;  // CLS key + L keys
  float* qs = sm;                 // [L][KLD]   q~
  float* dos = qs + L * KLD;      // [L][KLD]   dO
  float* ks = dos + L * KLD;      // [T][KLD]   k_cls, K
  float* vs = ks + T * KLD;       // [T][KLD]   v_cls, V
  float* P = vs + T * KLD;        // [L][T]     token-row probabilities
  float* S = P + L * T;           // [L][T]     dS
  float* cdl = S + L * T;         // [L]        CLS-row dl of each key
  float* cp = cdl + L;            // [L]        CLS-row p of each key
  float* qc = cp + L;             // [DH]       q~_cls
  float* dc = qc + DH;            // [DH]       d_cls

  const int h = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int inner = H * DH;
  const bf16* base = qkv + b * sb + g * sg;
  const bf16* cls = qkvc + b * scb;
  const bf16* dbase = dtok + b * db + g * dg;
  const int qoff = h * DH;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;

  for (int i = tid; i < T * DH; i += TOK_THREADS) {
    const int r = i / DH;
    const int d = i % DH;
    const bf16* row = r == 0 ? cls : base + (r - 1) * sl;
    ks[r * KLD + d] = bf(row[koff + d]);
    vs[r * KLD + d] = bf(row[voff + d]);
    if (r > 0) {
      qs[(r - 1) * KLD + d] = bf16_round(bf(row[qoff + d]) * scale);
      dos[(r - 1) * KLD + d] = bf(dbase[(r - 1) * dl + h * DH + d]);
    }
  }
  if (tid < DH) {
    qc[tid] = bf16_round(bf(cls[qoff + tid]) * scale);
    dc[tid] = bf(dcls[b * dcb + h * DH + tid]);
  }
  __syncthreads();

  // token rows: a warp per query row, lane t for key t
  for (int r = warp; r < L; r += TOK_WARPS) {
    float logit[MAXT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      float s = -INFINITY;
      if (t < T) {
        float a = 0.0f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) a = fmaf(qs[r * KLD + d], ks[t * KLD + d], a);
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
    float dp[MAXT];
    float sd = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      logit[j] /= sum;
      float a = 0.0f;
      if (t < T) {
#pragma unroll 16
        for (int d = 0; d < DH; ++d) a = fmaf(dos[r * KLD + d], vs[t * KLD + d], a);
      }
      dp[j] = a;
      sd += logit[j] * a;
    }
    sd = warp_sum(sd);
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      if (t < T) {
        P[r * T + t] = logit[j];
        S[r * T + t] = logit[j] * (dp[j] - sd);
      }
    }
  }

  // the CLS row's terms for each key of the group, from launch 1's scalars
  const float* st = stats + (size_t(b) * H + h) * 3;
  for (int j = tid; j < L; j += TOK_THREADS) {
    float lr = 0.0f, dp = 0.0f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      lr = fmaf(qc[d], ks[(j + 1) * KLD + d], lr);
      dp = fmaf(dc[d], vs[(j + 1) * KLD + d], dp);
    }
    if (row_bias != nullptr) lr += row_bias[b * rb_b + g * rb_g + j * rb_l];
    const float p = expf(lr - st[0]) / st[1];
    cp[j] = p;
    cdl[j] = p * (dp - st[2]);
  }
  __syncthreads();

  bf16* obase = dqkv + b * ob + g * og;
  for (int i = tid; i < L * DH; i += TOK_THREADS) {
    const int r = i / DH;
    const int d = i % DH;
    float aq = 0.0f;
    for (int t = 0; t < T; ++t) aq = fmaf(S[r * T + t], ks[t * KLD + d], aq);
    float ak = cdl[r] * qc[d];
    float av = cp[r] * dc[d];
    for (int q = 0; q < L; ++q) {
      ak = fmaf(S[q * T + r + 1], qs[q * KLD + d], ak);
      av = fmaf(P[q * T + r + 1], dos[q * KLD + d], av);
    }
    bf16* orow = obase + r * ol;
    orow[qoff + d] = __float2bfloat16(scale * aq);
    orow[koff + d] = __float2bfloat16(ak);
    orow[voff + d] = __float2bfloat16(av);
  }
  if (tid < DH) {
    float ak = 0.0f, av = 0.0f;
    for (int q = 0; q < L; ++q) {
      ak = fmaf(S[q * T], qs[q * KLD + tid], ak);
      av = fmaf(P[q * T], dos[q * KLD + tid], av);
    }
    float* part = kv_part + ((size_t(b) * G + g) * H + h) * 2 * DH;
    part[tid] = ak;
    part[DH + tid] = av;
  }
}

// dk_cls and dv_cls: the CLS row's own terms plus the groups' partials, in order
__global__ void attn_bwd_cls_reduce_kernel(const float* __restrict__ cls_kv,
                                           const float* __restrict__ kv_part,
                                           bf16* __restrict__ dqkvc, i64 ocb, int G, int H) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int e = threadIdx.x;  // 0 .. 2*DH-1: k then v
  float a = cls_kv[(size_t(b) * H + h) * 2 * DH + e];
  for (int g = 0; g < G; ++g) a += kv_part[((size_t(b) * G + g) * H + h) * 2 * DH + e];
  dqkvc[b * ocb + (1 + e / DH) * H * DH + h * DH + e % DH] = __float2bfloat16(a);
}

size_t token_smem(int L) {
  const size_t T = size_t(L) + 1;
  return sizeof(float) * ((2 * size_t(L) + 2 * T) * KLD + 2 * size_t(L) * T + 2 * size_t(L) + 2 * DH);
}

}  // namespace

// Scratch from the caller, fp32: stats (B*H*3), cls_kv (B*H*2*dh),
// kv_part (B*G*H*2*dh).
extern "C" int divided_attention_bwd(const void* qkv, i64 sb, i64 sg, i64 sl, const void* qkvc,
                                     i64 scb, const void* seq_bias, const void* row_bias,
                                     i64 rb_b, i64 rb_g, i64 rb_l, const void* dtok, i64 db,
                                     i64 dg, i64 dl, const void* dcls, i64 dcb, void* dqkv,
                                     i64 ob, i64 og, i64 ol, void* dqkvc, i64 ocb, void* stats,
                                     void* cls_kv, void* kv_part, int B, int G, int L, int H,
                                     int dh, void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || G > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  const size_t cls_smem = 2 * size_t(G) * L * sizeof(float);
  if (cls_smem > 96 * 1024) return int(cudaErrorInvalidValue);
  const size_t tok_smem = token_smem(L);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_cls_row_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(cls_smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(attn_bwd_token_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(tok_smem));
  if (err != cudaSuccess) return int(err);
  const float scale = 1.0f / sqrtf(float(DH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* qc = static_cast<const bf16*>(qkvc);
  const float* rb = static_cast<const float*>(row_bias);
  const bf16* dc = static_cast<const bf16*>(dcls);
  bf16* dqc = static_cast<bf16*>(dqkvc);
  float* st = static_cast<float*>(stats);
  float* ckv = static_cast<float*>(cls_kv);
  float* part = static_cast<float*>(kv_part);

  attn_bwd_cls_row_kernel<<<dim3(H, B), CLS_THREADS, cls_smem, s>>>(
      q, sb, sg, sl, qc, scb, rb, rb_b, rb_g, rb_l, dc, dcb, dqc, ocb, st, ckv, G, L, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  attn_bwd_token_rows_kernel<<<dim3(H, G, B), TOK_THREADS, tok_smem, s>>>(
      q, sb, sg, sl, qc, scb, static_cast<const float*>(seq_bias), rb, rb_b, rb_g, rb_l,
      static_cast<const bf16*>(dtok), db, dg, dl, dc, dcb, st, static_cast<bf16*>(dqkv), ob, og,
      ol, part, G, L, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  attn_bwd_cls_reduce_kernel<<<dim3(H, B), 2 * DH, 0, s>>>(ckv, part, dqc, ocb, G, H);
  return int(cudaGetLastError());
}
