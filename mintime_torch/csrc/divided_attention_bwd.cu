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
// Launch 2 keeps P and dS of the group in shared memory, [L][L+1] fp32 each:
// 99 KB a block at L = 64 but 487 KB at L = 192. For 64 < L <= 256 it is
// replaced by attn_bwd_token_rows_long_kernel, whose shared memory grows
// with L only: q~, K, V and dO of the group in bf16 (all four are exact in
// bf16; 139 KB at L = 256). One 16-warp block per (b, g, h) makes two
// passes, recomputing the probabilities in registers each time:
//   a. a warp per query row: logits, softmax, dS in registers (lane t for
//      keys t, t + 32, ...), dq from dS broadcast by shuffles, and the row's
//      max, sum and s_dot kept in shared memory;
//   b. a warp per key t (the CLS key first): lane r recomputes P[r][t] and
//      dS[r][t] from the row's scalars, and the warp sums dk_t and dv_t over
//      the rows in order, a lane owning two dimensions (no atomics); the CLS
//      key's sums are the group's partial dk_cls and dv_cls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int DH = 64;          // head width
constexpr int MAXL = 256;       // longest attended sequence of the token rows
constexpr int SHORT_MAXL = 64;  // longest of attn_bwd_token_rows_kernel
constexpr int MAXT = (SHORT_MAXL + 1 + 31) / 32;  // its keys per lane (CLS + L)
constexpr int LONG_NT = (MAXL + 1 + 31) / 32;     // the long kernel's keys (and rows) per lane
constexpr int LONG_WARPS = 16;
constexpr int KVLD = DH + 2;    // padded bf16 rows (33 words): lane t reads row t conflict-free
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

__device__ __forceinline__ float dot_bf16(const bf16* a, const bf16* b) {
  const bf162* a2 = reinterpret_cast<const bf162*>(a);
  const bf162* b2 = reinterpret_cast<const bf162*>(b);
  float s = 0.0f;
#pragma unroll 8
  for (int d2 = 0; d2 < DH / 2; ++d2) {
    const float2 x = __bfloat1622float2(a2[d2]);
    const float2 y = __bfloat1622float2(b2[d2]);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

__device__ __forceinline__ float2 pair(const bf16* row, int lane) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(row + 2 * lane));
}

// Launch 2 for 64 < L <= 256; the same results as attn_bwd_token_rows_kernel.
__global__ void __launch_bounds__(LONG_WARPS * 32)
attn_bwd_token_rows_long_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                                const bf16* __restrict__ qkvc, i64 scb,
                                const float* __restrict__ seq_bias,
                                const float* __restrict__ row_bias, i64 rb_b, i64 rb_g,
                                i64 rb_l, const bf16* __restrict__ dtok, i64 db, i64 dg, i64 dl,
                                const bf16* __restrict__ dcls, i64 dcb,
                                const float* __restrict__ stats, bf16* __restrict__ dqkv, i64 ob,
                                i64 og, i64 ol, float* __restrict__ kv_part, int G, int L, int H,
                                float scale) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int T = L + 1;  // CLS key + L keys
  bf16* ks = reinterpret_cast<bf16*>(lsm);  // [T][KVLD]  k_cls, K
  bf16* vs = ks + T * KVLD;                 // [T][KVLD]  v_cls, V
  bf16* qs = vs + T * KVLD;                 // [L][KVLD]  q~
  bf16* dos = qs + L * KVLD;                // [L][KVLD]  dO
  float* rst = reinterpret_cast<float*>(dos + L * KVLD);  // [L][3] max, sum, s_dot
  float* qc = rst + 3 * L;                  // [DH]       q~_cls
  float* dc = qc + DH;                      // [DH]       d_cls

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

  for (int i = tid; i < T * DH; i += LONG_WARPS * 32) {
    const int r = i / DH;
    const int d = i % DH;
    const bf16* row = r == 0 ? cls : base + (r - 1) * sl;
    ks[r * KVLD + d] = row[koff + d];
    vs[r * KVLD + d] = row[voff + d];
    if (r > 0) {
      qs[(r - 1) * KVLD + d] = __float2bfloat16(bf(row[qoff + d]) * scale);
      dos[(r - 1) * KVLD + d] = dbase[(r - 1) * dl + h * DH + d];
    }
  }
  if (tid < DH) {
    qc[tid] = bf16_round(bf(cls[qoff + tid]) * scale);
    dc[tid] = bf(dcls[b * dcb + h * DH + tid]);
  }
  __syncthreads();

  bf16* obase = dqkv + b * ob + g * og;
  // a. a warp per query row r, lane t for keys t, t + 32, ...
  for (int r = warp; r < L; r += LONG_WARPS) {
    const bf16* qrow = qs + r * KVLD;
    const bf16* drow = dos + r * KVLD;
    float p[LONG_NT], ds[LONG_NT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < LONG_NT; ++j) {
      const int t = lane + 32 * j;
      float s = -INFINITY;
      if (t < T) {
        s = dot_bf16(qrow, ks + t * KVLD);
        if (seq_bias != nullptr) s += seq_bias[(i64(b) * L + r) * T + t];
      }
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < LONG_NT; ++j) {
      const int t = lane + 32 * j;
      const float e = t < T ? expf(p[j] - mx) : 0.0f;
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float sd = 0.0f;
#pragma unroll
    for (int j = 0; j < LONG_NT; ++j) {
      const int t = lane + 32 * j;
      p[j] /= sum;
      ds[j] = t < T ? dot_bf16(drow, vs + t * KVLD) : 0.0f;
      sd += p[j] * ds[j];
    }
    sd = warp_sum(sd);
#pragma unroll
    for (int j = 0; j < LONG_NT; ++j) ds[j] = p[j] * (ds[j] - sd);

    float a0 = 0.0f, a1 = 0.0f;  // dq of dimensions 2*lane, 2*lane + 1
#pragma unroll
    for (int j = 0; j < LONG_NT; ++j) {
      if (32 * j >= T) continue;  // warp-uniform; j stays a constant index
      for (int u = 0; u < 32 && 32 * j + u < T; ++u) {
        const float w = __shfl_sync(0xffffffffu, ds[j], u);
        const float2 k = pair(ks + (32 * j + u) * KVLD, lane);
        a0 = fmaf(w, k.x, a0);
        a1 = fmaf(w, k.y, a1);
      }
    }
    *reinterpret_cast<bf162*>(obase + r * ol + qoff + 2 * lane) =
        __floats2bfloat162_rn(scale * a0, scale * a1);
    if (lane == 0) {
      rst[3 * r] = mx;
      rst[3 * r + 1] = sum;
      rst[3 * r + 2] = sd;
    }
  }
  __syncthreads();

  // b. a warp per key t (0 = the CLS key), lane r for rows r, r + 32, ...
  const float* st = stats + (size_t(b) * H + h) * 3;
  for (int t = warp; t < T; t += LONG_WARPS) {
    const bf16* krow = ks + t * KVLD;
    const bf16* vrow = vs + t * KVLD;
    float p[LONG_NT], ds[LONG_NT];
#pragma unroll
    for (int j = 0; j < LONG_NT; ++j) {
      const int r = lane + 32 * j;
      p[j] = ds[j] = 0.0f;
      if (r < L) {
        float s = dot_bf16(qs + r * KVLD, krow);
        if (seq_bias != nullptr) s += seq_bias[(i64(b) * L + r) * T + t];
        const float pr = expf(s - rst[3 * r]) / rst[3 * r + 1];
        p[j] = pr;
        ds[j] = pr * (dot_bf16(dos + r * KVLD, vrow) - rst[3 * r + 2]);
      }
    }
    float ak0 = 0.0f, ak1 = 0.0f, av0 = 0.0f, av1 = 0.0f;
    const float2 q2 = make_float2(qc[2 * lane], qc[2 * lane + 1]);
    const float2 d2 = make_float2(dc[2 * lane], dc[2 * lane + 1]);
    if (t > 0) {  // the CLS row's terms for key t, from launch 1's scalars
      const float2 k = pair(krow, lane);
      const float2 v = pair(vrow, lane);
      float lr = warp_sum(q2.x * k.x + q2.y * k.y);
      const float dp = warp_sum(d2.x * v.x + d2.y * v.y);
      if (row_bias != nullptr) lr += row_bias[b * rb_b + g * rb_g + (t - 1) * rb_l];
      const float cp = expf(lr - st[0]) / st[1];
      const float cdl = cp * (dp - st[2]);
      ak0 = cdl * q2.x;
      ak1 = cdl * q2.y;
      av0 = cp * d2.x;
      av1 = cp * d2.y;
    }
#pragma unroll
    for (int j = 0; j < LONG_NT; ++j) {
      if (32 * j >= L) continue;  // warp-uniform; j stays a constant index
      for (int u = 0; u < 32 && 32 * j + u < L; ++u) {
        const float ws = __shfl_sync(0xffffffffu, ds[j], u);
        const float wp = __shfl_sync(0xffffffffu, p[j], u);
        const float2 q = pair(qs + (32 * j + u) * KVLD, lane);
        const float2 o = pair(dos + (32 * j + u) * KVLD, lane);
        ak0 = fmaf(ws, q.x, ak0);
        ak1 = fmaf(ws, q.y, ak1);
        av0 = fmaf(wp, o.x, av0);
        av1 = fmaf(wp, o.y, av1);
      }
    }
    if (t == 0) {
      float* part = kv_part + ((size_t(b) * G + g) * H + h) * 2 * DH;
      part[2 * lane] = ak0;
      part[2 * lane + 1] = ak1;
      part[DH + 2 * lane] = av0;
      part[DH + 2 * lane + 1] = av1;
    } else {
      bf16* orow = obase + (t - 1) * ol;
      *reinterpret_cast<bf162*>(orow + koff + 2 * lane) = __floats2bfloat162_rn(ak0, ak1);
      *reinterpret_cast<bf162*>(orow + voff + 2 * lane) = __floats2bfloat162_rn(av0, av1);
    }
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

size_t long_smem(int L) {
  const size_t T = size_t(L) + 1;
  return sizeof(bf16) * (2 * T + 2 * size_t(L)) * KVLD + sizeof(float) * (3 * size_t(L) + 2 * DH);
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
  const bool long_rows = L > SHORT_MAXL;
  const size_t tok_smem = long_rows ? long_smem(L) : token_smem(L);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_cls_row_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(cls_smem));
  if (err != cudaSuccess) return int(err);
  err = long_rows ? cudaFuncSetAttribute(attn_bwd_token_rows_long_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(tok_smem))
                  : cudaFuncSetAttribute(attn_bwd_token_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(tok_smem));
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
  if (long_rows)
    attn_bwd_token_rows_long_kernel<<<dim3(H, G, B), LONG_WARPS * 32, tok_smem, s>>>(
        q, sb, sg, sl, qc, scb, static_cast<const float*>(seq_bias), rb, rb_b, rb_g, rb_l,
        static_cast<const bf16*>(dtok), db, dg, dl, dc, dcb, st, static_cast<bf16*>(dqkv), ob, og,
        ol, part, G, L, H, scale);
  else
    attn_bwd_token_rows_kernel<<<dim3(H, G, B), TOK_THREADS, tok_smem, s>>>(
        q, sb, sg, sl, qc, scb, static_cast<const float*>(seq_bias), rb, rb_b, rb_g, rb_l,
        static_cast<const bf16*>(dtok), db, dg, dl, dc, dcb, st, static_cast<bf16*>(dqkv), ob, og,
        ol, part, G, L, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  attn_bwd_cls_reduce_kernel<<<dim3(H, B), 2 * DH, 0, s>>>(ckv, part, dqc, ocb, G, H);
  return int(cudaGetLastError());
}
