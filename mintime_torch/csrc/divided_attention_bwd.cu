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
// replaced by two launches on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulators), each owning what it writes:
//   2a. attn_bwd_long_rows_kernel, one 4-warp block per (b, g, h, chunk of
//       64 query rows), [k_cls; K] and [v_cls; V] of the group in shared
//       memory, a warp per 16 rows: S = q~ [k_cls; K]^T and
//       dP = dO [v_cls; V]^T tile by tile (16 keys), a first sweep for each
//       row's max, sum and s_dot (online, rescaled), a second for dS and
//       dq = dS [k_cls; K]; writes dq, the rows' (max, sum, s_dot) as fp32
//       scratch (B, G, H, L, 3), and the chunk's part of dk_cls and dv_cls
//       (column 0 of dS^T q~ and P^T dO, summed over its rows in order);
//   2b. attn_bwd_long_cols_kernel, one 4-warp block per (b, g, h, chunk of
//       64 token keys), q and dO of the group in shared memory, a warp per
//       16 keys: S^T and dP^T tile by tile (16 rows), P and dS from the
//       stored row statistics, dK = dS^T q~ and dV = P^T dO, plus the CLS
//       row's terms for each key from launch 1's scalars.
// Each warp reads its own rows' operand (q and dO in 2a, K and V in 2b)
// from device memory straight into A fragments, once; shared memory holds
// only the operand every warp sweeps, staged by 16-byte cp.async into
// unpadded rows whose 16-byte chunks are swizzled by the row, so ldmatrix
// reads it without bank conflicts. That is at most 54 KB at L = 192 and
// 70 KB at 256: three blocks an SM, with registers capped at 170 a thread.
// q~, K, V and dO are exact in bf16, so S and dP match fp32 sums up to
// their order; with dh = 64 the scale is 1/8, a power of two, so q~ = q / 8
// exactly and the launches apply it to S and dK instead of to q. P and dS
// are fp32 (exponentials by __expf, whose relative error near 2^-21 is below
// what the split below keeps); they enter the gradient products as a bf16
// hi/lo pair (x = hi + lo, two products into one fp32 accumulator), about 16
// bits of mantissa. Keys past T and rows past L are padding to 16: padded
// keys take the finite mask value and a probability of 0, padded rows write
// nothing. Sums over rows and over keys run in a fixed order and every
// output is written once: reruns give the same bits. Launch 3 then sums the
// partials of every group and row chunk.
//
// Bound of the long axes: memory as well. At L = 192 (B = 8, G = 8, 6 heads)
// a call moves about 66 MB (20 us at 3.35 TB/s) and does about 6 * 2 L T dh
// FLOP a (b, g, h) on the tensor cores, a few us at the card's rate. What
// sets the time is each warp's chain of products, exponentials and
// shuffles at 12 warps an SM, and the staging: K and V once a row chunk,
// q and dO once a key chunk, from L2.

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
constexpr int SHORT_MAXL = 64;  // longest of attn_bwd_token_rows_kernel
constexpr int MAXT = (SHORT_MAXL + 1 + 31) / 32;  // its keys per lane (CLS + L)
constexpr int TILE = 64;        // query rows (2a) or keys (2b) of a block of the long launches
constexpr int TILE_WARPS = TILE / 16;
constexpr int MIN_BLOCKS = 3;   // blocks an SM: at most 170 registers a thread
constexpr float NEG = -0.7f * 3.402823466e38f;  // the finite mask value
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

using warp_mma::ldmatrix_x4;
using warp_mma::ldmatrix_x4_trans;
using warp_mma::mma_bf16;

// the swizzled tiles, their staging and the A fragments of
// csrc/attn_rows_mma.cuh, shared with the forward
using attn_rows::load_a;
using attn_rows::mma_rows_t;
using attn_rows::pad16;
using attn_rows::stage_rows;
using attn_rows::sw;

// acc (16 x DH, 8 tiles of 8 columns) += (hi + lo) (16 x 16) times rows
// k0 .. k0+15 of the swizzled tile m
__device__ __forceinline__ void mma_split(float acc[DH / 8][4], const uint32_t hi[4],
                                          const uint32_t lo[4], const bf16* m, int k0, int lane) {
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, m + sw(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n * 16 + (lane >> 4) * 8));
    mma_bf16(acc[2 * n], hi, b[0], b[1]);
    mma_bf16(acc[2 * n + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * n], lo, b[0], b[1]);
    mma_bf16(acc[2 * n + 1], lo, b[2], b[3]);
  }
}

// Launch 2a for 64 < L <= 256: dq of a chunk of TILE query rows, the rows'
// softmax statistics and the chunk's part of the CLS key's gradients. With
// dh = 64 the scale 1/8 is a power of two, so q~ = q / 8 exactly: q is
// read as it is and the scale applied to S (and to the dk_cls part).
__global__ void __launch_bounds__(TILE_WARPS * 32, MIN_BLOCKS)
attn_bwd_long_rows_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                          const bf16* __restrict__ qkvc, i64 scb,
                          const float* __restrict__ seq_bias, const bf16* __restrict__ dtok,
                          i64 db, i64 dg, i64 dl, bf16* __restrict__ dqkv, i64 ob, i64 og,
                          i64 ol, float* __restrict__ row_stats, float* __restrict__ kv_part,
                          int G, int L, int H, float scale) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int T = L + 1;  // CLS key + L keys
  const int Tp = pad16(T);
  const int chunks = (L + TILE - 1) / TILE;
  const int h = blockIdx.x;
  const int g = blockIdx.y / chunks;
  const int chunk = blockIdx.y % chunks;
  const int b = blockIdx.z;
  const int r0 = chunk * TILE;
  const int rows = min(TILE, L - r0);
  bf16* ks = reinterpret_cast<bf16*>(lsm);  // [Tp][DH]  k_cls, K, zeros (swizzled)
  bf16* vs = ks + Tp * DH;                  // [Tp][DH]  v_cls, V, zeros (swizzled)
  float* pc = reinterpret_cast<float*>(vs + Tp * DH);  // [TILE] P[r][0]
  float* dsc = pc + TILE;                               // [TILE] dS[r][0]

  const int inner = H * DH;
  const bf16* base = qkv + b * sb + g * sg;
  const bf16* cls = qkvc + b * scb;
  const int qoff = h * DH;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;
  stage_rows(ks, 0, cls + koff, 0, 1, 1);
  stage_rows(ks, 1, base + koff, sl, L, Tp);
  stage_rows(vs, 0, cls + voff, 0, 1, 1);
  stage_rows(vs, 1, base + voff, sl, L, Tp);
  const bf16* qrows = base + r0 * sl + qoff;                    // q of the chunk (unscaled)
  const bf16* drows = dtok + b * db + g * dg + r0 * dl + h * DH;  // dO of the chunk
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp * 16;  // the warp's first row in the chunk
  uint32_t qa[DH / 16][4], da[DH / 16][4];  // loaded while the copies run
  load_a(qa, qrows, sl, wr, rows, lane);
  load_a(da, drows, dl, wr, rows, lane);
  warp_mma::cp_async_wait_all();
  __syncthreads();

  const int grp = lane >> 2;
  const int tig = lane & 3;
  if (wr < rows) {  // warp-uniform
    // this thread's two rows: grp and grp + 8 of the warp's 16
    const int row[2] = {r0 + wr + grp, r0 + wr + grp + 8};
    const float* brow[2] = {nullptr, nullptr};
    if (seq_bias != nullptr)
#pragma unroll
      for (int x = 0; x < 2; ++x) brow[x] = seq_bias + (i64(b) * L + min(row[x], L - 1)) * T;
    // S and dP of keys kb .. kb+15, S scaled and biased, padded keys at NEG
    auto products = [&](float s[2][4], float dp[2][4], int kb) {
      float bias[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // issued before the products, to hide its latency
          const int t = kb + n * 8 + 2 * tig + (i & 1);
          bias[n][i] = brow[i >> 1] != nullptr && t < T ? brow[i >> 1][t] : 0.0f;
        }
      mma_rows_t(s, qa, ks, kb, lane);
      mma_rows_t(dp, da, vs, kb, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = kb + n * 8 + 2 * tig + (i & 1) < T ? fmaf(s[n][i], scale, bias[n][i]) : NEG;
    };

    // sweep 1: each row's max, sum and unnormalised s_dot, online
    float m[2] = {NEG, NEG}, sum[2] = {0.0f, 0.0f}, sdu[2] = {0.0f, 0.0f};
    for (int kb = 0; kb < Tp; kb += 16) {
      float s[2][4], dp[2][4];
      products(s, dp, kb);
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mt[i >> 1] = fmaxf(mt[i >> 1], s[n][i]);
#pragma unroll
      for (int x = 0; x < 2; ++x) {  // the row's four lanes agree on its max
        mt[x] = fmaxf(mt[x], __shfl_xor_sync(0xffffffffu, mt[x], 1));
        mt[x] = fmaxf(mt[x], __shfl_xor_sync(0xffffffffu, mt[x], 2));
        const float alpha = __expf(m[x] - mt[x]);
        sum[x] *= alpha;
        sdu[x] *= alpha;
        m[x] = mt[x];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = kb + n * 8 + 2 * tig + (i & 1);
          const float e = t < T ? __expf(s[n][i] - m[i >> 1]) : 0.0f;
          sum[i >> 1] += e;
          sdu[i >> 1] = fmaf(e, dp[n][i], sdu[i >> 1]);
        }
    }
    float inv[2], sd[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 1);
      sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 2);
      sdu[x] += __shfl_xor_sync(0xffffffffu, sdu[x], 1);
      sdu[x] += __shfl_xor_sync(0xffffffffu, sdu[x], 2);
      inv[x] = 1.0f / sum[x];
      sd[x] = sdu[x] * inv[x];
    }

    // sweep 2: P and dS, dq = dS [k_cls; K]
    float dq[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[n][i] = 0.0f;
    for (int kb = 0; kb < Tp; kb += 16) {
      float s[2][4], dp[2][4];
      products(s, dp, kb);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = kb + n * 8 + 2 * tig + (i & 1);
          const float p = t < T ? __expf(s[n][i] - m[i >> 1]) * inv[i >> 1] : 0.0f;
          dp[n][i] = p * (dp[n][i] - sd[i >> 1]);  // dS
          s[n][i] = p;
        }
      if (kb == 0 && tig == 0) {  // column 0: the CLS key
        pc[wr + grp] = s[0][0];
        dsc[wr + grp] = dp[0][0];
        pc[wr + grp + 8] = s[0][2];
        dsc[wr + grp + 8] = dp[0][2];
      }
      uint32_t hi[4], lo[4];
      warp_mma::split_a(dp, hi, lo);
      mma_split(dq, hi, lo, ks, kb, lane);
    }

    bf16* obase = dqkv + b * ob + g * og;
    float* st = row_stats + ((size_t(b) * G + g) * H + h) * size_t(L) * 3;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (row[x] >= L) continue;
      bf16* orow = obase + row[x] * ol + qoff;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<bf162*>(orow + n * 8 + 2 * tig) =
            __floats2bfloat162_rn(scale * dq[n][2 * x], scale * dq[n][2 * x + 1]);
      if (tig == 0) {
        st[3 * row[x]] = m[x];
        st[3 * row[x] + 1] = sum[x];
        st[3 * row[x] + 2] = sd[x];
      }
    }
  }
  __syncthreads();

  // the CLS key's column over the chunk's rows, summed in order: the chunk's
  // part of dk_cls (dS[:, 0]^T q~) and dv_cls (P[:, 0]^T dO)
  if (threadIdx.x < 2 * DH) {
    const int d = threadIdx.x % DH;
    const bool v = threadIdx.x >= DH;
    const float* w = v ? pc : dsc;
    const bf16* x = v ? drows : qrows;
    const i64 stride = v ? dl : sl;
    float a = 0.0f;
    for (int r = 0; r < rows; ++r) a = fmaf(w[r], bf(x[r * stride + d]), a);
    kv_part[(((size_t(b) * G + g) * chunks + chunk) * H + h) * 2 * DH + threadIdx.x] =
        v ? a : scale * a;
  }
}

// Launch 2b for 64 < L <= 256: dK and dV of a chunk of TILE token keys, with
// the CLS row's terms. q is staged unscaled: the scale goes to S^T and dK.
__global__ void __launch_bounds__(TILE_WARPS * 32, MIN_BLOCKS)
attn_bwd_long_cols_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                          const bf16* __restrict__ qkvc, i64 scb,
                          const float* __restrict__ seq_bias,
                          const float* __restrict__ row_bias, i64 rb_b, i64 rb_g, i64 rb_l,
                          const bf16* __restrict__ dtok, i64 db, i64 dg, i64 dl,
                          const bf16* __restrict__ dcls, i64 dcb, const float* __restrict__ stats,
                          const float* __restrict__ row_stats, bf16* __restrict__ dqkv, i64 ob,
                          i64 og, i64 ol, int G, int L, int H, float scale) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int T = L + 1;
  const int Lp = pad16(L);
  const int chunks = (L + TILE - 1) / TILE;
  const int h = blockIdx.x;
  const int g = blockIdx.y / chunks;
  const int chunk = blockIdx.y % chunks;
  const int b = blockIdx.z;
  const int j0 = chunk * TILE;  // first token key of the chunk (key j0 + 1 of [CLS; tokens])
  const int keys = min(TILE, L - j0);
  bf16* qs = reinterpret_cast<bf16*>(lsm);  // [Lp][DH]  q (unscaled), zeros (swizzled)
  bf16* dos = qs + Lp * DH;                 // [Lp][DH]  dO, zeros (swizzled)
  float* rm = reinterpret_cast<float*>(dos + Lp * DH);  // [Lp] row max
  float* rinv = rm + Lp;                                   // [Lp] 1 / row sum
  float* rsd = rinv + Lp;                                  // [Lp] row s_dot
  float* qc = rsd + Lp;                                    // [DH] q~_cls
  float* dc = qc + DH;                                     // [DH] d_cls

  const int tid = threadIdx.x;
  const int inner = H * DH;
  const bf16* base = qkv + b * sb + g * sg;
  const bf16* cls = qkvc + b * scb;
  const int qoff = h * DH;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;
  const bf16* krows = base + j0 * sl + koff;  // K of the chunk
  const bf16* vrows = base + j0 * sl + voff;  // V of the chunk
  stage_rows(qs, 0, base + qoff, sl, L, Lp);
  stage_rows(dos, 0, dtok + b * db + g * dg + h * DH, dl, L, Lp);
  const float* rst = row_stats + ((size_t(b) * G + g) * H + h) * size_t(L) * 3;
  for (int r = tid; r < Lp; r += TILE_WARPS * 32) {
    rm[r] = r < L ? rst[3 * r] : 0.0f;
    rinv[r] = r < L ? 1.0f / rst[3 * r + 1] : 0.0f;
    rsd[r] = r < L ? rst[3 * r + 2] : 0.0f;
  }
  if (tid < DH) {
    qc[tid] = bf16_round(bf(cls[qoff + tid]) * scale);
    dc[tid] = bf(dcls[b * dcb + h * DH + tid]);
  }
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wk = warp * 16;  // the warp's first key in the chunk
  uint32_t ka[DH / 16][4], va[DH / 16][4];  // loaded while the copies run
  load_a(ka, krows, sl, wk, keys, lane);
  load_a(va, vrows, sl, wk, keys, lane);
  warp_mma::cp_async_wait_all();
  __syncthreads();
  if (wk >= keys) return;  // warp-uniform; no barrier follows

  // the CLS row's terms for this thread's two keys, from launch 1's scalars:
  // q~_cls . k and d_cls . v over the key's fragments, summed over its 4 lanes
  float cp[2], cdl[2];
  {
    float lr[2] = {0.0f, 0.0f}, dp[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < DH / 16; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k * 16 + (i >> 1) * 8 + 2 * tig;
        const float2 kf = __bfloat1622float2(*reinterpret_cast<const bf162*>(&ka[k][i]));
        const float2 vf = __bfloat1622float2(*reinterpret_cast<const bf162*>(&va[k][i]));
        lr[i & 1] = fmaf(qc[c], kf.x, fmaf(qc[c + 1], kf.y, lr[i & 1]));
        dp[i & 1] = fmaf(dc[c], vf.x, fmaf(dc[c + 1], vf.y, dp[i & 1]));
      }
    const float* st = stats + (size_t(b) * H + h) * 3;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        lr[x] += __shfl_xor_sync(0xffffffffu, lr[x], o);
        dp[x] += __shfl_xor_sync(0xffffffffu, dp[x], o);
      }
      const int kk = min(wk + grp + 8 * x, keys - 1);
      if (row_bias != nullptr) lr[x] += row_bias[b * rb_b + g * rb_g + (j0 + kk) * rb_l];
      cp[x] = expf(lr[x] - st[0]) / st[1];
      cdl[x] = cp[x] * (dp[x] - st[2]);
    }
  }
  // this thread's two keys of [CLS; tokens]: grp and grp + 8 of the warp's 16
  const int key[2] = {j0 + wk + grp + 1, j0 + wk + grp + 9};
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.0f;
  for (int rb = 0; rb < Lp; rb += 16) {
    float s[2][4], dp[2][4];  // S^T and dP^T: keys x rows rb .. rb+15
    float bias[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // issued before the products, to hide its latency
        const int r = rb + n * 8 + 2 * tig + (i & 1);
        const int t = key[i >> 1];
        bias[n][i] = seq_bias != nullptr && r < L && t < T
                         ? seq_bias[(i64(b) * L + r) * T + t] : 0.0f;
      }
    mma_rows_t(s, ka, qs, rb, lane);
    mma_rows_t(dp, va, dos, rb, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb + n * 8 + 2 * tig + (i & 1);
        const float p = r < L && key[i >> 1] < T
                            ? __expf(fmaf(s[n][i], scale, bias[n][i]) - rm[r]) * rinv[r] : 0.0f;
        dp[n][i] = p * (dp[n][i] - rsd[r]);  // dS^T
        s[n][i] = p;                         // P^T
      }
    uint32_t hi[4], lo[4];
    warp_mma::split_a(dp, hi, lo);
    mma_split(dk, hi, lo, qs, rb, lane);
    warp_mma::split_a(s, hi, lo);
    mma_split(dv, hi, lo, dos, rb, lane);
  }

  bf16* obase = dqkv + b * ob + g * og;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int kk = wk + grp + 8 * x;  // key in the chunk
    if (kk >= keys) continue;
    bf16* orow = obase + (j0 + kk) * ol;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int d = n * 8 + 2 * tig;
      *reinterpret_cast<bf162*>(orow + koff + d) = __floats2bfloat162_rn(
          fmaf(cdl[x], qc[d], scale * dk[n][2 * x]),
          fmaf(cdl[x], qc[d + 1], scale * dk[n][2 * x + 1]));
      *reinterpret_cast<bf162*>(orow + voff + d) = __floats2bfloat162_rn(
          fmaf(cp[x], dc[d], dv[n][2 * x]), fmaf(cp[x], dc[d + 1], dv[n][2 * x + 1]));
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

size_t long_rows_smem(int L) {
  return sizeof(bf16) * 2 * size_t(pad16(L + 1)) * DH + sizeof(float) * 2 * TILE;
}

size_t long_cols_smem(int L) {
  const size_t Lp = pad16(L);
  return sizeof(bf16) * 2 * Lp * DH + sizeof(float) * (3 * Lp + 2 * DH);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Scratch from the caller, fp32: stats (B*H*3), cls_kv (B*H*2*dh), kv_part
// (B*G*C*H*2*dh) and, for 64 < L, row_stats (B*G*H*L*3), where C is 1 for L
// <= 64 and ceil(L / 64) above. Above L = 64 the three bf16 inputs and their
// strides (but the last) must be 16-byte aligned.
extern "C" int divided_attention_bwd(const void* qkv, i64 sb, i64 sg, i64 sl, const void* qkvc,
                                     i64 scb, const void* seq_bias, const void* row_bias,
                                     i64 rb_b, i64 rb_g, i64 rb_l, const void* dtok, i64 db,
                                     i64 dg, i64 dl, const void* dcls, i64 dcb, void* dqkv,
                                     i64 ob, i64 og, i64 ol, void* dqkvc, i64 ocb, void* stats,
                                     void* cls_kv, void* kv_part, void* row_stats, int B, int G,
                                     int L, int H, int dh, void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || G > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  const size_t cls_smem = 2 * size_t(G) * L * sizeof(float);
  if (cls_smem > 96 * 1024) return int(cudaErrorInvalidValue);
  const bool long_rows = L > SHORT_MAXL;
  if (long_rows && (!aligned16(qkv) || !aligned16(qkvc) || !aligned16(dtok) || row_stats == nullptr
                    || (sb | sg | sl | scb | db | dg | dl) % 8 != 0))
    return int(cudaErrorMisalignedAddress);
  const int chunks = long_rows ? (L + TILE - 1) / TILE : 1;
  if (G * chunks > 65535) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_cls_row_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(cls_smem));
  if (err != cudaSuccess) return int(err);
  if (long_rows) {
    err = cudaFuncSetAttribute(attn_bwd_long_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(long_rows_smem(L)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_long_cols_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(long_cols_smem(L)));
  } else {
    err = cudaFuncSetAttribute(attn_bwd_token_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(token_smem(L)));
  }
  if (err != cudaSuccess) return int(err);
  const float scale = 1.0f / sqrtf(float(DH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* qc = static_cast<const bf16*>(qkvc);
  const float* sqb = static_cast<const float*>(seq_bias);
  const float* rb = static_cast<const float*>(row_bias);
  const bf16* dt = static_cast<const bf16*>(dtok);
  const bf16* dc = static_cast<const bf16*>(dcls);
  bf16* dq = static_cast<bf16*>(dqkv);
  bf16* dqc = static_cast<bf16*>(dqkvc);
  float* st = static_cast<float*>(stats);
  float* ckv = static_cast<float*>(cls_kv);
  float* part = static_cast<float*>(kv_part);
  float* rst = static_cast<float*>(row_stats);

  attn_bwd_cls_row_kernel<<<dim3(H, B), CLS_THREADS, cls_smem, s>>>(
      q, sb, sg, sl, qc, scb, rb, rb_b, rb_g, rb_l, dc, dcb, dqc, ocb, st, ckv, G, L, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  if (long_rows) {
    attn_bwd_long_rows_kernel<<<dim3(H, G * chunks, B), TILE_WARPS * 32, long_rows_smem(L), s>>>(
        q, sb, sg, sl, qc, scb, sqb, dt, db, dg, dl, dq, ob, og, ol, rst, part, G, L, H, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    attn_bwd_long_cols_kernel<<<dim3(H, G * ((L + TILE - 1) / TILE), B), TILE_WARPS * 32,
                                long_cols_smem(L), s>>>(
        q, sb, sg, sl, qc, scb, sqb, rb, rb_b, rb_g, rb_l, dt, db, dg, dl, dc, dcb, st, rst, dq,
        ob, og, ol, G, L, H, scale);
  } else {
    attn_bwd_token_rows_kernel<<<dim3(H, G, B), TOK_THREADS, token_smem(L), s>>>(
        q, sb, sg, sl, qc, scb, sqb, rb, rb_b, rb_g, rb_l, dt, db, dg, dl, dc, dcb, st, dq, ob,
        og, ol, part, G, L, H, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // the partials of every group and row chunk, in order
  attn_bwd_cls_reduce_kernel<<<dim3(H, B), 2 * DH, 0, s>>>(ckv, part, dqc, ocb, G * chunks, H);
  return int(cudaGetLastError());
}
