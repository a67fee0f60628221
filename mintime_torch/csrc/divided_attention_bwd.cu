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
// groups inside one grid cell. Here six launches in order, each owning what
// it writes (deterministic, no atomics), at every L from 1 to 256:
//   1. The CLS row in three launches over cls_chunks chunks of the G*L keys
//      (as the forward's CLS row, csrc/divided_attention.cu), with fp32
//      scratch per (b, h) from the wrapper (see Cls below):
//      1a. attn_bwd_cls_logits_kernel, a block per (h, chunk, b): each key's
//          logit s = q~_cls . k + row_bias and dp = d_cls . v (8 lanes a key,
//          16-byte loads), and the chunk's max;
//      1b. attn_bwd_cls_sums_kernel, a block per (h, chunk, b): under the
//          global max m (the chunk maxima and the self logit), with
//          e = exp(s - m), the chunk's sum e, sum e dp, sum e k and
//          sum e dp k, which give s_dot and dq_cls without a second pass
//          over the keys;
//      1c. attn_bwd_cls_finish_kernel, a block per (h, b): sums the chunks in
//          order; z = sum e + e_s, s_dot = (sum e dp + e_s dps) / z,
//          dq_cls = dh^-0.5 (sum e dp k - s_dot sum e k + e_s (dps - s_dot)
//          k_cls) / z; writes dq_cls, the stats (m, z, s_dot) and the CLS
//          row's own terms of dk_cls and dv_cls.
//   2. The token rows on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//      accumulators), in two launches that split rows from columns, a warp
//      per 16 rows (or keys) of a group. A block takes a 64-row chunk of one
//      group where L > 64, or several whole groups where L is shorter than
//      its 64-row tile (four groups of L <= 16, two of L <= 32, one group on
//      three warps at L <= 48): the wrapper's planner
//      (ops/divided_attention.py::bwd_plan) sets groups a block, chunks and
//      threads (tests/test_torch_kernel_plans.py checks that the warps cover
//      every row once). Groups are numbered n = b * G + g, so a block's
//      groups may span two videos.
//      2a. attn_bwd_rows_kernel: [k_cls; K] and [v_cls; V] of the block's
//          groups in shared memory; S = q~ [k_cls; K]^T and
//          dP = dO [v_cls; V]^T tile by tile (16 keys), a first sweep for
//          each row's max, sum and s_dot (online, rescaled), a second for dS
//          and dq = dS [k_cls; K]; writes dq, the rows' (max, sum, s_dot) as
//          fp32 scratch (B, G, H, L, 3), and each group's part of dk_cls and
//          dv_cls (column 0 of dS^T q~ and P^T dO, summed over its rows in
//          order);
//      2b. attn_bwd_cols_kernel: q and dO of the block's groups in shared
//          memory, a warp per 16 keys: S^T and dP^T tile by tile (16 rows),
//          P and dS from the stored row statistics, dK = dS^T q~ and
//          dV = P^T dO, plus the CLS row's terms for each key from launch
//          1a's logits and 1c's stats.
//   3. attn_bwd_cls_reduce_kernel, per (h, b): dk_cls and dv_cls, the CLS
//      row's own terms plus the groups' partials, in order.
// Each warp reads its own rows' operand (q and dO in 2a, K and V in 2b)
// from device memory straight into A fragments, once; shared memory holds
// only the operand every warp sweeps, staged by 16-byte cp.async into
// unpadded rows whose 16-byte chunks are swizzled by the row, so ldmatrix
// reads it without bank conflicts: the row launch's 35 KB at L = 16 (four
// groups), 18 KB at L = 49, 72 KB at 256; three blocks an SM, registers
// capped at 170 (a cap of 128 spills).
// q~, K, V and dO are exact in bf16, so S and dP match fp32 sums up to their
// order; with dh = 64 the scale is 1/8, a power of two, so q~ = q / 8
// exactly and the launches apply it to S and dK instead of to q. P and dS
// are fp32 (exponentials by __expf, whose relative error near 2^-21 is below
// what the split below keeps); they enter the gradient products as a bf16
// hi/lo pair (x = hi + lo, two products into one fp32 accumulator), about 16
// bits of mantissa. Keys past T and rows past L are padding to 16: padded
// keys take the finite mask value and a probability of 0, padded rows write
// nothing. Sums over rows, keys and chunks run in a fixed order and every
// output is written once: reruns give the same bits.
//
// What sets the time: at the flagship's L = 16 and 49 the products are a
// few hundred mma a warp; each warp's chain of loads, products,
// exponentials and shuffles, and the staging from L2, set it. At L = 192 (B
// = 8, G = 8, 6 heads) a call moves about 66 MB (20 us at 3.35 TB/s) and
// does about 6 * 2 L T dh FLOP a (b, g, h) on the tensor cores.

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
constexpr int TILE = 64;        // query rows (2a) or keys (2b) of a group's chunk
constexpr int TILE_WARPS = TILE / 16;  // most warps a block of the token rows
constexpr int MIN_BLOCKS = 3;   // blocks an SM: at most 170 registers a thread
constexpr float NEG = -0.7f * 3.402823466e38f;  // the finite mask value
constexpr int CLS_THREADS = 256;
// a CLS chunk's scratch: sum e k (DH), sum e dp k (DH), sum e, sum e dp, max
constexpr int PART = 2 * DH + 3;

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

// The CLS row's fp32 scratch of one (b, h), laid out as the wrapper sizes
// it: each key's logit (N) and d_cls . v (N), the chunks' partials
// (chunks * PART), the stats (max, z, s_dot) and the CLS row's own terms of
// dk_cls and dv_cls (2 * DH).
struct Cls {
  float* logit;
  float* dp;
  float* part;
  float* stats;
  float* kv;
};

__device__ __forceinline__ Cls cls_scratch(float* base, int b, int h, int H, int N, int chunks) {
  Cls c;
  c.logit = base + (i64(b) * H + h) * (2 * i64(N) + chunks * PART + 3 + 2 * DH);
  c.dp = c.logit + N;
  c.part = c.dp + N;
  c.stats = c.part + chunks * PART;
  c.kv = c.stats + 3;
  return c;
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
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) mx = fmaxf(mx, part[c * PART + 2 * DH + 2]);
  mx = block_reduce<true>(mx, red);  // its barriers also publish self_logit
  ls = self_logit;
  m = fmaxf(mx, ls);
}

// Launch 1a: the logits and d_cls . v of chunk c of the G*L keys, 8 lanes a
// key (16-byte loads), and the chunk's max
__global__ void __launch_bounds__(CLS_THREADS)
attn_bwd_cls_logits_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                           const bf16* __restrict__ qkvc, i64 scb,
                           const float* __restrict__ row_bias, i64 rb_b, i64 rb_g, i64 rb_l,
                           const bf16* __restrict__ dcls, i64 dcb, float* __restrict__ scratch,
                           int G, int L, int H, int chunks, float scale) {
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
  const int sub = lane & 7;    // the lane's 8 dimensions
  const int slot = lane >> 3;  // the lane's key of the warp's four
  const int inner = H * DH;
  const bf16* base = qkv + b * sb;
  const int koff = inner + h * DH + sub * 8;
  const int voff = 2 * inner + h * DH + sub * 8;
  const Cls sc = cls_scratch(scratch, b, h, H, N, chunks);
  float q[8], dc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    q[i] = bf16_round(bf(qkvc[b * scb + h * DH + sub * 8 + i]) * scale);
    dc[i] = bf(dcls[b * dcb + h * DH + sub * 8 + i]);
  }

  float mx = -INFINITY;
  for (int tb = t0 + warp * 4; tb < t1; tb += CLS_THREADS / 8) {  // warp-uniform
    const int t = tb + slot;
    const int g = t / L;
    const int l = t % L;
    float k[8] = {0, 0, 0, 0, 0, 0, 0, 0}, v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (t < t1) {
      load8(k, base + g * sg + l * sl + koff);
      load8(v, base + g * sg + l * sl + voff);
    }
    float s = 0.0f, dp = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s = fmaf(q[i], k[i], s);
      dp = fmaf(dc[i], v[i], dp);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      dp += __shfl_xor_sync(0xffffffffu, dp, o);
    }
    if (t < t1) {
      if (row_bias != nullptr) s += row_bias[b * rb_b + g * rb_g + l * rb_l];
      if (sub == 0) {
        sc.logit[t] = s;
        sc.dp[t] = dp;
      }
      mx = fmaxf(mx, s);
    }
  }
  mx = block_reduce<true>(mx, red);
  if (threadIdx.x == 0) sc.part[c * PART + 2 * DH + 2] = mx;
}

// Launch 1b: with e = exp(s - m) under the global max m, chunk c's sum e,
// sum e dp, sum e k and sum e dp k
__global__ void __launch_bounds__(CLS_THREADS)
attn_bwd_cls_sums_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                         const bf16* __restrict__ qkvc, i64 scb, float* __restrict__ scratch,
                         int G, int L, int H, int chunks, float scale) {
  __shared__ float red[CLS_THREADS / 32];
  __shared__ float accw[CLS_THREADS / 32][2 * DH];
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
  const Cls sc = cls_scratch(scratch, b, h, H, N, chunks);
  float m, ls;
  cls_max_and_self(m, ls, sc.part, chunks, qkvc + b * scb, h * DH, inner + h * DH, scale, red);

  const int koff = inner + h * DH + sub * 8;
  float ak[8] = {0, 0, 0, 0, 0, 0, 0, 0}, adk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float z = 0.0f, zd = 0.0f;
  for (int tb = t0 + warp * 4; tb < t1; tb += CLS_THREADS / 8) {  // warp-uniform
    const int t = tb + slot;
    if (t < t1) {
      const float e = expf(sc.logit[t] - m);
      const float ed = e * sc.dp[t];
      float k[8];
      load8(k, base + (t / L) * sg + (t % L) * sl + koff);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ak[i] = fmaf(e, k[i], ak[i]);
        adk[i] = fmaf(ed, k[i], adk[i]);
      }
      if (sub == 0) {
        z += e;
        zd += ed;
      }
    }
  }
  // the warp's four keys a step, then the warps, in a fixed order
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ak[i] += __shfl_xor_sync(0xffffffffu, ak[i], 8);
    ak[i] += __shfl_xor_sync(0xffffffffu, ak[i], 16);
    adk[i] += __shfl_xor_sync(0xffffffffu, adk[i], 8);
    adk[i] += __shfl_xor_sync(0xffffffffu, adk[i], 16);
  }
  if (slot == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      accw[warp][sub * 8 + i] = ak[i];
      accw[warp][DH + sub * 8 + i] = adk[i];
    }
  z = block_reduce<false>(z, red);  // its barriers also publish accw
  zd = block_reduce<false>(zd, red);
  float* part = sc.part + c * PART;
  if (threadIdx.x < 2 * DH) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < CLS_THREADS / 32; ++w) a += accw[w][threadIdx.x];
    part[threadIdx.x] = a;
  }
  if (threadIdx.x == 0) {
    part[2 * DH] = z;
    part[2 * DH + 1] = zd;
  }
}

// Launch 1c: the chunks summed in order; dq_cls, the stats (m, z, s_dot) and
// the CLS row's own terms of dk_cls (dl_s q~_cls) and dv_cls (p_s d_cls)
__global__ void __launch_bounds__(DH)
attn_bwd_cls_finish_kernel(const bf16* __restrict__ qkvc, i64 scb, const bf16* __restrict__ dcls,
                           i64 dcb, bf16* __restrict__ dqkvc, i64 ocb, float* __restrict__ scratch,
                           int N, int H, int chunks, float scale) {
  __shared__ float red[DH / 32];
  __shared__ float self_dp;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int inner = H * DH;
  const bf16* cls = qkvc + b * scb;
  const Cls sc = cls_scratch(scratch, b, h, H, N, chunks);
  const float dc = bf(dcls[b * dcb + h * DH + d]);
  if (d >= 32) {  // d_cls . v_cls on the second warp, while the first takes the self logit
    const int e = d - 32;
    const float s = warp_sum(bf(dcls[b * dcb + h * DH + e]) * bf(cls[2 * inner + h * DH + e]) +
                             dc * bf(cls[2 * inner + h * DH + d]));
    if (e == 0) self_dp = s;
  }
  float m, ls;
  cls_max_and_self(m, ls, sc.part, chunks, cls, h * DH, inner + h * DH, scale, red);  // publishes self_dp
  float ak = 0.0f, adk = 0.0f, z = 0.0f, zd = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const float* part = sc.part + c * PART;
    ak += part[d];
    adk += part[DH + d];
    z += part[2 * DH];
    zd += part[2 * DH + 1];
  }
  const float dps = self_dp;
  const float es = expf(ls - m);
  z += es;
  const float inv = 1.0f / z;
  const float s_dot = (zd + es * dps) * inv;
  const float ps = es * inv;
  const float dls = ps * (dps - s_dot);
  const float kc = bf(cls[inner + h * DH + d]);
  dqkvc[b * ocb + h * DH + d] = __float2bfloat16(scale * fmaf(adk - s_dot * ak, inv, dls * kc));
  sc.kv[d] = dls * bf16_round(bf(cls[h * DH + d]) * scale);
  sc.kv[DH + d] = ps * dc;
  if (d == 0) {
    sc.stats[0] = m;
    sc.stats[1] = z;
    sc.stats[2] = s_dot;
  }
}

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

// Where a block of the token-row launches and its warps fall, from the
// wrapper's plan (tests/test_torch_kernel_plans.py::_tile computes the same):
// block x takes chunk x % chunks of groups n0 .. n0 + groups - 1 (n = b * G
// + g); warp w takes group n0 + w / wpg and the 16 rows (2a) or keys (2b)
// from first = (w % wpg) * 16 of the chunk, of `count` in all.
struct Tile {
  int n0, groups, chunk, r0, count;  // the block's
  int j, first;                      // the warp's group in the block and first row of the chunk
  bool live;                         // whether the warp has rows
};

__device__ __forceinline__ Tile block_tile(int B, int G, int L, int gpb, int chunks) {
  Tile t;
  const int wpg = blockDim.x / 32 / gpb;
  const int warp = threadIdx.x / 32;
  t.n0 = blockIdx.x / chunks * gpb;
  t.groups = min(gpb, B * G - t.n0);
  t.chunk = blockIdx.x % chunks;
  t.r0 = t.chunk * TILE;
  t.count = min(TILE, L - t.r0);
  t.j = warp / wpg;
  t.first = warp % wpg * 16;
  t.live = t.j < t.groups && t.first < t.count;
  return t;
}

// Launch 2a: dq of the block's rows, the rows' softmax statistics and each
// group's part of the CLS key's gradients. With dh = 64 the scale 1/8 is a
// power of two, so q~ = q / 8 exactly: q is read as it is and the scale
// applied to S (and to the dk_cls part).
__global__ void __launch_bounds__(TILE_WARPS * 32, MIN_BLOCKS)
attn_bwd_rows_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                     const bf16* __restrict__ qkvc, i64 scb, const float* __restrict__ seq_bias,
                     const bf16* __restrict__ dtok, i64 db, i64 dg, i64 dl,
                     bf16* __restrict__ dqkv, i64 ob, i64 og, i64 ol,
                     float* __restrict__ row_stats, float* __restrict__ kv_part, int B, int G,
                     int L, int H, int gpb, int chunks, float scale) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int T = L + 1;  // CLS key + L keys
  const int Tp = pad16(T);
  const int h = blockIdx.y;
  const Tile tl = block_tile(B, G, L, gpb, chunks);
  const int warps = blockDim.x / 32;
  bf16* ks = reinterpret_cast<bf16*>(lsm);  // [gpb][Tp][DH]  k_cls, K, zeros (swizzled)
  bf16* vs = ks + gpb * Tp * DH;            // [gpb][Tp][DH]  v_cls, V, zeros (swizzled)
  // [warps][2 * DH]: each warp's column 0 of dS^T q (DH), then of P^T dO (DH)
  float* kvw = reinterpret_cast<float*>(vs + gpb * Tp * DH);

  const int inner = H * DH;
  const int qoff = h * DH;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;
  for (int j = 0; j < tl.groups; ++j) {
    const int b = (tl.n0 + j) / G;
    const int g = (tl.n0 + j) % G;
    const bf16* base = qkv + b * sb + g * sg;
    const bf16* cls = qkvc + b * scb;
    stage_rows(ks + j * Tp * DH, 0, cls + koff, 0, 1, 1);
    stage_rows(ks + j * Tp * DH, 1, base + koff, sl, L, Tp);
    stage_rows(vs + j * Tp * DH, 0, cls + voff, 0, 1, 1);
    stage_rows(vs + j * Tp * DH, 1, base + voff, sl, L, Tp);
  }
  const int n = tl.n0 + min(tl.j, tl.groups - 1);  // the warp's group
  const int b = n / G;
  const int g = n % G;
  const bf16* qrows = qkv + b * sb + g * sg + tl.r0 * sl + qoff;       // q of the chunk (unscaled)
  const bf16* drows = dtok + b * db + g * dg + tl.r0 * dl + h * DH;  // dO of the chunk
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = tl.first;
  uint32_t qa[DH / 16][4], da[DH / 16][4];  // loaded while the copies run
  if (tl.live) {
    load_a(qa, qrows, sl, wr, tl.count, lane);
    load_a(da, drows, dl, wr, tl.count, lane);
  }
  warp_mma::cp_async_wait_all();
  __syncthreads();

  const int grp = lane >> 2;
  const int tig = lane & 3;
  if (tl.live) {  // warp-uniform
    const bf16* kt = ks + tl.j * Tp * DH;
    const bf16* vt = vs + tl.j * Tp * DH;
    // this thread's two rows: grp and grp + 8 of the warp's 16
    const int row[2] = {tl.r0 + wr + grp, tl.r0 + wr + grp + 8};
    const float* brow[2] = {nullptr, nullptr};
    if (seq_bias != nullptr)
#pragma unroll
      for (int x = 0; x < 2; ++x) brow[x] = seq_bias + (i64(b) * L + min(row[x], L - 1)) * T;
    // S and dP of keys kb .. kb+15, S scaled and biased, padded keys at NEG
    auto products = [&](float s[2][4], float dp[2][4], int kb) {
      float bias[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // issued before the products, to hide its latency
          const int t = kb + nn * 8 + 2 * tig + (i & 1);
          bias[nn][i] = brow[i >> 1] != nullptr && t < T ? brow[i >> 1][t] : 0.0f;
        }
      mma_rows_t(s, qa, kt, kb, lane);
      mma_rows_t(dp, da, vt, kb, lane);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[nn][i] = kb + nn * 8 + 2 * tig + (i & 1) < T ? fmaf(s[nn][i], scale, bias[nn][i]) : NEG;
    };

    // sweep 1: each row's max, sum and unnormalised s_dot, online
    float m[2] = {NEG, NEG}, sum[2] = {0.0f, 0.0f}, sdu[2] = {0.0f, 0.0f};
    for (int kb = 0; kb < Tp; kb += 16) {
      float s[2][4], dp[2][4];
      products(s, dp, kb);
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) mt[i >> 1] = fmaxf(mt[i >> 1], s[nn][i]);
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
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = kb + nn * 8 + 2 * tig + (i & 1);
          const float e = t < T ? __expf(s[nn][i] - m[i >> 1]) : 0.0f;
          sum[i >> 1] += e;
          sdu[i >> 1] = fmaf(e, dp[nn][i], sdu[i >> 1]);
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
    for (int nn = 0; nn < DH / 8; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[nn][i] = 0.0f;
    float pc[2], dsc[2];  // P and dS of this thread's two rows at the CLS key (column 0)
    for (int kb = 0; kb < Tp; kb += 16) {
      float s[2][4], dp[2][4];
      products(s, dp, kb);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = kb + nn * 8 + 2 * tig + (i & 1);
          const float p = t < T ? __expf(s[nn][i] - m[i >> 1]) * inv[i >> 1] : 0.0f;
          dp[nn][i] = p * (dp[nn][i] - sd[i >> 1]);  // dS
          s[nn][i] = p;
        }
      if (kb == 0) {  // column 0, held by the lanes with tig == 0
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          pc[x] = __shfl_sync(0xffffffffu, s[0][2 * x], lane & ~3);
          dsc[x] = __shfl_sync(0xffffffffu, dp[0][2 * x], lane & ~3);
        }
      }
      uint32_t hi[4], lo[4];
      warp_mma::split_a(dp, hi, lo);
      mma_split(dq, hi, lo, kt, kb, lane);
    }

    // the warp's part of dk_cls (dS[:, 0]^T q) and dv_cls (P[:, 0]^T dO) from
    // the rows' fragments (padded rows are zero there): the thread's two
    // rows, then the eight row pairs over lanes grp, in a fixed order; one
    // operand at a time, to keep registers down
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const uint32_t(*frag)[4] = o ? da : qa;
      const float* w = o ? pc : dsc;
      float c[DH / 16][4];  // columns k * 16 + (i / 2) * 8 + 2 tig + i % 2
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 r0 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&frag[k][2 * hf]));
          const float2 r1 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&frag[k][2 * hf + 1]));
          c[k][2 * hf] = fmaf(w[1], r1.x, w[0] * r0.x);
          c[k][2 * hf + 1] = fmaf(w[1], r1.y, w[0] * r0.y);
        }
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1)
#pragma unroll
        for (int k = 0; k < DH / 16; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[k][i] += __shfl_xor_sync(0xffffffffu, c[k][i], sh);
      if (grp == 0)
#pragma unroll
        for (int k = 0; k < DH / 16; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            kvw[warp * 2 * DH + o * DH + k * 16 + (i >> 1) * 8 + 2 * tig + (i & 1)] = c[k][i];
    }

    bf16* obase = dqkv + b * ob + g * og;
    float* st = row_stats + ((size_t(b) * G + g) * H + h) * size_t(L) * 3;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (row[x] >= L) continue;
      bf16* orow = obase + row[x] * ol + qoff;
#pragma unroll
      for (int nn = 0; nn < DH / 8; ++nn)
        *reinterpret_cast<bf162*>(orow + nn * 8 + 2 * tig) =
            __floats2bfloat162_rn(scale * dq[nn][2 * x], scale * dq[nn][2 * x + 1]);
      if (tig == 0) {
        st[3 * row[x]] = m[x];
        st[3 * row[x] + 1] = sum[x];
        st[3 * row[x] + 2] = sd[x];
      }
    }
  }
  __syncthreads();

  // each group's part of dk_cls (dS[:, 0]^T q~) and dv_cls (P[:, 0]^T dO):
  // its warps' parts with rows, in order
  const int wpg = warps / gpb;
  for (int i = threadIdx.x; i < tl.groups * 2 * DH; i += blockDim.x) {
    const int j = i / (2 * DH);
    const int e = i % (2 * DH);
    float a = 0.0f;
    for (int w = 0; w < wpg && w * 16 < tl.count; ++w) a += kvw[(j * wpg + w) * 2 * DH + e];
    kv_part[((size_t(tl.n0 + j) * chunks + tl.chunk) * H + h) * 2 * DH + e] =
        e < DH ? scale * a : a;
  }
}

// Launch 2b: dK and dV of the block's keys, with the CLS row's terms. q is
// staged unscaled: the scale goes to S^T and dK.
__global__ void __launch_bounds__(TILE_WARPS * 32, MIN_BLOCKS)
attn_bwd_cols_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                     const bf16* __restrict__ qkvc, i64 scb, const float* __restrict__ seq_bias,
                     const bf16* __restrict__ dtok, i64 db, i64 dg, i64 dl,
                     const bf16* __restrict__ dcls, i64 dcb, const float* __restrict__ cls_scr,
                     int cls_chunks, const float* __restrict__ row_stats,
                     bf16* __restrict__ dqkv, i64 ob, i64 og, i64 ol, int B, int G, int L, int H,
                     int gpb, int chunks, float scale) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int T = L + 1;
  const int Lp = pad16(L);
  const int h = blockIdx.y;
  const Tile tl = block_tile(B, G, L, gpb, chunks);
  bf16* qs = reinterpret_cast<bf16*>(lsm);  // [gpb][Lp][DH]  q (unscaled), zeros (swizzled)
  bf16* dos = qs + gpb * Lp * DH;           // [gpb][Lp][DH]  dO, zeros (swizzled)
  float* rm = reinterpret_cast<float*>(dos + gpb * Lp * DH);  // [gpb][Lp] row max
  float* rinv = rm + gpb * Lp;                                 // [gpb][Lp] 1 / row sum
  float* rsd = rinv + gpb * Lp;                                // [gpb][Lp] row s_dot
  float* qc = rsd + gpb * Lp;                                  // [gpb][DH] q~_cls
  float* dc = qc + gpb * DH;                                   // [gpb][DH] d_cls

  const int tid = threadIdx.x;
  const int inner = H * DH;
  const int qoff = h * DH;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;
  for (int j = 0; j < tl.groups; ++j) {
    const int bj = (tl.n0 + j) / G;
    const int gj = (tl.n0 + j) % G;
    stage_rows(qs + j * Lp * DH, 0, qkv + bj * sb + gj * sg + qoff, sl, L, Lp);
    stage_rows(dos + j * Lp * DH, 0, dtok + bj * db + gj * dg + h * DH, dl, L, Lp);
  }
  const int n = tl.n0 + min(tl.j, tl.groups - 1);  // the warp's group
  const int b = n / G;
  const int g = n % G;
  const bf16* krows = qkv + b * sb + g * sg + tl.r0 * sl + koff;  // K of the chunk
  const bf16* vrows = qkv + b * sb + g * sg + tl.r0 * sl + voff;  // V of the chunk
  const int lane = tid % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wk = tl.first;  // the warp's first key in the chunk
  uint32_t ka[DH / 16][4], va[DH / 16][4];  // loaded while the copies run
  // the CLS row's logit and d_cls . v of this thread's two keys (launch 1a)
  // and its stats (1c), loaded while the copies run too
  float cl[2] = {0.0f, 0.0f}, cd[2] = {0.0f, 0.0f}, cst[3] = {0.0f, 1.0f, 0.0f};
  if (tl.live) {
    load_a(ka, krows, sl, wk, tl.count, lane);
    load_a(va, vrows, sl, wk, tl.count, lane);
    const Cls sc = cls_scratch(const_cast<float*>(cls_scr), b, h, H, G * L, cls_chunks);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int t = g * L + tl.r0 + min(wk + grp + 8 * x, tl.count - 1);
      cl[x] = sc.logit[t];
      cd[x] = sc.dp[t];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) cst[i] = sc.stats[i];
  }
  // the block's row statistics and CLS operands, beside the copies
  for (int i = tid; i < tl.groups * Lp; i += blockDim.x) {
    const int j = i / Lp;
    const int r = i % Lp;
    const float* rst = row_stats + (size_t(tl.n0 + j) * H + h) * size_t(L) * 3;
    rm[i] = r < L ? rst[3 * r] : 0.0f;
    rinv[i] = r < L ? 1.0f / rst[3 * r + 1] : 0.0f;
    rsd[i] = r < L ? rst[3 * r + 2] : 0.0f;
  }
  for (int i = tid; i < tl.groups * DH; i += blockDim.x) {
    const int bj = (tl.n0 + i / DH) / G;
    const int d = i % DH;
    qc[i] = bf16_round(bf(qkvc[bj * scb + qoff + d]) * scale);
    dc[i] = bf(dcls[bj * dcb + h * DH + d]);
  }
  warp_mma::cp_async_wait_all();
  __syncthreads();
  if (!tl.live) return;  // warp-uniform; no barrier follows
  const bf16* qt = qs + tl.j * Lp * DH;
  const bf16* dot = dos + tl.j * Lp * DH;
  const float* rmj = rm + tl.j * Lp;
  const float* rinvj = rinv + tl.j * Lp;
  const float* rsdj = rsd + tl.j * Lp;
  const float* qcj = qc + tl.j * DH;
  const float* dcj = dc + tl.j * DH;
  // the CLS row's terms for the two keys: p and dl = p (d_cls . v - s_dot)
  float cp[2], cdl[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    cp[x] = expf(cl[x] - cst[0]) / cst[1];
    cdl[x] = cp[x] * (cd[x] - cst[2]);
  }
  // this thread's two keys of [CLS; tokens]: grp and grp + 8 of the warp's 16
  const int key[2] = {tl.r0 + wk + grp + 1, tl.r0 + wk + grp + 9};
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int nn = 0; nn < DH / 8; ++nn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nn][i] = dv[nn][i] = 0.0f;
  for (int rb = 0; rb < Lp; rb += 16) {
    float s[2][4], dp[2][4];  // S^T and dP^T: keys x rows rb .. rb+15
    float bias[2][4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // issued before the products, to hide its latency
        const int r = rb + nn * 8 + 2 * tig + (i & 1);
        const int t = key[i >> 1];
        bias[nn][i] = seq_bias != nullptr && r < L && t < T
                          ? seq_bias[(i64(b) * L + r) * T + t] : 0.0f;
      }
    mma_rows_t(s, ka, qt, rb, lane);
    mma_rows_t(dp, va, dot, rb, lane);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb + nn * 8 + 2 * tig + (i & 1);
        const float p = r < L && key[i >> 1] < T
                            ? __expf(fmaf(s[nn][i], scale, bias[nn][i]) - rmj[r]) * rinvj[r] : 0.0f;
        dp[nn][i] = p * (dp[nn][i] - rsdj[r]);  // dS^T
        s[nn][i] = p;                           // P^T
      }
    uint32_t hi[4], lo[4];
    warp_mma::split_a(dp, hi, lo);
    mma_split(dk, hi, lo, qt, rb, lane);
    warp_mma::split_a(s, hi, lo);
    mma_split(dv, hi, lo, dot, rb, lane);
  }

  bf16* obase = dqkv + b * ob + g * og;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int kk = wk + grp + 8 * x;  // key in the chunk
    if (kk >= tl.count) continue;
    bf16* orow = obase + (tl.r0 + kk) * ol;
#pragma unroll
    for (int nn = 0; nn < DH / 8; ++nn) {
      const int d = nn * 8 + 2 * tig;
      *reinterpret_cast<bf162*>(orow + koff + d) = __floats2bfloat162_rn(
          fmaf(cdl[x], qcj[d], scale * dk[nn][2 * x]),
          fmaf(cdl[x], qcj[d + 1], scale * dk[nn][2 * x + 1]));
      *reinterpret_cast<bf162*>(orow + voff + d) = __floats2bfloat162_rn(
          fmaf(cp[x], dcj[d], dv[nn][2 * x]), fmaf(cp[x], dcj[d + 1], dv[nn][2 * x + 1]));
    }
  }
}

// dk_cls and dv_cls: the CLS row's own terms plus the groups' partials, in
// order: RED_SPLIT runs of consecutive partials side by side, then the runs
constexpr int RED_SPLIT = 4;

__global__ void __launch_bounds__(RED_SPLIT * 2 * DH)
attn_bwd_cls_reduce_kernel(float* __restrict__ cls_scr, const float* __restrict__ kv_part,
                           bf16* __restrict__ dqkvc, i64 ocb, int N, int parts, int H,
                           int cls_chunks) {
  __shared__ float run[RED_SPLIT][2 * DH];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int e = threadIdx.x % (2 * DH);  // k then v
  const int q = threadIdx.x / (2 * DH);
  const int per = (parts + RED_SPLIT - 1) / RED_SPLIT;
  float a = 0.0f;
  for (int p = q * per; p < min(parts, (q + 1) * per); ++p)
    a += kv_part[((size_t(b) * parts + p) * H + h) * 2 * DH + e];
  run[q][e] = a;
  __syncthreads();
  if (q == 0) {
    a = cls_scratch(cls_scr, b, h, H, N, cls_chunks).kv[e];
#pragma unroll
    for (int r = 0; r < RED_SPLIT; ++r) a += run[r][e];
    dqkvc[b * ocb + (1 + e / DH) * H * DH + h * DH + e % DH] = __float2bfloat16(a);
  }
}

size_t rows_smem(int L, int gpb, int warps) {
  return sizeof(bf16) * 2 * size_t(gpb) * pad16(L + 1) * DH + sizeof(float) * warps * 2 * DH;
}

size_t cols_smem(int L, int gpb) {
  const size_t Lp = pad16(L);
  return sizeof(bf16) * 2 * gpb * Lp * DH + sizeof(float) * gpb * (3 * Lp + 2 * DH);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The launch plan comes from ops/divided_attention.py::bwd_plan: groups a
// block (gpb), row chunks a group (chunks), threads a block of the token-row
// launches and cls_chunks. Scratch from the caller, fp32: cls_scratch (B*H*
// (2*G*L + cls_chunks*(2*dh + 3) + 3 + 2*dh)), kv_part (B*G*chunks*H*2*dh)
// and row_stats (B*G*H*L*3). The three bf16 inputs and their strides (but
// the last) must be 16-byte aligned.
extern "C" int divided_attention_bwd(const void* qkv, i64 sb, i64 sg, i64 sl, const void* qkvc,
                                     i64 scb, const void* seq_bias, const void* row_bias,
                                     i64 rb_b, i64 rb_g, i64 rb_l, const void* dtok, i64 db,
                                     i64 dg, i64 dl, const void* dcls, i64 dcb, void* dqkv,
                                     i64 ob, i64 og, i64 ol, void* dqkvc, i64 ocb,
                                     void* cls_scratch, void* kv_part, void* row_stats, int B,
                                     int G, int L, int H, int dh, int gpb, int chunks,
                                     int threads, int cls_chunks, void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  // the plan: whole warps, each group's chunk covered by its warps, several
  // groups a block only where one chunk holds a group
  const int warps = threads / 32;
  if (threads % 32 != 0 || warps < 1 || warps > TILE_WARPS || gpb < 1 || warps % gpb != 0 ||
      chunks != (L + TILE - 1) / TILE || (chunks > 1 && gpb != 1) ||
      warps / gpb * 16 < (L < TILE ? L : TILE) || cls_chunks < 1 || cls_chunks > G * L ||
      cls_chunks > 65535)
    return int(cudaErrorInvalidValue);
  const i64 blocks = (i64(B) * G + gpb - 1) / gpb * chunks;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  if (!aligned16(qkv) || !aligned16(qkvc) || !aligned16(dtok) ||
      (sb | sg | sl | scb | db | dg | dl) % 8 != 0)
    return int(cudaErrorMisalignedAddress);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(rows_smem(L, gpb, warps)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(cols_smem(L, gpb)));
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
  float* cs = static_cast<float*>(cls_scratch);
  float* part = static_cast<float*>(kv_part);
  float* rst = static_cast<float*>(row_stats);
  const int N = G * L;

  attn_bwd_cls_logits_kernel<<<dim3(H, cls_chunks, B), CLS_THREADS, 0, s>>>(
      q, sb, sg, sl, qc, scb, rb, rb_b, rb_g, rb_l, dc, dcb, cs, G, L, H, cls_chunks, scale);
  attn_bwd_cls_sums_kernel<<<dim3(H, cls_chunks, B), CLS_THREADS, 0, s>>>(
      q, sb, sg, sl, qc, scb, cs, G, L, H, cls_chunks, scale);
  attn_bwd_cls_finish_kernel<<<dim3(H, B), DH, 0, s>>>(qc, scb, dc, dcb, dqc, ocb, cs, N, H,
                                                       cls_chunks, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const dim3 grid(unsigned(blocks), H);
  attn_bwd_rows_kernel<<<grid, threads, rows_smem(L, gpb, warps), s>>>(
      q, sb, sg, sl, qc, scb, sqb, dt, db, dg, dl, dq, ob, og, ol, rst, part, B, G, L, H, gpb,
      chunks, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  attn_bwd_cols_kernel<<<grid, threads, cols_smem(L, gpb), s>>>(
      q, sb, sg, sl, qc, scb, sqb, dt, db, dg, dl, dc, dcb, cs, cls_chunks, rst, dq, ob, og, ol,
      B, G, L, H, gpb, chunks, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // the partials of every group and row chunk, in order
  attn_bwd_cls_reduce_kernel<<<dim3(H, B), RED_SPLIT * 2 * DH, 0, s>>>(cs, part, dqc, ocb, N,
                                                                       G * chunks, H, cls_chunks);
  return int(cudaGetLastError());
}
