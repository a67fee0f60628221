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
//      2a. attn_bwd_rows_kernel<true> (csrc/attn_bwd_rows_mma.cuh, shared
//          with the token-row backward above 16 frames): [k_cls; K] and [v_cls; V] of the block's
//          groups in shared memory; S = q~ [k_cls; K]^T and
//          dP = dO [v_cls; V]^T tile by tile (16 keys), a first sweep for
//          each row's max, sum and s_dot (online, rescaled), a second for dS
//          and dq = dS [k_cls; K]; writes dq, the rows' (max, sum, s_dot) as
//          fp32 scratch (B, G, H, L, 3), and each group's part of dk_cls and
//          dv_cls (column 0 of dS^T q~ and P^T dO, summed over its rows in
//          order);
//      2b. attn_bwd_cols_kernel<true> (the same header): q and dO of the block's groups in shared
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

#include "attn_bwd_rows_mma.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

// the token rows' launches, the CLS row's scratch layout and the helpers of
// csrc/attn_bwd_rows_mma.cuh
using attn_bwd_rows::attn_bwd_cols_kernel;
using attn_bwd_rows::attn_bwd_rows_kernel;
using attn_bwd_rows::bf;
using attn_bwd_rows::bf16_round;
using attn_bwd_rows::Cls;
using attn_bwd_rows::cls_scratch;
using attn_bwd_rows::cols_smem;
using attn_bwd_rows::DH;
using attn_bwd_rows::PART;
using attn_bwd_rows::plan_ok;
using attn_bwd_rows::rows_smem;

constexpr int MAXL = 256;       // longest attended sequence of the token rows
constexpr int CLS_THREADS = 256;

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
  const int warps = threads / 32;
  if (!plan_ok(L, gpb, chunks, threads) || cls_chunks < 1 || cls_chunks > G * L ||
      cls_chunks > 65535)
    return int(cudaErrorInvalidValue);
  const i64 blocks = (i64(B) * G + gpb - 1) / gpb * chunks;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  if (!aligned16(qkv) || !aligned16(qkvc) || !aligned16(dtok) ||
      (sb | sg | sl | scb | db | dg | dl) % 8 != 0)
    return int(cudaErrorMisalignedAddress);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_rows_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(rows_smem(L, gpb, warps)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_cols_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  attn_bwd_rows_kernel<true><<<grid, threads, rows_smem(L, gpb, warps), s>>>(
      q, sb, sg, sl, qc, scb, sqb, dt, db, dg, dl, dq, ob, og, ol, rst, part, B, G, L, H, gpb,
      chunks, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  attn_bwd_cols_kernel<true><<<grid, threads, cols_smem(L, gpb), s>>>(
      q, sb, sg, sl, qc, scb, sqb, dt, db, dg, dl, dc, dcb, cs, cls_chunks, rst, dq, ob, og, ol,
      B, G, L, H, gpb, chunks, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // the partials of every group and row chunk, in order
  attn_bwd_cls_reduce_kernel<<<dim3(H, B), RED_SPLIT * 2 * DH, 0, s>>>(cs, part, dqc, ocb, N,
                                                                       G * chunks, H, cls_chunks);
  return int(cudaGetLastError());
}
