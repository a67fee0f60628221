// Backward of the token rows of the divided space-time attention, tiled over
// groups, for Hopper (sm_90a), bf16 in and out, fp32 inside.
//
// Replaces: mintime_tpu/ops/pallas_attention.py::_token_rows_bwd_kernel
// (reached through _token_rows_bwd_call and the custom_vjp of
// _token_rows_core). Inputs are the forward's packed qkv (B, G, L, 3*H*dh)
// with columns [q | k | v] (read through any (B, G, L) strides), the CLS
// row's qkv (B, 3*H*dh), the optional seq_bias (B, L, 1+L) and the cotangent
// of the token outputs (B, G, L, H*dh, any strides). With q~ = bf16(q *
// dh^-0.5) and the softmax recomputed in fp32, per (b, g, h):
//   P  = softmax([q~ k_cls | q~ K^T] + seq_bias)
//   dS = P * (dO [v_cls | V]^T - rowsum(dO [v_cls | V]^T * P))
//   dq = dh^-0.5 (dS[:, 1:] K + dS[:, 0] k_cls),  dK = dS[:, 1:]^T q~,
//   dV = P[:, 1:]^T dO,
// and dk_cls = sum over g of dS[:, 0]^T q~, dv_cls = sum over g of
// P[:, 0]^T dO, in fp32. Outputs: d_qkv in the layout of qkv (bf16) and
// d_qkvc (B, 3*H*dh) bf16, whose q third is zero (the CLS row's own gradient
// comes from its plain PyTorch autograd). seq_bias gets no gradient (the JAX
// package returns zeros).
//
// Bound on an H100: memory. At B = 8, G = 1280, L = 8, H*dh = 384 a call reads
// qkv (189 MB) and the cotangent (63 MB) and writes d_qkv (189 MB): 0.131 ms
// at 3.35 TB/s; about 4.5 GFLOP of scalar work.
//
// Design. The TPU kernel carried dk_cls and dv_cls in one output block across
// its sequential grid. GPU blocks run in parallel, so two launches in order,
// each owning its outputs (deterministic, no atomics):
//   1. token_rows_bwd_kernel: a warp per (b, g, h), h fastest; four warps a
//      block up to L = 32, two above (a warp's fp32 tiles take ~100 KB at
//      L = 64, so two fit the 227 KB a block may hold). The warp stages q~,
//      dO, K and V of its group (CLS as row 0) in its own shared memory as
//      fp32, recomputes each row's softmax with lane t on keys t, t + 32
//      and t + 64 of the CLS + L keys, keeps P and dS in shared memory, then
//      each lane owns two dimensions of dq, dK and dV. It writes the group's partial dk_cls
//      and dv_cls to fp32 scratch (B, G, H, 2, dh): 31 MB at the shapes above.
//   2. token_rows_cls_reduce_kernel, per (b, h): eight slices of the groups
//      summed in order each, then the eight partial sums in order; writes
//      dk_cls, dv_cls and the zero q third of d_qkvc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int DH = 64;          // head width: two dimensions a lane
constexpr int MAXL = 64;        // longest attended sequence, as the forward's
constexpr int SHORT_L = 32;     // up to here two keys a lane and four warps a block, above
                                // three keys a lane and two warps
constexpr int KLD = DH + 1;     // padded fp32 rows: lane t reads row t conflict-free
constexpr int SLICES = 8;       // group slices of the CLS reduction

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

// fp32 words of one warp's shared memory: qs, dos [L][KLD]; ks, vs [T][KLD];
// P, S [L][T]
int warp_floats(int L) {
  const int T = L + 1;
  return 2 * L * KLD + 2 * T * KLD + 2 * L * T;
}

// LMAX: the longest L the instance takes; WARPS: warps a block
template <int LMAX, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
token_rows_bwd_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                      const bf16* __restrict__ qkvc, i64 scb,
                      const float* __restrict__ seq_bias, const bf16* __restrict__ dtok, i64 db,
                      i64 dg, i64 dl, bf16* __restrict__ dqkv, i64 ob, i64 og, i64 ol,
                      float* __restrict__ kv_part, int B, int G, int L, int H, int wfloats,
                      float scale) {
  constexpr int MAXT = (LMAX + 1 + 31) / 32;  // keys a lane (CLS + L)
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const i64 item = i64(blockIdx.x) * WARPS + warp;  // (b, g, h), h fastest
  if (item >= i64(B) * G * H) return;  // no block-wide barrier below
  const int h = int(item % H);
  const int g = int(item / H % G);
  const int b = int(item / H / G);
  const int T = L + 1;  // CLS key + L keys
  float* qs = smem + warp * wfloats;  // [L][KLD]  q~
  float* dos = qs + L * KLD;          // [L][KLD]  dO
  float* ks = dos + L * KLD;          // [T][KLD]  k_cls, K
  float* vs = ks + T * KLD;           // [T][KLD]  v_cls, V
  float* P = vs + T * KLD;            // [L][T]    probabilities
  float* S = P + L * T;               // [L][T]    dS
  const int inner = H * DH;
  const bf16* base = qkv + b * sb + g * sg;
  const bf16* cls = qkvc + b * scb;
  const bf16* dbase = dtok + b * db + g * dg;
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
    vs[r * KLD + d] = v.x;
    vs[r * KLD + d + 1] = v.y;
    if (r > 0) {
      const float2 q = load2(row + qoff);
      const float2 o = load2(dbase + (r - 1) * dl + h * DH + d);
      qs[(r - 1) * KLD + d] = bf16_round(q.x * scale);
      qs[(r - 1) * KLD + d + 1] = bf16_round(q.y * scale);
      dos[(r - 1) * KLD + d] = o.x;
      dos[(r - 1) * KLD + d + 1] = o.y;
    }
  }
  __syncwarp();

  // each query row: lane t on key t
  for (int r = 0; r < L; ++r) {
    float p[MAXT], dp[MAXT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      float s = -INFINITY, a = 0.0f;
      if (t < T) {
        float l = 0.0f;
#pragma unroll 16
        for (int e = 0; e < DH; ++e) {
          l = fmaf(qs[r * KLD + e], ks[t * KLD + e], l);
          a = fmaf(dos[r * KLD + e], vs[t * KLD + e], a);
        }
        if (seq_bias != nullptr) l += seq_bias[(i64(b) * L + r) * T + t];
        s = l;
      }
      p[j] = s;
      dp[j] = a;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      p[j] = t < T ? expf(p[j] - mx) : 0.0f;
      sum += p[j];
    }
    sum = warp_sum(sum);
    float sd = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      p[j] /= sum;
      sd += p[j] * dp[j];
    }
    sd = warp_sum(sd);
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      const int t = lane + 32 * j;
      if (t < T) {
        P[r * T + t] = p[j];
        S[r * T + t] = p[j] * (dp[j] - sd);
      }
    }
  }
  __syncwarp();

  // dq, dK, dV of each row: lane owns dimensions d and d + 1
  bf16* obase = dqkv + b * ob + g * og;
  for (int r = 0; r < L; ++r) {
    float q0 = 0.0f, q1 = 0.0f, k0 = 0.0f, k1 = 0.0f, v0 = 0.0f, v1 = 0.0f;
    for (int t = 1; t < T; ++t) {
      q0 = fmaf(S[r * T + t], ks[t * KLD + d], q0);
      q1 = fmaf(S[r * T + t], ks[t * KLD + d + 1], q1);
    }
    q0 = fmaf(S[r * T], ks[d], q0);
    q1 = fmaf(S[r * T], ks[d + 1], q1);
    for (int q = 0; q < L; ++q) {
      const float s = S[q * T + r + 1];
      const float pv = P[q * T + r + 1];
      k0 = fmaf(s, qs[q * KLD + d], k0);
      k1 = fmaf(s, qs[q * KLD + d + 1], k1);
      v0 = fmaf(pv, dos[q * KLD + d], v0);
      v1 = fmaf(pv, dos[q * KLD + d + 1], v1);
    }
    bf16* orow = obase + r * ol;
    *reinterpret_cast<bf162*>(orow + qoff) = __floats2bfloat162_rn(scale * q0, scale * q1);
    *reinterpret_cast<bf162*>(orow + koff) = __floats2bfloat162_rn(k0, k1);
    *reinterpret_cast<bf162*>(orow + voff) = __floats2bfloat162_rn(v0, v1);
  }

  // this group's share of dk_cls and dv_cls
  float k0 = 0.0f, k1 = 0.0f, v0 = 0.0f, v1 = 0.0f;
  for (int q = 0; q < L; ++q) {
    k0 = fmaf(S[q * T], qs[q * KLD + d], k0);
    k1 = fmaf(S[q * T], qs[q * KLD + d + 1], k1);
    v0 = fmaf(P[q * T], dos[q * KLD + d], v0);
    v1 = fmaf(P[q * T], dos[q * KLD + d + 1], v1);
  }
  float* part = kv_part + ((i64(b) * G + g) * H + h) * 2 * DH;
  *reinterpret_cast<float2*>(part + d) = make_float2(k0, k1);
  *reinterpret_cast<float2*>(part + DH + d) = make_float2(v0, v1);
}

// d_qkvc of one (b, h): thread (s, e) sums element e (k then v) over slice s
// of the groups in order, then slice 0 sums the slices in order
__global__ void __launch_bounds__(SLICES * 2 * DH)
token_rows_cls_reduce_kernel(const float* __restrict__ kv_part, bf16* __restrict__ dqkvc,
                             i64 ocb, int G, int H) {
  __shared__ float red[SLICES][2 * DH];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int e = threadIdx.x % (2 * DH);
  const int s = threadIdx.x / (2 * DH);
  const int g0 = s * G / SLICES;
  const int g1 = (s + 1) * G / SLICES;
  const float* part = kv_part + (i64(b) * G * H + h) * 2 * DH + e;
  const i64 step = i64(H) * 2 * DH;
  float a = 0.0f;
#pragma unroll 4
  for (int g = g0; g < g1; ++g) a += part[g * step];
  red[s][e] = a;
  __syncthreads();
  if (s == 0) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < SLICES; ++k) t += red[k][e];
    bf16* row = dqkvc + b * ocb;
    row[(1 + e / DH) * H * DH + h * DH + e % DH] = __float2bfloat16(t);
    if (e < DH) row[h * DH + e] = __float2bfloat16(0.0f);
  }
}

template <int LMAX, int WARPS>
int launch_rows(const void* qkv, i64 sb, i64 sg, i64 sl, const void* qkvc, i64 scb,
                const void* seq_bias, const void* dtok, i64 db, i64 dg, i64 dl, void* dqkv,
                i64 ob, i64 og, i64 ol, float* part, int B, int G, int L, int H, cudaStream_t s) {
  const i64 blocks = (i64(B) * G * H + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  const int wfloats = warp_floats(L);
  const size_t smem = size_t(WARPS) * wfloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(token_rows_bwd_kernel<LMAX, WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  token_rows_bwd_kernel<LMAX, WARPS><<<unsigned(blocks), WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(qkv), sb, sg, sl, static_cast<const bf16*>(qkvc), scb,
      static_cast<const float*>(seq_bias), static_cast<const bf16*>(dtok), db, dg, dl,
      static_cast<bf16*>(dqkv), ob, og, ol, part, B, G, L, H, wfloats, 1.0f / sqrtf(float(DH)));
  return int(cudaGetLastError());
}

}  // namespace

// Strides are in elements; every pointer 4-byte aligned and every stride even
// (the wrapper checks), so pairs of bf16 move as one word. Scratch from the
// caller: kv_part, fp32 (B, G, H, 2, dh).
extern "C" int token_rows_attention_bwd(const void* qkv, i64 sb, i64 sg, i64 sl,
                                        const void* qkvc, i64 scb, const void* seq_bias,
                                        const void* dtok, i64 db, i64 dg, i64 dl, void* dqkv,
                                        i64 ob, i64 og, i64 ol, void* dqkvc, i64 ocb,
                                        void* kv_part, int B, int G, int L, int H, int dh,
                                        void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(kv_part);
  const int err =
      L <= SHORT_L ? launch_rows<SHORT_L, 4>(qkv, sb, sg, sl, qkvc, scb, seq_bias, dtok, db, dg,
                                             dl, dqkv, ob, og, ol, part, B, G, L, H, s)
                   : launch_rows<MAXL, 2>(qkv, sb, sg, sl, qkvc, scb, seq_bias, dtok, db, dg, dl,
                                          dqkv, ob, og, ol, part, B, G, L, H, s);
  if (err != 0) return err;
  token_rows_cls_reduce_kernel<<<dim3(H, B), SLICES * 2 * DH, 0, s>>>(
      part, static_cast<bf16*>(dqkvc), ocb, G, H);
  return int(cudaGetLastError());
}
