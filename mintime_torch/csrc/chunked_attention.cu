// Chunked-dense divided attention (token rows + CLS row) for Hopper
// (sm_90a), bf16 in and out, fp32 inside.
//
// Replaces: experiments/attn_kernel_variants.py::_chunked_kernel (reached
// through variant_g, variant G of the attention probe). Input is packed qkv
// (B, G, L, 3*H*dh), contiguous, with columns [q | k | v], each head-major
// (PyTorch's to_qkv layout), the CLS row's packed qkv (B, 3*H*dh), sbias
// (B, L, 1+L) fp32 (column 0 the CLS key) and a CLS-row bias read through
// (B, G, L) strides. The token rows pack P groups, each padded from L to Lp
// rows, into one tile of PL = P*Lp rows (a multiple of 16, at most 128) and
// take DENSE logits over the tile under an additive block-diagonal bias:
//   S   = Q~ K^T  (Q~ = bf16(q * dh^-0.5); WMMA bf16, fp32 accumulation)
//   S'  = S + (tile(sbias)[r, c] + (group(r) == group(c) ? 0 : NEG))
//   P   = bf16(softmax([q~ k_cls + sbias[r, 0] | S'[r, :]]))      (fp32)
//   out = bf16(P[:, 1:] V + P[:, 0] v_cls)  (PV through WMMA, fp32 sums)
// with padded key columns at NEG (-0.7 * f32 max) and padded query rows
// dropped. The CLS row (one query over all G*L keys and itself) is a second
// launch, one block per (b, h), rounding as the whole-slice kernel's:
// unnormalised bf16 probabilities before PV, the sum divided out at the end.
//
// Bound on an H100: memory for the real work. At the probe's B = 32, H = 8,
// G*L = 784, dh = 64 a call reads qkv once (38.5 MB) and writes out
// (12.8 MB): 15 us at 3.35 TB/s. The dense tiles multiply the logit and PV
// work by about P*Lp/L (4x on the time axis at P = 4, 2.3x on the space axis
// at P = 2), still far below the tensor cores' rate.
//
// Design: the TPU probe packed P groups into the MXU's 128-row tile to issue
// fewer matrix products; here the packed tile feeds the tensor cores through
// WMMA 16x16x16 fragments. One 8-warp block owns one (b, h, chunk of P
// groups): it stages Q~, K and V of the tile in shared memory as bf16, the
// warps compute the PL x PL logits tile by tile into shared fp32, one warp a
// row adds the biases (the block-diagonal one from indices, never read from
// memory) and takes the fp32 softmax, writing bf16 probabilities over the
// dead Q and K, and the warps run PV tile by tile into the logits' space.
// The CLS row needs every group of (b, h), which no tile block sees, so it
// takes a second launch; nothing is summed across blocks, so there are no
// atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int DH = 64;           // head width
constexpr int MAXPL = 128;       // rows of one packed tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QLD = DH + 8;      // bf16 row stride of the Q, K, V tiles
constexpr int CLS_THREADS = 256;
constexpr float NEG = -0.7f * 3.402823466e38f;  // finite mask value (pallas_attention.py:32)

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

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Shared memory of a tile of PL rows, in bytes from the start:
//   [0, qk)        Q~ and K, bf16 [2][PL][QLD]; later the probabilities [PL][PL+8]
//   [qk, qk+v)     V, bf16 [PL][QLD]
//   [.., +s)       logits S, fp32 [PL][SLD]; later the PV sums
//   then k_cls, v_cls (fp32 [DH] each) and one fp32 per row (the CLS logit,
//   then its probability)
struct TileSmem {
  size_t qk, v, s, total;
  int sld;
  __host__ __device__ explicit TileSmem(int PL) {
    sld = (PL > DH ? PL : DH) + 4;
    qk = align128(size_t(2) * PL * QLD * sizeof(bf16));
    v = align128(size_t(PL) * QLD * sizeof(bf16));
    s = align128(size_t(PL) * sld * sizeof(float));
    total = qk + v + s + align128((2 * DH + PL) * sizeof(float));
  }
};

__global__ void __launch_bounds__(THREADS)
chunked_tok_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkvc,
                   const float* __restrict__ sbias, bf16* __restrict__ out, int G, int L, int H,
                   int P, int Lp, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int PL = P * Lp;
  const TileSmem lay(PL);
  const int SLD = lay.sld;
  const int PLD = PL + 8;  // bf16 row stride of the probabilities
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + PL * QLD;
  bf16* pb = qs;  // written once the logits are in s and Q, K are dead
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.qk);
  float* s = reinterpret_cast<float*>(smem + lay.qk + lay.v);
  float* kcs = reinterpret_cast<float*>(smem + lay.qk + lay.v + lay.s);
  float* vcs = kcs + DH;
  float* lcls = vcs + DH;

  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int inner = H * DH;
  const int c3 = 3 * inner;

  // stage the tile: 16 bytes a thread; padded rows and padded groups are zero
  for (int i = tid; i < PL * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    const int g = chunk * P + r / Lp;
    const int l = r % Lp;
    uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv;
    if (g < G && l < L) {
      const bf16* row = qkv + ((i64(b) * G + g) * L + l) * c3 + h * DH + c;
      qv = *reinterpret_cast<const uint4*>(row);
      kv = *reinterpret_cast<const uint4*>(row + inner);
      vv = *reinterpret_cast<const uint4*>(row + 2 * inner);
      bf16* qe = reinterpret_cast<bf16*>(&qv);
#pragma unroll
      for (int e = 0; e < 8; ++e) qe[e] = __float2bfloat16(bf(qe[e]) * scale);
    }
    *reinterpret_cast<uint4*>(qs + r * QLD + c) = qv;
    *reinterpret_cast<uint4*>(ks + r * QLD + c) = kv;
    *reinterpret_cast<uint4*>(vs + r * QLD + c) = vv;
  }
  if (tid < DH) {
    kcs[tid] = bf(qkvc[i64(b) * c3 + inner + h * DH + tid]);
    vcs[tid] = bf(qkvc[i64(b) * c3 + 2 * inner + h * DH + tid]);
  }
  __syncthreads();

  // CLS-key logits, a warp per row, and the dense logits S = Q~ K^T
  for (int r = warp; r < PL; r += WARPS) {
    const float a = warp_sum(bf(qs[r * QLD + lane]) * kcs[lane] +
                             bf(qs[r * QLD + lane + 32]) * kcs[lane + 32]);
    if (lane == 0) lcls[r] = a;
  }
  const int nt = PL / 16;
  for (int t = warp; t < nt * nt; t += WARPS) {
    const int ti = t / nt;
    const int tj = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, qs + ti * 16 * QLD + kk, QLD);
      wmma::load_matrix_sync(fb, ks + tj * 16 * QLD + kk, QLD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(s + ti * 16 * SLD + tj * 16, acc, SLD, wmma::mem_row_major);
  }
  __syncthreads();

  // biases and the fp32 softmax over [CLS | PL keys], a warp per row
  for (int r = warp; r < PL; r += WARPS) {
    const int grp = r / Lp;
    const int l = r % Lp;
    bf16* prow = pb + r * PLD;
    if (chunk * P + grp >= G || l >= L) {  // a padded query row: dropped, its PV row zero
      for (int j = lane; j < PL; j += 32) prow[j] = __float2bfloat16(0.0f);
      continue;
    }
    const float* srow = s + r * SLD;
    const float* sb = sbias + (i64(b) * L + l) * (L + 1);
    const float cls = lcls[r] + sb[0];
    float x[MAXPL / 32];
    float mx = cls;
#pragma unroll
    for (int j = 0; j < MAXPL / 32; ++j) {
      const int col = lane + 32 * j;
      float val = -INFINITY;
      if (col < PL) {
        const int cl = col % Lp;
        const float tile_bias = (cl < L ? sb[1 + cl] : NEG) + (col / Lp == grp ? 0.0f : NEG);
        val = srow[col] + tile_bias;  // -inf where two NEGs overflow, as in fp32 on the TPU
      }
      x[j] = val;
      mx = fmaxf(mx, val);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXPL / 32; ++j) {
      x[j] = expf(x[j] - mx);
      sum += x[j];
    }
    const float ecls = expf(cls - mx);
    sum = warp_sum(sum) + ecls;
#pragma unroll
    for (int j = 0; j < MAXPL / 32; ++j) {
      const int col = lane + 32 * j;
      if (col < PL) prow[col] = __float2bfloat16(x[j] / sum);
    }
    __syncwarp();  // every lane has read lcls[r]
    if (lane == 0) lcls[r] = bf16_round(ecls / sum);
  }
  __syncthreads();

  // O = P V through WMMA, into the logits' space
  for (int t = warp; t < nt * (DH / 16); t += WARPS) {
    const int ti = t / (DH / 16);
    const int tj = t % (DH / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < PL; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, pb + ti * 16 * PLD + kk, PLD);
      wmma::load_matrix_sync(fb, vs + kk * QLD + tj * 16, QLD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(s + ti * 16 * SLD + tj * 16, acc, SLD, wmma::mem_row_major);
  }
  __syncthreads();

  // out = O + P[:, 0] v_cls for the real rows, two dimensions a lane
  for (int r = warp; r < PL; r += WARPS) {
    const int g = chunk * P + r / Lp;
    const int l = r % Lp;
    if (g >= G || l >= L) continue;
    const int d = 2 * lane;
    const float pc = lcls[r];
    const float o0 = s[r * SLD + d] + pc * vcs[d];
    const float o1 = s[r * SLD + d + 1] + pc * vcs[d + 1];
    *reinterpret_cast<bf162*>(out + ((i64(b) * G + g) * L + l) * inner + h * DH + d) =
        __floats2bfloat162_rn(o0, o1);
  }
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

// The CLS row, one block per (b, h): the G*L logits in shared memory (a warp
// per key), a block-wide max and sum, then PV with 64 threads per group of
// keys and the sum divided out at the end.
__global__ void __launch_bounds__(CLS_THREADS)
chunked_cls_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkvc,
                   const float* __restrict__ row_bias, i64 rb_b, i64 rb_g, i64 rb_l,
                   bf16* __restrict__ out_cls, int G, int L, int H, float scale) {
  extern __shared__ float lg[];  // G*L logits, then unnormalised probabilities
  __shared__ float qsh[DH];
  __shared__ float red[CLS_THREADS / 32];
  __shared__ float accp[CLS_THREADS / DH][DH];
  __shared__ float self_logit;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int inner = H * DH;
  const int c3 = 3 * inner;
  const int N = G * L;
  const bf16* base = qkv + i64(b) * N * c3;
  const bf16* cls = qkvc + i64(b) * c3;
  const int koff = inner + h * DH;
  const int voff = 2 * inner + h * DH;

  if (tid < DH) qsh[tid] = bf16_round(bf(cls[h * DH + tid]) * scale);
  __syncthreads();
  if (warp == 0) {
    const float s = warp_sum(qsh[lane] * bf(cls[koff + lane]) +
                             qsh[lane + 32] * bf(cls[koff + lane + 32]));
    if (lane == 0) self_logit = s;
  }
  for (int t = warp; t < N; t += CLS_THREADS / 32) {
    const bf16* krow = base + i64(t) * c3 + koff;
    const float s = warp_sum(qsh[lane] * bf(krow[lane]) + qsh[lane + 32] * bf(krow[lane + 32]));
    if (lane == 0) lg[t] = s + row_bias[b * rb_b + (t / L) * rb_g + (t % L) * rb_l];
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
  for (int t = grp; t < N; t += CLS_THREADS / DH)
    a = fmaf(bf16_round(lg[t]), bf(base[i64(t) * c3 + voff + d]), a);
  accp[grp][d] = a;
  __syncthreads();
  if (tid < DH) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < CLS_THREADS / DH; ++k) acc += accp[k][tid];
    out_cls[i64(b) * inner + h * DH + tid] =
        __float2bfloat16((acc + ps * bf(cls[voff + tid])) / z);
  }
}

}  // namespace

// qkv (B, G, L, 3*H*dh), qkvc (B, 3*H*dh), sbias (B, L, 1+L) contiguous and
// 16-byte aligned; row_bias fp32 through (B, G, L) element strides; out
// (B, G, L, H*dh) and out_cls (B, H*dh) contiguous.
extern "C" int chunked_attention_fwd(const void* qkv, const void* qkvc, const void* sbias,
                                     const void* row_bias, i64 rb_b, i64 rb_g, i64 rb_l,
                                     void* out, void* out_cls, int B, int G, int L, int H, int dh,
                                     int P, int Lp, void* stream) {
  const int PL = P * Lp;
  if (dh != DH || B < 1 || G < 1 || L < 1 || H < 1 || P < 1 || Lp < L || PL % 16 ||
      PL > MAXPL || B > 65535 || H > 65535 || reinterpret_cast<uintptr_t>(qkv) % 16)
    return int(cudaErrorInvalidValue);
  const size_t cls_smem = size_t(G) * L * sizeof(float);
  if (cls_smem > 48 * 1024) return int(cudaErrorInvalidValue);
  const TileSmem lay(PL);
  cudaError_t err = cudaFuncSetAttribute(chunked_tok_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(lay.total));
  if (err != cudaSuccess) return int(err);
  const float scale = 1.0f / sqrtf(float(DH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (G + P - 1) / P;
  chunked_tok_kernel<<<dim3(chunks, H, B), THREADS, lay.total, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qkvc),
      static_cast<const float*>(sbias), static_cast<bf16*>(out), G, L, H, P, Lp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  chunked_cls_kernel<<<dim3(H, B), CLS_THREADS, cls_smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qkvc),
      static_cast<const float*>(row_bias), rb_b, rb_g, rb_l, static_cast<bf16*>(out_cls), G, L,
      H, scale);
  return int(cudaGetLastError());
}
