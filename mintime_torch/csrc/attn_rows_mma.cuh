// The forward attention of one warp's 16 query rows over one group's keys
// on Hopper's tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators),
// shared by csrc/grouped_attention.cu, csrc/divided_attention.cu,
// csrc/token_rows_attention.cu and csrc/chunked_attention.cu (whose packed
// tile of P groups is one "group" of 1 + P*Lp keys under a block-diagonal
// bias), and the swizzled tiles and products the backward kernels build on.
// token_rows_mma_kernel, the token rows of whole groups (a block a group and
// head), is launched by the divided forward and by the token-row forward
// above 16 frames.
//
// The group's T = 1 + L keys and values sit in shared memory in bf16, the
// CLS pair as row 0, rows padded with zeros to a multiple of 16, each row
// DH = 64 values (narrower heads padded with zeros), its 16-byte chunks
// swizzled by the row (see sw) so that ldmatrix reads them conflict-free.
// The warp's q rows arrive as A fragments in registers. Per row r:
//   S = scale * q_r [k_cls; K]^T + bias_r        (fp32; padded keys at NEG)
//   P = bf16(exp(S - max S) / sum exp(S - max S))  (normalised, then rounded)
//   o = P[1:] V + P[0] v_cls                      (fp32 sums; the CLS term last)
// which is what both TPU kernels compute (mintime_tpu/ops/
// pallas_attention.py:58-67 for _kernel, :191-199 for _divided_kernel's
// token rows). Two passes over S, each a 16-key tile at a time: the first
// keeps each row's running max and sum, the second recomputes S, forms P
// with the final max and sum and multiplies it into V. P's accumulator
// fragments are P's A fragments as they stand, with the CLS column set to
// zero; P[0] v_cls is added in fp32 after the token sum. An online softmax
// that rescales o would round P elsewhere than the TPU kernels do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace attn_rows {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

constexpr int DH = 64;                          // row width in shared memory
constexpr float NEG = -0.7f * 3.402823466e38f;  // the finite mask value

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// Offset of element (r, c) of a [.][DH] bf16 tile in shared memory whose
// 16-byte chunks are swizzled by the row (chunk c/8 of row r at chunk
// (c/8) ^ (r % 8)): eight rows' same chunk fall in eight bank groups, so
// ldmatrix and the staging copies read and write conflict-free, unpadded.
__device__ __forceinline__ int sw(int r, int c) {
  return r * DH + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// Rows first .. end-1 of a swizzled tile: row first + r from src + r * stride
// while r < rows, zeros after. With `width` = DH and src and stride 16-byte
// aligned the rows go by 16-byte cp.async; otherwise (narrower heads) by
// 4-byte loads, zeros from column `width` on (width even).
__device__ __forceinline__ void stage_rows(bf16* tile, int first, const bf16* src, i64 stride,
                                           int rows, int end, int width = DH) {
  if (width == DH) {
    for (int i = threadIdx.x; i < (end - first) * (DH / 8); i += blockDim.x) {
      const int r = i / (DH / 8);
      const int c = i % (DH / 8) * 8;
      uint4* d = reinterpret_cast<uint4*>(tile + sw(first + r, c));
      if (r < rows)
        warp_mma::cp_async16(d, src + r * stride + c);
      else
        *d = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < (end - first) * (DH / 2); i += blockDim.x) {
    const int r = i / (DH / 2);
    const int c = i % (DH / 2) * 2;
    *reinterpret_cast<uint32_t*>(tile + sw(first + r, c)) =
        r < rows && c < width ? *reinterpret_cast<const uint32_t*>(src + r * stride + c) : 0u;
  }
}

// The A fragments (16 x DH) of rows r0 .. r0+15 of a bf16 matrix in global
// memory (row r at src + r * stride), rows from `rows` on and columns from
// `width` on zero (width even): read once a warp, straight into registers.
__device__ __forceinline__ void load_a(uint32_t a[DH / 16][4], const bf16* src, i64 stride,
                                       int r0, int rows, int lane, int width = DH) {
#pragma unroll
  for (int k = 0; k < DH / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + (lane >> 2) + (i & 1) * 8;
      const int c = k * 16 + (i >> 1) * 8 + 2 * (lane & 3);
      a[k][i] = r < rows && c < width ? *reinterpret_cast<const uint32_t*>(src + r * stride + c)
                                      : 0u;
    }
}

// s[n] (16 x 8, n = 0, 1) = A (16 x DH, fragments a[k]) times rows
// n0 .. n0+15 of the swizzled tile m, transposed (16 x 16 of A m^T)
__device__ __forceinline__ void mma_rows_t(float s[2][4], const uint32_t a[DH / 16][4],
                                           const bf16* m, int n0, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
#pragma unroll
  for (int k = 0; k < DH / 16; ++k) {
    uint32_t b[4];
    warp_mma::ldmatrix_x4(b, m + sw(n0 + (lane & 7) + ((lane >> 4) << 3),
                                    k * 16 + ((lane >> 3) & 1) * 8));
    warp_mma::mma_bf16(s[0], a[k], b[0], b[1]);
    warp_mma::mma_bf16(s[1], a[k], b[2], b[3]);
  }
}

// o (16 x DH, DH/8 tiles of 8 columns) += p (16 x 16) times rows k0 .. k0+15
// of the swizzled tile m
__device__ __forceinline__ void mma_pv(float o[DH / 8][4], const uint32_t p[4], const bf16* m,
                                       int k0, int lane) {
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    uint32_t b[4];
    warp_mma::ldmatrix_x4_trans(b, m + sw(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          n * 16 + (lane >> 4) * 8));
    warp_mma::mma_bf16(o[2 * n], p, b[0], b[1]);
    warp_mma::mma_bf16(o[2 * n + 1], p, b[2], b[3]);
  }
}

// The bias of a warp's rows read from memory: row x's (x = 0, 1: this
// thread's rows grp and grp + 8) over the T keys at brow[x] (fp32, column 0
// the CLS key), or none where brow[x] is null.
struct RowBias {
  const float* brow[2];
  // the bias of row x at key t, 0 past the T keys
  __device__ __forceinline__ float operator()(int x, int t, int T) const {
    return brow[x] != nullptr && t < T ? brow[x][t] : 0.0f;
  }
};

// The warp's 16 rows (this thread's rows grp = lane / 4 and grp + 8, as in
// the C fragments) against keys 0 .. T-1 of the swizzled tiles ks and vs
// (row 0 the CLS pair, zeros from T to pad16(T)). q is the rows' A fragments;
// bias(x, t, T) the fp32 bias of this thread's row x (0, 1) at key t (key 0
// the CLS key; 0 from T on): a RowBias, or a function of (row, key) such as
// the chunked attention's block-diagonal one. Returns o (16 x DH) in C
// fragments, fp32. Padded query rows (zero fragments) come out finite and
// are the caller's to drop.
//
// NT = 0 (any T): two passes over S, a 16-key tile at a time. NT > 0 (T <=
// 16 * NT; a T known when compiling folds the key-range tests): one pass, S
// of all NT key tiles held in registers (8 NT floats a thread), each row's
// max and sum taken over them at once, then all of P rounded to bf16 before
// PV. The same P = bf16(exp(S - max) / sum), its sum taken without the
// online rescaling, so P may differ from the two-pass P in its last bit.
template <int NT = 0, class Bias>
__device__ __forceinline__ void attend_rows(float o[DH / 8][4], const uint32_t q[DH / 16][4],
                                            const bf16* ks, const bf16* vs, int T, float scale,
                                            const Bias& bias_of, int lane) {
  const int tig = lane & 3;
  const int Tp = pad16(T);
  // S of keys kb .. kb+15, scaled and biased, padded keys at NEG
  auto logits = [&](float s[2][4], int kb) {
    float bias[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // issued before the products, to hide its latency
        const int t = kb + n * 8 + 2 * tig + (i & 1);
        bias[n][i] = bias_of(i >> 1, t, T);
      }
    mma_rows_t(s, q, ks, kb, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[n][i] = kb + n * 8 + 2 * tig + (i & 1) < T ? fmaf(s[n][i], scale, bias[n][i]) : NEG;
  };

  if constexpr (NT > 0) {
    // one pass: S of all NT key tiles, then each row's max and sum over them
    float s[NT][2][4];
#pragma unroll
    for (int k = 0; k < NT; ++k) logits(s[k], 16 * k);
    float m[2] = {NEG, NEG}, sum[2] = {0.0f, 0.0f}, inv[2];
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i >> 1] = fmaxf(m[i >> 1], s[k][n][i]);
#pragma unroll
    for (int x = 0; x < 2; ++x) {  // the row's four lanes agree on its max
      m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 1));
      m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 2));
    }
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[k][n][i] = 16 * k + n * 8 + 2 * tig + (i & 1) < T ? __expf(s[k][n][i] - m[i >> 1])
                                                              : 0.0f;
          sum[i >> 1] += s[k][n][i];
        }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 1);
      sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 2);
      inv[x] = 1.0f / sum[x];
    }
    // P = bf16(exp(S - m) / sum), all of it before PV, so S's registers free
    float pc[2] = {0.0f, 0.0f};  // P[r][0]
    uint32_t p[NT][4];
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // A fragment j: C tile j / 2, row half j % 2
        const float* c = s[k][j >> 1] + (j & 1) * 2;
        const float p1 = c[1] * inv[j & 1];
        __nv_bfloat162 pb = __floats2bfloat162_rn(c[0] * inv[j & 1], p1);
        if (k == 0 && j < 2 && tig == 0) {  // the CLS column: kept aside, zero in the product
          pc[j & 1] = __low2float(pb);
          pb = __floats2bfloat162_rn(0.0f, p1);
        }
        p[k][j] = warp_mma::as_u32(pb);
      }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
#pragma unroll
    for (int k = 0; k < NT; ++k) mma_pv(o, p[k], vs, 16 * k, lane);

    // o += P[:, 0] v_cls, in fp32 after the token sum
#pragma unroll
    for (int x = 0; x < 2; ++x) pc[x] = __shfl_sync(0xffffffffu, pc[x], lane & ~3);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const float2 vc =
          __bfloat1622float2(*reinterpret_cast<const bf162*>(vs + sw(0, n * 8 + 2 * tig)));
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = fmaf(pc[i >> 1], (i & 1) ? vc.y : vc.x, o[n][i]);
    }
  } else {
    // pass 1: each row's max and sum, online
    float m[2] = {NEG, NEG}, sum[2] = {0.0f, 0.0f};
    for (int kb = 0; kb < Tp; kb += 16) {
      float s[2][4];
      logits(s, kb);
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mt[i >> 1] = fmaxf(mt[i >> 1], s[n][i]);
#pragma unroll
      for (int x = 0; x < 2; ++x) {  // the row's four lanes agree on its max
        mt[x] = fmaxf(mt[x], __shfl_xor_sync(0xffffffffu, mt[x], 1));
        mt[x] = fmaxf(mt[x], __shfl_xor_sync(0xffffffffu, mt[x], 2));
        sum[x] *= __expf(m[x] - mt[x]);
        m[x] = mt[x];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kb + n * 8 + 2 * tig + (i & 1) < T) sum[i >> 1] += __expf(s[n][i] - m[i >> 1]);
    }
    float inv[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 1);
      sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 2);
      inv[x] = 1.0f / sum[x];
    }

    // pass 2: P = bf16(exp(S - m) / sum), o = P[:, 1:] V
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
    float pc[2] = {0.0f, 0.0f};  // P[r][0], held by the lanes with tig == 0
    for (int kb = 0; kb < Tp; kb += 16) {
      float s[2][4];
      logits(s, kb);
      uint32_t p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // A fragment j: C tile j / 2, row half j % 2
        const float* c = s[j >> 1] + (j & 1) * 2;
        const int t = kb + (j >> 1) * 8 + 2 * tig;
        const float p0 = t < T ? __expf(c[0] - m[j & 1]) * inv[j & 1] : 0.0f;
        const float p1 = t + 1 < T ? __expf(c[1] - m[j & 1]) * inv[j & 1] : 0.0f;
        __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
        if (t == 0) {  // the CLS column: kept aside, zero in the product
          pc[j & 1] = __low2float(pb);
          pb = __floats2bfloat162_rn(0.0f, p1);
        }
        p[j] = warp_mma::as_u32(pb);
      }
      mma_pv(o, p, vs, kb, lane);
    }

    // o += P[:, 0] v_cls, in fp32 after the token sum
#pragma unroll
    for (int x = 0; x < 2; ++x) pc[x] = __shfl_sync(0xffffffffu, pc[x], lane & ~3);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const float2 vc =
          __bfloat1622float2(*reinterpret_cast<const bf162*>(vs + sw(0, n * 8 + 2 * tig)));
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = fmaf(pc[i >> 1], (i & 1) ? vc.y : vc.x, o[n][i]);
    }
  }
}

// The A fragments (16 x DH) of rows 0 .. 15 of a swizzled tile, by ldmatrix
__device__ __forceinline__ void load_a_smem(uint32_t a[DH / 16][4], const bf16* m, int lane) {
#pragma unroll
  for (int k = 0; k < DH / 16; ++k)
    warp_mma::ldmatrix_x4(a[k], m + sw(lane & 15, k * 16 + (lane >> 4) * 8));
}

// acc (16 x DH, 8 tiles of 8 columns) += (hi + lo) (16 x 16) times rows
// k0 .. k0+15 of the swizzled tile m: an fp32 operand split into two bf16
// parts keeps about 16 bits of its mantissa through the product
__device__ __forceinline__ void mma_split(float acc[DH / 8][4], const uint32_t hi[4],
                                          const uint32_t lo[4], const bf16* m, int k0, int lane) {
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    uint32_t b[4];
    warp_mma::ldmatrix_x4_trans(b, m + sw(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          n * 16 + (lane >> 4) * 8));
    warp_mma::mma_bf16(acc[2 * n], hi, b[0], b[1]);
    warp_mma::mma_bf16(acc[2 * n + 1], hi, b[2], b[3]);
    warp_mma::mma_bf16(acc[2 * n], lo, b[0], b[1]);
    warp_mma::mma_bf16(acc[2 * n + 1], lo, b[2], b[3]);
  }
}

constexpr int MMA_WARPS = 4;  // most warps a block of token_rows_mma_kernel

// Token rows of whole groups on the tensor cores: a block of min(MMA_WARPS,
// tiles) warps per (b, g, h), warp w taking the group's 16-row tiles w,
// w + warps, ... It stages the group's K and V (CLS as row 0) by 16-byte
// cp.async into swizzled rows and runs attend_rows on each tile. With dh =
// 64 the scale 1/8 is a power of two, so bf16(q / 8) = q / 8 exactly: q is
// read as it is, straight into A fragments, and the scale is applied to S.
// Dynamic shared memory: 2 * pad16(L + 1) * DH bf16.
__global__ void __launch_bounds__(MMA_WARPS * 32)
token_rows_mma_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                      const bf16* __restrict__ qkvc, i64 scb,
                      const float* __restrict__ seq_bias, bf16* __restrict__ out, i64 ob,
                      i64 og, i64 ol, int L, int H, float scale) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int T = L + 1;  // CLS key + L keys
  const int Tp = pad16(T);
  const int h = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  bf16* ks = reinterpret_cast<bf16*>(mma_smem);  // [Tp][DH]  k_cls, K, zeros (swizzled)
  bf16* vs = ks + Tp * DH;                       // [Tp][DH]  v_cls, V, zeros (swizzled)
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

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles = (L + 15) / 16;
  const int warps = blockDim.x / 32;
  uint32_t qa[DH / 16][4];  // the first tile's q, loaded while the copies run
  load_a(qa, base + qoff, sl, warp * 16, L, lane);
  warp_mma::cp_async_wait_all();
  __syncthreads();

  const int grp = lane >> 2;
  const int tig = lane & 3;
  for (int tile = warp; tile < tiles; tile += warps) {  // warp-uniform
    if (tile != warp) load_a(qa, base + qoff, sl, tile * 16, L, lane);
    const int row[2] = {tile * 16 + grp, tile * 16 + grp + 8};
    RowBias bias = {{nullptr, nullptr}};
    if (seq_bias != nullptr)
#pragma unroll
      for (int x = 0; x < 2; ++x) bias.brow[x] = seq_bias + (i64(b) * L + min(row[x], L - 1)) * T;
    float o[DH / 8][4];
    attend_rows(o, qa, ks, vs, T, scale, bias, lane);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (row[x] >= L) continue;
      bf16* orow = out + b * ob + g * og + row[x] * ol + h * DH;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        *reinterpret_cast<bf162*>(orow + c * 8 + 2 * tig) =
            __floats2bfloat162_rn(o[c][2 * x], o[c][2 * x + 1]);
    }
  }
}

// Launch token_rows_mma_kernel over (H, G, B) for L <= 256 (16-byte aligned
// starts and strides, checked by the caller)
inline cudaError_t launch_token_rows_mma(const bf16* qkv, i64 sb, i64 sg, i64 sl, const bf16* qkvc,
                                         i64 scb, const float* seq_bias, bf16* out, i64 ob, i64 og,
                                         i64 ol, int B, int G, int L, int H, float scale,
                                         cudaStream_t s) {
  const int smem = 2 * pad16(L + 1) * DH * int(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(token_rows_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (L + 15) / 16;
  const int warps = tiles < MMA_WARPS ? tiles : MMA_WARPS;
  token_rows_mma_kernel<<<dim3(H, G, B), warps * 32, smem, s>>>(qkv, sb, sg, sl, qkvc, scb,
                                                                seq_bias, out, ob, og, ol, L, H,
                                                                scale);
  return cudaGetLastError();
}

}  // namespace attn_rows
