// Backward of the fused GEGLU feed-forward for Hopper (sm_90a), bf16 in.
//
// Replaces: mintime_tpu/ops/pallas_ffn.py::_bwd_kernel (reached through
// _bwd_call and the custom_vjp of _geglu_core). With W0 (2H, D), W1 (D, H)
// in PyTorch's Linear layout, the model width D = 512 or 256 (a template
// parameter of the dh kernel; the products take it at run time), and dout the
// cotangent of out:
//     h     = bf16(x @ W0^T + b0)                 recomputed, fp32 accumulation
//     g     = gelu_erf(gate), prod = bf16(val * g)  (gate math in fp32)
//     dprod = dout @ W1                           (fp32)
//     dh    = bf16([dprod * g | dprod * val * gelu'(gate)])
//     dx    = bf16(dh @ W0)        dW0 = dh^T @ x       db0 = sum_rows dh
//     dW1   = dout^T @ prod        db1 = sum_rows dout
// with every weight and bias gradient accumulated and returned in fp32.
//
// Bound on an H100: tensor-core operations at the token rows. At M = 6272,
// D = 512, H = 2048 one call is 2*M*D*(2H + H + 2H + 2H + H) = 105 GFLOP,
// about 0.11 ms at 989 TFLOP/s (M = 81920, D = 256, H = 1024: 344 GFLOP,
// 0.35 ms). At M = 8 (the CLS rows) it is bytes: the weights read (6 MB) and
// the fp32 gradients written (12.6 MB).
//
// Design. The TPU kernel walks a sequential grid and carries the weight
// gradients in VMEM from one row tile to the next; a GPU grid runs its
// blocks in parallel, so the work splits into launches that each own their
// outputs and reduce in a fixed order (deterministic, no atomics):
//   1. ffn_bwd_dh_kernel: one 8-warp block per 32-row tile (and, when the
//      row tiles are too few to fill the card, per share of the hidden
//      width) recomputes h and dprod for one chunk of 64 hidden columns at a
//      time with WMMA from the x and dout tiles held in shared memory, runs
//      the gate math in fp32, and writes dh (M, 2H) and prod (M, H) in bf16
//      to device memory, plus fp32 per-tile column sums of dh and dout.
//      dh and prod are the bytes the TPU kernel kept in VMEM: 3 * M * H * 2
//      bytes, 77 MB at M = 6272, written once and read back once.
//   2. ffn_bwd_colsum_kernel: db0 and db1 from the per-tile sums, in tile
//      order.
//   3. ffn_bwd_gemm_kernel, three times: dx = dh @ W0, dW0 = dh^T @ x,
//      dW1 = dout^T @ prod, 64 x 64 output tiles, 32-deep K steps through
//      shared memory, one block owning each output tile over the whole K.
// Making the products asynchronous (TMA, wgmma) and keeping dh on chip is
// the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;         // rows per block of the dh kernel
constexpr int HC = 64;         // hidden columns per chunk (val and gate each)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RT = BM / 16;    // row tiles per block
constexpr int HS_LD = 2 * HC + 4;  // fp32: recomputed [val | gate] chunk, then dh
constexpr int GS_LD = HC + 4;      // fp32: dprod chunk
constexpr size_t HS_BYTES = size_t(BM) * HS_LD * 4;
constexpr size_t GS_BYTES = size_t(BM) * GS_LD * 4;

// the constants of the dh kernel that follow the model width D
template <int D>
struct Width {
  static_assert(D % 16 == 0, "whole 16-deep WMMA steps over the width");
  static constexpr int XS_LD = D + 8;  // bf16, padded against bank conflicts
  static constexpr size_t XS_BYTES = size_t(BM) * XS_LD * 2;
  static constexpr size_t SMEM_BYTES = 2 * XS_BYTES + HS_BYTES + GS_BYTES;
};

static_assert(2 * HC / 16 == WARPS, "one up-projection column tile per warp");
static_assert(RT * (HC / 16) == WARPS, "one dprod tile per warp");

constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_dh_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                  const bf16* __restrict__ b0, const bf16* __restrict__ w1,
                  const bf16* __restrict__ dout, bf16* __restrict__ dh,
                  bf16* __restrict__ prod, float* __restrict__ db0_part,
                  float* __restrict__ db1_part, int M, int hidden) {
  constexpr int XS_LD = Width<D>::XS_LD;
  constexpr size_t XS_BYTES = Width<D>::XS_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ds = reinterpret_cast<bf16*>(smem + XS_BYTES);
  float* hs = reinterpret_cast<float*>(smem + 2 * XS_BYTES);
  float* gs = reinterpret_cast<float*>(smem + 2 * XS_BYTES + HS_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int two_h = 2 * hidden;
  const int chunks = hidden / HC;
  const int h_begin = int(blockIdx.y) * chunks / int(gridDim.y) * HC;
  const int h_end = (int(blockIdx.y) + 1) * chunks / int(gridDim.y) * HC;

  // x and dout tiles into shared memory, 16 bytes a thread; rows past M are zero
  for (int i = tid; i < BM * (D / 8); i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 vx = make_uint4(0, 0, 0, 0), vd = make_uint4(0, 0, 0, 0);
    if (row0 + r < M) {
      vx = *reinterpret_cast<const uint4*>(x + size_t(row0 + r) * D + c);
      vd = *reinterpret_cast<const uint4*>(dout + size_t(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = vx;
    *reinterpret_cast<uint4*>(ds + r * XS_LD + c) = vd;
  }
  __syncthreads();

  // db1: this tile's column sums of dout (once per row tile)
  if (blockIdx.y == 0) {
    for (int c = tid; c < D; c += THREADS) {
      float a = 0.0f;
      for (int r = 0; r < BM; ++r) a += __bfloat162float(ds[r * XS_LD + c]);
      db1_part[size_t(blockIdx.x) * D + c] = a;
    }
  }

  for (int h0 = h_begin; h0 < h_end; h0 += HC) {
    // recompute the up-projection: warp w owns column tile w of [val | gate]
    {
      const int n0 = warp < WARPS / 2 ? h0 + warp * 16 : hidden + h0 + (warp - WARPS / 2) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(acc[rt], 0.0f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag;
        wmma::load_matrix_sync(bfrag, w0 + size_t(n0) * D + k, D);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, xs + rt * 16 * XS_LD + k, XS_LD);
          wmma::mma_sync(acc[rt], afrag, bfrag, acc[rt]);
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
        wmma::store_matrix_sync(hs + rt * 16 * HS_LD + warp * 16, acc[rt], HS_LD,
                                wmma::mem_row_major);
    }
    // dprod = dout @ W1[:, chunk]: warp w owns row tile w / 4, column tile w % 4
    {
      const int rt = warp / (HC / 16);
      const int ct = warp % (HC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
        wmma::load_matrix_sync(afrag, ds + rt * 16 * XS_LD + k, XS_LD);
        wmma::load_matrix_sync(bfrag, w1 + size_t(k) * hidden + h0 + ct * 16, hidden);
        wmma::mma_sync(acc, afrag, bfrag, acc);
      }
      wmma::store_matrix_sync(gs + rt * 16 * GS_LD + ct * 16, acc, GS_LD, wmma::mem_row_major);
    }
    __syncthreads();

    // bias, bf16 rounding, exact GELU and its derivative in fp32; dh back
    // into hs (as the bf16 value it is stored as) for the column sums
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC;
      const int c = i % HC;
      const int row = row0 + r;
      const float val = bf16_round(hs[r * HS_LD + c] + __bfloat162float(b0[h0 + c]));
      const float gate =
          bf16_round(hs[r * HS_LD + HC + c] + __bfloat162float(b0[hidden + h0 + c]));
      const float cdf = 0.5f * (1.0f + erff(gate * INV_SQRT2));
      const float g = gate * cdf;
      const float dgelu = cdf + gate * expf(-0.5f * gate * gate) * INV_SQRT_2PI;
      const float dp = gs[r * GS_LD + c];
      const bf16 dval = __float2bfloat16(dp * g);
      const bf16 dgate = __float2bfloat16(dp * val * dgelu);
      if (row < M) {
        prod[size_t(row) * hidden + h0 + c] = __float2bfloat16(val * g);
        dh[size_t(row) * two_h + h0 + c] = dval;
        dh[size_t(row) * two_h + hidden + h0 + c] = dgate;
        hs[r * HS_LD + c] = __bfloat162float(dval);
        hs[r * HS_LD + HC + c] = __bfloat162float(dgate);
      } else {
        hs[r * HS_LD + c] = 0.0f;
        hs[r * HS_LD + HC + c] = 0.0f;
      }
    }
    __syncthreads();

    // db0: this tile's column sums of the chunk's dh
    if (tid < 2 * HC) {
      float a = 0.0f;
      for (int r = 0; r < BM; ++r) a += hs[r * HS_LD + tid];
      const int col = tid < HC ? h0 + tid : hidden + h0 + tid - HC;
      db0_part[size_t(blockIdx.x) * two_h + col] = a;
    }
    __syncthreads();  // hs and gs are rewritten by the next chunk
  }
}

// out[c] = sum over p < P, in order, of part[p * C + c]
__global__ void ffn_bwd_colsum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      int P, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.0f;
  for (int p = 0; p < P; ++p) a += part[size_t(p) * C + c];
  out[c] = a;
}

constexpr int GBM = 64;
constexpr int GBN = 64;
constexpr int GBK = 32;
constexpr int G_THREADS = 128;  // 4 warps, 2 x 2, each a 32 x 32 output tile
constexpr int AR_LD = GBK + 8;  // A row-major tile [GBM][AR_LD]
constexpr int AC_LD = GBM + 8;  // A column-major tile [GBK][AC_LD]
constexpr int B_LD = GBN + 8;   // B tile [GBK][B_LD]

// C (M x N, row-major, ldc) = A (M x K) @ B (K x N), fp32 accumulation.
// A is row-major (A[m * lda + k]) or, with A_COL, column-major
// (A[k * lda + m]); B is row-major (B[k * ldb + n]). Loads are 8 bf16 wide
// along the contiguous axis, which the launcher requires to be a multiple of
// 8; the other axes are masked element by element (zero rows in, none out).
template <bool A_COL, bool OUT_F32>
__global__ void __launch_bounds__(G_THREADS)
ffn_bwd_gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
                    void* __restrict__ C, int ldc, int M, int N, int K) {
  __shared__ __align__(32) bf16 a_tile[A_COL ? GBK * AC_LD : GBM * AR_LD];
  __shared__ __align__(32) bf16 bs[GBK * B_LD];
  __shared__ __align__(32) float stage[G_THREADS / 32][256];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.y * GBM;
  const int n0 = blockIdx.x * GBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GBK) {
    // 256 vectors of 8 for each tile, two a thread
    for (int v = tid; v < GBM * GBK / 8; v += G_THREADS) {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (A_COL) {
        const int kr = v / (GBM / 8);
        const int mc = (v % (GBM / 8)) * 8;
        if (k0 + kr < K && m0 + mc < M)
          val = *reinterpret_cast<const uint4*>(A + size_t(k0 + kr) * lda + m0 + mc);
        *reinterpret_cast<uint4*>(a_tile + kr * AC_LD + mc) = val;
      } else {
        const int mr = v / (GBK / 8);
        const int kc = (v % (GBK / 8)) * 8;
        if (m0 + mr < M && k0 + kc < K)
          val = *reinterpret_cast<const uint4*>(A + size_t(m0 + mr) * lda + k0 + kc);
        *reinterpret_cast<uint4*>(a_tile + mr * AR_LD + kc) = val;
      }
    }
    for (int v = tid; v < GBK * GBN / 8; v += G_THREADS) {
      const int kr = v / (GBN / 8);
      const int nc = (v % (GBN / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + kr < K && n0 + nc < N)
        val = *reinterpret_cast<const uint4*>(B + size_t(k0 + kr) * ldb + n0 + nc);
      *reinterpret_cast<uint4*>(bs + kr * B_LD + nc) = val;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfrag[j], bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (A_COL) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> afrag;
          wmma::load_matrix_sync(afrag, a_tile + kk * AC_LD + wm * 32 + i * 16, AC_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], afrag, bfrag[j], acc[i][j]);
        } else {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, a_tile + (wm * 32 + i * 16) * AR_LD + kk, AR_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], afrag, bfrag[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + e / 16;
        const int n = n0 + wn * 32 + j * 16 + e % 16;
        if (m < M && n < N) {
          if (OUT_F32)
            static_cast<float*>(C)[size_t(m) * ldc + n] = st[e];
          else
            static_cast<bf16*>(C)[size_t(m) * ldc + n] = __float2bfloat16(st[e]);
        }
      }
      __syncwarp();
    }
  }
}

template <bool A_COL, bool OUT_F32>
cudaError_t gemm(const bf16* A, int lda, const bf16* B, int ldb, void* C, int ldc, int M, int N,
                 int K, cudaStream_t s) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  ffn_bwd_gemm_kernel<A_COL, OUT_F32><<<grid, G_THREADS, 0, s>>>(A, lda, B, ldb, C, ldc, M, N, K);
  return cudaGetLastError();
}

template <int D>
int launch_dh(const bf16* x, const bf16* w0, const void* b0, const bf16* w1, const bf16* dout,
              bf16* dh, bf16* prod, void* db0_part, void* db1_part, int M, int hidden,
              int splits, cudaStream_t s) {
  constexpr size_t smem = Width<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_dh_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  ffn_bwd_dh_kernel<D><<<dim3((M + BM - 1) / BM, splits), THREADS, smem, s>>>(
      x, w0, static_cast<const bf16*>(b0), w1, dout, dh, prod, static_cast<float*>(db0_part),
      static_cast<float*>(db1_part), M, hidden);
  return int(cudaGetLastError());
}

}  // namespace

// dim: the model width, 512 or 256. splits: how many blocks share the hidden
// width of a row tile in the dh kernel. Scratch from the caller: dh (M, 2H)
// and prod (M, H) bf16, db0_part (tiles, 2H) and db1_part (tiles, dim) fp32,
// tiles = ceil(M / 32). Outputs: dx (M, dim) bf16; dw0 (2H, dim), db0 (2H),
// dw1 (dim, H), db1 (dim) fp32.
extern "C" int geglu_ffn_bwd(const void* x, const void* w0, const void* b0, const void* w1,
                             const void* dout, void* dx, void* dw0, void* db0, void* dw1,
                             void* db1, void* dh, void* prod, void* db0_part, void* db1_part,
                             int M, int dim, int hidden, int splits, void* stream) {
  if (hidden <= 0 || hidden % HC != 0 || M <= 0 || splits < 1 || splits > hidden / HC)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (M + BM - 1) / BM;
  const int two_h = 2 * hidden;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w0b = static_cast<const bf16*>(w0);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* doutb = static_cast<const bf16*>(dout);
  bf16* dhb = static_cast<bf16*>(dh);
  bf16* prodb = static_cast<bf16*>(prod);

  int status;
  if (dim == 512)
    status = launch_dh<512>(xb, w0b, b0, w1b, doutb, dhb, prodb, db0_part, db1_part, M, hidden,
                            splits, s);
  else if (dim == 256)
    status = launch_dh<256>(xb, w0b, b0, w1b, doutb, dhb, prodb, db0_part, db1_part, M, hidden,
                            splits, s);
  else
    return int(cudaErrorInvalidValue);
  if (status != 0) return status;
  cudaError_t err;
  ffn_bwd_colsum_kernel<<<(two_h + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(db0_part), static_cast<float*>(db0), tiles, two_h);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ffn_bwd_colsum_kernel<<<(dim + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(db1_part), static_cast<float*>(db1), tiles, dim);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // dx (M, dim) = dh (M, 2H) @ W0 (2H, dim)
  if ((err = gemm<false, false>(dhb, two_h, w0b, dim, dx, dim, M, dim, two_h, s)) != cudaSuccess)
    return int(err);
  // dW0 (2H, dim) = dh^T @ x: dh read column-major
  if ((err = gemm<true, true>(dhb, two_h, xb, dim, dw0, dim, two_h, dim, M, s)) != cudaSuccess)
    return int(err);
  // dW1 (dim, H) = dout^T @ prod
  return int(gemm<true, true>(doutb, dim, prodb, hidden, dw1, hidden, dim, hidden, M, s));
}
