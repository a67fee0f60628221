// Backward of the fused GEGLU feed-forward for Hopper (sm_90a), bf16 in.
//
// Replaces: mintime_tpu/ops/pallas_ffn.py::_bwd_kernel (reached through
// _bwd_call and the custom_vjp of _geglu_core). With W0 (2H, D), W1 (D, H)
// in PyTorch's Linear layout, the model width D (256 or 512 on the model
// paths; any multiple of 8 here), and dout the cotangent of out:
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
// blocks in parallel, so the work splits into three launches that each own
// their outputs and reduce in a fixed order (deterministic, no atomics):
//   1. ffn_bwd_dh_kernel: one 8-warp block per (128-row tile, 64 hidden
//      columns) recomputes [val | gate] = x W0[chunk]^T, then dprod =
//      dout W1[:, chunk], on mma.sync (warps 4 x 2, each 32 x 32), the
//      operands streamed through one 4-stage cp.async ring of
//      csrc/gemm_mma.cuh's swizzled tiles; h is rounded to bf16 with its
//      bias between the passes and kept packed, so two blocks fit an SM. It
//      runs the gate math in fp32 on the accumulators; writes dh (M, 2H) and
//      prod (M, H) in bf16 through shared memory, 16 bytes a thread; and
//      writes the tile's column sums of dh (a shuffle tree over a warp's
//      rows, then the warp rows in order) and of dout (from the ring, each
//      32-column step by one block of the row tile). dh and prod are the
//      bytes the TPU kernel kept in VMEM.
//   2. ffn_bwd_products_kernel: dW0 = dh^T x, dW1 = dout^T prod and
//      dx = dh W0 in one launch of 128 x 128 tiles on gemm_mma::gemm_tile,
//      the products with the most k a block first. A product whose tiles
//      cannot fill the card splits its reduction into S slices
//      (ops/geglu_ffn.py::product_splits): each (tile, slice) block writes
//      an fp32 partial to scratch.
//   3. ffn_bwd_reduce_kernel: the split products' partials summed in slice
//      order, and db0, db1 from the row tiles' column sums in tile order.
// Keeping dh on chip (dW0 and dx fused into the dh kernel) and wgmma + TMA
// are later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_mma.cuh"

typedef __nv_bfloat16 bf16;
using gemm_mma::BK;

namespace {

constexpr int DM = 128;             // rows of a dh block: 4 warp rows of 32
constexpr int HC = 64;              // hidden columns of a dh block (val and gate each)
constexpr int DH_STAGES = 4;
constexpr int DH_THREADS = 256;
constexpr int DH_WARPS = DH_THREADS / 32;
constexpr int X_ELEMS = DM * BK;    // x or dout ("kc")
constexpr int W_ELEMS = HC * BK;    // W0 val rows, W0 gate rows ("kc"), W1 columns ("rc")
// a stage holds x, W0's val and gate rows (first pass) or dout, W1 (second)
constexpr int DH_STAGE_ELEMS = X_ELEMS + 2 * W_ELEMS;
constexpr size_t DH_RING_BYTES = size_t(DH_STAGES) * DH_STAGE_ELEMS * sizeof(bf16);
constexpr int OUT_LD = 2 * HC + 8;  // staged dh tile [DM][OUT_LD] (val | gate), bf16
constexpr int PROD_LD = HC + 8;     // staged prod tile [DM][PROD_LD]
constexpr size_t OUT_BYTES = size_t(DM) * (OUT_LD + PROD_LD) * sizeof(bf16);
constexpr size_t DH_SMEM_BYTES = DH_RING_BYTES > OUT_BYTES ? DH_RING_BYTES : OUT_BYTES;
static_assert(DM == 32 * (DH_WARPS / 2) && HC == 2 * 32, "warps 4 x 2, each 32 x 32");
static_assert(BK == 32 && DH_THREADS == 8 * BK, "db1: a thread per (column, 16-row group)");

constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return warp_mma::as_u32(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// The dh kernel. Grid (ceil(M / DM), H / HC). Two passes over k = D through
// one cp.async ring: [val | gate] = x W0[chunk]^T, rounded to bf16 with the
// bias and kept packed (half the registers of the fp32 sums), then dprod =
// dout W1[:, chunk]; so a thread holds 64 accumulators at most and two
// blocks share an SM, one's gate math overlapping the other's products.
// Warps 4 x 2, each 32 rows x 32 of the chunk's columns. db0_part (tiles,
// 2H): the tile's column sums of dh. db1_part (tiles, D): dout's, taken
// from the ring in the second pass, k-step kk by the block with
// kk % gridDim.y == y.
__global__ void __launch_bounds__(DH_THREADS, 2)
ffn_bwd_dh_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                  const bf16* __restrict__ b0, const bf16* __restrict__ w1,
                  const bf16* __restrict__ dout, bf16* __restrict__ dh,
                  bf16* __restrict__ prod, float* __restrict__ db0_part,
                  float* __restrict__ db1_part, int M, int D, int hidden) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float colsum[DH_WARPS / 2][2 * HC];  // [warp row][val | gate column]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int row0 = blockIdx.x * DM;
  const int h0 = blockIdx.y * HC;
  const int two_h = 2 * hidden;
  const int wm = warp >> 1;  // the warp's 32 rows and 32 of the chunk's columns
  const int wr0 = wm * 32;
  const int wc0 = (warp & 1) * 32;
  const bool warp_live = row0 + wr0 < M;  // a warp past the last row skips its products

  const int nk = (D + BK - 1) / BK;
  auto stage = [&](int slot, int t) {  // step t < nk: first pass; else the second
    bf16* s = smem + slot * DH_STAGE_ELEMS;
    const int k0 = (t < nk ? t : t - nk) * BK;
    if (t < nk) {
      gemm_mma::stage_kc(s, x, D, row0, DM, M, k0, D, tid, DH_THREADS);
      gemm_mma::stage_kc(s + X_ELEMS, w0, D, h0, HC, two_h, k0, D, tid, DH_THREADS);
      gemm_mma::stage_kc(s + X_ELEMS + W_ELEMS, w0, D, hidden + h0, HC, two_h, k0, D, tid,
                         DH_THREADS);
    } else {
      gemm_mma::stage_kc(s, dout, D, row0, DM, M, k0, D, tid, DH_THREADS);
      gemm_mma::stage_rc(s + X_ELEMS, w1, hidden, k0, D, h0, HC, hidden, tid, DH_THREADS);
    }
  };
  // one step of the ring: wait for step t, free step t - 1's slot, issue step
  // t + DH_STAGES - 1, and return step t's stage
  auto advance = [&](int t) -> const bf16* {
    warp_mma::cp_async_wait<DH_STAGES - 2>();
    __syncthreads();
    if (t + DH_STAGES - 1 < 2 * nk) stage((t + DH_STAGES - 1) % DH_STAGES, t + DH_STAGES - 1);
    warp_mma::cp_async_commit();
    return smem + (t % DH_STAGES) * DH_STAGE_ELEMS;
  };
#pragma unroll
  for (int t = 0; t < DH_STAGES - 1; ++t) {
    if (t < 2 * nk) stage(t, t);
    warp_mma::cp_async_commit();
  }

  // first pass: h = x W0^T for the chunk's val and gate columns
  uint32_t val_h[2][4][2], gate_h[2][4][2];  // bf16(h + b0): [m16 tile][n8 tile][row grp, + 8]
  {
    float acc_v[2][4][4], acc_g[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_v[i][j][e] = acc_g[i][j][e] = 0.0f;
    for (int t = 0; t < nk; ++t) {
      const bf16* s = advance(t);
      if (!warp_live) continue;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t ax[2][4], bv[2][4], bg[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) gemm_mma::frag_a_kc(ax[i], s, wr0 + 16 * i, kk, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          gemm_mma::frag_b_kc(bv[jj], s + X_ELEMS, wc0 + 16 * jj, kk, lane);
          gemm_mma::frag_b_kc(bg[jj], s + X_ELEMS + W_ELEMS, wc0 + 16 * jj, kk, lane);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            warp_mma::mma_bf16(acc_v[i][j], ax[i], bv[j >> 1][(j & 1) * 2], bv[j >> 1][(j & 1) * 2 + 1]);
            warp_mma::mma_bf16(acc_g[i][j], ax[i], bg[j >> 1][(j & 1) * 2], bg[j >> 1][(j & 1) * 2 + 1]);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = h0 + wc0 + 8 * j + 2 * tig;
      const float2 bv = make_float2(__bfloat162float(b0[c]), __bfloat162float(b0[c + 1]));
      const float2 bg = make_float2(__bfloat162float(b0[hidden + c]),
                                    __bfloat162float(b0[hidden + c + 1]));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          val_h[i][j][half] = pack_bf16(acc_v[i][j][2 * half] + bv.x, acc_v[i][j][2 * half + 1] + bv.y);
          gate_h[i][j][half] = pack_bf16(acc_g[i][j][2 * half] + bg.x, acc_g[i][j][2 * half + 1] + bg.y);
        }
    }
  }

  // second pass: dprod = dout W1[:, chunk]; dout's column sums on the way
  float acc_p[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_p[i][j][e] = 0.0f;
  float* red = &colsum[0][0];  // free until the epilogue
  for (int t = nk; t < 2 * nk; ++t) {
    const bf16* s = advance(t);
    const int kk0 = t - nk;
    if (kk0 % int(gridDim.y) == int(blockIdx.y)) {  // uniform over the block
      const int c = tid % BK;
      const int g = tid / BK;  // 16-row group
      float a = 0.0f;
#pragma unroll
      for (int r = 16 * g; r < 16 * g + 16; ++r)
        a += __bfloat162float(s[gemm_mma::kc_off(r, c >> 3) + (c & 7)]);
      red[g * BK + c] = a;
      __syncthreads();
      if (tid < BK && kk0 * BK + tid < D) {
        a = 0.0f;
#pragma unroll
        for (int q = 0; q < DH_THREADS / BK; ++q) a += red[q * BK + tid];
        db1_part[size_t(blockIdx.x) * D + kk0 * BK + tid] = a;
      }
    }
    if (!warp_live) continue;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t ad[2][4], bp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) gemm_mma::frag_a_kc(ad[i], s, wr0 + 16 * i, kk, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        gemm_mma::frag_b_rc(bp[jj], s + X_ELEMS, wc0 + 16 * jj, kk, HC, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          warp_mma::mma_bf16(acc_p[i][j], ad[i], bp[j >> 1][(j & 1) * 2], bp[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  warp_mma::cp_async_wait<0>();
  __syncthreads();  // the ring becomes the output staging

  // exact GELU and its derivative in fp32, per element of the accumulators;
  // dh and prod into shared memory as bf16, and the warp's column sums of
  // dh (the bf16 values; rows past M count 0)
  bf16* out_s = smem;
  bf16* prod_s = smem + DM * OUT_LD;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float sv[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f};
    const int c = wc0 + 8 * j + 2 * tig;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr0 + 16 * i + grp + 8 * half;
        const bool live = row0 + r < M;
        const float2 vals = unpack_bf16(val_h[i][j][half]);
        const float2 gates = unpack_bf16(gate_h[i][j][half]);
        float dv[2], dg[2], pr[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float val = q ? vals.y : vals.x;
          const float gate = q ? gates.y : gates.x;
          const float cdf = 0.5f * (1.0f + erff(gate * INV_SQRT2));
          const float g = gate * cdf;
          const float dgelu = cdf + gate * expf(-0.5f * gate * gate) * INV_SQRT_2PI;
          const float dp = acc_p[i][j][2 * half + q];
          dv[q] = live ? bf16_round(dp * g) : 0.0f;
          dg[q] = live ? bf16_round(dp * val * dgelu) : 0.0f;
          pr[q] = val * g;
          sv[q] += dv[q];
          sg[q] += dg[q];
        }
        *reinterpret_cast<uint32_t*>(out_s + r * OUT_LD + c) = pack_bf16(dv[0], dv[1]);
        *reinterpret_cast<uint32_t*>(out_s + r * OUT_LD + HC + c) = pack_bf16(dg[0], dg[1]);
        *reinterpret_cast<uint32_t*>(prod_s + r * PROD_LD + c) = pack_bf16(pr[0], pr[1]);
      }
    // sum over the warp's 32 rows: the four rows a lane holds, then the 8 row groups
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sv[q] += __shfl_xor_sync(0xffffffffu, sv[q], off);
        sg[q] += __shfl_xor_sync(0xffffffffu, sg[q], off);
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        colsum[wm][c + q] = sv[q];
        colsum[wm][HC + c + q] = sg[q];
      }
    }
  }
  __syncthreads();

  // db0: the warp rows' sums in order
  if (tid < 2 * HC) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < DH_WARPS / 2; ++w) a += colsum[w][tid];
    const int col = tid < HC ? h0 + tid : hidden + h0 + tid - HC;
    db0_part[size_t(blockIdx.x) * two_h + col] = a;
  }
  // dh and prod rows out, 16 bytes a thread
  constexpr int CPR = HC / 8;  // 16-byte chunks of a 64-column row
  for (int i = tid; i < DM * 3 * CPR; i += DH_THREADS) {
    const int r = i / (3 * CPR);
    const int part = i % (3 * CPR) / CPR;  // 0 val, 1 gate, 2 prod
    const int c = (i % CPR) * 8;
    const int row = row0 + r;
    if (row >= M) continue;
    if (part < 2)
      *reinterpret_cast<uint4*>(dh + size_t(row) * two_h + part * hidden + h0 + c) =
          *reinterpret_cast<const uint4*>(out_s + r * OUT_LD + part * HC + c);
    else
      *reinterpret_cast<uint4*>(prod + size_t(row) * hidden + h0 + c) =
          *reinterpret_cast<const uint4*>(prod_s + r * PROD_LD + c);
  }
}

// One product of the products launch: C (M x N) = A (M x K) @ B (K x N)
// (gemm_mma::Operands), over S slices of k of kchunk each. With S = 1 the
// block writes C (fp32, or bf16 with c_bf16); else slice s writes its fp32
// partial to part + s * M * N (row-major, ld N).
struct Product {
  gemm_mma::Operands op;
  int K, S, kchunk;
  void* C;
  bool c_bf16;
  float* part;
  int tiles_n, blocks;
};

struct Products {
  Product p[3];
  int n;
};

__global__ void __launch_bounds__(gemm_mma::THREADS, gemm_mma::MIN_BLOCKS)
ffn_bwd_products_kernel(const __grid_constant__ Products job) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int b = blockIdx.x;
  int which = 0;
  while (which + 1 < job.n && b >= job.p[which].blocks) b -= job.p[which++].blocks;
  const Product p = job.p[which];
  const int tiles = p.blocks / p.S;
  const int slice = b / tiles;
  const int tile = b - slice * tiles;
  const int m0 = tile / p.tiles_n * gemm_mma::BM;
  const int n0 = tile % p.tiles_n * gemm_mma::BN;
  const int kb = slice * p.kchunk;
  const int ke = min(p.K, kb + p.kchunk);
  float acc[gemm_mma::MT][gemm_mma::NT][4];
  gemm_mma::gemm_tile(p.op, m0, n0, kb, ke, reinterpret_cast<bf16*>(smem_raw), acc);

  const int M = p.op.M, N = p.op.N;
#pragma unroll
  for (int i = 0; i < gemm_mma::MT; ++i)
#pragma unroll
    for (int j = 0; j < gemm_mma::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + gemm_mma::acc_row(i, 2 * h);
        const int n = n0 + gemm_mma::acc_col(j);
        if (m >= M || n >= N) continue;  // N is a multiple of 8: n + 1 < N too
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t at = size_t(m) * N + n;
        if (p.S > 1)
          *reinterpret_cast<float2*>(p.part + size_t(slice) * M * N + at) = make_float2(v0, v1);
        else if (p.c_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + at) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.C) + at) = make_float2(v0, v1);
      }
}

// out[i] = sum over s < S, in order, of part[s * n + i] (bf16 out with
// to_bf16); one launch for up to five such sums. A block of 256 threads
// takes groups of E = 256 / R consecutive i in turn, R = the largest power
// of two up to min(S, 8): its R runs of threads sum R consecutive stretches
// of the S terms, then the first run adds the R stretches in order, so the
// result depends on S alone.
struct Sum {
  const float* part;
  void* out;
  bool to_bf16;
  int n, S;
};

struct Sums {
  Sum s[5];
  int first[6];  // first block of each sum; first[count] = all blocks
  int count;
};

constexpr int RED_THREADS = 256;
constexpr int RED_BLOCKS = 512;  // blocks a sum, at most

__host__ __device__ __forceinline__ int sum_runs(int S) {
  return S >= 8 ? 8 : S >= 4 ? 4 : S >= 2 ? 2 : 1;
}

__global__ void __launch_bounds__(RED_THREADS)
ffn_bwd_reduce_kernel(const __grid_constant__ Sums job) {
  __shared__ float runs[RED_THREADS];
  int which = 0;
  while (which + 1 < job.count && int(blockIdx.x) >= job.first[which + 1]) ++which;
  const Sum& s = job.s[which];
  const int R = sum_runs(s.S);
  const int E = RED_THREADS / R;  // elements of a group
  const int e = threadIdx.x % E;
  const int run = threadIdx.x / E;
  const int k0 = run * s.S / R;
  const int k1 = (run + 1) * s.S / R;
  const int blocks = job.first[which + 1] - job.first[which];
  for (int g = int(blockIdx.x) - job.first[which]; g * E < s.n; g += blocks) {
    const int i = g * E + e;
    float a = 0.0f;
    if (i < s.n) {
#pragma unroll 4
      for (int k = k0; k < k1; ++k) a += s.part[size_t(k) * s.n + i];
    }
    __syncthreads();  // the last group's runs were read
    runs[threadIdx.x] = a;
    __syncthreads();
    if (run == 0 && i < s.n) {
      for (int r = 1; r < R; ++r) a += runs[r * E + e];
      if (s.to_bf16)
        static_cast<bf16*>(s.out)[i] = __float2bfloat16(a);
      else
        static_cast<float*>(s.out)[i] = a;
    }
  }
}

Product product(const bf16* A, int lda, bool a_col, const bf16* B, int ldb, int M, int N, int K,
                int S, int kchunk, void* C, bool c_bf16, void* part) {
  Product p;
  p.op = {A, lda, a_col, B, ldb, M, N};
  p.K = K;
  p.S = S;
  p.kchunk = kchunk;
  p.C = C;
  p.c_bf16 = c_bf16;
  p.part = static_cast<float*>(part);
  p.tiles_n = (N + gemm_mma::BN - 1) / gemm_mma::BN;
  p.blocks = (M + gemm_mma::BM - 1) / gemm_mma::BM * p.tiles_n * S;
  return p;
}

bool valid_split(int K, int S, int kchunk, const void* part) {
  return S >= 1 && kchunk >= 1 && (kchunk % BK == 0 || S == 1) &&
         size_t(S - 1) * kchunk < size_t(K) && size_t(S) * kchunk >= size_t(K) &&
         (S == 1 || part != nullptr);
}

}  // namespace

// dim: the model width D, a multiple of 8; hidden a multiple of 64. Splits
// of the products' reductions from ops/geglu_ffn.py::product_splits:
// (s_*, k_*) = slices and their length (a multiple of 32 unless S = 1); a
// product with S > 1 takes its fp32 partials in part_* (S x its output).
// Scratch from the caller: dh (M, 2H) and prod (M, H) bf16, db0_part
// (tiles, 2H) and db1_part (tiles, D) fp32, tiles = ceil(M / 128).
// Outputs: dx (M, D) bf16; dw0 (2H, D), db0 (2H), dw1 (D, H), db1 (D) fp32.
extern "C" int geglu_ffn_bwd(const void* x, const void* w0, const void* b0, const void* w1,
                             const void* dout, void* dx, void* dw0, void* db0, void* dw1,
                             void* db1, void* dh, void* prod, void* db0_part, void* db1_part,
                             void* part_dx, void* part_dw0, void* part_dw1, int M, int dim,
                             int hidden, int s_dx, int k_dx, int s_dw0, int k_dw0, int s_dw1,
                             int k_dw1, void* stream) {
  const int two_h = 2 * hidden;
  if (hidden <= 0 || hidden % HC != 0 || M <= 0 || dim <= 0 || dim % 8 != 0 ||
      M > (1 << 30) / max(two_h, dim) || !valid_split(two_h, s_dx, k_dx, part_dx) ||
      !valid_split(M, s_dw0, k_dw0, part_dw0) || !valid_split(M, s_dw1, k_dw1, part_dw1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (M + DM - 1) / DM;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w0b = static_cast<const bf16*>(w0);
  const bf16* doutb = static_cast<const bf16*>(dout);
  bf16* dhb = static_cast<bf16*>(dh);
  bf16* prodb = static_cast<bf16*>(prod);

  cudaError_t err = cudaFuncSetAttribute(ffn_bwd_dh_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(DH_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  ffn_bwd_dh_kernel<<<dim3(tiles, hidden / HC), DH_THREADS, DH_SMEM_BYTES, s>>>(
      xb, w0b, static_cast<const bf16*>(b0), static_cast<const bf16*>(w1), doutb, dhb, prodb,
      static_cast<float*>(db0_part), static_cast<float*>(db1_part), M, dim, hidden);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

  Products job;
  job.n = 3;
  // dW0 (2H, D) = dh^T @ x: dh read column-major
  job.p[0] = product(dhb, two_h, true, xb, dim, two_h, dim, M, s_dw0, k_dw0, dw0, false, part_dw0);
  // dW1 (D, H) = dout^T @ prod
  job.p[1] = product(doutb, dim, true, prodb, hidden, dim, hidden, M, s_dw1, k_dw1, dw1, false,
                     part_dw1);
  // dx (M, D) = dh (M, 2H) @ W0 (2H, D)
  job.p[2] = product(dhb, two_h, false, w0b, dim, M, dim, two_h, s_dx, k_dx, dx, true, part_dx);
  // the longest blocks (most k a block) first, so the short ones fill the tail
  for (int i = 1; i < job.n; ++i)
    for (int j = i; j > 0 && job.p[j].kchunk > job.p[j - 1].kchunk; --j) {
      const Product t = job.p[j];
      job.p[j] = job.p[j - 1];
      job.p[j - 1] = t;
    }
  long blocks = 0;
  for (int i = 0; i < job.n; ++i) blocks += job.p[i].blocks;
  if (blocks > 0x7fffffffL) return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(ffn_bwd_products_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(gemm_mma::SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  ffn_bwd_products_kernel<<<unsigned(blocks), gemm_mma::THREADS, gemm_mma::SMEM_BYTES, s>>>(job);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

  Sums sums;
  int n = 0;
  sums.s[n++] = {static_cast<const float*>(db0_part), db0, false, two_h, tiles};
  sums.s[n++] = {static_cast<const float*>(db1_part), db1, false, dim, tiles};
  if (s_dw0 > 1) sums.s[n++] = {static_cast<const float*>(part_dw0), dw0, false, two_h * dim, s_dw0};
  if (s_dw1 > 1) sums.s[n++] = {static_cast<const float*>(part_dw1), dw1, false, dim * hidden, s_dw1};
  if (s_dx > 1) sums.s[n++] = {static_cast<const float*>(part_dx), dx, true, M * dim, s_dx};
  sums.count = n;
  sums.first[0] = 0;
  for (int i = 0; i < n; ++i) {
    const int per_group = RED_THREADS / sum_runs(sums.s[i].S);
    sums.first[i + 1] = sums.first[i] + min(RED_BLOCKS, (sums.s[i].n + per_group - 1) / per_group);
  }
  ffn_bwd_reduce_kernel<<<sums.first[n], RED_THREADS, 0, s>>>(sums);
  return int(cudaGetLastError());
}
