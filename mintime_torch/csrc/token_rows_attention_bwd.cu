// Backward of the token rows of the divided space-time attention, tiled
// over groups, for Hopper (sm_90a) tensor cores, bf16 in and out, fp32
// inside.
//
// Replaces: mintime_tpu/ops/pallas_attention.py:571 _token_rows_bwd_kernel
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
// package returns zeros). Starts and strides 16-byte aligned (the wrapper
// copies a view that is not).
//
// Bound on an H100: memory. At B = 8, G = 1280, L = 8, H*dh = 384 a call reads
// qkv (189 MB) and the cotangent (63 MB) and writes d_qkv (189 MB): 0.131 ms
// at 3.35 TB/s; about 4.5 GFLOP.
//
// Design. The TPU kernel carried dk_cls and dv_cls in one output block across
// its sequential grid. GPU blocks run in parallel, so the CLS key's
// gradients go through one fp32 partial a block and an ordered reduce (no
// atomics: reruns give the same bits).
//   L <= 16: token_rows_bwd_tile_kernel, then token_rows_cls_reduce_kernel.
//     The tile of csrc/token_rows_tile.cuh: a warp owns 16 rows of one head,
//     16 / L whole groups (two at L = 8), against the same groups' 16 keys
//     under a block-diagonal mask. S = q K^T and dP = dO V^T are one 16 x 16
//     product each (16 mma); the CLS key's column is a per-row fp32 dot
//     (q . k_cls, dO . v_cls) by shuffles over the row's four lanes; P, dS
//     and the row sums stay in registers. dq = dS K, dK = dS^T q~ and
//     dV = P^T dO are one k16 step each over the tile's 16 keys or rows,
//     P and dS entering as bf16 hi/lo pairs (attn_rows::mma_split: about 16
//     bits of mantissa, so the gradients keep the fp32 plain version's
//     accuracy), transposed for dK and dV by movmatrix. A block takes the
//     tile's groups at all heads (H warps at H <= 8): every token row's
//     2304-byte q|k|v and 768-byte dO arrive whole, by 16-byte cp.async into
//     swizzled tiles (48 KB at H = 6), and each result overwrites a tile its
//     warp has consumed (dq the V tile, dK the K tile, dV the q tile), so
//     d_qkv leaves as whole rows by 16-byte stores. qkv and dO are read once
//     and d_qkv written once; no row statistics leave the block. A block
//     takes up to four such runs of groups one after another in two
//     buffers, the next run's copies in flight while this one computes (the
//     plan takes as many as leave two blocks an SM: four at the shapes
//     above, 1280 blocks), and sums its groups' column-0 terms (dS[:, 0]^T
//     q~, P[:, 0]^T dO) in a fixed order into one fp32 partial of (blocks,
//     H, 2, dh): 3.9 MB at the shapes above (a partial a group and head took
//     31.5 MB). What sets the time: the copies, the products and the
//     stores each take 0.07-0.09 ms a call alone at the shapes above and
//     overlap only in part (experiments/token_rows_phases.py); 128
//     registers leave two blocks (twelve warps) an SM. Measured
//     (kernel_turns, device time, H100 80GB HBM3, 700.00 W): 0.1832 ms a
//     call at the shapes above, the one-warp scalar kernel it replaced
//     0.8818.
//   17 <= L <= 64 (no model path): the divided backward's row and column
//     launches without a CLS row (csrc/attn_bwd_rows_mma.cuh, CLS_ROW
//     false), a partial a group, then the same reduce.
//   The reduce, per (b, h): 32 runs of the partials summed in order each
//   (16-byte loads), then the runs in order; writes dk_cls, dv_cls and the
//   zero q third of d_qkvc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_bwd_rows_mma.cuh"
#include "token_rows_tile.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

using token_tile::Block;
using token_tile::DH;
using token_tile::MAX_WARPS;
using token_tile::ROWS;
using token_tile::TILE_ELEMS;

constexpr int TILE_MAXL = 16;   // the tile kernel's longest L
constexpr int MAXL = 64;        // longest attended sequence, as the forward's
constexpr int SLOTS = 4;        // q, k, v and dO tiles a head
constexpr int SLICES = 32;      // runs of partials of the CLS reduction

// bf16 elements of one buffer of tiles
__host__ __device__ inline size_t buffer_elems(int hpb) {
  return size_t(SLOTS) * hpb * TILE_ELEMS;
}

size_t tile_smem(int hpb, int runs) {
  return sizeof(bf16) * (runs > 1 ? 2 : 1) * buffer_elems(hpb) + sizeof(float) * 4 * hpb * DH;
}

// C tile pair (16 x 16, fp32) -> bf16 rows of the swizzled tile m, times f
__device__ __forceinline__ void store_tile(bf16* m, const float acc[DH / 8][4], float f,
                                           int lane) {
  const int grp = lane >> 2;
  const int tig = lane & 3;
  __syncwarp();  // every lane is done reading the tile this overwrites
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int x = 0; x < 2; ++x)
      *reinterpret_cast<bf162*>(m + attn_rows::sw(grp + 8 * x, n * 8 + 2 * tig)) =
          __floats2bfloat162_rn(f * acc[n][2 * x], f * acc[n][2 * x + 1]);
}

__device__ __forceinline__ void zero(float acc[DH / 8][4]) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
}

// Block: `runs` runs of gpt groups of one video, at hpb heads, a warp a
// head. Dynamic shared memory: one buffer of tiles, two where runs > 1;
// k_cls and v_cls of the block's heads in fp32; each head's column-0 terms
// summed over the runs, [hpb][2 * DH].
__global__ void __launch_bounds__(MAX_WARPS * 32)
token_rows_bwd_tile_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                           const bf16* __restrict__ qkvc, i64 scb,
                           const float* __restrict__ seq_bias, const bf16* __restrict__ dtok,
                           i64 db, i64 dg, i64 dl, bf16* __restrict__ dqkv, i64 ob, i64 og, i64 ol,
                           float* __restrict__ kv_part, int G, int L, int H, int gpt, int hpb,
                           int runs, float scale) {
  extern __shared__ __align__(16) unsigned char tsm[];
  const Block first = token_tile::block_of(G, H, gpt, runs, hpb);
  bf16* const buf0 = reinterpret_cast<bf16*>(tsm);
  // buffer i at buf0 + i * buf_step
  const size_t buf_step = runs > 1 ? buffer_elems(hpb) : 0;
  float* kcs = reinterpret_cast<float*>(buf0 + buf_step + buffer_elems(hpb));
  float* vcs = kcs + hpb * DH;
  float* kvw = vcs + hpb * DH;
  for (int i = 0; i < 2 && i < first.runs; ++i)
    token_tile::stage<SLOTS>(buf0 + i * buf_step, token_tile::run_of(first, i, G, gpt), gpt, hpb, L,
                             H, qkv, sb, sg, sl, dtok, db, dg, dl);
  const int inner = H * DH;
  const bf16* cls = qkvc + first.b * scb + first.h0 * DH;
  for (int i = threadIdx.x; i < first.heads * DH; i += blockDim.x) {
    kcs[i] = __bfloat162float(cls[inner + i]);
    vcs[i] = __bfloat162float(cls[2 * inner + i]);
  }
  for (int i = threadIdx.x; i < hpb * 2 * DH; i += blockDim.x) kvw[i] = 0.0f;

  const int hh = threadIdx.x / 32;  // the warp's head
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const token_tile::RowKeys rk(L, lane);
  for (int run = 0; run < first.runs; ++run) {
    if (run + 1 < first.runs)
      warp_mma::cp_async_wait<1>();  // run + 1's copies may still fly
    else
      warp_mma::cp_async_wait<0>();
    __syncthreads();
    const Block k = token_tile::run_of(first, run, G, gpt);
    bf16* tiles = buf0 + (run & 1) * buf_step;
    if (hh < k.heads) {  // warp-uniform
      const int rows = k.groups * L;
      bf16* qt = token_tile::tile(tiles, hpb, 0, hh);
      bf16* kt = token_tile::tile(tiles, hpb, 1, hh);
      bf16* vt = token_tile::tile(tiles, hpb, 2, hh);
      const bf16* dot = token_tile::tile(tiles, hpb, 3, hh);
      const float* kc = kcs + hh * DH;

      uint32_t dshi[4], dslo[4], phi[4], plo[4];
      float dsc[2], pc[2];  // dS and P at the CLS key, this thread's two rows
      {
        uint32_t qa[DH / 16][4], da[DH / 16][4];
        attn_rows::load_a_smem(qa, qt, lane);
        attn_rows::load_a_smem(da, dot, lane);
        float s[2][4], dp[2][4], dpc[2];
        attn_rows::mma_rows_t(s, qa, kt, 0, lane);
        attn_rows::mma_rows_t(dp, da, vt, 0, lane);
        token_tile::row_dots(pc, qa, kc, lane);
        token_tile::row_dots(dpc, da, vcs + hh * DH, lane);
        token_tile::softmax_rows(s, pc, rk, rows, L, k.b, seq_bias, scale, lane);
        // dS = P (dP - rowsum(P dP)), the CLS key's term last
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float sd = 0.0f;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) sd = fmaf(s[n][2 * x + e], dp[n][2 * x + e], sd);
          sd += __shfl_xor_sync(0xffffffffu, sd, 1);
          sd += __shfl_xor_sync(0xffffffffu, sd, 2);
          sd = fmaf(pc[x], dpc[x], sd);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              dp[n][2 * x + e] = s[n][2 * x + e] * (dp[n][2 * x + e] - sd);
          dsc[x] = pc[x] * (dpc[x] - sd);
        }

        // the head's column-0 terms, dS[:, 0]^T q (DH) and P[:, 0]^T dO (DH),
        // from the rows' fragments: the thread's two rows, then the eight row
        // pairs over lanes grp, in a fixed order (rows past the tile have
        // dS and P of 0)
        float* kw = kvw + hh * 2 * DH;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const uint32_t(*frag)[4] = o ? da : qa;
          const float* w = o ? pc : dsc;
          float c[DH / 16][4];  // columns kk * 16 + (i / 2) * 8 + 2 tig + i % 2
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const bf162* rows = reinterpret_cast<const bf162*>(&frag[kk][2 * hf]);
              const float2 r0 = __bfloat1622float2(rows[0]);  // row grp
              const float2 r1 = __bfloat1622float2(rows[1]);  // row grp + 8
              c[kk][2 * hf] = fmaf(w[1], r1.x, w[0] * r0.x);
              c[kk][2 * hf + 1] = fmaf(w[1], r1.y, w[0] * r0.y);
            }
#pragma unroll
          for (int sh = 4; sh < 32; sh <<= 1)
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
              for (int i = 0; i < 4; ++i) c[kk][i] += __shfl_xor_sync(0xffffffffu, c[kk][i], sh);
          if (grp == 0)
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                kw[o * DH + kk * 16 + (i >> 1) * 8 + 2 * tig + (i & 1)] += c[kk][i];
        }
        warp_mma::split_a(dp, dshi, dslo);
        warp_mma::split_a(s, phi, plo);
      }

      float acc[DH / 8][4];
      // dq = dh^-0.5 (dS K + dS[:, 0] k_cls), into the V tile (V is consumed)
      zero(acc);
      attn_rows::mma_split(acc, dshi, dslo, kt, 0, lane);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[n][i] = fmaf(dsc[i >> 1], kc[n * 8 + 2 * tig + (i & 1)], acc[n][i]);
      store_tile(vt, acc, scale, lane);
      // dK = dS^T q~, into the K tile
      uint32_t thi[4], tlo[4];
      warp_mma::transpose_a(dshi, thi);
      warp_mma::transpose_a(dslo, tlo);
      zero(acc);
      attn_rows::mma_split(acc, thi, tlo, qt, 0, lane);
      store_tile(kt, acc, scale, lane);
      // dV = P^T dO, into the q tile
      warp_mma::transpose_a(phi, thi);
      warp_mma::transpose_a(plo, tlo);
      zero(acc);
      attn_rows::mma_split(acc, thi, tlo, dot, 0, lane);
      store_tile(qt, acc, 1.0f, lane);
    }
    __syncthreads();
    // d_qkv rows: dq from the V tile, dK from the K tile, dV from the q tile
    token_tile::write_rows<3>(tiles, [](int o) { return 2 - o; }, k, gpt, hpb, L, H, dqkv, ob,
                              og, ol);
    if (run + 2 < first.runs) {
      __syncthreads();  // every row of this buffer is written out
      token_tile::stage<SLOTS>(tiles, token_tile::run_of(first, run + 2, G, gpt), gpt, hpb, L, H,
                               qkv, sb, sg, sl, dtok, db, dg, dl);
    }
  }
  __syncthreads();

  // the block's partial: each head's column-0 terms, summed over the runs
  for (int e = threadIdx.x; e < first.heads * 2 * DH; e += blockDim.x)
    kv_part[i64(blockIdx.x) * H * 2 * DH + first.h0 * 2 * DH + e] =
        e % (2 * DH) < DH ? scale * kvw[e] : kvw[e];
}

// d_qkvc of one (b, h) from `parts` partials a video, fp32 (B * parts, H, 2,
// dh): thread (s, e) sums elements 4e .. 4e + 3 (k then v) over run s of the
// partials in order, by 16-byte loads, then run 0 sums the runs in order
__global__ void __launch_bounds__(SLICES * 2 * DH / 4)
token_rows_cls_reduce_kernel(const float* __restrict__ kv_part, bf16* __restrict__ dqkvc,
                             i64 ocb, int parts, int H) {
  __shared__ float4 red[SLICES][2 * DH / 4];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int e = threadIdx.x % (2 * DH / 4);
  const int s = threadIdx.x / (2 * DH / 4);
  const int p0 = s * parts / SLICES;
  const int p1 = (s + 1) * parts / SLICES;
  const float4* part =
      reinterpret_cast<const float4*>(kv_part + (i64(b) * parts * H + h) * 2 * DH) + e;
  const i64 step = i64(H) * 2 * DH / 4;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const float4 v = part[p * step];
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  red[s][e] = a;
  __syncthreads();
  if (s == 0) {
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < SLICES; ++k) {
      t.x += red[k][e].x;
      t.y += red[k][e].y;
      t.z += red[k][e].z;
      t.w += red[k][e].w;
    }
    bf16* row = dqkvc + b * ocb;
    const int c = 4 * e;  // k (c < DH) or v column of the head
    bf162* out = reinterpret_cast<bf162*>(row + (1 + c / DH) * H * DH + h * DH + c % DH);
    out[0] = __floats2bfloat162_rn(t.x, t.y);
    out[1] = __floats2bfloat162_rn(t.z, t.w);
    if (c < DH) {  // the CLS query's third: zero
      bf162* q = reinterpret_cast<bf162*>(row + h * DH + c);
      q[0] = q[1] = __floats2bfloat162_rn(0.0f, 0.0f);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The plan comes from ops/token_rows.py::plan. At L <= 16: groups a warp
// tile (gpt = 16 / L), heads a block (hpb), runs a block and threads (a warp
// a head); gpb and chunks 0; kv_part fp32 (B * ceil(G / (gpt * runs)), H,
// 2, dh); row_stats unused. Above: gpt, hpb, runs 0; gpb, chunks and
// threads of ops/divided_attention.py::bwd_plan's token-row launches;
// kv_part (B * G * chunks, H, 2, dh) and row_stats (B, G, H, L, 3). Strides
// are in elements; the inputs and d_qkv, and their strides but the last,
// 16-byte aligned.
extern "C" int token_rows_attention_bwd(const void* qkv, i64 sb, i64 sg, i64 sl,
                                        const void* qkvc, i64 scb, const void* seq_bias,
                                        const void* dtok, i64 db, i64 dg, i64 dl, void* dqkv,
                                        i64 ob, i64 og, i64 ol, void* dqkvc, i64 ocb,
                                        void* kv_part, void* row_stats, int B, int G, int L,
                                        int H, int dh, int gpt, int hpb, int runs, int gpb,
                                        int chunks, int threads, void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  if (!aligned16(qkv) || !aligned16(qkvc) || !aligned16(dtok) || !aligned16(dqkv) ||
      (sb | sg | sl | scb | db | dg | dl | ob | og | ol) % 8 != 0)
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(float(DH));
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* qc = static_cast<const bf16*>(qkvc);
  const float* bias = static_cast<const float*>(seq_bias);
  const bf16* dt = static_cast<const bf16*>(dtok);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* part = static_cast<float*>(kv_part);
  int parts;  // partials a video
  cudaError_t err;
  if (L <= TILE_MAXL) {
    if (gpt != ROWS / L || hpb < 1 || hpb > H || hpb > MAX_WARPS || runs < 1 ||
        threads != 32 * hpb || gpb || chunks)
      return int(cudaErrorInvalidValue);
    parts = (G + gpt * runs - 1) / (gpt * runs);
    const i64 blocks = i64(B) * parts;
    const int head_chunks = (H + hpb - 1) / hpb;
    if (blocks > 0x7fffffff || head_chunks > 65535) return int(cudaErrorInvalidValue);
    const size_t smem = tile_smem(hpb, runs);
    err = cudaFuncSetAttribute(token_rows_bwd_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    token_rows_bwd_tile_kernel<<<dim3(unsigned(blocks), head_chunks), threads, smem, s>>>(
        q, sb, sg, sl, qc, scb, bias, dt, db, dg, dl, dq, ob, og, ol, part, G, L, H, gpt, hpb, runs,
        scale);
  } else {
    using attn_bwd_rows::attn_bwd_cols_kernel;
    using attn_bwd_rows::attn_bwd_rows_kernel;
    if (gpt || hpb || runs || !attn_bwd_rows::plan_ok(L, gpb, chunks, threads))
      return int(cudaErrorInvalidValue);
    parts = G * chunks;
    const i64 blocks = (i64(B) * G + gpb - 1) / gpb * chunks;
    if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(attn_bwd_rows_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(attn_bwd_rows::rows_smem(L, gpb, threads / 32)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_cols_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(attn_bwd_rows::cols_smem(L, gpb)));
    if (err != cudaSuccess) return int(err);
    float* rst = static_cast<float*>(row_stats);
    const dim3 grid(unsigned(blocks), H);
    attn_bwd_rows_kernel<false><<<grid, threads, attn_bwd_rows::rows_smem(L, gpb, threads / 32),
                                  s>>>(q, sb, sg, sl, qc, scb, bias, dt, db, dg, dl, dq, ob, og,
                                       ol, rst, part, B, G, L, H, gpb, chunks, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    attn_bwd_cols_kernel<false><<<grid, threads, attn_bwd_rows::cols_smem(L, gpb), s>>>(
        q, sb, sg, sl, qc, scb, bias, dt, db, dg, dl, nullptr, 0, nullptr, 0, rst, dq, ob, og, ol,
        B, G, L, H, gpb, chunks, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  token_rows_cls_reduce_kernel<<<dim3(H, B), SLICES * 2 * DH / 4, 0, s>>>(
      part, static_cast<bf16*>(dqkvc), ocb, parts, H);
  return int(cudaGetLastError());
}
