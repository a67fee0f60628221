// The token rows of the attention backward on Hopper's tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulators): the row and column
// launches of csrc/divided_attention_bwd.cu, shared with the token-row
// backward above 16 frames (csrc/token_rows_attention_bwd.cu). Templated on
// CLS_ROW, whether a CLS row attends over the token keys: the divided
// backward's instance (true) adds that row's terms to each key's dK and dV
// in the column launch, the token-row backward's (false) has no such row.
//
// A warp takes 16 rows (row launch) or keys (column launch) of one group. A
// block takes a 64-row chunk of one group where L > 64, or several whole
// groups where L is shorter (four of L <= 16, two of L <= 32, one on three
// or four warps at L <= 64): ops/divided_attention.py::bwd_plan sets groups
// a block, chunks and threads. Groups are numbered n = b * G + g, so a
// block's groups may span two videos.
//   row launch: [k_cls; K] and [v_cls; V] of the block's groups in shared
//     memory; S = q~ [k_cls; K]^T and dP = dO [v_cls; V]^T tile by tile (16
//     keys), a first sweep for each row's max, sum and s_dot (online,
//     rescaled), a second for dS and dq = dS [k_cls; K]; writes dq, the
//     rows' (max, sum, s_dot) as fp32 scratch (B, G, H, L, 3) and each
//     group chunk's part of dk_cls and dv_cls (column 0 of dS^T q~ and
//     P^T dO, summed over its rows in order) as fp32 (B * G * chunks, H, 2,
//     dh);
//   column launch: q and dO of the block's groups in shared memory, a warp
//     per 16 keys: S^T and dP^T tile by tile (16 rows), P and dS from the
//     stored row statistics, dK = dS^T q~ and dV = P^T dO.
// Each warp reads its own rows' operand (q and dO in the row launch, K and
// V in the column launch) from device memory straight into A fragments,
// once; shared memory holds only the operand every warp sweeps, staged by
// 16-byte cp.async into swizzled rows. Three blocks an SM: registers capped
// at 170. P and dS enter the gradient products as bf16 hi/lo pairs
// (attn_rows::mma_split). Padded keys take the finite mask value and a
// probability of 0, padded rows write nothing; sums run in a fixed order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_rows_mma.cuh"

namespace attn_bwd_rows {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

using attn_rows::DH;
using attn_rows::load_a;
using attn_rows::mma_rows_t;
using attn_rows::mma_split;
using attn_rows::NEG;
using attn_rows::pad16;
using attn_rows::stage_rows;
using attn_rows::sw;

constexpr int TILE = 64;               // query rows (row launch) or keys (column launch) of a chunk
constexpr int TILE_WARPS = TILE / 16;  // most warps a block
constexpr int MIN_BLOCKS = 3;          // blocks an SM: at most 170 registers a thread
// a CLS chunk's scratch: sum e k (DH), sum e dp k (DH), sum e, sum e dp, max
constexpr int PART = 2 * DH + 3;

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

// The row launch: dq of the block's rows, the rows' softmax statistics and
// each group's part of the CLS key's gradients (the same with or without a
// CLS row: CLS_ROW only names the instance). With dh = 64 the scale 1/8 is a
// power of two, so q~ = q / 8 exactly: q is read as it is and the scale
// applied to S (and to the dk_cls part).
template <bool CLS_ROW>
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

// The column launch: dK and dV of the block's keys, with the CLS row's terms
// where CLS_ROW (dcls, cls_scr and cls_chunks are read only then). q is
// staged unscaled: the scale goes to S^T and dK.
template <bool CLS_ROW>
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
  }
  if (CLS_ROW && tl.live) {
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
  for (int i = tid; CLS_ROW && i < tl.groups * DH; i += blockDim.x) {
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
  float cp[2] = {0.0f, 0.0f}, cdl[2] = {0.0f, 0.0f};
#pragma unroll
  for (int x = 0; x < 2 && CLS_ROW; ++x) {
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
      if constexpr (CLS_ROW) {
        *reinterpret_cast<bf162*>(orow + koff + d) = __floats2bfloat162_rn(
            fmaf(cdl[x], qcj[d], scale * dk[nn][2 * x]),
            fmaf(cdl[x], qcj[d + 1], scale * dk[nn][2 * x + 1]));
        *reinterpret_cast<bf162*>(orow + voff + d) = __floats2bfloat162_rn(
            fmaf(cp[x], dcj[d], dv[nn][2 * x]), fmaf(cp[x], dcj[d + 1], dv[nn][2 * x + 1]));
      } else {
        *reinterpret_cast<bf162*>(orow + koff + d) =
            __floats2bfloat162_rn(scale * dk[nn][2 * x], scale * dk[nn][2 * x + 1]);
        *reinterpret_cast<bf162*>(orow + voff + d) =
            __floats2bfloat162_rn(dv[nn][2 * x], dv[nn][2 * x + 1]);
      }
    }
  }
}

inline size_t rows_smem(int L, int gpb, int warps) {
  return sizeof(bf16) * 2 * size_t(gpb) * pad16(L + 1) * DH + sizeof(float) * warps * 2 * DH;
}

inline size_t cols_smem(int L, int gpb) {
  const size_t Lp = pad16(L);
  return sizeof(bf16) * 2 * gpb * Lp * DH + sizeof(float) * gpb * (3 * Lp + 2 * DH);
}


// Whether the plan (ops/divided_attention.py::bwd_plan) fits the launches:
// whole warps, each group's chunk covered by its warps, several groups a
// block only where one chunk holds a group
inline bool plan_ok(int L, int gpb, int chunks, int threads) {
  const int warps = threads / 32;
  return threads % 32 == 0 && warps >= 1 && warps <= TILE_WARPS && gpb >= 1 && warps % gpb == 0 &&
         chunks == (L + TILE - 1) / TILE && (chunks == 1 || gpb == 1) &&
         warps / gpb * 16 >= (L < TILE ? L : TILE);
}

}  // namespace attn_bwd_rows
