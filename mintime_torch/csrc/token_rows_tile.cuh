// The tile of the token-row launches at L <= 16 (csrc/token_rows_attention.cu
// and csrc/token_rows_attention_bwd.cu): where a block's groups, heads and
// rows fall, the staging of whole token rows into swizzled tiles, the
// block-diagonal mask, and the CLS key's column by shuffles.
//
// A warp tile holds 16 rows of one head: gpt = 16 / L whole groups of L
// rows (two groups of 8 frames, one of 9-16), row r of group r / L and
// position r % L. Its keys are the same groups' keys stacked, under a
// block-diagonal mask: a row sees only its own group's keys, so the products
// S = q K^T and dP = dO V^T are one 16 x 16 tile each. A block takes runs
// of gpt consecutive groups of one video, `runs` runs one after another
// (block x is video x / bpv, its first group (x % bpv) * gpt * runs), at hpb
// heads (block y the heads y * hpb on); a warp takes a head of the run.
// ops/token_rows.py::plan sets gpt, hpb, the runs and the threads
// (tests/test_torch_kernel_plans.py checks that every row falls in one
// tile). Groups never straddle videos, so a tile has one CLS key and value
// and a block one partial of their gradients; an odd G leaves the last tile
// half empty. With runs > 1 (the backward) the block holds two buffers: the
// copies of run i + 1 are in flight while run i computes.
//
// The block stages its rows whole: row (b, g, l) of the [q | k | v] view
// is 3 * H * dh contiguous values, the cotangent's H * dh, and at hpb = H
// each moves as one run of 16-byte cp.async copies into the tiles
// (slot, head) of shared memory, [slots][hpb][16][DH] bf16, swizzled as
// attn_rows::sw. Rows past the run's groups are filled with zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_rows_mma.cuh"

namespace token_tile {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

using attn_rows::DH;
using attn_rows::NEG;
using attn_rows::sw;

constexpr int ROWS = 16;       // rows (and keys) of a warp tile
constexpr int MAX_WARPS = 8;   // most heads a block, a warp each
constexpr int TILE_ELEMS = ROWS * DH;

// One run of a block: gpb = gpt consecutive groups of one video
struct Block {
  int b;          // video
  int g0, groups; // first group and groups in the run
  int h0, heads;  // first head and heads in the block
  int runs;       // runs of the block (set by block_of)
};

// The block's first run: block x takes `runs` runs of gpb groups each of
// video x / bpv, from group (x % bpv) * runs * gpb on
__device__ __forceinline__ Block block_of(int G, int H, int gpb, int runs, int hpb) {
  const int span = gpb * runs;
  const int bpv = (G + span - 1) / span;
  Block k;
  k.b = blockIdx.x / bpv;
  k.g0 = blockIdx.x % bpv * span;
  k.groups = min(gpb, G - k.g0);
  k.h0 = blockIdx.y * hpb;
  k.heads = min(hpb, H - k.h0);
  k.runs = (min(span, G - k.g0) + gpb - 1) / gpb;
  return k;
}

// Run i of the block whose first run is k
__device__ __forceinline__ Block run_of(Block k, int i, int G, int gpb) {
  k.g0 += i * gpb;
  k.groups = min(gpb, G - k.g0);
  return k;
}

// The tile (slot, hh) of a buffer of the block's shared memory
__device__ __forceinline__ bf16* tile(bf16* base, int hpb, int slot, int hh) {
  return base + (slot * hpb + hh) * TILE_ELEMS;
}

// Stage the run's rows: slots 0-2 the q, k, v thirds of qkv at the
// block's heads, slot 3 (if SLOTS == 4) the cotangent's. Every start and
// stride 16-byte aligned; rows past the run's groups are zeros. A warp
// copies a row, a lane the 16-byte chunk w = lane (and lane + 32) of each
// slot's heads, the slots unrolled. Issues the copies and commits them; the
// caller waits.
template <int SLOTS>
__device__ __forceinline__ void stage(bf16* base, const Block& k, int gpt, int hpb, int L, int H,
                                      const bf16* qkv, i64 sb, i64 sg, i64 sl, const bf16* dtok,
                                      i64 db, i64 dg, i64 dl) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int inner = H * DH;
  const int per_slot = k.heads * (DH / 8);  // 16-byte chunks of one slot of a row
  for (int r = warp; r < ROWS; r += warps) {  // a warp a row
    const int j = r / L;
    const int g = k.g0 + j;
    const bool live = r < gpt * L && j < k.groups;
    const i64 l = r - j * L;
    const bf16* row = qkv + k.b * sb + g * sg + l * sl + k.h0 * DH;
    const bf16* drow = SLOTS == 4 ? dtok + k.b * db + g * dg + l * dl + k.h0 * DH : nullptr;
    for (int w = lane; w < per_slot; w += 32) {
      const int off = sw(r, (w & 7) * 8);
#pragma unroll
      for (int slot = 0; slot < SLOTS; ++slot) {
        const bf16* src = slot < 3 ? row + slot * inner + w * 8 : drow + w * 8;
        warp_mma::cp_async16_zfill(tile(base, hpb, slot, w >> 3) + off,
                                   live ? src : qkv, live ? 16 : 0);
      }
    }
  }
  warp_mma::cp_async_commit();
}

// Write the run's live rows back from the tiles: output slot o (of OUT,
// each H * DH wide in a row of the output) from the tile slot src_slot(o),
// by 16-byte stores, a warp a row as in stage
template <int OUT, typename SrcSlot>
__device__ __forceinline__ void write_rows(bf16* base, SrcSlot src_slot, const Block& k, int gpt,
                                           int hpb, int L, int H, bf16* out, i64 ob, i64 og,
                                           i64 ol) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int inner = H * DH;
  const int per_slot = k.heads * (DH / 8);
  for (int r = warp; r < ROWS; r += warps) {
    const int j = r / L;
    if (r >= gpt * L || j >= k.groups) continue;  // warp-uniform
    bf16* orow = out + k.b * ob + (k.g0 + j) * og + (r - j * L) * ol + k.h0 * DH;
    for (int w = lane; w < per_slot; w += 32) {
      const int off = sw(r, (w & 7) * 8);
#pragma unroll
      for (int o = 0; o < OUT; ++o)
        *reinterpret_cast<uint4*>(orow + o * inner + w * 8) =
            *reinterpret_cast<const uint4*>(tile(base, hpb, src_slot(o), w >> 3) + off);
    }
  }
}

// The dot of each of this thread's two rows (grp, grp + 8) of the A
// fragments a with an fp32 vector v (DH, 8-byte aligned), summed over the
// row's four lanes: every lane of the row gets it
__device__ __forceinline__ void row_dots(float d[2], const uint32_t a[DH / 16][4], const float* v,
                                         int lane) {
  const int tig = lane & 3;
  d[0] = d[1] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const bf162*>(&a[kk][i]));
      const float2 y = *reinterpret_cast<const float2*>(v + kk * 16 + (i >> 1) * 8 + 2 * tig);
      d[i & 1] = fmaf(x.x, y.x, fmaf(x.y, y.y, d[i & 1]));
    }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    d[x] += __shfl_xor_sync(0xffffffffu, d[x], 1);
    d[x] += __shfl_xor_sync(0xffffffffu, d[x], 2);
  }
}

// This thread's two rows of a tile (grp, grp + 8) under the block-diagonal
// mask, fixed by the lane and L: the keys each row sees (bit key of vis),
// the first key of its group (base) and its position in the group (pos)
struct RowKeys {
  uint32_t vis[2];
  int base[2], pos[2];
  __device__ __forceinline__ RowKeys(int L, int lane) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = (lane >> 2) + 8 * x;
      base[x] = r / L * L;
      pos[x] = r - base[x];
      const int end = min(base[x] + L, ROWS);
      vis[x] = ((1u << end) - 1u) & ~((1u << base[x]) - 1u);
    }
  }
};

// The softmax of this thread's two rows over [CLS | the 16 keys of the
// tile] under the block-diagonal mask: s (C fragments, 16 x 16) and sc (the
// CLS logits of the rows) unscaled products in, probabilities out, fp32;
// keys of another group, and every key of a row past `rows`, get 0. bias:
// seq_bias (B, L, 1 + L) or null.
__device__ __forceinline__ void softmax_rows(float s[2][4], float sc[2], const RowKeys& rk,
                                             int rows, int L, int b,
                                             const float* __restrict__ bias, float scale,
                                             int lane) {
  const int grp = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float* brow = bias != nullptr ? bias + (i64(b) * L + rk.pos[x]) * (L + 1) : nullptr;
    sc[x] = fmaf(sc[x], scale, brow != nullptr ? brow[0] : 0.0f);
    float m = sc[x];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = n * 8 + 2 * tig + e;
        float& v = s[n][2 * x + e];
        if (rk.vis[x] >> key & 1u)
          v = fmaf(v, scale, brow != nullptr ? brow[1 + key - rk.base[x]] : 0.0f);
        else
          v = NEG;  // another group's key
        m = fmaxf(m, v);
      }
    // the row's four lanes agree on its max
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[n][2 * x + e];
        v = rk.vis[x] >> (n * 8 + 2 * tig + e) & 1u ? __expf(v - m) : 0.0f;
        sum += v;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sc[x] = __expf(sc[x] - m);
    sum += sc[x];
    const float inv = grp + 8 * x < rows ? 1.0f / sum : 0.0f;  // rows past the tile: 0
    sc[x] *= inv;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[n][2 * x + e] *= inv;
  }
}

}  // namespace token_tile
