// Token rows of the divided space-time attention, tiled over groups, for
// Hopper (sm_90a) tensor cores, bf16 in and out, fp32 inside.
//
// Replaces: mintime_tpu/ops/pallas_attention.py:530 _token_rows_kernel
// (reached through _token_rows_fwd_call, _token_rows_core and
// divided_attention when a slice exceeds the whole-slice budget: the
// Convolutional TimeSformer's time axis, G = 1280 channel groups of L = 8
// frames, H = 6 heads of 64). Input is packed qkv (B, G, L, 3*H*dh) with
// columns [q | k | v], each head-major (PyTorch's to_qkv layout), read
// through (B, G, L) strides so the time axis needs no transpose, plus the
// CLS row's packed qkv (B, 3*H*dh). Per (b, g, h), with q~ = bf16(q *
// dh^-0.5):
//   P   = bf16(softmax([q~ k_cls | q~ K^T] + seq_bias))   (fp32 logits)
//   out = bf16(P[:, 1:] V + P[:, 0] v_cls)                 (fp32 sums)
// seq_bias (B, L, 1+L) fp32, column 0 the CLS key, is optional; masks are
// finite biases (-0.7 * f32 max), never -inf. The CLS row itself is not
// computed here (mintime_torch/ops/token_rows.py::cls_row_plain). Starts
// and strides 16-byte aligned (the wrapper copies a view that is not).
//
// Bound on an H100: memory. At B = 8, G = 1280, L = 8, H*dh = 384 a call
// reads qkv once (81920 * 1152 * 2 B = 189 MB) and writes out (63 MB):
// 0.075 ms at 3.35 TB/s. Its arithmetic, 4*B*G*H*L*(L+1)*dh = 1.8 GFLOP, is
// far below the tensor-core rate.
//
// Design. The TPU kernel tiled G to fit VMEM and looped over heads.
//   L <= 16: token_rows_fwd_tile_kernel (csrc/token_rows_tile.cuh). A warp
//     owns a 16-row mma.sync tile of one head holding 16 / L whole groups
//     (two at L = 8) against the same groups' 16 keys under a
//     block-diagonal mask: S = q K^T is one 16 x 16 product (8 mma), the
//     CLS key's logit a per-row fp32 dot q . k_cls by shuffles over the
//     row's four lanes, the softmax in registers, P rounded to bf16 after
//     normalising and multiplied into V (16 mma), then P[:, 0] v_cls added
//     in fp32. A block takes the tile's groups at all heads (H warps at
//     H <= 8), so every token row's 2304-byte q|k|v arrives whole, by
//     16-byte cp.async into swizzled tiles, and its 768-byte output leaves
//     whole, by 16-byte stores from the q tile it overwrote. Blocks are
//     not persistent: each issues all its copies at once, and the other
//     blocks of its SM compute meanwhile.
//   17 <= L <= 64 (no model path; the attention probe's L = 49):
//     attn_rows::token_rows_mma_kernel, the divided forward's token rows
//     (csrc/attn_rows_mma.cuh), a block per (b, g, h).
// One launch a call either way. What takes the time at L = 8 is the bytes:
// a block's 36 KB of copies against a few hundred mma; 56 registers and
// 39 KB of shared memory leave five blocks an SM. Measured (kernel_turns,
// device time, H100 80GB HBM3, 700.00 W): 0.0895 ms a call at the shapes
// above, the one-warp scalar kernel it replaced 0.3577.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
constexpr int MAXL = 64;        // longest L: frame counts up to 32, the probe's 49 patches
constexpr int SLOTS = 3;        // q, k, v tiles a head

size_t tile_smem(int hpb) {
  return sizeof(bf16) * SLOTS * hpb * TILE_ELEMS + sizeof(float) * 2 * hpb * DH;
}

// Block: gpt groups of one video at hpb heads, a warp a head. Dynamic shared
// memory: the tiles, then k_cls and v_cls of the block's heads in fp32.
__global__ void __launch_bounds__(MAX_WARPS * 32)
token_rows_fwd_tile_kernel(const bf16* __restrict__ qkv, i64 sb, i64 sg, i64 sl,
                           const bf16* __restrict__ qkvc, i64 scb,
                           const float* __restrict__ seq_bias, bf16* __restrict__ out, i64 ob,
                           i64 og, i64 ol, int G, int L, int H, int gpt, int hpb, float scale) {
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* tiles = reinterpret_cast<bf16*>(tsm);
  float* kcs = reinterpret_cast<float*>(tiles + SLOTS * hpb * TILE_ELEMS);
  float* vcs = kcs + hpb * DH;
  const Block k = token_tile::block_of(G, H, gpt, 1, hpb);
  token_tile::stage<SLOTS>(tiles, k, gpt, hpb, L, H, qkv, sb, sg, sl, nullptr, 0, 0, 0);
  const int inner = H * DH;
  const bf16* cls = qkvc + k.b * scb + k.h0 * DH;
  for (int i = threadIdx.x; i < k.heads * DH; i += blockDim.x) {
    kcs[i] = __bfloat162float(cls[inner + i]);
    vcs[i] = __bfloat162float(cls[2 * inner + i]);
  }
  warp_mma::cp_async_wait<0>();
  __syncthreads();

  const int hh = threadIdx.x / 32;  // the warp's head
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  if (hh < k.heads) {  // warp-uniform
    const token_tile::RowKeys rk(L, lane);
    const int rows = k.groups * L;
    bf16* qt = token_tile::tile(tiles, hpb, 0, hh);
    const bf16* kt = token_tile::tile(tiles, hpb, 1, hh);
    const bf16* vt = token_tile::tile(tiles, hpb, 2, hh);
    uint32_t qa[DH / 16][4];
    attn_rows::load_a_smem(qa, qt, lane);
    float s[2][4], pc[2];
    attn_rows::mma_rows_t(s, qa, kt, 0, lane);
    token_tile::row_dots(pc, qa, kcs + hh * DH, lane);
    token_tile::softmax_rows(s, pc, rk, rows, L, k.b, seq_bias, scale, lane);

    // P rounded to bf16 after normalising (the CLS key's probability is pc)
    uint32_t p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // A fragment j: C tile j / 2, row half j % 2
      const float* c = s[j >> 1] + (j & 1) * 2;
      p[j] = warp_mma::as_u32(__floats2bfloat162_rn(c[0], c[1]));
    }
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
    attn_rows::mma_pv(o, p, vt, 0, lane);
    // o += P[:, 0] v_cls in fp32 after the token sum; into the q tile
    const float* vc = vcs + hh * DH;
    __syncwarp();
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int c = n * 8 + 2 * tig;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float pcr = __bfloat162float(__float2bfloat16(pc[x]));
        *reinterpret_cast<bf162*>(qt + attn_rows::sw(grp + 8 * x, c)) = __floats2bfloat162_rn(
            fmaf(pcr, vc[c], o[n][2 * x]), fmaf(pcr, vc[c + 1], o[n][2 * x + 1]));
      }
    }
  }
  __syncthreads();
  token_tile::write_rows<1>(tiles, [](int) { return 0; }, k, gpt, hpb, L, H, out, ob, og, ol);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The plan comes from ops/token_rows.py::plan: at L <= 16, groups a warp
// tile (gpt = 16 / L), heads a block (hpb) and threads (a warp a head);
// above, all three 0. Strides are in elements; the two
// inputs and the output, and their strides but the last, 16-byte aligned.
extern "C" int token_rows_attention_fwd(const void* qkv, i64 sb, i64 sg, i64 sl,
                                        const void* qkvc, i64 scb, const void* seq_bias,
                                        void* out, i64 ob, i64 og, i64 ol, int B, int G, int L,
                                        int H, int dh, int gpt, int hpb, int threads,
                                        void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || H > 65535)
    return int(cudaErrorInvalidValue);
  if (!aligned16(qkv) || !aligned16(qkvc) || !aligned16(out) ||
      (sb | sg | sl | scb | ob | og | ol) % 8 != 0)
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(float(DH));
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* qc = static_cast<const bf16*>(qkvc);
  const float* bias = static_cast<const float*>(seq_bias);
  bf16* o = static_cast<bf16*>(out);
  if (L > TILE_MAXL) {
    if (gpt || hpb || threads || G > 65535 || B > 65535) return int(cudaErrorInvalidValue);
    return int(attn_rows::launch_token_rows_mma(q, sb, sg, sl, qc, scb, bias, o, ob, og, ol, B, G,
                                                L, H, scale, s));
  }
  if (gpt != ROWS / L || hpb < 1 || hpb > H || hpb > MAX_WARPS || threads != 32 * hpb)
    return int(cudaErrorInvalidValue);
  const i64 blocks = i64(B) * ((G + gpt - 1) / gpt);
  const int head_chunks = (H + hpb - 1) / hpb;
  if (blocks > 0x7fffffff || head_chunks > 65535) return int(cudaErrorInvalidValue);
  const size_t smem = tile_smem(hpb);
  cudaError_t err = cudaFuncSetAttribute(token_rows_fwd_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  token_rows_fwd_tile_kernel<<<dim3(unsigned(blocks), head_chunks), threads, smem, s>>>(
      q, sb, sg, sl, qc, scb, bias, o, ob, og, ol, G, L, H, gpt, hpb, scale);
  return int(cudaGetLastError());
}
