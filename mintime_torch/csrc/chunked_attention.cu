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
// take DENSE logits over the tile's T = 1 + PL keys (the CLS key, then the
// tile's rows) under an additive block-diagonal bias:
//   S   = Q~ [k_cls; K]^T   (Q~ = bf16(q * dh^-0.5), which is q / 8 exactly)
//   S'  = S + bias: sbias[r, 0] at the CLS key; at column c of the tile
//         tile(sbias)[r, c] + (group(r) == group(c) ? 0 : NEG), with NEG at
//         padded columns (two NEGs overflow to -inf, as in fp32 on the TPU)
//   P   = bf16(softmax(S'))                                  (fp32 softmax)
//   out = bf16(P[:, 1:] V + P[:, 0] v_cls)   (fp32 sums, the CLS term last)
// with padded query rows dropped. The CLS row (one query over all G*L keys
// and itself) rounds as the whole-slice kernel's: unnormalised bf16
// probabilities before PV, the sum divided out at the end.
//
// Bound on an H100: memory. At the probe's B = 32, H = 8, G*L = 784, dh = 64
// a call reads qkv once (32 * 784 * 1536 * 2 B = 77.1 MB) and writes out
// (32 * 784 * 512 * 2 B = 25.7 MB): 30.7 us at 3.35 TB/s. The dense tiles
// multiply the logit and PV work by about (1 + P*Lp) / (1 + L) (3.8x on the
// time axis at P = 4, 2.3x on the space axis at P = 2): 3.5 and 6.6 GFLOP
// a call, 4-7 us at 989 TFLOP/s.
//
// Design: the TPU probe packed P groups into the MXU's 128-row tile to issue
// fewer matrix products; here the packed tile is one "group" of
// attn_rows::attend_rows (csrc/attn_rows_mma.cuh), the routine of the
// whole-slice, token-row and grouped forwards, in its one-pass form.
//   * Token rows: a block of W = PL / 16 warps per (tile, h, b) stages the
//     tile's Q and [k_cls; K], [v_cls; V] by 16-byte cp.async into swizzled
//     bf16 rows, and each warp takes its 16 rows' A fragments by ldmatrix
//     and runs attend_rows<W + 1>: S of the W + 1 key tiles on mma.sync
//     m16n8k16 fragments held in registers, the softmax in registers over
//     all of them at once, P normalised and rounded to bf16 as PV's A
//     fragments. No logit goes through shared memory. The tile's size is a
//     template argument, so the key-range tests fold away.
//   * The bias of (row, key): the tiled sbias of each position, [L][1 + PL]
//     fp32 in shared memory, copied by 4-byte cp.async with the rows (NEG
//     written at padded columns), and each key's group; TileBias adds NEG
//     where the row's and the key's groups differ. Per element two shared
//     loads, no division. The output goes out through each warp's own Q
//     rows by 16-byte stores.
//   * CLS row: it needs every group of (b, h), which no tile block sees, so
//     it takes the divided forward's three launches (csrc/cls_row_fwd.cuh)
//     over 128-key chunks of the G*L keys: more blocks than (b, h) pairs, any
//     G*L, the chunks summed in a fixed order, no atomics. They read K and V
//     a second time (51.4 MB at the probe's size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_rows_mma.cuh"
#include "cls_row_fwd.cuh"

using attn_rows::bf16;
using attn_rows::DH;
using attn_rows::i64;
using attn_rows::NEG;

namespace {

constexpr int MAXPL = 128;                 // rows of one packed tile
constexpr int MAXKJ = (1 + MAXPL + 31) / 32;  // a lane's keys of a bias row, at most

// Row stride of the bias table (fp32) over the 1 + PL keys: 8 past a
// multiple of 16, so a warp's 8 rows x 4 key pairs fall at most two to a bank
__host__ __device__ constexpr int bias_stride(int PL) { return PL + 24; }

// Dynamic shared memory of a tile of PL = P * Lp rows over L positions: Q
// [PL][DH] and K, V [PL + 16][DH] (the CLS pair first, zeros after the
// tile's rows) in bf16, swizzled, the bias table [L][bias_stride(PL)] in
// fp32 and each key's group [1 + PL]
__host__ __device__ inline int tile_smem_bytes(int PL, int L) {
  return (3 * PL + 32) * DH * int(sizeof(bf16)) + L * bias_stride(PL) * int(sizeof(float)) +
         (1 + PL) * int(sizeof(int));
}

// The block-diagonal bias of a packed tile at this thread's row x (0, 1) and
// key t: trow[x][t] is the tiled sbias of the row's position (sbias[., 0] at
// the CLS key, NEG at a padded column), kgs[t] the key's group (-1 for the
// CLS key, every row's own) and rg[x] the row's; NEG is added where the
// groups differ.
struct TileBias {
  const float* trow[2];
  const int* kgs;
  int rg[2];
  __device__ __forceinline__ float operator()(int x, int t, int T) const {
    if (t >= T) return 0.0f;
    const float tb = trow[x][t];
    const int kg = kgs[t];
    return kg < 0 || kg == rg[x] ? tb : tb + NEG;
  }
};

// The token rows of one packed tile (blockIdx.x) of head blockIdx.y of video
// blockIdx.z: W = P * Lp / 16 warps of 16 rows, each over the W + 1 key
// tiles of [CLS | the tile's rows]. At most 128 registers a thread, so two
// blocks of up to 8 warps share an SM.
template <int W>
__global__ void __launch_bounds__(MAXPL / 16 * 32, 2)
chunked_tile_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkvc,
                    const float* __restrict__ sbias, bf16* __restrict__ out, int G, int L, int H,
                    int P, int Lp, float scale) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  constexpr int PL = 16 * W;   // P * Lp
  constexpr int T = 1 + PL;    // the CLS key and the tile's rows
  constexpr int Tp = PL + 16;  // T padded to whole key tiles
  constexpr int BS = bias_stride(PL);
  bf16* qs = reinterpret_cast<bf16*>(tile_smem);           // [PL][DH]  Q, then the output
  bf16* ks = qs + PL * DH;                                 // [Tp][DH]  k_cls, K, zeros
  bf16* vs = ks + Tp * DH;                                 // [Tp][DH]  v_cls, V, zeros
  float* tbias = reinterpret_cast<float*>(vs + Tp * DH);  // [L][BS]   tiled sbias
  int* kgs = reinterpret_cast<int*>(tbias + L * BS);       // [T]       each key's group
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int inner = H * DH;
  const i64 c3 = 3 * i64(inner);
  const bf16* cls = qkvc + b * c3;
  attn_rows::stage_rows(ks, 0, cls + inner + h * DH, 0, 1, 1);
  attn_rows::stage_rows(vs, 0, cls + 2 * inner + h * DH, 0, 1, 1);
  for (int j = 0; j < P; ++j) {  // group j of the tile: L rows, zeros to Lp (all zeros past G)
    const int g = tile * P + j;
    const int rows = g < G ? L : 0;
    const bf16* src = qkv + (i64(b) * G + min(g, G - 1)) * L * c3 + h * DH;
    attn_rows::stage_rows(qs, j * Lp, src, c3, rows, (j + 1) * Lp);
    attn_rows::stage_rows(ks, 1 + j * Lp, src + inner, c3, rows, 1 + (j + 1) * Lp);
    attn_rows::stage_rows(vs, 1 + j * Lp, src + 2 * inner, c3, rows, 1 + (j + 1) * Lp);
  }
  attn_rows::stage_rows(ks, T, nullptr, 0, 0, Tp);
  attn_rows::stage_rows(vs, T, nullptr, 0, 0, Tp);

  // The tiled sbias, copied with the rows: at position l and key t,
  // sbias[l, 0] at the CLS key (t = 0) and, at column c = t - 1 of the tile,
  // sbias[l, 1 + c % Lp], or NEG past L. A lane takes keys lane, lane + 32,
  // ...: their columns and groups once, for every position.
  int col[MAXKJ];
#pragma unroll
  for (int j = 0; j < MAXKJ; ++j) {
    const int t = lane + 32 * j;
    const int c = t - 1;
    col[j] = c < 0 ? 0 : c % Lp < L ? 1 + c % Lp : -1;
    if (warp == 0 && t < T) kgs[t] = c < 0 ? -1 : c / Lp;
  }
  for (int l = warp; l < L; l += W) {
    const float* srow = sbias + (i64(b) * L + l) * (L + 1);
#pragma unroll
    for (int j = 0; j < MAXKJ; ++j) {
      const int t = lane + 32 * j;
      if (t < T && col[j] >= 0) warp_mma::cp_async4(tbias + l * BS + t, srow + col[j]);
      if (t < T && col[j] < 0) tbias[l * BS + t] = NEG;
    }
  }
  warp_mma::cp_async_wait_all();
  __syncthreads();

  const int r0 = warp * 16;
  TileBias bias;
  bias.kgs = kgs;
#pragma unroll
  for (int x = 0; x < 2; ++x) {  // this thread's rows, as in the C fragments
    const int r = r0 + (lane >> 2) + 8 * x;
    bias.rg[x] = r / Lp;
    bias.trow[x] = tbias + min(r % Lp, L - 1) * BS;
  }
  uint32_t qa[DH / 16][4];
  attn_rows::load_a_smem(qa, qs + r0 * DH, lane);
  float o[DH / 8][4];
  attn_rows::attend_rows<W + 1>(o, qa, ks, vs, T, scale, bias, lane);

  // the warp's rows through its own rows of qs (dead once its A fragments
  // are loaded), then out by 16-byte stores, a row's 128 bytes at a time
  const int tig = lane & 3;
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(qs + attn_rows::sw(r0 + (lane >> 2) + 8 * x,
                                                            c * 8 + 2 * tig)) =
          __floats2bfloat162_rn(o[c][2 * x], o[c][2 * x + 1]);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (DH / 8); i += 32) {
    const int r = r0 + i / (DH / 8);
    const int c = i % (DH / 8) * 8;
    const int g = tile * P + r / Lp;
    const int l = r % Lp;
    if (g < G && l < L)  // a padded row: dropped
      *reinterpret_cast<uint4*>(out + ((i64(b) * G + g) * L + l) * inner + h * DH + c) =
          *reinterpret_cast<const uint4*>(qs + attn_rows::sw(r, c));
  }
}

struct TileArgs {
  const bf16* qkv;
  const bf16* qkvc;
  const float* sbias;
  bf16* out;
  int G, L, H, P, Lp;
  float scale;
};

template <int W>
cudaError_t launch_tile(const TileArgs& a, int B, cudaStream_t s) {
  const int smem = tile_smem_bytes(16 * W, a.L);
  cudaError_t err = cudaFuncSetAttribute(chunked_tile_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  chunked_tile_kernel<W><<<dim3((a.G + a.P - 1) / a.P, a.H, B), W * 32, smem, s>>>(
      a.qkv, a.qkvc, a.sbias, a.out, a.G, a.L, a.H, a.P, a.Lp, a.scale);
  return cudaGetLastError();
}

}  // namespace

// qkv (B, G, L, 3*H*dh), qkvc (B, 3*H*dh), sbias (B, L, 1+L) contiguous and
// 16-byte aligned; row_bias fp32 through (B, G, L) element strides; out
// (B, G, L, H*dh) and out_cls (B, H*dh) contiguous; cls_scratch fp32 (B, H,
// G*L + cls_chunks * (dh + 2)) over cls_chunks chunks of the CLS row's keys.
extern "C" int chunked_attention_fwd(const void* qkv, const void* qkvc, const void* sbias,
                                     const void* row_bias, i64 rb_b, i64 rb_g, i64 rb_l,
                                     void* out, void* out_cls, void* cls_scratch, int cls_chunks,
                                     int B, int G, int L, int H, int dh, int P, int Lp,
                                     void* stream) {
  if (dh != DH || B < 1 || G < 1 || L < 1 || H < 1 || P < 1 || P > MAXPL || Lp < L ||
      Lp > MAXPL || P * Lp % 16 || P * Lp > MAXPL || B > 65535 || H > 65535 ||
      cls_chunks < 1 || cls_chunks > i64(G) * L || cls_chunks > 65535 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(qkvc) % 16)
    return int(cudaErrorInvalidValue);
  const int PL = P * Lp;
  const float scale = 1.0f / sqrtf(float(DH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* qc = static_cast<const bf16*>(qkvc);
  const TileArgs args = {q, qc, static_cast<const float*>(sbias), static_cast<bf16*>(out),
                         G, L, H, P, Lp, scale};
  cudaError_t err;
  switch (PL / 16) {  // the tile's warps: 1 (PL = 16) .. 8 (PL = 128)
    case 1: err = launch_tile<1>(args, B, s); break;
    case 2: err = launch_tile<2>(args, B, s); break;
    case 3: err = launch_tile<3>(args, B, s); break;
    case 4: err = launch_tile<4>(args, B, s); break;
    case 5: err = launch_tile<5>(args, B, s); break;
    case 6: err = launch_tile<6>(args, B, s); break;
    case 7: err = launch_tile<7>(args, B, s); break;
    default: err = launch_tile<8>(args, B, s); break;
  }
  if (err != cudaSuccess) return int(err);
  const i64 inner = i64(H) * DH;
  return int(cls_row::launch_cls_row(q, i64(G) * L * 3 * inner, L * 3 * inner, 3 * inner, qc,
                                     3 * inner, static_cast<const float*>(row_bias), rb_b, rb_g,
                                     rb_l, static_cast<float*>(cls_scratch), cls_chunks,
                                     static_cast<bf16*>(out_cls), inner, B, G, L, H, scale, s));
}
