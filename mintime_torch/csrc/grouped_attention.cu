// Grouped attention with a CLS key and value over pre-split q, k, v, for
// Hopper (sm_90a), bf16 in and out, fp32 inside.
//
// Replaces: mintime_tpu/ops/pallas_attention.py::_kernel (reached through
// fused_grouped_attention, the v1 kernel). Inputs are q, k, v (B*H, G, L, D)
// with q pre-scaled, k_cls and v_cls (B*H, D), and an optional additive
// bias (B, L, 1+L) fp32 shared over heads and groups (column 0 the CLS key).
// Per (b*h, g) and query row r:
//   P   = bf16(softmax([q_r k_cls | q_r K^T] + bias[b, r]))   (fp32 logits)
//   out = bf16(P[1:] V + P[0] v_cls)                            (fp32 sums)
// Masks arrive as finite biases (-0.7 * f32 max), never -inf.
//
// Bound on an H100: memory. At the flagship's B = 8, H = 8, G*L = 784,
// D = 64 a call reads q, k, v once and writes out (4 * 6.4 MB): 7.7 us at
// 3.35 TB/s, plus the bias where there is one; its arithmetic,
// 4*B*H*G*L*(1+L)*D, is at most 0.2 GFLOP.
//
// Design: the TPU kernel took a whole (b*h) slice per grid step and batched
// its groups through the MXU. Here a block takes one (b*h, g) group, a warp
// per 16 query rows: one warp on the time axis (L = 16, 3136 blocks at the
// flagship's B = 8), four on the space axis (L = 49, 1024 blocks). Blocks
// of 2, 4 or 8 warps carrying several groups were no faster on an H100
// (device time, utils.profiling.device_ms). The block stages its group's K and
// V (the CLS pair as row 0) in shared memory as swizzled bf16 rows of 64
// (narrower heads padded with zeros; 16-byte cp.async when D = 64, 4-byte
// loads otherwise); each warp loads its q rows into A fragments and runs
// attn_rows::attend_rows (csrc/attn_rows_mma.cuh): both products on
// mma.sync tiles, two passes over S, P rounded to bf16 after normalising.
// The bias is read per tile from device memory (at most B*L*(1+L)*4 bytes,
// which stays in L2). Every output is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_rows_mma.cuh"

using attn_rows::bf16;
using attn_rows::bf162;
using attn_rows::DH;
using attn_rows::i64;

namespace {

constexpr int MAXL = 64;  // longest group (the space axis' 49)

// one (b*h, g) group of the N = B*H*G a block, a warp per 16 query rows
__global__ void __launch_bounds__(MAXL / 16 * 32)
grouped_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ kc,
                         const bf16* __restrict__ vc, const float* __restrict__ bias,
                         bf16* __restrict__ out, int G, int L, int D, int H, int wide) {
  extern __shared__ __align__(16) unsigned char gsm[];
  const int T = L + 1;  // CLS key + L keys
  const int Tp = attn_rows::pad16(T);
  const int n = blockIdx.x;
  const i64 p = n / G;  // b * H + h
  const i64 base = i64(n) * L * D;
  const int width = wide ? DH : D;  // DH: stage by 16-byte copies
  bf16* ks = reinterpret_cast<bf16*>(gsm);  // [Tp][DH]  k_cls, K, zeros (swizzled)
  bf16* vs = ks + Tp * DH;                  // [Tp][DH]  v_cls, V, zeros (swizzled)
  attn_rows::stage_rows(ks, 0, kc + p * D, 0, 1, 1, width);
  attn_rows::stage_rows(ks, 1, k + base, D, L, Tp, width);
  attn_rows::stage_rows(vs, 0, vc + p * D, 0, 1, 1, width);
  attn_rows::stage_rows(vs, 1, v + base, D, L, Tp, width);

  const int lane = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32 * 16;  // the warp's first row
  uint32_t qa[DH / 16][4];  // loaded while the copies run
  attn_rows::load_a(qa, q + base, D, r0, L, lane, D);
  warp_mma::cp_async_wait_all();
  __syncthreads();

  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int row[2] = {r0 + grp, r0 + grp + 8};
  attn_rows::RowBias row_bias = {{nullptr, nullptr}};
  if (bias != nullptr)
#pragma unroll
    for (int x = 0; x < 2; ++x) row_bias.brow[x] = bias + (p / H * L + min(row[x], L - 1)) * T;
  float o[DH / 8][4];
  attn_rows::attend_rows(o, qa, ks, vs, T, 1.0f, row_bias, lane);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (row[x] >= L) continue;
    bf16* orow = out + base + i64(row[x]) * D;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const int d = c * 8 + 2 * tig;
      if (d < D)
        *reinterpret_cast<bf162*>(orow + d) = __floats2bfloat162_rn(o[c][2 * x], o[c][2 * x + 1]);
    }
  }
}

}  // namespace

// q, k, v, out (B*H, G, L, D) and kc, vc (B*H, D) contiguous; bias (B, L, 1+L)
// contiguous fp32 or null.
extern "C" int grouped_attention_fwd(const void* q, const void* k, const void* v, const void* kc,
                                     const void* vc, const void* bias, void* out, int B, int H,
                                     int G, int L, int D, void* stream) {
  if (D < 2 || D > DH || D % 2 || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1)
    return int(cudaErrorInvalidValue);
  const i64 N = i64(B) * H * G;
  if (N > 0x7fffffff) return int(cudaErrorInvalidValue);
  // 16-byte copies need whole rows of 64 and 16-byte aligned starts
  const void* ptrs[5] = {q, k, v, kc, vc};
  bool wide = D == DH;
  for (const void* p : ptrs) wide = wide && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int smem = 2 * attn_rows::pad16(L + 1) * DH * int(sizeof(bf16));  // <= 20 KB
  grouped_attention_kernel<<<unsigned(N), (L + 15) / 16 * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(kc), static_cast<const bf16*>(vc), static_cast<const float*>(bias),
      static_cast<bf16*>(out), G, L, D, H, wide);
  return int(cudaGetLastError());
}
