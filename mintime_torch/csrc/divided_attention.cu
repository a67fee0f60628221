// Divided space-time attention with a CLS row for Hopper (sm_90a), bf16.
//
// Replaces: mintime_tpu/ops/pallas_attention.py::_divided_kernel (reached
// through _fwd_call, _divided_attention_core and divided_attention).
// Input is packed qkv (B, G, L, 3*H*dh) with columns [q | k | v], each
// head-major (PyTorch's to_qkv layout), read through (B, G, L) strides so
// the time axis needs no transpose, plus the CLS row's packed qkv
// (B, 3*H*dh); starts and strides 16-byte aligned.
//   token rows: softmax over [CLS key | the L keys of the group] + seq_bias
//               (fp32, (B, L, 1+L), column 0 = CLS key), bf16 probabilities,
//               then P @ [v_cls; V] with fp32 accumulation, the CLS term last;
//   CLS row:    one query over all G*L keys (+ row_bias) and itself, with
//               unnormalised bf16 probabilities before PV and the sum
//               divided out at the end, as the TPU kernel does.
// q is scaled by dh^-0.5 in bf16; masks arrive as finite biases
// (-0.7 * f32 max), never -inf.
//
// Bound on an H100: memory. Per call at B = 8 (G*L = 784, H*dh = 512) it
// reads qkv once (6272 * 1536 * 2 B = 19.3 MB) and writes out (6.4 MB):
// about 8 us at 3.35 TB/s; its arithmetic is a few hundred MFLOP.
//
// Design: the TPU held a whole batch slice (2.4 MB) in VMEM; a GPU block
// cannot, so the work splits into launches that each own what they write.
//   * token rows: token_rows_mma_kernel (csrc/attn_rows_mma.cuh, launched
//     by the token-row forward above 16 frames too), a block of up to four
//     warps per (b, g, h), stages the group's K and V (CLS as row 0) by 16-byte
//     cp.async into swizzled bf16 rows (68 KB at L = 256), and each warp
//     runs attn_rows::attend_rows (csrc/attn_rows_mma.cuh) over 16 query
//     rows at a time: S and PV on mma.sync tiles, two passes over S, P
//     rounded after normalising. With dh = 64 the scale 1/8 is a power of
//     two, so bf16(q / 8) = q / 8 exactly: q is read as it is, straight into
//     A fragments, and the scale is applied to S. One block a group, its
//     warps looping over the 16-row tiles, reads K and V once and was as
//     fast as a block per four tiles at L = 80-256; at L <= 64 it took half
//     to a third of the time of the scalar kernel it replaced (a warp per
//     query row, a lane per key; H100, device time by chip_smoke.device_ms);
//   * CLS row, in three launches over cls_chunks chunks of the G*L keys
//     (fp32 scratch (B, H, G*L + chunks * (dh + 2)) from the wrapper;
//     csrc/cls_row_fwd.cuh, which the chunked attention shares):
//     cls_row_logits_kernel writes each key's logit (8 lanes a key, 16-byte
//     loads) and the chunk's max; cls_row_pv_kernel takes the global max
//     m = max(chunk maxima, the CLS self-logit), p = exp(s - m) rounded to
//     bf16 with that m, and writes the chunk's sum of p (fp32) and of
//     bf16(p) v; cls_row_reduce_kernel sums the chunks in order and divides:
//     out = (sum bf16(p) v + ps v_cls) / (sum p + ps). No atomics: reruns
//     give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_rows_mma.cuh"
#include "cls_row_fwd.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int DH = 64;          // head width
constexpr int MAXL = 256;       // longest attended sequence of the token rows

bool aligned16(const void* p, i64 elems) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && elems % 8 == 0;
}

}  // namespace

// cls_chunks: chunks of the G*L keys of the CLS row; cls_scratch: fp32
// (B, H, G*L + cls_chunks * (dh + 2)).
extern "C" int divided_attention_fwd(const void* qkv, i64 sb, i64 sg, i64 sl, const void* qkvc,
                                     i64 scb, const void* seq_bias, const void* row_bias,
                                     i64 rb_b, i64 rb_g, i64 rb_l, void* out, i64 ob, i64 og,
                                     i64 ol, void* out_cls, i64 ocb, void* cls_scratch,
                                     int cls_chunks, int B, int G, int L, int H, int dh,
                                     void* stream) {
  if (dh != DH || L < 1 || L > MAXL || G < 1 || B < 1 || H < 1 || B > 65535 || G > 65535 ||
      cls_chunks < 1 || cls_chunks > G * L || cls_chunks > 65535)
    return int(cudaErrorInvalidValue);
  // 16-byte loads: aligned starts and strides
  if (!aligned16(qkv, sb) || !aligned16(qkv, sg) || !aligned16(qkv, sl) || !aligned16(qkvc, scb))
    return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(DH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* qc = static_cast<const bf16*>(qkvc);
  const float* sbias = static_cast<const float*>(seq_bias);
  const float* rbias = static_cast<const float*>(row_bias);
  float* scratch = static_cast<float*>(cls_scratch);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err = attn_rows::launch_token_rows_mma(q, sb, sg, sl, qc, scb, sbias, o, ob, og, ol,
                                                     B, G, L, H, scale, s);
  if (err != cudaSuccess) return int(err);
  return int(cls_row::launch_cls_row(q, sb, sg, sl, qc, scb, rbias, rb_b, rb_g, rb_l, scratch,
                                     cls_chunks, static_cast<bf16*>(out_cls), ocb, B, G, L, H,
                                     scale, s));
}
