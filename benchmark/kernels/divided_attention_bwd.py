"""The divided-attention backward kernel: from the packed qkv, the biases
and the outputs' gradients, the gradients of the packed qkv. Operations a
query, key and head dimension: the logits recomputed, ``dP = dO V^T``,
``dV = P^T dO``, ``dQ = dS K``, ``dK = dS^T Q``: 10, over the token rows'
``L + 1`` keys and the CLS row's ``G L + 1``."""

from harness.kernelcalls import nbytes

MODULE, FUNCTION = "mintime_torch.ops.divided_attention", "divided_attention_bwd_cuda"
KERNELS = ("attn_bwd_cls_logits_kernel", "attn_bwd_cls_sums_kernel",
           "attn_bwd_cls_finish_kernel", "attn_bwd_cls_reduce_kernel", "attn_bwd_rows_kernel",
           "attn_bwd_cols_kernel")


def work(args, kwargs, out):
    qkv_g, qkv_cls, seq_bias, row_bias, d_tok, d_cls = args[:6]
    B, G, L, c3 = qkv_g.shape
    inner = c3 // 3
    flops = 10 * inner * (B * G * L * (L + 1) + B * (G * L + 1))
    return flops, nbytes(qkv_g, qkv_cls, seq_bias, row_bias, d_tok, d_cls, out)
