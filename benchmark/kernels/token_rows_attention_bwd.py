"""The token-row attention backward kernel: the packed qkv's gradients from
the token rows' output gradients (the CLS key's and value's summed over the
groups). Operations: 10 a query, key and head dimension, as
``divided_attention_bwd``, over each token row's ``L + 1`` keys."""

from harness.kernelcalls import nbytes

MODULE, FUNCTION = "mintime_torch.ops.token_rows", "token_rows_attention_bwd_cuda"
KERNELS = ("token_rows_bwd_tile_kernel", "token_rows_cls_reduce_kernel")


def work(args, kwargs, out):
    qkv_g, qkv_cls, seq_bias, d_tok = args[:4]
    B, G, L, c3 = qkv_g.shape
    return 10 * (c3 // 3) * B * G * L * (L + 1), nbytes(qkv_g, qkv_cls, seq_bias, d_tok, out)
