"""The divided-attention forward kernel (whole slices): ``qkv_g (B, G, L,
3 H dh)`` packed ``[q|k|v]``, the CLS row's ``qkv_cls (B, 1, 3 H dh)`` and
the masks' biases. Each of the ``B G L`` token rows attends its ``L`` keys
and the CLS key; the CLS row attends ``G L + 1`` keys. Operations: ``QK``
and ``PV``, ``4 dh`` a query, key and head; the softmax is not counted."""

from harness.kernelcalls import nbytes

MODULE, FUNCTION = "mintime_torch.ops.divided_attention", "divided_attention_cuda"
KERNELS = ("token_rows_mma_kernel", "cls_row_logits_kernel", "cls_row_pv_kernel",
           "cls_row_reduce_kernel")


def work(args, kwargs, out):
    qkv_g, qkv_cls, seq_bias, row_bias = args[:4]
    B, G, L, c3 = qkv_g.shape
    inner = c3 // 3
    flops = 4 * inner * (B * G * L * (L + 1) + B * (G * L + 1))
    return flops, nbytes(qkv_g, qkv_cls, seq_bias, row_bias, out)
