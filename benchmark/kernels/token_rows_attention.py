"""The token-row attention forward kernel (slices too large for the whole-
slice kernels, such as the conv model's time axis: 1280 groups of 8): each
of the ``B G L`` token rows attends its group's ``L`` keys and the CLS key;
the CLS row is not this kernel's. Operations: ``QK`` and ``PV``, ``4 dh`` a
query, key and head."""

from harness.kernelcalls import nbytes

MODULE, FUNCTION = "mintime_torch.ops.token_rows", "token_rows_attention_cuda"
KERNELS = ("token_rows_fwd_tile_kernel",)


def work(args, kwargs, out):
    qkv_g, qkv_cls, seq_bias = args[:3]
    B, G, L, c3 = qkv_g.shape
    return 4 * (c3 // 3) * B * G * L * (L + 1), nbytes(qkv_g, qkv_cls, seq_bias, out)
