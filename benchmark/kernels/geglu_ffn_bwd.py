"""The GEGLU feed-forward backward kernel: from ``x``, the weights and the
output's gradient, the gradients of ``x``, ``w0``, ``b0``, ``w1``, ``b1``.
Operations: the up-projection recomputed (its input is ``x``, not the
activation), ``4 M D H``; ``dh = dout w1`` and ``dw1``, ``2 M D H`` each;
``dx`` and ``dw0``, ``4 M D H`` each: ``16 M D H`` in all."""

from harness.kernelcalls import nbytes

MODULE, FUNCTION = "mintime_torch.ops.geglu_ffn", "geglu_ffn_bwd_cuda"
KERNELS = ("ffn_bwd_dh_kernel", "ffn_bwd_products_kernel", "ffn_bwd_reduce_kernel")


def work(args, kwargs, out):
    x, w0, b0, w1, dout = args[:5]
    d, h = x.shape[-1], w1.shape[1]
    m = x.numel() // d
    return 16 * m * d * h, nbytes(x, w0, b0, w1, dout, out)
