"""The GEGLU feed-forward forward kernel: ``x (M, D)`` through ``w0 (2H, D)``,
``val * gelu(gate)``, then ``w1 (D, H)``. Operations: its two products,
``2 M D 2H + 2 M H D``; the gate's elementwise work is not counted."""

from harness.kernelcalls import nbytes

MODULE, FUNCTION = "mintime_torch.ops.geglu_ffn", "geglu_ffn_cuda"
KERNELS = ("geglu_ffn_up_kernel", "geglu_ffn_down_kernel", "geglu_ffn_down_reduce_kernel")


def work(args, kwargs, out):
    x, w0, b0, w1, b1 = args[:5]
    d, h = x.shape[-1], w1.shape[1]
    m = x.numel() // d
    return 6 * m * d * h, nbytes(x, w0, b0, w1, b1, out)
