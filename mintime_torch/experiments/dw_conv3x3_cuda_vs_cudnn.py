"""Xception's depthwise 3 x 3 on the card: the port's plain 3 x 3 kernel,
with the ReLU in front of the layer as its prologue, against cuDNN plus
that ReLU's own pass (the port's own measurement: the JAX package has no
kernel here; the numbers behind the shape rule in ``ops/dw_conv.py::_refusal``).

At 1,536 images (96 videos x 16 faces, one scoring call of the benchmark's
``xc_score_b96``), for each distinct depthwise shape of Xception at 224 px
(``GEOMS``, with its count in the network and whether a ReLU precedes it):

  kernel   ``dw_conv3x3_cuda`` (``csrc/dw_conv.cu``) at ``plan``, NCHW
           bf16 in channels-last memory, the module's (C, 1, 3, 3) bf16
           weights, ``relu`` as the layer has it
  library  cuDNN: ``F.conv2d(groups=C)`` on the channels-last input, after
           ``F.relu`` where the layer has a ReLU (a yardstick; the port
           keeps it where the kernel is not faster)

Times by CUDA events over 20 calls after 3 warm-up calls; ``bound_ms`` is the
card's least time for the kernel's work (x read once, y written once, at
3.35 TB/s; its fp32 operations at 67 TFLOP/s are below that). ``--check``
also holds the kernel against its plain version (relative error 2e-2).

Run on a machine with a card:
``python -m mintime_torch.experiments.dw_conv3x3_cuda_vs_cudnn [--check]``.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from mintime_torch.experiments import PEAK_FP32_FLOP_S, bound_ms, card, require_card, time_ms
from mintime_torch.ops import dw_conv

N = 1536
GEOMS = [  # (H, W, C, count in Xception at 224 px, ReLU in front)
    (109, 109, 64, 1, False),
    (109, 109, 128, 1, True),
    (55, 55, 128, 1, True),
    (55, 55, 256, 1, True),
    (28, 28, 256, 1, True),
    (28, 28, 728, 1, True),
    (14, 14, 728, 26, True),
    (7, 7, 1024, 1, False),
    (7, 7, 1536, 1, True),
]
CHECK_REL = 2e-2


def make_inputs(H, W, C, n=N, seed=0, device="cuda"):
    """x (n, C, H, W) bf16 standard normal in channels-last memory and w
    (C, 1, 3, 3) bf16 at scale 0.3, drawn on the device from a seeded
    generator."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn((n, H, W, C), generator=gen, device=device).bfloat16().permute(0, 3, 1, 2)
    w = (torch.randn((C, 1, 3, 3), generator=gen, device=device) * 0.3).bfloat16()
    return x, w


def cudnn_dwconv(x, w, relu):
    """cuDNN's depthwise conv on x, after ReLU's pass where ``relu``."""
    return F.conv2d(F.relu(x) if relu else x, w, padding=1, groups=x.shape[1])


def bound(x):
    """The kernel's bound: (ms, what bounds it)."""
    return bound_ms(4 * x.numel(), 18 * x.numel(), PEAK_FP32_FLOP_S)


def run(device="cuda", check: bool = False) -> list[dict]:
    dev = require_card(device)
    rows = []
    for H, W, C, count, relu in GEOMS:
        x, w = make_inputs(H, W, C, device=dev)
        got = dw_conv.dw_conv3x3_cuda(x, w, relu=relu)
        lib = cudnn_dwconv(x, w, relu)
        b_ms, b_by = bound(x)
        ms = time_ms(lambda: dw_conv.dw_conv3x3_cuda(x, w, relu=relu))
        row = {"H": H, "W": W, "C": C, "count": count, "relu": relu, "N": N,
               "plan": dw_conv.plan(H, W, C, 3), "ms": ms,
               "library_ms": time_ms(lambda: cudnn_dwconv(x, w, relu)),
               "cudnn_conv_ms": time_ms(lambda: cudnn_dwconv(x, w, False)),
               "bound_ms": b_ms, "bound_by": b_by, "pct_of_bound": 100 * b_ms / ms,
               "on_kernel": dw_conv.on_kernel(x, w),
               "kernel_vs_library_max_abs_err": float((got.float() - lib.float()).abs().max())}
        if check:
            want = dw_conv.dw_conv3x3_plain(x, w, relu=relu).float()
            row["check_rel_err"] = float((got.float() - want).abs().max() / want.abs().max())
        rows.append(row)
        del x, w, got, lib
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="hold the kernel against its plain version")
    args = ap.parse_args()
    print(f"card: {card()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    total_k = total_l = 0.0
    for r in run(check=args.check):
        total_k += r["ms"] * r["count"]
        total_l += r["library_ms"] * r["count"]
        line = (f"{r['H']:4d}x{r['W']:<4d} C={r['C']:<5d} relu={int(r['relu'])} x{r['count']:<2d}"
                f" plan {r['plan']}: cudnn{'+relu' if r['relu'] else ''} {r['library_ms']:7.3f} ms"
                f" (conv {r['cudnn_conv_ms']:.3f})  kernel {r['ms']:7.3f} ms"
                f" ({r['library_ms'] / r['ms']:4.2f}x, {r['pct_of_bound']:.0f}% of bound"
                f" {r['bound_ms']:.3f})  on kernel {r['on_kernel']}"
                f"  max|kernel-cudnn| {r['kernel_vs_library_max_abs_err']:.4f}")
        if args.check:
            ok = "OK" if r["check_rel_err"] <= CHECK_REL else "MISMATCH"
            line += f"  vs plain rel err {r['check_rel_err']:.2e} {ok}"
        print(line)
    print(f"TOTAL (one forward of {N} faces): cudnn {total_l:.2f} ms  kernel {total_k:.2f} ms")


if __name__ == "__main__":
    main()
