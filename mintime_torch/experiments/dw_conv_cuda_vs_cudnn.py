"""Depthwise conv (stride 1, SAME) + bias + SiLU on the card: the port's
kernel against cuDNN (the port's counterpart of
``experiments/dw_conv_pallas_vs_xla.py``).

At the probe's geometry (512 images: 32 videos x 16 faces), for each
stride-1 depthwise layer of EfficientNet-B0 (``GEOMS``, with its count in
the network):

  kernel   ``dw_conv_bias_silu_cuda`` (``csrc/dw_conv.cu``), NHWC bf16, fp32
           weights and bias
  library  cuDNN: ``F.conv2d(groups=C)`` with its bias on the channels-last
           view, then ``F.silu``, in bf16 (a yardstick; the port never calls
           it)

Times by CUDA events over 20 calls after 3 warm-up calls; ``bound_ms`` is the
card's least time for the kernel's work (x read once, y written once, at
3.35 TB/s; its fp32 operations at 67 TFLOP/s are below that). ``--check``
also holds the kernel against its plain version (relative error 2e-2, the
JAX probe's rule).

Run on a machine with a card:
``python -m mintime_torch.experiments.dw_conv_cuda_vs_cudnn [--check]``.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from mintime_torch.experiments import PEAK_FP32_FLOP_S, bound_ms, card, require_card, time_ms
from mintime_torch.ops import dw_conv

N = 512
GEOMS = [  # (H, W, C, K, count in B0)
    (112, 112, 32, 3, 1),
    (56, 56, 144, 3, 1),
    (28, 28, 240, 5, 1),
    (14, 14, 480, 3, 2),
    (14, 14, 480, 5, 1),
    (14, 14, 672, 5, 2),
    (7, 7, 1152, 5, 3),
    (7, 7, 1152, 3, 1),
]
CHECK_REL = 2e-2


def make_inputs(H, W, C, K, n=N, seed=0, device="cuda"):
    """x (n, H, W, C) bf16 standard normal, w (K, K, C) and b (C,) fp32 at
    scale 0.1, drawn on the device from a seeded generator."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn((n, H, W, C), generator=gen, device=device).bfloat16()
    w = torch.randn((K, K, C), generator=gen, device=device) * 0.1
    b = torch.randn((C,), generator=gen, device=device) * 0.1
    return x, w, b


def cudnn_dwconv(x, w_oihw, b, K):
    """cuDNN's depthwise conv with bias on the channels-last view of NHWC x,
    then SiLU; NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=K // 2, groups=x.shape[-1])
    return F.silu(y).permute(0, 2, 3, 1)


def bound(x, K):
    """The kernel's bound: (ms, what bounds it)."""
    n = x.numel()
    return bound_ms(2 * 2 * n, 2 * K * K * n, PEAK_FP32_FLOP_S)


def run(device="cuda", check: bool = False) -> list[dict]:
    dev = require_card(device)
    rows = []
    for H, W, C, K, count in GEOMS:
        x, w, b = make_inputs(H, W, C, K, device=dev)
        w_lib = w.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous()  # (C, 1, K, K)
        b_lib = b.to(torch.bfloat16)
        got = dw_conv.dw_conv_bias_silu_cuda(x, w, b, K=K)
        lib = cudnn_dwconv(x, w_lib, b_lib, K)
        b_ms, b_by = bound(x, K)
        row = {"H": H, "W": W, "C": C, "K": K, "count": count, "N": N,
               "ms": time_ms(lambda: dw_conv.dw_conv_bias_silu_cuda(x, w, b, K=K)),
               "library_ms": time_ms(lambda: cudnn_dwconv(x, w_lib, b_lib, K)),
               "bound_ms": b_ms, "bound_by": b_by,
               "kernel_vs_library_max_abs_err": float((got.float() - lib.float()).abs().max())}
        if check:
            want = dw_conv.dw_conv_bias_silu_plain(x, w, b, K=K).float()
            row["check_rel_err"] = float((got.float() - want).abs().max() / want.abs().max())
        rows.append(row)
        del x, w, b, w_lib, b_lib, got, lib
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
        line = (f"{r['H']:4d}x{r['W']:<4d} C={r['C']:<5d} K={r['K']} x{r['count']}:"
                f" cudnn {r['library_ms']:7.3f} ms  kernel {r['ms']:7.3f} ms"
                f" ({r['library_ms'] / r['ms']:4.2f}x)  bound {r['bound_ms']:6.3f} ms"
                f"  max|kernel-cudnn| {r['kernel_vs_library_max_abs_err']:.4f}")
        if args.check:
            ok = "OK" if r["check_rel_err"] <= CHECK_REL else "MISMATCH"
            line += f"  vs plain rel err {r['check_rel_err']:.2e} {ok}"
        print(line)
    print(f"TOTAL (stride-1 layers): cudnn {total_l:.2f} ms  kernel {total_k:.2f} ms")


if __name__ == "__main__":
    main()
