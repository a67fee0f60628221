"""Depthwise-conv weight gradient on the card: the port's kernel against
cuDNN's convolution backward (the port's counterpart of
``experiments/dw_conv_bwd_pallas_vs_xla.py``).

At the probe's geometry (512 images), for each depthwise layer of
EfficientNet-B0 (``GEOMS``):

  kernel         ``dw_conv_wgrad_cuda`` (``csrc/dw_conv_wgrad.cu``), the
                 counterpart of the JAX probe's three Pallas layouts
                 (``pl_flat``, ``pl_chan``, ``pl_roll``); stride 1 only
  library_wgrad  cuDNN's weight gradient through
                 ``torch.ops.aten.convolution_backward`` (output mask
                 weight only), on the channels-last views, bf16
  library_dgrad  the same call's data gradient (output mask input only)
  shift          the plain K*K shifted multiply-reduces in fp32
                 (``dw_conv_wgrad_plain``; the JAX probe's ``xla_shift``
                 control); stride 1 only

The stride-2 rows time the library alone, as the JAX probe does. Times by
CUDA events over 20 calls after 3 warm-up calls; ``bound_ms`` is x plus dy
read once at 3.35 TB/s. ``--check`` also holds the kernel against its plain
version (relative error 2e-2 of max |plain|, the JAX probe's rule).
``--ablate`` times, at b0, the kernel beside a build of the same source with
``WGRAD_LOADS_ONLY`` (every row staged as usual, no arithmetic), in turns:
how much of the kernel's time the staging alone takes.

Run on a machine with a card:
``python -m mintime_torch.experiments.dw_conv_bwd_cuda_vs_cudnn [--check] [--ablate]``.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from mintime_torch.experiments import PEAK_FP32_FLOP_S, bound_ms, card, require_card, time_ms
from mintime_torch.ops import _build, dw_conv

N = 512
GEOMS = [  # (tag, H, C, K, stride), square images
    ("b0  112² C32   K3 s1", 112, 32, 3, 1),
    ("b1  112² C96   K3 s2", 112, 96, 3, 2),
    ("b2  56²  C144  K3 s1", 56, 144, 3, 1),
    ("b3  56²  C144  K5 s2", 56, 144, 5, 2),
    ("b4  28²  C240  K5 s1", 28, 240, 5, 1),
    ("b6  14²  C480  K3 s1", 14, 480, 3, 1),
    ("b8  14²  C672  K5 s1", 14, 672, 5, 1),
    ("b12 7²   C1152 K5 s1", 7, 1152, 5, 1),
    ("b15 7²   C1152 K3 s1", 7, 1152, 3, 1),
]
CHECK_REL = 2e-2


def make_inputs(H, C, K, s, n=N, seed=0, device="cuda"):
    """x (n, H, H, C), dy (n, H/s, H/s, C) and w (K, K, 1, C), bf16 standard
    normal drawn on the device from a seeded generator."""
    gen = torch.Generator(device).manual_seed(seed)
    oh = H // s
    x = torch.randn((n, H, H, C), generator=gen, device=device).bfloat16()
    dy = torch.randn((n, oh, oh, C), generator=gen, device=device).bfloat16()
    w = torch.randn((K, K, 1, C), generator=gen, device=device).bfloat16()
    return x, dy, w


def cudnn_backward(x, dy, w, s, mask):
    """``convolution_backward`` of the depthwise conv on the channels-last
    views of NHWC x and dy; ``mask`` picks (input, weight) gradients."""
    K, C = w.shape[0], w.shape[-1]
    return torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(), None,
        [s, s], [K // 2, K // 2], [1, 1], False, [0, 0], C, [mask[0], mask[1], False])


def bound(x, dy, K):
    """The weight gradient's bound, x and dy read once: (ms, what bounds it)."""
    return bound_ms(2 * (x.numel() + dy.numel()), 2 * K * K * dy.numel(), PEAK_FP32_FLOP_S)


def run(device="cuda", check: bool = False) -> list[dict]:
    dev = require_card(device)
    rows = []
    for tag, H, C, K, s in GEOMS:
        x, dy, w = make_inputs(H, C, K, s, device=dev)
        b_ms, b_by = bound(x, dy, K)
        row = {"tag": tag, "H": H, "C": C, "K": K, "stride": s, "N": N,
               "bound_ms": b_ms, "bound_by": b_by,
               "library_wgrad_ms": time_ms(lambda: cudnn_backward(x, dy, w, s, (False, True))),
               "library_dgrad_ms": time_ms(lambda: cudnn_backward(x, dy, w, s, (True, False)))}
        if s == 1:
            got = dw_conv.dw_conv_wgrad_cuda(x, dy, K=K)
            lib = cudnn_backward(x, dy, w, s, (False, True))[1].permute(2, 3, 1, 0)  # (K, K, 1, C)
            row["ms"] = time_ms(lambda: dw_conv.dw_conv_wgrad_cuda(x, dy, K=K))
            row["shift_ms"] = time_ms(lambda: dw_conv.dw_conv_wgrad_plain(x, dy, K=K))
            row["kernel_vs_library_rel_err"] = float(
                (got - lib.float()).abs().max() / lib.float().abs().max())
            if check:
                want = dw_conv.dw_conv_wgrad_plain(x, dy, K=K)
                row["check_rel_err"] = float((got - want).abs().max() / want.abs().max())
        rows.append(row)
        del x, dy, w
        torch.cuda.empty_cache()
    return rows


def ablation(device="cuda") -> dict:
    """At b0: the kernel's ms and the loads-only build's ms, timed in turns
    (kernel, loads only, loads only, kernel); each the mean of its two."""
    dev = require_card(device)
    _, H, C, K, s = GEOMS[0]
    x, dy, _ = make_inputs(H, C, K, s, device=dev)
    N = x.shape[0]
    lib = _build.load("dw_conv_wgrad", defines=("WGRAD_LOADS_ONLY",))
    plan = lib.dw_conv_wgrad_chunks
    plan.argtypes = [ctypes.c_int] * 5
    chunks = plan(N, H, H, C, K)
    partial = torch.empty((chunks, K, K, C), dtype=torch.float32, device=dev)
    out = torch.empty((K, K, 1, C), dtype=torch.float32, device=dev)
    fn = lib.dw_conv_wgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def loads_only():
        _build.check(fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), out.data_ptr(), N, H, H,
                        C, K, chunks, torch.cuda.current_stream(dev).cuda_stream),
                     "dw_conv_wgrad[WGRAD_LOADS_ONLY]")

    kernel = lambda: dw_conv.dw_conv_wgrad_cuda(x, dy, K=K)  # noqa: E731
    a, b, c, d = (time_ms(f) for f in (kernel, loads_only, loads_only, kernel))
    b_ms, _ = bound(x, dy, K)
    return {"tag": GEOMS[0][0], "ms": (a + d) / 2, "loads_only_ms": (b + c) / 2, "bound_ms": b_ms,
            "readings": [a, b, c, d]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="hold the kernel against its plain version")
    ap.add_argument("--ablate", action="store_true",
                    help="at b0, time the kernel beside its loads-only build")
    args = ap.parse_args()
    print(f"card: {card()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    for r in run(check=args.check):
        print(f"=== {r['tag']}  bound {r['bound_ms']:.3f} ms ===")
        print(f"  cudnn_wgrad {r['library_wgrad_ms']:8.3f} ms")
        print(f"  cudnn_dgrad {r['library_dgrad_ms']:8.3f} ms")
        if r["stride"] != 1:
            continue
        print(f"  kernel      {r['ms']:8.3f} ms   vs cudnn rel err {r['kernel_vs_library_rel_err']:.2e}")
        print(f"  shift       {r['shift_ms']:8.3f} ms")
        if args.check:
            ok = "OK" if r["check_rel_err"] <= CHECK_REL else "MISMATCH"
            print(f"  kernel vs plain rel err {r['check_rel_err']:.2e} {ok}")
    if args.ablate:
        r = ablation()
        print(f"=== ablation at {r['tag']}  bound {r['bound_ms']:.3f} ms ===")
        print(f"  kernel      {r['ms']:8.3f} ms")
        print(f"  loads only  {r['loads_only_ms']:8.3f} ms   readings {r['readings']}")


if __name__ == "__main__":
    main()
