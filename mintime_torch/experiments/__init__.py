"""The port's probes: the JAX package's ``experiments/`` measurements that
hold a TPU kernel, rerun on the card with the port's kernels beside a
library call and the plain version (``attn_kernel_variants``,
``dw_conv_cuda_vs_cudnn``, ``dw_conv_bwd_cuda_vs_cudnn``), and the port's own
measurements (``kernel_turns``: two checkouts in turns;
``token_rows_phases``: the token-row launches with phases cut). Each probe has
``run(device="cuda") -> list[dict]`` and a ``main()`` that prints a table:
``python -m mintime_torch.experiments.<name>``. Times are device times by
CUDA events; there is no CPU mode.
"""

from __future__ import annotations

import subprocess

import torch

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_FP32_FLOP_S = 67e12  # CUDA cores, outside the tensor cores


def bound_ms(nbytes: float, flops: float, peak_flop_s: float = PEAK_BF16_FLOP_S) -> tuple[float, str]:
    """Least time in ms for the work on the card, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flop_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def require_card(device) -> torch.device:
    """The probes measure the card: a CPU device is refused."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the probes time CUDA kernels and need a card; got device {device!r}"
                           f" (torch.cuda.is_available() is {torch.cuda.is_available()})")
    return dev
