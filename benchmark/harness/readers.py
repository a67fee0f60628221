"""Arithmetic that several per-layer metrics share: the table of peaks, MFU,
the hand-written kernels' share of their roofline, the idle share."""

from __future__ import annotations

import os

from harness import files, kernelcalls, trace


def peaks(kind: str) -> dict | None:
    table = files.load_json(os.path.join(files.BENCH, "peaks.json"))
    return next((v for k, v in table.items() if not k.startswith("_") and k in kind), None)


def mfu_pct(rec) -> float | None:
    p = peaks(rec.device_kind)
    if p is None or not rec.items_per_s or not rec.flops_per_item:
        return None
    return 100.0 * rec.flops_per_item * rec.items_per_s / p["bf16_flop_s"]


def roofline_pct(rec) -> float | None:
    """Sum over the traced window's kernel calls of the least time their
    operations and bytes need, over the summed device time of the
    hand-written kernels' records."""
    p = peaks(rec.device_kind)
    if p is None or not rec.traced or not rec.kernel_calls:
        return None
    table = kernelcalls.specs()
    spent = sum(b - a for n, a, b in rec.traced["kernels"] if kernelcalls.is_handwritten(n, table))
    if spent <= 0:
        return None
    least = sum(max(f / p["bf16_flop_s"], n / p["bytes_s"]) for _, f, n in rec.kernel_calls)
    return 100.0 * least / (spent / 1e9)


def idle_pct(rec) -> float | None:
    if not rec.traced or not rec.traced["kernels"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(rec.traced["kernels"]) / rec.traced["window_s"])


def per_call(rec) -> float | None:
    if not rec.traced or not rec.traced_calls:
        return None
    return len(rec.traced["kernels"]) / rec.traced_calls
