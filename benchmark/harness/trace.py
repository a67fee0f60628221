"""A profiled window on the card and what is read from it: the device records
(kernels, copies, sets) from ``torch.profiler``'s raw records, busy time as
the union of their intervals, and the host operation under way in each idle
gap. A window that lost a record (a host launch whose correlation id no
device record carries) is profiled again. The arithmetic is that of
``mintime_torch/utils/profiling.py`` (``_window_kernels``, ``_profile``),
copied so that the yardstick does not move with the program."""

from __future__ import annotations

import collections
import time

LEAD_IN, LEAD_INS, PAD_S, TRIES = "spin_kernel", 4, 0.05, 5


def kind(name: str) -> str:
    """Coarse class of a device record, from its name (``profiling._kind``)."""
    low = name.lower()
    if ("token_rows_bwd" in low or "token_rows_cls_reduce" in low
            or ("attn_bwd" in low and "<false>" in low)):
        return "token_rows_attention backward kernel"
    if "token_rows_fwd" in low:
        return "token_rows_attention kernel"
    if "ffn_bwd" in low:
        return "geglu_ffn backward kernel"
    if "attn_bwd" in low:
        return "divided_attention backward kernel"
    if "geglu" in low:
        return "geglu_ffn kernel"
    if "token_rows" in low or "cls_row" in low:
        return "divided_attention kernel"
    if any(w in low for w in ("conv2d", "convolution", "cudnn", "implicit", "depthwise", "fprop")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "matmul", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memory copies and sets"
    if "softmax" in low or "reduce" in low or "norm" in low:
        return "reduction / norm"
    return "elementwise"


def _records(prof):
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    launches = {e.correlation_id() for e in raw
                if e.device_type() == cpu and "LaunchKernel" in e.name()}
    device = [e for e in raw if e.device_type() == cuda and LEAD_IN not in e.name()
              and not e.is_user_annotation()]
    kernels = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in device),
                     key=lambda k: k[1:])
    lost = len(launches - {e.correlation_id() for e in device}) - LEAD_INS
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in raw
            if e.device_type() == cpu and not e.name().startswith(("cuda", "cu"))]
    return kernels, lost, host


def profile(fn) -> dict:
    """``fn()`` (which ends in a synchronise) under ``torch.profiler``,
    padded with host time and opened by spin kernels; again while a window
    lost records. Returns the device records, the host ops, the host window
    in seconds and the records lost in the window kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _prof

    tries = []
    for _ in range(TRIES):
        with _prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            for _ in range(LEAD_INS):
                torch.cuda._sleep(5000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
            time.sleep(PAD_S)
        kernels, lost, host = _records(prof)
        tries.append(lost)
        if kernels and lost <= 0:
            break
    return {"kernels": kernels, "host": host, "window_s": window, "lost": lost,
            "tries": len(tries)}


def busy_s(kernels) -> float:
    busy, end = 0, float("-inf")
    for _, a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e9


def breakdown(kernels, host, top: int = 10) -> dict:
    """The device operations that took most time (classes, then names) and
    the longest idle gaps, each named by the innermost host operation under
    way at the gap's middle."""
    by_kind, by_name = collections.Counter(), collections.Counter()
    for name, a, b in kernels:
        by_kind[kind(name)] += (b - a) / 1e9
        by_name[name[:120]] += (b - a) / 1e9
    ops = [[f"class: {k}", v] for k, v in by_kind.most_common(4)]
    ops += [[k, v] for k, v in by_name.most_common(top - len(ops))]
    gaps, end = [], None
    for _, a, b in kernels:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        under = [h for h in host if h[1] <= mid <= h[2]]
        label = max(under, key=lambda h: h[1])[0] if under else "(no host op)"
        named.append([label[:120], (b - a) / 1e9])
    return {"device_ops": ops, "idle_gaps": named}
