"""Scoring in a closed loop: calls of ``batch`` assembled videos, drawn in
turn from a pool assembled in set-up, each waited on before the next. The
window starts calls until ``--seconds`` have passed and ends when the last
returns; the rate is all videos over all of it, the tail the 95th percentile
of every call's latency. Every answer of every call in the window is then
compared with the plain reference's answer for its video."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import compare, files, kernelcalls, trace, weights
from harness.core import Record, Run
from reference.numerics import Numerics, tf32_off

#: calls in the profiled window of a ``--trace 1`` run
TRACED_CALLS = 3


def run(r: Run) -> Record:
    import faults

    cfg, traffic = r.cell["config_file"], r.cell["traffic_file"]
    fam = files.module("families", cfg["family"])
    rec = Record()
    marks = [("start", time.perf_counter())]
    sd = weights.make(fam.spec(cfg), r.sub_seed("weights"), r.device)
    videos = files.module("inputs", traffic["inputs"]).make(traffic, cfg, r.sub_seed("inputs"),
                                                           r.device)
    marks.append(("weights_inputs", time.perf_counter()))
    if r.variant.get("system") == "control":
        system = fam.ReferenceServing(cfg, sd, r.device, Numerics("fp8"))
    else:
        system = fam.Serving(cfg, sd, r.device)
    faults.plant(system, r.variant.get("fault"))
    marks.append(("system", time.perf_counter()))
    pool = system.prepare(videos, traffic)
    marks.append(("assembly", time.perf_counter()))
    B = traffic["batch"]
    batches = [list(range(i, min(i + B, len(pool)))) for i in range(0, len(pool), B)]
    for rows in batches:  # every shape the window uses
        system.predict([pool[i] for i in rows])
    _sync(r)

    answers, latency = [], []
    rec.window_start = t0 = time.perf_counter()
    marks.append(("warm_up", t0))
    while True:
        rows = batches[len(latency) % len(batches)]
        t = time.perf_counter()
        out = system.predict([pool[i] for i in rows])
        latency.append(time.perf_counter() - t)
        answers.append((rows, out))
        if time.perf_counter() - t0 >= r.seconds:
            break
    window = time.perf_counter() - t0
    videos_done = sum(len(rows) for rows, _ in answers)
    rec.e2e = {"score_videos_per_s": videos_done / window,
               "score_p95_ms": 1e3 * float(np.percentile(latency, 95))}
    rec.attempted, rec.items_per_s = videos_done, videos_done / window
    rec.flops_per_item = files.module("flops", cfg["family"]).forward(cfg)
    rec.notes = {"calls": len(latency), "window_s": window,
                 "p50_ms": 1e3 * float(np.percentile(latency, 50)), "setup_phases_s": _phases(marks)}

    if r.trace:
        with kernelcalls.recording() as calls:
            def traced():
                for k in range(TRACED_CALLS):
                    system.predict([pool[i] for i in batches[k % len(batches)]])
            rec.traced = trace.profile(traced)
        rec.kernel_calls = calls[-_per_window(calls, rec.traced["tries"]):]
        rec.traced_calls = TRACED_CALLS
    _sync(r)
    if torch.device(r.device).type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
        rec.device_kind = torch.cuda.get_device_name(0)

    del system, pool
    gc.collect()
    if torch.device(r.device).type == "cuda":
        torch.cuda.empty_cache()
    tf32_off()
    ref = fam.ReferenceServing(cfg, sd, r.device, Numerics("fp32"))
    want = ref.predict(ref.prepare(videos, traffic))
    got, exp = [], []
    for rows, out in answers:
        got += out
        exp += [want[i] for i in rows]
    from reference.assembly import SCALE

    m = {k.replace("-", "_"): v for k, v in cfg["model"].items()}
    gaps = compare.answers(got, exp, SCALE, 1 + m["num_frames"] * m["num_patches"])
    limits = r.cell["limits"]
    rec.checks = {k: (v, limits[k]) for k, v in gaps.items() if k in limits}
    rec.notes.update({k: v for k, v in gaps.items() if k not in limits})
    rec.failed = sum(1 for g, w in zip(got, exp) if abs(g[0] - w[0]) > limits["prob_gap"])
    return rec


def _phases(marks: list) -> dict:
    return {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}


def _per_window(calls: list, tries: int) -> int:
    """The kernel calls of the profiled window that was kept (the last)."""
    return len(calls) // tries


def _sync(r: Run) -> None:
    if torch.device(r.device).type == "cuda":
        torch.cuda.synchronize()
