"""Training: one training system built in set-up and driven from the seed
through its first three steps, on batches whose rows all differ, by the same
call and feed as the window; the window then carries the same object on,
cycling through the pool's batches, starting steps until ``--seconds`` have
passed and ending when the last has finished. The rate is all videos over all
of that time.

The plain reference follows the first three steps from the same weights and
batches. Compared: each step's loss; each leaf's norm of the first gradient
as the optimizer got it, worked out from the parameters after step 1
(``p0 - p1 = lr0 (g + wd p0)``); each leaf's norm of the change after step 3,
read before step 4."""

from __future__ import annotations

import gc
import time

import torch

from harness import compare, files, kernelcalls, trace, weights
from harness.core import Record, Run
from harness.systems import ReferenceTraining, learning_rate
from reference.numerics import Numerics, tf32_off

FIRST_STEPS = 3
#: steps in the profiled window of a ``--trace 1`` run
TRACED_STEPS = 2


def _norms(t: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in t.items()}


def first_steps(system, batches: list, cfg: dict) -> dict:
    """Losses, first-gradient norms and change norms of the first steps."""
    wd = {k.replace("-", "_"): v for k, v in cfg["training"].items()}["weight_decay"]
    p0 = {k: v.detach().clone() for k, v in system.params().items()}
    losses, grad = [], None
    for k in range(FIRST_STEPS):
        losses.append(float(system.step(batches[k])))
        if k == 0 and hasattr(system, "grad_norms"):  # the reference: by autograd
            grad = dict(system.grad_norms)
        elif k == 0:
            lr = learning_rate(cfg, 0)
            grad = _norms({n: (p0[n] - v.detach()) / lr - wd * p0[n]
                           for n, v in system.params().items()})
    change = _norms({n: v.detach() - p0[n] for n, v in system.params().items()})
    return {"losses": losses, "grad": grad, "change": change}


def run(r: Run) -> Record:
    import faults

    cfg, traffic = r.cell["config_file"], r.cell["traffic_file"]
    fam = files.module("families", cfg["family"])
    inputs = files.module("inputs", traffic["inputs"])
    rec = Record()
    marks = [("start", time.perf_counter())]
    sd = weights.make(fam.spec(cfg), r.sub_seed("weights"), r.device)
    raw = inputs.make(traffic, cfg, r.sub_seed("inputs"), r.device)
    labels = inputs.labels(traffic, traffic["pool_videos"])
    marks.append(("weights_inputs", time.perf_counter()))
    B, seed = traffic["batch"], r.sub_seed("train") % 2**31
    pos_weight = float((labels == 0).sum() / max((labels == 1).sum(), 1))
    if r.variant.get("system") == "control":
        system = ReferenceTraining(fam, cfg, sd, r.device, seed, pos_weight, Numerics("fp8"))
    else:
        system = fam.Training(cfg, sd, r.device, seed, pos_weight)
    faults.plant(system, r.variant.get("fault"))
    marks.append(("system", time.perf_counter()))
    batches = system.prepare(raw, traffic, labels, B)
    marks.append(("batches", time.perf_counter()))
    got = first_steps(system, batches, cfg)
    _sync(r)
    marks.append(("first_steps", time.perf_counter()))
    on_card = torch.device(r.device).type == "cuda"
    if on_card:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    steps = 0
    rec.window_start = t0 = time.perf_counter()
    while r.seconds > 0:
        system.step(batches[(FIRST_STEPS + steps) % len(batches)])
        steps += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    _sync(r)
    window = time.perf_counter() - t0
    rec.attempted = (FIRST_STEPS + steps) * B
    rec.items_per_s = steps * B / window if steps else None
    rec.e2e = {"train_videos_per_s": rec.items_per_s}
    rec.flops_per_item = files.module("flops", cfg["family"]).train(cfg)
    rec.notes = {"steps": steps, "window_s": window, "losses": got["losses"],
                 "setup_phases_s": {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}}
    if on_card:
        rec.window_peak_bytes = torch.cuda.max_memory_allocated()
        rec.memory_peak_bytes = max(rec.memory_peak_bytes, rec.window_peak_bytes)
        rec.device_kind = torch.cuda.get_device_name(0)
    if r.trace:
        with kernelcalls.recording() as calls:
            def traced():
                for k in range(TRACED_STEPS):
                    system.step(batches[k % len(batches)])
            rec.traced = trace.profile(traced)
        rec.kernel_calls = calls[-(len(calls) // rec.traced["tries"]):]
        rec.traced_calls = TRACED_STEPS

    del system, batches
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    tf32_off()
    ref = ReferenceTraining(fam, cfg, sd, r.device, seed, pos_weight, Numerics("fp32"))
    want = first_steps(ref, ref.prepare(raw, traffic, labels, B), cfg)
    gaps = compare.training(got, want)
    limits = r.cell["limits"]
    rec.checks = {k: (v, limits[k]) for k, v in gaps.items() if k in limits}
    rec.notes.update({k: v for k, v in gaps.items() if k not in limits},
                     reference_losses=want["losses"])
    rec.failed = 0 if all(v <= lim for v, lim in rec.checks.values()) else FIRST_STEPS * B
    return rec


def _sync(r: Run) -> None:
    if torch.device(r.device).type == "cuda":
        torch.cuda.synchronize()
