"""Tracing and profiling of the port (counterpart of
``mintime_tpu/utils/profiling.py``).

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``*.pt.trace.json``, which TensorBoard's profiler plugin
  and Perfetto load) into a directory through
  ``torch.profiler.tensorboard_trace_handler``.
* :func:`span` and :func:`count`: the program's spans (a
  ``torch.profiler.record_function`` range while a profile is active,
  nothing else) and counters (one table, always on), named by the
  constants below.
* :func:`sync`: waits for the card when a tensor of its argument is on it.
* :func:`op_stats`: per-op time from a trace directory or a profile: the
  device kernels by name where the trace holds kernels, else the CPU ops by
  self time.
* ``python -m mintime_torch.utils.profiling``: :func:`main`, the JAX CLI's
  flags plus ``--device``.

Profiled windows on the card (:func:`trace`, :func:`device_ms`,
:func:`_profile`) start with ``PAD_S`` of host time and ``LEAD_INS`` spin
kernels (left out of every count: the profiler drops a window's first
kernel or two), and end with ``PAD_S`` after the last kernel: the profiler
keeps only the kernels whose device times fall inside its window, and on
the card some windows' device times read milliseconds early against the
host's clock. :func:`_window_kernels` ties each host launch to its kernel
record by correlation id, so a window that lost a kernel is seen.

The module imports torch inside its functions only, so that a script that
imports it at its top still starts a spawned loader worker without torch.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import sys
import time

LEAD_IN = "spin_kernel"  # the kernel ``torch.cuda._sleep`` launches
#: spin kernels that open each profiled window
LEAD_INS = 4
#: host seconds before the lead-in and after the window's last kernel
PAD_S = 0.05
#: windows profiled before a short one is given up on
TRIES = 5
#: the autograd engine's ranges: every op under one is the backward's
BACKWARD_RANGE = "autograd::engine::evaluate_function"
#: the trace's categories of host-side kernel launches
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# Spans (:func:`span`): a root span a call or step, carrying its number, the
# others nested under it.
#: ``predict.predict_assembled``: the whole call (args: call, videos, padded)
SERVE_CALL = "serve.call"
#: ``predict.stack_inputs``: concatenating the staged rows
SERVE_STACK = "serve.stack"
#: ``predict.forward_batch``: host arrays to the device
SERVE_UPLOAD = "serve.upload"
#: ``predict.forward_batch``: logits and maps to host arrays (waits on the card)
SERVE_FETCH = "serve.fetch"
#: ``predict.predict_assembled``: ``aggregate_attentions_batch``, one pass over
#: the call's videos (arg: videos)
SERVE_AGGREGATE = "serve.aggregate"
#: ``CastModel._in_compute_dtype``: ``MODEL + child`` is a child's call
#: (``model.extractor``, ``model.head``, ``model.blocks``); every op under a
#: ``model.*`` span is the forward's (:func:`op_stats`' ``fwd``)
MODEL = "model."
#: ``CastModel.__call__``: the model's whole call, its glue between children included
MODEL_FORWARD = "model.forward"
#: ``CastModel._in_compute_dtype``: the parameters cast to the compute dtype
MODEL_CAST = "model.cast"
#: ``train.make_train_step``: the whole step (arg: step)
STEP = "step"
#: the step's ``forward_loss``
STEP_FORWARD = "step.forward"
#: the step's ``loss.backward()``
STEP_BACKWARD = "step.backward"
#: the step's zero_grad, zero gradients, learning rate and ``opt.step()``
STEP_OPTIMIZER = "step.optimizer"
#: ``models/xception.py``: the backbone's flows, entry (``conv1`` to block 3),
#: middle (blocks 4-11) and exit (block 12 to ``bn4``)
XCEPTION_ENTRY = "xception.entry"
XCEPTION_MIDDLE = "xception.middle"
XCEPTION_EXIT = "xception.exit"

# Counters (:func:`count`).
#: rows (faces) the extractor ran, padded slots included
FACES_RUN = "faces_run"
#: slots of the batches' masks that hold a face (counted from host masks only)
FACES_VALID = "faces_valid"
#: device microseconds of the extractor's calls timed under a profile
#: (:func:`device_timer`), and how many calls those are
EXTRACTOR_DEVICE_US = "extractor_device_us"
EXTRACTOR_TIMED = "extractor_timed"

_counts: collections.Counter = collections.Counter()
_OFF = contextlib.nullcontext()
#: :func:`device_timer`'s event pairs not yet resolved: (start, end, counter, calls)
_pending: list = []


def _lead_in() -> None:
    """Open a profiled window with short spin kernels, finished before the
    measured work starts. :func:`_window_kernels` leaves them out."""
    import torch

    for _ in range(LEAD_INS):
        torch.cuda._sleep(5000)
    torch.cuda.synchronize()


def _profiled(fn):
    """One ``fn()`` under ``torch.profiler``, padded with host time and opened
    by the lead-in; returns the profile and the host ms of ``fn()`` and its
    synchronisation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        _lead_in()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PAD_S)
    return prof, wall_ms


def _window_kernels(prof) -> tuple[list, int, float]:
    """The device records of a profile (kernels, copies, sets), the lead-in
    left out, as ``(name, start ns, end ns)`` in start order; how many
    kernels the window launched that it holds no record of (each launch on
    the host has a correlation id that its kernel's record carries); and the
    most ms by which a kernel's recorded start precedes its launch (at or
    under 0 where the device's and the host's clocks agree). Read from the
    profiler's raw records: no event tree is built, so a window of ~10^5
    kernels takes seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    launch_ns = {e.correlation_id(): e.start_ns() for e in raw
                 if e.device_type() == torch.autograd.DeviceType.CPU and "LaunchKernel" in e.name()}
    # a record_function range (a span, :func:`span`) has a device span too,
    # from its first kernel to its last: no kernel, left out
    device = [e for e in raw if e.device_type() == cuda and LEAD_IN not in e.name()
              and not e.is_user_annotation()]
    kernels = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in device), key=lambda k: k[1:])
    start_ns = {e.correlation_id(): e.start_ns() for e in device}
    lost = len(launch_ns.keys() - start_ns.keys()) - LEAD_INS
    early = [launch_ns[c] - t for c, t in start_ns.items() if c in launch_ns]
    return kernels, lost, max(early, default=0) / 1e6


def device_ms(fn, iters: int = 20, warmup: int = 3, launches: int | None = None) -> float:
    """Device time of one call: the summed durations of the CUDA kernels that
    ``iters`` calls launch, under ``torch.profiler``, over ``iters``. The
    host's time between launches is left out, so a call whose kernels finish
    quicker than Python issues them reads its kernels' time, not the host's.
    The window must hold a record of every kernel it launched, and
    ``launches`` kernels a call where that is given, else a whole number a
    call; a window that does not is profiled again."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(TRIES):
        prof, _ = _profiled(lambda: [fn() for _ in range(iters)])
        kernels, lost, early_ms = _window_kernels(prof)
        counts.append((len(kernels), lost, round(early_ms, 3)))
        whole = (len(kernels) == launches * iters if launches is not None
                 else len(kernels) % iters == 0)
        if kernels and whole and not lost:
            return sum(b - a for _, a, b in kernels) / 1e6 / iters
    raise RuntimeError(f"torch.profiler recorded (kernels, lost, device clock early ms) {counts}"
                       f" in {TRIES} windows of {iters} calls"
                       f"{'' if launches is None else f' of {launches} launches'}")


def _kind(name: str) -> str:
    """Coarse layer of a CUDA kernel, from its name."""
    low = name.lower()
    if ("token_rows_bwd" in low or "token_rows_cls_reduce" in low
            or ("attn_bwd" in low and "<false>" in low)):  # the latter above 16 frames
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
    if "memcpy" in low:
        return "memory copies"
    if "softmax" in low or "reduce" in low or "norm" in low:
        return "reduction / norm"
    return "elementwise"


def _profile(fn, launches: int | None = None, calls: int = 1) -> dict:
    """Device busy and idle share of the host window of one ``fn()`` under
    ``torch.profiler``, device time by layer and the top kernels. A window
    must hold kernels, a record of every kernel it launched, each name a
    multiple of ``calls`` times (``fn`` makes that many calls) and
    ``launches`` in all where that is given; one that does not is profiled
    again, up to ``TRIES`` times, and then raises where ``launches`` is
    given, else reports the kernels it lost."""
    import torch

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(TRIES):
        prof, wall_ms = _profiled(fn)
        kernels, lost, early_ms = _window_kernels(prof)
        counts.append((len(kernels), lost, round(early_ms, 3)))
        names = collections.Counter(name for name, _, _ in kernels)
        if (kernels and not lost and all(n % calls == 0 for n in names.values())
                and (launches is None or len(kernels) == launches)):
            break
    else:
        if launches is not None:
            raise RuntimeError(f"torch.profiler recorded (kernels, lost, device clock early ms)"
                               f" {counts} in {TRIES} windows, not {launches} kernels")
    busy, end = 0, float("-inf")
    for _, a, b in kernels:  # union of the kernels' intervals, in start order
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kind, by_name = {}, {}
    for name, a, b in kernels:
        ms = (b - a) / 1e6
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + ms)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"host_window_ms": wall_ms, "kernels": len(kernels), "kernels_lost": lost,
            "device_clock_early_ms": early_ms,
            "device_busy_ms": busy / 1e6 if kernels else "not measured",
            "device_idle_share": 1 - busy / 1e6 / wall_ms if kernels else "not measured",
            "ms_by_layer": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": k[:90], "launches": n, "ms": t} for k, (n, t) in top]}


@contextlib.contextmanager
def trace(log_dir: str = "outputs/trace", cuda: bool | None = None):
    """``torch.profiler`` over the block, written into ``log_dir`` as a
    Chrome trace when the block ends; yields the profile. ``cuda`` (default:
    whether a card is present) adds the card's activity and pads the window
    as the module's docstring says; the block's last kernels are waited for
    before the window closes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        if cuda:
            time.sleep(PAD_S)
            _lead_in()
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(PAD_S)


def _profiling() -> bool:
    """Whether a ``torch.profiler`` profile is active: one check of the
    profiler's flag (torch is not even imported where none can be)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def span(name: str, **args):
    """A context manager over one of the program's spans: while a
    ``torch.profiler`` profile is active, ``record_function(name)`` with
    ``args`` as its argument string, so that the span lies among the
    profile's host records on their clock and its exporter writes it;
    otherwise a shared no-op, after :func:`_profiling`'s one check."""
    if not _profiling():
        return _OFF
    import torch

    return torch.profiler.record_function(
        name, " ".join(f"{k}={v}" for k, v in args.items()) or None)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counters() -> dict[str, int]:
    """A copy of the counters as they stand (since the process started)."""
    return dict(_counts)


@contextlib.contextmanager
def _timed(counter: str, calls: str):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    _pending.append((start, end, counter, calls))


def device_timer(counter: str, calls: str, device):
    """A context manager that, while a profile is active and ``device`` is a
    card, records a CUDA event pair on the current stream around its body;
    :func:`resolve_timers` (here first, and after a served call's fetch)
    adds the stream's microseconds between them to ``counter`` and one to
    ``calls`` once the device has passed both, so no synchronise is added.
    Otherwise the shared no-op."""
    if getattr(device, "type", None) != "cuda" or not _profiling():
        return _OFF
    resolve_timers()
    return _timed(counter, calls)


def resolve_timers() -> None:
    """Count every :func:`device_timer` pair whose end the device has passed
    (``Event.query``, which does not wait); the others stay pending."""
    if not _pending:
        return
    left = []
    for start, end, counter, calls in _pending:
        if end.query():
            count(counter, round(1e3 * start.elapsed_time(end)))
            count(calls, 1)
        else:
            left.append((start, end, counter, calls))
    _pending[:] = left


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def sync(x):
    """Wait for the card when a tensor of ``x`` (a tensor or nested dicts,
    lists and tuples of them) lies on it; returns ``x``."""
    import torch

    for leaf in _leaves(x):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    return x


def _trace_events(source) -> list[dict]:
    """The Chrome trace events of a profile, or of the newest
    ``*.pt.trace.json`` under a directory (a reused directory holds one file
    a capture)."""
    if isinstance(source, (str, os.PathLike)):
        files = glob.glob(os.path.join(os.fspath(source), "*.pt.trace.json"))
        if not files:
            raise FileNotFoundError(f"no *.pt.trace.json under {source}")
        path = max(files, key=os.path.getmtime)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        source.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _host_ops(events: list[dict]) -> list[dict]:
    """The host's complete events (ops, user ranges, runtime calls), each
    with its self time and the sections its enclosing ranges put it in:
    ``bwd`` under the autograd engine, ``fwd`` under a ``model.*`` span
    (:data:`MODEL`)."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation", *LAUNCH_CATS):
            by_tid[e.get("tid")].append(dict(e, self_us=float(e.get("dur", 0.0))))
    out = []
    for ops in by_tid.values():
        ops.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: list[dict] = []
        for e in ops:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0.0) <= e["ts"]:
                stack.pop()
            if stack:
                stack[-1]["self_us"] -= float(e.get("dur", 0.0))
            e["parent"] = stack[-1]["name"] if stack else None
            e["bwd"] = (e["name"].startswith(BACKWARD_RANGE)
                        or any(s["bwd"] for s in stack[-1:]))
            e["fwd"] = e["name"].startswith(MODEL) or any(s["fwd"] for s in stack[-1:])
            stack.append(e)
            out.append(e)
    return out


def _section(name: str, host) -> str:
    if "_bwd" in name or (host is not None and host["bwd"]):
        return "bwd"
    if host is not None and host["fwd"]:
        return "fwd"
    return "other"


def op_stats(source, top: int = 20) -> list[dict]:
    """Per-op time of a :func:`trace` directory (its newest trace) or of a
    ``torch.profiler`` profile: the ``top`` rows by total self time, as dicts
    with the JAX function's keys ``name``, ``type``, ``self_ms``, plus
    ``launches`` and ``section`` (``fwd``, ``bwd`` or ``other``, as
    :func:`_print_op_table` sums them). Rows are the card's kernels by name
    (the lead-in left out; ``type`` their layer, :func:`_kind`) when the
    trace holds any, else the host's ops by self time (``type`` ``"cpu
    op"``). A directory without a trace raises ``FileNotFoundError``."""
    events = _trace_events(source)
    host = _host_ops(events)
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
               and LEAD_IN not in e.get("name", "")]
    rows: dict[tuple, dict] = {}

    def add(name, kind, us, section):
        r = rows.setdefault((name, section), {
            "name": name, "type": kind, "self_ms": 0.0, "launches": 0, "section": section})
        r["self_ms"] += us / 1e3
        r["launches"] += 1

    if kernels:
        launch = {e.get("args", {}).get("correlation"): e for e in host
                  if e.get("cat") in LAUNCH_CATS}
        for k in kernels:
            src = launch.get(k.get("args", {}).get("correlation"))
            add(k["name"], _kind(k["name"]), float(k.get("dur", 0.0)), _section(k["name"], src))
    else:
        for e in host:
            if e.get("cat") == "cpu_op":
                add(e["name"], "cpu op", max(e["self_us"], 0.0), _section(e["name"], e))
    out = sorted(rows.values(), key=lambda r: -r["self_ms"])
    return out[:top]


def kernels_lost(source) -> dict[str, int]:
    """Kernels a :func:`trace` window launched (each host launch carries a
    correlation id that its kernel's record repeats) of which it holds no
    record, by the host op that launched them: empty for a whole trace. The
    window's first ``LEAD_INS`` launches, the lead-in's, are left out."""
    events = _trace_events(source)
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") == "kernel"}
    launches = sorted((e for e in _host_ops(events)
                       if e.get("cat") in LAUNCH_CATS and "LaunchKernel" in e["name"]),
                      key=lambda e: e["ts"])[LEAD_INS:]
    return dict(collections.Counter(str(e["parent"]) for e in launches
                                    if e.get("args", {}).get("correlation") not in recorded))


def _example_inputs(cfg, batch: int):
    """Fixed-shape random inputs at the config's shapes (the JAX function's
    arrays, from the same numpy generator)."""
    import numpy as np

    F, n = cfg.num_frames, cfg.num_patches
    rng = np.random.default_rng(0)
    frames = rng.standard_normal(
        (batch, F, cfg.image_size, cfg.image_size, 3)
    ).astype(np.float32)
    mask = np.ones((batch, F), bool)
    id_mask = np.ones((batch, F, F), bool)
    size_emb = rng.integers(1, 21, size=(batch, F)).astype(np.int32)
    # (B, 1 + F·n): 0 = CLS, then each frame's n patch tokens share the
    # frame's temporal rank
    positions = np.concatenate(
        [[0], np.repeat(np.arange(1, F + 1), n)]
    ).astype(np.int32)
    positions = np.tile(positions, (batch, 1))
    return frames, mask, id_mask, size_emb, positions


def _counters() -> dict:
    """The model-path kernel wrappers' launch counters as they stand."""
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.ops import token_rows as tr

    return {"divided_attention": da.launches, "geglu_ffn": ffn.launches,
            "token_rows_attention": tr.launches, "divided_attention_bwd": da.bwd_launches,
            "geglu_ffn_bwd": ffn.bwd_launches, "token_rows_attention_bwd": tr.bwd_launches}


def main(argv=None, config=None) -> dict:
    """``python -m mintime_torch.utils.profiling``: trace ``--iters`` calls
    of a model's forward (or, with ``--grad``, forward and backward; with
    ``--train``, the real train step of :func:`mintime_torch.train.
    make_train_step`) and print videos/s and the per-op table. On the card
    the table holds the kernels by device time; on the CPU the host's ops by
    self time. ``config`` stands in for the ``--config`` file, for a caller
    without yaml. Returns what it printed: ``videos_per_s``, ``trace_dir``,
    ``rows`` (every row of :func:`op_stats`), ``launches`` (the kernel
    wrappers' launches during the traced calls), ``kernels_lost``
    (:func:`kernels_lost`, by host op: where it is not empty, the table's
    totals are lower bounds), ``iters``, ``batch``, ``what``."""
    import argparse

    p = argparse.ArgumentParser("mintime-torch profiler")
    p.add_argument("--config", default="configs/size_invariant_timesformer.yaml")
    p.add_argument("--model", type=int, default=1,
                   help="0 baseline | 1 timesformer | 2 slowfast | 3 conv")
    p.add_argument("--extractor_model", type=int, default=0)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--trace_dir", default="outputs/mintime-trace")
    p.add_argument("--fused_attention", type=int, choices=(0, 1), default=None,
                   help="the CUDA kernels (use_kernels): on by default on the card, off on "
                        "the CPU (where the kernel path runs their plain versions)")
    p.add_argument("--grad", action="store_true", default=False,
                   help="profile forward+backward (grad of the sum of squared logits through "
                        "the kernels' autograd Functions) instead of the forward alone; the "
                        "per-parameter reductions show up as harness rows ('other'); prefer "
                        "--train for step-true accounting")
    p.add_argument("--train", action="store_true", default=False,
                   help="profile the real train step (train.make_train_step: forward, "
                        "backward through the kernels, BatchNorm statistics, SGD update), "
                        "models 0/1 only")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = p.parse_args(argv)
    if opt.train and opt.model not in (0, 1):
        p.error("--train supports models 0 (baseline) / 1 (timesformer)")

    import dataclasses

    import numpy as np
    import torch

    from mintime_torch.config import MintimeConfig, load_config
    from mintime_torch.device import resolve_device

    dev = resolve_device(opt.device)
    cfg = (config if config is not None else load_config(opt.config)).model
    fused = dev.type == "cuda" if opt.fused_attention is None else bool(opt.fused_attention)
    param_dtype = torch.float32 if opt.train else None

    if opt.model == 2:
        from mintime_torch.models.slowfast import SlowFastClassifier

        model = SlowFastClassifier(num_classes=cfg.num_classes, device=dev)
        keys = ("frames",)
    elif opt.model == 3:
        from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer

        model = ConvolutionalTimeSformer(cfg, use_kernels=fused, device=dev)
        keys = ("frames", "mask", "size_embedding")
    else:
        from mintime_torch.models.classifier import MintimeVideoClassifier

        cfg = dataclasses.replace(cfg, channels=1280)
        model = MintimeVideoClassifier(
            cfg, backbone="efficientnet-b0" if opt.extractor_model == 0 else "xception",
            head="baseline" if opt.model == 0 else "timesformer",
            use_kernels=fused and opt.model == 1, device=dev, param_dtype=param_dtype)
        keys = ("frames", "mask", "identities_mask", "size_embedding", "positions")
    names = ("frames", "mask", "identities_mask", "size_embedding", "positions")
    batch = dict(zip(names, _example_inputs(cfg, opt.batch)))

    if opt.train:
        from mintime_torch.train import create_train_state, make_train_step

        batch["labels"] = np.random.default_rng(1).integers(
            0, 2, size=(opt.batch,)).astype(np.float32)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        state = create_train_state(model, MintimeConfig(model=cfg))
        train_step = make_train_step(model, pos_weight=0.8)

        def call():
            return train_step(state, batch)
        what = "train step"
    else:
        args = tuple(torch.as_tensor(batch[k]).to(dev) for k in keys)
        if opt.grad:
            params = [q for q in model.parameters() if q.requires_grad]

            def call():
                out = model(*args)
                loss = torch.sum(out.float() ** 2)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                return [g.float().sum() for g in grads if g is not None]
        else:
            def call():
                with torch.no_grad():
                    return model(*args)
        what = "fwd+bwd" if opt.grad else "forward"

    sync(call())  # warm up (cuDNN's and cuBLAS's first use) outside the trace
    before = _counters()
    with trace(opt.trace_dir, cuda=dev.type == "cuda"):
        t0 = time.perf_counter()
        for _ in range(opt.iters):
            out = call()
        sync(out)
        dt = time.perf_counter() - t0  # the calls, not the trace's padding and export
    after = _counters()
    videos_per_s = opt.batch * opt.iters / dt
    print(f"{opt.iters} x batch {opt.batch} {what}: {videos_per_s:.1f} videos/s "
          f"(trace: {opt.trace_dir})")
    rows = _print_op_table(opt.trace_dir, opt)
    lost = kernels_lost(opt.trace_dir)
    if lost:
        print(f"(the trace holds no record of launched kernels, by host op: {lost}; the "
              "totals above are lower bounds)")
    return {"videos_per_s": videos_per_s, "trace_dir": opt.trace_dir, "rows": rows,
            "launches": {k: after[k] - before[k] for k in after}, "iters": opt.iters,
            "batch": opt.batch, "what": what, "kernels_lost": lost}


def _print_op_table(trace_dir: str, opt) -> list[dict]:
    """Top-N per-op rows plus two aggregates: by graph section (``fwd``,
    ``bwd``, ``other``) and by section:op-type. A kernel launched from the
    autograd engine's backward, or named ``*_bwd*``, is ``bwd``; the
    forward's are ``fwd``; the optimizer and the harness reductions land in
    ``other``. Returns every row."""
    rows = op_stats(trace_dir, top=10 ** 6)
    for r in rows[:opt.top]:
        print(f"{r['self_ms'] / opt.iters:8.3f} ms/call  {r['launches'] // opt.iters:5d}x  "
              f"{str(r['type'])[:36]:36} {r['section']:5} {r['name'][:70]}")

    for key, label in ((lambda r: r["section"], "graph section"),
                       (lambda r: f"{r['section']}:{r['type']}", "section:op-type")):
        agg, calls = {}, {}
        for r in rows:
            k = key(r)
            agg[k] = agg.get(k, 0.0) + r["self_ms"]
            calls[k] = calls.get(k, 0) + 1
        total = sum(agg.values())
        print(f"\n-- total self-time by {label} (of {total / opt.iters:.1f} ms/call) --")
        for k, ms in sorted(agg.items(), key=lambda kv: -kv[1])[:16]:
            print(f"{ms / opt.iters:8.3f} ms/call  {calls[k]:4d} ops  {k}")
    return rows


if __name__ == "__main__":
    main()
