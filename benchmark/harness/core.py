"""One run of one cell: ``python benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

The cell's driver (``drivers/<traffic's driver>.py``) builds the system from
the seed, warms every shape it uses, runs whole calls or steps for
``--seconds`` and checks what the timed path produced against the plain
reference; with ``--trace 1`` it also profiles a short window. Its end-to-end
metrics, or with ``--trace 1`` the per-layer metrics that each
``metrics/<name>.py`` reads, go into one JSON line, the last on standard
output; the numbers compared, each beside its limit, are the last lines on
standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from dataclasses import dataclass, field

from harness import files

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "mintime_tpu")
#: nor may the reference import the program
NOT_IN_REFERENCE = FORBIDDEN + ("mintime_torch",)


@dataclass
class Run:
    """What a driver is given."""

    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    #: ``{"system": "control"}`` puts the reference in float8 in the
    #: program's place; ``{"fault": name}`` plants a fault (``faults.py``).
    #: The benchmark's own runs set neither.
    variant: dict = field(default_factory=dict)

    def sub_seed(self, what: str) -> int:
        import numpy as np

        tag = {"weights": 1, "inputs": 2, "train": 3}[what]
        return int(np.random.SeedSequence([self.seed % 2**64, tag]).generate_state(1)[0])


@dataclass
class Record:
    """What a driver returns."""

    e2e: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    notes: dict = field(default_factory=dict)
    window_start: float = 0.0  # perf_counter at the first timed call
    memory_peak_bytes: int = 0
    #: per-layer readings: the untraced rate, model FLOPs an item, the
    #: traced window (``trace.profile``), its calls or steps, the kernel
    #: calls and their work, the window's memory peak
    items_per_s: float | None = None
    flops_per_item: float | None = None
    traced: dict | None = None
    traced_calls: int = 0
    kernel_calls: list = field(default_factory=list)
    window_peak_bytes: int | None = None
    device_kind: str = ""


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reference_imports() -> list[str]:
    """Top-level modules that the reference's sources import and may not."""
    bad = set()
    d = os.path.join(files.BENCH, "reference")
    for f in sorted(os.listdir(d)):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                bad |= {n.split(".")[0] for n in names} & set(NOT_IN_REFERENCE)
    return sorted(bad)


def run_cell(run: Run) -> Record:
    driver = files.module("drivers", run.cell["traffic_file"]["driver"])
    return driver.run(run)


def result(bench: dict, run: Run, rec: Record, t0: float) -> dict:
    """The contract's last line."""
    import torch

    name = run.cell["name"]
    metrics = {}
    if not run.trace:
        values = dict(rec.e2e, setup_s=rec.window_start - t0)
        for m in files.cell_metrics(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        moves = {m["name"] for m in files.cell_metrics(bench, name, "end_to_end")}
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name] if m["moves"] in moves else []):
                continue
            value = files.module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = torch.device(run.device).type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": run.cell["chips"], "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": all(v <= lim for v, lim in rec.checks.values()) and bool(rec.checks),
           "attempted": rec.attempted, "failed": rec.failed, "metrics": metrics,
           "device": device}
    if run.trace and rec.traced:
        from harness import trace

        device["busy_s"] = trace.busy_s(rec.traced["kernels"])
        device["window_s"] = rec.traced["window_s"]
        out["breakdown"] = trace.breakdown(rec.traced["kernels"], rec.traced["host"])
    out["notes"] = rec.notes
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in rec.checks.items()}
    return out


def main(argv: list[str], t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    bench = files.benchmark()
    cell = files.cell(bench, a.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"benchmark: {a.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    run = Run(cell, a.seed, a.seconds, bool(a.trace))
    rec = run_cell(run)
    out = result(bench, run, rec, t0)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the run loaded {bad}, which no run may load", file=sys.stderr)
        return 4
    bad = reference_imports()
    if bad:
        print(f"benchmark: the reference imports {bad}", file=sys.stderr)
        return 4
    for k, (v, lim) in rec.checks.items():
        print(f"check {k} {float(v)!r} limit {float(lim)!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
