"""Where the benchmark finds its parts by name: ``BENCHMARK.json`` at the
checkout's root, and under ``benchmark/`` one file a configuration
(``configs/``, named in ``BENCHMARK.json``), traffic mix (``traffic/<name>.json``),
cell's limits (``limits/<workload>.json``), driver (``drivers/<name>.py``),
input maker (``inputs/<name>.py``), model family (``families/<name>.py``),
per-layer metric (``metrics/<metric>.py``) and hand-written kernel
(``kernels/<name>.py``). Adding a cell, a metric or a kernel adds files; no
file here names one."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"bench_{kind}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def modules(kind: str) -> dict:
    """Every ``benchmark/<kind>/*.py`` by name."""
    d = os.path.join(BENCH, kind)
    names = sorted(f[:-3] for f in os.listdir(d) if f.endswith(".py") and not f.startswith("_"))
    return {n: module(kind, n) for n in names}


def cell(bench: dict, workload: str) -> dict:
    """The workload's entry with its configuration and traffic files read in."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = dict(cells[workload])
    configs = {c["name"]: c for c in bench["configs"]}
    w["config_file"] = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    w["traffic_file"] = load_json(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    w["limits"] = load_json(os.path.join(BENCH, "limits", f"{workload}.json"))
    return w


def cell_metrics(bench: dict, workload: str, key: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that this cell reports."""
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]
