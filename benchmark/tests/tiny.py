"""Cells of BENCHMARK.json cut to sizes a CPU test holds: every width the
program's plain paths take, the shapes and the control flow of the run."""

from __future__ import annotations

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import files  # noqa: E402

TINY_MODEL = {
    "mintime_classifier": {"image-size": 64, "num-patches": 4, "num-frames": 8, "dim": 64,
                           "depth": 1, "heads": 2, "dim-head": 32},
    "conv_timesformer": {"image-size": 64, "num-frames": 8, "dim": 64, "depth": 1, "heads": 2,
                         "dim-head": 32, "efficient-net-block": 3, "num-patches": 40,
                         "channels": 40},
}
TINY_TRAFFIC = {"pool_videos": 8, "batch": 2, "face_side_px": [16, 48], "face_seconds": [2, 5],
                "side_jitter_px": 2}


def cell(workload: str, widths: bool = False) -> dict:
    """``widths``: keep the configuration's own model, cut the traffic only."""
    c = copy.deepcopy(files.cell(files.benchmark(), workload))
    cfg, traffic = c["config_file"], c["traffic_file"]
    if not widths:
        cfg["model"].update(TINY_MODEL[cfg["family"]])
    for k, v in TINY_TRAFFIC.items():
        if k in traffic:
            traffic[k] = v
    return c
