"""Whole runs of each cell at tiny sizes on the CPU, the look for a card
skipped: the contract's last line, a sound program read as correct, and
each fault that the cell can have, planted under the timed path, read as not
correct."""

import json

import pytest

import tiny
from harness import core, files

BENCH = files.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [w["name"] for w in BENCH["workloads"] if files.cell(BENCH, w["name"])
         ["traffic_file"]["driver"] == "train"]
SCORE = [w for w in CELLS if w not in TRAIN]


def _run(workload, variant=None, widths=False):
    cell = tiny.cell(workload, widths)
    if widths:
        cell["traffic_file"].update(pool_videos=2, batch=2)
    run = core.Run(cell, 2**31 + 12345, 0.3, False, "cpu", variant or {})
    return run, core.run_cell(run)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_and_its_last_line(workload):
    run, rec = _run(workload)
    line = json.dumps(core.result(BENCH, run, rec, rec.window_start - 1.0))
    out = json.loads(line)
    assert out["correct"] is True, out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in files.cell_metrics(BENCH, workload, "end_to_end")}
    assert set(out["metrics"]) == want
    assert out["metrics"]["setup_s"]["value"] == pytest.approx(1.0)
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert core.forbidden_loaded() == []


@pytest.mark.parametrize("workload,fault", [(w, f) for w in TRAIN
                                            for f in ("unchanged", "half_batch")]
                         + [(w, "altered") for w in SCORE])
def test_fault_reads_not_correct(workload, fault):
    _, rec = _run(workload, {"fault": fault})
    assert not all(v <= lim for v, lim in rec.checks.values()), rec.checks


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_not_correct(workload):
    """The reference in float8 in the program's place, under the cell's
    limits (``benchmark/control.py`` reads it on the card at the cell's size).
    Scoring's control needs the configuration's depth and widths to fail
    (two videos of them); the training cells' fails at the tiny sizes."""
    _, rec = _run(workload, {"system": "control"}, widths=workload in SCORE)
    assert not all(v <= lim for v, lim in rec.checks.values()), rec.checks
