"""On the card: ``run.py`` end to end, a short window of each cell, its last
line read as the driver reads it. Skips without a card (decided in the test)."""

import json
import os
import subprocess
import sys

import pytest

from harness import files

CELLS = [w["name"] for w in files.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_run_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                        "4294967311", "--seconds", "2", "--trace", str(trace)],
                       cwd=files.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"] and len(out["breakdown"]["idle_gaps"]) <= 10
        for k, v in out["metrics"].items():
            if "roofline" in k or "mfu" in k:
                assert 0 < v["value"] <= 100, (k, v)


def test_no_card_no_result(tmp_path):
    """Without the card the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, os.path.join(files.BENCH, "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=files.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
