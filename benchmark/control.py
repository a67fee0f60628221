"""The readings that a cell's limits are set from: the program's own over
many seeds, the control's (the plain reference computed in float8 in the
program's place) and each planted fault's, at the cell's own size, all in one
process on the card:

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --variants program,control,half_batch --seconds 2

One JSON line a run: the variant, the seed, ``correct`` under the present
limits, and every number the comparison read."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from harness import core, files  # noqa: E402

VARIANTS = {"program": {}, "control": {"system": "control"}, "unchanged": {"fault": "unchanged"},
            "half_batch": {"fault": "half_batch"}, "altered": {"fault": "altered"}}


def readings(cell: dict, seed: int, variant: str, seconds: float, device: str = "cuda") -> dict:
    run = core.Run(cell, seed, seconds, False, device, VARIANTS[variant])
    t = time.perf_counter()
    rec = core.run_cell(run)
    numbers = {k: v for k, (v, _) in rec.checks.items()}
    numbers.update({k: v for k, v in rec.notes.items() if isinstance(v, float)})
    return {"variant": variant, "seed": seed,
            "correct": all(v <= lim for v, lim in rec.checks.values()),
            "numbers": numbers, "seconds": time.perf_counter() - t}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program,control")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args()
    cell = files.cell(files.benchmark(), a.workload)
    for variant in a.variants.split(","):
        for seed in (int(s) for s in a.seeds.split(",")):
            print(json.dumps(readings(cell, seed, variant, a.seconds)), flush=True)
            gc.collect()
            import torch

            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
