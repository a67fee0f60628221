"""The benchmark of the PyTorch and CUDA port (``mintime_torch``): one run of
one cell of ``BENCHMARK.json``.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell asks
for. The last line on standard output is the run's JSON result.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel caches at fixed paths inside the checkout; the port's own CUDA
# builds live in mintime_torch/.build/
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

from harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T0))
