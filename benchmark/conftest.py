"""The tiny sizes of ``benchmark/tests``' CPU runs for the families that
declare their own (``TINY_MODEL``), added to ``tests/tiny.py``'s table
before any test runs."""

import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for p in (BENCH, os.path.dirname(BENCH), os.path.join(BENCH, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import tiny  # noqa: E402
from harness import files  # noqa: E402

for name, fam in files.modules("families").items():
    if hasattr(fam, "TINY_MODEL"):
        tiny.TINY_MODEL.setdefault(name, fam.TINY_MODEL)
