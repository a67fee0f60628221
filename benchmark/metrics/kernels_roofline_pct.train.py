"""The hand-written kernels' least time for their calls' operations and bytes over their device time, in the traced train steps."""

from harness import readers


def read(rec):
    return readers.roofline_pct(rec)
