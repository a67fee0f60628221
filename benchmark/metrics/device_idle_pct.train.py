"""Share of the traced train steps' host window in which no kernel, copy or set ran."""

from harness import readers


def read(rec):
    return readers.idle_pct(rec)
