"""Device records (kernels, copies, sets) a scoring call in the traced window."""

from harness import readers


def read(rec):
    return readers.per_call(rec)
