"""Share of the rows the extractor ran over the training run that held a face (the counters faces_valid over faces_run)."""

from harness import spans


def read(rec):
    return spans.faces_valid_pct(rec)
