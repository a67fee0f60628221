"""Model FLOPs of a training step a video (flops/<family>.py) times the untraced window's videos/s, over the bf16 dense peak."""

from harness import readers


def read(rec):
    return readers.mfu_pct(rec)
