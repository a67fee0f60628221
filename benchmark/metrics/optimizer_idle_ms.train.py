"""Device-idle ms a traced train step inside the host intervals of the span step.optimizer."""

from harness import spans


def read(rec):
    return spans.idle_ms(rec, spans.STEP_OPTIMIZER)
