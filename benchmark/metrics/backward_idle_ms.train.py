"""Device-idle ms a traced train step inside the host interval of the span step.backward."""

from harness import spans


def read(rec):
    return spans.idle_ms(rec, spans.STEP_BACKWARD)
