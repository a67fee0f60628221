"""Host ms a traced scoring call in the span model.cast: the fp32 master weights cast to bf16."""

from harness import spans


def read(rec):
    return spans.span_ms(rec, spans.MODEL_CAST)
