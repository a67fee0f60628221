"""Host ms a traced scoring call in the span serve.aggregate: every video's attention aggregation."""

from harness import spans


def read(rec):
    return spans.span_ms(rec, spans.SERVE_AGGREGATE)
