"""Host ms a traced scoring call in the span serve.fetch: logits and maps to host arrays, the host waiting on the card."""

from harness import spans


def read(rec):
    return spans.span_ms(rec, spans.SERVE_FETCH)
