"""Host ms a traced scoring call from its start (the span serve.call) to the fetch of its answers (serve.fetch): stacking, uploads, casts and the forward's launches."""

from harness import spans


def read(rec):
    return spans.issue_ms(rec)
