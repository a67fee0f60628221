"""What several per-layer metrics read from the program's own spans and
counters (``mintime_torch/utils/profiling.py``): the host time a traced call
or step spends in a span, and the device's idle time inside a span's host
interval. The spans are host records of the profiled window
(``trace.profile``'s ``host``: ``(name, start ns, end ns)``, every thread);
the counters are the program's table at the end of the run. A program
without them reads None. The names are the program's, written out here so
that the yardstick does not move with the program."""

from __future__ import annotations

SERVE_CALL, SERVE_FETCH, SERVE_AGGREGATE = "serve.call", "serve.fetch", "serve.aggregate"
MODEL_CAST = "model.cast"
STEP_FORWARD, STEP_BACKWARD, STEP_OPTIMIZER = "step.forward", "step.backward", "step.optimizer"
FACES_RUN, FACES_VALID = "faces_run", "faces_valid"


def union(intervals) -> list[tuple[int, int]]:
    """Intervals ``(start, end)`` merged where they overlap, in order."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a < out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def span_intervals(host, name: str) -> list[tuple[int, int]]:
    return union((a, b) for n, a, b in host if n == name)


def _overlap(a: int, b: int, merged) -> int:
    return sum(max(0, min(b, y) - max(a, x)) for x, y in merged)


def idle_ns(kernels, spans) -> int:
    """Nanoseconds inside ``spans`` (merged host intervals) in which no
    device record (``(name, start ns, end ns)``) runs."""
    busy = union((a, b) for _, a, b in kernels)
    return sum((b - a) - _overlap(a, b, busy) for a, b in spans)


def _spans(rec, name: str) -> tuple[list[tuple[int, int]], int]:
    """The span's merged host intervals in the traced window, and the
    window's calls or steps."""
    if not rec.traced or not rec.traced_calls:
        return [], 0
    return span_intervals(rec.traced["host"], name), rec.traced_calls


def span_ms(rec, name: str) -> float | None:
    """Host ms a traced call or step in the span ``name``."""
    spans, n = _spans(rec, name)
    return sum(b - a for a, b in spans) / 1e6 / n if spans else None


def idle_ms(rec, name: str) -> float | None:
    """Device-idle ms a traced step inside the span ``name``'s host
    intervals."""
    spans, n = _spans(rec, name)
    if not spans or not rec.traced["kernels"]:
        return None
    return idle_ns(rec.traced["kernels"], spans) / 1e6 / n


def issue_ms(rec) -> float | None:
    """Host ms a traced call from the start of ``serve.call`` to the start of
    the first ``serve.fetch`` inside it."""
    calls, n = _spans(rec, SERVE_CALL)
    fetches = sorted(a for nm, a, _ in rec.traced["host"] if nm == SERVE_FETCH) if calls else []
    starts = [next((f for f in fetches if a <= f <= b), None) for a, b in calls]
    if not calls or None in starts:
        return None
    return sum(f - a for f, (a, _) in zip(starts, calls)) / 1e6 / n


def counters() -> dict | None:
    """The program's counters, or None where it keeps none."""
    try:
        from mintime_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if read is not None else None


def faces_valid_pct(rec) -> float | None:
    """Share of the extractor's rows over the run that held a face."""
    c = counters()
    if not c or not c.get(FACES_RUN):
        return None
    return 100.0 * c.get(FACES_VALID, 0) / c[FACES_RUN]
