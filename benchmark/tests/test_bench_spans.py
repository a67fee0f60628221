"""The readers of the program's spans and counters (``harness/spans.py``) on
hand-made host spans and device records with known answers, and on a
program that keeps none."""

import pytest

from harness import files, spans
from harness.core import Record

MS = 1_000_000  # ns


def _rec(host, kernels, calls=2):
    return Record(traced={"host": host, "kernels": kernels, "window_s": 0.1}, traced_calls=calls)


def test_union_merges_overlaps():
    assert spans.union([(5, 8), (0, 2), (1, 3), (7, 9), (9, 10)]) == [(0, 3), (5, 9), (9, 10)]


def test_idle_inside_spans():
    """Two steps of 40 ms: the device runs 5-15 and 22-30 ms of the first
    (two overlapping records), 45-70 of the second. Forward 0-20 / 40-60,
    backward 20-30 / 60-75, optimizer 30-40 / 75-80."""
    kernels = [("a", 5 * MS, 12 * MS), ("b", 10 * MS, 15 * MS), ("c", 22 * MS, 30 * MS),
               ("d", 45 * MS, 70 * MS)]
    host = [("step", 0, 40 * MS), ("step", 40 * MS, 80 * MS),
            ("step.forward", 0, 20 * MS), ("step.forward", 40 * MS, 60 * MS),
            ("aten::mm", 1 * MS, 2 * MS),
            ("step.backward", 20 * MS, 30 * MS), ("step.backward", 60 * MS, 75 * MS),
            ("step.optimizer", 30 * MS, 40 * MS), ("step.optimizer", 75 * MS, 80 * MS)]
    rec = _rec(host, kernels)
    # forward: 0-5, 15-20 idle of the first; 40-45 of the second
    assert spans.idle_ms(rec, spans.STEP_FORWARD) == pytest.approx((5 + 5 + 5) / 2)
    # backward: 20-22 of the first; 70-75 of the second
    assert spans.idle_ms(rec, spans.STEP_BACKWARD) == pytest.approx((2 + 5) / 2)
    # optimizer: all of 30-40 and 75-80
    assert spans.idle_ms(rec, spans.STEP_OPTIMIZER) == pytest.approx((10 + 5) / 2)
    # the three cover the window's idle time: 80 ms less 43 busy, a step
    total = sum(spans.idle_ms(rec, s) for s in (spans.STEP_FORWARD, spans.STEP_BACKWARD,
                                                 spans.STEP_OPTIMIZER))
    assert total == pytest.approx((80 - 43) / 2)
    assert spans.span_ms(rec, spans.STEP_OPTIMIZER) == pytest.approx(7.5)


def test_serving_spans():
    host = [("serve.call", 0, 100 * MS), ("serve.stack", 1 * MS, 3 * MS),
            ("model.cast", 4 * MS, 6 * MS), ("model.cast", 10 * MS, 11 * MS),
            ("serve.fetch", 30 * MS, 70 * MS), ("serve.aggregate", 71 * MS, 99 * MS),
            ("serve.call", 100 * MS, 180 * MS), ("model.cast", 104 * MS, 107 * MS),
            ("serve.fetch", 120 * MS, 150 * MS), ("serve.aggregate", 151 * MS, 179 * MS)]
    rec = _rec(host, [("k", 20 * MS, 60 * MS)])
    assert spans.issue_ms(rec) == pytest.approx((30 + 20) / 2)
    assert spans.span_ms(rec, spans.MODEL_CAST) == pytest.approx((2 + 1 + 3) / 2)
    assert spans.span_ms(rec, spans.SERVE_FETCH) == pytest.approx((40 + 30) / 2)
    assert spans.span_ms(rec, spans.SERVE_AGGREGATE) == pytest.approx((28 + 28) / 2)


def test_a_program_without_spans_reads_none():
    """An older program's window holds no span of these names; every reader
    says None and none raises."""
    rec = _rec([("aten::mm", 0, MS)], [("k", 0, MS)])
    for name in ("issue_ms.score", "cast_ms.score", "fetch_ms.score", "aggregate_ms.score",
                 "forward_idle_ms.train", "backward_idle_ms.train", "optimizer_idle_ms.train"):
        assert files.module("metrics", name).read(rec) is None
    assert files.module("metrics", "issue_ms.score").read(Record()) is None


def test_faces_valid_pct(monkeypatch):
    monkeypatch.setattr(spans, "counters", lambda: {"faces_run": 400, "faces_valid": 304})
    assert files.module("metrics", "faces_valid_pct.score").read(Record()) == pytest.approx(76.0)
    monkeypatch.setattr(spans, "counters", lambda: None)
    assert files.module("metrics", "faces_valid_pct.train").read(Record()) is None
