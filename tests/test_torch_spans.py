"""The port's spans and counters (``mintime_torch/utils/profiling.py``) on the
CPU, on a tiny MINTIME-EF (32 px, depth 1, dim 32) that keeps fp32
parameters and computes in bf16, so each forward casts: under
``torch.profiler`` a served call and a train step lay down their spans,
nested and in order; with no profile active a span calls nothing in torch;
the face counters count the extractor's rows and the masks' faces; and
``op_stats`` sorts the kernels under a ``model.*`` span into ``fwd``.
"""

import numpy as np
import pytest
import torch

from mintime_torch import predict, train
from mintime_torch.config import MintimeConfig, ModelConfig
from mintime_torch.models.classifier import MintimeVideoClassifier
from mintime_torch.utils import profiling

SMALL = ModelConfig(image_size=32, num_frames=8, num_patches=1, channels=1280, dim=32, depth=1,
                    heads=2, dim_head=16, max_identities=2)
CFG = MintimeConfig(model=SMALL)
SERVE = [profiling.SERVE_STACK, profiling.SERVE_UPLOAD, profiling.MODEL_FORWARD,
         profiling.MODEL_CAST, profiling.MODEL + "extractor", profiling.MODEL + "head", profiling.SERVE_FETCH,
         profiling.SERVE_AGGREGATE]
STEP = [profiling.STEP_FORWARD, profiling.STEP_BACKWARD, profiling.STEP_OPTIMIZER]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(**kw):
    return MintimeVideoClassifier(SMALL, device="cpu", dtype=torch.bfloat16,
                                  param_dtype=torch.float32, **kw)


def _staged(n: int) -> list:
    """``n`` videos as ``assemble_inputs`` stages them: two identities of
    two and three faces, so three of the eight slots are padding."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        video = {k: [(30 * s, k, rng.integers(0, 256, (40, 40, 3), dtype=np.uint8),
                      [10.0, 10.0, 23.0, 23.0]) for s in range(faces)]
                 for k, faces in enumerate((2, 3))}
        out.append(predict.assemble_inputs(video, (640, 360), CFG, "cpu"))
    return out


def _train_batch(staged):
    batch = predict.stack_inputs(staged)
    batch["labels"] = np.arange(len(staged)) % 2
    return batch


def _spans(prof) -> list:
    """The profile's spans of the program, as ``(name, start, end)`` in start
    order."""
    ours = (*SERVE, profiling.SERVE_CALL, profiling.STEP, *STEP)
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name in ours), key=lambda s: s[1])


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def _inside(spans, root):
    return [s for s in spans if root[1] <= s[1] and s[2] <= root[2] and s is not root]


def test_served_call_nests_its_spans_in_order():
    model, staged = _model(require_attention=True), _staged(2)
    spans = _profiled(lambda: [predict.predict_assembled(staged, model, None, CFG)
                               for _ in range(2)])
    calls = [s for s in spans if s[0] == profiling.SERVE_CALL]
    assert len(calls) == 2
    for call in calls:
        inner = _inside(spans, call)
        first = {}
        for name, _, _ in inner:
            first.setdefault(name, len(first))
        assert sorted(first, key=first.get) == SERVE
        # the extractor's and the head's casts
        assert [n for n, _, _ in inner].count(profiling.MODEL_CAST) == 2
    assert calls[0][2] <= calls[1][1]


def test_aggregate_span_once_a_call_with_its_videos(monkeypatch):
    """One ``serve.aggregate`` a served call, its arg the number of videos
    the one pass aggregated (pad rows not counted)."""
    model, staged = _model(require_attention=True), _staged(3)
    record, args = torch.profiler.record_function, []

    def recording(name, arg=None):
        args.append((name, arg))
        return record(name, arg)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    spans = _profiled(lambda: [predict.predict_assembled(staged[:n], model, None, CFG, pad_to=4)
                               for n in (3, 1)])
    calls = [s for s in spans if s[0] == profiling.SERVE_CALL]
    assert len(calls) == 2
    for call in calls:
        assert [s[0] for s in _inside(spans, call)].count(profiling.SERVE_AGGREGATE) == 1
    assert [a for n, a in args if n == profiling.SERVE_AGGREGATE] == ["videos=3", "videos=1"]


def test_train_step_nests_forward_backward_optimizer():
    model = train.training_model(SMALL, device="cpu")
    state = train.create_train_state(model, CFG)
    step = train.make_train_step(model)
    batch = _train_batch(_staged(2))
    spans = _profiled(lambda: step(state, batch))
    roots = [s for s in spans if s[0] == profiling.STEP]
    assert len(roots) == 1
    inner = [n for n, _, _ in _inside(spans, roots[0]) if n in STEP]
    assert inner == [profiling.STEP_FORWARD, profiling.STEP_OPTIMIZER, profiling.STEP_BACKWARD,
                     profiling.STEP_OPTIMIZER]


def _serve():
    model, staged = _model(require_attention=True), _staged(2)
    return lambda: predict.predict_assembled(staged, model, None, CFG)


def _step():
    model = train.training_model(SMALL, device="cpu")
    state = train.create_train_state(model, CFG)
    step, batch = train.make_train_step(model), _train_batch(_staged(2))
    return lambda: step(state, batch)


@pytest.mark.parametrize("make", [_serve, _step], ids=["serve", "train_step"])
def test_spans_off_call_nothing_in_torch(monkeypatch, make):
    fn = make()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profile active")

    # torch's own ranges (the optimizer's) take ``torch.autograd.profiler``'s
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    fn()


@pytest.mark.parametrize("make", [_serve, _step], ids=["serve", "train_step"])
def test_face_counters_count_rows_and_mask(make):
    fn = make()
    staged = _staged(2)
    rows = sum(s[0]["frames"].shape[0] * s[0]["frames"].shape[1] for s in staged)
    faces = sum(int(s[0]["mask"].sum()) for s in staged)
    assert 0 < faces < rows
    before = profiling.counters()
    fn()
    after = profiling.counters()
    got = {k: after.get(k, 0) - before.get(k, 0)
           for k in (profiling.FACES_RUN, profiling.FACES_VALID)}
    assert got == {profiling.FACES_RUN: rows, profiling.FACES_VALID: faces}


def test_device_mask_counts_no_valid_faces():
    """A mask already on the device is not read back: only the rows count."""
    model, staged = _model(require_attention=True), _staged(1)
    batch = predict.stack_inputs(staged)
    batch["mask"] = torch.as_tensor(batch["mask"])
    before = profiling.counters()
    predict.forward_batch(model, None, batch)
    after = profiling.counters()
    assert after.get(profiling.FACES_VALID, 0) == before.get(profiling.FACES_VALID, 0)
    assert after[profiling.FACES_RUN] - before.get(profiling.FACES_RUN, 0) == SMALL.num_frames


def test_op_stats_sorts_model_spans_into_fwd(tmp_path):
    """The kernels under the model's own spans are the forward's; an op
    after the call is not."""
    model = _model()
    x, mask, id_mask, size_emb, positions = profiling._example_inputs(SMALL, 1)
    args = [torch.as_tensor(a) for a in (x, mask, id_mask, size_emb, positions)]
    a = torch.randn(16, 16)
    with profiling.trace(str(tmp_path), cuda=False), torch.no_grad():
        model(*args)
        a @ a
    rows = {(r["name"], r["section"]) for r in profiling.op_stats(str(tmp_path), top=10 ** 6)}
    assert any("conv" in n for n, s in rows)
    assert not any("conv" in n and s != "fwd" for n, s in rows)
    assert ("aten::mm", "other") in rows


XC_SMALL = ModelConfig(image_size=32, num_frames=8, num_patches=1, channels=2048, dim=32, depth=1,
                       heads=2, dim_head=16, max_identities=2)
XC_FLOWS = [profiling.XCEPTION_ENTRY, profiling.XCEPTION_MIDDLE, profiling.XCEPTION_EXIT]


def _xc_serve():
    model = MintimeVideoClassifier(XC_SMALL, backbone="xception", require_attention=True,
                                   device="cpu", dtype=torch.bfloat16, param_dtype=torch.float32)
    staged = _staged(2)
    return lambda: predict.predict_assembled(staged, model, None, MintimeConfig(model=XC_SMALL))


def test_xception_flows_once_each_a_forward_in_order():
    serve = _xc_serve()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        serve()
        serve()
    names = (profiling.MODEL + "extractor", *XC_FLOWS)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name in names), key=lambda s: s[1])
    calls = [s for s in spans if s[0] == profiling.MODEL + "extractor"]
    assert len(calls) == 2
    for call in calls:
        assert [n for n, _, _ in _inside(spans, call)] == XC_FLOWS
    assert len(spans) == 2 * (1 + len(XC_FLOWS))


def test_xception_flows_off_call_nothing_in_torch(monkeypatch):
    serve = _xc_serve()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profile active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    serve()


@pytest.mark.parametrize("profiled", [False, True], ids=["off_profile", "cpu_profile"])
def test_extractor_device_counters_stay_off_the_cpu(profiled):
    """The extractor's device timers run only under a profile on the card:
    off a profile, and under one on the CPU, the counters do not move and
    nothing is left pending."""
    serve = _xc_serve()
    keys = (profiling.EXTRACTOR_DEVICE_US, profiling.EXTRACTOR_TIMED)
    before = {k: profiling.counters().get(k, 0) for k in keys}
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            serve()
    else:
        serve()
    assert {k: profiling.counters().get(k, 0) for k in keys} == before
    assert profiling._pending == []
