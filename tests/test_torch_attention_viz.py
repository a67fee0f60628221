"""The port's attention aggregation (``mintime_torch/utils/attention_viz.py``)
on the CPU: ``aggregate_attentions_batch`` over a whole batch equals the JAX
package's ``aggregate_attentions`` called per video, bit for bit (float32
frame means, float64 softmaxes, the reference's identity frame ranges); the
one-video ``aggregate_attentions`` still maxes over every row it is given;
and ``predict.predict_assembled`` hands each video the aggregation of its
own rows, in order, with the pad rows dropped.
"""

import numpy as np
import pytest

from mintime_torch import predict
from mintime_torch.config import MintimeConfig, ModelConfig
from mintime_torch.utils.attention_viz import aggregate_attentions, aggregate_attentions_batch
from mintime_tpu.utils.attention_viz import aggregate_attentions as reference_aggregate

HEADS = 8


def _maps(rng, rows: int, tokens: int) -> np.ndarray:
    """CLS attention rows ``(rows, 1, tokens)`` as a softmax leaves them:
    float32, each row summing to 1, so values near ``1 / tokens``."""
    e = np.exp(rng.normal(scale=0.5, size=(rows, 1, tokens)))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _frames_per_identity(rng, identities: int, num_frames: int) -> list[int]:
    """Cumulative frame counts of ``identities`` identities of uneven,
    random lengths, the last ending at ``num_frames``."""
    cuts = sorted(rng.choice(np.arange(1, num_frames), identities - 1, replace=False))
    return [int(c) for c in cuts] + [num_frames]


@pytest.mark.parametrize("identities", [1, 2, 3])
@pytest.mark.parametrize("frames, patches", [(16, 49), (8, 49), (8, 1)])
@pytest.mark.parametrize("videos", [1, 7, 96])
def test_batch_equals_reference_per_video(videos, frames, patches, identities):
    rng = np.random.default_rng([videos, frames, patches, identities])
    tokens = 1 + frames * patches  # group 0 holds the extra CLS token
    attns = [_maps(rng, videos * HEADS, tokens) for _ in range(2)]
    fpis = [_frames_per_identity(rng, identities, frames) for _ in range(videos)]
    agg, shares = aggregate_attentions_batch(attns, HEADS, frames, fpis)
    assert agg.shape == (videos, 3, frames) and agg.dtype == np.float64
    assert len(shares) == videos
    for b in range(videos):
        rows = [a[b * HEADS:(b + 1) * HEADS] for a in attns]
        want, want_shares = reference_aggregate(rows, HEADS, frames, fpis[b])
        one, one_shares = aggregate_attentions(rows, HEADS, frames, fpis[b])
        for got in (list(agg[b]), one):
            assert len(got) == 3
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert shares[b] == want_shares == one_shares
        assert all(type(s) is float for s in shares[b])


def test_one_video_maxes_over_every_row_given():
    """Given more rows than ``heads`` (a whole batch's, as the evaluation's
    plots and the benchmark's tests pass them), the one-video aggregation
    maxes over all of them, as the reference does."""
    rng = np.random.default_rng(5)
    frames, tokens = 8, 1 + 8 * 49
    attns = [_maps(rng, 3 * HEADS, tokens) for _ in range(2)]
    for a in attns:  # a peak outside the first ``heads`` rows
        a[2 * HEADS + 1, 0, 3 * 49 + 7] = 0.5
    want, want_shares = reference_aggregate(attns, HEADS, frames, [3, 8])
    got, shares = aggregate_attentions(attns, HEADS, frames, [3, 8])
    assert all(np.array_equal(g, w) for g, w in zip(got, want)) and shares == want_shares
    first, _ = aggregate_attentions([a[:HEADS] for a in attns], HEADS, frames, [3, 8])
    assert not np.array_equal(first[2], got[2])


SMALL = ModelConfig(image_size=32, num_frames=8, num_patches=1, channels=1280, dim=32, depth=1,
                    heads=2, dim_head=16, max_identities=3)
CFG = MintimeConfig(model=SMALL)


def _staged(faces_per_video) -> list:
    """Videos as ``assemble_inputs`` stages them, each with identities of
    the given numbers of faces."""
    rng = np.random.default_rng(0)
    out = []
    for faces in faces_per_video:
        video = {k: [(30 * s, k, rng.integers(0, 256, (40, 40, 3), dtype=np.uint8),
                      [10.0, 10.0, 23.0, 23.0]) for s in range(n)]
                 for k, n in enumerate(faces)}
        out.append(predict.assemble_inputs(video, (640, 360), CFG, "cpu"))
    return out


def test_predict_assembled_gives_each_video_its_own_rows(monkeypatch):
    staged, pad_to, heads = _staged([(3,), (2, 4), (1, 2, 3)]), 5, SMALL.heads
    tokens = 1 + SMALL.num_frames * SMALL.num_patches
    rng = np.random.default_rng(7)
    logits = rng.normal(size=pad_to).astype(np.float32)
    maps = [_maps(rng, pad_to * heads, tokens) for _ in range(2)]
    seen = []

    def forward(model, state, batch):
        seen.append(len(batch["frames"]))
        return logits, maps

    monkeypatch.setattr(predict, "forward_batch", forward)
    results = predict.predict_assembled(staged, None, None, CFG, pad_to=pad_to)
    assert seen == [pad_to] and len(results) == len(staged)
    for b, (result, (_, plan, crop_store)) in enumerate(zip(results, staged)):
        assert result.plan is plan
        fpi = [int(t / SMALL.num_patches) for _, t in plan.tokens_per_identity]
        want, want_shares = aggregate_attentions([m[b * heads:(b + 1) * heads] for m in maps],
                                                 heads, SMALL.num_frames, fpi)
        assert result.frames_per_identity == fpi
        assert len(result.aggregated_attentions) == 3
        assert all(a.shape == (SMALL.num_frames,) and a.dtype == np.float64
                   for a in result.aggregated_attentions)
        assert all(np.array_equal(g, w) for g, w in zip(result.aggregated_attentions, want))
        assert result.identity_attentions == want_shares
        assert all(type(s) is float for s in result.identity_attentions)
        assert result.probability == float(1.0 / (1.0 + np.exp(-float(logits[b]))))
        assert result.identities == {k: crop_store[k] for k in plan.identity_keys}
