"""The port's pipelined serving path (``predict_videos`` over
``_stage_videos_pipelined``, ``stage_decoded_pipelined``, ``predict_staged``)
and ``detect_video_faces``, with the port's own MTCNN cascade on 40-frame
64 x 48 videos written by cv2, fp32 on the CPU.

The cascade's weights are seed-0 random nets with their score layers x75 (as
``tests/test_torch_predict_detect.py`` builds its own), so no threshold
decision sits near a cut; the JAX side gets the same weights through
``mtcnn_params_from_torch``. The classifier is the SMALL config, random.

Tolerances: against the JAX ``predict_videos``, probabilities within 1e-4
(the JAX package's fp32 logit tolerance) and identities equal; against the
JAX ``detect_video_faces``, boxes within 2e-2. Pipelined against the port's
sequential staging: bit-equal, since the same functions run on the same
frames in another order.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch import predict as port_predict  # noqa: E402
from mintime_torch.config import MintimeConfig, ModelConfig  # noqa: E402
from mintime_torch.convert import load_jax_variables  # noqa: E402
from mintime_torch.models.classifier import MintimeVideoClassifier  # noqa: E402
from mintime_torch.preprocessing import mtcnn as port_mtcnn  # noqa: E402
from mintime_tpu import predict as jax_predict  # noqa: E402
from mintime_tpu.config import MintimeConfig as JaxMintimeConfig  # noqa: E402
from mintime_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier  # noqa: E402
from mintime_tpu.preprocessing import mtcnn as jax_mtcnn  # noqa: E402
from test_torch_efficientnet import random_variables  # noqa: E402
from test_torch_predict import SMALL, FakeDetector, FakeEmbedder  # noqa: E402
from test_torch_predict_detect import mean_colour_embedder  # noqa: E402

THRESHOLDS = (0.4, 0.4, 0.4)
OPTIONS = {"host_resize": {},
           "device_shrink_bgr_device_crops": {"input_scale": 2, "channel_order": "bgr",
                                              "device_crops": True}}
N_VIDEOS = 5


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small torch ops on the CPU: one thread each, so that the parallel
    test run's workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _video(path, seed, n_frames=40):
    """Noise frames with a warm disc of the seed's size and place."""
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(seed)
    centre, radius = (28 + seed % 3 * 4, 22 + seed % 2 * 4), 9 + seed % 3
    for _ in range(n_frames):
        frame = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        cv2.circle(frame, centre, radius, (200, 150, 120), -1)
        writer.write(frame)
    writer.release()
    assert os.path.getsize(path) > 0
    return path


def _state_dicts():
    torch.manual_seed(0)
    nets = {"pnet": port_mtcnn.PNet(), "rnet": port_mtcnn.RNet(), "onet": port_mtcnn.ONet()}
    with torch.no_grad():
        for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
            getattr(nets[net], layer).weight.mul_(75.0)
            getattr(nets[net], layer).bias.mul_(75.0)
    return {k: v.state_dict() for k, v in nets.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    paths = [_video(str(d / f"v{i}.mp4"), i) for i in range(N_VIDEOS)]
    jcfg = JaxModelConfig(**SMALL)
    jmodel = JaxClassifier(jcfg, backbone="efficientnet-b0", head="timesformer",
                           require_attention=True, use_pallas=True)
    F = jcfg.num_frames
    variables = random_variables(
        jmodel, np.zeros((1, F, 32, 32, 3), np.float32), np.ones((1, F), bool),
        np.ones((1, F, F), bool), np.ones((1, F), np.int32), np.arange(1 + F)[None].astype(np.int32),
    )
    tcfg = ModelConfig(**SMALL)
    tmodel = MintimeVideoClassifier(tcfg, require_attention=True, use_kernels=True, device="cpu")
    load_jax_variables(tmodel, variables)
    return paths, (jmodel, variables, JaxMintimeConfig(model=jcfg)), \
        (tmodel, MintimeConfig(model=tcfg)), _state_dicts()


def _detector(sds, options="host_resize"):
    return port_mtcnn.MTCNNDetector(sds, device="cpu", thresholds=THRESHOLDS, **OPTIONS[options])


def _sequential(paths, model, cfg, detector, embedder, batch_size, boxes_per_video=None):
    """The staging the port had before the pipelining: each video's stages
    one after another, a forward a batch, padded as ``predict_videos`` pads."""
    staged = [port_predict._stage_video(p, detector, embedder, cfg, 0.45, 1,
                                        boxes_per_video[i] if boxes_per_video else None, "cpu")
              for i, p in enumerate(paths)]
    pad_to = batch_size if len(paths) > batch_size else 0
    out = []
    for s in range(0, len(staged), batch_size):
        out += port_predict.predict_assembled(staged[s:s + batch_size], model, None, cfg, pad_to)
    return out


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.probability == w.probability
        assert g.identity_attentions == w.identity_attentions
        assert g.frames_per_identity == w.frames_per_identity
        assert list(g.identities) == list(w.identities)
        for key in w.identities:
            assert [(i, j, b) for i, j, _, b in g.identities[key]] == \
                [(i, j, b) for i, j, _, b in w.identities[key]]
        for a, b in zip(g.aggregated_attentions, w.aggregated_attentions):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("options", list(OPTIONS))
def test_predict_videos_matches_jax(setup, options):
    """The port's pipelined ``predict_videos`` with its own cascade against the
    JAX ``predict_videos`` (pipelined too) with the JAX cascade, 3 videos at
    batch 2: a full batch and a padded one."""
    paths, (jmodel, variables, jcfg), (tmodel, tcfg), sds = setup
    jdet = jax_mtcnn.MTCNNDetector(jax_mtcnn.mtcnn_params_from_torch(
        sds["pnet"], sds["rnet"], sds["onet"]), thresholds=THRESHOLDS, **OPTIONS[options])
    want = jax_predict.predict_videos(paths[:3], jmodel, variables, jcfg, jdet,
                                      mean_colour_embedder, batch_size=2)
    got = port_predict.predict_videos(paths[:3], tmodel, None, tcfg, _detector(sds, options),
                                      mean_colour_embedder, batch_size=2)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.probability, w.probability, atol=1e-4)
        assert list(g.identities) == list(w.identities)
        assert len(g.identities) >= 1
        for key in w.identities:
            assert [(i, j) for i, j, _, _ in g.identities[key]] == \
                [(i, j) for i, j, _, _ in w.identities[key]]
        assert g.frames_per_identity == w.frames_per_identity


@pytest.mark.parametrize("n_videos", [1, 2, 3, 5])
def test_pipelined_equals_sequential(setup, n_videos):
    """Batch 2: one video, one full batch, a full and a padded batch, and the
    lookahead across two batch boundaries with a last batch of one."""
    paths, _, (tmodel, tcfg), sds = setup
    det = _detector(sds)
    got = port_predict.predict_videos(paths[:n_videos], tmodel, None, tcfg, det,
                                      mean_colour_embedder, batch_size=2)
    want = _sequential(paths[:n_videos], tmodel, tcfg, det, mean_colour_embedder, 2)
    _assert_bit_equal(got, want)


class RecordingDetector:
    """The port's cascade behind the stage-1 split, logging each call."""

    def __init__(self, detector, log):
        self.detector, self.log = detector, log
        self.channel_order, self.input_scale = detector.channel_order, detector.input_scale

    def _dispatch_stage1(self, frames):
        self.log.append("dispatch")
        return self.detector._dispatch_stage1(frames)

    def _finish_detect(self, frames, pre):
        self.log.append("finish")
        return self.detector._finish_detect(frames, pre)


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_at_most_one_batch_and_one_video_are_staged(setup, monkeypatch, batch_size):
    """Five videos: the JAX order (video i+1 dispatched before video i is
    finished), and at no point more than ``batch_size + 1`` videos dispatched
    but not yet through a forward, nor more than ``batch_size`` assembled."""
    paths, _, (tmodel, tcfg), sds = setup
    log = []

    def embed(crops):
        log.append("embed")
        return mean_colour_embedder(crops)

    real = port_predict.predict_assembled

    def forward(staged, *a, **k):
        log.append(("forward", len(staged)))
        return real(staged, *a, **k)

    monkeypatch.setattr(port_predict, "predict_assembled", forward)
    out = port_predict.predict_videos(paths, tmodel, None, tcfg,
                                      RecordingDetector(_detector(sds), log), embed,
                                      batch_size=batch_size)
    assert len(out) == N_VIDEOS
    assert log[:3] == ["dispatch", "dispatch", "finish"]
    dispatched = embedded = forwarded = most = 0
    for event in log:
        if event == "dispatch":
            dispatched += 1
        elif event == "embed":
            embedded += 1
        elif event != "finish":
            forwarded += event[1]
        assert embedded - forwarded <= batch_size
        most = max(most, dispatched - forwarded)
    assert most == batch_size + 1
    assert dispatched == embedded == forwarded == N_VIDEOS


@pytest.mark.parametrize("video", [0, 3])
def test_detect_video_faces_matches_jax(setup, video):
    paths, *_, sds = setup
    jdet = jax_mtcnn.MTCNNDetector(jax_mtcnn.mtcnn_params_from_torch(
        sds["pnet"], sds["rnet"], sds["onet"]), thresholds=THRESHOLDS)
    want_boxes, want_fps, want_dims = jax_predict.detect_video_faces(paths[video], jdet)
    got_boxes, got_fps, got_dims = port_predict.detect_video_faces(paths[video], _detector(sds))
    assert (got_fps, got_dims) == (want_fps, want_dims) == (10, (64, 48))
    assert list(got_boxes) == list(want_boxes)
    assert sum(len(b or []) for b in got_boxes.values()) > 0
    for key, want in want_boxes.items():
        if want is None:
            assert got_boxes[key] is None
        else:
            np.testing.assert_allclose(got_boxes[key], want, atol=2e-2, rtol=0)


def test_detect_video_faces_raises_without_faces(setup):
    paths, *_ = setup

    class NoFaces:
        def detect(self, frame):
            return np.zeros((0, 5))

    with pytest.raises(ValueError, match="No faces found"):
        port_predict.detect_video_faces(paths[0], NoFaces())


def test_a_detector_without_the_split_stages_sequentially(setup, monkeypatch):
    """An injected detector with only ``detect`` takes :func:`stage_decoded`
    in each video's turn, once a video."""
    paths, _, (tmodel, tcfg), _ = setup
    calls = []
    real = port_predict.stage_decoded

    def recording(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(port_predict, "stage_decoded", recording)
    got = port_predict.predict_videos(paths[:3], tmodel, None, tcfg, FakeDetector(),
                                      FakeEmbedder(), batch_size=2)
    assert len(calls) == 3
    monkeypatch.setattr(port_predict, "stage_decoded", real)
    _assert_bit_equal(got, _sequential(paths[:3], tmodel, tcfg, FakeDetector(), FakeEmbedder(),
                                       2))
    decoded = [port_predict.decode_for_predict(p) for p in paths[:2]]
    staged = list(port_predict.stage_decoded_pipelined(iter(decoded), FakeDetector(),
                                                       FakeEmbedder(), tcfg, device="cpu"))
    for (inputs, plan, _), (half, full, fps) in zip(staged, decoded):
        want, want_plan, _ = port_predict.stage_decoded(half, full, fps, FakeDetector(),
                                                        FakeEmbedder(), tcfg, device="cpu")
        assert plan.identity_keys == want_plan.identity_keys
        for k in want:
            np.testing.assert_array_equal(np.asarray(inputs[k]), np.asarray(want[k]))


def test_precomputed_boxes_take_the_sequential_path(setup):
    """Boxes for videos 1 and 3 of five: those two skip the cascade, the rest
    are dispatched, and every result equals the sequential one."""
    paths, _, (tmodel, tcfg), sds = setup
    det = _detector(sds)
    boxes = [None] * N_VIDEOS
    for i in (1, 3):
        boxes[i] = port_predict.detect_on_frames(port_predict.decode_for_predict(paths[i])[0],
                                                 det)
    log = []
    got = port_predict.predict_videos(paths, tmodel, None, tcfg, RecordingDetector(det, log),
                                      mean_colour_embedder, batch_size=2, boxes_per_video=boxes)
    assert log.count("dispatch") == log.count("finish") == N_VIDEOS - 2
    _assert_bit_equal(got, _sequential(paths, tmodel, tcfg, det, mean_colour_embedder, 2, boxes))


@pytest.mark.parametrize("options", list(OPTIONS))
def test_stage_decoded_pipelined_equals_stage_decoded(setup, options):
    """The decoded-frames generator, as the card's smoke run drives it, gives
    each video's inputs bit for bit as :func:`stage_decoded` does."""
    paths, _, (_, tcfg), sds = setup
    det = _detector(sds, options)
    decoded = [port_predict.decode_for_predict(p, channel_order=det.channel_order,
                                               resize_on_device=det.input_scale > 1)
               for p in paths[:3]]
    staged = list(port_predict.stage_decoded_pipelined(iter(decoded), det, mean_colour_embedder,
                                                       tcfg, device="cpu"))
    assert len(staged) == 3
    for (inputs, plan, store), (half, full, fps) in zip(staged, decoded):
        want, want_plan, want_store = port_predict.stage_decoded(
            half, full, fps, det, mean_colour_embedder, tcfg, device="cpu")
        assert plan.identity_keys == want_plan.identity_keys
        assert {k: [(i, j, b) for i, j, _, b in v] for k, v in store.items()} == \
            {k: [(i, j, b) for i, j, _, b in v] for k, v in want_store.items()}
        for k in want:
            np.testing.assert_array_equal(np.asarray(inputs[k]), np.asarray(want[k]))


def test_the_tail_copy_on_the_host_is_the_tensor():
    """Without an event (a CPU detector) the stage-1 tail is read in place."""
    t = torch.arange(14, dtype=torch.float64).reshape(2, 7)
    np.testing.assert_array_equal(port_mtcnn._copy_after(t, None), t.numpy())
