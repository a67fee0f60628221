"""The port's MTCNN cascade (``mintime_torch/preprocessing/mtcnn.py``) against
the JAX package's, fp32 on the CPU, on one set of facenet-pytorch-layout
weights (the score layers widened x75 as ``tests/test_mtcnn_oracle.py``
widens them, so no threshold decision sits near a cut).

Tolerances: the nets 1e-5; boxes and scores 2e-2 with the same box count
(``test_mtcnn_oracle.py``'s); crops 1e-2; the host helpers and the converter
bitwise; the options that permute or repeat pixels (BGR, stage 1 of
``input_scale`` on 2 x 2-block frames, an odd frame against its even floor)
bitwise; device crops on constant frames 1e-4.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from mintime_torch.convert import mtcnn_state_dicts  # noqa: E402
from mintime_torch.preprocessing import mtcnn as port  # noqa: E402
from mintime_tpu.preprocessing import mtcnn as jaxm  # noqa: E402
from test_mtcnn_oracle import THRESHOLDS, _corner_frames, _videos  # noqa: E402


@pytest.fixture(scope="module")
def weights():
    """Port nets from seed 11 (the oracle test's seed and layer order), the
    score layers x75; their state_dicts and the JAX variables from them."""
    torch.manual_seed(11)
    nets = {"pnet": port.PNet().eval(), "rnet": port.RNet().eval(), "onet": port.ONet().eval()}
    with torch.no_grad():
        for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
            getattr(nets[net], layer).weight.mul_(75.0)
            getattr(nets[net], layer).bias.mul_(75.0)
    sds = {k: {n: t.clone() for n, t in v.state_dict().items()} for k, v in nets.items()}
    variables = jaxm.mtcnn_params_from_torch(sds["pnet"], sds["rnet"], sds["onet"])
    return nets, sds, variables


def _pair(weights, **kw):
    _, sds, variables = weights
    return (port.MTCNNDetector(sds, device="cpu", **kw), jaxm.MTCNNDetector(variables, **kw))


def _assert_boxes_close(got, want, what):
    assert len(got) == len(want), f"{what}: {len(got)} frames vs {len(want)}"
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{what} frame {t}: {g.shape} vs {w.shape}"
        if len(w):
            np.testing.assert_allclose(g, w, atol=2e-2, rtol=0, err_msg=f"{what} frame {t}")


def _assert_boxes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ the nets
@pytest.mark.parametrize("name,shape", [("pnet", (2, 3, 31, 45)), ("rnet", (5, 3, 24, 24)),
                                        ("onet", (5, 3, 48, 48))])
def test_nets_match_jax(weights, name, shape):
    nets, _, variables = weights
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    with torch.no_grad():
        got = nets[name](torch.from_numpy(x))
    cls = {"pnet": jaxm.PNet, "rnet": jaxm.RNet, "onet": jaxm.ONet}[name]
    want = cls().apply(variables[name], jnp.asarray(x.transpose(0, 2, 3, 1)))
    for g, w in zip(got, want):
        g = g.numpy()
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)


def test_state_dicts_round_trip_bitwise(weights):
    _, sds, variables = weights
    back = mtcnn_state_dicts(variables)
    assert back.keys() == sds.keys()
    for net in sds:
        assert back[net].keys() == sds[net].keys(), net
        for k in sds[net]:
            assert torch.equal(back[net][k], sds[net][k]), f"{net}.{k}"


# ------------------------------------------------------------- host helpers
def test_host_helpers_equal_the_jax_copies_bitwise():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(-20, 120, (40, 5)).astype(np.float32)
    boxes[:, 2:4] += 30
    reg = rng.normal(size=(40, 4)).astype(np.float32)
    for fn in ("rerec",):
        np.testing.assert_array_equal(getattr(port, fn)(boxes), getattr(jaxm, fn)(boxes))
    for fn in ("apply_regression", "apply_regression_stage1"):
        np.testing.assert_array_equal(getattr(port, fn)(boxes, reg), getattr(jaxm, fn)(boxes, reg))
    for si, so in ((50, 24), (7, 48), (1920, 960), (101, 13)):
        np.testing.assert_array_equal(port._area_matrix(si, so), jaxm._area_matrix(si, so))
        assert port._pnet_grid(si, so) == jaxm._pnet_grid(si, so)
    img = rng.integers(0, 255, (80, 100, 3)).astype(np.float32)
    np.testing.assert_array_equal(port._area_resize_hw(img, 24), jaxm._area_resize_hw(img, 24))
    frame = rng.integers(0, 255, (161, 201, 3)).astype(np.uint8)
    for scale in (1, 2):
        for size in (24, 48):
            got = port._crop_resize(frame, boxes, size, scale)
            want = jaxm._crop_resize(frame, boxes, size, scale)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("h,w", [(120, 160), (1080, 1920), (121, 77), (23, 500)])
def test_pyramid_scales_and_grids(h, w):
    """The scale list and level sizes, accumulated as the JAX detector does."""
    for minsize in (20, 40, 121):
        scales = port._pyramid_scales(h, w, minsize, 0.709)
        m, minl, want, s = 12.0 / minsize, min(h, w) * 12.0 / minsize, [], 12.0 / minsize
        while minl >= 12:
            want.append(s)
            s *= 0.709
            minl *= 0.709
        assert scales == want
        assert all(port._pnet_grid(int(h * s + 1), int(w * s + 1))[0] >= 1 for s in scales)


def test_device_crops_match_host_crops_on_edge_boxes():
    """Device crops (two products a candidate) against the host crop, with
    clipped, sliver and fully outside boxes, at scale 1 and 2: 1e-2."""
    rng = np.random.default_rng(9)
    for scale in (1, 2):
        img = rng.integers(0, 255, (80 * scale, 100 * scale, 3)).astype(np.uint8)
        boxes = np.array([[10.6, 12.2, 40.9, 44.1, 0.9], [-15.3, -9.7, 30.0, 35.0, 0.9],
                          [70.2, 50.5, 130.0, 95.0, 0.9], [-20.0, 60.0, 25.0, 120.0, 0.9],
                          [5.7, 8.1, 6.9, 9.9, 0.9], [120.0, 20.0, 150.0, 50.0, 0.9]], np.float32)
        for size in (24, 48):
            want, valid = port._crop_resize(img, boxes, size, scale)
            coords, v = port._valid_box_coords(boxes, 100, 80)
            np.testing.assert_array_equal(v, valid)
            assert valid.tolist() == [True] * 5 + [False]
            got = port._device_crops(torch.from_numpy(img), torch.from_numpy(coords), size,
                                     scale, bgr=False).numpy().transpose(0, 2, 3, 1)
            np.testing.assert_allclose(got[valid], want[valid], atol=1e-2, rtol=0)
            assert not got[~valid].any(), "an invalid box crops to zeros"


# ----------------------------------------------------- the cascade against JAX
@pytest.mark.parametrize("device_crops", [False, True])
def test_detector_matches_jax_on_videos(weights, device_crops):
    ours, theirs = _pair(weights, thresholds=THRESHOLDS, pnet_topk=2048, device_crops=device_crops)
    total = 0
    for v, frames in enumerate(_videos()):
        want = theirs.detect_batch(frames)
        _assert_boxes_close(ours.detect_batch(frames), want, f"video {v}")
        total += sum(len(b) for b in want)
    assert total >= 6, "the inputs must produce detections"


def test_border_clipped_boxes_match_jax(weights):
    th = (0.4, 0.35, 0.35)
    ours, theirs = _pair(weights, thresholds=th, pnet_topk=4096)
    frames = _corner_frames(seed=1)
    want = theirs.detect_batch(frames)
    _assert_boxes_close(ours.detect_batch(frames), want, "corners")
    h, w = frames[0].shape[:2]
    b = np.concatenate(want)
    assert ((b[:, 0] < 1) | (b[:, 1] < 1) | (b[:, 2] > w) | (b[:, 3] > h)).any(), \
        "a final box must overhang the frame"


@pytest.mark.parametrize("minsize", [20, 60, 100, 120, 121])
def test_minsize_pyramid_boundary_matches_jax(weights, minsize):
    low = (0.3, 0.3, 0.3)
    ours, theirs = _pair(weights, thresholds=low, min_face_size=minsize, pnet_topk=4096)
    for v, frames in enumerate(_videos(seed=7, n_frames=2)):
        got = ours.detect_batch(frames)
        _assert_boxes_close(got, theirs.detect_batch(frames), f"minsize {minsize} video {v}")
        if minsize > 120:
            assert all(len(b) == 0 for b in got)


def test_overlap_nms_stress_matches_jax(weights):
    low = (0.35, 0.35, 0.35)
    ours, theirs = _pair(weights, thresholds=low, pnet_topk=8192)
    frames = _videos(seed=5, n_frames=2)[1]
    want = theirs.detect_batch(frames)
    _assert_boxes_close(ours.detect_batch(frames), want, "stress")
    assert sum(len(b) for b in want) >= 8


def test_truncation_warnings_match_jax(weights):
    """A small ``pnet_topk`` and fetch budget clip above-threshold cells:
    both detectors warn, and still agree on what they kept."""
    kw = dict(thresholds=(0.35, 0.35, 0.35), pnet_topk=16, pnet_fetch_k=24, pnet_head_k=8)
    ours, theirs = _pair(weights, **kw)
    frames = _videos(seed=5, n_frames=2)[1]
    with pytest.warns(UserWarning) as caught_jax:
        want = theirs.detect_batch(frames)
    with pytest.warns(UserWarning) as caught:
        got = ours.detect_batch(frames)
    assert sorted(str(w.message) for w in caught) == sorted(str(w.message) for w in caught_jax)
    assert any("pnet_fetch_k" in str(w.message) for w in caught)
    _assert_boxes_close(got, want, "truncated")


# ------------------------------------------------------------- the options
def test_head_tail_split_is_exact(weights):
    """The head size only decides what is copied when: boxes are the same."""
    _, sds, _ = weights
    frames = _videos(seed=4, n_frames=2)[0]
    for th in ((0.35, 0.35, 0.35), (0.9, 0.35, 0.35)):
        want = port.MTCNNDetector(sds, thresholds=th, device="cpu").detect_batch(frames)
        for head_k in (0, 1, 10**9):
            got = port.MTCNNDetector(sds, thresholds=th, pnet_head_k=head_k,
                                     device="cpu").detect_batch(frames)
            _assert_boxes_equal(got, want)


def test_bgr_frames_give_the_rgb_boxes(weights):
    _, sds, _ = weights
    frames = _videos(seed=2, n_frames=2)[2]
    bgr = [np.ascontiguousarray(f[..., ::-1]) for f in frames]
    for device_crops in (False, True):
        kw = dict(thresholds=(0.4, 0.4, 0.4), device_crops=device_crops, device="cpu")
        want = port.MTCNNDetector(sds, **kw).detect_batch(frames)
        got = port.MTCNNDetector(sds, channel_order="bgr", **kw).detect_batch(bgr)
        assert sum(len(b) for b in want) > 0
        _assert_boxes_equal(got, want)


def test_device_crops_on_constant_frames():
    """Every area window of a constant frame averages to the constant, so
    both crop paths give the same crops up to rounding and the same boxes
    within 1e-4 (default-init nets: every score near 0.5, above the 0.4
    cuts, so every candidate goes through)."""
    sds = port.MTCNNDetector.init_state_dicts(0)
    frames = [np.full((60, 80, 3), 137, np.uint8) for _ in range(2)]
    kw = dict(thresholds=(0.4, 0.4, 0.4), device="cpu")
    want = port.MTCNNDetector(sds, **kw).detect_batch(frames)
    assert sum(len(b) for b in want) > 0
    got = port.MTCNNDetector(sds, device_crops=True, **kw).detect_batch(frames)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def _stage1(det, frames):
    scales, (head_copy, tail), _ = det._dispatch_stage1(frames)
    return scales, det._head(head_copy), tail.numpy()


@pytest.mark.parametrize("device_crops", [False, True])
def test_input_scale_two_shrinks_on_the_device(weights, device_crops):
    """``input_scale=2`` on 2 x 2-block frames: stage 1 equals the half-size
    frames' (what a host ``cv2.resize`` to half gives on such frames)
    bitwise, and the whole cascade, whose R/O-Net crops come from the full
    frames, matches the JAX detector's ``input_scale=2`` within 2e-2."""
    half = _videos(seed=8, n_frames=2)[2]
    full = [np.repeat(np.repeat(f, 2, 0), 2, 1) for f in half]
    host = [cv2.resize(f, (f.shape[1] // 2, f.shape[0] // 2)) for f in full]
    _assert_boxes_equal(host, half)
    kw = dict(thresholds=(0.4, 0.4, 0.4), device_crops=device_crops)
    a = _stage1(port.MTCNNDetector(weights[1], device="cpu", **kw), host)
    b = _stage1(port.MTCNNDetector(weights[1], device="cpu", input_scale=2, **kw), full)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    ours, theirs = _pair(weights, input_scale=2, **kw)
    want = theirs.detect_batch(full)
    assert sum(len(w) for w in want) > 0
    _assert_boxes_close(ours.detect_batch(full), want, "input_scale=2")


@pytest.mark.parametrize("device_crops", [False, True])
def test_odd_frames_are_floored_to_even(weights, device_crops):
    """An odd-sized frame with ``input_scale=2`` detects exactly what its
    even floor (last row and column dropped) detects, and on 2 x 2-block
    content that equals the host path (cv2 half-size resize of the even
    floor, ``input_scale=1``) in stage 1. The JAX detector's area shrink of
    the odd frame averages three-pixel windows instead (its
    ``_area_matrix(h, h // 2)``), so its boxes differ there."""
    _, sds, _ = weights
    rng = np.random.default_rng(12)
    blocks = np.repeat(np.repeat(_videos(seed=8, n_frames=1)[2][0], 2, 0), 2, 1)
    odd = np.concatenate([blocks, rng.integers(0, 255, (1, 320, 3), dtype=np.uint8)], 0)
    odd = np.concatenate([odd, rng.integers(0, 255, (241, 1, 3), dtype=np.uint8)], 1)
    assert odd.shape == (241, 321, 3)
    kw = dict(thresholds=(0.4, 0.4, 0.4), device_crops=device_crops, device="cpu")
    det = port.MTCNNDetector(sds, input_scale=2, **kw)
    got = det.detect_batch([odd, odd[::-1, ::-1].copy()])
    want = det.detect_batch([blocks, odd[::-1, ::-1][:240, :320].copy()])
    assert sum(len(b) for b in want) > 0
    _assert_boxes_equal(got, want)
    host = [cv2.resize(blocks, (160, 120))]
    a = _stage1(port.MTCNNDetector(sds, **kw), host)
    b = _stage1(det, [odd])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


# ---------------------------------------------------------- the public surface
def test_detect_batch_equals_per_frame_detect(weights):
    _, sds, _ = weights
    det = port.MTCNNDetector(sds, thresholds=THRESHOLDS, pnet_topk=2048, device="cpu")
    frames = _videos()[2]
    batched = det.detect_batch(frames)
    assert sum(len(b) for b in batched) > 0
    for t, frame in enumerate(frames):
        single = det.detect(frame)
        assert single.shape == batched[t].shape
        np.testing.assert_allclose(single, batched[t], atol=1e-5, rtol=0)


def test_detect_videos_equals_detect_batch(weights):
    """One video of lookahead, and the staged frames, change nothing."""
    _, sds, _ = weights
    det = port.MTCNNDetector(sds, thresholds=(0.4, 0.4, 0.4), device_crops=True, device="cpu")
    videos = _videos(seed=6, n_frames=3)
    got = det.detect_videos(videos)
    assert len(got) == len(videos)
    for fs, g in zip(videos, got):
        _assert_boxes_equal(g, det.detect_batch(fs))
        _assert_boxes_equal(det.detect_batch(fs, staged=det.stage_frames(fs)), g)
    assert sum(len(b) for g in got for b in g) > 0
    assert det.detect_videos([[]]) == [[]]
    tiny = det.detect_batch([np.zeros((10, 10, 3), np.uint8)])
    assert len(tiny) == 1 and tiny[0].shape == (0, 5)


@pytest.mark.parametrize("kw,match", [({"input_scale": 0}, "input_scale"),
                                      ({"channel_order": "BGR"}, "channel_order"),
                                      ({"channel_order": ""}, "channel_order")])
def test_constructor_validates(weights, kw, match):
    with pytest.raises(ValueError, match=match):
        port.MTCNNDetector(weights[1], device="cpu", **kw)


def test_init_state_dicts_load_and_are_seeded():
    a, b = port.MTCNNDetector.init_state_dicts(3), port.MTCNNDetector.init_state_dicts(3)
    for net in port.NETS:
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net])
    det = port.MTCNNDetector(a, device="cpu")
    assert {p.device.type for n in det.nets.values() for p in n.parameters()} == {"cpu"}
