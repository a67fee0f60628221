"""The port's detection driver (``mintime_torch.preprocessing.detect_faces``)
vs the JAX package's on cv2-written videos in nested directories, on the
CPU, with the same cascade weights (``tests/test_torch_mtcnn.py``'s seed-11
nets, score layers x75) and thresholds.

Tolerances: boxes within 2e-2 with the same counts a frame (the cascade's
fp32 products in two frameworks), the ``.dims.json`` sidecars and the miss
reports equal. One decode thread and two spawned decode processes write the
same bytes.
"""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch.preprocessing import detect_faces as port_df  # noqa: E402
from mintime_torch.preprocessing import mtcnn as port_mtcnn  # noqa: E402
from mintime_tpu.preprocessing import detect_faces as jax_df  # noqa: E402
from mintime_tpu.preprocessing import mtcnn as jax_mtcnn  # noqa: E402
from test_torch_predict_detect import _video  # noqa: E402

THRESHOLDS = (0.4, 0.4, 0.4)


def _nets():
    torch.manual_seed(11)
    nets = {"pnet": port_mtcnn.PNet(), "rnet": port_mtcnn.RNet(), "onet": port_mtcnn.ONet()}
    with torch.no_grad():
        for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
            getattr(nets[net], layer).weight.mul_(75.0)
            getattr(nets[net], layer).bias.mul_(75.0)
    return {k: v.state_dict() for k, v in nets.items()}


def _grey_video(path, n_frames=6):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (160, 120))
    for _ in range(n_frames):
        writer.write(np.full((120, 160, 3), 128, np.uint8))
    writer.release()
    return path


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    for sub in ("a", "b/c"):
        os.makedirs(root / sub, exist_ok=True)
    paths = [_video(str(root / "a" / "one.mp4"), n_frames=12),
             _video(str(root / "b" / "c" / "two.mp4"), n_frames=8),
             _grey_video(str(root / "b" / "three.mp4"))]
    sds = _nets()
    jvars = jax_mtcnn.mtcnn_params_from_torch(sds["pnet"], sds["rnet"], sds["onet"])
    return str(root), sorted(paths), sds, jvars


def _read(out_root):
    files = {}
    for dirpath, _, names in os.walk(out_root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path) as f:
                files[os.path.relpath(path, out_root)] = json.load(f)
    return files


def _port_detector(sds):
    return port_mtcnn.MTCNNDetector(sds, thresholds=THRESHOLDS, channel_order="bgr",
                                    device="cpu")


def test_process_videos_matches_jax(videos, tmp_path):
    root, paths, sds, jvars = videos
    want_missed = jax_df.process_videos(
        paths, root, str(tmp_path / "jax"),
        jax_mtcnn.MTCNNDetector(jvars, thresholds=THRESHOLDS, channel_order="bgr"))
    got_missed = port_df.process_videos(paths, root, str(tmp_path / "port"), _port_detector(sds))
    grey = os.path.join(root, "b", "three.mp4")  # grey frames: no face
    assert got_missed == want_missed == [grey]
    want, got = _read(tmp_path / "jax"), _read(tmp_path / "port")
    assert sorted(got) == sorted(want) == sorted(
        ["a/one.json", "a/one.dims.json", "b/c/two.json", "b/c/two.dims.json",
         "b/three.json", "b/three.dims.json"])
    n_boxes = 0
    for name in want:
        if name.endswith(".dims.json"):
            assert got[name] == want[name]
            continue
        assert list(got[name]) == list(want[name])
        for frame, boxes in want[name].items():
            assert (got[name][frame] is None) == (boxes is None)
            if boxes is not None:
                assert len(got[name][frame]) == len(boxes)
                np.testing.assert_allclose(got[name][frame], boxes, atol=2e-2, rtol=0)
                n_boxes += len(boxes)
    assert n_boxes > 0

    # idempotent: a second run skips every video and writes nothing
    before = {p: os.path.getmtime(tmp_path / "port" / p) for p in got}
    assert port_df.process_videos(paths, root, str(tmp_path / "port"), _port_detector(sds)) == []
    assert {p: os.path.getmtime(tmp_path / "port" / p) for p in got} == before


def test_spawned_decode_workers_write_the_same_files(videos, tmp_path):
    root, paths, sds, _ = videos
    det = _port_detector(sds)
    one = port_df.process_videos(paths, root, str(tmp_path / "thread"), det, decode_workers=0)
    two = port_df.process_videos(paths, root, str(tmp_path / "spawn"), det, decode_workers=2)
    assert one == two
    assert _read(tmp_path / "thread") == _read(tmp_path / "spawn")


def test_detect_video_matches_the_driver(videos, tmp_path):
    root, paths, sds, _ = videos
    det = _port_detector(sds)
    port_df.process_videos(paths[:1], root, str(tmp_path), det)
    with open(tmp_path / "a" / "one.json") as f:
        assert port_df.detect_video(paths[0], det) == json.load(f)


def test_main_without_weights_warns_and_runs(videos, tmp_path, capsys):
    root, _, _, _ = videos
    port_df.main(["--video_path", root, "--output_path", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "WARNING: no --mtcnn_weights; using random cascade (structural run)" in out
    assert "processed 3 videos" in out
    assert len(_read(tmp_path)) == 6
