"""``mintime_torch.preprocessing.extract_crops`` and ``pack_crops`` against
the JAX package's: ``extract_video`` on a cv2-written ``.mp4`` with a boxes
JSON gives the same crops, the same sidecar and a byte-identical pack, and
both ``main``s write the same trees."""

import json
import os
import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mintime_torch.preprocessing import extract_crops as port_ec  # noqa: E402
from mintime_torch.preprocessing import pack_crops as port_pc  # noqa: E402
from mintime_tpu.preprocessing import extract_crops as jax_ec  # noqa: E402
from mintime_tpu.preprocessing import pack_crops as jax_pc  # noqa: E402


def write_video(path, n_frames=91, size=(96, 128), seed=0):
    """An ``.mp4`` of 8-pixel block noise at 30 fps."""
    rng = np.random.default_rng(seed)
    h, w = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for _ in range(n_frames):
        blocks = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        writer.write(np.repeat(np.repeat(blocks, 8, 0), 8, 1))
    writer.release()
    return path


#: half-resolution boxes a frame: a frame without, a face at the border, a
#: window's last frame (never taken)
BOXES = {"1": [[4, 4, 20, 20], [30, 10, 50, 34]], "2": None, "31": None,
         "40": [[0, 30, 18, 47], [40, 2, 62, 24]], "59": [[10, 10, 30, 30]],
         "61": [[6, 6, 22, 22]]}


def write_videos(root, n=3):
    """``n`` videos under ``root/videos/<split>`` with boxes JSONs under
    ``root/boxes/<split>``; returns the two roots."""
    videos, boxes = os.path.join(root, "videos"), os.path.join(root, "boxes")
    for v in range(n):
        split = "train" if v % 2 else "test"
        os.makedirs(os.path.join(videos, split), exist_ok=True)
        os.makedirs(os.path.join(boxes, split), exist_ok=True)
        write_video(os.path.join(videos, split, f"clip_{v}.mp4"), seed=v)
        with open(os.path.join(boxes, split, f"clip_{v}.json"), "w") as f:
            json.dump(BOXES if v != 2 else {"1": [[4, 4, 20, 20]]}, f)
    return videos, boxes


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    video = write_video(str(root / "v.mp4"))
    boxes = str(root / "v.json")
    with open(boxes, "w") as f:
        json.dump(BOXES, f)
    return video, boxes


@pytest.mark.parametrize("packed", [False, True])
def test_extract_video_matches_jax(clip, tmp_path, packed):
    video, boxes = clip
    got = port_ec.extract_video(video, boxes, str(tmp_path / "port"), packed=packed)
    want = jax_ec.extract_video(video, boxes, str(tmp_path / "jax"), packed=packed)
    assert [(f, j) for f, j, _ in got] == [(f, j) for f, j, _ in want]
    assert len(got) == 5
    for (_, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert ("crops.pack" in names) == packed and "video_dims.json" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_extract_video_without_writing(clip, tmp_path):
    video, boxes = clip
    got = port_ec.extract_video(video, boxes, str(tmp_path / "none"), write=False)
    assert len(got) == 5 and not (tmp_path / "none").exists()


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_clis_write_jax_trees(tmp_path, packed):
    videos, boxes = write_videos(str(tmp_path))
    extra = ["--packed"] if packed else []
    for side, main in (("port", port_ec.main), ("jax", jax_ec.main)):
        main(["--video_path", videos, "--boxes_path", boxes,
              "--output_path", str(tmp_path / side), "--workers", "2", *extra])
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert got == want and len(got) == (6 if packed else 3 + 5 + 5 + 1)

    if packed:
        return
    # identities as clustering would leave them (face j → folder j), then both pack_crops
    for side in ("port", "jax"):
        for dirpath, _, files in list(os.walk(tmp_path / side)):
            for f in files:
                if f.endswith(".png"):
                    ident = os.path.join(dirpath, f.split("_")[1][:-4])
                    os.makedirs(ident, exist_ok=True)
                    shutil.move(os.path.join(dirpath, f), os.path.join(ident, f))
    assert sorted(port_pc.iter_video_dirs(str(tmp_path / "port"))) == [
        str(tmp_path / "port" / s / f"clip_{v}") for s, v in (("test", 0), ("test", 2),
                                                              ("train", 1))]
    port_pc.main(["--faces_dir", str(tmp_path / "port"), "--remove_images"])
    jax_pc.main(["--faces_dir", str(tmp_path / "jax"), "--remove_images"])
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert got == want
    assert sorted(k for k in got if k.endswith("crops.pack")) == [
        os.path.join(s, f"clip_{v}", "crops.pack") for s, v in (("test", 0), ("test", 2),
                                                                ("train", 1))]
