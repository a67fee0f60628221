"""``DeepfakesDataset(mode="train")`` of the port against the JAX package's,
on a small tree written by the port's own ``extract_crops`` (cv2-written
``.mp4`` files and boxes, 5 fps, faces of 66 to 267 px, one or two
identities a video) and, packed by ``pack_crops``, as ``crops.pack`` shards;
both presets, at 224 px and 4 frames.

Side tensors and labels must be equal, and so must the drawn steps, arrays
included, and the frames (every transform, and the resize chain with it,
is bitwise equal to cv2's on this tree, as ``test_torch_augment.py`` holds). The port's loader in train mode gives
the dataset's own samples, and its spawned workers never map libtorch.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch.data import dataset as port_ds  # noqa: E402
from mintime_torch.data.loader import DataLoader  # noqa: E402
from mintime_torch.preprocessing import extract_crops, pack_crops  # noqa: E402
from mintime_tpu.data import dataset as jax_ds  # noqa: E402
from test_torch_augment import _recorder, _same  # noqa: E402

IMAGE, FRAMES, PATCHES, FPS = 224, 4, 49, 5
SIDE_KEYS = ("size_embedding", "mask", "identities_mask", "positions", "labels")
#: (video, each identity's half-resolution box side) on 360 x 480 frames
VIDEOS = (("clip_0", (20,)), ("clip_1", (40, 26)), ("clip_2", (87,)), ("clip_3", (56, 33)))


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many small torch ops on the CPU: one thread each, so
    that the parallel test run's workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_video(path, seed, n_frames=6 * FPS, size=(360, 480)):
    """Block noise over a gradient, in a band of levels the video draws."""
    r = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 0.3, yy * 0.4, (xx + yy) * 0.2], -1) + r.integers(0, 80)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (w, h))
    for _ in range(n_frames):
        blocks = r.integers(-40, 40, (h // 8, w // 8, 3))
        noise = np.repeat(np.repeat(blocks, 8, 0), 8, 1)
        writer.write(np.clip(base + noise, 0, 255).astype(np.uint8))
    writer.release()


def write_train_tree(root):
    """Videos and boxes → PNG crops in identity folders (``png``) and the
    same packed (``pack``); returns both roots, the videos and labels."""
    videos, boxes = os.path.join(root, "videos", "train"), os.path.join(root, "boxes", "train")
    os.makedirs(videos)
    os.makedirs(boxes)
    for v, (name, sides) in enumerate(VIDEOS):
        _write_video(os.path.join(videos, f"{name}.mp4"), v)
        faces = {}
        for sec in range(6):
            # the box drifts and changes size a little from second to second
            x0, y0, grow = 10 + sec, 10 + sec, sec % 3
            faces[str(sec * FPS + 1)] = [[x0 + 120 * j, y0, x0 + 120 * j + s + grow, y0 + s + grow]
                                         for j, s in enumerate(sides)]
        with open(os.path.join(boxes, f"{name}.json"), "w") as f:
            json.dump(faces, f)
    png = os.path.join(root, "faces")
    extract_crops.main(["--video_path", os.path.dirname(videos), "--boxes_path",
                        os.path.dirname(boxes), "--output_path", png, "--workers", "2"])
    for dirpath, _, files in list(os.walk(png)):  # face j → identity folder j
        for f in files:
            if f.endswith(".png"):
                ident = os.path.join(dirpath, f.split("_")[1][:-4])
                os.makedirs(ident, exist_ok=True)
                shutil.move(os.path.join(dirpath, f), os.path.join(ident, f))
    pack = os.path.join(root, "packed")
    shutil.copytree(png, pack)
    pack_crops.main(["--faces_dir", pack, "--remove_images"])
    names = [f"train/{name}" for name, _ in VIDEOS]
    return {"png": png, "pack": pack, "videos": names, "labels": [0.0, 1.0, 1.0, 0.0]}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_train_tree(str(tmp_path_factory.mktemp("train_tree")))


def _datasets(tree, layout, aug, seed):
    args = dict(data_path=tree[layout], image_size=IMAGE, num_frames=FRAMES,
                num_patches=PATCHES, max_identities=2, mode="train", augmentation=aug, seed=seed)
    return (port_ds.DeepfakesDataset(tree["videos"], tree["labels"], device="cpu", **args),
            jax_ds.DeepfakesDataset(tree["videos"], tree["labels"], **args))


def test_the_tree_has_the_sizes_it_needs(tree):
    port, _ = _datasets(tree, "pack", "max", 0)
    sides = sorted({c.shape[0] for i in range(len(port)) for c in port.load(i)["crops"]})
    assert sides[0] < 100 and sides[-1] > IMAGE  # crops that grow and crops that shrink
    assert all(port.get_index(i).pack is not None for i in range(len(port)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("aug", ["min", "max"])
@pytest.mark.parametrize("layout", ["png", "pack"])
def test_train_samples_match_jax(monkeypatch, tree, layout, aug, seed):
    rec = _recorder(monkeypatch)
    port, jax = _datasets(tree, layout, aug, seed)
    for i in range(len(port)):
        raw = port.load(i)
        rec.clear()
        want = jax[i]
        # the draws: the resize chain's members record empty dicts, as in the JAX package
        assert _same([(t.name, p) for t, p in raw["steps"]], rec), i
        got = port[i]
        assert set(got) == set(want)
        for k in SIDE_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        frames = got["frames"]
        assert frames.dtype == torch.uint8 and tuple(frames.shape) == (FRAMES, IMAGE, IMAGE, 3)
        diff = np.abs(frames.numpy().astype(np.int16) - want["frames"].astype(np.int16))
        assert diff.max() == 0, \
            (i, [t.name for t, _ in raw["steps"]], int(diff.max()), (diff > 0).mean())


def test_the_same_video_gets_the_same_augmentation_in_every_epoch(tree):
    """The JAX package's generator is seeded by (seed, index) and not the
    epoch, and the port copies it: through the loader, two epochs in
    different orders give every video the same frames."""
    port, _ = _datasets(tree, "pack", "max", 3)
    epochs = []
    with DataLoader(port, batch_size=2, shuffle=True, num_workers=2, seed=0,
                    worker_mode="thread") as loader:
        for _ in range(2):
            order = [i for b in loader._batches() for i in b]
            frames = torch.cat([b["frames"] for b in loader])
            epochs.append((order, dict(zip(order, frames))))
    (order0, frames0), (order1, frames1) = epochs
    assert order0 != order1 and sorted(order0) == sorted(order1) == list(range(len(port)))
    for i in order0:
        assert torch.equal(frames0[i], frames1[i]), i


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_gives_the_datasets_samples(tree, mode):
    port, _ = _datasets(tree, "pack", "max", 4)
    with DataLoader(port, batch_size=3, shuffle=True, num_workers=2, seed=1,
                    worker_mode=mode) as loader:
        order = [i for b in loader._batches() for i in b]
        batches = list(loader)
    assert [b["frames"].shape[0] for b in batches] == [3, 1]
    got = torch.cat([b["frames"] for b in batches])
    want = torch.stack([port[i]["frames"] for i in order])
    assert torch.equal(got, want)
    labels = np.concatenate([b["labels"] for b in batches])
    np.testing.assert_array_equal(labels, np.asarray(port.labels, np.float32)[order])
    assert "steps" not in batches[0] and "crops" not in batches[0]


def test_the_train_loaders_workers_run_without_torch(tree):
    port, _ = _datasets(tree, "pack", "max", 0)
    with DataLoader(port, batch_size=2, shuffle=False, num_workers=2,
                    worker_mode="process") as loader:
        assert len(list(loader)) == 2
        maps = []
        for w in loader._workers:
            with open(f"/proc/{w.pid}/maps") as f:
                maps.append(f.read())
    assert len(maps) == 2 and all("libc" in m for m in maps)
    assert not [m for m in maps if "libtorch" in m]
