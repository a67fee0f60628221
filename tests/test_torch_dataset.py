"""``mintime_torch.data.dataset.DeepfakesDataset`` against
``mintime_tpu.data.dataset.DeepfakesDataset`` on a cv2-written faces tree
(modelled on ``tests/test_train_loop.py::faces_dir``), as PNG folders and as
``crops.pack`` shards.

The tree has identity folders, loose crops that merge into identity 0, a
third identity (cut by ``max_identities=2``), a video of loose crops only, a
pack-only video, and frame sizes from a sidecar, a pack header and an
``.mp4`` under ``video_path``. Crops from 14 to 60 px at ``image_size`` 32
take both of the transform's resizes (area down, cubic up) and the pad.

Side tensors, ``video_id`` and ``tokens_per_identity`` must be equal; frames
may differ by one level on at most 1e-4 of the values (the port's cubic
resize against cv2's, ``tests/test_torch_val_transform.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch.data import dataset as port_ds  # noqa: E402
from mintime_torch.data.crop_store import CropPack, pack_video_dir, write_pack  # noqa: E402
from mintime_tpu.data import dataset as jax_ds  # noqa: E402
from mintime_tpu.data.crop_store import CropPack as JaxCropPack  # noqa: E402

IMAGE, FRAMES, PATCHES = 32, 8, 4
SIDE_KEYS = ("size_embedding", "mask", "identities_mask", "positions", "labels")
#: (video, each identity's crop sides a second, loose crops' frames, source of the frame size)
VIDEOS = (
    ("video_0", [[20, 24, 28, 32, 36]], (), "sidecar"),
    ("video_1", [[40, 44, 48, 52], [18, 18, 18]], (30, 150, 180), "sidecar"),
    ("video_2", [[60, 56, 52, 48], [30, 34, 38, 42], [14, 16, 18, 20]], (), "sidecar"),
    ("video_3", [], (0, 30, 60, 90, 120), "sidecar"),
    ("video_4", [[26, 30, 34, 26, 30], [50, 50]], (60,), "pack"),
    ("video_5", [[32, 32, 32, 40], [22, 26, 30, 34, 38, 42]], (), "video_path"),
    ("video_6", [[44] * 10, [16] * 10], (), "sidecar"),
)


def _crop(rng, side, frame):
    """A square crop, or a slightly wide one every third frame (the pad)."""
    w = side + 6 if frame % 90 == 30 else side
    return rng.integers(0, 256, (side, w, 3), dtype=np.uint8)


def write_faces_tree(root, seed=0):
    """The tree above under ``root/faces`` and the ``.mp4`` of ``video_5``
    under ``root/videos``; returns ``(faces, videos_root, videos, labels,
    method ids)``."""
    rng = np.random.default_rng(seed)
    faces, videos_root = os.path.join(root, "faces"), os.path.join(root, "videos")
    os.makedirs(videos_root, exist_ok=True)
    names, labels, methods = [], [], []
    for v, (name, identities, loose, dims) in enumerate(VIDEOS):
        vdir = os.path.join(faces, name)
        os.makedirs(vdir)
        entries = []
        for ident, sides in enumerate(identities):
            for k, side in enumerate(sides):
                entries.append((str(ident), 30 * k, ident, _crop(rng, side, 30 * k)))
        entries += [(None, f, 3, _crop(rng, 24, f)) for f in loose]
        if dims == "pack":
            write_pack(os.path.join(vdir, "crops.pack"), entries,
                       dims={"width": 1280, "height": 720})
        else:
            for ident, frame, face, crop in entries:
                folder = vdir if ident is None else os.path.join(vdir, ident)
                os.makedirs(folder, exist_ok=True)
                cv2.imwrite(os.path.join(folder, f"{frame}_{face}.png"), crop)
        if dims == "sidecar":
            with open(os.path.join(vdir, "video_dims.json"), "w") as f:
                json.dump({"width": 640 + 80 * v, "height": 360, "fps": 30}, f)
        if dims == "video_path":
            writer = cv2.VideoWriter(os.path.join(videos_root, f"{name}.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), 30, (320, 240))
            for _ in range(3):
                writer.write(np.zeros((240, 320, 3), np.uint8))
            writer.release()
        names.append(name)
        labels.append(float(v % 2))
        methods.append(float(1 + v % 4) if v % 2 else float("nan"))
    return faces, videos_root, names, labels, methods


def pack_tree(faces, out):
    """A copy of the faces tree with every PNG video packed (images removed)."""
    shutil.copytree(faces, out)
    for name in sorted(os.listdir(out)):
        pack_video_dir(os.path.join(out, name), remove_images=True)
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    faces, videos_root, names, labels, methods = write_faces_tree(root)
    return {"png": faces, "pack": pack_tree(faces, os.path.join(root, "packed")),
            "video_path": videos_root, "videos": names, "labels": labels, "methods": methods}


def _datasets(tree, layout, mode="test", ordering=0, **kw):
    args = dict(data_path=tree[layout], image_size=IMAGE, num_frames=FRAMES,
                num_patches=PATCHES, max_identities=2, mode=mode, identities_ordering=ordering,
                multiclass_labels=tree["methods"], video_path=tree["video_path"], seed=5, **kw)
    return (port_ds.DeepfakesDataset(tree["videos"], tree["labels"], device="cpu", **args),
            jax_ds.DeepfakesDataset(tree["videos"], tree["labels"], **args))


def assert_frames_close(got, want, share=1e-4):
    """At most one level apart, on at most ``share`` of the values."""
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got).astype(np.int16)
    diff = np.abs(got - np.asarray(want).astype(np.int16))
    assert got.shape == diff.shape == np.asarray(want).shape
    assert diff.max() <= 1 and (diff > 0).mean() <= share, (diff.max(), (diff > 0).mean())


def assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in SIDE_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    for k in ("video_id", "tokens_per_identity"):
        assert got.get(k) == want.get(k), k
    if "multiclass_label" in want:
        np.testing.assert_array_equal(got["multiclass_label"], want["multiclass_label"])


@pytest.mark.parametrize("ordering", [0, 1, 2])
@pytest.mark.parametrize("mode", ["test", "val"])
@pytest.mark.parametrize("layout", ["png", "pack"])
def test_samples_match_jax(tree, layout, mode, ordering):
    port, jax = _datasets(tree, layout, mode, ordering)
    frames_got, frames_want = [], []
    for i in range(len(port)):
        got, want = port[i], jax[i]
        frames_got.append(got.pop("frames"))
        frames_want.append(want.pop("frames"))
        assert frames_got[-1].dtype == torch.uint8 and frames_got[-1].device.type == "cpu"
        assert_samples_equal(got, want)
    assert_frames_close(torch.stack(frames_got), np.stack(frames_want))


def test_the_tree_reaches_every_branch(tree):
    """What the tree is for: the merge, the third identity's cut, the
    loose-only video, every source of the frame size."""
    port, _ = _datasets(tree, "png")
    port.preload_index(workers=2)
    idx = {v: port.get_index(i) for i, v in enumerate(tree["videos"])}
    assert idx["video_1"].vf.identities[0].frames == [0, 30, 60, 90, 150, 180]
    assert len(port[2]["tokens_per_identity"]) == 2
    assert len(idx["video_2"].vf.identities) == 3
    assert [i.key for i in idx["video_3"].vf.identities] == ["video_3"]
    assert idx["video_4"].pack is not None and idx["video_4"].dims == (1280, 720)
    assert idx["video_5"].dims == (320, 240) and idx["video_0"].dims == (640, 360)
    packed, _ = _datasets(tree, "pack")
    assert all(packed.get_index(i).pack is not None for i in range(len(packed)))


@pytest.mark.parametrize("layout", ["png", "pack"])
def test_index_matches_jax(tree, layout):
    for name in tree["videos"]:
        vdir = os.path.join(tree[layout], name)
        pack = os.path.join(vdir, "crops.pack")
        if os.path.exists(pack):
            got = port_ds.video_faces_from_pack(CropPack(pack), vdir)
            want = jax_ds.video_faces_from_pack(JaxCropPack(pack), vdir)
        else:
            got, want = port_ds.scan_video_dir(vdir), jax_ds.scan_video_dir(vdir)
        for g, w in ((got, want), (port_ds.merge_discarded(got), jax_ds.merge_discarded(want))):
            assert [(i.key, i.frames, i.mean_side) for i in g.identities] == \
                [(i.key, i.frames, i.mean_side) for i in w.identities]
            assert g.faces == w.faces and g.discarded == w.discarded


def test_collate_matches_jax(tree):
    port, jax = _datasets(tree, "png")
    got = port_ds.collate([port[i] for i in (1, 2, 5)])
    want = jax_ds.collate([jax[i] for i in (1, 2, 5)])
    assert set(got) == set(want)
    assert isinstance(got["frames"], torch.Tensor)
    assert_frames_close(got.pop("frames"), want.pop("frames"))
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        else:
            assert got[k] == want[k], k


def test_load_is_numpy_and_transform_crops_batches(tree):
    port, _ = _datasets(tree, "pack")
    raws = [port.load(i) for i in (0, 4)]
    assert all(isinstance(c, np.ndarray) for r in raws for c in r["crops"])
    assert [len(r["crops"]) for r in raws] == [FRAMES, FRAMES]
    frames = port.transform_crops([r["crops"] for r in raws])
    assert frames.shape == (2, FRAMES, IMAGE, IMAGE, 3)
    torch.testing.assert_close(frames[1], port[4]["frames"], rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["png", "pack"])
def test_unknown_dims_raise_as_in_jax(tree, layout):
    args = dict(data_path=tree[layout], image_size=IMAGE, num_frames=FRAMES,
                num_patches=PATCHES, mode="test")
    i = tree["videos"].index("video_5")  # dims only through video_path
    port = port_ds.DeepfakesDataset(tree["videos"], tree["labels"], device="cpu", **args)
    jax = jax_ds.DeepfakesDataset(tree["videos"], tree["labels"], **args)
    for ds in (port, jax):
        with pytest.raises(ValueError, match="unknown original video dimensions"):
            ds[i]
    port = port_ds.DeepfakesDataset(tree["videos"], tree["labels"], device="cpu",
                                    default_video_dims=(100, 50), **args)
    jax = jax_ds.DeepfakesDataset(tree["videos"], tree["labels"],
                                  default_video_dims=(100, 50), **args)
    got, want = port[i], jax[i]
    assert_frames_close(got.pop("frames"), want.pop("frames"))
    assert_samples_equal(got, want)


def test_train_mode_raises_and_names_the_work_item():
    with pytest.raises(ValueError, match="queue 1 item 4"):
        port_ds.DeepfakesDataset(["v"], [0.0], mode="train", device="cpu")


def test_default_device_is_the_card(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    ds = port_ds.DeepfakesDataset(tree["videos"], tree["labels"], data_path=tree["png"],
                                  image_size=IMAGE, num_frames=FRAMES, num_patches=PATCHES)
    ds.load(0)  # the file work needs no device
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ds[0]
