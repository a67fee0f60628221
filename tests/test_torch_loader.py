"""``mintime_torch.data.loader.DataLoader`` against
``mintime_tpu.data.loader.DataLoader`` on ``test_torch_dataset``'s faces
tree: in thread mode and in spawned-process mode the port yields the JAX
loader's batches in the same order for the same seed and epoch (side arrays
equal, frames within one level), keeps its workers across passes, and turns
a dataset error into a ``RuntimeError`` in the consumer."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch.data import dataset as port_ds  # noqa: E402
from mintime_torch.data.loader import DataLoader  # noqa: E402
from mintime_tpu.data import dataset as jax_ds  # noqa: E402
from mintime_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from test_torch_dataset import (  # noqa: E402
    FRAMES,
    IMAGE,
    PATCHES,
    assert_frames_close,
    pack_tree,
    write_faces_tree,
)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader"))
    faces, videos_root, names, labels, methods = write_faces_tree(root, seed=1)
    return {"png": faces, "pack": pack_tree(faces, os.path.join(root, "packed")),
            "video_path": videos_root, "videos": names, "labels": labels, "methods": methods}


def _args(tree, layout, **kw):
    return dict(data_path=tree[layout], image_size=IMAGE, num_frames=FRAMES,
                num_patches=PATCHES, mode="test", multiclass_labels=tree["methods"],
                video_path=tree["video_path"], **kw)


def _assert_batches_equal(got, want):
    assert [b["video_id"] for b in got] == [b["video_id"] for b in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert isinstance(g["frames"], torch.Tensor)
        assert_frames_close(g["frames"], w["frames"])
        for k, v in w.items():
            if isinstance(v, np.ndarray) and k != "frames":
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            elif k != "frames":
                assert g[k] == v, k


@pytest.mark.parametrize("mode,layout", [("thread", "png"), ("process", "pack"),
                                         ("process", "png")])
def test_batches_match_jax_in_order(tree, mode, layout):
    port = port_ds.DeepfakesDataset(tree["videos"], tree["labels"], device="cpu",
                                    **_args(tree, layout))
    jax = jax_ds.DeepfakesDataset(tree["videos"], tree["labels"], **_args(tree, layout))
    kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=11)
    want_loader = JaxDataLoader(jax, worker_mode="thread", **kw)
    with DataLoader(port, worker_mode=mode, **kw) as loader:
        assert len(loader) == len(want_loader) == 3
        for _ in range(2):  # two epochs: the (seed, epoch) shuffle
            _assert_batches_equal(list(loader), list(want_loader))
        if mode == "process":
            pids = [w.pid for w in loader._workers]
            list(loader)
            assert [w.pid for w in loader._workers] == pids  # kept across passes
            workers = loader._workers
    if mode == "process":
        assert not loader._workers and not any(w.is_alive() for w in workers)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_order_without_shuffle(tree, mode):
    """In list order, the last partial batch kept."""
    port = port_ds.DeepfakesDataset(tree["videos"], tree["labels"], device="cpu",
                                    **_args(tree, "pack"))
    with DataLoader(port, batch_size=2, shuffle=False, num_workers=2,
                    worker_mode=mode) as loader:
        ids = [b["video_id"] for b in loader]
    assert len(tree["videos"]) % 2 == 1
    assert ids == [tree["videos"][i:i + 2] for i in range(0, len(tree["videos"]), 2)]


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_a_dataset_error_raises_in_the_consumer(tree, mode):
    args = _args(tree, "png")
    del args["video_path"]  # video_5 has no frame size then
    port = port_ds.DeepfakesDataset(tree["videos"], tree["labels"], device="cpu", **args)
    loader = DataLoader(port, batch_size=2, shuffle=False, num_workers=2, worker_mode=mode)
    with pytest.raises(RuntimeError, match="unknown original video dimensions"):
        list(loader)
    assert not loader._workers  # a failed pass stops its workers
    loader.close()


def test_the_workers_modules_import_no_torch():
    """A spawned worker only loads: its modules start without torch, and so
    does ``mintime_torch.evaluate``, the main module that the CLI's workers
    run again under ``python -m``."""
    import subprocess
    import sys

    code = ("import sys, mintime_torch.data.loader, mintime_torch.data.dataset, "
            "mintime_torch.evaluate\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120,
                   env={**os.environ, "PYTHONPATH": root})


def test_the_evaluation_loaders_workers_run_without_torch(tree):
    """The loader that ``evaluate.evaluate_split`` builds, given the
    ``torch.device`` it resolves: its spawned workers load every sample and
    never map libtorch (the dataset pickles its device as a string)."""
    from mintime_torch import evaluate
    from mintime_torch.config import MintimeConfig, ModelConfig

    cfg = MintimeConfig(model=ModelConfig(image_size=IMAGE, num_frames=FRAMES,
                                          num_patches=PATCHES, max_identities=2))
    with evaluate.split_loader(cfg, tree["videos"], tree["labels"], tree["methods"],
                               tree["pack"], 3, workers=2, video_path=tree["video_path"],
                               device=torch.device("cpu")) as loader:
        loader.worker_mode = "process"
        assert len([b["video_id"] for b in loader]) == len(loader)
        maps = []
        for w in loader._workers:
            with open(f"/proc/{w.pid}/maps") as f:
                maps.append(f.read())
    assert len(maps) == 2 and all("libc" in m for m in maps)
    assert not [m for m in maps if "libtorch" in m]
