"""Data and tensor parallelism of the port (``mintime_torch/parallel/mesh.py``)
on the CPU: two processes of a gloo group, spawned by the test, each with a
time limit of its own, against one process.

* A DP=2 train step of the flagship at a small size (EfficientNet-B0 at
  32 px, every BatchNorm in train mode, drop-connect on), three steps of
  which the second is an odd batch (3 rows: 1 + 2) and the third a batch of
  one row, padded with its repeat (``mesh.pad_batch``: 1 + 1, the second
  marked ``valid`` 0), against one process on the whole batches: the loss within 1e-5 relative; gradients, updated
  parameters and running statistics within 1e-5 of each tensor's max
  |value|. In float64: through B0's 16 train-mode blocks, fp32 rounding
  alone moves a gradient by up to 5e-5 of its tensor's max between two
  summation orders (one process in fp32 against float64), so the data ranks'
  other order is held to 1e-5 where rounding sits far below it.
* TP=2 against TP=1: the train and eval losses within ``rtol=1e-5``, as
  ``tests/test_train_loop.py::test_tensor_parallel_matches_data_parallel``
  demands of the JAX mesh.
* A DP=2 ``evaluate_split`` report against one process on a split of 7
  videos at batch 4 (ranks of 2 + 2, then 1 + 2 rows), as
  ``test_evaluate_mesh_matches_single``: equal discrete fields, the loss
  within ``rtol=1e-5``.
* The attention kernels take the heads a model rank keeps.
"""

import multiprocessing as mp
import os
import socket
import time

import numpy as np
import pytest
import torch

from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig

CFG = ModelConfig(image_size=32, num_frames=8, num_patches=1, channels=1280, dim=32, depth=1,
                  heads=2, dim_head=16, max_identities=2)
TRAIN = MintimeConfig(model=CFG, training=TrainingConfig(lr=0.05, weight_decay=1e-3,
                                                         optimizer="SGD", scheduler="cosinelr"))
POS_WEIGHT = 1.3
#: seconds each spawned process may take
LIMIT_S = 150


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    result = globals()[fn](*args)
    torch.save(result, os.path.join(out, f"{fn}_{rank}.pt"))
    dist.destroy_process_group()


def _spawn(fn: str, args: tuple, out, world: int = 2) -> list:
    """``fn(*args)`` in ``world`` spawned processes of one gloo group; each
    one's result. A process past its time limit is killed and fails the test."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + LIMIT_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    late = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not late, f"processes {late} passed their {LIMIT_S} s limit"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
    return [torch.load(os.path.join(out, f"{fn}_{r}.pt"), weights_only=False)
            for r in range(world)]


def _batch(n: int, seed: int) -> dict:
    from mintime_torch.utils.profiling import _example_inputs

    names = ("frames", "mask", "identities_mask", "size_embedding", "positions")
    b = dict(zip(names, _example_inputs(CFG, n)))
    rng = np.random.default_rng(seed)
    b["frames"] = rng.standard_normal(b["frames"].shape).astype(np.float32)
    b["mask"][:, -2:] = rng.random((n, 2)) < 0.5  # some dummy slots
    b["labels"] = (np.arange(n) % 2).astype(np.float32)
    return b


BATCHES = (_batch(4, 1), _batch(3, 2), _batch(1, 3))


def _model(dtype=torch.float64):
    from mintime_torch.models.classifier import MintimeVideoClassifier

    return MintimeVideoClassifier(CFG, use_kernels=True, device="cpu", dtype=dtype,
                                  param_dtype=dtype, seed=0)


def _train(mesh=None) -> dict:
    from mintime_torch.parallel.mesh import pad_batch, shard_batch
    from mintime_torch.train import create_train_state, make_train_step

    model = _model()
    state = create_train_state(model, TRAIN, steps_per_epoch=2, num_epochs=1, seed=7)
    step = make_train_step(model, POS_WEIGHT, mesh=mesh)
    losses, grads = [], []
    for b in BATCHES:
        if mesh is not None:
            b = shard_batch(mesh, pad_batch(mesh, b))
        losses.append(float(step(state, b)["loss"]))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    return {"losses": losses, "grads": grads, "state": {k: v.clone() for k, v in
                                                         model.state_dict().items()}}


def dp_train():
    from mintime_torch.parallel.mesh import make_mesh

    return _train(make_mesh(device="cpu"))


def _close(got, want, what):
    """Each tensor within 1e-5 of its max |value|; a tensor that is zero in
    exact arithmetic (max |value| under 1e-9 of the largest tensor's: the
    ``_bn2`` biases' gradients under a train-mode BatchNorm, the running
    means of 1x1 convolutions fed by one) takes 1e-9 of the largest as its
    scale, since both sides hold rounding noise there."""
    largest = max(float(v.abs().max()) for v in want.values())
    for name, ref in want.items():
        top = max(float(ref.abs().max()), 1e-9 * largest)
        err = float((got[name] - ref).abs().max())
        assert err <= 1e-5 * top, f"{what} {name}: {err} vs max {top}"


def test_dp2_train_steps_match_one_process(tmp_path):
    runs = _spawn("dp_train", (), tmp_path)
    one = _train()
    for run in runs:
        np.testing.assert_allclose(run["losses"], one["losses"], rtol=1e-5)
        for g_dp, g_one in zip(run["grads"], one["grads"]):
            _close(g_dp, g_one, "gradient")
        _close(run["state"], one["state"], "parameter or statistic")
    moved = [k for k in one["state"] if "running_var" in k]
    assert moved and all(not torch.equal(runs[0]["state"][k], _model().state_dict()[k])
                         for k in moved)
    for k, v in runs[0]["state"].items():  # the ranks hold the same bits
        assert torch.equal(v, runs[1]["state"][k]), k


def _tp_losses(mesh=None) -> tuple:
    from mintime_torch.parallel.mesh import tensor_parallel
    from mintime_torch.train import create_train_state, make_eval_step, make_train_step

    model = _model(torch.float32)
    model.extractor.drop_connect_rate = 0.0
    tensor_parallel(model, mesh)
    state = create_train_state(model, TRAIN, steps_per_epoch=2, num_epochs=1)
    train_loss = float(make_train_step(model, POS_WEIGHT, mesh=mesh)(state, BATCHES[0])["loss"])
    eval_loss = float(make_eval_step(model, POS_WEIGHT, mesh=mesh)(state, BATCHES[0])["loss"])
    heads = [m.heads for m in model.modules() if hasattr(m, "heads")]
    return train_loss, eval_loss, heads


def tp_losses():
    from mintime_torch.parallel.mesh import make_mesh

    return _tp_losses(make_mesh(model_parallel=2, device="cpu"))


def test_tp2_losses_match_tp1(tmp_path):
    runs = _spawn("tp_losses", (), tmp_path)
    one = _tp_losses()
    for train_loss, eval_loss, heads in runs:
        assert set(heads) == {CFG.heads // 2}
        np.testing.assert_allclose((train_loss, eval_loss), one[:2], rtol=1e-5)


def test_tp_rules_split_by_heads_and_halves():
    """q, k and v each split by heads, the GEGLU's value and gate halves each
    by hidden units; the shards put back give the whole weights."""
    from mintime_torch.parallel import mesh

    H, dh, tp, hidden = 4, 3, 2, 6
    rows = [mesh._heads_rows(H, dh, tp, r) for r in range(tp)]
    assert rows[0].tolist() == [0, 1, 2, 3, 4, 5, 12, 13, 14, 15, 16, 17, 24, 25, 26, 27, 28, 29]
    assert sorted(torch.cat(rows).tolist()) == list(range(3 * H * dh))
    halves = [mesh._halves_rows(hidden, tp, r) for r in range(tp)]
    assert halves[1].tolist() == [3, 4, 5, 9, 10, 11]
    spec = mesh.state_shardings(_model())
    assert spec["head.layers.0.0.fn.to_qkv.weight"] == "column"
    assert spec["head.layers.0.1.fn.to_out.0.weight"] == "row"
    assert spec["head.layers.0.2.fn.net.0.bias"] == "column"
    assert spec["head.layers.0.2.fn.net.3.weight"] == "row"
    assert spec["extractor._conv_stem.weight"] == "replicated"
    assert spec["head.to_out.1.weight"] == "replicated"


def test_shard_rows_cover_the_batch_in_order():
    from mintime_torch.parallel.mesh import shard_rows

    for n in range(0, 9):
        for world in (1, 2, 3, 4):
            got = [list(range(n))[shard_rows(n, r, world)] for r in range(world)]
            assert sum(got, []) == list(range(n))
            assert max(map(len, got)) - min(map(len, got)) <= 1


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_attention_kernels_take_the_heads_of_a_model_rank(tp):
    """The flagship's axes at ``heads / tp`` heads of 64 still reach the
    whole-slice kernels within their limits (``tests/test_torch_attention_limits.py``)."""
    from mintime_torch.ops import divided_attention as da

    H, dh = 8 // tp, 64
    for G, L in ((49, 16), (16, 49)):
        assert da.takes_whole_slice(G, L, 3 * H * dh, 2)
        da.check_kernel_shape(G, L, dh)


def _write_split(root) -> tuple:
    from mintime_torch.data.crop_store import PACK_NAME, write_pack

    rng = np.random.default_rng(5)
    faces, rows = os.path.join(root, "faces"), []
    for v in range(7):
        name = f"video_{v}"
        os.makedirs(os.path.join(faces, name))
        entries = [(str(i), f * 30, i, rng.integers(0, 256, (40 + 8 * i, 40 + 8 * i, 3),
                                                         dtype=np.uint8))
                   for i in range(1 + v % 2) for f in range(6)]
        write_pack(os.path.join(faces, name, PACK_NAME), entries,
                   dims={"width": 320, "height": 240})
        rows.append(f"{name} {v % 2} {v % 2 * (1 + v % 3)}")
    split = os.path.join(root, "test.csv")
    with open(split, "w") as f:
        f.write("\n".join(rows) + "\n")
    weights = os.path.join(root, "checkpoint_0")
    model = _model(torch.float32)
    torch.save({"params": dict(model.named_parameters()),
                "batch_stats": dict(model.named_buffers())}, weights)
    return faces, split, weights


def _evaluate(root, mesh=None) -> dict:
    from mintime_torch.evaluate import evaluate_split

    faces, split, weights = (os.path.join(root, n) for n in ("faces", "test.csv", "checkpoint_0"))
    cfg = MintimeConfig(model=CFG)
    return evaluate_split(cfg, weights, split, faces, batch_size=4, workers=1, device="cpu",
                          fused_attention=1, mesh=mesh)


def dp_evaluate(root):
    from mintime_torch.parallel.mesh import make_mesh

    return _evaluate(root, make_mesh(device="cpu"))


def test_dp2_evaluate_report_matches_one_process(tmp_path):
    _write_split(tmp_path)
    runs = _spawn("dp_evaluate", (str(tmp_path),), tmp_path)
    one = _evaluate(str(tmp_path))
    assert one["n_videos"] == 7
    for dp in runs:
        assert dp["n_videos"] == one["n_videos"]
        for key in ("accuracy", "f1", "positive", "negative"):
            assert dp[key] == one[key], key
        np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-5)
        assert dp.get("per_method_errors") == one.get("per_method_errors")


def test_loader_shards_and_drops_the_last_batch():
    from mintime_torch.data.loader import DataLoader

    class Items:
        def __len__(self):
            return 7

        def load(self, i):
            return {"crops": [], "labels": np.float32(i)}

        def transform_crops(self, crops, steps=None):
            return None

    def labels(loader):
        return [b["labels"].tolist() if b else [] for b in loader]

    kw = dict(shuffle=False, num_workers=1, worker_mode="thread")
    full = DataLoader(Items(), 3, **kw)
    assert len(full) == 3 and len(DataLoader(Items(), 3, drop_last=True, **kw)) == 2
    assert labels(DataLoader(Items(), 3, drop_last=True, **kw)) == [[0, 1, 2], [3, 4, 5]]
    ranks = [labels(DataLoader(Items(), 3, shard=(r, 2), **kw)) for r in range(2)]
    assert ranks == [[[0], [3], []], [[1, 2], [4, 5], [6]]]


def test_loader_pads_a_batch_shorter_than_the_ranks():
    """With ``pad_short``, a last batch of one row reaches both ranks: the
    row and its repeat, marked ``valid`` 0; full batches carry no ``valid``."""
    from mintime_torch.data.loader import DataLoader
    from mintime_torch.parallel.mesh import pad_rows

    class Items:
        def __len__(self):
            return 7

        def load(self, i):
            return {"crops": [], "labels": np.float32(i)}

        def transform_crops(self, crops, steps=None):
            return None

    kw = dict(shuffle=False, num_workers=1, worker_mode="thread", pad_short=True)
    ranks = [[(b["labels"].tolist(), b.get("valid", np.ones(0)).tolist())
              for b in DataLoader(Items(), 3, shard=(r, 2), **kw)] for r in range(2)]
    assert ranks == [[([0], []), ([3], []), ([6], [1.0])],
                     [([1, 2], []), ([4, 5], []), ([6], [0.0])]]
    assert pad_rows(3, 4).tolist() == [0, 1, 2, 0, 1, 2]
    assert pad_rows(2, 4).tolist() == [0, 1, 0, 1]
    assert pad_rows(5, 4).tolist() == list(range(5)) and pad_rows(0, 4).tolist() == []


def test_make_mesh_raises_without_the_environment(monkeypatch):
    import torch.distributed as dist

    from mintime_torch.parallel.mesh import make_mesh

    if dist.is_initialized():
        pytest.skip("a process group is live in this process")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError):
        make_mesh(device="cpu")


class _Detector:
    """Two face boxes a frame (half-res coordinates): two identities."""

    def detect(self, frame):
        h, w = frame.shape[:2]
        return np.array([[w * 0.05, h * 0.1, w * 0.45, h * 0.6, 0.99],
                         [w * 0.55, h * 0.3, w * 0.9, h * 0.8, 0.98]])


def _embedder(crops):
    """Left and right faces are two identities (crops come two a frame)."""
    out = np.zeros((len(crops), 8))
    out[np.arange(len(crops)), np.arange(len(crops)) % 2] = 1.0
    return out


def _predict(paths, mesh=None):
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.predict import predict_videos

    model = MintimeVideoClassifier(CFG, require_attention=True, use_kernels=True, device="cpu",
                                   seed=3)
    out = predict_videos(paths, model, None, MintimeConfig(model=CFG), _Detector(), _embedder,
                         batch_size=2, mesh=mesh)
    return [(r.probability, r.identity_attentions, list(r.identities), r.frames_per_identity)
            for r in out]


def dp_predict(paths):
    from mintime_torch.parallel.mesh import make_mesh

    return _predict(paths, make_mesh(device="cpu"))


def test_dp2_predict_videos_gives_every_rank_the_whole_list(tmp_path):
    """Three videos at batch 2: the ranks stage and score 1 + 1, then 0 + 1
    videos, and each ends with the three results in order, as one process
    gives them (probabilities within 1e-5: each row's forward at another
    batch size)."""
    cv2 = pytest.importorskip("cv2")

    paths = []
    for v, frames in enumerate((30, 20, 30)):
        path = str(tmp_path / f"v{v}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        rng = np.random.default_rng(v)
        for _ in range(frames):
            writer.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
        writer.release()
        paths.append(path)
    runs = _spawn("dp_predict", (paths,), tmp_path)
    one = _predict(paths)
    assert len(one) == 3
    for run in runs:
        assert len(run) == 3
        for (p, att, ids, fpi), (p1, att1, ids1, fpi1) in zip(run, one):
            assert ids == ids1 and fpi == fpi1
            np.testing.assert_allclose(p, p1, atol=1e-5)
            np.testing.assert_allclose(att, att1, atol=1e-3)


def _main(root, mesh_env: bool, bs: int = 4) -> dict:
    """``train_loop.main`` for one epoch of the 7-video split (batches of 4
    and 3 videos, or at ``bs`` 3 of 3, 3 and 1) with ``root``'s outputs; the
    logged scalars by epoch."""
    import json

    from mintime_torch import train_loop

    faces, split = os.path.join(root, "faces"), os.path.join(root, "test.csv")
    cfg = MintimeConfig(model=CFG, training=TrainingConfig(
        lr=0.05, weight_decay=1e-3, bs=bs, val_bs=bs, optimizer="SGD", scheduler="cosinelr",
        augmentation="min"))
    out = os.path.join(root, "dp" if mesh_env else "one")
    result = train_loop.main(["--train_list_file", split, "--validation_list_file", split,
                              "--data_path", faces, "--num_epochs", "0", "--workers", "1",
                              "--models_output_path", os.path.join(out, "models"),
                              "--logger_name", os.path.join(out, "runs"), "--device", "cpu"],
                             config=cfg)
    scalars = {}
    path = os.path.join(out, "runs", "scalars.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                scalars.setdefault(row["step"], {})[row["tag"]] = row["value"]
    return {"epochs_run": result.epochs_run, "checkpoints": result.checkpoints,
            "scalars": scalars}


def dp_main(root, bs=4):
    return _main(root, True, bs)


def test_dp2_train_loop_main_matches_one_process(tmp_path):
    """Two ranks through the CLI's function, as ``torchrun --nproc_per_node 2``
    starts it (``WORLD_SIZE`` in the environment): rank 0 alone logs, both
    return the same checkpoints, and the logged losses and accuracies equal
    one process's (fp32; the losses within 1e-4 relative)."""
    _check_main(tmp_path, 4)


def test_dp2_train_loop_main_pads_a_one_row_batch(tmp_path):
    """As above at batch 3: the last training batch has one row, which the
    train loader pads with its repeat (``valid`` 0) so that each rank trains
    on a row; the epoch's losses and accuracies still equal one process's."""
    _check_main(tmp_path, 3)


def _check_main(tmp_path, bs: int):
    _write_split(tmp_path)
    runs = _spawn("dp_main", (str(tmp_path), bs), tmp_path)
    one = _main(str(tmp_path), False, bs)
    assert one["epochs_run"] == 1 and sorted(one["scalars"]) == [0]
    assert runs[0]["scalars"].keys() == one["scalars"].keys()
    for epoch, row in one["scalars"].items():
        got = runs[0]["scalars"][epoch]
        for tag, value in row.items():
            if tag.endswith("Accuracy") or tag.endswith("Rate"):
                assert got[tag] == value, (epoch, tag)
            else:
                np.testing.assert_allclose(got[tag], value, rtol=1e-4, err_msg=tag)
    assert [os.path.basename(c) for c in runs[0]["checkpoints"]] == \
        [os.path.basename(c) for c in runs[1]["checkpoints"]] == \
        [os.path.basename(c) for c in one["checkpoints"]]
    with open(tmp_path / "dp" / "runs" / "scalars.jsonl") as f:  # one writer: 5 tags
        assert len(f.read().splitlines()) == 5
