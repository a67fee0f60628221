"""The port's extractor pretraining (``mintime_torch/pretrain_extractor.py``)
against the JAX package's (``mintime_tpu/pretrain_extractor.py``) on the CPU:

* ``collect_frames`` gives the JAX function's paths in its order on a PNG
  tree, and the same names on that tree packed (``crops.pack``, the PNGs
  removed);
* ``FramesDataset`` items (the ``min`` preset, and the evaluation transform)
  bitwise equal to the JAX ones, from the PNGs and from the packs;
* ``rebalance_frames`` and ``custom_video_round`` equal;
* one ``FrameClassifier`` SGD step (fp32, 32 px, drop-connect off on both
  sides as in ``tests/test_torch_train_classifier.py``) against the JAX step:
  the loss within 2e-5 relative, the logits after the step within 1e-4;
* ``export_extractor``'s file read strictly by the JAX package's
  ``efficientnet_params_from_torch`` and by ``load_model_state``;
* the CLI end to end for one epoch.
"""

import functools
import os

import numpy as np
import pytest
import torch

from mintime_torch import pretrain_extractor as port
from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig

cv2 = pytest.importorskip("cv2")

VIDEOS = ("real/v0", "fake/v1", "real/v2", "fake/v3")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root) -> str:
    """Videos of one or two identities, 7-12 frames of faces 0 and 1, two
    loose crops in one video folder, crops of 20-80 px."""
    rng = np.random.default_rng(3)
    for v, video in enumerate(VIDEOS):
        for ident in range(1 + v % 2):
            d = os.path.join(root, video, str(ident))
            os.makedirs(d)
            for f in range(7 + 2 * v + ident):
                for face in (0, 1):
                    side = int(rng.integers(20, 80))
                    cv2.imwrite(os.path.join(d, f"{15 * f}_{face}.png"),
                                rng.integers(0, 256, (side, side + 5, 3), dtype=np.uint8))
        if v == 2:
            for f in (7, 22):
                cv2.imwrite(os.path.join(root, video, f"{f}_0.png"),
                            rng.integers(0, 256, (30, 30, 3), dtype=np.uint8))
    return root


def _pack(root):
    from mintime_torch.data.crop_store import pack_video_dir

    for video in VIDEOS:
        pack_video_dir(os.path.join(root, video), remove_images=True)


@pytest.mark.parametrize("validation", [False, True])
def test_collect_frames_matches_jax_on_pngs_and_packs(tmp_path, validation):
    from mintime_tpu.pretrain_extractor import collect_frames as jax_collect

    root = _tree(str(tmp_path / "faces"))
    labels = [0.0, 1.0, 0.0, 1.0]
    args = (VIDEOS, labels, root, 4, 1.0, 0.5, validation)
    want = jax_collect(*args)
    assert port.collect_frames(*args) == want
    assert len(set(want[0])) == len(want[0]) > 4
    _pack(root)
    assert not any(f.endswith(".png") for _, _, fs in os.walk(root) for f in fs)
    assert port.collect_frames(*args) == want


@pytest.mark.parametrize("mode", ["train", "val"])
def test_frames_dataset_items_are_the_jax_ones_bitwise(tmp_path, mode):
    from mintime_tpu.pretrain_extractor import FramesDataset as JaxFramesDataset

    root = _tree(str(tmp_path / "faces"))
    paths, labels = port.collect_frames(VIDEOS, [0, 1, 0, 1], root, 6, 1.0, 1.0)
    jds = JaxFramesDataset(paths, labels, 32, mode=mode, augmentation="min", seed=5)
    want = [jds[i] for i in range(len(paths))]
    for packed in (False, True):
        if packed:
            _pack(root)
        ds = port.FramesDataset(paths, labels, 32, mode=mode, augmentation="min", seed=5,
                                device="cpu")
        for i, w in enumerate(want):
            got = ds[i]
            assert got["frames"].dtype == torch.uint8 and got["frames"].shape == (32, 32, 3)
            assert np.array_equal(got["frames"].numpy(), w["frames"]), (packed, i)
            assert got["labels"] == w["labels"]


def test_rebalance_and_video_round_match_jax():
    from mintime_tpu import pretrain_extractor as jax_pre

    paths = [f"p{i}" for i in range(20)]
    labels = [i % 3 == 0 for i in range(20)]
    assert port.rebalance_frames(paths, labels, 0.7, 0.4, 9) == \
        jax_pre.rebalance_frames(paths, labels, 0.7, 0.4, 9)
    for probs in ([0.1, 0.6, 0.9], [0.2, 0.3], []):
        assert port.custom_video_round(probs) == jax_pre.custom_video_round(probs)


def _frame_batch():
    rng = np.random.default_rng(0)
    return {"frames": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
            "labels": np.array([0.0, 1.0, 1.0, 0.0], np.float32)}


def test_frame_classifier_sgd_step_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from mintime_tpu import pretrain_extractor as jax_pre
    from mintime_tpu import train as jax_train
    from mintime_tpu.config import MintimeConfig as JaxMintimeConfig
    from mintime_tpu.config import ModelConfig as JaxModelConfig
    from mintime_tpu.config import TrainingConfig as JaxTrainingConfig
    from mintime_tpu.models import efficientnet as jax_eff
    from mintime_torch import train as port_train
    from mintime_torch.convert import efficientnet_state_dict
    from mintime_torch.models.frame_classifier import FrameClassifier
    from tests.test_torch_efficientnet import random_variables

    monkeypatch.setattr(jax_eff, "EfficientNet",
                        functools.partial(jax_eff.EfficientNet, drop_connect_rate=0.0))
    train_kw = dict(lr=0.05, weight_decay=1e-3, optimizer="SGD", scheduler="steplr",
                    step_size=15, gamma=0.1)
    batch = _frame_batch()
    jmodel = jax_pre.FrameClassifier()
    variables = random_variables(jmodel, batch["frames"].astype(np.float32))
    jcfg = JaxMintimeConfig(model=JaxModelConfig(image_size=32),
                            training=JaxTrainingConfig(**train_kw))
    tx = jax_train.make_optimizer(jcfg, jax_train.make_schedule(jcfg, 2, 2))
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]), tx=tx)
    jstate, jmetrics = jax.jit(jax_train.make_train_step(jmodel, 1.5))(
        jstate, batch, jax.random.key(0))
    jlogits = np.asarray(jmodel.apply({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats},
                                      batch["frames"].astype(np.float32)))

    model = FrameClassifier(device="cpu", param_dtype=torch.float32)
    model.extractor.drop_connect_rate = 0.0
    sd = {f"extractor.{k}": v for k, v in efficientnet_state_dict(
        {"params": variables["params"]["extractor"],
         "batch_stats": variables["batch_stats"]["extractor"]}).items()}
    sd["fc.weight"] = torch.from_numpy(np.asarray(variables["params"]["fc"]["kernel"]).T.copy())
    sd["fc.bias"] = torch.from_numpy(np.asarray(variables["params"]["fc"]["bias"]).copy())
    model.load_state_dict(sd, strict=True)
    cfg = MintimeConfig(model=ModelConfig(image_size=32), training=TrainingConfig(**train_kw))
    state = port_train.create_train_state(model, cfg, steps_per_epoch=2, num_epochs=2)
    metrics = port_train.make_train_step(model, 1.5)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=2e-5)
    with torch.no_grad():
        logits = model(torch.as_tensor(batch["frames"]), train=False).numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)


def test_export_extractor_reads_strictly_in_both_packages(tmp_path):
    from mintime_tpu.utils.torch_convert import efficientnet_params_from_torch
    from mintime_torch.convert import efficientnet_state_dict
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.models.frame_classifier import FrameClassifier
    from mintime_torch.utils.checkpoint import load_model_state

    model = FrameClassifier(device="cpu", param_dtype=torch.float32, seed=4)
    path = str(tmp_path / "Extractor_checkpoint0")
    port.export_extractor(model, path)
    sd = torch.load(path)
    want = {k[len("extractor."):]: v for k, v in model.state_dict().items()
            if k.startswith("extractor.")}
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    back = efficientnet_state_dict(efficientnet_params_from_torch(sd))  # and back to torch
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)

    cfg = ModelConfig(image_size=32, num_frames=8, num_patches=1, channels=1280, dim=32,
                      depth=1, heads=2, dim_head=16)
    clf = MintimeVideoClassifier(cfg, device="cpu", param_dtype=torch.float32, seed=1)
    head = str(tmp_path / "Model_checkpoint")
    torch.save({k[len("head."):]: v for k, v in clf.state_dict().items()
                if k.startswith("head.")}, head)
    state = load_model_state(clf, MintimeConfig(model=cfg), head, extractor_weights=path)
    clf.load_state_dict(state, strict=True)
    for k, v in want.items():
        assert torch.equal(clf.state_dict()[f"extractor.{k}"], v), k


def test_cli_one_epoch(tmp_path, capsys):
    root = _tree(str(tmp_path / "faces"))
    for name, rows in (("train.csv", VIDEOS), ("val.csv", VIDEOS[:2] + VIDEOS[3:])):
        with open(tmp_path / name, "w") as f:
            f.write("\n".join(f"{v} {int('fake' in v)} {int('fake' in v)}" for v in rows) + "\n")
    cfg = MintimeConfig(model=ModelConfig(image_size=32), training=TrainingConfig(
        lr=0.01, weight_decay=1e-7, bs=4, optimizer="SGD", scheduler="steplr", gamma=0.1,
        step_size=15, rebalancing_fake=0.5, rebalancing_real=1.0, frames_per_video=6,
        augmentation="min"))
    best = port.main(["--train_list_file", str(tmp_path / "train.csv"),
                      "--validation_list_file", str(tmp_path / "val.csv"),
                      "--data_path", root, "--num_epochs", "0", "--workers", "1",
                      "--models_output_path", str(tmp_path / "out"), "--device", "cpu"],
                     config=cfg)
    out = capsys.readouterr().out
    assert "Train images: 18 Validation images: 6" in out, out
    assert "#0/0 loss:" in out and "video_round_acc:" in out
    assert best == os.path.join(str(tmp_path / "out"), "Extractor_checkpoint0")
    assert os.path.exists(best) and os.path.exists(tmp_path / "out" / "checkpoint_0")
    assert all(np.isfinite(v.numpy()).all() for v in torch.load(best).values())


def test_the_loaders_workers_import_no_torch():
    """A spawned loader worker imports the dataset's module and, under
    ``python -m``, the CLI's: neither pulls in torch."""
    import subprocess
    import sys

    code = ("import sys, mintime_torch.pretrain_extractor, mintime_torch.data.frames\n"
            "assert 'torch' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120,
                   env={**os.environ, "PYTHONPATH": root})


def test_chip_smoke_pretrain_config_is_the_yaml():
    """``chip_smoke.py`` phase ``pretrain`` builds the config in code (the
    card's machine has no yaml): ``configs/extractor_pretraining.yaml``."""
    import chip_smoke

    from mintime_torch.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert chip_smoke.pretrain_config() == \
        load_config(os.path.join(root, "configs", "extractor_pretraining.yaml"))
