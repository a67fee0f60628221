"""One train step of the full classifier (EfficientNet-B0 + TimeSformer) at
64 px: the port's ``make_train_step`` against ``mintime_tpu.train.
make_train_step`` on the same weights, batch and SGD, fp32 on the CPU.

With ``freeze_backbone`` the step is deterministic (the backbone runs in eval
mode and only decays), so every parameter and statistic is held at the SGD
rule of ``tests/test_train_step_parity.py`` (rtol 5e-4, atol 5e-6).

With the backbone trainable, drop-connect is off on both sides: the JAX
classifier fixes its backbone's rate at 0.2, so the test builds it with
``mintime_tpu.models.classifier.EfficientNet`` replaced by the same module at
rate 0 (the JAX package itself is unchanged). The updates ``p1 - p0`` are
compared at the tolerances of ``tests/test_torch_efficientnet_train.py``'s
gradients (rtol 1e-3, atol 1e-3 of the tensor's largest update and 1e-6 of
the network's, and two ulps of the parameter, to which ``p1 - p0`` is exact),
because an SGD update is the gradient times the learning
rate plus a decay term that both sides compute alike. The BatchNorm
statistics at 1e-4 relative: flax takes the batch variance as E[x^2] - E[x]^2,
which loses digits where the mean is large against the spread, as at the stem
over raw 0-255 pixels (measured 4.4e-5 there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mintime_tpu import train as jax_train
from mintime_tpu.config import MintimeConfig as JaxMintimeConfig
from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.config import TrainingConfig as JaxTrainingConfig
from mintime_tpu.models import classifier as jax_classifier
from mintime_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from mintime_torch import train as port_train
from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig
from mintime_torch.convert import classifier_state_dict, load_jax_variables
from mintime_torch.models.classifier import MintimeVideoClassifier
from test_torch_efficientnet import random_variables

KW = dict(image_size=64, num_frames=8, num_patches=4, channels=1280, dim=32, depth=1, heads=2,
          dim_head=16, max_identities=2)
TRAIN = dict(lr=0.05, weight_decay=1e-3, optimizer="SGD", scheduler="cosinelr")
POS_WEIGHT = 1.7


def _batch():
    rng = np.random.default_rng(0)
    F = KW["num_frames"]
    mask = np.ones((2, F), bool)
    mask[1, 6:] = False
    ids = np.ones((2, F, F), bool)
    ids[0, :4, 4:] = ids[0, 4:, :4] = False
    return {"frames": rng.integers(0, 256, (2, F, 64, 64, 3), dtype=np.uint8), "mask": mask,
            "identities_mask": ids, "size_embedding": rng.integers(1, 21, (2, F)).astype(np.int32),
            "positions": np.tile(np.arange(1 + F * 4, dtype=np.int32), (2, 1)),
            "labels": np.array([0.0, 1.0], np.float32)}


def _steps(freeze_backbone):
    batch = _batch()
    args = [batch[k] for k in ("frames", "mask", "identities_mask", "size_embedding", "positions")]
    jmodel = jax_classifier.MintimeVideoClassifier(JaxModelConfig(**KW),
                                                   freeze_backbone=freeze_backbone)
    variables = random_variables(jmodel, *args)
    jcfg = JaxMintimeConfig(model=JaxModelConfig(**KW), training=JaxTrainingConfig(**TRAIN))
    tx = jax_train.make_optimizer(jcfg, jax_train.make_schedule(jcfg, 2, 2))
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]), tx=tx)
    jstate, jmetrics = jax.jit(jax_train.make_train_step(jmodel, POS_WEIGHT))(
        jstate, batch, jax.random.key(0))

    cfg = MintimeConfig(model=ModelConfig(**KW), training=TrainingConfig(**TRAIN))
    model = MintimeVideoClassifier(cfg.model, freeze_backbone=freeze_backbone, use_kernels=True,
                                   device="cpu")
    model.extractor.drop_connect_rate = 0.0
    load_jax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = port_train.create_train_state(model, cfg, steps_per_epoch=2, num_epochs=2)
    metrics = port_train.make_train_step(model, POS_WEIGHT)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=2e-5)
    want = classifier_state_dict(
        jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}),
        model.config)
    got = model.state_dict()
    assert set(got) == set(want)
    return before, got, want, dict(model.named_parameters())


def test_frozen_backbone_step_matches_jax():
    before, got, want, params = _steps(freeze_backbone=True)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=5e-4, atol=5e-6,
                                   err_msg=name)
    # the frozen backbone only decays, as under JAX's zero gradient
    w = "extractor._conv_stem.weight"
    torch.testing.assert_close(got[w], before[w] * (1 - TRAIN["lr"] * TRAIN["weight_decay"]))
    assert torch.equal(got["extractor._bn0.running_mean"], before["extractor._bn0.running_mean"])


def test_trainable_backbone_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_classifier, "EfficientNet",
                        functools.partial(JaxEfficientNet, drop_connect_rate=0.0))
    before, got, want, params = _steps(freeze_backbone=False)
    updates = {k: (want[k] - before[k]).numpy() for k in params}
    floor = 1e-6 * max(np.abs(u).max() for u in updates.values())
    for name, ref in want.items():
        if name in params:
            upd = updates[name]
            ulp = np.spacing(np.abs(before[name].numpy()).max())  # p1 - p0 is exact to an ulp of p
            np.testing.assert_allclose((got[name] - before[name]).numpy(), upd, rtol=1e-3,
                                       atol=max(1e-3 * np.abs(upd).max(), floor, 2 * ulp),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    assert not torch.equal(got["extractor._bn0.running_var"], before["extractor._bn0.running_var"])
