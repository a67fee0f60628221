"""Port's training code vs the JAX package's, on the CPU in fp32.

One train step of the TimeSformer head (``backbone="none"``) at
``tests/test_timesformer.py``'s ``SMALL``: the port's ``make_train_step``
against ``mintime_tpu.train.make_train_step`` on the same weights and batch,
kernels on in both (the JAX package's Pallas kernels in interpret mode, the
port's autograd Functions with their plain versions). Loss within 2e-5
relative; every updated parameter compared in the port's key names, SGD at
rtol 5e-4 / atol 5e-6 and Adam/AdamW on the >= 99.9% rule of
``tests/test_train_step_parity.py:125-146``. Then the loss, the schedules and
the optimizers against optax, the partial-unfreeze mask, ``fit``, and the
repair of kernel wrappers that dropped gradients.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mintime_tpu import train as jax_train
from mintime_tpu.config import MintimeConfig as JaxMintimeConfig
from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.config import TrainingConfig as JaxTrainingConfig
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier
from mintime_torch import train as port_train
from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig
from mintime_torch.convert import classifier_state_dict, load_jax_variables
from mintime_torch.models.classifier import MintimeVideoClassifier, init_weights
from mintime_torch.models.timesformer import SizeInvariantTimeSformer
from mintime_torch.ops import divided_attention, geglu_ffn
from mintime_torch.train_loop import fit
from mintime_torch.utils.checkpoint import restore_train_state
from tests.test_timesformer import SMALL, make_inputs

LR, WD, POS_WEIGHT = 0.05, 1e-3, 1.7
SMALL_KW = {f: getattr(SMALL, f) for f in ("num_frames", "num_patches", "channels", "dim", "depth",
                                           "heads", "dim_head", "max_identities")}


def _configs(optimizer, scheduler="cosinelr"):
    kw = dict(lr=LR, weight_decay=WD, optimizer=optimizer, scheduler=scheduler, step_size=2)
    return (JaxMintimeConfig(model=SMALL, training=JaxTrainingConfig(**kw)),
            MintimeConfig(model=ModelConfig(**SMALL_KW), training=TrainingConfig(**kw)))


def _batch(seed=0):
    x, mask, id_mask, size_emb, positions = make_inputs(SMALL, seed=seed)
    return {"frames": x, "mask": mask, "identities_mask": id_mask, "size_embedding": size_emb,
            "positions": positions, "labels": np.array([0.0, 1.0], np.float32)}


@functools.lru_cache(maxsize=None)
def _head_params():
    """JAX head variables, initialised once (plain path: same parameter tree)."""
    b = _batch()
    model = JaxClassifier(SMALL, backbone="none", head="timesformer")
    args = [b[k] for k in ("frames", "mask", "identities_mask", "size_embedding", "positions")]
    return jax.jit(model.init)(jax.random.key(0), *args)["params"]


def _jax_step(optimizer, params, batch):
    jcfg, _ = _configs(optimizer)
    model = JaxClassifier(SMALL, backbone="none", head="timesformer", use_pallas=True)
    tx = jax_train.make_optimizer(jcfg, jax_train.make_schedule(jcfg, 4, 3))
    # a placeholder collection: with empty batch_stats the JAX step passes
    # mutable=[] and flax returns (logits, {}), which train.py:212 takes for
    # the logits (ROADMAP queue 3)
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats={"unused": jnp.zeros(())},
                                 opt_state=tx.init(params), tx=tx)
    state, metrics = jax.jit(jax_train.make_train_step(model, POS_WEIGHT))(
        state, batch, jax.random.key(0))
    return state, metrics


def _port_model(params, use_kernels=True):
    _, pcfg = _configs("SGD")
    model = MintimeVideoClassifier(pcfg.model, backbone="none", head="timesformer",
                                   use_kernels=use_kernels, device="cpu")
    return load_jax_variables(model, {"params": params})


@pytest.mark.parametrize("optimizer", ["SGD", "Adam", "AdamW"])
def test_head_train_step_matches_jax(optimizer):
    params = _head_params()
    batch = _batch()
    jstate, jmetrics = _jax_step(optimizer, params, batch)

    _, pcfg = _configs(optimizer)
    model = _port_model(params)
    state = port_train.create_train_state(model, pcfg, steps_per_epoch=4, num_epochs=3)
    metrics = port_train.make_train_step(model, POS_WEIGHT)(state, batch)
    assert state.step == 1

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=2e-5)
    for k in ("correct", "positive", "count"):
        assert float(metrics[k]) == float(jmetrics[k]), k
    want = classifier_state_dict({"params": jax.tree.map(np.asarray, jstate.params)},
                                 model.config, "none", "timesformer")
    got = model.state_dict()
    assert set(got) == set(want)
    for name, ref in want.items():
        leaf, ref = got[name].numpy(), ref.numpy()
        if optimizer == "SGD":
            np.testing.assert_allclose(leaf, ref, rtol=5e-4, atol=5e-6, err_msg=name)
        else:
            close = np.isclose(leaf, ref, rtol=5e-4, atol=2e-5)
            assert close.mean() > 0.999, f"{name}: {(~close).sum()}/{close.size} beyond tolerance"
            assert np.abs(leaf - ref).max() < LR / 10, name


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 1)).astype(np.float32) * 3
    labels = np.array([0, 1, 1, 0, 1, 0], np.float32)
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)
    for weights in (None, valid):
        want = float(jax_train.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels), 1.7,
                                               None if weights is None else jnp.asarray(weights)))
        got = float(port_train.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                               1.7, None if weights is None else torch.from_numpy(weights)))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("scheduler", ["steplr", "cosinelr", "none"])
def test_schedule_matches_optax(scheduler):
    jcfg, pcfg = _configs("SGD", scheduler)
    want = jax_train.make_schedule(jcfg, 3, 4)
    got = port_train.make_schedule(pcfg, 3, 4)
    for step in range(0, 16):
        ref = float(want(step)) if callable(want) else want
        assert got(step) == pytest.approx(ref, rel=1e-6), step


@pytest.mark.parametrize("optimizer", ["SGD", "Adam", "AdamW"])
def test_optimizer_matches_optax(optimizer):
    """Three updates under the cosine schedule from the same gradients."""
    jcfg, pcfg = _configs(optimizer)
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = jax_train.make_optimizer(jcfg, jax_train.make_schedule(jcfg, 2, 2))
    jp, opt_state = {k: jnp.asarray(v) for k, v in p0.items()}, None
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = port_train.make_optimizer(pcfg, tp.items())
    schedule = port_train.make_schedule(pcfg, 2, 2)
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


def test_unknown_optimizer_raises():
    _, pcfg = _configs("RMSprop")
    with pytest.raises(ValueError, match="invalid optimizer"):
        port_train.make_optimizer(pcfg, {"a": torch.nn.Parameter(torch.zeros(1))}.items())


@pytest.mark.parametrize("blocks", [0, 3, 20])
def test_unfreeze_mask_matches_jax_and_frozen_stay_bitwise(blocks):
    """The same parameters frozen as the JAX mask (mapped to the port's key
    names), and a port step leaves the frozen ones bitwise unchanged."""
    kw = {**SMALL_KW, "image_size": 32, "num_patches": 1, "channels": 1280}
    cfg = ModelConfig(**kw)
    jmodel = JaxClassifier(JaxModelConfig(**kw))
    b = _batch()
    batch = {**b, "frames": np.random.default_rng(0).integers(0, 255, (2, 8, 32, 32, 3), np.uint8),
             "positions": np.tile(np.arange(9, dtype=np.int32), (2, 1))}
    args = [batch[k] for k in ("frames", "mask", "identities_mask", "size_embedding", "positions")]
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), jax.random.key(0), *args)
    jmask = jax_train.extractor_unfreeze_mask(blocks)(shapes["params"])
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), jmask, shapes["params"])
    stats = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), shapes["batch_stats"])
    want = classifier_state_dict({"params": as_arrays, "batch_stats": stats}, cfg)

    model = MintimeVideoClassifier(cfg, device="cpu")
    mask = port_train.extractor_unfreeze_mask(blocks)(dict(model.named_parameters()))
    for name, flag in mask.items():
        assert bool(want[name].all()) == flag and bool(want[name].any()) == flag, name
    assert sum(mask.values()) < len(mask)

    _, pcfg = _configs("SGD")
    state = port_train.create_train_state(model, pcfg, 1, 1, trainable_mask=mask)
    before = {k: v.clone() for k, v in model.named_parameters()}
    port_train.make_train_step(model, 1.0)(state, batch)
    moved = {name: not torch.equal(p, before[name]) for name, p in model.named_parameters()}
    assert not any(moved[k] for k, m in mask.items() if not m)
    assert any(moved[k] for k, m in mask.items() if m and k.startswith("extractor.")) == (blocks > 0)


def test_every_parameter_of_the_kernel_head_gets_a_gradient():
    """Repair of kernel wrappers that returned outputs without a grad_fn:
    with ``use_kernels`` every TimeSformer parameter (``to_qkv``, the norms,
    ``net.0``/``net.3``, ...) gets a non-zero gradient, and the kernel ops'
    outputs carry their Functions' grad_fn."""
    cfg = ModelConfig(**SMALL_KW)
    head = SizeInvariantTimeSformer(cfg, use_kernels=True)
    init_weights(head, torch.Generator().manual_seed(0))
    b = _batch()
    out = head(*(torch.from_numpy(b[k]) for k in ("frames", "mask", "identities_mask",
                                                   "size_embedding", "positions")))
    out.sum().backward()
    for name, p in head.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name
    x = torch.randn(3, 32, requires_grad=True)
    ff = head.layers[0][2].fn.net
    assert "GegluFFNFunction" in geglu_ffn.geglu_ffn(
        x, ff["0"].weight, ff["0"].bias, ff["3"].weight, ff["3"].bias).grad_fn.name()
    qkv = torch.randn(1, 2, 3, 3 * 32, requires_grad=True)
    o, _ = divided_attention.divided_attention(qkv, torch.randn(1, 1, 96), None, None,
                                               heads=2, dim_head=16)
    assert "DividedAttentionFunction" in o.grad_fn.name()


def _fit_batches(n, seed):
    out = []
    for i in range(n):
        b = _batch(seed=seed + i)
        b["labels"] = np.array([i % 2, 1 - i % 2], np.float32)
        out.append(b)
    return out


def test_fit_logs_checkpoints_and_restores(tmp_path):
    """Two epochs (``num_epochs=1`` runs epochs 0 and 1): the five scalar tags
    per epoch, a checkpoint each time the validation loss improves, and a
    restore that reproduces the checkpoint's validation loss."""
    _, pcfg = _configs("SGD")
    model = _port_model(_head_params())
    state = port_train.create_train_state(model, pcfg, steps_per_epoch=3, num_epochs=1)
    train, val = _fit_batches(3, 10), _fit_batches(2, 20)
    state, result = fit(state, train, val, pcfg, num_epochs=1, patience=5, pos_weight=1.0,
                        models_output_path=str(tmp_path / "models"), log_dir=str(tmp_path / "runs"))
    assert result.epochs_run == 2 and state.step == 6
    rows = [json.loads(line) for line in open(tmp_path / "runs" / "scalars.jsonl")]
    tags = {"Training/Loss", "Training/Accuracy", "Training/Learning_Rate", "Validation/Loss",
            "Validation/Accuracy"}
    assert {(r["tag"], r["step"]) for r in rows} == {(t, e) for t in tags for e in (0, 1)}
    assert any(name.startswith("events.out.tfevents") for name in os.listdir(tmp_path / "runs"))
    val_loss = {r["step"]: r["value"] for r in rows if r["tag"] == "Validation/Loss"}
    assert result.checkpoints and result.checkpoints[0].endswith("checkpoint_0")
    last = result.checkpoints[-1]
    epoch = int(last.rsplit("_", 1)[1])
    assert result.best_val_loss == val_loss[epoch]

    fresh = _port_model(_head_params())
    restored = restore_train_state(last, port_train.create_train_state(fresh, pcfg, 3, 1))
    assert restored.step == 3 * (epoch + 1)
    eval_step = port_train.make_eval_step(fresh, 1.0)
    loss = np.mean([float(eval_step(restored, b)["loss"]) for b in val])
    assert loss == pytest.approx(val_loss[epoch], rel=1e-6)


def test_fit_stops_early_after_patience(tmp_path):
    """With a learning rate of 0 the validation loss never improves after
    epoch 0, so ``patience=1`` stops after epoch 1 of 6."""
    _, pcfg = _configs("SGD")
    pcfg = MintimeConfig(model=pcfg.model, training=TrainingConfig(lr=0.0, optimizer="SGD"))
    state = port_train.create_train_state(_port_model(_head_params()), pcfg, 2, 5)
    _, result = fit(state, _fit_batches(2, 30), _fit_batches(1, 40), pcfg, num_epochs=5,
                    patience=1, models_output_path=str(tmp_path / "m"), log_dir=str(tmp_path / "r"))
    assert result.epochs_run == 2 and len(result.checkpoints) == 1


def test_pos_weight_from_labels_matches_jax():
    labels = [0, 0, 0, 1, 1, 0, 1]
    assert port_train.pos_weight_from_labels(labels) == jax_train.pos_weight_from_labels(labels)
