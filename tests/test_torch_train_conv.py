"""Port's training code on the Convolutional TimeSformer vs the JAX
package's, on the CPU in fp32, at ``tests/test_torch_conv_timesformer.py``'s
cut model (its time axis on the token-row path).

One SGD train step with kernels on in both (the JAX package's Pallas kernels
in interpret mode, the port's autograd Functions with their plain versions):
loss within 2e-5 relative, every updated parameter at rtol 5e-4 / atol 5e-6
(``tests/test_torch_train.py``'s tolerances), the frozen extractor's
BatchNorm statistics unchanged and its parameters moved by weight decay
alone. Then the eval step's logits and a ``fit`` epoch with a checkpoint
round trip.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_tpu import train as jax_train
from mintime_tpu.config import MintimeConfig as JaxMintimeConfig
from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.config import TrainingConfig as JaxTrainingConfig
from mintime_tpu.models.conv_timesformer import ConvolutionalTimeSformer as JaxConvTimeSformer
from mintime_torch import train as port_train
from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig
from mintime_torch.convert import conv_timesformer_state_dict, load_jax_variables
from mintime_torch.ops import token_rows
from mintime_torch.train_loop import fit
from mintime_torch.utils.checkpoint import restore_train_state
from test_torch_conv_timesformer import CONV_KW, batch, jax_variables

LR, WD, POS_WEIGHT = 0.05, 1e-3, 1.7
TRAIN_KW = dict(lr=LR, weight_decay=WD, optimizer="SGD", scheduler="cosinelr")


def _port_model():
    model = port_train.conv_training_model(ModelConfig(**CONV_KW), device="cpu")
    return load_jax_variables(model, jax_variables())


def _pcfg(**kw):
    return MintimeConfig(model=ModelConfig(**CONV_KW),
                         training=TrainingConfig(**{**TRAIN_KW, **kw}))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """One JAX train step from ``jax_variables``: (new variables, metrics)."""
    jcfg = JaxMintimeConfig(model=JaxModelConfig(**CONV_KW), training=JaxTrainingConfig(**TRAIN_KW))
    model = JaxConvTimeSformer(jcfg.model, use_pallas=True)
    v = jax_variables()
    tx = jax_train.make_optimizer(jcfg, jax_train.make_schedule(jcfg, 4, 3))
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                 batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                                 tx=tx)
    state, metrics = jax.jit(jax_train.make_train_step(model, POS_WEIGHT))(
        state, batch(), jax.random.key(0))
    new = {"params": jax.tree.map(np.asarray, state.params),
           "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}
    return new, {k: float(m) for k, m in metrics.items()}


def test_train_step_matches_jax():
    jvars, jmetrics = _jax_step()
    model = _port_model()
    state = port_train.create_train_state(model, _pcfg(), steps_per_epoch=4, num_epochs=3)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    token_rows.reset_launches()
    metrics = port_train.make_train_step(model, POS_WEIGHT)(state, batch())
    assert state.step == 1 and token_rows.launches == 0

    np.testing.assert_allclose(float(metrics["loss"]), jmetrics["loss"], rtol=2e-5)
    for k in ("correct", "positive", "count"):
        assert float(metrics[k]) == jmetrics[k], k
    want = conv_timesformer_state_dict(jvars, model.config)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=5e-4, atol=5e-6,
                                   err_msg=name)
    # the frozen extractor: statistics unchanged, parameters moved by decay alone
    assert all(torch.equal(v, stats0[k]) for k, v in model.named_buffers())
    for name, p in model.named_parameters():
        if name.startswith("extractor."):
            torch.testing.assert_close(p.detach(), params0[name] * (1 - LR * WD))
        else:
            assert not torch.equal(p.detach(), params0[name] * (1 - LR * WD)), name


def test_eval_step_logits_match_jax():
    b = batch(seed=3)
    jmodel = JaxConvTimeSformer(JaxModelConfig(**CONV_KW), use_pallas=True)
    out = jax.jit(jax_train.make_eval_step(jmodel, POS_WEIGHT))(
        jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=jax_variables()["params"],
                             batch_stats=jax_variables()["batch_stats"], opt_state=None, tx=None),
        b)
    model = _port_model()
    got = port_train.make_eval_step(model, POS_WEIGHT)(None, b)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(out["logits"]), atol=1e-4,
                               rtol=1e-4)
    assert float(got["loss"]) == pytest.approx(float(out["loss"]), rel=1e-4)


def test_fit_epoch_and_checkpoint_round_trip(tmp_path):
    """One epoch (``num_epochs=0``) of two steps: a checkpoint of parameters,
    extractor statistics, optimizer state and step that a fresh model
    restores, giving the same validation loss."""
    def batches(seeds):
        return [{**batch(seed=s), "labels": np.array([s % 2, 1 - s % 2], np.float32)}
                for s in seeds]

    pcfg = _pcfg()
    state = port_train.create_train_state(_port_model(), pcfg, steps_per_epoch=2, num_epochs=0)
    train, val = batches([10, 11]), batches([20])
    state, result = fit(state, train, val, pcfg, num_epochs=0, pos_weight=1.0,
                        models_output_path=str(tmp_path / "models"),
                        log_dir=str(tmp_path / "runs"))
    assert result.epochs_run == 1 and state.step == 2
    assert result.checkpoints and result.checkpoints[0].endswith("checkpoint_0")
    rows = [json.loads(line) for line in open(tmp_path / "runs" / "scalars.jsonl")]
    val_loss = [r["value"] for r in rows if r["tag"] == "Validation/Loss"]

    fresh = _port_model()
    restored = restore_train_state(result.checkpoints[0],
                                   port_train.create_train_state(fresh, pcfg, 2, 0))
    assert restored.step == 2
    for (name, p), q in zip(fresh.named_parameters(), state.model.parameters()):
        assert torch.equal(p, q), name
    loss = float(port_train.make_eval_step(fresh, 1.0)(restored, val[0])["loss"])
    assert loss == pytest.approx(val_loss[0], rel=1e-6)
