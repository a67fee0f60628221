"""SlowFast R-50 of the port (``mintime_torch.models.slowfast``) against the
JAX package's (``mintime_tpu.models.slowfast``), fp32 on the CPU.

Weights: a state_dict in pytorchvideo's ``slowfast_r50`` keys drawn with
numpy (convolutions He-normal, BatchNorm affine terms and statistics away
from the identity, the head N(0, 0.02)), carried to the JAX package through
its own ``slowfast_params_from_torch`` and back through
``convert.slowfast_state_dict``.

Each residual branch's last BatchNorm scale (``norm_c``) is drawn from
[0.05, 0.15]: pytorchvideo initialises it at 0, and with the other scales'
draw, [0.5, 1.5], sixteen bottlenecks make a random net whose fp32 gradients
are off their fp64 values by up to 48% of a tensor's largest (measured on
both sides alike; an fp64 run's gradients moved 3.7% under a 1e-9 change of
the input). At these scales fp32 rounding moves the running statistics of a
train-mode forward by 1e-5 on each side.

Tolerances are the JAX package's own (``tests/test_slowfast_numerics.py``):
2e-5 per stage, logits atol 5e-3 / rtol 1e-3 for the whole net; the running
statistics of a train-mode forward 1e-5 relative for a stage, and rtol 1e-4
/ atol 2e-5 for the whole net. The front end is compared on its own, the JAX
classifier's network replaced inside the test by a module that returns its
inputs: bitwise without a resize, 2e-5 with one. One SGD step of the
classifier through both ``make_train_step``\\ s at
``tests/test_torch_train.py``'s rule (loss 2e-5 relative; rtol 5e-4, atol
5e-6 per parameter and statistic) at the flagship's learning rate 0.01.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mintime_torch import train as port_train
from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig
from mintime_torch.convert import load_jax_variables, slowfast_state_dict
from mintime_torch.models import slowfast as port_sf
from mintime_tpu import train as jax_train
from mintime_tpu.config import MintimeConfig as JaxMintimeConfig
from mintime_tpu.config import TrainingConfig as JaxTrainingConfig
from mintime_tpu.models import slowfast as jax_sf
from mintime_tpu.utils.torch_convert import slowfast_params_from_torch
from test_slowfast_numerics import make_state_dict

#: the classifier's toy front end: 8 fast / 2 slow frames at 32 px
TOY = dict(num_frames=8, side_size=32, crop_size=32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test: the parallel test run's workers share the
    cores, and torch's default of one thread a core oversubscribes them (a
    test of this file took 50 times its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_state_dict(model: torch.nn.Module, seed: int = 0) -> dict:
    """Every entry of the port's state_dict drawn with numpy at its shape."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("proj.weight"):
            a = rng.standard_normal(shape) * 0.02
        elif k.endswith("proj.bias"):
            a = rng.standard_normal(shape) * 0.01
        elif v.dim() == 5:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("norm_c.weight"):  # a residual branch's last scale: see above
            a = rng.uniform(0.05, 0.15, shape)
        elif k.endswith((".running_var", ".weight")):  # BatchNorm scales and variances
            a = rng.uniform(0.5, 1.5, shape)
        else:  # BatchNorm shifts and running means
            a = rng.standard_normal(shape) * 0.1
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


@functools.lru_cache(maxsize=None)
def _weights():
    """(port state_dict, JAX SlowFastR50 variables) of one draw."""
    model = port_sf.SlowFastClassifier(device="cpu", **TOY)
    sd = random_state_dict(model)
    return sd, slowfast_params_from_torch(dict(sd))


def _classifier(sd=None, **kw):
    model = port_sf.SlowFastClassifier(device="cpu", **{**TOY, **kw})
    model.load_state_dict(_weights()[0] if sd is None else sd)
    return model


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _ncthw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def _nthwc(t):
    return t.detach().permute(0, 2, 3, 4, 1).numpy()


def test_keys_are_pytorchvideo_and_weights_cross_both_ways():
    sd, variables = _weights()
    reference = {k for k in make_state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == reference
    back = slowfast_state_dict(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the classifier's variables hold the net under "slowfast"
    nested = {"params": {"slowfast": variables["params"]},
              "batch_stats": {"slowfast": variables["batch_stats"]}}
    model = load_jax_variables(port_sf.SlowFastClassifier(device="cpu", **TOY), nested)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


#: (name, port module and its keys' prefix, JAX module and its variables' path, input shapes)
STAGES = {
    "stem": (lambda: port_sf.ConvBn3d(3, 8, (5, 7, 7), (1, 2, 2)),
             "blocks.0.multipathway_blocks.1.",
             lambda: jax_sf.ConvBn3d(8, (5, 7, 7), stride=(1, 2, 2)), ("fast_stem",),
             ((2, 8, 32, 32, 3),)),
    "bottleneck_with_shortcut": (
        lambda: port_sf.Bottleneck3d(80, 64, 256, 1, 1),
        "blocks.1.multipathway_blocks.0.res_blocks.0.",
        lambda: jax_sf.Bottleneck3d(64, 256, temporal_a=1, spatial_stride=1),
        ("slow_res2", "block_0"), ((2, 2, 16, 16, 80),)),
    "strided_temporal_bottleneck": (
        lambda: port_sf.Bottleneck3d(32, 16, 64, 3, 2),
        "blocks.2.multipathway_blocks.1.res_blocks.0.",
        lambda: jax_sf.Bottleneck3d(16, 64, temporal_a=3, spatial_stride=2),
        ("fast_res3", "block_0"), ((2, 8, 8, 8, 32),)),
    "lateral_fusion": (lambda: port_sf.LateralFusion(8), "blocks.0.multipathway_fusion.",
                       lambda: jax_sf.LateralFusion(8), ("fuse_stem",),
                       ((2, 2, 8, 8, 64), (2, 8, 8, 8, 8))),
}


def _stage(name):
    make_port, prefix, make_jax, path, shapes = STAGES[name]
    sd, variables = _weights()
    port = make_port()
    port.load_state_dict(_sub(sd, prefix))
    v = {c: functools.reduce(lambda d, p: d[p], path, variables[c])
         for c in ("params", "batch_stats")}
    rng = np.random.default_rng(len(name))
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return port, make_jax(), v, xs


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_matches_jax_in_eval_mode(name):
    port, jmod, v, xs = _stage(name)
    want = np.asarray(jmod.apply(v, *map(jnp.asarray, xs)))
    with torch.no_grad():
        got = _nthwc(port.eval()(*map(_ncthw, xs)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["stem", "bottleneck_with_shortcut", "lateral_fusion"])
def test_stage_train_mode_gives_flax_batch_statistics(name):
    """Train mode normalises with the batch's statistics and updates the
    running ones as flax does: momentum 0.9 and the biased variance."""
    port, jmod, v, xs = _stage(name)
    want, upd = jmod.apply(v, *map(jnp.asarray, xs), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = _nthwc(port.train()(*map(_ncthw, xs)))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)
    flat = jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]
    assert flat
    stats = dict(port.named_buffers())
    for path, leaf in flat:
        names = [str(getattr(k, "key", k)) for k in path]
        key = _port_stat_key(names)
        np.testing.assert_allclose(stats[key].numpy(), np.asarray(leaf), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    # the biased variance, by hand, at the stem
    if name == "stem":
        with torch.no_grad():
            y = port.conv(_ncthw(xs[0]))
        var = y.var(dim=(0, 2, 3, 4), unbiased=False)
        torch.testing.assert_close(port.norm.running_var, 0.9 * _weights()[0][
            "blocks.0.multipathway_blocks.1.norm.running_var"] + 0.1 * var)


def _port_stat_key(names):
    """JAX ``.../conv_a/bn/mean`` → the port's ``branch2.norm_a.running_mean``."""
    *mods, _, stat = names
    stat = "running_" + stat
    if not mods:
        return f"norm.{stat}"
    mod = mods[-1]
    if mod == "fuse":
        return f"norm.{stat}"
    if mod == "shortcut":
        return f"branch1_norm.{stat}"
    return f"branch2.norm_{mod[-1]}.{stat}"


def _clip(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 2, 32, 32, 3)).astype(np.float32),
            rng.standard_normal((1, 8, 32, 32, 3)).astype(np.float32))


def test_whole_net_logits_match_jax():
    sd, variables = _weights()
    slow, fast = _clip()
    want = np.asarray(jax.jit(jax_sf.SlowFastR50(num_classes=1).apply)(
        variables, jnp.asarray(slow), jnp.asarray(fast)))
    with torch.no_grad():
        got = _classifier().blocks(torch.from_numpy(slow), torch.from_numpy(fast)).numpy()
    assert np.abs(want).max() > 1e-2  # the logits are not all near 0
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)


def test_whole_net_train_mode_matches_jax():
    """Every BatchNorm's running statistics after one train-mode forward, and
    the logits, at a batch of two clips."""
    sd, variables = _weights()
    (s0, f0), (s1, f1) = _clip(5), _clip(6)
    slow, fast = np.concatenate([s0, s1]), np.concatenate([f0, f1])
    logits, upd = jax.jit(functools.partial(jax_sf.SlowFastR50(num_classes=1).apply, train=True,
                                            mutable=["batch_stats"]))(
        variables, jnp.asarray(slow), jnp.asarray(fast))
    model = _classifier()
    model.blocks.train()
    with torch.no_grad():
        got = model.blocks(torch.from_numpy(slow), torch.from_numpy(fast)).numpy()
    np.testing.assert_allclose(got, np.asarray(logits), atol=5e-3, rtol=1e-3)
    want = slowfast_state_dict({"params": variables["params"],
                                "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    moved = 0
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=k)
            moved += not torch.equal(v, sd[k])
    assert moved == sum("running" in k for k in sd)


class _Inputs(nn.Module):
    """Stands in for the JAX classifier's network: returns its inputs."""

    num_classes: int = 1
    dtype: object = None

    def __call__(self, slow, fast, train=False):
        return slow, fast


@pytest.mark.parametrize("side", [24, 32, 48, 40])
def test_front_end_matches_jax(monkeypatch, side):
    """Normalise, short-side resize (growing from 24 px, shrinking from 48
    px, none at 32), centre crop (a 40 x 56 frame) and the two pathways'
    frames, against the JAX classifier's front end."""
    monkeypatch.setattr(jax_sf, "SlowFastR50", _Inputs)
    rng = np.random.default_rng(side)
    w = side + 16 if side == 40 else side
    frames = rng.integers(0, 256, (2, 5, side, w, 3), dtype=np.uint8)
    jslow, jfast = jax_sf.SlowFastClassifier(**TOY).apply({}, jnp.asarray(frames))
    slow, fast = _classifier().front_end(torch.from_numpy(frames))
    assert tuple(fast.shape) == (2, 8, 32, 32, 3) and tuple(slow.shape) == (2, 2, 32, 32, 3)
    atol = 0 if side == 32 else 2e-5  # no resize: the same fp32 operations, bitwise
    np.testing.assert_allclose(fast.numpy(), np.asarray(jfast), atol=atol, rtol=0)
    np.testing.assert_allclose(slow.numpy(), np.asarray(jslow), atol=atol, rtol=0)


def test_temporal_index_truncates_as_jax():
    for frames in range(1, 40):
        for num in (1, 2, 4, 6, 7, 8, 16, 32):
            want = np.asarray(jnp.linspace(0, frames - 1, num).astype(jnp.int32))
            np.testing.assert_array_equal(port_sf.temporal_index(frames, num), want,
                                          err_msg=f"{frames} frames, {num}")
    # 16 → 32 lands on fractional indices, where truncation and rounding differ
    idx = port_sf.temporal_index(16, 32)
    assert (idx != np.round(np.linspace(0, 15, 32))).any()


def test_host_input_pack_matches_jax():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    for shape in ((20, 48, 64, 3), (12, 64, 40, 3), (9, 32, 32, 3)):
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
        got = port_sf.slowfast_input_pack(frames, num_frames=8, crop_size=32, side_size=32)
        want = jax_sf.slowfast_input_pack(frames, num_frames=8, crop_size=32, side_size=32)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)


LR, WD, POS_WEIGHT = 0.01, 1e-3, 1.7


def test_sgd_step_matches_jax():
    """One step of the classifier, front end included, through both
    ``make_train_step``\\ s: SGD with coupled decay, cosine schedule, BCE
    with ``pos_weight``. The frames are at the crop size, where the two front
    ends agree bitwise."""
    sd, variables = _weights()
    rng = np.random.default_rng(7)
    batch = {"frames": rng.integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8),
             "labels": np.array([0.0, 1.0], np.float32)}
    kw = dict(lr=LR, weight_decay=WD, optimizer="SGD", scheduler="cosinelr")
    jcfg = JaxMintimeConfig(training=JaxTrainingConfig(**kw))
    tx = jax_train.make_optimizer(jcfg, jax_train.make_schedule(jcfg, 2, 2))
    params = {"slowfast": variables["params"]}
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats={"slowfast": variables["batch_stats"]},
                                  opt_state=tx.init(params), tx=tx)
    jstate, jmetrics = jax.jit(jax_train.make_train_step(jax_sf.SlowFastClassifier(**TOY),
                                                         POS_WEIGHT))(
        jstate, batch, jax.random.key(0))
    jstate, jmetrics = jax.tree.map(np.asarray, (jstate.params, jstate.batch_stats)), \
        jax.tree.map(np.asarray, jmetrics)

    cfg = MintimeConfig(model=ModelConfig(), training=TrainingConfig(**kw))
    model = _classifier()
    state = port_train.create_train_state(model, cfg, steps_per_epoch=2, num_epochs=2)
    metrics = port_train.make_train_step(model, POS_WEIGHT)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=2e-5)
    for k in ("correct", "positive", "count"):
        assert float(metrics[k]) == float(jmetrics[k]), k
    want = slowfast_state_dict({"params": jstate[0], "batch_stats": jstate[1]})
    got = model.state_dict()
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=5e-4, atol=5e-6,
                                   err_msg=name)
    assert all(not torch.equal(got[k].float(), sd[k]) for k in got)  # every tensor moved
