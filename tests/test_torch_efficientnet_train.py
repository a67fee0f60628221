"""Port's EfficientNet-B0 in train mode vs the Flax model on the same weights,
fp32 on the CPU, at 64 px with drop-connect off: the output, every parameter
gradient and the updated BatchNorm statistics (running mean and flax's
biased running variance). Then drop-connect on its own.

Tolerances: output 1e-4 as the eval-mode test; gradients 1e-3 relative with
an absolute floor of 1e-3 of the largest gradient of each tensor (sixteen
blocks of train-mode BatchNorm, whose backward divides by batch standard
deviations taken over as few as 16 values at the last stage, summed in
another order by XLA and PyTorch's CPU kernels; measured 7e-5), and for every
tensor a floor of 1e-6 of the largest gradient in the network: the ``_bn2``
biases have a gradient of zero in exact arithmetic (a per-channel constant
ahead of a convolution and a train-mode BatchNorm), so both sides hold only
round-off there. Statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from mintime_torch.convert import efficientnet_state_dict
from mintime_torch.models import efficientnet as port_eff
from mintime_torch.models.efficientnet import EfficientNet
from test_torch_efficientnet import random_variables


def _jax_train_step(variables, x, cot):
    model = JaxEfficientNet("efficientnet-b0", drop_connect_rate=0.0)

    def loss(params):
        out, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return np.asarray(out), grads, stats


def test_train_mode_matches_flax():
    size = 64
    variables = random_variables(JaxEfficientNet("efficientnet-b0"),
                                 np.zeros((1, size, size, 3), np.float32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    cot = rng.standard_normal((4, 2, 2, 1280)).astype(np.float32)
    want_out, grads, stats = _jax_train_step(variables, x, cot)

    port = EfficientNet("efficientnet-b0", drop_connect_rate=0.0)
    port.load_state_dict(efficientnet_state_dict(variables), strict=True)
    port.train()
    out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-4, rtol=1e-4)
    (out * torch.from_numpy(cot)).sum().backward()

    # the JAX gradients and new statistics in the port's key names
    want = efficientnet_state_dict({"params": grads, "batch_stats": stats})
    params = dict(port.named_parameters())
    buffers = dict(port.named_buffers())
    assert set(want) == set(params) | set(buffers)
    floor = 1e-6 * max(float(want[name].abs().max()) for name in params)
    for name, ref in want.items():
        ref = ref.numpy()
        if name in params:
            got = params[name].grad.numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-3,
                                       atol=max(1e-3 * np.abs(ref).max(), floor),
                                       err_msg=f"grad of {name}")
        else:  # running_mean, and the biased running_var of flax
            np.testing.assert_allclose(buffers[name].numpy(), ref, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    assert not any(name.endswith("num_batches_tracked") for name in buffers)


def test_running_var_takes_the_biased_batch_variance():
    bn = port_eff.BatchNorm(3).train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 2, 2)).astype(np.float32))
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var)
    torch.testing.assert_close(bn.running_mean, 0.01 * x.mean(dim=(0, 2, 3)))


def test_drop_connect_mask_and_scale():
    """Whole samples dropped or scaled by 1/keep; the mask is the CPU
    generator's first draws, so one seed gives one mask."""
    x = torch.ones(64, 3, 2, 2)
    out = port_eff.drop_connect(x, 0.25, torch.Generator().manual_seed(3))
    keep = torch.rand(64, generator=torch.Generator().manual_seed(3)) < 0.75
    torch.testing.assert_close(out, keep.float()[:, None, None, None] / 0.75 * x)
    assert 0 < int(keep.sum()) < 64


def test_drop_connect_only_on_residual_blocks_in_train_mode(monkeypatch):
    calls = []
    real = port_eff.drop_connect

    def record(x, rate, generator):
        calls.append(rate)
        return real(x, rate, generator)

    monkeypatch.setattr(port_eff, "drop_connect", record)
    net = EfficientNet("efficientnet-b0")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32))
    blocks = port_eff.expand_blocks("efficientnet-b0")
    residual = [i for i, a in enumerate(blocks) if a.stride == 1 and a.in_filters == a.out_filters]
    with torch.no_grad():
        net.eval()(x)
        assert calls == []  # none in eval mode
        a = net.train()(x, generator=torch.Generator().manual_seed(5))
        assert calls == pytest.approx([0.2 * i / len(blocks) for i in residual])
        b = net(x, generator=torch.Generator().manual_seed(5))
        c = net(x, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b)  # the same masks from the same seed
    assert not torch.equal(a, c)
