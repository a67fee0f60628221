"""Port's EfficientNet-B0 feature map vs the Flax model on the same weights,
fp32 on the CPU.

Sizes 32 and 33: at 33 px every stride-2 convolution sees an odd input, where
XLA's SAME padding puts the extra row and column at the bottom and right.
Tolerance 1e-4 (absolute and relative): sixteen blocks of convolutions summed
in another order by XLA and by PyTorch's CPU kernels, on features of order 1.
"""

import jax
import numpy as np
import pytest
import torch

from mintime_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from mintime_torch.convert import efficientnet_state_dict
from mintime_torch.models.efficientnet import EfficientNet, same_pad


def random_variables(module, *args, seed=0):
    """Variables of a Flax module drawn with numpy from the shapes of its
    init (``jax.eval_shape``, which traces but compiles nothing: compiling
    EfficientNet's init takes some 15 s on a CPU). Convolution kernels are LeCun
    normal, every other kernel, embedding and token N(0, 0.02) as the JAX
    package's TimeSformer draws them; BatchNorm gets random statistics and
    affine terms so it is not the identity; other biases are zero and
    LayerNorm scales one."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [str(getattr(k, "key", k)) for k in path]
        last, shape = names[-1], leaf.shape
        in_bn = any(n.startswith("bn") for n in names)
        if last == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif last == "mean" or (in_bn and last == "bias"):
            a = rng.standard_normal(shape) * 0.1
        elif in_bn and last == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif last == "scale":
            a = np.ones(shape)
        elif last.endswith("bias"):
            a = np.zeros(shape)
        elif last == "kernel" and len(shape) == 4:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = rng.standard_normal(shape) * 0.02
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("size", [32, 33])
def test_feature_map_matches_flax(size):
    model = JaxEfficientNet("efficientnet-b0")
    variables = random_variables(model, np.zeros((1, size, size, 3), np.float32))
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(variables, x))
    port = EfficientNet("efficientnet-b0").eval()
    port.load_state_dict(efficientnet_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, -(-size // 32), -(-size // 32), 1280)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (33, 3, 2, (1, 1)), (32, 3, 2, (0, 1)), (16, 5, 2, (1, 2)), (17, 5, 2, (2, 2)),
    (7, 3, 1, (1, 1)), (7, 1, 1, (0, 0)),
])
def test_same_pad_is_xla_same(size, kernel, stride, pads):
    assert same_pad(size, kernel, stride) == pads
