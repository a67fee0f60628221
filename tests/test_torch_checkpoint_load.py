"""The port's weight loading (``mintime_torch.utils.checkpoint``) vs the JAX
package's on the same files, fp32 on the CPU.

Reference-format files are written from seeded JAX variables through the JAX
package's exporters (``timesformer_params_to_torch``,
``efficientnet_params_to_torch``, ``xception_params_to_torch``,
``baseline_params_to_torch``); ``load_model_state`` reads them into the
port's classifier and ``load_model_variables`` into the JAX one, and both
score the same inputs. Tolerance: logits 1e-4, the JAX package's fp32 logits
tolerance.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from mintime_torch.config import ModelConfig
from mintime_torch.models.classifier import MintimeVideoClassifier
from mintime_torch.utils import checkpoint as port_ckpt
from mintime_tpu.config import MintimeConfig as JaxMintimeConfig
from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier
from mintime_tpu.utils import checkpoint as jax_ckpt
from mintime_tpu.utils import torch_convert
from test_torch_efficientnet import random_variables


def small_config(backbone: str) -> dict:
    """64 px: both backbones give a 2 x 2 map, so num_patches 4."""
    return dict(image_size=64, num_frames=8, num_patches=4,
                channels=2048 if backbone == "xception" else 1280, dim=64, depth=2, heads=2,
                dim_head=32, max_identities=2, mlp_dim=16)


def inputs(cfg: dict, seed=0):
    rng = np.random.default_rng(seed)
    F, n = cfg["num_frames"], cfg["num_patches"]
    frames = rng.integers(0, 256, (2, F, 64, 64, 3), dtype=np.uint8)
    mask = np.ones((2, F), bool)
    mask[1, 5:] = False
    id_mask = np.ones((2, F, F), bool)
    size_emb = rng.integers(1, 21, (2, F)).astype(np.int32)
    positions = np.tile(np.arange(1 + F * n, dtype=np.int32), (2, 1))
    return frames, mask, id_mask, size_emb, positions


def _save(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return path


def write_reference_files(variables, jcfg, backbone, head, out_dir, prefix=""):
    """The reference's ``Model_checkpoint`` (head) and ``Extractor_checkpoint``
    files of JAX variables, keys optionally under a DataParallel prefix."""
    params, stats = variables["params"], variables["batch_stats"]
    if head == "baseline":
        head_sd = torch_convert.baseline_params_to_torch(params["head"])
    else:
        head_sd = torch_convert.timesformer_params_to_torch(params["head"], jcfg)
    ext_vars = {"params": params["extractor"], "batch_stats": stats["extractor"]}
    if backbone == "xception":
        ext_sd = torch_convert.xception_params_to_torch(ext_vars)
    else:
        ext_sd = torch_convert.efficientnet_params_to_torch(ext_vars)
    head_path = _save({prefix + k: v for k, v in head_sd.items()},
                      os.path.join(out_dir, "Model_checkpoint3"))
    ext_path = _save({prefix + k: v for k, v in ext_sd.items()},
                     os.path.join(out_dir, "Extractor_checkpoint3"))
    return head_path, ext_path


@pytest.mark.parametrize("backbone,head,prefix", [
    ("efficientnet-b0", "timesformer", ""),
    ("xception", "timesformer", "module."),
    ("efficientnet-b0", "baseline", ""),
])
def test_reference_files_load_as_in_jax(backbone, head, prefix, tmp_path):
    cfg = small_config(backbone)
    x = inputs(cfg)
    jcfg = JaxModelConfig(**cfg)
    jmodel = JaxClassifier(jcfg, backbone=backbone, head=head)
    head_path, ext_path = write_reference_files(random_variables(jmodel, *x), jcfg, backbone,
                                                head, str(tmp_path), prefix)
    jvars = jax_ckpt.load_model_variables(jmodel, JaxMintimeConfig(model=jcfg), head_path,
                                          extractor_weights=ext_path)
    want = np.asarray(jax.jit(jmodel.apply)(jvars, *x))

    model = MintimeVideoClassifier(ModelConfig(**cfg), backbone=backbone, head=head,
                                   use_kernels=True, device="cpu")
    state = port_ckpt.load_model_state(model, None, head_path, extractor_weights=ext_path)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_the_ports_own_checkpoint_loads_whole(tmp_path):
    cfg = ModelConfig(**small_config("efficientnet-b0"))
    trained = MintimeVideoClassifier(cfg, device="cpu", param_dtype=torch.float32, seed=5)
    state = types.SimpleNamespace(model=trained, step=7,
                                  optimizer=torch.optim.SGD(trained.parameters(), lr=0.1))
    path = port_ckpt.save_train_state(str(tmp_path), state)
    fresh = MintimeVideoClassifier(cfg, device="cpu", seed=6)
    fresh.load_state_dict(port_ckpt.load_model_state(fresh, None, path))
    x = [torch.from_numpy(a) for a in inputs(small_config("efficientnet-b0"))]
    with torch.no_grad():
        torch.testing.assert_close(fresh(*x), trained(*x), atol=0, rtol=0)


def test_reference_head_without_extractor_weights_is_refused(tmp_path):
    model = MintimeVideoClassifier(ModelConfig(**small_config("efficientnet-b0")), device="cpu")
    path = _save({k[len("head."):]: v.numpy() for k, v in model.state_dict().items()
                  if k.startswith("head.")}, str(tmp_path / "Model_checkpoint0"))
    with pytest.raises(ValueError, match="extractor_weights"):
        port_ckpt.load_model_state(model, None, path)


def test_orbax_directory_and_conv_head_are_refused(tmp_path):
    model = MintimeVideoClassifier(ModelConfig(**small_config("efficientnet-b0")), device="cpu")
    with pytest.raises(ValueError, match="orbax checkpoint of the JAX package"):
        port_ckpt.load_model_state(model, None, str(tmp_path))
    path = _save({"cls_token": np.zeros((1, 1, 64), np.float32)}, str(tmp_path / "Model_c"))
    conv = types.SimpleNamespace(head_kind="conv_timesformer", backbone="efficientnet-b0")
    with pytest.raises(ValueError, match="no reference checkpoint format"):
        port_ckpt.load_model_state(conv, None, path)


@pytest.mark.parametrize("names,path", [
    ((), "Model_checkpoint12"),
    (("checkpoint_3", "checkpoint_12", "checkpoint_7"), "/runs/x/Extractor_checkpoint0"),
    (("checkpoint_2", "checkpoint_x", "checkpoint_2.123.tmp", "other"), "best_model"),
    (("checkpoint_1",), "checkpoint_41"),
])
def test_latest_checkpoint_and_epoch_from_name_match_jax(names, path, tmp_path):
    for name in names:
        (tmp_path / name).mkdir()
    assert port_ckpt.latest_checkpoint(str(tmp_path)) == jax_ckpt.latest_checkpoint(str(tmp_path))
    assert port_ckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    assert port_ckpt.epoch_from_name(path) == jax_ckpt.epoch_from_name(path)
