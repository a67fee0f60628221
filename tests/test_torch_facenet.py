"""The port's FaceNet embedder (``mintime_torch/preprocessing/facenet.py``,
``cluster_faces.py``) against the JAX package's, fp32 on the CPU, on one
facenet-pytorch-layout ``state_dict`` with randomised BatchNorm statistics
(``tests/test_facenet_numerics.py``'s).

Tolerances: each block 1e-5; the whole InceptionResnetV1 at 128 px
``atol=2e-4, rtol=1e-3``; the converter bitwise; the crop resize within one
uint8 level of PIL ``BILINEAR`` (the JAX embedder's resize); embeddings of
the two embedders 5e-3 (the resize's one-level differences, through a
last BatchNorm calibrated to the crops) and cluster memberships equal.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import jax.numpy as jnp  # noqa: E402

from mintime_torch.convert import facenet_state_dict  # noqa: E402
from mintime_torch.preprocessing import cluster_faces as port_cluster  # noqa: E402
from mintime_torch.preprocessing import facenet as port  # noqa: E402
from mintime_tpu.preprocessing import cluster_faces as jax_cluster  # noqa: E402
from mintime_tpu.preprocessing import facenet as jaxf  # noqa: E402
from test_facenet_numerics import _randomize_bn_stats  # noqa: E402


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(5)
    net = port.InceptionResnetV1().eval()
    _randomize_bn_stats(net, torch.Generator().manual_seed(6))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    return net, sd, jaxf.facenet_params_from_torch(sd)


def _sub(variables, name):
    return {"params": variables["params"][name], "batch_stats": variables["batch_stats"][name]}


BLOCKS = [
    # (port module path, JAX module, input channels, spatial size)
    ("conv2d_4b", lambda: jaxf.ConvBn(256, (3, 3), stride=2), 192, 9),
    ("repeat_1.2", jaxf.Block35, 256, 5),
    ("mixed_6a", jaxf.Mixed6a, 256, 9),
    ("repeat_2.7", jaxf.Block17, 896, 4),
    ("mixed_7a", jaxf.Mixed7a, 896, 7),
    ("repeat_3.0", jaxf.Block8, 1792, 3),
    ("block8", lambda: jaxf.Block8(relu=False, scale=1.0), 1792, 3),
]


@pytest.mark.parametrize("path,jax_cls,cin,side", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_blocks_match_jax(weights, path, jax_cls, cin, side):
    net, _, variables = weights
    module = net.get_submodule(path)
    x = np.random.default_rng(4).normal(size=(2, cin, side, side)).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    jax_name = path.replace(".", "_")
    want = jax_cls().apply(_sub(variables, jax_name), jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_inception_resnet_v1_matches_jax(weights):
    net, _, variables = weights
    crops = np.random.default_rng(7).integers(0, 255, (2, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        got = net(port.fixed_image_standardization(torch.from_numpy(crops).permute(0, 3, 1, 2)))
    want = jaxf.InceptionResnetV1().apply(variables, jaxf.fixed_image_standardization(crops))
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_state_dict_round_trips_bitwise(weights):
    _, sd, _ = weights
    with_head = dict(sd, **{"logits.weight": torch.zeros(8631, 512),
                            "logits.bias": torch.zeros(8631)})
    back = facenet_state_dict(jaxf.facenet_params_from_torch(with_head))
    assert back.keys() == sd.keys()
    for k in sd:
        if k.endswith("num_batches_tracked"):
            assert int(back[k]) == 0
        else:
            assert torch.equal(back[k], sd[k]), k


def test_facenet_pytorch_checkpoint_loads_directly(weights):
    """``logits.*`` (the classify head) and ``module.`` prefixes go; any
    other key that does not belong raises."""
    _, sd, _ = weights
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    ckpt["logits.weight"], ckpt["logits.bias"] = torch.zeros(8631, 512), torch.zeros(8631)
    net = port.load_facenet_state_dict(port.InceptionResnetV1(), ckpt)
    assert torch.equal(net.last_linear.weight, sd["last_linear.weight"])
    with pytest.raises(RuntimeError, match="Unexpected key"):
        port.load_facenet_state_dict(port.InceptionResnetV1(), dict(sd, extra=torch.zeros(1)))


@pytest.mark.parametrize("shape", [(60, 60), (97, 97), (128, 128), (224, 224), (300, 300),
                                   (513, 513), (100, 140), (40, 33)])
def test_resize_is_within_one_level_of_pil_bilinear(shape):
    crop = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(crop).resize((128, 128), Image.BILINEAR)).astype(np.int32)
    got = port_cluster.resize_crop(torch.from_numpy(crop), 128).permute(1, 2, 0).numpy()
    assert got.shape == (128, 128, 3)
    np.testing.assert_array_equal(got, np.round(got))
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def _tinted_crops(seed, n=8):
    """Noise crops of assorted sizes in two tints: two identities."""
    rng = np.random.default_rng(seed)
    crops = []
    for i in range(n):
        s = int(rng.integers(60, 200))
        c = rng.integers(0, 80, (s, s, 3)) + np.array([(150, 40, 40), (40, 150, 40)][i % 2])
        crops.append(np.clip(c, 0, 255).astype(np.uint8))
    return crops


@pytest.fixture(scope="module")
def calibrated(weights):
    """The net with its last BatchNorm set to the crops' own statistics: a
    random net maps every crop to nearly one direction, and this spreads
    them, so the similarities fall on both sides of the cut and far from it."""
    net, _, _ = weights
    crops = _tinted_crops(0)
    feats = []
    hook = net.last_linear.register_forward_hook(lambda m, i, o: feats.append(o))
    with torch.no_grad():
        net(port.fixed_image_standardization(
            torch.stack([port_cluster.resize_crop(torch.from_numpy(c), 128) for c in crops])))
    hook.remove()
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    sd["last_bn.running_mean"] = feats[0].mean(0)
    sd["last_bn.running_var"] = feats[0].var(0) + 1e-3
    sd["last_bn.weight"] = torch.ones(512)
    sd["last_bn.bias"] = torch.zeros(512)
    return (port_cluster.FaceEmbedder(sd, device="cpu"),
            jax_cluster.FaceEmbedder(jaxf.facenet_params_from_torch(sd)))


def test_embedder_memberships_equal_jax(calibrated):
    ours, theirs = calibrated
    crops = _tinted_crops(0)
    got, want = ours(crops), theirs(crops)
    assert got.shape == want.shape == (8, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    sims = want @ want.T
    assert np.abs(sims - 0.45).min() > 0.1, "the crops must sit far from the cut"
    comps = port_cluster.connected_components(got @ got.T, 0.45)
    assert comps == jax_cluster.connected_components(sims, 0.45)
    assert comps == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert ours([]).shape == (0, 512)


def test_cluster_video_dir_matches_jax(calibrated, tmp_path):
    ours, theirs = calibrated
    crops = _tinted_crops(0)
    trees = {}
    for side, embedder, fn in (("port", ours, port_cluster.cluster_video_dir),
                               ("jax", theirs, jax_cluster.cluster_video_dir)):
        d = tmp_path / side / "video_0"
        d.mkdir(parents=True)
        for i, c in enumerate(crops):
            cv2.imwrite(str(d / f"{i // 2}_{i % 2}.png"), c)
        (d / "notes.txt").write_text("not a crop")
        assignment = fn(str(d), embedder)
        trees[side] = (
            {os.path.relpath(k, d): v for k, v in assignment.items()},
            sorted(os.path.relpath(os.path.join(r, f), d)
                   for r, _, files in os.walk(d) for f in files),
        )
    assert trees["port"] == trees["jax"]
    assert sorted(set(trees["port"][0].values())) == [0, 1]
    assert "notes.txt" in trees["port"][1]
