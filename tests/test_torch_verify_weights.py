"""The port's day-one weight check (``mintime_torch/verify_weights.py``) on
files the test writes in the published formats, as
``tests/test_verify_weights.py`` writes them for the JAX CLI: facenet-pytorch
MTCNN and InceptionResnetV1 state_dicts, a pytorchvideo ``slowfast_r50``
checkpoint (wrapped as the hub file is), and the reference's
``Model_checkpoint`` / ``Extractor_checkpoint`` exported from a JAX model. On
the CPU: every arm gives rc 0 and at least 7 ``[ OK ]`` lines; the
classifier arm's logit (bf16, as both CLIs run it) is within the repo's bf16
tolerance of the JAX ``verify_classifier``'s on the same files, 5e-2 x
max(1, |JAX|); a file with a missing or unknown key raises.
"""

import numpy as np
import pytest
import torch

from mintime_torch import verify_weights as port

SMALL_YAML = ("training:\n  bs: 2\n  val-bs: 2\nmodel:\n  image-size: 32\n"
              "  num-frames: 8\n  num-patches: 1\n  channels: 1280\n  dim: 32\n"
              "  depth: 1\n  heads: 2\n  dim-head: 16\n  max-identities: 2\n")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from mintime_tpu.config import ModelConfig
    from mintime_tpu.models.classifier import MintimeVideoClassifier
    from mintime_tpu.utils.torch_convert import (
        efficientnet_params_to_torch,
        timesformer_params_to_torch,
    )
    from tests.test_facenet_numerics import TorchInceptionResnetV1
    from tests.test_mtcnn_oracle import TorchONet, TorchPNet, TorchRNet
    from tests.test_slowfast_numerics import make_state_dict
    from tests.test_torch_efficientnet import random_variables

    d = tmp_path_factory.mktemp("weights")
    torch.manual_seed(0)
    mt = d / "mtcnn"
    mt.mkdir()
    torch.save(TorchPNet().state_dict(), mt / "pnet.pt")
    torch.save(TorchRNet().state_dict(), mt / "rnet.pt")
    torch.save(TorchONet().state_dict(), mt / "onet.pt")
    torch.save(TorchInceptionResnetV1().state_dict(), d / "vggface2.pt")
    torch.save({"model_state": make_state_dict()}, d / "slowfast.pyth")

    small = ModelConfig(image_size=32, num_frames=8, num_patches=1, channels=1280, dim=32,
                        depth=1, heads=2, dim_head=16, max_identities=2)
    model = MintimeVideoClassifier(small, backbone="efficientnet-b0", head="timesformer",
                                   require_attention=True)
    # drawn from the init's shapes: compiling the init takes ~15 s on a CPU
    variables = random_variables(
        model, np.zeros((1, 8, 32, 32, 3), np.float32), np.ones((1, 8), bool),
        np.ones((1, 8, 8), bool), np.ones((1, 8), np.int32), np.zeros((1, 9), np.int32))
    ext = {"params": variables["params"]["extractor"],
           "batch_stats": variables["batch_stats"]["extractor"]}
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in efficientnet_params_to_torch(ext).items()},
               d / "Extractor_checkpoint")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in timesformer_params_to_torch(variables["params"]["head"],
                                                        small).items()},
               d / "Model_checkpoint")
    (d / "small.yaml").write_text(SMALL_YAML)
    return d


def _argv(d):
    return ["--mtcnn_weights", str(d / "mtcnn"), "--facenet_weights", str(d / "vggface2.pt"),
            "--slowfast_weights", str(d / "slowfast.pyth"),
            "--model_weights", str(d / "Model_checkpoint"),
            "--extractor_weights", str(d / "Extractor_checkpoint"),
            "--config", str(d / "small.yaml"), "--device", "cpu"]


def test_every_arm_verifies(files, capsys):
    rc = port.main(_argv(files))
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("[ OK ]") >= 7
    assert "all requested artifacts verified" in out


def test_classifier_logit_matches_jax(files):
    from mintime_tpu.verify_weights import verify_classifier as jax_verify

    args = (str(files / "Model_checkpoint"), str(files / "Extractor_checkpoint"),
            str(files / "small.yaml"), 0)
    parts = jax_verify(*args)
    import jax

    m = parts["cfg"].model
    F = m.num_frames
    logits, _ = jax.jit(parts["model"].apply)(
        parts["variables"], np.full((1, F, 32, 32, 3), 128, np.float32), np.ones((1, F), bool),
        np.ones((1, F, F), bool), np.ones((1, F), np.int32),
        np.arange(1 + F * m.num_patches, dtype=np.int32)[None] % (F * m.num_patches))
    want = float(np.asarray(logits)[0, 0])
    got = port.verify_classifier(*args, device="cpu")["logit"]
    assert abs(got - want) <= 5e-2 * max(1.0, abs(want)), (got, want)


def test_a_missing_or_unknown_key_raises(files, tmp_path):
    import shutil

    sd = torch.load(files / "Model_checkpoint")
    sd.pop("to_out.1.weight")
    torch.save(sd, tmp_path / "Model_checkpoint")
    with pytest.raises(KeyError):
        port.verify_classifier(str(tmp_path / "Model_checkpoint"),
                               str(files / "Extractor_checkpoint"), str(files / "small.yaml"),
                               0, device="cpu")
    mt = tmp_path / "mtcnn"
    shutil.copytree(files / "mtcnn", mt)
    pnet = torch.load(mt / "pnet.pt")
    pnet["extra.weight"] = torch.zeros(1)
    torch.save(pnet, mt / "pnet.pt")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        port.verify_mtcnn(str(mt), None, device="cpu")
    sf = torch.load(files / "slowfast.pyth")
    sf["model_state"]["blocks.6.proj.weight"] = torch.zeros(1, 2304)
    torch.save(sf, tmp_path / "slowfast.pyth")
    with pytest.raises(ValueError, match="keys the model does not have"):
        port.verify_slowfast(str(tmp_path / "slowfast.pyth"), device="cpu")


def test_nothing_to_verify_is_an_error():
    with pytest.raises(SystemExit):
        port.main(["--device", "cpu"])


def test_default_device_is_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port.main(["--facenet_weights", str(files / "vggface2.pt")])
