"""``python -m mintime_torch.predict`` vs ``python -m mintime_tpu.predict`` on
a cv2-written video and weight files the test writes, on the CPU, for
MINTIME-EF (``--extractor_model 0``) and MINTIME-XC (``1``).

Weights: the classifier's from seeded JAX variables through the JAX
package's exporters (the reference's ``Model_checkpoint`` /
``Extractor_checkpoint`` formats), the MTCNN nets of seed 43 with their
score layers x75 (so the default thresholds 0.85 / 0.95 / 0.95 find three
faces a frame in the test video, with no P-Net truncation), a random
InceptionResnetV1 for FaceNet.

Tolerances: both CLIs compute in bf16, so their probabilities agree within
2e-2; the same files through ``load_model_state`` + ``predict_video`` in fp32
against ``load_model_variables`` + ``predict_video`` within 1e-4 (the JAX
package's fp32 logits tolerance). The annotated video is compared frame by
frame after the boxes' integer corners are asserted equal.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch import predict as port_predict  # noqa: E402
from mintime_torch.config import load_config  # noqa: E402
from mintime_torch.models.classifier import MintimeVideoClassifier  # noqa: E402
from mintime_torch.preprocessing import mtcnn as port_mtcnn  # noqa: E402
from mintime_torch.preprocessing.cluster_faces import FaceEmbedder  # noqa: E402
from mintime_torch.utils.checkpoint import load_model_state  # noqa: E402
from mintime_tpu import predict as jax_predict  # noqa: E402
from mintime_tpu.config import load_config as jax_load_config  # noqa: E402
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier  # noqa: E402
from mintime_tpu.preprocessing.cluster_faces import FaceEmbedder as JaxFaceEmbedder  # noqa: E402
from mintime_tpu.preprocessing.facenet import facenet_params_from_torch  # noqa: E402
from mintime_tpu.preprocessing.mtcnn import MTCNNDetector as JaxMTCNNDetector  # noqa: E402
from mintime_tpu.preprocessing.mtcnn import mtcnn_params_from_torch  # noqa: E402
from mintime_tpu.utils.checkpoint import load_model_variables  # noqa: E402
from test_torch_checkpoint_load import inputs, small_config, write_reference_files  # noqa: E402
from test_torch_efficientnet import random_variables  # noqa: E402
from test_torch_predict_detect import _video  # noqa: E402

BACKBONES = {0: "efficientnet-b0", 1: "xception"}
YAML = """model:
  image-size: 64
  num-frames: 8
  num-patches: 4
  max-identities: 2
  dim: 64
  depth: 2
  heads: 2
  dim-head: 32
  channels: {channels}
"""


def _mtcnn_state_dicts(seed=43):
    torch.manual_seed(seed)
    nets = {"pnet": port_mtcnn.PNet(), "rnet": port_mtcnn.RNet(), "onet": port_mtcnn.ONet()}
    with torch.no_grad():
        for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
            getattr(nets[net], layer).weight.mul_(75.0)
            getattr(nets[net], layer).bias.mul_(75.0)
    return {k: v.state_dict() for k, v in nets.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    video = _video(str(d / "clip.mp4"), n_frames=20)
    os.makedirs(d / "mtcnn")
    for name, sd in _mtcnn_state_dicts().items():
        torch.save(sd, d / "mtcnn" / f"{name}.pt")
    torch.save(FaceEmbedder.init_state_dict(2), d / "facenet.pt")
    out = {"video": video, "mtcnn": str(d / "mtcnn"), "facenet": str(d / "facenet.pt")}
    for model_id, backbone in BACKBONES.items():
        cfg = small_config(backbone)
        sub = d / backbone
        os.makedirs(sub)
        config = sub / "config.yaml"
        config.write_text(YAML.format(channels=cfg["channels"]))
        jcfg = jax_load_config(str(config))
        jmodel = JaxClassifier(jcfg.model, backbone=backbone, head="timesformer")
        variables = random_variables(jmodel, *inputs(cfg), seed=model_id)
        head, ext = write_reference_files(variables, jcfg.model, backbone, "timesformer",
                                          str(sub))
        out[model_id] = {"config": str(config), "head": head, "ext": ext}
    return out


def _argv(files, model_id, *extra):
    f = files[model_id]
    return ["--video_path", files["video"], "--config", f["config"], "--model_weights", f["head"],
            "--extractor_weights", f["ext"], "--extractor_model", str(model_id),
            "--mtcnn_weights", files["mtcnn"], "--facenet_weights", files["facenet"], *extra]


def _frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def _corners(result):
    return [[(i, tuple(int(b * 2) for b in bbox)) for i, _, _, bbox in items]
            for items in result.identities.values()]


@pytest.mark.parametrize("model_id", [0, 1], ids=["efficientnet", "xception"])
def test_cli_matches_the_jax_cli(files, model_id, tmp_path, monkeypatch, capsys):
    extra = ("--output_type", "1", "--save_attentions")
    for side in ("jax", "port"):  # each CLI writes under its working directory
        os.makedirs(tmp_path / side)
    monkeypatch.chdir(tmp_path / "jax")
    want = jax_predict.main(_argv(files, model_id, *extra))
    monkeypatch.chdir(tmp_path / "port")
    got = port_predict.main(_argv(files, model_id, *extra, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "fake probability: " in out and "annotated video: " in out

    assert 0.0 < got.probability < 1.0
    np.testing.assert_allclose(got.probability, want.probability, atol=2e-2)
    assert list(got.identities) == list(want.identities)
    assert [len(v) for v in got.identities.values()] == [len(v) for v in want.identities.values()]
    assert got.frames_per_identity == want.frames_per_identity

    # the plots: the same three files
    names = sorted(os.listdir(tmp_path / "port" / "outputs" / "tokens"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "outputs" / "tokens")) == [
        f"clip.mp4_{k}.jpg" for k in ("combined", "space", "time")]

    # the annotated video: where the boxes' integer corners agree, the port
    # draws the JAX result's frames exactly
    assert _corners(got) == _corners(want)
    jax_avi = tmp_path / "jax" / "examples" / "preds" / "clip.avi"
    assert (tmp_path / "port" / "examples" / "preds" / "clip.avi").exists()
    redrawn = port_predict.generate_output_video(files["video"], want, str(tmp_path / "redrawn"))
    want_frames, got_frames = _frames(str(jax_avi)), _frames(redrawn)
    assert len(got_frames) == len(want_frames) == 20
    for g, w in zip(got_frames, want_frames):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("model_id", [0, 1], ids=["efficientnet", "xception"])
def test_fp32_library_route_matches_jax(files, model_id):
    f = files[model_id]
    backbone = BACKBONES[model_id]
    mtcnn = {n: torch.load(os.path.join(files["mtcnn"], f"{n}.pt")) for n in port_mtcnn.NETS}
    facenet = torch.load(files["facenet"])

    jcfg = jax_load_config(f["config"])
    jmodel = JaxClassifier(jcfg.model, backbone=backbone, head="timesformer",
                           require_attention=True, use_pallas=True)
    jvars = load_model_variables(jmodel, jcfg, f["head"], extractor_weights=f["ext"])
    want = jax_predict.predict_video(
        files["video"], jmodel, jvars, jcfg,
        JaxMTCNNDetector(mtcnn_params_from_torch(mtcnn["pnet"], mtcnn["rnet"], mtcnn["onet"]),
                         channel_order="bgr"),
        JaxFaceEmbedder(facenet_params_from_torch(facenet)))

    cfg = load_config(f["config"])
    model = MintimeVideoClassifier(cfg.model, backbone=backbone, require_attention=True,
                                   use_kernels=True, device="cpu")
    model.load_state_dict(load_model_state(model, cfg, f["head"], extractor_weights=f["ext"]))
    got = port_predict.predict_video(
        files["video"], model, None, cfg,
        port_mtcnn.MTCNNDetector(mtcnn, channel_order="bgr", device="cpu"),
        FaceEmbedder(facenet, device="cpu"))
    np.testing.assert_allclose(got.probability, want.probability, atol=1e-4)
    assert list(got.identities) == list(want.identities)
    np.testing.assert_allclose(got.identity_attentions, want.identity_attentions, atol=1e-3)


def test_missing_face_weights_are_an_error(files, capsys):
    with pytest.raises(SystemExit) as e:
        port_predict.main(["--video_path", files["video"], "--model_weights", files[0]["head"],
                           "--device", "cpu"])
    assert e.value.code == 2
    assert "--mtcnn_weights (dir with pnet.pt/rnet.pt/onet.pt)" in capsys.readouterr().err
