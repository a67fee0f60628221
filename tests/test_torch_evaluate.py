"""``mintime_torch.evaluate`` against ``mintime_tpu.evaluate``, on the CPU.

The faces tree is written by the port's ``extract_crops`` CLI from
cv2-written videos and boxes, its crops moved into identity folders as
clustering leaves them, and packed by the port's ``pack_crops`` CLI into a
second tree. Weights: seeded JAX variables through the JAX package's
exporters (the reference's ``Model_checkpoint`` / ``Extractor_checkpoint``).

Tolerances: ``evaluate()`` in fp32 against the JAX ``evaluate()`` in fp32,
logits and loss within 1e-4 (the JAX package's fp32 logits tolerance) and
the rest of the report equal, with every logit at least 1e-3 from 0 so that
no prediction sits on the rounding edge; both CLIs compute in bf16, so
their losses agree within 2e-2.
"""

import functools
import json
import math
import os
import shutil
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch import evaluate as port_eval  # noqa: E402
from mintime_torch.config import MintimeConfig, ModelConfig, load_config  # noqa: E402
from mintime_torch.data.manifest import load_manifest  # noqa: E402
from mintime_torch.preprocessing import extract_crops, pack_crops  # noqa: E402
from mintime_torch.utils import metrics as port_metrics  # noqa: E402
from mintime_tpu import evaluate as jax_eval  # noqa: E402
from mintime_tpu.config import load_config as jax_load_config  # noqa: E402
from mintime_tpu.data.dataset import DeepfakesDataset as JaxDataset  # noqa: E402
from mintime_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier  # noqa: E402
from mintime_tpu.utils import metrics as jax_metrics  # noqa: E402
from mintime_tpu.utils.checkpoint import load_model_variables  # noqa: E402
from test_torch_checkpoint_load import inputs, small_config, write_reference_files  # noqa: E402
from test_torch_dataset import pack_tree, write_faces_tree  # noqa: E402
from test_torch_efficientnet import random_variables  # noqa: E402
from test_torch_extract_crops import write_videos  # noqa: E402

YAML = """model:
  image-size: 64
  num-frames: 8
  num-patches: 4
  max-identities: 2
  dim: 64
  depth: 2
  heads: 2
  dim-head: 32
  channels: 1280
test:
  bs: 2
"""
#: the weights' seed: every fp32 logit of the split lies 1e-3 or more from 0, of both signs
SEED = 4
#: the baseline's seed: every fp32 logit lies 1e-3 or more from 0
BASELINE_SEED = 4
#: SlowFast's seed: every fp32 logit of the split lies 1e-3 or more from 0, of both signs
SLOWFAST_SEED = 0
N_VIDEOS = 6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    videos, boxes = write_videos(root, n=N_VIDEOS)
    faces = os.path.join(root, "faces")
    extract_crops.main(["--video_path", videos, "--boxes_path", boxes, "--output_path", faces,
                        "--workers", "2"])
    for dirpath, _, names in list(os.walk(faces)):  # face j → identity folder j
        for name in names:
            if name.endswith(".png"):
                ident = os.path.join(dirpath, name.split("_")[1][:-4])
                os.makedirs(ident, exist_ok=True)
                shutil.move(os.path.join(dirpath, name), os.path.join(ident, name))
    packed = os.path.join(root, "packed")
    shutil.copytree(faces, packed)
    pack_crops.main(["--faces_dir", packed, "--remove_images"])
    rows = [f"{'train' if v % 2 else 'test'}/clip_{v} {v % 2}" + (f" {1 + v % 4}" if v % 2 else "")
            for v in range(N_VIDEOS)] + ["test/clip_missing 1 2"]
    split = os.path.join(root, "test.csv")
    with open(split, "w") as f:
        f.write("\n".join(rows) + "\n")
    config = os.path.join(root, "config.yaml")
    with open(config, "w") as f:
        f.write(YAML)
    cfg = small_config("efficientnet-b0")
    jmodel = JaxClassifier(jax_load_config(config).model, backbone="efficientnet-b0")
    head, ext = write_reference_files(random_variables(jmodel, *inputs(cfg), seed=SEED),
                                      jax_load_config(config).model, "efficientnet-b0",
                                      "timesformer", root)
    return {"png": faces, "pack": packed, "split": split, "config": config, "head": head,
            "ext": ext}


def _argv(files, layout="png", *extra):
    return ["--config", files["config"], "--test_list_file", files["split"],
            "--data_path", files[layout], "--model_weights", files["head"],
            "--extractor_weights", files["ext"], "--workers", "2", *extra]


def _assert_reports_equal(got, want, loss_atol):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "loss":
            np.testing.assert_allclose(got[k], v, atol=loss_atol, rtol=0)
        elif isinstance(v, float) and math.isnan(v):
            assert math.isnan(got[k]), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluation_report_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    logits = rng.choice([-2.0, -0.5, 0.0, 0.5, 2.0, 3.0], n) + (seed == 2) * rng.normal(0, 1, n)
    labels = rng.integers(0, 2, n).astype(np.float32)
    methods = np.where(labels > 0, rng.integers(1, 5, n), np.nan).astype(np.float32)
    methods[:3] = np.nan
    got = port_metrics.evaluation_report(logits, labels, methods)
    want = jax_metrics.evaluation_report(logits, labels, methods)
    _assert_reports_equal(got, want, 0)
    assert got["per_method_errors"] and got["auc"] == want["auc"]
    assert port_metrics.check_correct(logits, labels, methods, {m: [0] for m in range(1, 5)},
                                      [str(i) for i in range(n)]) == \
        jax_metrics.check_correct(logits, labels, methods, {m: [0] for m in range(1, 5)},
                                  [str(i) for i in range(n)])


def test_filter_multi_identity_matches_jax(tmp_path):
    faces, _, names, _, _ = write_faces_tree(str(tmp_path))
    packed = pack_tree(faces, str(tmp_path / "packed"))
    for root in (faces, packed):
        got = port_eval.filter_multi_identity(names + ["video_missing"], root)
        assert got == jax_eval.filter_multi_identity(names + ["video_missing"], root)
        assert got == [1, 2, 4, 5, 6]


def _jax_fp32_report(files, head, head_path, ext_path, monkeypatch):
    """The JAX ``evaluate()`` in fp32 over the PNG tree's split: the report
    and the logits in split order."""
    jcfg = jax_load_config(files["config"])
    jmodel = JaxClassifier(jcfg.model, backbone="efficientnet-b0", head=head)
    jvars = load_model_variables(jmodel, jcfg, head_path, extractor_weights=ext_path)
    jax_logits = []
    loop = jax_eval._evaluate_loop

    def spy(fwd, *a, **k):
        def record(*args):
            out = fwd(*args)
            jax_logits.append(np.asarray(out).reshape(-1))
            return out
        return loop(record, *a, **k)

    monkeypatch.setattr(jax_eval, "_evaluate_loop", spy)
    man = load_manifest(files["split"], files["png"])
    m = jcfg.model
    ds = JaxDataset(man.videos, man.labels, data_path=files["png"], image_size=m.image_size,
                    num_frames=m.num_frames, num_patches=m.num_patches,
                    max_identities=m.max_identities, mode="test", multiclass_labels=man.multiclass)
    want = jax_eval.evaluate(jmodel, jvars, JaxDataLoader(ds, 2, shuffle=False, num_workers=2,
                                                          worker_mode="thread"))
    monkeypatch.undo()
    return want, np.concatenate(jax_logits)


def _spy_logits(monkeypatch):
    """The logits of every port forward, appended in order."""
    logits = []
    forward = port_eval._forward
    monkeypatch.setattr(port_eval, "_forward", lambda *a: logits.append(forward(*a)) or
                        logits[-1])
    return logits


def test_fp32_evaluate_matches_jax(files, monkeypatch):
    want, w = _jax_fp32_report(files, "timesformer", files["head"], files["ext"], monkeypatch)

    cfg = load_config(files["config"])
    man = load_manifest(files["split"], files["png"])
    port_logits = _spy_logits(monkeypatch)
    model = port_eval.build_model(cfg, files["head"], files["ext"], device="cpu",
                                  dtype=torch.float32)
    with port_eval.split_loader(cfg, man.videos, man.labels, man.multiclass, files["png"], 2,
                                workers=2, device="cpu") as loader:
        got = port_eval.evaluate(model, None, loader)

    g = np.concatenate([lg for lg, _ in port_logits])
    assert len(g) == len(w) == N_VIDEOS
    assert np.abs(w).min() >= 1e-3, w  # no logit on the rounding edge
    np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    _assert_reports_equal(got, want, 1e-4)
    assert got["n_videos"] == N_VIDEOS and 0 < got["positive"] < N_VIDEOS


def test_fp32_baseline_matches_jax(files, monkeypatch, tmp_path):
    """``--model 0`` from the reference's baseline files, through
    ``evaluate_split`` with the model in fp32, against the JAX baseline."""
    jcfg = jax_load_config(files["config"])
    jmodel = JaxClassifier(jcfg.model, backbone="efficientnet-b0", head="baseline")
    head, ext = write_reference_files(
        random_variables(jmodel, *inputs(small_config("efficientnet-b0")), seed=BASELINE_SEED),
        jcfg.model, "efficientnet-b0", "baseline", str(tmp_path))
    want, w = _jax_fp32_report(files, "baseline", head, ext, monkeypatch)

    port_logits = _spy_logits(monkeypatch)
    monkeypatch.setattr(port_eval, "build_model",
                        functools.partial(port_eval.build_model, dtype=torch.float32))
    got = port_eval.evaluate_split(load_config(files["config"]), head, files["split"],
                                   files["png"], extractor_weights=ext, model=0, batch_size=2,
                                   workers=2, device="cpu")
    g = np.concatenate([lg for lg, _ in port_logits])
    assert len(g) == len(w) == N_VIDEOS
    assert np.abs(w).min() >= 1e-3, w  # no logit on the rounding edge
    np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    _assert_reports_equal(got, want, 1e-4)


def test_cli_matches_the_jax_cli(files, capsys):
    want = jax_eval.main(_argv(files))
    capsys.readouterr()
    for layout in ("png", "pack"):
        got = port_eval.main(_argv(files, layout, "--device", "cpu"))
        assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
        assert got["n_videos"] == want["n_videos"] == N_VIDEOS
        np.testing.assert_allclose(got["loss"], want["loss"], atol=2e-2, rtol=0)
        assert set(got) == set(want)
    multi = port_eval.main(_argv(files, "pack", "--device", "cpu", "--only_multiidentity",
                                 "--max_videos", "4"))
    kept = load_manifest(files["split"], files["png"], max_videos=4, shuffle_seed=42).videos
    assert multi["n_videos"] == len(jax_eval.filter_multi_identity(kept, files["png"])) == 3


def test_baseline_and_conv_models_are_served(files, tmp_path, monkeypatch):
    """``--model 3`` and ``--model 0`` from the port's own checkpoint, built
    in fp32: the logits of ``evaluate_split`` equal those of the saved model
    in memory within 1e-4, and the reports agree."""
    from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.utils.checkpoint import save_train_state

    man = load_manifest(files["split"], files["png"])
    conv_cfg = MintimeConfig(model=ModelConfig(image_size=32, num_frames=8, num_patches=1280,
                                               channels=1280, dim=64, depth=1, heads=2,
                                               dim_head=32, efficient_net_block=20))
    base_cfg = load_config(files["config"])
    logits = _spy_logits(monkeypatch)
    monkeypatch.setattr(port_eval, "build_model",
                        functools.partial(port_eval.build_model, dtype=torch.float32))
    for model_id, cfg, net in (
            (3, conv_cfg, ConvolutionalTimeSformer(conv_cfg.model, device="cpu",
                                                   param_dtype=torch.float32, seed=4)),
            (0, base_cfg, MintimeVideoClassifier(base_cfg.model, head="baseline", device="cpu",
                                                 param_dtype=torch.float32, seed=4))):
        gen = torch.Generator().manual_seed(model_id)
        for out in [net.head.to_out[1]] if model_id == 3 else net.head.mlp_head:
            with torch.no_grad():  # output layers that spread the logits over the videos
                out.weight.copy_(torch.randn(out.weight.shape, generator=gen))
                out.bias.zero_()
        state = types.SimpleNamespace(model=net, step=1,
                                      optimizer=torch.optim.SGD(net.parameters(), lr=0.1))
        path = save_train_state(str(tmp_path / str(model_id)), state)
        logits.clear()
        got = port_eval.evaluate_split(cfg, path, files["split"], files["pack"], model=model_id,
                                       batch_size=3, workers=1, device="cpu")
        g = np.concatenate([lg for lg, _ in logits])
        logits.clear()
        loader = port_eval.split_loader(cfg, man.videos, man.labels, man.multiclass,
                                        files["pack"], 3, device="cpu")
        loader.worker_mode = "thread"
        want = port_eval.evaluate(net, None, loader)
        w = np.concatenate([lg for lg, _ in logits])
        assert len(g) == len(w) == N_VIDEOS
        assert np.ptp(w) >= 1e-3, w  # the logits depend on the video
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        assert got["n_videos"] == want["n_videos"] == N_VIDEOS
        np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4, rtol=0)


def _slowfast_file(path, seed=0, shift=0.0):
    """A pytorchvideo ``slowfast_r50`` state_dict as a DataParallel run saves
    it: ``module.`` before every key, BatchNorm's ``num_batches_tracked``
    beside its statistics; ``shift`` is added to the head's bias."""
    from mintime_torch.models.slowfast import SlowFastClassifier
    from test_torch_slowfast import TOY, random_state_dict

    sd = random_state_dict(SlowFastClassifier(device="cpu", **TOY), seed=seed)
    sd["blocks.5.proj.bias"] += shift
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    return path


def test_fp32_slowfast_matches_jax(files, monkeypatch, tmp_path):
    """``--model 2`` from a pytorchvideo-key weight file through
    ``evaluate_split``, fp32, against the JAX ``evaluate()`` in fp32 with the
    weights read by the JAX package's own loader. Both classifiers' front
    ends are cut to 8 frames at 32 px inside the test (the 64 px crops
    shrink to it); the class default, 32 frames at 256 px, is what both CLIs
    build."""
    from mintime_torch.models import slowfast as port_sf
    from mintime_tpu.models import slowfast as jax_sf
    from test_torch_slowfast import TOY

    port_logits = _spy_logits(monkeypatch)
    monkeypatch.setattr(port_sf, "SlowFastClassifier",
                        functools.partial(port_sf.SlowFastClassifier, **TOY))
    monkeypatch.setattr(port_eval, "build_model",
                        functools.partial(port_eval.build_model, dtype=torch.float32))

    def port_report(path):
        port_logits.clear()
        report = port_eval.evaluate_split(load_config(files["config"]), path, files["split"],
                                          files["png"], model=2, batch_size=2, workers=2,
                                          device="cpu")
        return report, np.concatenate([lg for lg, _ in port_logits])

    # a head bias that puts the split's logits on both sides of 0
    _, g = port_report(_slowfast_file(str(tmp_path / "unshifted.pth"), seed=SLOWFAST_SEED))
    path = _slowfast_file(str(tmp_path / "slowfast_r50.pth"), seed=SLOWFAST_SEED,
                          shift=-float(np.median(g)))
    got, g = port_report(path)

    jcfg = jax_load_config(files["config"])
    jmodel = jax_sf.SlowFastClassifier(num_classes=jcfg.model.num_classes, **TOY)
    jvars = load_model_variables(jmodel, jcfg, path)
    man = load_manifest(files["split"], files["png"])
    m = jcfg.model
    ds = JaxDataset(man.videos, man.labels, data_path=files["png"], image_size=m.image_size,
                    num_frames=m.num_frames, num_patches=m.num_patches,
                    max_identities=m.max_identities, mode="test", multiclass_labels=man.multiclass)
    jax_logits = []
    loop = jax_eval._evaluate_loop

    def spy(fwd, *a, **k):
        return loop(lambda *args: jax_logits.append(np.asarray(fwd(*args)).reshape(-1)) or
                    jax_logits[-1], *a, **k)

    monkeypatch.setattr(jax_eval, "_evaluate_loop", spy)
    want = jax_eval.evaluate(jmodel, jvars, JaxDataLoader(ds, 2, shuffle=False, num_workers=2,
                                                          worker_mode="thread"))
    w = np.concatenate(jax_logits)
    assert len(g) == len(w) == N_VIDEOS
    assert np.abs(w).min() >= 1e-3 and (w > 0).any() and (w < 0).any(), w
    np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    _assert_reports_equal(got, want, 1e-4)


def test_slowfast_file_with_an_unknown_or_missing_key_raises(tmp_path):
    from mintime_torch.models.slowfast import SlowFastClassifier
    from mintime_torch.utils.checkpoint import load_model_state
    from test_torch_slowfast import TOY

    model = SlowFastClassifier(device="cpu", **TOY)
    path = _slowfast_file(str(tmp_path / "good.pth"))
    assert set(load_model_state(model, None, path)) == set(model.state_dict())
    sd = torch.load(path)
    torch.save({**sd, "module.blocks.6.proj.weight": torch.zeros(1, 2304)},
               str(tmp_path / "extra.pth"))
    with pytest.raises(ValueError, match="blocks.6.proj.weight"):
        load_model_state(model, None, str(tmp_path / "extra.pth"))
    del sd["module.blocks.5.proj.bias"]
    torch.save(sd, str(tmp_path / "short.pth"))
    with pytest.raises(KeyError, match="blocks.5.proj.bias"):
        load_model_state(model, None, str(tmp_path / "short.pth"))
    sd = torch.load(path)
    sd["module.blocks.5.proj.weight"] = torch.zeros(400, 2304)  # a Kinetics head
    torch.save(sd, str(tmp_path / "kinetics.pth"))
    with pytest.raises(ValueError, match="shape"):
        load_model_state(model, None, str(tmp_path / "kinetics.pth"))


def test_entry_point_defaults_to_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_eval.main(_argv(files))


def test_card_inputs_split_and_config(tmp_path):
    """The card tests' evaluation data and model: the yaml's config built in
    code, and a split of 48 videos, 32 of them with two or more identities,
    frame sizes from pack headers and sidecars, loose crops merged into
    identity 0, block noise in a band of levels a video."""
    import card_inputs
    from mintime_torch.data.dataset import DeepfakesDataset

    yaml = load_config(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                                    "size_invariant_timesformer.yaml"))
    cfg = card_inputs.flagship_config(2048)
    assert (cfg.model, cfg.test) == (yaml.model, yaml.test) and cfg.test.bs == 1
    faces, split, n_crops = card_inputs.write_split(str(tmp_path))
    man = load_manifest(split, faces)
    assert len(man) == card_inputs.SPLIT_VIDEOS == 48 and sum(man.labels) == 24
    assert sorted({m for m in man.multiclass if not math.isnan(m)}) == [1.0, 2.0, 3.0, 4.0]
    assert len(port_eval.filter_multi_identity(man.videos, faces)) == 32
    ds = DeepfakesDataset(man.videos, man.labels, data_path=faces, device="cpu")
    ds.preload_index(workers=2)
    index = [ds.get_index(i) for i in range(len(ds))]
    assert all(vi.dims == (1920, 1080) for vi in index)
    assert sum(vi.pack.dims is None for vi in index) == 6  # the sidecar videos
    merged = [vi for vi in index if vi.vf.discarded]
    assert len(merged) == 8 and all(len(vi.vf.identities[0].frames) == 13 for vi in merged)
    sides = [e[4] for vi in index for e in vi.pack.entries if e[0] is not None]
    assert n_crops == len(sides) + 3 * 8 and min(sides) >= 64 and max(sides) <= 320
    crops = [[vi.pack.read(i) for i in range(len(vi.pack.entries))] for vi in index]
    lo = [min(int(c.min()) for c in cs) for cs in crops]
    assert all(max(int(c.max()) for c in cs) - low < card_inputs.SPLIT_BAND
               for cs, low in zip(crops, lo))  # each video's noise in its band
    assert max(lo) - min(lo) > 128  # the bands spread over the levels
