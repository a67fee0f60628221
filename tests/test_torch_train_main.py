"""``python -m mintime_torch.train_loop`` (``train_loop.main``) against the JAX
package's ``main``, on the CPU.

The files: ``tests/test_torch_dataset_train.py``'s tree (cv2-written videos,
the port's ``extract_crops``, identity folders, ``pack_crops``), a train list
of its four videos and a validation list of two, and narrow config yamls
written here. Both CLIs run ``--model 1`` (EfficientNet-B0 + TimeSformer) on
the same files with the same flags, both in fp32 with drop-connect off (the
JAX side through stand-ins for the classes and the train state its ``main``
imports, built inside the test; the JAX package itself is unchanged), from
the same initial weights, drawn with numpy. Split sizes are multiples of the batch, so the
JAX loader pads nothing.

Held: each epoch's logged scalars (training and validation loss and
accuracy, learning rate), the epochs at which checkpoints are written, the
epochs run under ``--patience``, and where each kind of resumption starts
(the JAX ``main``'s choice read through a stand-in for its ``fit``). Losses
within 2e-4 relative: one fp32 step of this classifier agrees to 2e-5
(``tests/test_torch_train_classifier.py``), and four epochs of steps carry
the gap along. Then ``--model 0``, ``2`` and ``3`` each train an epoch.
"""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch import train_loop as port_loop  # noqa: E402
from mintime_torch.convert import load_jax_variables  # noqa: E402
from mintime_torch.data import loader as port_loader  # noqa: E402
from mintime_tpu import train as jax_train  # noqa: E402
from mintime_tpu import train_loop as jax_loop  # noqa: E402
from mintime_tpu.data import loader as jax_loader  # noqa: E402
from mintime_tpu.models import classifier as jax_classifier  # noqa: E402
from mintime_tpu.models.efficientnet import EfficientNet as JaxEfficientNet  # noqa: E402
from mintime_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from test_torch_dataset_train import write_train_tree  # noqa: E402
from test_torch_efficientnet import random_variables  # noqa: E402

TAGS = ("Training/Loss", "Training/Accuracy", "Training/Learning_Rate", "Validation/Loss",
        "Validation/Accuracy")
YAML = """training:
  lr: 0.2
  weight-decay: 0.0001
  bs: 2
  val_bs: 2
  optimizer: 'SGD'
  scheduler: 'cosinelr'
  augmentation: 'max'
model:
  image-size: 32
  num-frames: 8
  num-patches: 1
  max-identities: 2
  channels: 1280
  dim: 32
  depth: 1
  heads: 2
  dim-head: 16
"""
CONV_YAML = """training:
  bs: 2
  val_bs: 2
  augmentation: 'min'
model:
  image-size: 32
  num-frames: 8
  num-patches: 1280
  channels: 1280
  dim: 64
  depth: 1
  heads: 2
  dim-head: 32
"""
SLOWFAST_YAML = """training:
  lr: 0.001
  bs: 2
  val_bs: 2
  augmentation: 'min'
model:
  image-size: 32
  num-frames: 8
  max-identities: 1
"""


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test: the parallel test run's workers share the
    cores, and torch's default of one thread a core oversubscribes them (a
    test of this file took 50 times its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_main")
    tree = write_train_tree(str(root))
    rows = [f"{v} {int(lab)} {2 if lab else 0}" for v, lab in zip(tree["videos"], tree["labels"])]
    out = {"data": tree["pack"], "root": root}
    for name, text in (("train.csv", rows), ("val.csv", rows[1:3])):
        (root / name).write_text("\n".join(text) + "\n")
        out[name] = str(root / name)
    for name, text in (("small", YAML), ("conv", CONV_YAML), ("slowfast", SLOWFAST_YAML)):
        (root / f"{name}.yaml").write_text(text)
        out[name] = str(root / f"{name}.yaml")
    return out


def _argv(files, out, *extra, config="small"):
    return ["--config", files[config], "--train_list_file", files["train.csv"],
            "--validation_list_file", files["val.csv"], "--data_path", files["data"],
            "--workers", "2", "--models_output_path", str(out / "models"),
            "--logger_name", str(out / "runs"), *extra]


def _scalars(out):
    with open(out / "runs" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    by_epoch = {}
    for r in rows:
        by_epoch.setdefault(r["step"], {})[r["tag"]] = r["value"]
    return by_epoch


def _threads(monkeypatch):
    """Both loaders' workers as threads (the spawned workers of the port's
    loader are the chip phase's)."""
    monkeypatch.setattr(jax_loader, "DataLoader",
                        functools.partial(jax_loader.DataLoader, worker_mode="thread"))
    monkeypatch.setattr(port_loader, "DataLoader",
                        functools.partial(port_loader.DataLoader, worker_mode="thread"))


@pytest.fixture(scope="module")
def jax_run(files, tmp_path_factory):
    """The JAX ``main`` in fp32 with drop-connect off: its result, scalars,
    and the initial variables of its train state."""
    out = tmp_path_factory.mktemp("jax")
    mp = pytest.MonkeyPatch()
    _threads(mp)
    mp.setattr(jax_classifier, "EfficientNet",
               functools.partial(JaxEfficientNet, drop_connect_rate=0.0))
    cls = jax_classifier.MintimeVideoClassifier
    mp.setattr(jax_classifier, "MintimeVideoClassifier",
               lambda *a, **k: cls(*a, **{**k, "dtype": None}))
    initial = {}

    def create(rng, model, example, cfg, steps_per_epoch, num_epochs, trainable_mask=None):
        """``create_train_state`` with the variables drawn by numpy from the
        init's shapes (an eager init of this model takes 45 s on the CPU);
        copies of them kept, as the JAX step donates the state's buffers."""
        variables = random_variables(model, *jax_train.model_inputs(example, model.head), seed=3)
        initial.update(jax.tree.map(np.array, variables))
        tx = jax_train.make_optimizer(
            cfg, jax_train.make_schedule(cfg, steps_per_epoch, num_epochs), trainable_mask)
        return jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=tx.init(variables["params"]), tx=tx)

    mp.setattr(jax_train, "create_train_state", create)
    try:
        result = jax_loop.main(_argv(files, out, "--num_epochs", "3", "--patience", "1"))
    finally:
        mp.undo()
    return {"result": result, "scalars": _scalars(out), "initial": initial, "out": out}


def _from_jax_weights(monkeypatch, initial):
    """The port's ``main`` building its model from the JAX run's initial
    variables, drop-connect off."""
    build = port_loop.build_training_model

    def from_jax(*a, **k):
        model = build(*a, **k)
        model.extractor.drop_connect_rate = 0.0
        return load_jax_variables(model, initial)

    monkeypatch.setattr(port_loop, "build_training_model", from_jax)


def _epochs(paths):
    return [int(os.path.basename(p).split("_")[1]) for p in paths]


def test_main_matches_the_jax_main(files, jax_run, tmp_path, monkeypatch):
    _threads(monkeypatch)
    _from_jax_weights(monkeypatch, jax_run["initial"])
    got = port_loop.main(_argv(files, tmp_path, "--num_epochs", "3", "--patience", "1",
                               "--device", "cpu"))
    want = jax_run["result"]
    assert got.epochs_run == want.epochs_run
    assert _epochs(got.checkpoints) == _epochs(want.checkpoints)
    assert want.epochs_run < 4  # patience stopped both runs early
    scalars, jscalars = _scalars(tmp_path), jax_run["scalars"]
    assert sorted(scalars) == sorted(jscalars) == list(range(want.epochs_run))
    for epoch, row in jscalars.items():
        assert set(scalars[epoch]) == set(TAGS)
        for tag in TAGS:
            tol = 2e-4 if tag.endswith("Loss") else 1e-6
            np.testing.assert_allclose(scalars[epoch][tag], row[tag], rtol=tol,
                                       err_msg=f"epoch {epoch} {tag}")
    np.testing.assert_allclose(got.best_val_loss, want.best_val_loss, rtol=2e-4)
    assert all(os.path.isfile(p) for p in got.checkpoints)


def _starts(files, out, monkeypatch, argv):
    """Where each ``main`` starts on the same models directory: the epoch its
    ``fit`` is given (neither trains), and the step the port restored."""
    _threads(monkeypatch)
    seen = {}
    monkeypatch.setattr(jax_loop, "fit", lambda *a, **k: seen.update(jax=k["starting_epoch"]) or
                        (None, jax_loop.FitResult(math.inf, 0)))
    monkeypatch.setattr(jax_train, "create_train_state", lambda *a, **k: "state")
    monkeypatch.setattr(jax_checkpoint, "restore_train_state", lambda path, state: state)
    monkeypatch.setattr(port_loop, "fit", lambda state, *a, **k: seen.update(
        port=k["starting_epoch"], step=state.step) or (state, port_loop.FitResult(math.inf, 0)))
    jax_loop.main(_argv(files, out, *argv))
    port_loop.main(_argv(files, out, *argv, "--device", "cpu"))
    monkeypatch.undo()
    return seen


def test_resume_starts_where_the_jax_main_does(files, jax_run, tmp_path, monkeypatch):
    """A first run of two epochs, then: the automatic resume from the last
    ``checkpoint_<epoch>`` really trains from ``epoch + 1``; ``--resume``
    alone restarts the count at 0, with ``--restore_epoch`` at the file's
    epoch + 1; the JAX ``main`` chooses the same epochs on the same files."""
    with monkeypatch.context() as m:
        _threads(m)
        first = port_loop.main(_argv(files, tmp_path, "--num_epochs", "1", "--patience", "5",
                                     "--device", "cpu"))
    last = max(_epochs(first.checkpoints))
    models = tmp_path / "models"
    steps = 2  # four train videos at batch 2

    auto = _starts(files, tmp_path, monkeypatch, ["--num_epochs", "3"])
    assert auto == {"jax": last + 1, "port": last + 1, "step": (last + 1) * steps}
    given = str(models / f"checkpoint_{last}")
    assert _starts(files, tmp_path, monkeypatch, ["--resume", given]) == \
        {"jax": 0, "port": 0, "step": (last + 1) * steps}
    assert _starts(files, tmp_path, monkeypatch, ["--resume", given, "--restore_epoch"]) == \
        {"jax": last + 1, "port": last + 1, "step": (last + 1) * steps}

    with monkeypatch.context() as m:  # the automatic resume, trained
        _threads(m)
        again = port_loop.main(_argv(files, tmp_path, "--num_epochs", "2", "--patience", "5",
                                     "--device", "cpu"))
    assert sorted(_scalars(tmp_path)) == list(range(3))  # epochs 0, 1, then 2
    assert again.epochs_run == 3


@pytest.mark.parametrize("model, config", [("0", "small"), ("2", "slowfast"), ("3", "conv")])
def test_every_model_trains_an_epoch(files, tmp_path, monkeypatch, model, config):
    from mintime_torch.models import slowfast
    from test_torch_slowfast import TOY

    _threads(monkeypatch)
    monkeypatch.setattr(slowfast, "SlowFastClassifier",
                        functools.partial(slowfast.SlowFastClassifier, **TOY))
    result = port_loop.main(_argv(files, tmp_path, "--model", model, "--num_epochs", "0",
                                  "--device", "cpu", config=config))
    assert result.epochs_run == 1 and _epochs(result.checkpoints) == [0]
    row = _scalars(tmp_path)[0]
    assert set(row) == set(TAGS) and all(np.isfinite(v) for v in row.values()), row


def test_main_defaults_to_the_card(files, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_loop.main(_argv(files, tmp_path))


def test_flags_are_the_jax_mains(capsys):
    """Every flag of the JAX ``main`` with its default, and ``--device``."""
    import argparse

    def flags(main):
        seen = {}

        def parse(self, args=None, namespace=None):
            seen.update({a.dest: a.default for a in self._actions if a.dest != "help"})
            raise SystemExit(0)

        with pytest.MonkeyPatch.context() as m:
            m.setattr(argparse.ArgumentParser, "parse_args", parse)
            with pytest.raises(SystemExit):
                main([])
        return seen

    port, jax = flags(port_loop.main), flags(jax_loop.main)
    assert set(port) == set(jax) | {"device"}
    assert {k: v for k, v in port.items() if k != "device"} == jax
    assert port["device"] == "cuda"


def test_card_inputs_configs_are_the_yamls():
    """The card tests of the training CLI and SlowFast build their configs
    in code (the card's machine has no yaml): the repo's yamls."""
    import card_inputs
    from mintime_torch.config import load_config

    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
    assert card_inputs.train_main_config() == \
        load_config(os.path.join(root, "size_invariant_timesformer.yaml"))
    assert card_inputs.slowfast_config() == load_config(os.path.join(root, "slowfast.yaml"))
