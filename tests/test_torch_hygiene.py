"""Import hygiene and device policy of the PyTorch port.

The port must run where there is no JAX, no Flax, no PIL, no cv2, no yaml
and no pandas: it never imports JAX, Flax, PIL or ``mintime_tpu``, and
imports cv2, yaml, pandas and matplotlib only inside the functions that need
them. Its default device is the card, and
without one it raises instead of falling back to the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mintime_torch").rglob("*.py")) + [
    ROOT / "tests" / "test_torch_paths_cuda.py", ROOT / "tests" / "card_inputs.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "mintime_tpu", "PIL")
LAZY_ONLY = ("cv2", "yaml", "matplotlib", "pandas")


def _imports(tree):
    """(module name, is top level) for every import in the module."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_or_top_level_lazy_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top_level in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"
        assert not (root in LAZY_ONLY and top_level), f"{path.name} imports {name} at top level"


def test_import_pulls_in_no_jax_cv2_or_yaml():
    code = ("import sys, mintime_torch.predict, mintime_torch.models.classifier, "
            "mintime_torch.convert, mintime_torch.train, mintime_torch.train_loop, "
            "mintime_torch.preprocessing.mtcnn, mintime_torch.preprocessing.facenet, "
            "mintime_torch.preprocessing.cluster_faces, mintime_torch.native, "
            "mintime_torch.models.xception, mintime_torch.models.slowfast, "
            "mintime_torch.data.augment, "
            "mintime_torch.data.augment_plan, mintime_torch.data.colorspace, "
            "mintime_torch.data.draw, mintime_torch.data.jpeg, "
            "mintime_torch.utils.checkpoint, mintime_torch.utils.attention_viz, "
            "mintime_torch.preprocessing.detect_faces, mintime_torch.evaluate, "
            "mintime_torch.data.dataset, mintime_torch.data.loader, mintime_torch.data.manifest, "
            "mintime_torch.data.crop_store, mintime_torch.utils.metrics, "
            "mintime_torch.preprocessing.extract_crops, mintime_torch.preprocessing.pack_crops, "
            "mintime_torch.preprocessing.split_dataset, mintime_torch.preprocessing.stats, "
            "mintime_torch.utils.profiling, mintime_torch.preprocessing.extract_features, "
            "mintime_torch.verify_weights, mintime_torch.pretrain_extractor, "
            "mintime_torch.models.frame_classifier, mintime_torch.data.frames, "
            "mintime_torch.parallel.mesh\n"
            "bad = [m for m in ('jax', 'flax', 'cv2', 'yaml', 'PIL', 'mintime_tpu', 'matplotlib', "
            "'pandas') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=120)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from mintime_torch.config import ModelConfig
    from mintime_torch.models.classifier import MintimeVideoClassifier

    cfg = ModelConfig(num_frames=8, num_patches=1, dim=32, depth=1, heads=1, dim_head=32)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MintimeVideoClassifier(cfg)


def test_detector_and_embedder_default_to_the_card():
    """``MTCNNDetector`` and ``FaceEmbedder`` raise without a card unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from mintime_torch.preprocessing.cluster_faces import FaceEmbedder
    from mintime_torch.preprocessing.mtcnn import MTCNNDetector

    sds = MTCNNDetector.init_state_dicts()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MTCNNDetector(sds)
    sd = FaceEmbedder.init_state_dict()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        FaceEmbedder(sd)
    assert MTCNNDetector(sds, device="cpu").device.type == "cpu"
    assert FaceEmbedder(sd, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("device_kw", [{}, {"device": "cuda"}])
def test_training_entry_point_raises_without_a_card_unless_cpu(device_kw):
    """``training_model`` defaults to the card and raises without one; with
    ``device="cpu"`` it builds the fp32 training model."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from mintime_torch.config import ModelConfig
    from mintime_torch.train import training_model

    cfg = ModelConfig(num_frames=8, num_patches=1, dim=32, depth=1, heads=1, dim_head=32)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        training_model(cfg, **device_kw)
    model = training_model(cfg, device="cpu")
    assert model.dtype == model.compute_dtype == torch.float32


def test_kernel_wrappers_refuse_cpu_calls_to_the_kernel():
    """The kernel entry points check their arguments instead of silently
    computing on the CPU."""
    from mintime_torch.ops import divided_attention, geglu_ffn

    x = torch.zeros(8, 512)
    with pytest.raises(ValueError, match="card"):
        geglu_ffn.geglu_ffn_cuda(x, torch.zeros(4096, 512), torch.zeros(4096),
                                 torch.zeros(512, 2048), torch.zeros(512))
    with pytest.raises(ValueError, match="card"):
        divided_attention.divided_attention_cuda(
            torch.zeros(1, 2, 3, 192), torch.zeros(1, 1, 192), None, None,
            heads=1, dim_head=64)
    with pytest.raises(ValueError, match="card"):
        geglu_ffn.geglu_ffn_bwd_cuda(x, torch.zeros(4096, 512), torch.zeros(4096),
                                     torch.zeros(512, 2048), torch.zeros(8, 512))
    with pytest.raises(ValueError, match="card"):
        divided_attention.divided_attention_bwd_cuda(
            torch.zeros(1, 2, 3, 192), torch.zeros(1, 1, 192), None, None,
            torch.zeros(1, 2, 3, 64), torch.zeros(1, 1, 64), heads=1, dim_head=64)
