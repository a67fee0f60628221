"""Typed configuration (copy of ``mintime_tpu/config.py:17-142``).

Reads the reference's YAML schema verbatim (kebab-case keys under
``training:`` / ``test:`` / ``model:``) into frozen dataclasses. ``yaml`` is
imported only by :func:`load_config`, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

VALID_NUM_FRAMES = (8, 16, 32)


def _get(section: Mapping[str, Any], key: str, default):
    """Look up a kebab-case key, tolerating snake_case spellings too."""
    if key in section:
        return section[key]
    alt = key.replace("-", "_")
    if alt in section:
        return section[alt]
    return default


@dataclass(frozen=True)
class TrainingConfig:
    """Mirrors the ``training:`` YAML section."""

    lr: float = 0.01
    weight_decay: float = 1e-4
    bs: int = 8
    val_bs: int = 8
    optimizer: str = "SGD"  # SGD | Adam | AdamW
    scheduler: str = "cosinelr"  # steplr | cosinelr
    gamma: float = 0.1
    step_size: int = 5
    augmentation: str = "max"  # min | max
    momentum: float = 0.9
    rebalancing_real: float = 1.0
    rebalancing_fake: float = 1.0
    frames_per_video: int = 30


@dataclass(frozen=True)
class TestConfig:
    bs: int = 1


@dataclass(frozen=True)
class ModelConfig:
    """Mirrors the ``model:`` YAML section. Defaults are the flagship
    (F=16, 2 identities, dim 512, depth 9, heads 8, 49 patches)."""

    image_size: int = 224
    num_classes: int = 1
    num_frames: int = 16
    max_identities: int = 2
    num_patches: int = 49
    dim: int = 512
    depth: int = 9
    heads: int = 8
    dim_head: int = 64
    channels: int = 2048  # Xception 2048 | EfficientNet-B0 1280
    mlp_dim: int = 512  # baseline MLP hidden width
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    shift_tokens: bool = False
    enable_size_emb: bool = True
    enable_pos_emb: bool = True
    enable_identity_attention: bool = True
    identities_ordering: int = 0  # 0 size | 1 length | 2 random
    efficient_net_block: int = 20  # conv-timesformer feature tap

    def __post_init__(self):
        if self.num_frames not in VALID_NUM_FRAMES:
            raise ValueError(
                f"num-frames must be one of {VALID_NUM_FRAMES}, got {self.num_frames}"
            )
        if self.shift_tokens and self.dim < 3:
            raise ValueError("shift-tokens needs dim >= 3 (three shifted chunks)")

    @property
    def tokens(self) -> int:
        """Sequence length including CLS: 1 + F * num_patches."""
        return 1 + self.num_frames * self.num_patches


@dataclass(frozen=True)
class MintimeConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    test: TestConfig = field(default_factory=TestConfig)

    def as_reference_dict(self) -> dict:
        """Render back to the reference's nested kebab-case dict shape."""

        def kebab(d: Mapping[str, Any]) -> dict:
            return {k.replace("_", "-"): v for k, v in d.items()}

        return {
            "model": kebab(dataclasses.asdict(self.model)),
            "training": kebab(dataclasses.asdict(self.training)),
            "test": kebab(dataclasses.asdict(self.test)),
        }


def _build(cls, section: Mapping[str, Any] | None):
    section = section or {}
    kwargs = {}
    for f in dataclasses.fields(cls):
        sentinel = object()
        val = _get(section, f.name.replace("_", "-"), sentinel)
        if val is not sentinel and val is not None:
            kwargs[f.name] = val
    return cls(**kwargs)


def config_from_dict(raw: Mapping[str, Any]) -> MintimeConfig:
    return MintimeConfig(
        model=_build(ModelConfig, raw.get("model")),
        training=_build(TrainingConfig, raw.get("training")),
        test=_build(TestConfig, raw.get("test")),
    )


def load_config(path: str) -> MintimeConfig:
    """Load a reference-format YAML config."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw or {})
