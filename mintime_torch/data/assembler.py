"""Multi-identity adaptive sequence assembly (copy of
``mintime_tpu/data/assembler.py:41-296``).

Pure metadata-in / index-plan-out functions: which identity and face fills
each of the ``F`` slots, the frame mask, the block-diagonal identities mask,
the temporally coherent token positions and the size buckets. All
raggedness stays here on the host, so the model only sees fixed shapes.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

RANGE_SIZE = 5
NUM_SIZE_BUCKETS = 20
#: (lo, hi) inclusive ranges per bucket
SIZE_EMB_RANGES = [
    (0, RANGE_SIZE) if i == 0 else (1 + i * RANGE_SIZE, (i + 1) * RANGE_SIZE)
    for i in range(NUM_SIZE_BUCKETS)
]


def max_faces_per_identity(num_frames: int) -> dict[int, list[int]]:
    """Fixed per-identity slot quotas keyed by number of identities."""
    return {
        1: [num_frames],
        2: [num_frames // 2, num_frames // 2],
        3: [num_frames // 3, num_frames // 3, num_frames // 4],
        4: [num_frames // 3, num_frames // 3, num_frames // 8, num_frames // 8],
    }


@dataclass
class IdentityFaces:
    """Metadata for one clustered identity within a video."""

    key: str  # identity name (e.g. "identity_0")
    frames: list[int]  # frame number of each available face, any order
    mean_side: float = 0.0  # mean face side in px (ordering criterion 0)

    @property
    def count(self) -> int:
        return len(self.frames)


@dataclass
class SequencePlan:
    """A fully-resolved fixed-shape plan for one video's input sequence."""

    identity_index: np.ndarray  # (F,) int32
    face_index: np.ndarray  # (F,) int32, -1 = dummy
    frame_numbers: np.ndarray  # (F,) int32
    mask: np.ndarray  # (F,) bool
    identities_mask: np.ndarray  # (F, F) bool
    positions: np.ndarray  # (1 + F*P,) int32
    #: (identity key, cumulative token count) pairs
    tokens_per_identity: list[tuple[str, int]] = field(default_factory=list)
    #: assigned face quota per identity, sums to F
    assigned: list[int] = field(default_factory=list)
    #: identity keys after sorting/truncation
    identity_keys: list[str] = field(default_factory=list)


def sort_identities(
    identities: Sequence[IdentityFaces],
    ordering: int = 0,
    rng: _random.Random | None = None,
) -> list[IdentityFaces]:
    """Order identities by size (0), length (1), or randomly (2)."""
    ids = list(identities)
    if ordering == 0:
        return sorted(ids, key=lambda x: x.mean_side, reverse=True)
    if ordering == 1:
        return sorted(ids, key=lambda x: x.count, reverse=True)
    (rng or _random).shuffle(ids)
    return ids


def assign_slots(face_counts: Sequence[int], num_frames: int) -> list[int]:
    """Split ``num_frames`` slots across identities (deficit flow, then
    back-fill from banked surpluses, then dummy padding on the last
    identity). Returns the count per identity; it sums to ``num_frames``."""
    n = len(face_counts)
    if n == 0:
        raise ValueError("need at least one identity")
    counts = [int(c) for c in face_counts]
    available_additional = []
    if n > 1:
        quotas = max_faces_per_identity(num_frames)[n]
        for i in range(n):
            if counts[i] < quotas[i] and i < n - 1:
                counts[i + 1] += quotas[i] - counts[i]
                available_additional.append(0)
            elif counts[i] > quotas[i]:
                available_additional.append(counts[i] - quotas[i])
                counts[i] = quotas[i]
            else:
                available_additional.append(0)
    else:
        counts[0] = num_frames
        available_additional.append(0)

    total = sum(counts)
    if total < num_frames:
        for i in range(n):
            needed = num_frames - total
            if available_additional[i] > 0:
                added = min(available_additional[i], needed)
                counts[i] += added
                total += added
                if total == num_frames:
                    break
        if total < num_frames:
            counts[-1] += num_frames - total
            total = num_frames
    return counts


def subsample_indices(n_available: int, n_needed: int, parity: int = 0) -> np.ndarray:
    """Alternating uniform temporal subsampling: even ``parity`` picks
    ``linspace(1, n-1)``, odd picks ``linspace(0, n-2)``."""
    if n_available <= n_needed:
        return np.arange(n_available)
    if parity % 2:
        return np.round(np.linspace(0, n_available - 2, n_needed)).astype(int)
    return np.round(np.linspace(1, n_available - 1, n_needed)).astype(int)


def build_identities_mask(assigned: Sequence[int], num_frames: int) -> np.ndarray:
    """(F, F) block-diagonal bool mask: row *i* is True over the slot range
    of the identity that owns slot *i*."""
    mask = np.zeros((num_frames, num_frames), dtype=bool)
    start = 0
    for c in assigned:
        mask[start : start + c, start : start + c] = True
        start += c
    return mask


def build_positions(frame_numbers: Sequence[int], num_patches: int) -> np.ndarray:
    """Token positions: distinct frame numbers are rank-ordered (1-based);
    patch *p* of a face from the rank-*r* frame gets ``(r-1)*P + p + 1``.
    Position 0 is the CLS token."""
    frame_numbers = np.asarray(frame_numbers, dtype=np.int64)
    uniq = np.unique(frame_numbers)  # sorted
    rank = {int(k): v + 1 for v, k in enumerate(uniq)}
    ranks = np.array([rank[int(f)] for f in frame_numbers], dtype=np.int64)
    pos = ((ranks - 1)[:, None] * num_patches + np.arange(1, num_patches + 1)[None, :]).reshape(-1)
    return np.concatenate([[0], pos]).astype(np.int32)


def size_bucket(
    face_h: float,
    face_w: float,
    video_h: float,
    video_w: float,
    legacy_predict_double_ratio: bool = False,
) -> int:
    """Quantized face/frame area ratio in [1, 20]; 0 is reserved for padding.
    Ratios above 100 clamp into the last bucket."""
    video_area = video_w * video_h / 2.0
    face_area = face_h * face_w / 2.0
    if legacy_predict_double_ratio:
        face_area = face_h * face_w  # the reference predict path omits the halving
    ratio = int(face_area * 100.0 / video_area)
    for i, (lo, hi) in enumerate(SIZE_EMB_RANGES):
        if lo <= ratio <= hi:
            return i + 1
    return NUM_SIZE_BUCKETS  # clamp


def build_sequence_plan(
    identities: Sequence[IdentityFaces],
    num_frames: int,
    num_patches: int,
    max_identities: int = 2,
    ordering: int = 0,
    parity: int = 0,
    rng: _random.Random | None = None,
    legacy_all_ones_mask: bool = False,
) -> SequencePlan:
    """Assemble the complete fixed-shape plan for one video: sort, truncate,
    assign slots, subsample each identity in time, pad with dummies (which
    repeat the running max frame number), and build the side tensors."""
    ids = sort_identities(identities, ordering, rng)[:max_identities]
    if not ids:
        raise ValueError("no identities for video")
    assigned = assign_slots([i.count for i in ids], num_frames)

    identity_index: list[int] = []
    face_index: list[int] = []
    frame_numbers: list[int] = []
    mask: list[bool] = []
    for ident_i, (ident, quota) in enumerate(zip(ids, assigned)):
        order = np.argsort(np.asarray(ident.frames, dtype=np.int64), kind="stable")
        chosen = order[subsample_indices(len(order), quota, parity)]
        for fi in chosen:
            identity_index.append(ident_i)
            face_index.append(int(fi))
            frame_numbers.append(int(ident.frames[fi]))
            mask.append(True)
        n_pad = quota - len(chosen)
        for _ in range(n_pad):
            identity_index.append(ident_i)
            face_index.append(-1)
            frame_numbers.append(max(frame_numbers) if frame_numbers else 0)
            mask.append(bool(legacy_all_ones_mask))

    positions = build_positions(frame_numbers, num_patches)
    identities_mask = build_identities_mask(assigned, num_frames)

    cum = 0
    tokens_per_identity = []
    for ident, quota in zip(ids, assigned):
        cum += quota * num_patches
        tokens_per_identity.append((ident.key, cum))

    return SequencePlan(
        identity_index=np.asarray(identity_index, dtype=np.int32),
        face_index=np.asarray(face_index, dtype=np.int32),
        frame_numbers=np.asarray(frame_numbers, dtype=np.int32),
        mask=np.asarray(mask, dtype=bool),
        identities_mask=identities_mask,
        positions=positions,
        tokens_per_identity=tokens_per_identity,
        assigned=list(assigned),
        identity_keys=[i.key for i in ids],
    )
