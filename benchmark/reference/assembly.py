"""MINTIME's input assembly for one video, as plain Python, NumPy and float32
PyTorch: which identity and face fills each of the F slots, the frame mask,
the identities mask, the token positions, the size buckets, and the
evaluation transform of each face crop (the longer side to the model's size,
cv2's INTER_AREA when it shrinks and INTER_CUBIC when it grows, then a black
pad to a square).

It follows the MINTIME reference repository's predict path: identities by
mean face width, at most ``max_identities`` kept, per-identity quotas with
the deficit passed on and surpluses banked, the rest padded (masked) on the
last identity; alternate-parity uniform subsampling in time; face areas not
halved against the halved video area.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

RANGE, BUCKETS = 5, 20
#: the reference's scale of the frame means before their softmax
SCALE = 50000.0


def quotas(n: int, frames: int) -> list[int]:
    return {1: [frames], 2: [frames // 2] * 2, 3: [frames // 3, frames // 3, frames // 4],
            4: [frames // 3, frames // 3, frames // 8, frames // 8]}[n]


def assign(counts: list[int], frames: int) -> list[int]:
    """Slots an identity: quotas, each deficit handed to the next identity,
    surpluses banked and handed back in order, the rest on the last."""
    n, c, bank = len(counts), list(counts), []
    if n == 1:
        c, bank = [frames], [0]
    else:
        q = quotas(n, frames)
        for i in range(n):
            if c[i] < q[i] and i < n - 1:
                c[i + 1] += q[i] - c[i]
                bank.append(0)
            elif c[i] > q[i]:
                bank.append(c[i] - q[i])
                c[i] = q[i]
            else:
                bank.append(0)
    total = sum(c)
    for i in range(n):
        if total >= frames:
            break
        add = min(bank[i], frames - total)
        c[i] += add
        total += add
    c[-1] += frames - total
    return c


def subsample(avail: int, need: int, parity: int) -> np.ndarray:
    if avail <= need:
        return np.arange(avail)
    lo, hi = (0, avail - 2) if parity % 2 else (1, avail - 1)
    return np.round(np.linspace(lo, hi, need)).astype(int)


def bucket(face_h: int, face_w: int, video_h: int, video_w: int) -> int:
    ratio = int(face_h * face_w * 100.0 / (video_w * video_h / 2.0))
    for i in range(BUCKETS):
        lo, hi = (0, RANGE) if i == 0 else (1 + i * RANGE, (i + 1) * RANGE)
        if lo <= ratio <= hi:
            return i + 1
    return BUCKETS


def plan(identities: dict, frames: int, patches: int, max_ids: int, parity: int = 1) -> dict:
    """``identities``: key -> [(frame index, face index, crop, box), ...].
    Returns each slot's (key, item or None), the mask, identities mask,
    positions and the cumulative frames of each kept identity."""
    ids = []
    for key, items in identities.items():
        items = sorted(items, key=lambda t: (t[0], t[1]))
        ids.append((str(key), items, float(np.mean([t[2].shape[1] for t in items]))))
    ids = sorted(ids, key=lambda x: x[2], reverse=True)[:max_ids]
    counts = assign([len(x[1]) for x in ids], frames)
    slots, mask, numbers = [], [], []
    for (key, items, _), quota in zip(ids, counts):
        order = np.argsort(np.asarray([t[0] for t in items]), kind="stable")
        chosen = order[subsample(len(order), quota, parity)]
        for fi in chosen:
            slots.append((key, items[fi]))
            numbers.append(items[fi][0])
            mask.append(True)
        for _ in range(quota - len(chosen)):
            slots.append((key, None))
            numbers.append(max(numbers) if numbers else 0)
            mask.append(False)
    idm = np.zeros((frames, frames), bool)
    start = 0
    for c in counts:
        idm[start:start + c, start:start + c] = True
        start += c
    rank = {f: r for r, f in enumerate(sorted(set(numbers)))}
    pos = [0] + [rank[f] * patches + p + 1 for f in numbers for p in range(patches)]
    return {"slots": slots, "mask": np.array(mask), "identities_mask": idm,
            "positions": np.array(pos, np.int64), "cum_frames": list(np.cumsum(counts)),
            "keys": [x[0] for x in ids]}


@functools.lru_cache(maxsize=1024)
def _area_weights(src: int, dst: int) -> torch.Tensor:
    """(dst, src): each source pixel's share of the output cell it overlaps."""
    s = src / dst
    w = torch.zeros(dst, src, dtype=torch.float64)
    for d in range(dst):
        a, b = d * s, min((d + 1) * s, src)
        for j in range(int(math.floor(a)), int(math.ceil(b))):
            w[d, j] = (min(b, j + 1) - max(a, j)) / (b - a)
    return w.float()


@functools.lru_cache(maxsize=1024)
def _cubic_weights(src: int, dst: int, a: float = -0.75) -> torch.Tensor:
    """(dst, src): Keys' cubic (A = -0.75) at half-pixel centres, taps
    clamped to the border."""
    w = torch.zeros(dst, src, dtype=torch.float64)
    for d in range(dst):
        x = (d + 0.5) * src / dst - 0.5
        x0 = math.floor(x)
        for j in range(x0 - 1, x0 + 3):
            t = abs(x - j)
            k = ((a + 2) * t - (a + 3)) * t * t + 1 if t < 1 else \
                ((a * t - 5 * a) * t + 8 * a) * t - 4 * a
            w[d, min(max(j, 0), src - 1)] += k
    return w.float()


def transform(crop: np.ndarray, size: int, device) -> torch.Tensor:
    """One BGR uint8 crop -> ``(size, size, 3)`` uint8 on ``device``."""
    h, w = crop.shape[:2]
    if max(h, w) != size:
        s = size / max(h, w)
        nh, nw = int(round(h * s)), int(round(w * s))
    else:
        nh, nw = h, w
    x = torch.from_numpy(np.ascontiguousarray(crop)).to(device).float()
    if (nh, nw) != (h, w):
        mk = _area_weights if nh <= h and nw <= w else _cubic_weights
        wy, wx = mk(h, nh).to(device), mk(w, nw).to(device)
        x = torch.einsum("yh,hwc,xw->yxc", wy, x, wx)
        x = torch.round(x).clamp(0, 255)
    out = torch.zeros(size, size, 3, device=device)
    top, left = (size - nh) // 2, (size - nw) // 2
    out[top:top + nh, left:left + nw] = x
    return out.to(torch.uint8)


def assemble(identities: dict, video_hw: tuple[int, int], m: dict, device) -> dict:
    """One video's inputs (batch axis first) and its plan."""
    p = plan(identities, m["num_frames"], m["num_patches"], m["max_identities"])
    size, frames, buckets = m["image_size"], [], []
    for _, item in p["slots"]:
        if item is None:
            frames.append(torch.zeros(size, size, 3, dtype=torch.uint8, device=device))
            buckets.append(0)
        else:
            crop = item[2]
            frames.append(transform(crop, size, device))
            buckets.append(bucket(crop.shape[0], crop.shape[1], *video_hw))
    return {"frames": torch.stack(frames)[None],
            "mask": torch.from_numpy(p["mask"])[None].to(device),
            "identities_mask": torch.from_numpy(p["identities_mask"])[None].to(device),
            "size_embedding": torch.tensor(buckets, device=device)[None],
            "positions": torch.from_numpy(p["positions"])[None].to(device), "plan": p}


def aggregate(maps: list[np.ndarray], frames: int, cum_frames: list[int],
              scale: float = SCALE) -> tuple[list[float], np.ndarray]:
    """MINTIME's per-identity attention shares from one video's last-layer CLS
    rows ``[space, time]``, each ``(H, 1 + F * n)``: the maximum over heads,
    space plus time, the frame means (the reference's split of 1 + F * n into
    F parts) scaled and soft-maxed, then summed over each identity's frames
    with the reference's frame-range arithmetic. Returns the shares and the
    soft-maxed frame vector."""
    combined = sum(np.asarray(m, np.float64).max(axis=0) for m in maps)
    means = np.array([g.mean() for g in np.array_split(combined, frames)]) * scale
    e = np.exp(means - means.max())
    share = e / e.sum()
    out = []
    for i, c in enumerate(cum_frames):
        lo = 0 if i == 0 else cum_frames[i - 1] - 1
        out.append(float(share[lo:c - 1].sum()))
    return out, share
