"""The port's train-mode augmentations (``mintime_torch.data.augment_plan``
draws them, ``mintime_torch.data.augment`` applies them in torch) against
the JAX package's (``mintime_tpu/data/augment.py``: numpy and cv2), on the
CPU at ``S`` = 224, 4 frames (the last a black dummy slot, as the dataset
gives).

* The draws: for ``min`` and ``max`` over 50 seeds, the steps and their
  parameters, arrays included, and the generator's state after them, are
  exactly the JAX draws.
* Each transform on the same frames and parameters, over seeded draws and
  the ends of its ranges. Bitwise equal: HorizontalFlip, InvertImg,
  CoarseDropout, RandomBrightnessContrast, RandomGamma, RGBShift, GaussNoise,
  MultiplicativeNoise, MedianBlur. Every other transform within one level on
  at most 1e-3 of the values; the share measured against OpenCV 5.0 (with
  numpy 2) is 0 for every one of them: the port computes what cv2 computes
  (fixed-point filters and colour conversions, its float32 fused
  multiply-adds, libjpeg-turbo's integer codec, numpy's float32 pairwise
  sums for the per-frame statistics).
* Both presets end to end at seeds chosen so that every member of the preset
  fires at least once across them, on crops already ``S`` x ``S``, and from
  crops that shrink, grow and pad through every member of the resize
  chain's OneOf: bitwise.
* The resizes on their own: INTER_LINEAR, and INTER_CUBIC both on OpenCV's
  own path (a side under 4) and on the IPP path it hands the rest to:
  bitwise.
"""

import inspect

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch.data import augment as pa  # noqa: E402
from mintime_torch.data import augment_plan as ap  # noqa: E402
from mintime_tpu.data import augment as ja  # noqa: E402

S, F = 224, 4
BITWISE = ("HorizontalFlip", "InvertImg", "CoarseDropout", "RandomBrightnessContrast",
           "RandomGamma", "RGBShift", "GaussNoise", "MultiplicativeNoise", "MedianBlur")
#: seeds at which, together, every member of the preset fires
COVER_SEEDS = {"min": (2, 33, 19779), "max": (510, 1092, 3233, 3591, 8437, 11009)}


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many small torch ops on the CPU: one thread each, so
    that the parallel test run's workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames(seed, size=S, n=F):
    """Face-like frames: a tinted gradient, noise of std 20 and an offset;
    the last frame black (a dummy slot)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([xx, yy, (xx + yy) // 2], -1) * r.uniform(0.3, 1.0)
    out = [np.clip(base + r.normal(0, 20, (size, size, 3)) + r.integers(0, 60), 0, 255)
           .astype(np.uint8) for _ in range(n - 1)]
    return out + [np.zeros((size, size, 3), np.uint8)]


def _mult(value):
    return {"m": np.full((S, S, 3), value, np.float32)}


def _noise(var, seed=0):
    r = np.random.default_rng(seed)
    return {"noise": r.standard_normal((S, S, 3), dtype=np.float32) * np.float32(np.sqrt(var))}


def _motion(k, angle):
    """MotionBlur's kernel for ``k`` and ``angle`` (its ``sample`` with the
    draws fixed)."""
    import math

    kernel = np.zeros((k, k), np.float32)
    c = (k - 1) / 2
    dx, dy = math.cos(math.radians(angle)), math.sin(math.radians(angle))
    for t in np.linspace(-c, c, k * 2):
        x, y = int(round(c + t * dx)), int(round(c + t * dy))
        if 0 <= x < k and 0 <= y < k:
            kernel[y, x] = 1
    return {"kernel": kernel / max(kernel.sum(), 1)}


#: the ends of each transform's ranges
EXTREMES = {
    "HorizontalFlip": [{}], "InvertImg": [{}], "ToGray": [{}], "ToSepia": [{}],
    "CoarseDropout": [{"holes": [(0, 0, 8, 8), (S - 13, S - 13, 12, 12), (100, 0, 1, 12)]}],
    "RandomBrightnessContrast": [{"alpha": 0.8, "beta": -51.0}, {"alpha": 1.2, "beta": 51.0}],
    "RandomGamma": [{"gamma": 0.8}, {"gamma": 1.2}],
    "RGBShift": [{"shift": np.array([-20.0, 20.0, -20.0])}, {"shift": np.array([20.0, 0.0, -0.5])}],
    "GaussNoise": [_noise(10.0, 1), _noise(50.0, 2)],
    "MultiplicativeNoise": [_mult(0.9), _mult(1.1)],
    "RandomFog": [{"coef": 0.1}, {"coef": 0.4}],
    "HueSaturationValue": [{"dh": -20.0, "ds": -30.0, "dv": -20.0},
                           {"dh": 20.0, "ds": 30.0, "dv": 20.0}],
    "ColorJitter": [{"b": 0.8, "c": 0.8, "s": 0.8, "h": -3.6},
                    {"b": 1.2, "c": 1.2, "s": 1.2, "h": 3.6}],
    "FancyPCA": [{"coeffs": np.array([0.3, -0.3, 0.3])}, {"coeffs": np.array([-0.25, 0.2, 0.0])}],
    "ISONoise": [{"shift": 0.01, "intensity": 0.1, "seed": 1},
                 {"shift": 0.05, "intensity": 0.5, "seed": 2}],
    "CLAHE": [{"clip": 1.0}, {"clip": 4.0}],
    "GaussianBlur": [{"k": 3}, {"k": 5}],
    "MedianBlur": [{"k": 3}, {"k": 5}, {"k": 7}],
    "MotionBlur": [_motion(3, 0.0), _motion(4, 45.0), _motion(7, 90.0), _motion(6, 179.9)],
    "GlassBlur": [{"seed": 0}, {"seed": 2**31 - 1}],
    "ShiftScaleRotate": [{"dx": -0.1, "dy": 0.1, "scale": 0.8, "angle": -5.0},
                         {"dx": 0.1, "dy": -0.1, "scale": 1.2, "angle": 5.0}],
    "RandomShadow": [{"pts": np.array([[0, 0], [S - 1, 0], [0, S - 1], [S - 1, S - 1]], np.int32),
                      "strength": 0.3},
                     {"pts": np.array([[10, 200], [180, 30], [200, 210], [5, 5]], np.int32),
                      "strength": 0.7}],
    "RandomRain": [{"drops": np.array([[0, 0], [S - 1, S - 3], [50, 100]]), "length": 5},
                   {"drops": np.array([[0, S - 1], [S - 1, 0], [7, 7]]), "length": 14}],
    "RandomSunFlare": [{"center": (0, 0), "radius": S // 6 + 1},
                       {"center": (S - 1, S // 2), "radius": S // 3 + 1}],
    "ImageCompression": [{"quality": 60}, {"quality": 100}],
    "Downscale": [{"scale": 0.25}, {"scale": 0.5}],
}
NAMES = sorted(pa.STACK_STEPS)


def _compare(got, want, bitwise, what):
    """Bitwise, or within one level on at most 1e-3 of the values; returns
    the share of values that differ."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    diff = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    assert diff.shape == np.asarray(want).shape
    share = float((diff > 0).mean())
    if bitwise:
        assert diff.max() == 0, (what, int(diff.max()), share)
    else:
        assert diff.max() <= 1 and share <= 1e-3, (what, int(diff.max()), share)
    return share


def test_every_transform_of_the_presets_is_ported():
    names = {t.name for aug in ("min", "max") for t in _transforms(ap.create_train_plan(S, aug))}
    assert names - set(pa.CROP_STEPS) <= set(pa.STACK_STEPS)
    assert set(EXTREMES) == set(pa.STACK_STEPS)
    with pytest.raises(ValueError, match="not ported"):
        pa.apply_step(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), (ap.Transform(), {}))


@pytest.mark.parametrize("name", NAMES)
def test_transform_matches_jax(name):
    pt, jt = getattr(ap, name)(), getattr(ja, name)()
    cases = [pt.sample(np.random.default_rng(100 + s), (S, S, 3)) for s in range(3)]
    cases += EXTREMES[name]
    for i, params in enumerate(cases):
        fr = frames(i)
        want = np.stack([jt.apply(f, **params) for f in fr])
        got = pa.apply_step(torch.from_numpy(np.stack(fr)), (pt, params))
        assert got.dtype == torch.uint8
        _compare(got, want, name in BITWISE, (name, i))


def _recorder(monkeypatch):
    """Record every JAX ``sample`` call as ``(class name, params)``."""
    rec = []
    for _, cls in inspect.getmembers(ja, inspect.isclass):
        if issubclass(cls, ja.Transform) and "sample" in cls.__dict__:
            def wrapped(self, rng, shape, _orig=cls.__dict__["sample"]):
                out = _orig(self, rng, shape)
                rec.append((type(self).__name__, out))
                return out
            monkeypatch.setattr(cls, "sample", wrapped)
    return rec


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("aug", ["min", "max"])
def test_draws_match_jax_over_50_seeds(monkeypatch, aug):
    rec = _recorder(monkeypatch)
    jt, plan = ja.create_train_transforms(S, aug), ap.create_train_plan(S, aug)
    small = [np.zeros((40, 40, 3), np.uint8)] * 2  # the resize chain's draws need no pixels
    fired = set()
    for seed in range(50):
        r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
        rec.clear()
        jt(list(small), r_jax)
        steps = plan([c.shape for c in small], r_port)
        got = [(t.name, params) for t, params in steps]
        assert _same(got, rec), seed
        assert r_port.bit_generator.state == r_jax.bit_generator.state, seed
        fired |= {name for name, _ in got}
    assert {"IsotropicResize", "PadIfNeeded", "Resize", "ShiftScaleRotate"} <= fired


@pytest.mark.parametrize("aug", ["min", "max", "any other name"])
def test_a_name_other_than_min_gives_max(aug):
    def names(plan):
        return [type(t).__name__ for t in plan.transforms]

    want = names(ja.create_train_transforms(S, aug))
    assert names(ap.create_train_plan(S, aug)) == want
    assert (aug == "min") == (want != names(ap.create_train_plan(S, "max")))


def _crops(seed):
    """Crops of a video: a face shrunk, one grown, one wide, a dummy slot."""
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (300, 300, 3), dtype=np.uint8),
            frames(seed, 150, 2)[0], r.integers(0, 256, (120, 160, 3), dtype=np.uint8),
            np.zeros((S, S, 3), np.uint8)]


def _transforms(t):
    if isinstance(t, (ap.Compose, ap.OneOf)):
        return [x for c in t.transforms for x in _transforms(c)]
    return [t]


@pytest.mark.parametrize("aug", ["min", "max"])
def test_presets_end_to_end(aug):
    """The whole preset at ``COVER_SEEDS`` on ``S`` x ``S`` frames; every
    member fires across them."""
    jt, plan = ja.create_train_transforms(S, aug), ap.create_train_plan(S, aug)
    members = {id(t): i for i, t in enumerate(_transforms(plan))}
    fired, names = set(), {}
    for seed in COVER_SEEDS[aug]:
        crops = frames(seed)
        want = jt(list(crops), np.random.default_rng(seed))
        steps = plan([c.shape for c in crops], np.random.default_rng(seed))
        got = pa.train_transform(crops, steps, device="cpu")
        names[seed] = [t.name for t, _ in steps]
        fired |= {members[id(t)] for t, _ in steps}
        _compare(got, want, True, (aug, seed, names[seed]))
    assert fired == set(members.values()), (sorted(set(members.values()) - fired), names)


@pytest.mark.parametrize("aug", ["min", "max"])
def test_presets_from_crops_of_any_size(aug):
    """Both presets from crops that shrink, grow and pad, at 30 seeds each,
    every member of the resize chain's OneOf among them: every video, and
    its stack after the chain, bitwise equal to the JAX package's."""
    jt, plan = ja.create_train_transforms(S, aug), ap.create_train_plan(S, aug)
    chains = set()
    for seed in range(30):
        crops = _crops(seed)
        want = jt(list(crops), np.random.default_rng(seed))
        steps = plan([c.shape for c in crops], np.random.default_rng(seed))
        stack, rest = pa.resize_chain(crops, steps, device="cpu")
        chain = ja.Compose(jt.transforms[:3])(list(crops), np.random.default_rng(seed))
        _compare(stack, chain, True, (aug, seed, "resize chain"))
        _compare(pa.apply_steps(stack, rest), want, True, (aug, seed, [t.name for t, _ in rest]))
        chains.add((steps[0][0].down, steps[0][0].up))
    assert chains == {("area", "cubic"), ("area", "linear"), ("linear", "linear")}, chains


def test_drawing_matches_cv2():
    """The masks of ``mintime_torch.data.draw`` against cv2's own drawing on
    seeded shapes: polygons of 3 to 6 points (crossing themselves or not),
    lines that leave the image, filled circles cut by its edges."""
    from mintime_torch.data import draw

    r = np.random.default_rng(5)
    for i in range(400):
        h, w = ((S, S), (64, 64), (100, 37))[i % 3]
        pts = r.integers(0, [w, h], size=(3 + i % 4, 2)).astype(np.int32)
        want = np.ones((h, w), np.float32)
        cv2.fillPoly(want, [pts.reshape(-1, 1, 2)], 0.4)
        got = np.ones((h, w), np.float32)
        draw.fill_poly(got, pts, np.float32(0.4))
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))
        p0, p1 = (tuple(int(v) for v in r.integers(-20, 250, 2)) for _ in range(2))
        want = np.zeros((h, w), np.uint8)
        cv2.line(want, p0, p1, 1, 1)
        got = np.zeros((h, w), np.uint8)
        draw.line(got, p0, p1, 1)
        np.testing.assert_array_equal(got, want, err_msg=str((p0, p1)))
        c, rad = (int(r.integers(0, w)), int(r.integers(0, h))), int(r.integers(1, 80))
        want = np.zeros((h, w), np.uint8)
        cv2.circle(want, c, rad, 1, -1)
        got = np.zeros((h, w), np.uint8)
        draw.fill_circle(got, c, rad, 1)
        np.testing.assert_array_equal(got, want, err_msg=str((c, rad)))


def test_resize_inter_linear_matches_cv2():
    """cv2's 8-bit INTER_LINEAR (11-bit fixed point in OpenCV
    5.0) both ways, at the sizes the train chain gives it: bitwise."""
    r = np.random.default_rng(0)
    for (h, w, nh, nw) in ((100, 80, 224, 179), (300, 250, 224, 187), (57, 40, 224, 157),
                           (448, 448, 224, 224), (224, 100, 224, 224), (1, 5, 3, 7)):
        img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        got = pa.resize(torch.from_numpy(img), nh, nw, "linear")
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sides", ["small", "any", "large"])
def test_resize_inter_cubic_matches_cv2(sides):
    """cv2's 8-bit INTER_CUBIC growing a crop, as the chain and the
    evaluation transform use it: OpenCV's own path when a side is under 4,
    IPP's otherwise, and past ~700 px (weights under 2**-20, rows summed
    with rounding to odd); random, two-level and smooth crops, bitwise."""
    r = np.random.default_rng(["small", "any", "large"].index(sides))
    for i in range(60 if sides != "large" else 2):
        h, w = r.integers(1, 12, 2) if sides == "small" else r.integers(4, 224, 2)
        if i % 2:
            h = r.integers(1, 224)
        side = (224, 160, 300)[i % 3] if sides != "large" else 1024
        if max(h, w) >= side:
            continue
        nh, nw = pa.isotropic_size(int(h), int(w), side)
        img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 3 == 1:
            img = np.where(img > 127, 255, 0).astype(np.uint8)
        elif i % 3 == 2 and min(h, w) > 5:
            img = cv2.GaussianBlur(img, (5, 5), 0)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC)
        got = pa.resize(torch.from_numpy(img), nh, nw, "cubic")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str((h, w, nh, nw)))


def test_fma_f32_rounds_once():
    """``fma_f32`` is float32 ``a * b + c`` with one rounding: against exact
    rational arithmetic on random triples and on products that land on a
    float32 tie, where a small ``c`` decides and rounding twice would not
    see it."""
    from fractions import Fraction

    r = np.random.default_rng(0)
    a = (r.standard_normal(300) * 100).astype(np.float32)
    b = r.standard_normal(300).astype(np.float32)
    c = (r.standard_normal(300) * 100).astype(np.float32)
    tie = np.float32(1 + 2**-12)  # tie * tie = 1 + 2**-11 + 2**-24, half a float32 step
    a = np.concatenate([a, [tie, tie, -tie, tie]]).astype(np.float32)
    b = np.concatenate([b, [tie, tie, tie, tie]]).astype(np.float32)
    c = np.concatenate([c, [2.0**-80, -(2.0**-80), 2.0**-80, 0.0]]).astype(np.float32)
    got = pa.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = [v for v, e in zip(cands, errs) if e == min(errs)]
        want = best[0] if len(best) == 1 else next(
            v for v in best if not np.float32(v).view(np.int32) & 1)
        assert g == want, (x, y, z, g, want)


@pytest.mark.parametrize("down,up", [("area", "cubic"), ("area", "linear"), ("linear", "linear")])
def test_resize_chain_matches_jax(down, up):
    """IsotropicResize → PadIfNeeded → Resize crop by crop, each member of
    the chain's OneOf, on crops that shrink, grow and pad: bitwise."""
    cv = {"area": cv2.INTER_AREA, "cubic": cv2.INTER_CUBIC, "linear": cv2.INTER_LINEAR}
    chain_j = ja.Compose([ja.IsotropicResize(S, cv[down], cv[up]), ja.PadIfNeeded(S, S),
                          ja.Resize(S, S)])
    steps = [(ap.IsotropicResize(S, down, up), {}), (ap.PadIfNeeded(S, S), {}),
             (ap.Resize(S, S), {})]
    crops = _crops(7)
    want = chain_j(list(crops), np.random.default_rng(0))
    got, rest = pa.resize_chain(crops, steps, device="cpu")
    assert rest == []
    _compare(got, want, True, (down, up))


def test_numpy_float32_statistics_to_the_bit():
    """The per-frame mean and deviation that ColorJitter and ISONoise read
    are numpy's float32 ones exactly (blocks of 8192, pairwise inside)."""
    r = np.random.default_rng(3)
    for shape in ((224, 224, 3), (64, 64, 3), (7, 3, 3), (100, 130, 3)):
        x = (r.integers(0, 256, (4,) + shape).astype(np.float32) * np.float32(r.uniform(0.8, 1.2)))
        mean, std = pa.np_mean_std_f32(torch.from_numpy(x.reshape(4, -1)))
        for i in range(4):
            assert mean[i].item() == x[i].mean() and std[i].item() == x[i].std()
