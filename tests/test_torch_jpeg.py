"""The port's JPEG round trip (``mintime_torch.data.jpeg``: integer torch,
no codec) against ``cv2.imencode`` / ``cv2.imdecode`` (libjpeg-turbo: 4:2:0,
islow DCTs, fancy upsampling) at qualities 60, 75, 90 and 100, on noise,
smooth gradients, 8-pixel blocks and crops whose sides are not multiples of
16. Bound: one level on at most 1e-3 of the values; measured against
OpenCV 5.0 on libjpeg-turbo 3.1: bitwise equal everywhere."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch.data import jpeg  # noqa: E402

QUALITIES = (60, 75, 90, 100)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many small torch ops on the CPU: one thread each, so
    that the parallel test run's workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gradient(h, w, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a, b = r.uniform(0.2, 1.0, 2)
    return np.clip(np.stack([xx * 255 / w * a, yy * 255 / h * b, (xx + yy) * 127 / (h + w) + 60],
                            -1), 0, 255).astype(np.uint8)


def _images():
    r = np.random.default_rng(0)
    return {
        "noise_224": r.integers(0, 256, (224, 224, 3), dtype=np.uint8),
        "gradient_224": _gradient(224, 224, 1),
        "blocks_64": np.kron(r.integers(0, 256, (8, 8, 3)), np.ones((8, 8, 1))).astype(np.uint8),
        "noise_75x101": r.integers(0, 256, (75, 101, 3), dtype=np.uint8),
        "gradient_37x53": _gradient(37, 53, 2),
        "noisy_gradient_130x97": np.clip(_gradient(130, 97, 3) + r.normal(0, 12, (130, 97, 3)),
                                         0, 255).astype(np.uint8),
        "one_pixel_row_1x9": r.integers(0, 256, (1, 9, 3), dtype=np.uint8),
        "saturated_17x17": (r.integers(0, 2, (17, 17, 3)) * 255).astype(np.uint8),
    }


def _cv2_roundtrip(img, quality):
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("name", sorted(_images()))
def test_roundtrip_matches_cv2(name, quality):
    img = _images()[name]
    want = _cv2_roundtrip(img, quality)
    got = jpeg.jpeg_roundtrip(torch.from_numpy(img), quality)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (int(diff.max()), (diff > 0).mean())


def test_frames_code_on_their_own():
    """A stack of frames gives each frame's own round trip."""
    imgs = _images()
    stack = np.stack([imgs["noise_224"], imgs["gradient_224"]])
    got = jpeg.jpeg_roundtrip(torch.from_numpy(stack), 61)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), _cv2_roundtrip(stack[i], 61))


@pytest.mark.parametrize("quality,first", [(1, 255), (50, 16), (60, 13), (100, 1)])
def test_quality_scaling_is_ijg(quality, first):
    assert jpeg.quant_table(jpeg._LUMA, quality)[0] == first
