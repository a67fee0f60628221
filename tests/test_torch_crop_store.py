"""``mintime_torch.data.crop_store`` against ``mintime_tpu.data.crop_store``:
the same crops give byte-identical packs, each package reads the other's,
the header parser gives the JAX package's sizes, and ``pack_video_dir`` on a
cv2-written PNG tree gives the JAX package's entries and bytes."""

import json
import os
import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mintime_torch.data import crop_store as port_cs  # noqa: E402
from mintime_tpu.data import crop_store as jax_cs  # noqa: E402


def _crops(seed=1):
    rng = np.random.default_rng(seed)
    return [
        ("0", 0, 0, rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)),
        ("0", 30, 0, rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)),
        ("1", 30, 1, rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)),
        (None, 60, 1, rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)),
    ]


@pytest.mark.parametrize("dims", [None, {"width": 1920, "height": 1080, "fps": 30}])
def test_packs_are_byte_identical_and_read_across(tmp_path, dims):
    crops = _crops()
    a, b = str(tmp_path / "port.pack"), str(tmp_path / "jax.pack")
    assert port_cs.write_pack(a, iter(crops), dims=dims) == jax_cs.write_pack(
        b, iter(crops), dims=dims) == len(crops)
    assert open(a, "rb").read() == open(b, "rb").read()
    for reader, path in ((port_cs.CropPack, b), (jax_cs.CropPack, a)):
        pack = reader(path)
        assert pack.dims == dims and len(pack) == len(crops)
        for i, (ident, frame, face, crop) in enumerate(crops):
            assert pack.entries[i][:5] == [ident, frame, face, *crop.shape[:2]]
            np.testing.assert_array_equal(pack.read(i), crop)


def test_pack_pickles_by_path_and_rejects_other_files(tmp_path):
    import pickle

    path = str(tmp_path / "crops.pack")
    port_cs.write_pack(path, iter(_crops()))
    pack = port_cs.CropPack(path)
    pack.read(0)  # opens the memmap
    again = pickle.loads(pickle.dumps(pack))
    assert again._mm is None and again.entries == pack.entries
    np.testing.assert_array_equal(again.read(2), pack.read(2))
    other = tmp_path / "x.bin"
    other.write_bytes(b"NOPE" + bytes(20))
    with pytest.raises(ValueError, match="not a crop pack"):
        port_cs.CropPack(str(other))


@pytest.mark.parametrize("ext", [".png", ".bmp", ".jpg"])
@pytest.mark.parametrize("shape", [(37, 53), (64, 48), (1, 300)])
def test_image_dims_header_matches_jax(tmp_path, ext, shape):
    img = np.random.default_rng(2).integers(0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / f"x{ext}")
    assert cv2.imwrite(path, img)
    got = port_cs.image_dims_header(path)
    assert got == jax_cs.image_dims_header(path) == (shape[1], shape[0])


def test_image_dims_header_of_other_files_is_none(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"not an image at all")
    assert port_cs.image_dims_header(str(path)) is None is jax_cs.image_dims_header(str(path))
    assert port_cs.image_dims_header(str(tmp_path / "absent.png")) is None


def _png_video(vdir, identities=2, loose=(120, 150), dims=True, seed=0):
    rng = np.random.default_rng(seed)
    for ident in range(identities):
        os.makedirs(os.path.join(vdir, str(ident)))
        for f in (0, 30, 60, 90):
            side = 40 + 8 * ident + f // 30
            cv2.imwrite(os.path.join(vdir, str(ident), f"{f}_{ident}.png"),
                        rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
    os.makedirs(vdir, exist_ok=True)
    for f in loose:
        cv2.imwrite(os.path.join(vdir, f"{f}_0.png"),
                    rng.integers(0, 256, (30, 30, 3), dtype=np.uint8))
    if dims:
        with open(os.path.join(vdir, "video_dims.json"), "w") as fh:
            json.dump({"width": 640, "height": 360, "fps": 25}, fh)


@pytest.mark.parametrize("layout", ["identities_and_loose", "loose_only", "no_sidecar"])
@pytest.mark.parametrize("remove_images", [False, True])
def test_pack_video_dir_matches_jax(tmp_path, layout, remove_images):
    src = str(tmp_path / "src")
    _png_video(src, identities=0 if layout == "loose_only" else 2,
               dims=layout != "no_sidecar")
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(src, port_dir)
    shutil.copytree(src, jax_dir)
    a = port_cs.pack_video_dir(port_dir, remove_images=remove_images)
    b = jax_cs.pack_video_dir(jax_dir, remove_images=remove_images)
    assert a == port_cs.find_pack(port_dir) and b == jax_cs.find_pack(jax_dir)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert port_cs.CropPack(a).entries == jax_cs.CropPack(b).entries
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert port_cs.pack_video_dir(port_dir) == a  # an existing pack is kept


def test_pack_video_dir_without_crops_writes_nothing(tmp_path):
    os.makedirs(tmp_path / "empty" / "0")
    assert port_cs.pack_video_dir(str(tmp_path / "empty")) is None
    assert port_cs.find_pack(str(tmp_path / "empty")) is None
