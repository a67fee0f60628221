"""``mintime_torch.preprocessing.split_dataset`` and ``stats`` against the JAX
package's copies on the same ForgeryNet-style lists and faces trees: the
same parsed rows, the same stratified split, byte-identical split lists and
CSVs, the same identity counts."""

import os
import shutil

import pytest

pytest.importorskip("pandas")

from mintime_torch.preprocessing import split_dataset as port_split  # noqa: E402
from mintime_torch.preprocessing import stats as port_stats  # noqa: E402
from mintime_tpu.preprocessing import split_dataset as jax_split  # noqa: E402
from mintime_tpu.preprocessing import stats as jax_stats  # noqa: E402


def _forgerynet(root):
    """ForgeryNet-style video lists (rows of two to four fields, the method
    class last) and a faces tree holding most of the training videos."""
    train, val = root / "train_list.txt", root / "val_list.txt"
    rows = []
    for i in range(60):
        cls = i % 4
        extra = " 1" if i % 3 == 0 else ""
        rows.append(f"x train_video_release/src/{i:03d}.mp4{extra} {cls}")
        if i % 7:
            os.makedirs(root / "faces" / "train" / "src" / f"{i:03d}" / "0")
    train.write_text("\n".join(rows) + "\n")
    val.write_text("\n".join(f"x val_video_release/v/{i}.mp4 {i % 3}" for i in range(9)) + "\n")
    return str(train), str(val), str(root / "faces")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_read_video_list_and_split_match_jax(tmp_path):
    train, _, _ = _forgerynet(tmp_path)
    rows = port_split.read_video_list(train)
    assert rows == jax_split.read_video_list(train) and len(rows) == 60
    by_class = {}
    for video, cls in rows:
        by_class.setdefault(cls, []).append(video)
    for seed in (1, 42):
        assert port_split.stratified_val_split(by_class, 0.1, seed) == \
            jax_split.stratified_val_split(by_class, 0.1, seed)


@pytest.mark.parametrize("move_files", [False, True])
def test_split_dataset_cli_matches_jax(tmp_path, move_files):
    train, val, faces = _forgerynet(tmp_path)
    shutil.copytree(faces, tmp_path / "faces_jax")
    for side, main, faces_dir in (("port", port_split.main, faces),
                                  ("jax", jax_split.main, str(tmp_path / "faces_jax"))):
        os.makedirs(tmp_path / side)
        main(["--train_list_file", train, "--validation_list_file", val, "--faces_path",
              faces_dir, "--output_path", str(tmp_path / side), "--seed", "3",
              *(["--move_files"] if move_files else [])])
    for split in ("train", "val", "test"):
        got = _read(tmp_path / "port" / f"{split}.csv")
        assert got == _read(tmp_path / "jax" / f"{split}.csv") and got
    assert sorted(os.listdir(os.path.join(faces))) == sorted(os.listdir(tmp_path / "faces_jax"))
    assert os.path.isdir(os.path.join(faces, "val")) == move_files


@pytest.fixture
def faces_tree(tmp_path):
    for v, n_ids in (("a", 1), ("b", 2), ("c", 3), ("d", 0)):
        os.makedirs(tmp_path / "faces" / "s" / v)
        for k in range(n_ids):
            d = tmp_path / "faces" / "s" / v / f"identity_{k}"
            d.mkdir()
            (d / "0_0.png").write_bytes(b"x")
            (d / f"{k + 3}_0.png").write_bytes(b"x")
    return str(tmp_path / "faces")


def test_stats_match_jax(faces_tree, tmp_path):
    assert port_stats.identity_counts(faces_tree) == jax_stats.identity_counts(faces_tree)
    plots = [str(tmp_path / side / "dist.png") for side in ("port", "jax")]
    got = port_stats.count_multi_identities(faces_tree, plots[0])
    assert got == jax_stats.count_multi_identities(faces_tree, plots[1]) == {1: 1, 2: 1, 3: 1}
    assert os.path.getsize(plots[0]) > 0
    assert port_stats.multi_identity_videos(faces_tree, 3) == \
        jax_stats.multi_identity_videos(faces_tree, 3) == [os.path.join(faces_tree, "s", "c")]
    csvs = [str(tmp_path / side / "structure.csv") for side in ("port", "jax")]
    assert port_stats.save_folder_structure(faces_tree, csvs[0]) == \
        jax_stats.save_folder_structure(faces_tree, csvs[1]) == 12
    assert _read(csvs[0]) == _read(csvs[1])


def test_merge_label_csv_matches_jax(tmp_path):
    parts = []
    for i in range(3):
        p = tmp_path / f"labels_{i}.csv"
        p.write_text("filename,label,split\n" + "".join(
            f"v{i}_{k}.mp4,{'FAKE' if k % 2 else 'REAL'},train\n" for k in range(4)))
        parts.append(str(p))
    outs = [str(tmp_path / f"{side}.csv") for side in ("port", "jax")]
    assert port_stats.merge_label_csv(parts, outs[0]) == \
        jax_stats.merge_label_csv(parts, outs[1]) == 12
    assert _read(outs[0]) == _read(outs[1])
