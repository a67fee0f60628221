"""The kernel build's cache key (``mintime_torch/ops/_build.py``): a library
is keyed on its source, every header that source includes with
``#include "..."`` and the flags, so an edited header rebuilds the kernels
that include it. Needs no ``nvcc``: only the target paths are computed."""

import pytest

from mintime_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\nint b;\n')
    (tmp_path / "other.cuh").write_text("int other;\n")
    return tmp_path


def test_sources_follow_quoted_includes_once(csrc):
    assert [p.name for p in _build._sources(csrc / "k.cu")] == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited,changes", [("k.cu", True), ("a.cuh", True), ("b.cuh", True),
                                            ("other.cuh", False)])
def test_target_changes_when_an_included_file_changes(csrc, edited, changes):
    before = _build._target("k")
    (csrc / edited).write_text((csrc / edited).read_text() + "// edited\n")
    assert (_build._target("k") != before) == changes
    assert _build._target("k", ("X=1",)) != _build._target("k")


def test_attention_backward_key_covers_the_mma_header():
    """The divided backward rebuilds when its token-row launches (shared
    with the token-row backward), the row-tile routines or the mma helpers
    change."""
    names = [p.name for p in _build._sources(_build.CSRC / "divided_attention_bwd.cu")]
    assert names == ["divided_attention_bwd.cu", "attn_bwd_rows_mma.cuh", "attn_rows_mma.cuh",
                     "warp_mma.cuh"]


@pytest.mark.parametrize("name,headers", [
    ("token_rows_attention", ["token_rows_tile.cuh", "attn_rows_mma.cuh", "warp_mma.cuh"]),
    ("token_rows_attention_bwd", ["attn_bwd_rows_mma.cuh", "token_rows_tile.cuh",
                                  "attn_rows_mma.cuh", "warp_mma.cuh"])])
def test_token_rows_keys_cover_the_tile_headers(name, headers):
    """The token-row kernels rebuild when their tile, the shared row
    launches or the mma helpers under them change."""
    names = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
    assert names == [f"{name}.cu", *headers]


#: the headers each tensor-core forward includes, in the order first met
FORWARD_HEADERS = {
    "divided_attention": ["attn_rows_mma.cuh", "cls_row_fwd.cuh", "warp_mma.cuh"],
    "grouped_attention": ["attn_rows_mma.cuh", "warp_mma.cuh"],
    "chunked_attention": ["attn_rows_mma.cuh", "cls_row_fwd.cuh", "warp_mma.cuh"],
}


@pytest.mark.parametrize("name", ["divided_attention", "grouped_attention", "chunked_attention"])
def test_forward_keys_cover_the_row_tile_header(name):
    """The tensor-core forwards rebuild when the row-tile routine, the mma
    helpers under it or (divided and chunked) the CLS row's launches
    change."""
    names = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
    assert names == [f"{name}.cu", *FORWARD_HEADERS[name]]


def test_ffn_backward_key_covers_the_product_header():
    """The FFN backward rebuilds when the product core or the mma helpers
    under it change."""
    names = [p.name for p in _build._sources(_build.CSRC / "geglu_ffn_bwd.cu")]
    assert names == ["geglu_ffn_bwd.cu", "gemm_mma.cuh", "warp_mma.cuh"]


def test_ffn_forward_key_covers_the_warpgroup_header():
    """The FFN forward rebuilds when the warpgroup product core changes."""
    names = [p.name for p in _build._sources(_build.CSRC / "geglu_ffn.cu")]
    assert names == ["geglu_ffn.cu", "gemm_wgmma.cuh"]


def test_dw_conv_key_covers_the_copy_helpers():
    names = [p.name for p in _build._sources(_build.CSRC / "dw_conv.cu")]
    assert names == ["dw_conv.cu", "warp_mma.cuh"]
