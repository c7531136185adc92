"""T1's host geometry (``tools/packed_kernels.py`` beside
``ops/csrc/packed_stream.cu``), in plain Python on the CPU: the tile
constants against the source, the grid, the shared memory of a
block, where each window word's bytes and each window row come from, and a
numpy replay of the kernel's tiling (``_torch_packed_emulator.py``) against
the plain version on ragged tiles, every stencil kind and ghost mode.

Every tolerance is 0. Tests that need a card carry the ``cuda`` marker.
"""

import re

import numpy as np
import pytest
import torch
from _torch_packed_emulator import emulate_t1

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk

SOURCE = kr.CSRC_DIR / "packed_stream.cu"


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SOURCE.read_text()).group(1))


def test_constants_match_the_source():
    assert pk.TILE_WORDS == _define("PK_TILE_WORDS")
    assert kr.PK_MAX_PLANES == _define("PK_MAX_PLANES")
    assert "#define PK_WIN_WORDS (PK_TILE_WORDS + 2)" in SOURCE.read_text()
    assert pk.WIN_WORDS == pk.TILE_WORDS + 2
    assert "packed_stream" in kr.SOURCES


@pytest.mark.parametrize("height,wp,tile_h,grid", [
    (4320, 1920, 16, (60, 270)), (97, 96, 16, (3, 7)), (33, 40, 32, (2, 2)),
    (40, 8, 16, (1, 3)), (1, 33, 1, (2, 1)),
])
def test_grid(height, wp, tile_h, grid):
    assert pk.packed_grid(height, wp, tile_h) == grid


def test_shared_memory_bytes():
    sep, corr, med = (ck._FAMILIES[f] for f in ("separable", "corr", "median"))
    # (16 + 4) rows of 34 words; then (16 + 4) x 128 floats
    assert pk.packed_smem_bytes(1, 16, 2, corr) == 20 * 34 * 4
    assert pk.packed_smem_bytes(1, 16, 2, sep) == 20 * 34 * 4 + 20 * 128 * 4
    assert pk.packed_smem_bytes(3, 96, 3, sep) == 3 * 102 * (136 + 512)
    assert pk.packed_smem_bytes(3, 16, 1, med) == 3 * 18 * 136
    # the largest tile a 3-plane separable group takes, and one row more
    assert pk.packed_smem_bytes(3, 113, 3, sep) <= ck.MAX_SMEM_BYTES
    assert pk.packed_smem_bytes(3, 114, 3, sep) > ck.MAX_SMEM_BYTES


@pytest.mark.parametrize("wp", [8, 9, 33, 40, 1920])
@pytest.mark.parametrize("mode", ["reflect101", "edge"])
def test_edge_words_take_edge_src(wp, mode):
    """The halo words of every window the grid loads hold the columns the
    golden padding gives (ck.edge_src); words the outputs never read (past
    the right halo word of a ragged tile) stay inside the row."""
    width = 4 * wp
    reach = pk.packed_grid(1, wp, 1)[0] * pk.TILE_WORDS  # one past the last window word
    for gw in range(-1, reach + 1):
        cols = pk.window_word_sources(gw, wp, mode)
        assert all(0 <= c < width for c in cols)
        if gw <= wp:
            assert cols == [ck.edge_src(4 * gw + k, width, mode) for k in range(4)], gw
    if wp == 8:  # word -1 of an 8-word row: its bytes reflect to columns 4, 3, 2, 1
        assert pk.window_word_sources(-1, 8, "reflect101") == [4, 3, 2, 1]
        assert pk.window_word_sources(8, 8, "reflect101") == [30, 29, 28, 27]


def test_interior_words_clamp():
    assert pk.window_word_sources(-1, 8, "interior") == [0, 0, 0, 0]
    assert pk.window_word_sources(8, 8, "interior") == [31, 31, 31, 31]


@pytest.mark.parametrize("mode", ["reflect101", "edge", "interior"])
def test_window_rows(mode):
    for height, halo in ((33, 2), (4, 3), (1080, 3)):
        for ty in range(-halo, height + 40):
            where, r = pk.window_row_source(ty, height, halo, mode, ghost=False)
            src = ck.edge_src(ty, height, mode)
            assert where == "image" and r == (src if src is not None else
                                              min(max(ty, 0), height - 1))
            assert pk.window_row_source(ty, height, halo, mode, ghost=True) == \
                ck.ghost_row_source(ty, height, halo)


# --------------------------------------------------------------------------
# The tiling replayed
# --------------------------------------------------------------------------


def _words(img):
    planes = [img] if img.ndim == 2 else [img[..., c] for c in range(img.shape[2])]
    return [pk.pack_words(torch.from_numpy(np.ascontiguousarray(p))) for p in planes]


@pytest.mark.parametrize("spec,shape,tile_h", [
    ("gaussian:5", (33, 160, 1), 16),  # ragged row and word tiles
    ("gaussian:7", (34, 32, 1), 32),  # 8 words, halo 3; last block of 2 rows
    ("sobel", (20, 136, 1), 7),
    ("median:5", (19, 64, 1), 8),
    ("erode:3", (17, 132, 1), 5),
    ("emboss:3", (21, 128, 1), 6),  # interior passthrough at tile edges
    ("edge_box", (18, 40, 1), 4),  # edge mode: no registry stencil has it
    ("grayscale,contrast:3.5", (13, 160, 3), 4),  # the pointwise form
    ("grayscale,contrast:3.5,emboss:3", (22, 136, 3), 8),
    ("sepia,gaussian:3", (15, 96, 3), 4),
])
def test_emulated_tiling_equals_plain(spec, shape, tile_h):
    if spec == "edge_box":
        import dataclasses

        (pw, st), = [([], dataclasses.replace(make_pipeline_ops("box:5")[0], name="box5e",
                                               edge_mode="edge"))]
    else:
        (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    h, w, c = shape
    img = synthetic_image(h, w, channels=c, seed=h)
    words = _words(img)
    want = pk.run_group_packed_words_plain(pw, st, words, h, w)
    got = emulate_t1(pw, st, [x.numpy() for x in words], h, w, tile_h=tile_h)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())


@pytest.mark.parametrize("spec", ["gaussian:5", "sobel", "emboss:3", "erode:3"])
@pytest.mark.parametrize("y0,local_h", [(0, 12), (12, 12), (24, 13)])
def test_emulated_ghost_tiling_equals_plain(spec, y0, local_h):
    image_h, width = 37, 96
    ref = synthetic_image(image_h, width, channels=1, seed=9)
    (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    h = st.halo
    rows = np.arange(y0 - h, y0 + local_h + h)
    ext = ref[np.clip(rows, 0, image_h - 1)]  # clamped at the image's edges
    tile, top, bot = ext[h:-h], ext[:h], ext[-h:]
    words, tops, bots = _words(tile), _words(top), _words(bot)
    want = pk.run_group_packed_words_plain(pw, st, words, local_h, width,
                                           ghosts=(tops, bots), y0=y0, image_h=image_h)
    got = emulate_t1(pw, st, [x.numpy() for x in words], local_h, width, tile_h=5,
                     ghosts=([x.numpy() for x in tops], [x.numpy() for x in bots]),
                     y0=y0, image_h=image_h)
    np.testing.assert_array_equal(got[0], want[0].numpy())


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_shared_memory_formula_matches_source(cuda_device):
    lib = kr.load("packed_stream")
    for args in [(3, 16, 2, 2, 0), (1, 16, 1, 0, 9), (3, 96, 3, 3, 40), (1, 7, 2, 5, 0)]:
        assert lib.packed_stream_smem_bytes(*args) == pk.packed_smem_bytes(*args)
