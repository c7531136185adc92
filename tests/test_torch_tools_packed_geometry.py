"""T1's host geometry (``tools/packed_kernels.py`` beside
``ops/csrc/packed_stream.cu``), in plain Python on the CPU: the constants
against the source, the grid of strips and runs, the shared memory of a
block, where each window byte's column and each window row come from, and a
numpy replay of the kernel's strips, runs and chunks
(``_torch_packed_emulator.py``) against the plain version on ragged
strips, every stencil kind and ghost mode.

Every tolerance is 0. Tests that need a card carry the ``cuda`` marker.
"""

import re

import numpy as np
import pytest
import torch
from _torch_packed_emulator import emulate_t1
from _torch_tools_emulator import emulate_planar

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk

SOURCE = kr.CSRC_DIR / "packed_stream.cu"
BODY = kr.CSRC_DIR / "packed_run.cuh"


def _define(name, source=SOURCE):
    return int(re.search(rf"#define {name} (\d+)", source.read_text()).group(1))


def test_constants_match_the_source():
    assert pk.TILE_WIDTHS == (_define("PK_MAX_TILE_W"), 16, _define("PK_MIN_TILE_W"))
    assert "tile_w == PK_MIN_TILE_W || tile_w == 16 || tile_w == PK_MAX_TILE_W" in \
        SOURCE.read_text()
    assert pk.MAX_CHUNK_H == _define("PK_MAX_CHUNK_H") and 1 <= pk.CHUNK_H <= pk.MAX_CHUNK_H
    assert pk.PREFETCH == _define("PK_PREFETCH")
    assert pk.RAW_SLOTS == pk.PREFETCH + 1 and pk.ROW_SLOTS == pk.PREFETCH + 2
    assert "#define PK_RAW_SLOTS (PK_PREFETCH + 1)" in SOURCE.read_text()
    assert "#define PK_ROW_SLOTS (PK_PREFETCH + 2)" in SOURCE.read_text()
    assert kr.PK_MAX_PLANES == _define("PK_MAX_PLANES") == _define("PR_MAX_PLANES", BODY)
    assert pk.RUN_WORDS == _define("PR_RUN_WORDS", BODY)
    assert pk.N_SMS == ck.N_SMS
    assert "packed_stream" in kr.SOURCES and "packed_proto" in kr.SOURCES


@pytest.mark.parametrize("height,wp,tile_w,run_h,grid", [
    (4320, 1920, 32, 96, (60, 45)), (97, 96, 32, 32, (3, 4)), (33, 40, 16, 64, (3, 1)),
    (40, 8, 8, 32, (1, 2)), (1, 33, 8, 32, (5, 1)),
])
def test_grid(height, wp, tile_w, run_h, grid):
    assert pk.packed_grid(height, wp, tile_w, run_h) == grid


@pytest.mark.parametrize("height,wp", [(4320, 1920), (1080, 1920), (97, 96), (40, 8),
                                       (2160, 960), (3, 75), (200000, 8)])
def test_tile_shape(height, wp):
    """The strips narrow only while that adds blocks, until one chunk a block
    gives N_SMS; runs are whole chunks, about TARGET_BLOCKS blocks, never
    more than 65535 runs."""
    tile_w, run_h = pk.packed_tile_shape(height, wp)
    assert tile_w in pk.TILE_WIDTHS and run_h % pk.CHUNK_H == 0 and run_h >= pk.CHUNK_H
    strips, runs = pk.packed_grid(height, wp, tile_w, run_h)
    assert runs <= 65535
    wider = [w for w in pk.TILE_WIDTHS if w > tile_w]
    for w in wider:  # each wider strip was short of N_SMS single-chunk blocks
        assert np.prod(pk.packed_grid(height, wp, w, pk.CHUNK_H)) < pk.N_SMS
    chunks = pk.packed_grid(height, wp, tile_w, pk.CHUNK_H)[1]
    if run_h > pk.CHUNK_H and chunks <= 65535:
        assert strips * runs >= pk.TARGET_BLOCKS // 2


def test_shared_memory_bytes():
    sep, corr, med = (ck._FAMILIES[f] for f in ("separable", "corr", "median"))
    # row sources 4 x 1 x 36 x 16, three raw slots of 36 rows x 160 bytes,
    # the ring of 40 rows x 144 bytes; then 40 rows x 128 floats
    assert pk.packed_smem_bytes(1, 1, 32, 32, 2, corr) == 4 * 36 * 16 + 3 * 36 * 160 + 40 * 144
    assert pk.packed_smem_bytes(1, 1, 32, 32, 2, sep) == \
        4 * 36 * 16 + 3 * 36 * 160 + 40 * 144 + 40 * 128 * 4
    assert pk.packed_smem_bytes(3, 3, 8, 16, 3, sep) == \
        4 * 3 * 22 * 16 + 3 * 3 * 22 * 64 + 3 * 28 * 48 + 3 * 28 * 32 * 4
    assert pk.packed_smem_bytes(3, 1, 16, 32, 1, med) == 4 * 3 * 34 * 16 + 3 * 3 * 34 * 96 + 36 * 80
    # the largest block any group takes fits: 3 planes, halo 3, a row pass
    assert pk.packed_smem_bytes(3, 3, 32, pk.MAX_CHUNK_H, 3, sep) <= ck.MAX_SMEM_BYTES


@pytest.mark.parametrize("wp", [8, 9, 33, 40, 1920])
@pytest.mark.parametrize("mode", ["reflect101", "edge"])
def test_edge_words_take_edge_src(wp, mode):
    """The window bytes every output of every strip reads hold the columns
    the golden padding gives (ck.edge_src), in whatever strip width."""
    width = 4 * wp
    for h in (1, 2, 3):
        if 2 * h >= wp:
            continue
        for tile_w in pk.TILE_WIDTHS:
            for w0 in range(0, wp, tile_w):
                cols = pk.window_columns(w0, tile_w, wp, h, mode)
                lo, hi = max(w0 - 1, 0), min(w0 + tile_w + 1, wp)
                assert all(4 * lo <= c < 4 * hi for c in cols)
                for b in range(min(4 * tile_w, width - 4 * w0) + 2 * h):  # the read bytes
                    assert cols[b] == ck.edge_src(4 * w0 - h + b, width, mode), (tile_w, w0, b)
    if wp == 8:  # bytes past either end of an 8-word row reflect into it
        cols = pk.window_columns(0, 8, 8, 3, "reflect101")
        assert cols[:4] == [3, 2, 1, 0] and cols[35:] == [30, 29, 28]


def test_interior_words_clamp():
    assert pk.window_columns(0, 8, 8, 1, "interior")[:2] == [0, 0]
    assert pk.window_columns(0, 8, 8, 3, "interior")[-3:] == [31, 31, 31]
    assert pk.window_columns(8, 8, 40, 2, "interior") == list(range(30, 30 + 36))


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


# the third entry is the chunk height; each block walks runs of two chunks
@pytest.mark.parametrize("spec,shape,chunk_h", [
    ("gaussian:5", (33, 160, 1), 16),  # ragged strips and runs
    ("gaussian:7", (34, 32, 1), 32),  # 8 words, halo 3; last chunk of 2 rows
    ("sobel", (20, 136, 1), 7),
    ("median:5", (19, 64, 1), 8),
    ("erode:3", (17, 132, 1), 5),
    ("emboss:3", (21, 128, 1), 6),  # interior passthrough at chunk edges
    ("edge_box", (18, 40, 1), 4),  # edge mode: no registry stencil has it
    ("grayscale,contrast:3.5", (13, 160, 3), 4),  # the pointwise form
    ("grayscale,contrast:3.5,emboss:3", (22, 136, 3), 8),
    ("sepia,gaussian:3", (15, 96, 3), 4),
])
def test_emulated_tiling_equals_plain(spec, shape, chunk_h):
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
    arrays = [x.numpy() for x in words]
    if st is None:
        runs = [emulate_planar(pw, arrays, bases=[1, 2, 3][:len(arrays)], out_base=b)
                for b in range(4)]
    else:
        runs = [emulate_t1(pw, st, arrays, h, w, tile_w=tile_w, run_h=2 * chunk_h,
                           chunk_h=chunk_h, bases=[1, 3, 2][:len(arrays)])
                for tile_w in (None, 8)]
    for got in runs:
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.reshape(h, w // 4), x.numpy())


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
    got = emulate_t1(pw, st, [x.numpy() for x in words], local_h, width, chunk_h=5, run_h=10,
                     ghosts=([x.numpy() for x in tops], [x.numpy() for x in bots]),
                     y0=y0, image_h=image_h, bases=[y0 % 4])
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
    for args in [(3, 3, 32, 32, 2, 2), (1, 1, 16, 32, 1, 0), (3, 1, 8, 64, 3, 3),
                 (1, 3, 32, 7, 2, 5)]:
        assert lib.packed_stream_smem_bytes(*args) == pk.packed_smem_bytes(*args)
