"""The stream-stencil kernel's tiling (K2, K2g, K3; stream_stencil.cu) on the
CPU: its launch-shape chooser, its cached host encodings, and a block-by-
block numpy replay of the kernel (``tests/_torch_stencil_emulator.py``) held
byte for byte against the plain versions on the cases of
``test_torch_kernels.py`` and ``test_torch_sharded_kernels.py``, at
unaligned buffer addresses, widths that are no multiple of 4 or 16, tile
heights that leave ragged last tiles, and overlap bands of 1 to 2h + 1
rows.

Every tolerance is 0: bytes must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_stencil_emulator import div, emulate, magic
from hypothesis import given, settings
from hypothesis import strategies as st

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.parallel import api as port_api

# the K2 cases of test_torch_kernels.py and the K2g / K3 ones of
# test_torch_sharded_kernels.py
K2_GROUPS = [
    "grayscale,contrast:3.5,emboss:3", "sepia,gaussian:5", "grayscale,gaussian:5",
    "grayscale,gray2rgb,median:3", "gaussian:7", "erode:5", "box:5", "dilate:7", "median:3",
    "box:1", "invert,box:1", "sobel", "unsharp",
]
STENCILS = [
    "gaussian:3", "gaussian:5", "gaussian:7", "emboss:3", "emboss:5", "emboss101:3", "box:3",
    "sobel", "scharr", "sharpen", "unsharp", "laplacian:8", "filter:1/2/1/2/4/2/1/2/1:0.0625",
    "erode:5", "dilate:3", "median:3", "median:5",
]
GROUPS = [
    "grayscale,contrast:3.5,emboss:3", "sepia,gaussian:5", "grayscale,gray2rgb,sobel",
    "invert,brightness:-20,median:5", "grayscale601,contrast:3,emboss101:3",
]
POSITIONS = ("first", "middle", "last")


def _img(h, w, channels, seed):
    return torch.from_numpy(synthetic_image(h, w, channels=channels, seed=seed))


def _group(spec):
    (pw, stn), = ck.group_ops(make_pipeline_ops(spec))
    return pw, stn


def _shard(pw, halo, position, local_h, width, seed, stencil):
    """The tile at `position` of three shards with its raw ghost strips (the
    runner's edge fix where the mesh has no neighbour), y0, image height."""
    channels = next((op.in_channels for op in pw if op.in_channels), 0) or (1 if seed % 2 else 3)
    image_h = 3 * local_h
    img = _img(image_h, width, channels, seed)
    k = POSITIONS.index(position)
    y0 = k * local_h
    tile = img[y0:y0 + local_h].contiguous()
    top = img[y0 - halo:y0] if k else torch.zeros_like(img[:halo])
    bottom = img[y0 + local_h:y0 + local_h + halo] if k < 2 else torch.zeros_like(img[:halo])
    top, bottom = port_api._fix_edge_strips(top.contiguous(), bottom.contiguous(), tile, stencil,
                                            y0, image_h)
    return tile, top, bottom, y0, image_h


# --------------------------------------------------------------------------
# The launch shape
# --------------------------------------------------------------------------


def test_magic_division_is_exact():
    for d in (2, 3, 5, 7, 8, 9, 26, 33, 34, 35, 64, 100, 131, 1000, 65535, 65536):
        m = magic(d)
        for n in list(range(0, 2000)) + [65535 - k for k in range(200)]:
            assert div(n, m) == n // d, (n, d)


def test_tile_shape_of_the_main_launches():
    # 8K frames and 1080-row shards keep 16 x 128 tiles; the band and the
    # 1-row band get 32-column tiles, 240 blocks
    assert ck.stencil_tile_shape(4320, 7680) == (16, 128)
    assert ck.stencil_tile_shape(1080, 7680) == (16, 128)
    assert ck.stencil_tile_shape(2, 7680) == (2, 32)
    assert ck.stencil_tile_shape(1, 7680) == (1, 32)
    assert ck.stencil_blocks(2, 7680, 2, 32) == 240
    # an explicit tile height is the block's rows
    assert ck.stencil_tile_shape(4320, 7680, 48) == (48, 128)
    # narrowing stops where it adds no block
    assert ck.stencil_tile_shape(37, 53) == (16, 32)
    assert ck.stencil_tile_shape(37, 20) == (16, 128)


@settings(max_examples=300, deadline=None)
@given(
    height=st.integers(1, 5000), width=st.integers(1, 9000), c=st.sampled_from([1, 3]),
    halo=st.integers(0, 3), fam=st.sampled_from(sorted(ck._FAMILIES.values())),
    tile_h=st.one_of(st.none(), st.integers(1, 64)), n_ops=st.integers(0, 40),
)
def test_launch_shape_covers_every_output_once(height, width, c, halo, fam, tile_h, n_ops):
    """The chooser's grid covers every output pixel exactly once, its
    shared memory fits a block, its flat loops stay under 2^16 (the
    high-multiply division's range), and each window reads the tile's rows
    and halo rows only."""
    try:
        rows, cols = ck.stencil_launch_shape(height, width, c, c, halo, fam, n_ops, tile_h)
    except ValueError as e:
        assert "shared memory" in str(e) or "taller tile" in str(e)
        return
    assert cols in ck.ST_TILE_WIDTHS and rows == (tile_h or min(ck.DEFAULT_TILE_H, height))
    gx, gy = ck.stencil_grid(height, width, rows, cols)
    assert gy <= 65535
    assert (gx - 1) * cols < width <= gx * cols and (gy - 1) * rows < height <= gy * rows
    smem = ck.stencil_smem_bytes(c, c, rows, cols, halo, fam, n_ops)
    assert smem <= ck.MAX_SMEM_BYTES
    eh, ew = rows + 2 * halo, cols + 2 * halo
    assert eh * (-(-(ew * c + 15) // 16)) < 1 << 16 and eh * -(-ew // 4) < 1 << 16
    # window rows of block row b: rows b*rows - halo .. (b+1)*rows + halo - 1
    for b in (0, gy - 1):
        first, last = b * rows - halo, b * rows + eh - 1 - halo
        assert first >= -halo and last <= gy * rows + halo - 1
    # the grid has N_SMS blocks where narrowing can give them
    if gx * gy < ck.N_SMS:
        assert all(-(-width // w) == gx for w in ck.ST_TILE_WIDTHS if w < cols)


@settings(max_examples=200, deadline=None)
@given(halo=st.integers(1, 3), width=st.sampled_from([7680, 3840, 1920, 5000]),
       c=st.sampled_from([1, 3]), data=st.data())
def test_overlap_bands_fill_the_card(halo, width, c, data):
    """Overlap bands of 1 to 2h + 1 output rows over a frame's width get at
    least N_SMS blocks where 32-column tiles give them (a width of 4224 or
    more), else as many as 32-column tiles give."""
    local_h = data.draw(st.integers(1, 2 * halo + 1))
    rows, cols = ck.stencil_launch_shape(local_h, width, c, c, halo, 2, 0, None)
    assert rows == local_h
    most = ck.stencil_blocks(local_h, width, rows, ck.ST_TILE_WIDTHS[-1])
    assert ck.stencil_blocks(local_h, width, rows, cols) >= min(ck.N_SMS, most)
    if width >= 4224:
        assert ck.stencil_blocks(local_h, width, rows, cols) >= ck.N_SMS


def test_launch_shape_is_cached():
    ck.stencil_launch_shape.cache_clear()
    ck.stencil_launch_shape(4320, 7680, 3, 3, 2, 2, 0, None)
    ck.stencil_launch_shape(4320, 7680, 3, 3, 2, 2, 0, None)
    info = ck.stencil_launch_shape.cache_info()
    assert info.hits == 1 and info.misses == 1


# --------------------------------------------------------------------------
# Cached descriptors and chain tables
# --------------------------------------------------------------------------


def test_cached_descriptors_follow_the_op():
    g5, g5b = make_op("gaussian:5"), make_op("gaussian:5")
    d = ck.desc_for(g5)
    assert ck.desc_for(g5) is d  # same op: the same object
    assert bytes(d) == bytes(ck.stencil_desc(g5))
    assert ck.desc_for(g5b) is not d and bytes(ck.desc_for(g5b)) == bytes(d)
    other = dataclasses.replace(g5, edge_mode="edge")
    assert bytes(ck.desc_for(other)) != bytes(d)


def test_cached_chains_follow_ops_channels_and_device():
    pw = list(make_pipeline_ops("grayscale,contrast:3.5"))
    chain = ck.chain_for(pw, 3)
    assert ck.chain_for(pw, 3) is chain and ck.chain_for(tuple(pw), 3) is chain
    assert chain.c_out == 1 and chain.n_ops == 2
    np.testing.assert_array_equal(chain.table, ck.pointwise_program(pw, 3)[0])
    assert ck.chain_for(pw[1:], 1) is not chain
    assert ck.chain_for(list(make_pipeline_ops("grayscale,contrast:3.5")), 3) is not chain
    assert ck.chain_for([], 3).ptr(torch.device("cpu")) is None
    with pytest.raises(ValueError, match="expects 3 channels"):
        ck.chain_for(pw, 1)
    # the table's copy on each device is made once per content and device
    t = ck.device_table(chain.table, torch.device("cpu"))
    assert ck.device_table(chain.table.copy(), torch.device("cpu")) is t
    assert ck.device_table(chain.table[:1].copy(), torch.device("cpu")) is not t
    assert ck.device_table(chain.table, torch.device("meta")) is not t


# --------------------------------------------------------------------------
# The replay against the plain versions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", K2_GROUPS)
def test_k2_replay_matches_plain(spec):
    pw, stn = _group(spec)
    channels = 3 if spec.startswith(("grayscale", "sepia")) else 1
    for (h, w), tile_h, base in (((40, 56), None, 0), ((37, 53), 5, 5), ((65, 140), 32, 13),
                                 ((11, 301), None, 7)):
        x = _img(h, w, 3 if channels == 3 else (1 if base % 2 else 3), seed=h + w)
        want = ck.stream_stencil_plain(pw, stn, x)
        got = emulate(pw, stn, x, tile_h=tile_h, base=base)
        assert torch.equal(got, want), (spec, (h, w), tile_h, base)


@pytest.mark.parametrize("spec", STENCILS + GROUPS)
def test_k2g_replay_matches_plain(spec):
    pw, stn = _group(spec)
    for seed, position in enumerate(POSITIONS):
        for local_h, width, tile_h in ((21, 40, None), (stn.halo + 1, 37, 5)):
            tile, top, bottom, y0, image_h = _shard(pw, stn.halo, position, local_h, width, seed,
                                                    stn)
            want = ck.stream_stencil_ghost_plain(pw, stn, tile, top, bottom, y0=y0,
                                                 image_h=image_h, image_w=width)
            got = emulate(pw, stn, tile, mode="ghost", top=top, bottom=bottom, row0=y0,
                          image_h=image_h, tile_h=tile_h, base=seed * 5)
            assert torch.equal(got, want), (spec, position, local_h, tile_h)


@pytest.mark.parametrize("spec", STENCILS + ["box:1"])
def test_k3_replay_matches_plain(spec):
    stn = make_op(spec)
    h = stn.halo
    for seed, position in enumerate(POSITIONS):
        tile, top, bottom, y0, image_h = _shard([], h, position, 19, 36, seed, stn)
        ext = torch.cat([top, tile, bottom]) if h else tile
        ext = port_api._fix_edge_rows(ext, stn, y0, image_h).contiguous()
        assert torch.equal(emulate([], stn, ext, mode="tile", base=seed * 3),
                           ck.stencil_tile_plain(stn, ext)), (spec, position)


@pytest.mark.parametrize("mode", ["interior", "reflect101", "edge", "zero"])
@pytest.mark.parametrize("channels", [1, 3])
def test_k3_replay_on_overlap_bands(mode, channels):
    """K3 as the overlap mode launches it on a boundary band: 1 to 2h + 1
    output rows of a (rows + 2h)-row tile, in every edge mode, over a
    width that is no multiple of 4."""
    stn = dataclasses.replace(make_op("gaussian:5"), edge_mode=mode)
    h = stn.halo
    for local_h in range(1, 2 * h + 2):
        ext = _img(local_h + 2 * h, 203, channels, seed=local_h).contiguous()
        assert torch.equal(emulate([], stn, ext, mode="tile", base=local_h),
                           ck.stencil_tile_plain(stn, ext)), (mode, local_h)


@pytest.mark.parametrize("n_ops", [9, 17, 40])
def test_replay_of_long_chains(n_ops):
    """The chain table of any length through the replayed window load."""
    pw = list(make_pipeline_ops(",".join(["brightness:1"] * (n_ops - 1) + ["invert"])))
    stn = make_op("gaussian:5")
    x = _img(23, 70, 3, seed=n_ops)
    assert torch.equal(emulate(pw, stn, x, base=9), ck.stream_stencil_plain(pw, stn, x))
