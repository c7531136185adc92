"""The row-sharded slice's kernel modules on the CPU: the index helpers of
``parallel/api.py`` against the JAX functions, the plain PyTorch versions of
K2g, K3 and K4g against the JAX package's Pallas kernels in interpret mode,
and the kernels' host-side geometry (strip row sources, gates, a
tile-by-tile emulation of the window algorithms).

Every tolerance is 0: bytes must be equal. Tests that need a card carry the
``cuda`` marker and skip without one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_k4_emulator import emulate_k4

from mpi_cuda_imagemanipulation_tpu.ops import pallas_kernels as jax_pk
from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.parallel import api as jax_api
from mpi_cuda_imagemanipulation_tpu.plan.ir import Stage as JaxStage
from mpi_cuda_imagemanipulation_tpu.plan.pallas_exec import run_stage_pallas_ext
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import F32, chain_halo, pad2d
from mpi_cuda_imagemanipulation_tpu_torch.parallel import api as port_api
from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import run_stage_cuda_ext
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import Stage

EDGE_MODES = ("interior", "reflect101", "edge", "zero")
# one stencil per edge mode (zero mode has no registry op: a copy of box:3)
_MODE_SPEC = {"interior": "emboss:5", "reflect101": "gaussian:5", "edge": "erode:5",
              "zero": "box:5"}
POSITIONS = ("first", "middle", "last")


def _mode_ops(mode):
    """(port op, JAX op) of halo 2 with edge mode `mode`."""
    ours, theirs = make_op(_MODE_SPEC[mode]), jax_registry.make_op(_MODE_SPEC[mode])
    if ours.edge_mode != mode:
        ours = dataclasses.replace(ours, edge_mode=mode)
        theirs = dataclasses.replace(theirs, edge_mode=mode)
    return ours, theirs


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# --------------------------------------------------------------------------
# Index helpers against the JAX functions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 5, 9])
def test_reflect101_index_matches_jax(size):
    g = np.arange(-(size - 1), 2 * size - 1)  # every index one reflection reaches
    got = port_api._reflect101_index(torch.from_numpy(g), size)
    want = jax_api._reflect101_index(jnp.asarray(g), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() >= 0 and got.max() < size


# (local_h, global_h, y0): 3 shards of 12 rows; with global_h 34 the last
# shard holds 2 pad rows, whose sources depend on the position
_FIX_CASES = {
    "first": (12, 36, 0), "middle": (12, 36, 12), "last": (12, 36, 24),
    "last-padded": (12, 34, 24), "middle-padded": (12, 34, 12),
}


@pytest.mark.parametrize("case", sorted(_FIX_CASES))
@pytest.mark.parametrize("mode", EDGE_MODES)
@pytest.mark.parametrize("channels", [1, 3])
def test_fix_edge_axis_matches_jax(mode, case, channels):
    local_h, global_h, y0 = _FIX_CASES[case]
    ours, theirs = _mode_ops(mode)
    shape = (local_h + 2 * ours.halo, 10) + ((3,) if channels == 3 else ())
    ext = _rand(shape, seed=y0 + global_h)
    got = port_api._fix_edge_axis(torch.from_numpy(ext), ours, y0, global_h, 0)
    want = jax_api._fix_edge_axis(jnp.asarray(ext), theirs, jnp.int32(y0), global_h, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        port_api._fix_edge_rows(torch.from_numpy(ext), ours, y0, global_h).numpy(),
        np.asarray(jax_api._fix_edge_rows(jnp.asarray(ext), theirs, jnp.int32(y0), global_h)),
    )
    # the column axis, as the 2-D runner will call it
    ext_t = np.ascontiguousarray(np.swapaxes(ext, 0, 1))
    got_t = port_api._fix_edge_axis(torch.from_numpy(ext_t), ours, y0, global_h, 1)
    np.testing.assert_array_equal(got_t.numpy(), np.swapaxes(np.asarray(want), 0, 1))


@pytest.mark.parametrize("position", POSITIONS + ("only",))
@pytest.mark.parametrize("mode", EDGE_MODES)
@pytest.mark.parametrize("channels", [1, 3])
def test_fix_edge_strips_matches_jax(mode, position, channels):
    local_h = 9
    y0, global_h = {"first": (0, 27), "middle": (9, 27), "last": (18, 27),
                    "only": (0, 9)}[position]
    ours, theirs = _mode_ops(mode)
    tail = (3,) if channels == 3 else ()
    tile = _rand((local_h, 10) + tail, seed=1)
    top, bottom = _rand((ours.halo, 10) + tail, seed=2), _rand((ours.halo, 10) + tail, seed=3)
    got = port_api._fix_edge_strips(
        torch.from_numpy(top), torch.from_numpy(bottom), torch.from_numpy(tile), ours, y0,
        global_h,
    )
    want = jax_api._fix_edge_strips(
        jnp.asarray(top), jnp.asarray(bottom), jnp.asarray(tile), theirs, y0, global_h
    )
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("spec", ["emboss:3", "emboss:5"])
def test_interior_box_is_the_interior_mask(spec):
    """The box the sharded runner copies around equals `interior_mask` at
    every tile position, tiles that hold no filtered pixel included."""
    op = make_op(spec)
    for global_h, global_w in ((40, 17), (9, 4), (5, 30), (3, 3)):
        for rows in (1, 4, 13):
            for y0 in range(0, max(global_h - rows, 0) + 1):
                r0, r1, c0, c1 = port_api._interior_box(op, rows, y0, global_h, global_w)
                want = op.interior_mask((rows, global_w), y0, 0, global_h, global_w)
                got = torch.zeros_like(want)
                got[r0:r1, c0:c1] = True
                assert 0 <= r0 <= r1 <= rows and 0 <= c0 <= c1 <= global_w
                assert torch.equal(got, want), (spec, global_h, global_w, rows, y0)


# --------------------------------------------------------------------------
# Shard tiles cut from one image: first, middle and last of three shards
# --------------------------------------------------------------------------

STENCILS = [
    "emboss:3", "emboss:5", "emboss101:3", "gaussian:3", "gaussian:5", "gaussian:7",
    "box:3", "sobel", "scharr", "sharpen", "unsharp", "laplacian:8",
    "filter:1/2/1/2/4/2/1/2/1:0.0625", "erode:5", "dilate:3", "median:3", "median:5",
]
GROUPS = [
    "grayscale,contrast:3.5,emboss:3", "sepia,gaussian:5", "grayscale,gray2rgb,sobel",
    "invert,brightness:-20,median:5", "grayscale601,contrast:3,emboss101:3",
]
STAGE_CASES = [
    "gaussian:5,sharpen", "emboss:3,gaussian:5", "median:3,sobel,box:3",
    "erode:3,dilate:5,median:5", "emboss:5,emboss:3,emboss101:3",
    "grayscale,contrast:3.5,emboss:3,gray2rgb,gaussian:5",
    "grayscale,gaussian:3,gray2rgb,sharpen,sepia", "sepia,gaussian:3,grayscale,sobel",
    "grayscale,contrast:3.5,emboss:3", "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6",
]


def _first_channels(ops) -> int:
    return next((op.in_channels for op in ops if op.in_channels), 0)


def _shard(ops, halo, position, local_h, width, seed, stencil=None):
    """The tile at `position` of three shards of a seeded image, with its
    raw ghost strips (zeros where the mesh has no neighbour, then the edge
    extension `stencil` asks for, as the runner makes them), its y0 and the
    image height."""
    channels = _first_channels(ops) or (1 if seed % 2 else 3)
    image_h = 3 * local_h
    img = synthetic_image(image_h, width, channels=channels, seed=seed)
    k = POSITIONS.index(position)
    y0 = k * local_h
    tile = img[y0:y0 + local_h]
    top = img[y0 - halo:y0] if k else np.zeros_like(img[:halo])
    bottom = img[y0 + local_h:y0 + local_h + halo] if k < 2 else np.zeros_like(img[:halo])
    tile, top, bottom = (torch.from_numpy(np.ascontiguousarray(a)) for a in (tile, top, bottom))
    if stencil is not None:
        top, bottom = port_api._fix_edge_strips(top, bottom, tile, stencil, y0, image_h)
    return tile, top, bottom, y0, image_h


def _planes(t):
    a = jnp.asarray(t.numpy())
    return [a] if a.ndim == 2 else [a[..., c] for c in range(a.shape[2])]


def _stack(planes):
    return np.asarray(planes[0] if len(planes) == 1 else jnp.stack(planes, -1))


@pytest.mark.parametrize("spec", STENCILS + GROUPS)
def test_k2g_plain_matches_pallas_ghost_kernel(spec):
    """`stream_stencil_ghost` on CPU tensors (its plain version) against the
    JAX ghost-mode stream kernel (`run_group(ghosts=...)`, the kernel under
    `stencil_tile_pallas_fused`) in interpret mode, at every shard position."""
    (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    (jpw, jst), = jax_pk.group_ops(jax_registry.make_pipeline_ops(spec))
    ck.reset_launch_counts()
    for seed, position in enumerate(POSITIONS):
        tile, top, bottom, y0, image_h = _shard(pw, st.halo, position, 21, 40, seed, st)
        got = ck.stream_stencil_ghost(pw, st, tile, top, bottom, y0=y0, image_h=image_h,
                                      image_w=40)
        want = jax_pk.run_group(
            jpw, jst, _planes(tile), interpret=True, ghosts=(_planes(top), _planes(bottom)),
            y0=y0, image_h=image_h, image_w=40,
        )
        np.testing.assert_array_equal(got.numpy(), _stack(want), err_msg=f"{spec} {position}")
    assert ck.stream_stencil_ghost.launches == 0  # no launch on the CPU


@pytest.mark.parametrize("spec", STENCILS + ["box:1"])
def test_k3_plain_matches_pallas_tile_kernel(spec):
    """`stencil_tile` on CPU tensors against `stencil_tile_pallas` in
    interpret mode over the same extended tile; for interior-mode ops after
    the caller's mask, which is where the two may differ."""
    st, jst = make_op(spec), jax_registry.make_op(spec)
    h = st.halo
    for seed, position in enumerate(POSITIONS):
        tile, top, bottom, y0, image_h = _shard([], h, position, 19, 36, seed)
        ext = torch.cat([top, tile, bottom]) if h else tile
        ext = port_api._fix_edge_rows(ext, st, y0, image_h)
        got = ck.stencil_tile(st, ext)
        assert got.shape == tile.shape
        want = _stack([jax_pk.stencil_tile_pallas(jst, p, interpret=True) for p in _planes(ext)])
        got = got.numpy()
        if st.edge_mode == "interior":
            mask = st.interior_mask(tile.shape[:2], y0, 0, image_h, 36).numpy()
            mask = mask[..., None] if tile.ndim == 3 else mask
            got, want = np.where(mask, got, tile.numpy()), np.where(mask, want, tile.numpy())
        np.testing.assert_array_equal(got, want, err_msg=f"{spec} {position}")
    assert ck.stencil_tile.launches == 0


def test_k3_zero_and_interior_columns_are_zeros():
    """K3 pads columns as the golden pad2d does, in every edge mode."""
    ext = torch.from_numpy(_rand((12, 9), seed=4))
    for mode in EDGE_MODES:
        op, _ = _mode_ops(mode)
        want = op.valid(pad2d(ext.to(F32), mode, 0, 0, op.halo, op.halo))
        want = {"trunc_clip": torch.floor, "rint_clip": torch.round}[op.quantize](
            want.clamp(0, 255)).to(torch.uint8)
        assert torch.equal(ck.stencil_tile(op, ext), want), mode


@pytest.mark.parametrize("spec", STAGE_CASES)
def test_k4g_plain_matches_pallas_ghost_megakernel(spec):
    """`run_stage_cuda_ext` on CPU tensors (K4g's plain version, the
    edge-fix walker) against `run_stage_pallas_ext` in interpret mode at
    every shard position, the strips riding raw."""
    ops, jops = make_pipeline_ops(spec), jax_registry.make_pipeline_ops(spec)
    H = chain_halo(ops)
    stage, jstage = Stage("fused", ops, H), JaxStage("fused", jops, H)
    local_h = 2 * H + 3
    for seed, position in enumerate(POSITIONS):
        tile, top, bottom, y0, image_h = _shard(ops, H, position, local_h, 40, seed)
        ext = torch.cat([top, tile, bottom])
        got = run_stage_cuda_ext(stage, ext, y0=y0, image_h=image_h, image_w=40)
        want = run_stage_pallas_ext(
            jstage, jnp.asarray(ext.numpy()), y0=y0, image_h=image_h, image_w=40, interpret=True
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{spec} {position}")
    assert ck.fused_stage_ext.launches == 0


# --------------------------------------------------------------------------
# Host-side geometry
# --------------------------------------------------------------------------


def test_ghost_row_sources():
    assert ck.ghost_row_source(-2, 10, 2) == ("top", 0)
    assert ck.ghost_row_source(-1, 10, 2) == ("top", 1)
    assert ck.ghost_row_source(0, 10, 2) == ("tile", 0)
    assert ck.ghost_row_source(9, 10, 2) == ("tile", 9)
    assert ck.ghost_row_source(10, 10, 2) == ("bottom", 0)
    assert ck.ghost_row_source(11, 10, 2) == ("bottom", 1)
    # past the strip (a ragged last block): clamped, read by no stored output
    assert ck.ghost_row_source(14, 10, 2) == ("bottom", 1)
    # halo 0 (K3 on a halo-0 stencil): never a strip
    assert ck.ghost_row_source(12, 10, 0) == ("tile", 9)


def _emulate_k2g(pw, st, tile, top, bottom, y0, image_h, tile_h):
    """stream_stencil.cu's ghost mode on the CPU, row block by row block:
    each block gathers its window rows by `ghost_row_source`, runs the
    pointwise chain on them, pads columns per the op's mode, and finalizes
    its rows at global coordinates."""
    local_h, h = tile.shape[0], st.halo
    src = {"tile": tile, "top": top, "bottom": bottom}
    out = []
    for b0 in range(0, local_h, tile_h):
        rows = [ck.ghost_row_source(b0 + wy - h, local_h, h) for wy in range(tile_h + 2 * h)]
        win = torch.stack([src[name][r] for name, r in rows])
        post = ck.pointwise_group_plain(pw, win) if pw else win

        def plane(x):
            xpad = pad2d(x.to(F32), st.edge_mode, 0, 0, h, h)
            return st.finalize(st.valid(xpad), x[h:x.shape[0] - h], y0 + b0, 0, image_h,
                               x.shape[1])

        res = (torch.stack([plane(post[..., c]) for c in range(post.shape[2])], -1)
               if post.ndim == 3 else plane(post))
        out.append(res[:min(tile_h, local_h - b0)])
    return torch.cat(out)


@pytest.mark.parametrize("spec", ["grayscale,contrast:3.5,emboss:3", "gaussian:7", "emboss:5",
                                  "erode:5", "sepia,median:3"])
def test_k2g_window_algorithm_matches_plain(spec):
    """K2g's window load, emulated block by block at tile heights that leave
    ragged last blocks and at the gate local_h = halo + 1."""
    (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    for local_h in (st.halo + 1, 23):
        for seed, position in enumerate(POSITIONS):
            tile, top, bottom, y0, image_h = _shard(pw, st.halo, position, local_h, 37, seed, st)
            want = ck.stream_stencil_ghost_plain(pw, st, tile, top, bottom, y0=y0,
                                                 image_h=image_h, image_w=37)
            for tile_h in (16, 5):
                got = _emulate_k2g(pw, st, tile, top, bottom, y0, image_h, tile_h)
                assert torch.equal(got, want), (spec, local_h, position, tile_h)


def test_k2g_gates():
    st = make_op("gaussian:5")
    tile = torch.zeros((8, 16), dtype=torch.uint8)
    strip = torch.zeros((2, 16), dtype=torch.uint8)
    kw = dict(y0=0, image_h=24, image_w=16)
    assert ck.stream_stencil_ghost([], st, tile, strip, strip, **kw).shape == (8, 16)
    with pytest.raises(ValueError, match="halo 0"):
        ck.stream_stencil_ghost([], make_op("box:1"), tile, strip[:0], strip[:0], **kw)
    with pytest.raises(NotImplementedError, match="zero-mode"):
        ck.stream_stencil_ghost([], dataclasses.replace(st, edge_mode="zero"), tile, strip,
                                strip, **kw)
    with pytest.raises(ValueError, match="too small for halo"):
        ck.stream_stencil_ghost([], st, tile[:2], strip, strip, **kw)
    with pytest.raises(ValueError, match="strip"):
        ck.stream_stencil_ghost([], st, tile, strip[:1], strip, **kw)
    with pytest.raises(ValueError, match="full width"):
        ck.stream_stencil_ghost([], st, tile, strip, strip, y0=0, image_h=24, image_w=32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.stream_stencil_ghost([], st, tile.to("meta"), strip.to("meta"), strip.to("meta"), **kw)


def test_k3_gates_and_geometry():
    st = make_op("gaussian:5")
    assert ck.stencil_tile(st, torch.zeros((12, 16, 3), dtype=torch.uint8)).shape == (8, 16, 3)
    with pytest.raises(ValueError, match="holds no row"):
        ck.stencil_tile(st, torch.zeros((4, 16), dtype=torch.uint8))
    with pytest.raises(ValueError, match="too small for halo"):
        ck.stencil_tile(st, torch.zeros((12, 2), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.stencil_tile(st, torch.zeros((12, 16), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="shared memory"):
        ck.stencil_tile(st, torch.zeros((1200, 16, 3), dtype=torch.uint8), tile_h=900)
    # the grid covers the local rows, not the extended ones
    assert ck.stencil_grid(1080, 7680, 16) == (60, 68)


def test_k4g_gates():
    ops = make_pipeline_ops("gaussian:5,sharpen")  # H = 3
    kw = dict(image_h=40, image_w=16)
    ext = torch.zeros((13, 16), dtype=torch.uint8)  # local_h = 7 = 2H + 1
    assert ck.fused_stage_ext(ops, ext, y0=0, **kw).shape == (7, 16)
    assert ck.fused_stage_ext(ops, ext, y0=33, **kw).shape == (7, 16)
    with pytest.raises(ValueError, match="image-too-small"):
        ck.fused_stage_ext(ops, ext[:12], y0=0, **kw)  # local_h = 2H
    with pytest.raises(ValueError, match="holds no row"):
        ck.fused_stage_ext(ops, ext[:6], y0=0, **kw)
    with pytest.raises(ValueError, match="outside an image"):
        ck.fused_stage_ext(ops, ext, y0=34, **kw)
    with pytest.raises(ValueError, match="full width"):
        ck.fused_stage_ext(ops, ext, y0=0, image_h=40, image_w=32)
    with pytest.raises(ValueError, match="lut-op"):
        ck.fused_stage_ext(make_pipeline_ops("gamma:2,sobel"), ext, y0=0, **kw)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.fused_stage_ext(ops, ext.to("meta"), y0=0, **kw)


@pytest.mark.parametrize(
    "spec,channels",
    [("gaussian:5,sharpen", 1), ("emboss:3,gaussian:5", 3), ("median:3,sobel,box:3", 1),
     ("emboss:5,emboss:3,emboss101:3", 1), ("erode:3,dilate:5,emboss:5", 1),
     ("grayscale,contrast:3.5,emboss:3,gray2rgb,gaussian:5", 3),
     ("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", 3), ("box:1,invert,box:1", 3)],
)
def test_k4g_tile_algorithm_matches_plain(spec, channels):
    """The kernel's ghost-mode window algorithm, emulated tile by tile,
    gives the bytes of its plain version at every shard position, at tile
    heights just above the gates (local_h = 2H + 1, width = largest op halo
    + 1) and with ragged last tiles."""
    ops = make_pipeline_ops(spec)
    H, max_op = chain_halo(ops), max(op.halo for op in ops)
    for local_h, width in ((2 * H + 1, 140), (23, max_op + 1), (2 * H + 1, max_op + 1)):
        image_h = 3 * local_h
        img = synthetic_image(image_h, width, channels=channels, seed=local_h + width)
        padded = np.concatenate([np.zeros_like(img[:H]), img, np.zeros_like(img[:H])])
        for k in range(3):
            y0 = k * local_h
            ext = np.ascontiguousarray(padded[y0:y0 + local_h + 2 * H])
            want = ck.fused_stage_ext_plain(
                ops, torch.from_numpy(ext), y0=y0, image_h=image_h, image_w=width
            ).numpy()
            for tile_h in (16, 5):
                got = emulate_k4(ops, ext, tile_h, y0=y0, image_h=image_h)
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{spec} {local_h}x{width} shard {k} tile_h={tile_h}")


def test_launch_counts_cover_every_kernel():
    ck.reset_launch_counts()
    assert ck.launch_counts() == {"K1": 0, "K2": 0, "K2g": 0, "K3": 0, "K4": 0, "K4g": 0,
                                  "K5-bf16": 0, "K5-int8": 0, "K6-narrow": 0, "K6-wide": 0,
                                  "K7": 0, "K8": 0, "K6g-narrow": 0, "K6g-wide": 0, "K7g": 0,
                                  "K8g": 0, "T4-copy": 0, "T4-smem-copy": 0,
                                  "T4-bitcast-store": 0, "T4-bitcast-load": 0, "T2": 0,
                                  "T3": 0}
    ck.stencil_tile.launches = 3
    ck.SWAR_LAUNCHES["K7g"] = 2
    assert ck.launch_counts()["K3"] == 3 and ck.launch_counts()["K7g"] == 2
    ck.reset_launch_counts()
    assert ck.stencil_tile.launches == 0 and ck.SWAR_LAUNCHES["K7g"] == 0


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["grayscale,contrast:3.5,emboss:3", "gaussian:5", "median:5",
                                  "erode:5", "sobel"])
def test_ghost_kernels_match_plain_on_card(cuda_device, spec):
    (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    for seed, position in enumerate(POSITIONS):
        tile, top, bottom, y0, image_h = (
            t.to(cuda_device) if isinstance(t, torch.Tensor) else t
            for t in _shard(pw, st.halo, position, 87, 301, seed, st)
        )
        kw = dict(y0=y0, image_h=image_h, image_w=301)
        for tile_h in (None, 5, 48):
            assert torch.equal(
                ck.stream_stencil_ghost(pw, st, tile, top, bottom, tile_h=tile_h, **kw),
                ck.stream_stencil_ghost_plain(pw, st, tile, top, bottom, **kw))
        post = ck.pointwise_group_plain(pw, torch.cat([top, tile, bottom]))
        assert torch.equal(ck.stencil_tile(st, post), ck.stencil_tile_plain(st, post))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", STAGE_CASES)
def test_fused_stage_ext_matches_plain_on_card(cuda_device, spec):
    ops = make_pipeline_ops(spec)
    H = chain_halo(ops)
    for seed, position in enumerate(POSITIONS):
        tile, top, bottom, y0, image_h = _shard(ops, H, position, 2 * H + 30, 301, seed)
        ext = torch.cat([top, tile, bottom]).to(cuda_device)
        kw = dict(y0=y0, image_h=image_h, image_w=301)
        for tile_h in (None, 5):
            assert torch.equal(ck.fused_stage_ext(ops, ext, tile_h=tile_h, **kw),
                               ck.fused_stage_ext_plain(ops, ext, **kw))
