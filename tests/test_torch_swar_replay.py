"""The redesigned SWAR kernels (``ops/csrc/swar_stencil.cu``: K6, K7, K8) on
the CPU: ``tests/_torch_swar_emulator.py`` replays the kernel block by block
(row sources, 16-byte granules from made-up unaligned addresses into a raw
buffer of garbage, the four-word pair build, K7's compile-time tap loops and
the tap-table loops, the hoisted interior guard, eight-byte stores) and is
held against the JAX package's SWAR kernels in interpret mode and against
the plain versions, at widths that are no multiple of 8 or 128, in every
edge mode, at the interior guard's first and last rows and columns, in
ghost mode at the image's top, middle and bottom, at halos 1-3 and past 7x7.
Then the host side: the tile-shape picker and the per-group cache.

Every tolerance is 0: bytes must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_swar_emulator import emulate_swar

from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.ops import swar_kernels as jax_swar
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

# K7 at 7x7 (taps as kernel parameters, the largest side) and at 9x9 (the
# tap table), both within sum|w| <= 128 with negative taps
K7_7X7 = "filter:" + "/".join(str(v) for v in
                              [(i * 7 % 11) - 5 if i % 3 == 0 else 0 for i in range(49)])
_W9 = np.array([(-3 if i % 10 == 0 else 2) if i % 5 == 0 else 0 for i in range(81)],
               np.float32).reshape(9, 9)
# K8 on i32 lanes at side 3 (sum|w| = 530: past a 16-bit field) and at
# side 7 (a scaled 7x7 filter); K8 on fields with one kernel
K8_LANES3 = "filter:100/-100/50/0/30/0/-50/100/-100:0.25"
K8_7X7 = "filter:" + "/".join(str((i * 5 % 13) - 6) for i in range(49)) + ":0.125"
K8_FIELDS1 = "filter:1/2/1/2/4/2/1/2/1:0.0625"
_A5 = np.outer([1, 2, 0, -2, -1], [1, 4, 6, 4, 1]).astype(np.float32)
_T3 = np.array([1, 30, 1], np.float32)
_T5 = np.array([1, 4, 30, 4, 1], np.float32)
# ops with no registry spelling: (base spec, fields replaced); _op builds them
CUSTOM = {
    "k7_9x9": ("sharpen", dict(halo=4, kernels=(_W9,), separable=None)),
    # K8 past side 7 (the tap table), trunc_clip
    "k8_9x9": ("sobel", dict(halo=4, kernels=(_W9,), combine="single", scale=0.25,
                             quantize="trunc_clip")),
    # K8's magnitude of two 5x5 kernels (lanes)
    "k8_mag5": ("sobel", dict(halo=2, kernels=(_A5, _A5.T.copy()))),
    # K6 narrow past side 5 (the tap table): S = 8
    "k6n_7": ("gaussian:5", dict(halo=3, kernels=(np.ones((7, 7), np.float32),),
                                 separable=np.array([1, 1, 1, 2, 1, 1, 1], np.float32),
                                 scale=1.0 / 64)),
    # K6 wide on i32 lanes at sides 3 and 5: S = 32 and 40, 255 * S^2 >= 2^16
    "k6w_3": ("gaussian:3", dict(kernels=(np.outer(_T3, _T3),), separable=_T3,
                                 scale=1.0 / 32 ** 2)),
    "k6w_5": ("gaussian:5", dict(kernels=(np.outer(_T5, _T5),), separable=_T5,
                                 scale=1.0 / 40 ** 2)),
}
K7_9X9 = "k7_9x9"


def _op(spec, make=make_op):
    """The op of `spec` (the port's, or the JAX package's with its
    `make`), a CUSTOM name built from its base op's fields."""
    if spec not in CUSTOM:
        return make(spec)
    base, fields = CUSTOM[spec]
    return dataclasses.replace(make(base), name=spec, **fields)


def _ops(spec, make_one):
    return tuple(_op(s, make_one) for s in spec.split(",") if s) if spec else ()


# (pre ops, stencil, post ops): K6 narrow and wide at every side and arm, K7
# at halos 1-4, K8 single and magnitude on fields, lanes and the tap table
CASES = [
    ("contrast:3.5", "gaussian:5", "invert"), ("", "gaussian:7", "brightness:-20"),
    ("contrast:3.5", "emboss:3", ""), ("brightness:-20", "sharpen", "contrast:3.5"),
    ("", "emboss:5", "invert"), ("invert", K7_7X7, ""), ("", K7_9X9, "brightness:20"),
    ("", "sobel", ""), ("contrast:3.5", "unsharp", ""),
    ("", "gaussian:3", "invert"), ("contrast:3.5", "box:3", ""), ("", "box:5", "brightness:-20"),
    ("", "box:7", ""), ("invert", "box:9", ""), ("", "box:17", "invert"), ("", "k6n_7", ""),
    ("", "scharr", "contrast:3.5"), ("brightness:-20", "prewitt", ""), ("", K8_FIELDS1, ""),
    ("", K8_LANES3, "invert"), ("", "k8_mag5", ""), ("contrast:3.5", K8_7X7, ""),
    ("", "k8_9x9", "brightness:20"), ("contrast:3.5", "k6w_3", ""), ("", "k6w_5", "invert"),
]
IDS = ["K6n", "K6w", "K7-3", "K7-sharpen", "K7-5", "K7-7", "K7-9", "K8-sobel", "K8-unsharp",
       "K6n-3", "K6w-box3", "K6w-box5", "K6w-box7", "K6w-box9", "K6w-box17", "K6n-7",
       "K8-scharr", "K8-prewitt", "K8-fields1", "K8-lanes3", "K8-mag5", "K8-7", "K8-9",
       "K6w-lanes3", "K6w-lanes5"]
def _split(case):
    pre, st, post = case
    out = ()
    for make in (make_op, jax_registry.make_op):
        out += (_ops(pre, make), _op(st, make), _ops(post, make))
    return out


def _chains(pre, post):
    return tuple(map(sk.swar_fusable, pre)), tuple(map(sk.swar_fusable, post))


def _plane(h, w, seed):
    return synthetic_image(h, w, channels=1, seed=seed)


def _instance(op):
    """The instantiation the dispatch launches for `op`'s descriptor."""
    return sk.swar_instance(sk.swar_desc(op)[0])


def test_instances_are_the_dispatch():
    """SWAR_INSTANCES and swar_instance's sides are the launches that
    sw_dispatch in swar_stencil.cu makes: (kind, side, on fields), side 0
    the tap table."""
    import re
    from pathlib import Path

    src = (Path(sk.__file__).parent / "csrc" / "swar_stencil.cu").read_text()
    body = src[src.index("static int sw_dispatch("):]
    body = body[:body.index("#undef SW_ARGS")]
    names = {"SW_K6_NARROW": "K6-narrow", "SW_K6_WIDE": "K6-wide", "SW_K7": "K7", "SW_K8": "K8"}
    launched = {(names[k], int(side), bool(f16))
                for k, side, f16 in re.findall(r"sw_launch<(SW_\w+), (\d+), GHOST(, true)?>",
                                               body)}
    want = {(k, side, False) for k, sides in sk.DISPATCH_SIDES.items() for side in (*sides, 0)}
    want |= {("K8", side, True) for side in sk.K8_FIELD_SIDES}
    assert launched == want
    # K8's field instantiations are picked by d->fields, and they are the
    # only K8 instantiations that sum on fields
    assert body.count("d->fields ?") == len(sk.K8_FIELD_SIDES)
    assert {(k, s) for k, s, f in sk.SWAR_INSTANCES if k == "K8" and f == "fields"} == {
        ("K8", s) for s in sk.K8_FIELD_SIDES}


def test_cases_cover_every_kernel_and_form():
    kinds = [sk.swar_kind(_split(c)[1]) for c in CASES]
    assert set(kinds) == set(sk.KINDS)
    halos = {_split(c)[1].halo for c, k in zip(CASES, kinds) if k == "K7"}
    assert halos == {1, 2, 3, 4}  # 4: past the compile-time tap loops
    assert 2 * 4 + 1 > sk.MAX_K
    assert {_instance(_split(c)[1]) for c in CASES} == sk.SWAR_INSTANCES
    # K8 on fields and on lanes with one kernel and with two
    k8 = {(_instance(op)[2], op.combine) for op in (_split(c)[1] for c in CASES)
          if sk.swar_kind(op) == "K8"}
    assert k8 == {(f, c) for f in ("fields", "lanes") for c in ("single", "magnitude")}
    # each JAX kernel takes the same op (the interpret-mode comparison)
    for c in CASES:
        assert jax_swar.swar_any_eligible(_split(c)[4]), c


@pytest.mark.parametrize("addr", [0, 3, 13])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replay_matches_jax_interpret(case, addr):
    """Full mode at a width that is no multiple of 8 or 128 (two column
    tiles, the last ragged), rows at unaligned addresses, against the JAX
    SWAR kernel in interpret mode."""
    pre, st, post, jpre, jst, jpost = _split(case)
    img = _plane(37, 196, seed=addr + 1)
    want = np.asarray(jax_swar.swar_stencil(jst, jnp.asarray(img), pre_ops=jpre, post_ops=jpost,
                                            interpret=True))
    pre_c, post_c = _chains(pre, post)
    got = emulate_swar(st, img, pre_chain=pre_c, post_chain=post_c, tile_h=16, tile_w=128,
                       addr=4096 + addr)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,tile", [((37, 196), (7, 64)), ((19, 132), (32, 128)),
                                        ((64, 260), (None, None)), ((40, 76), (8, 64))])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replay_matches_plain_at_ragged_shapes(case, shape, tile):
    """Widths 196, 132, 260 and 76 (no multiple of 8 or 128; 76 narrower
    than one tile), tile heights that do not divide the plane, the host's
    own shape, odd start bytes, the plain version as the yardstick."""
    pre, st, post, *_ = _split(case)
    if shape[1] // 4 < 2 * st.halo + 1:
        pytest.skip("below the SWAR width gate")
    pre_c, post_c = _chains(pre, post)
    img = _plane(*shape, seed=sum(shape))
    want = sk.swar_stencil_plain(st, torch.from_numpy(img), pre_chain=pre_c, post_chain=post_c)
    got = emulate_swar(st, img, pre_chain=pre_c, post_chain=post_c, tile_h=tile[0],
                       tile_w=tile[1], addr=77, seed=shape[0])
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("mode", ["interior", "reflect101", "edge", "zero"])
@pytest.mark.parametrize("spec", ["gaussian:5", "gaussian:7", "emboss:3", "laplacian:8",
                                  K7_7X7, K7_9X9, "sobel", "unsharp", "gaussian:3", "box:5",
                                  "box:9", "scharr", K8_LANES3, K8_7X7, "k8_9x9"])
def test_replay_every_edge_mode(spec, mode):
    """Every edge mode on every kernel that takes it (K6 has no interior
    form), blocks on every border: a 3 x 3 grid of 64 x 8 tiles."""
    st = dataclasses.replace(_op(spec), edge_mode=mode)
    if not sk.swar_any_eligible(st):
        assert mode == "interior" and sk.swar_kind(_op(spec)).startswith("K6")
        return
    pre = (sk.swar_fusable(make_op("contrast:3.5" if mode != "zero" else "brightness:20")),)
    img = _plane(21, 180, seed=3)
    want = sk.swar_stencil_plain(st, torch.from_numpy(img), pre_chain=pre)
    for tile_h, tile_w in ((8, 64), (32, 128)):
        got = emulate_swar(st, img, pre_chain=pre, tile_h=tile_h, tile_w=tile_w, addr=5)
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("spec", ["emboss:3", "emboss:5", K7_7X7, K7_9X9, "sobel", "scharr",
                                  "unsharp", K8_LANES3, K8_7X7, "k8_mag5", "k8_9x9"])
def test_replay_interior_guard_at_the_borders(spec):
    """The interior guard: tiles whose outputs lie wholly inside the
    interior skip it; tiles on the first and last rows and columns pass
    the centre through. Planes sized so that the interior's first and last
    row and column fall on a tile's first or last row or column."""
    st = dataclasses.replace(_op(spec), edge_mode="interior")
    h = st.halo
    for H, W, tile_h in ((2 * 8 + 2 * h + 1, 128 + 4 * (h + 1), 8), (3 * 8, 192, 8),
                         (h + 1 + 8, 64 * 3, 8)):
        img = _plane(H, W, seed=H + W)
        want = sk.swar_stencil_plain(st, torch.from_numpy(img))
        got = emulate_swar(st, img, tile_h=tile_h, tile_w=64)
        np.testing.assert_array_equal(got, want.numpy())
        golden = st(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, golden)


@pytest.mark.parametrize("position", ["top", "middle", "bottom"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replay_ghost_mode(case, position):
    """Ghost mode with row0 at the image's top, middle and bottom: strips
    from the neighbours (the edge extension at the image's border, as the
    sharded runner synthesises it) at unaligned addresses; the guard
    follows global rows."""
    from mpi_cuda_imagemanipulation_tpu_torch.parallel.api import _fix_edge_strips

    pre, st, post, *_ = _split(case)
    pre_c, post_c = _chains(pre, post)
    img = _plane(72, 132, seed=11)
    h = st.halo
    y0 = {"top": 0, "middle": 24, "bottom": 48}[position]
    x = torch.from_numpy(img)
    tile = x[y0:y0 + 24]
    top = x[y0 - h:y0] if y0 else torch.zeros_like(x[:h])
    bottom = x[y0 + 24:y0 + 24 + h] if y0 < 48 else torch.zeros_like(x[:h])
    top, bottom = _fix_edge_strips(top, bottom, tile, st, y0, 72)
    ghosts = (top.contiguous(), bottom.contiguous())
    want = sk.swar_stencil_plain(st, tile.contiguous(), pre_chain=pre_c, post_chain=post_c,
                                 ghosts=ghosts, y0=y0, global_h=72)
    for tile_h, tile_w in ((7, 64), (None, None)):
        got = emulate_swar(st, tile.numpy(), pre_chain=pre_c, post_chain=post_c, tile_h=tile_h,
                           tile_w=tile_w, ghosts=tuple(g.numpy() for g in ghosts), y0=y0,
                           global_h=72, addr=9, ghost_addrs=(1027, 2061))
        np.testing.assert_array_equal(got, want.numpy())
    golden = x
    for op in pre + (st,) + post:
        golden = op(golden)
    np.testing.assert_array_equal(want.numpy(), golden[y0:y0 + 24].numpy())


def test_replay_extreme_planes():
    """All 0, all 255, the checkerboards and a row ramp: the largest sums
    and the guard's fields at their bounds."""
    yy, xx = np.mgrid[0:33, 0:136]
    board = ((yy + xx) % 2 * 255).astype(np.uint8)
    planes = [np.zeros((33, 136), np.uint8), np.full((33, 136), 255, np.uint8), board,
              255 - board, (yy * 37 % 256).astype(np.uint8)]
    for case in CASES + [("", "filter:-60/-4/0/0/1/0/0/0/63", "invert")]:
        pre, st, post, *_ = _split(case)
        pre_c, post_c = _chains(pre, post)
        for img in planes:
            want = sk.swar_stencil_plain(st, torch.from_numpy(img), pre_chain=pre_c,
                                         post_chain=post_c)
            got = emulate_swar(st, img, pre_chain=pre_c, post_chain=post_c, tile_h=16,
                               tile_w=64, addr=1)
            np.testing.assert_array_equal(got, want.numpy())


# --------------------------------------------------------------------------
# The host side: tile shape and per-group cache
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind,halo", [("K6-narrow", 2), ("K6-wide", 3), ("K7", 1), ("K7", 2),
                                       ("K7", 3), ("K7", 4), ("K8", 1), ("K8", 11)])
@pytest.mark.parametrize("shape", [(4320, 7680), (1080, 7680), (6, 7680), (40, 256),
                                   (37, 196), (70000, 64)])
def test_tile_shape_picker(kind, halo, shape):
    """The picker's shape: rows DEFAULT_TILE_H (64), cut
    while the grid is short of 2 x 132 blocks; columns 128, narrowed while
    the grid is short of 132 blocks; the block's shared memory within a
    block's; the grid within CUDA's."""
    height, width = shape
    if height > 65535 * 64:
        return
    rows, cols = sk.swar_tile_shape(kind, halo, height, width)
    assert cols in sk.TILE_WIDTHS and rows in sk.TILE_ROWS
    assert sk.swar_smem_bytes(kind, rows, halo, 0, cols) <= ck.MAX_SMEM_BYTES
    gx, gy = sk.swar_grid(height, width, rows, cols)
    assert gy <= 65535
    if cols == 64:
        assert sk.swar_grid(height, width, rows, 128)[0] < gx
    if rows < sk.DEFAULT_TILE_H:
        assert sk.swar_grid(height, width, 2 * rows, cols)[0] * sk.swar_grid(
            height, width, 2 * rows, cols)[1] < 2 * ck.N_SMS
    if shape in ((4320, 7680), (1080, 7680)):
        assert (rows, cols) == (sk.DEFAULT_TILE_H, 128)


def test_tile_shape_block_h_and_limits():
    # block_h keeps its meaning: the rows, whatever the grid
    assert sk.swar_tile_shape("K7", 1, 4320, 7680, 7) == (7, 128)
    assert sk.swar_tile_shape("K7", 1, 40, 256, 16) == (16, 64)
    assert sk.swar_tile_shape("K7", 1, 40, 256) == (8, 64)
    with pytest.raises(ValueError, match=">= 1"):
        sk.swar_tile_shape("K7", 1, 40, 256, 0)
    with pytest.raises(ValueError, match="shared memory"):
        sk.swar_tile_shape("K6-wide", 63, 4320, 7680, 512)
    # a table of 1058 tap words fits beside the tile; one of 60000 does not
    assert sk.swar_tile_shape("K8", 11, 4320, 7680, None, 1058) == (64, 128)
    assert sk.swar_tile_shape("K8", 11, 4320, 7680, None, 50000)[0] < 64
    with pytest.raises(ValueError, match="taller tile"):
        sk.swar_tile_shape("K7", 1, 65536 * 8, 7680, 8)


def test_group_cache_returns_the_same_encoding():
    pre, st, post, *_ = _split(("contrast:3.5", "emboss:3", "invert"))
    g = sk.swar_group(st, pre, post)
    assert sk.swar_group(st, pre, post) is g
    desc, table = sk.swar_desc(st, *_chains(pre, post))
    assert bytes(g.desc) == bytes(desc) and np.array_equal(g.table, table)
    assert list(g.taps.w[:9]) == [int(v) for v in np.asarray(st.kernels[0]).reshape(-1)]
    assert g.kind == "K7" and g.shape(4320, 7680, None) == sk.swar_tile_shape("K7", 1, 4320, 7680)
    ref = g.desc_ref(torch.device("cpu"))
    assert g.desc_ref(torch.device("cpu")) is ref
    d = ref._obj
    assert d.table == ck.device_table(table, torch.device("cpu")).data_ptr()
    assert bytes(d)[:56] == bytes(desc)[:56]  # all but the pointer


def test_group_cache_keys_on_identity_not_bytes():
    """Two groups whose ops encode to equal bytes are two entries, each
    holding its own ops; a pre-chain and the same op as a post-chain are
    two groups too."""
    a = make_op("sharpen")
    b = dataclasses.replace(a)  # the registry caches its ops: a copy
    assert a is not b
    inv = make_op("invert")
    ga, gb = sk.swar_group(a), sk.swar_group(b)
    assert ga is not gb and ga.op is a and gb.op is b
    assert bytes(ga.desc) == bytes(gb.desc)
    g_pre, g_post = sk.swar_group(a, (inv,)), sk.swar_group(a, (), (inv,))
    assert g_pre is not g_post
    assert (g_pre.desc.n_pre, g_pre.desc.n_post) == (1, 0)
    assert (g_post.desc.n_pre, g_post.desc.n_post) == (0, 1)


def test_wrapper_repeats_no_encoding(monkeypatch):
    """A second call of the same group (a shard's call in the sharded runner)
    builds no descriptor, table or shape."""
    pre, st, post, *_ = _split(("contrast:3.5", "emboss:3", ""))
    img = torch.from_numpy(_plane(40, 128, seed=2))
    first = sk.swar_stencil(st, img, pre_ops=pre)

    def boom(*a, **k):
        raise AssertionError("encoded again")

    monkeypatch.setattr(sk, "swar_desc", boom)
    monkeypatch.setattr(sk, "swar_taps", boom)
    monkeypatch.setattr(sk, "_fit_affine_u8", boom)
    assert torch.equal(sk.swar_stencil(st, img, pre_ops=pre), first)
