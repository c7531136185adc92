"""The SWAR slice on the CPU (``ops/swar_kernels.py``, ``backend='swar'``):
eligibility and the affine fitter against the JAX package's predicates, the
plain versions of K6 (narrow and wide), K7 and K8 against the JAX package's
SWAR kernels in interpret mode and against the golden ops, a numpy replay of
the CUDA kernels' word and field arithmetic (``_torch_swar_emulator.py``)
against the plain versions, and ``pipeline_swar`` and the entry points
against the JAX package.

Every tolerance is 0: bytes must be equal. Tests that need a card carry the
``cuda`` marker and skip without one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_swar_emulator import emulate_swar

from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.ops import swar_kernels as jax_swar
from mpi_cuda_imagemanipulation_tpu.plan import resolve_plan_mode as jax_resolve
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import BACKENDS, Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.plan import resolve_plan_mode
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

# every stencil spelling of the registry, plus custom integer filters: one
# with scale != 1 (K8), one with sum|w| = 128 and large negative taps (K7's
# bias bound at its edge), one past it (K8), an even box and a non-integer
# filter (no SWAR kernel)
STENCILS = [
    "emboss:3", "emboss:5", "emboss101:3", "emboss101:5", "gaussian:3", "gaussian:5",
    "gaussian:7", "box:1", "box:3", "box:5", "box:9", "sobel", "prewitt", "scharr",
    "sharpen", "unsharp", "laplacian:4", "laplacian:8", "erode:3", "dilate:5", "median:3",
    "median:5", "filter:1/2/1/2/4/2/1/2/1:0.0625", "filter:-60/-4/0/0/1/0/0/0/63",
    "filter:-60/-4/0/0/2/0/0/0/63", "filter:0.1/0.2/0.1/0.2/0.3/0.2/0.1/0.2/0.1",
]
KIND = {
    "gaussian:3": "K6-narrow", "gaussian:5": "K6-narrow", "gaussian:7": "K6-wide",
    "box:3": "K6-wide", "box:5": "K6-wide", "box:9": "K6-wide", "emboss:3": "K7",
    "emboss:5": "K7", "emboss101:3": "K7", "emboss101:5": "K7", "sharpen": "K7",
    "laplacian:4": "K7", "laplacian:8": "K7", "filter:-60/-4/0/0/1/0/0/0/63": "K7",
    "sobel": "K8", "prewitt": "K8", "scharr": "K8", "unsharp": "K8",
    "filter:1/2/1/2/4/2/1/2/1:0.0625": "K8", "filter:-60/-4/0/0/2/0/0/0/63": "K8",
}
POINTWISE = [
    "contrast:3.5", "contrast:3", "contrast:2", "contrast:0.5", "contrast:1.25",
    "contrast:4.3", "contrast:1", "brightness:20", "brightness:-20", "brightness:-7.5",
    "brightness:300", "invert", "grayscale", "grayscale601", "sepia", "gray2rgb",
    "quantize:6", "posterize:3", "gamma:1.8", "threshold:100", "solarize:100",
]
SHAPES = [(64, 64), (48, 64), (37, 128), (2, 64), (3, 64), (64, 60), (64, 66), (64, 12),
          (64, 20), (64, 28), (64, 36), (5, 64)]


def _plane(h, w, seed):
    return synthetic_image(h, w, channels=1, seed=seed)


def _fits(specs):
    return tuple(sk.swar_fusable(make_op(s)) for s in specs)


# --------------------------------------------------------------------------
# Eligibility, kinds and fits against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", STENCILS + POINTWISE)
def test_eligibility_matches_jax(spec):
    ours, theirs = make_op(spec), jax_registry.make_op(spec)
    for shape in [None] + SHAPES:
        for fn in ("swar_eligible", "swar_corr2d_eligible", "swar_corr2d_wide_eligible",
                   "swar_any_eligible"):
            assert getattr(sk, fn)(ours, shape) == getattr(jax_swar, fn)(theirs, shape), (
                fn, shape)
    if jax_swar.swar_eligible(theirs):
        assert sk._taps_shift(ours) == jax_swar._taps_shift(theirs)
        assert sk._swar_mode(sk._taps_shift(ours)[0]) == jax_swar._swar_mode(
            jax_swar._taps_shift(theirs)[0])


@pytest.mark.parametrize("spec", STENCILS)
def test_kernel_of_each_stencil(spec):
    """The routing the slice states: narrow K6 for gaussian:3/5, wide K6 for
    gaussian:7 and the odd boxes, K7 for the emboss family, sharpen and the
    laplacians, K8 for the gradient magnitudes, unsharp and filters past
    K7's bounds; no kernel for rank and morphology ops."""
    op = make_op(spec)
    if spec in KIND:
        assert sk.swar_any_eligible(op) and sk.swar_kind(op) == KIND[spec]
    else:
        assert not sk.swar_any_eligible(op)
        with pytest.raises(ValueError, match="no SWAR kernel"):
            sk.swar_kind(op)


def test_even_tap_vector_is_refused():
    op = dataclasses.replace(make_op("box:3"), separable=np.ones(4, np.float32),
                             scale=1.0 / 16)
    jop = dataclasses.replace(jax_registry.make_op("box:3"), separable=np.ones(4, np.float32),
                              scale=1.0 / 16)
    assert not sk.swar_eligible(op) and not jax_swar.swar_eligible(jop)


@pytest.mark.parametrize("spec", POINTWISE)
def test_swar_fusable_matches_jax(spec):
    ours = make_op(spec)
    assert sk.swar_fusable(ours) == jax_swar.swar_fusable(jax_registry.make_op(spec))
    if ours.lut_host is not None:
        table = torch.arange(256, dtype=torch.uint8)
        assert np.array_equal(ours.lut_host(), ours(table).numpy())


def test_fits_of_the_slice():
    assert _fits(["contrast:3.5", "brightness:20", "invert"]) == (
        (False, 7, 640, 1), (False, 1, -20, 0), (True, 1, 0, 0))
    assert _fits(["grayscale", "quantize:6", "gamma:2.2", "threshold:100"]) == (None,) * 4


@pytest.mark.parametrize("seed", range(8))
def test_fit_affine_matches_jax_on_random_tables(seed):
    rng = np.random.default_rng(seed)
    neg, a, c, m = bool(seed % 2), int(rng.integers(1, 129)), int(rng.integers(-200, 20000)), \
        int(rng.integers(0, 9))
    x = 255 - np.arange(256) if neg else np.arange(256)
    table = np.minimum(np.maximum(a * x - c, 0) >> m, 255).astype(np.uint8)
    if seed == 7:
        table[100] ^= 1  # no affine form
    fit = sk._fit_affine_u8(table.tobytes())
    assert fit == jax_swar._fit_affine_u8(table.tobytes())
    if fit is not None:
        assert np.array_equal(sk.affine_int(torch.arange(256), [fit]).numpy(), table)


@pytest.mark.parametrize("chain", [
    [], ["contrast:3.5"], ["brightness:20"], ["invert"], ["invert", "invert"],
    ["brightness:20", "brightness:-20"], ["brightness:-20", "contrast:2"],
])
def test_chain_fixes_zero_matches_jax(chain):
    ours = [make_op(s) for s in chain]
    theirs = [jax_registry.make_op(s) for s in chain]
    assert sk._chain_fixes_zero(ours) == jax_swar._chain_fixes_zero(theirs)


@pytest.mark.parametrize("backend_plan", ["auto", "off", "pointwise", "fused", "fused-pallas",
                                          "fused-pallas-mxu", "on"])
def test_every_plan_resolves_off_under_swar(backend_plan):
    ops = make_pipeline_ops("gaussian:5,sharpen")
    jops = jax_registry.make_pipeline_ops("gaussian:5,sharpen")
    assert resolve_plan_mode(ops, backend_plan, backend="swar") == "off"
    assert jax_resolve(jops, backend_plan, backend="swar") == "off"


# --------------------------------------------------------------------------
# Plain versions against the JAX package's kernels (interpret mode)
# --------------------------------------------------------------------------

# (pre ops, stencil, post ops): every kernel and mode with no chain, a
# pre-chain, a post-chain and both
CHAIN_CASES = [
    ("", "gaussian:3", ""), ("contrast:3.5", "gaussian:5", "invert"),
    ("", "gaussian:7", "brightness:-20"), ("invert", "box:5", ""),
    ("contrast:3.5", "emboss:3", ""), ("", "emboss:5", "invert"),
    ("brightness:-20", "sharpen", "contrast:3.5"), ("", "laplacian:8", ""),
    ("", "sobel", ""), ("invert", "scharr", "brightness:20"), ("contrast:3.5", "unsharp", ""),
    ("", "filter:-60/-4/0/0/1/0/0/0/63", "invert"),
    ("brightness:-20", "filter:1/2/1/2/4/2/1/2/1:0.0625", ""),
]


def _split(case):
    pre, st, post = case
    ops = make_pipeline_ops(",".join(s for s in (pre, st, post) if s))
    jops = jax_registry.make_pipeline_ops(",".join(s for s in (pre, st, post) if s))
    n = int(bool(pre))
    return ops[:n], ops[n], ops[n + 1:], jops[:n], jops[n], jops[n + 1:]


def _chains(pre, post):
    return tuple(map(sk.swar_fusable, pre)), tuple(map(sk.swar_fusable, post))


@pytest.mark.parametrize("shape", [(48, 64), (37, 128)])
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: "|".join(c))
def test_plain_matches_jax_swar_interpret(case, shape):
    pre, st, post, jpre, jst, jpost = _split(case)
    img = _plane(*shape, seed=shape[0])
    want = np.asarray(jax_swar.swar_stencil(jst, jnp.asarray(img), pre_ops=jpre, post_ops=jpost,
                                            interpret=True))
    got = sk.swar_stencil(st, torch.from_numpy(img), pre_ops=pre, post_ops=post)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CHAIN_CASES[1::2], ids=lambda c: "|".join(c))
def test_plain_ghost_mode_matches_jax_swar_interpret(case):
    """Ghost mode with raw strips and a global row offset: the middle rows
    of a 48-row image as a tile, its neighbours' rows as strips."""
    pre, st, post, jpre, jst, jpost = _split(case)
    img = _plane(48, 64, seed=9)
    h, y0 = st.halo, 16
    tile, top, bottom = img[y0:y0 + 16], img[y0 - h:y0], img[y0 + 16:y0 + 16 + h]
    want = np.asarray(jax_swar.swar_stencil(
        jst, jnp.asarray(tile), pre_ops=jpre, post_ops=jpost,
        ghosts=(jnp.asarray(top), jnp.asarray(bottom)), y0=y0, global_h=48, interpret=True))
    got = sk.swar_stencil(st, torch.from_numpy(tile), pre_ops=pre, post_ops=post,
                          ghosts=(torch.from_numpy(top), torch.from_numpy(bottom)), y0=y0,
                          global_h=48)
    np.testing.assert_array_equal(got.numpy(), want)


def _golden(ops, img):
    x = torch.from_numpy(img)
    for op in ops:
        x = op(x)
    return x.numpy()


def _extreme_planes(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    board = ((yy + xx) % 2 * 255).astype(np.uint8)
    return [np.zeros((h, w), np.uint8), np.full((h, w), 255, np.uint8), board,
            (yy * 37 % 256).astype(np.uint8)]


@pytest.mark.parametrize("shape", [(48, 64), (37, 128), (70, 260)])
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: "|".join(c))
def test_plain_matches_golden(case, shape):
    pre, st, post, *_ = _split(case)
    for img in [_plane(*shape, seed=1)] + _extreme_planes(*shape):
        got = sk.swar_stencil(st, torch.from_numpy(img), pre_ops=pre, post_ops=post)
        np.testing.assert_array_equal(got.numpy(), _golden(pre + (st,) + post, img))


@pytest.mark.parametrize("position", ["first", "middle", "last"])
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: "|".join(c))
def test_plain_ghost_mode_matches_golden_rows(case, position):
    """A tile cut as the first, a middle or the last of three shards, with
    the strips the sharded runner gives it (neighbour rows, the op's edge
    extension at the image's border), equals those rows of the golden
    result."""
    from mpi_cuda_imagemanipulation_tpu_torch.parallel.api import _fix_edge_strips

    pre, st, post, *_ = _split(case)
    img = _plane(48, 64, seed=4)
    h, y0 = st.halo, {"first": 0, "middle": 16, "last": 32}[position]
    x = torch.from_numpy(img)
    tile = x[y0:y0 + 16]
    top = x[max(y0 - h, 0):y0] if y0 else torch.zeros_like(x[:h])
    bottom = x[y0 + 16:y0 + 16 + h] if y0 < 32 else torch.zeros_like(x[:h])
    top, bottom = _fix_edge_strips(top, bottom, tile, st, y0, 48)
    got = sk.swar_stencil(st, tile, pre_ops=pre, post_ops=post,
                          ghosts=(top.contiguous(), bottom.contiguous()), y0=y0, global_h=48)
    np.testing.assert_array_equal(got.numpy(), _golden(pre + (st,) + post, img)[y0:y0 + 16])


# --------------------------------------------------------------------------
# The kernels' host geometry and a replay of their arithmetic
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tile_h", [5, 16, 31, 32, 33])
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: "|".join(c))
def test_emulator_matches_plain(case, tile_h):
    """The kernel's algorithm replayed in numpy, tile heights one below and
    one above a multiple of the plane's height included (37 rows, a ragged
    last column tile at 200 columns)."""
    pre, st, post, *_ = _split(case)
    pre_c, post_c = _chains(pre, post)
    img = _plane(37, 200, seed=tile_h)
    want = sk.swar_stencil_plain(st, torch.from_numpy(img), pre_chain=pre_c, post_chain=post_c)
    got = emulate_swar(st, img, pre_chain=pre_c, post_chain=post_c, tile_h=tile_h)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: "|".join(c))
def test_emulator_ghost_mode_matches_plain(case):
    pre, st, post, *_ = _split(case)
    pre_c, post_c = _chains(pre, post)
    img = _plane(60, 136, seed=2)
    h = st.halo
    for y0, rows, tile_h in ((3, 20, 7), (20, 37, 32), (h, 60 - 2 * h, 16)):
        tile, top, bottom = img[y0:y0 + rows], img[y0 - h:y0], img[y0 + rows:y0 + rows + h]
        want = sk.swar_stencil_plain(
            st, torch.from_numpy(tile), pre_chain=pre_c, post_chain=post_c,
            ghosts=(torch.from_numpy(top), torch.from_numpy(bottom)), y0=y0, global_h=60)
        got = emulate_swar(st, tile, pre_chain=pre_c, post_chain=post_c, tile_h=tile_h,
                           ghosts=(top, bottom), y0=y0, global_h=60)
        np.testing.assert_array_equal(got, want.numpy())


def test_emulator_on_zero_mode_and_edge_mode():
    """Border resolution by index for the modes no registry op has."""
    for mode, pre in (("zero", "contrast:3.5"), ("edge", "brightness:20")):
        for spec in ("gaussian:5", "sharpen", "sobel"):
            st = dataclasses.replace(make_op(spec), edge_mode=mode)
            chain = (sk.swar_fusable(make_op(pre)),)
            img = _plane(21, 72, seed=3)
            want = sk.swar_stencil_plain(st, torch.from_numpy(img), pre_chain=chain)
            np.testing.assert_array_equal(
                emulate_swar(st, img, pre_chain=chain, tile_h=8), want.numpy())
            np.testing.assert_array_equal(
                want.numpy(), _golden((make_op(pre), st), img))


@pytest.mark.parametrize("spec", sorted(KIND))
def test_swar_desc_encoding(spec):
    op = make_op(spec)
    d, table = sk.swar_desc(op, (sk.swar_fusable(make_op("contrast:3.5")),),
                            (sk.swar_fusable(make_op("invert")),))
    kind = sk.swar_kind(op)
    assert d.kind == sk.KINDS[kind] and d.halo == op.halo
    assert (d.n_pre, d.n_post) == (1, 1) and table.dtype == np.int32
    assert list(table[:4]) == [0, 7, 640, 1] and list(table[4:8]) == [1, 1, 0, 0]
    assert d.edge_mode == ck._EDGE_MODES[op.edge_mode]
    assert d.interior == int(op.edge_mode == "interior")
    if kind.startswith("K6"):
        taps, k = sk._taps_shift(op)
        assert d.n_taps[0] == len(taps) and list(table[8:]) == list(taps)
        assert d.shift == k
        return
    ks = 2 * op.halo + 1
    flat, j = list(table[8:]), 0
    assert len(flat) == 2 * sum(d.n_taps)
    for n_k, w in zip(d.n_taps, list(op.kernels) + [None]):
        if w is None:
            assert n_k == 0
            continue
        dense = np.zeros(ks * ks, np.int64)
        for t in range(n_k):
            dense[flat[j]] = flat[j + 1]
            j += 2
        np.testing.assert_array_equal(dense.reshape(ks, ks), np.asarray(w).astype(np.int64))
    if kind == "K7":
        assert d.bias == 255 * int(-np.minimum(np.asarray(op.kernels[0]), 0).sum())


def test_desc_layout_and_limits():
    """The descriptor is 64 bytes of scalars and a table pointer; the table
    holds chains and taps of any length (the JAX SWAR kernels have no
    limit): 40 pre-chain steps and 40 post-chain steps, and a 23x23 integer
    kernel on K8 (529 nonzero taps, 1058 tap words)."""
    import ctypes

    assert ctypes.sizeof(kr.SwarDesc) == 64 < kr.KERNEL_PARAM_BYTES
    step = sk.swar_fusable(make_op("invert"))
    d, table = sk.swar_desc(make_op("gaussian:5"), (step,) * 40, (step,) * 40)
    assert (d.n_pre, d.n_post) == (40, 40) and table.size == 4 * 80 + 5
    assert list(table[:4]) == list(step) and list(table[-5:]) == [1, 4, 6, 4, 1]
    big = dataclasses.replace(make_op("sobel"), name="ones23", halo=11,
                              kernels=(np.ones((23, 23), np.float32),), combine="single",
                              scale=1.0 / 529)
    assert sk.swar_kind(big) == "K8"
    d, table = sk.swar_desc(big)
    assert d.n_taps[0] == 529 and table.size == 1058
    assert sk.pick_tile_h("K8", 11, table_words=table.size) == sk.DEFAULT_TILE_H


@pytest.mark.parametrize("kind,tile_h,halo", [("K6-narrow", 32, 2), ("K6-wide", 32, 3),
                                              ("K7", 32, 1), ("K8", 5, 2), ("K6-wide", 1, 4)])
def test_shared_memory_and_grid(kind, tile_h, halo):
    eh = tile_h + 2 * halo
    words = eh * (sk.PAIRS + halo) * 4
    assert sk.swar_smem_bytes(kind, tile_h, halo) == words + (
        eh * sk.PAIRS * 4 if kind.startswith("K6") else 0)
    # the table ahead of the window, rounded up to 16 bytes
    assert sk.swar_smem_bytes(kind, tile_h, halo, 9) == sk.swar_smem_bytes(kind, tile_h, halo) + 48
    assert sk.window_words(halo) == 64 + halo
    assert sk.swar_grid(4320, 7680, tile_h) == (60, -(-4320 // tile_h))
    assert sk.swar_grid(37, 200, tile_h) == (2, -(-37 // tile_h))


def test_tile_height_choice():
    assert sk.pick_tile_h("K6-narrow", 2) == sk.DEFAULT_TILE_H
    assert sk.pick_tile_h("K7", 1, 7) == 7
    assert sk.pick_tile_h("K6-wide", 63) == sk.DEFAULT_TILE_H  # box:127 fits
    big = sk.pick_tile_h("K6-wide", 110)  # the default halved to fit
    assert big < sk.DEFAULT_TILE_H
    assert sk.swar_smem_bytes("K6-wide", big, 110) <= ck.MAX_SMEM_BYTES
    assert sk.swar_smem_bytes("K6-wide", 2 * big, 110) > ck.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="more shared memory"):
        sk.pick_tile_h("K6-wide", 120)
    with pytest.raises(ValueError, match="shared memory"):
        sk.pick_tile_h("K6-wide", 63, 512)
    with pytest.raises(ValueError, match=">= 1"):
        sk.pick_tile_h("K7", 1, 0)


def test_wrapper_rejections():
    img = torch.from_numpy(_plane(32, 64, seed=1))
    st = make_op("gaussian:5")
    with pytest.raises(ValueError, match="not SWAR-fusable"):
        sk.swar_stencil(st, img, pre_ops=(make_op("gamma:2"),))
    with pytest.raises(ValueError, match="one u8 plane"):
        sk.swar_stencil(st, torch.from_numpy(synthetic_image(32, 64, seed=1)))
    with pytest.raises(ValueError, match="SWAR gates"):
        sk.swar_stencil(st, img[:, :62].contiguous())
    with pytest.raises(ValueError, match="strip"):
        sk.swar_stencil(st, img, ghosts=(img[:1], img[:2]), y0=2, global_h=40)
    with pytest.raises(ValueError, match="outside an image"):
        sk.swar_stencil(st, img, ghosts=(img[:2], img[:2]), y0=30, global_h=40)
    with pytest.raises(ValueError, match="no SWAR kernel"):
        sk.swar_stencil(make_op("median:3"), img)


def test_wrappers_count_no_launch_on_cpu():
    ck.reset_launch_counts()
    assert ck.SWAR_LAUNCHES == dict.fromkeys(
        ["K6-narrow", "K6-wide", "K7", "K8", "K6g-narrow", "K6g-wide", "K7g", "K8g"], 0)
    img = _plane(32, 64, seed=2)
    for spec in ("gaussian:5", "gaussian:7", "sharpen", "sobel"):
        Pipeline.parse(spec).jit("swar", device="cpu")(img)
    assert set(sk._GHOST_KEYS.values()) | set(sk.KINDS) == set(ck.SWAR_LAUNCHES)
    assert not any(ck.launch_counts().values())


# --------------------------------------------------------------------------
# pipeline_swar and the entry points
# --------------------------------------------------------------------------


def _record(monkeypatch):
    """Record pipeline_swar's decisions: ('flush', op names) for each
    fallback run, (kernel, pre, post) for each SWAR launch."""
    calls = []
    real_swar, real_cuda = sk.swar_stencil, ck.pipeline_cuda

    def swar(op, img, **kw):
        calls.append((sk.swar_kind(op), len(kw.get("pre_ops", ())), len(kw.get("post_ops", ()))))
        return real_swar(op, img, **kw)

    def cuda(ops, img, **kw):
        calls.append(("flush", [op.name for op in ops]))
        return real_cuda(ops, img, **kw)

    monkeypatch.setattr(sk, "swar_stencil", swar)
    monkeypatch.setattr(ck, "pipeline_cuda", cuda)
    return calls


# the slice's workloads and what they run, as the JAX package routes them
ROUTES = {
    "grayscale,contrast:3.5,emboss:3": (3, [("flush", ["grayscale"]), ("K7", 1, 0)]),
    "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6": (3, [
        ("flush", ["grayscale"]), ("K6-narrow", 1, 0), ("K7", 0, 0), ("flush", ["quantize6"])]),
    "grayscale,gaussian:7": (3, [("flush", ["grayscale"]), ("K6-wide", 0, 0)]),
    "grayscale,sobel": (3, [("flush", ["grayscale"]), ("K8", 0, 0)]),
    "gaussian:5": (3, [("flush", ["gaussian5"])]),
    "contrast:3.5,gaussian:5,invert,sharpen,brightness:20": (1, [
        ("K6-narrow", 1, 0), ("K7", 1, 1)]),
    "gamma:1.8,gaussian:5,invert": (1, [("flush", ["gamma1.8"]), ("K6-narrow", 0, 1)]),
    "contrast:3.5,median:3,gaussian:5": (1, [("flush", ["contrast3.5", "median3"]),
                                              ("K6-narrow", 0, 0)]),
}


@pytest.mark.parametrize("spec", sorted(ROUTES))
def test_pipeline_swar_routes_as_jax(spec, monkeypatch):
    channels, want_calls = ROUTES[spec]
    img = synthetic_image(40, 64, channels=channels, seed=6)
    calls = _record(monkeypatch)
    got = sk.pipeline_swar(make_pipeline_ops(spec), torch.from_numpy(img))
    assert calls == want_calls
    np.testing.assert_array_equal(got.numpy(), _golden(make_pipeline_ops(spec), img))


@pytest.mark.parametrize("spec,channels,shape", [
    ("grayscale,contrast:3.5,emboss:3", 3, (40, 64)),
    ("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", 3, (37, 128)),
    ("contrast:3.5,median:3,gaussian:5", 1, (40, 64)),
    ("gamma:1.8,gaussian:5,invert", 1, (40, 64)),
    ("contrast:3.5,gaussian:5,sobel", 1, (40, 66)),  # W % 4 != 0: all fall back
])
def test_pipeline_swar_matches_jax(spec, channels, shape):
    img = synthetic_image(*shape, channels=channels, seed=8)
    want = np.asarray(jax_swar.pipeline_swar(
        jax_registry.make_pipeline_ops(spec), jnp.asarray(img), interpret=True))
    got = sk.pipeline_swar(make_pipeline_ops(spec), torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)


def test_zero_mode_prefix_that_moves_zero_falls_back(monkeypatch):
    """Zero padding and a pre-chain commute only if the chain fixes 0: with
    brightness:20 before a zero-mode box:3 the group falls back (the JAX
    package then runs its u8 kernels); with contrast:3.5, which maps 0 to 0,
    it runs on K6 and equals the JAX kernel. The port's fallback, the K2
    group runner, has no zero-mode form and raises, as `--impl cuda` does on
    the same pipeline (ROADMAP.md section 3)."""
    box = dataclasses.replace(make_op("box:3"), name="box3z", edge_mode="zero")
    jbox = dataclasses.replace(jax_registry.make_op("box:3"), name="box3z", edge_mode="zero")
    img = _plane(40, 64, seed=12)
    calls = _record(monkeypatch)
    ops = (make_op("contrast:3.5"), box)
    got = sk.pipeline_swar(ops, torch.from_numpy(img))
    assert calls == [("K6-wide", 1, 0)]
    want = np.asarray(jax_swar.pipeline_swar((jax_registry.make_op("contrast:3.5"), jbox),
                                             jnp.asarray(img), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _golden(ops, img))
    calls.clear()
    ops = (make_op("brightness:20"), box)
    with pytest.raises(NotImplementedError, match="zero-mode"):
        sk.pipeline_swar(ops, torch.from_numpy(img))
    assert calls == [("flush", ["brightness20", "box3z"])]
    with pytest.raises(NotImplementedError, match="zero-mode"):
        ck.pipeline_cuda(ops, torch.from_numpy(img))


def test_block_h_shapes_the_swar_kernels_only(monkeypatch):
    seen = []
    real = sk.swar_stencil

    def swar(op, img, **kw):
        seen.append(("swar", kw.get("block_h")))
        return real(op, img, **kw)

    monkeypatch.setattr(sk, "swar_stencil", swar)
    real_cuda = ck.pipeline_cuda
    monkeypatch.setattr(ck, "pipeline_cuda", lambda ops, img, **kw: (
        seen.append(("flush", kw.get("block_h"))), real_cuda(ops, img, **kw))[1])
    img = synthetic_image(40, 64, channels=3, seed=2)
    Pipeline.parse("grayscale,gaussian:5").jit("swar", block_h=8, device="cpu")(img)
    assert seen == [("flush", None), ("swar", 8)]


@pytest.mark.parametrize("spec,channels", [
    ("grayscale,contrast:3.5,emboss:3", 3), ("grayscale,gaussian:7", 3),
    ("grayscale,sobel", 3), ("gaussian:5", 3), ("contrast:3.5,gaussian:5,invert", 1),
    ("invert,emboss:5,brightness:-20,sharpen,unsharp,box:3,prewitt", 1),
])
def test_jit_backend_swar_matches_golden(spec, channels):
    assert "swar" in BACKENDS
    img = synthetic_image(45, 96, channels=channels, seed=3)
    pipe = Pipeline.parse(spec)
    for plan in ("auto", "off", "fused-pallas"):
        got = pipe.jit("swar", device="cpu", plan=plan)(img)
        np.testing.assert_array_equal(got.numpy(), _golden(pipe.ops, img))


@pytest.mark.parametrize("ops,gray_output", [
    ("grayscale,contrast:3.5,emboss:3", False),
    ("grayscale,gaussian:5", True),
    ("grayscale,contrast:3.5,sobel,invert", True),
])
def test_cli_run_impl_swar_matches_jax(tmp_path, ops, gray_output):
    img = synthetic_image(33, 64, channels=3, seed=12)
    src = tmp_path / "in.png"
    save_image(src, img)
    out = tmp_path / "swar.png"
    extra = ["--gray-output"] if gray_output else []
    rc = cli.main(["run", "--input", str(src), "--output", str(out), "--ops", ops,
                   "--impl", "swar", "--device", "cpu", "--plan", "fused", *extra])
    assert rc == 0
    x = jnp.asarray(load_image(src))
    want = np.asarray(jax_swar.pipeline_swar(jax_registry.make_pipeline_ops(ops), x,
                                             interpret=True))
    if not gray_output:
        want = np.repeat(want[..., None], 3, axis=-1)
    np.testing.assert_array_equal(load_image(out, grayscale=gray_output), want)


def test_cli_info_lists_swar(capsys):
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "swar" in out.split("backends:")[1].splitlines()[0]
    for k in ("K6", "K7", "K8"):
        assert f"  {k} " in out


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: "|".join(c))
def test_swar_kernels_match_plain_on_card(cuda_device, case):
    pre, st, post, *_ = _split(case)
    img = torch.from_numpy(_plane(257, 300, seed=5))
    want = sk.swar_stencil(st, img, pre_ops=pre, post_ops=post)
    ck.reset_launch_counts()
    for tile_h in (None, 7):
        got = sk.swar_stencil(st, img.to(cuda_device), pre_ops=pre, post_ops=post,
                              block_h=tile_h)
        assert torch.equal(got.cpu(), want)
    h, y0 = st.halo, 100
    tile, top, bottom = img[y0:y0 + 60], img[y0 - h:y0], img[y0 + 60:y0 + 60 + h]
    want = sk.swar_stencil(st, tile.contiguous(), pre_ops=pre, post_ops=post,
                           ghosts=(top.contiguous(), bottom.contiguous()), y0=y0, global_h=257)
    got = sk.swar_stencil(st, tile.contiguous().to(cuda_device), pre_ops=pre, post_ops=post,
                          ghosts=(top.contiguous().to(cuda_device),
                                  bottom.contiguous().to(cuda_device)), y0=y0, global_h=257)
    assert torch.equal(got.cpu(), want)
    kind = sk.swar_kind(st)
    assert ck.SWAR_LAUNCHES[kind] == 2 and ck.SWAR_LAUNCHES[sk._GHOST_KEYS[kind]] == 1


@pytest.mark.cuda
def test_swar_layout_matches_source(cuda_device):
    import ctypes

    lib = kr.load("swar_stencil")
    assert lib.swar_desc_bytes() == ctypes.sizeof(kr.SwarDesc)
    for kind, code in sk.KINDS.items():
        for tile_h, halo, words in ((32, 2, 0), (5, 3, 9), (1, 63, 1058)):
            assert lib.swar_smem_bytes(code, tile_h, halo, words) == sk.swar_smem_bytes(
                kind, tile_h, halo, words)
