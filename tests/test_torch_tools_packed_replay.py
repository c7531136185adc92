"""The redesigned T1 and T2 (``ops/csrc/packed_stream.cu``,
``ops/csrc/packed_proto.cu`` and their shared planar body
``ops/csrc/packed_run.cuh``) replayed on the CPU:

* the planar pointwise body (``_torch_tools_emulator.emulate_planar``):
  head, body and tail with the inputs and the output at every word offset
  0-3 past a 16-byte boundary, for (n_in, n_out) in {1, 3}^2, against
  T1-pw's plain version, and T2's chain against T2's plain version and the
  JAX tool in interpret mode;
* the stencil form (``_torch_packed_emulator.emulate_t1``): heights of 1
  to 2h + 1 rows around each chunk boundary, ragged last chunks and runs,
  narrow and ragged strips, widths of 8 words and of words not a multiple
  of 4, planes and strips at word offsets 0-3, ghost tiles at the top,
  middle and bottom of an image, chains into every stencil family; against
  the plain version and, on one case per family, the JAX kernels in
  interpret mode.

Every tolerance is 0. Tests that need a card carry the ``cuda`` marker.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_packed_emulator import emulate_t1
from _torch_tools_emulator import emulate_planar

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops.pallas_kernels import group_ops as jax_group_ops
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp
from tools import packed_kernels as jax_pk

# chains of every channel count: (spec, n_in)
PLANAR_CHAINS = [
    ("invert,brightness:9", 1),  # 1 -> 1
    ("gray2rgb,sepia", 1),  # 1 -> 3
    ("grayscale,contrast:3.5", 3),  # 3 -> 1: T2's
    ("sepia,invert,solarize:100", 3),  # 3 -> 3
]


def _planes(h, w, n, seed):
    img = synthetic_image(h, w, channels=n, seed=seed)
    planes = [img] if n == 1 else [img[..., c] for c in range(n)]
    return [pk.pack_words(torch.from_numpy(np.ascontiguousarray(p))) for p in planes]


# --------------------------------------------------------------------------
# The planar body (T1-pw, T2)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec,n_in", PLANAR_CHAINS)
@pytest.mark.parametrize("shape", [(1, 9), (3, 11), (7, 16), (13, 40)])
def test_planar_body_replayed_at_every_offset(spec, n_in, shape):
    """Every input and output word offset 0-3 gives the plain version's
    words, with heads and tails of 0-3 words and planes of fewer words than
    one run."""
    h, wp = shape
    pw = list(make_pipeline_ops(spec))
    words = _planes(h, 4 * wp, n_in, seed=h + wp)
    want = pk.run_group_packed_words_plain(pw, None, words, h, 4 * wp)
    arrays = [w.numpy() for w in words]
    for out_base in range(4):
        for shift in range(4):
            bases = [(shift + c) % 4 for c in range(n_in)]
            got = emulate_planar(pw, arrays, bases=bases, out_base=out_base)
            assert len(got) == len(want)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g.reshape(h, wp), x.numpy())


@pytest.mark.parametrize("shape", [(64, 256), (37, 128), (5, 36), (1, 12)])
def test_t2_chain_replayed_against_t2_plain_and_jax(shape):
    """T2's table through the planar body equals T2's plain version and the
    JAX tool's kernel in interpret mode."""
    import importlib.util
    import os

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    spec = importlib.util.spec_from_file_location("packed_proto", os.path.join(tools,
                                                                               "packed_proto.py"))
    jax_pp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_pp)
    h, w = shape
    rgb = synthetic_image(h, w, channels=3, seed=w)
    planes = [pp.pack_u8(torch.from_numpy(np.ascontiguousarray(rgb[..., c]))) for c in range(3)]
    want = pp.packed_gray_contrast_plain(*planes)
    jwords = [jax_pp.pack_u8(jnp.asarray(rgb[..., c])) for c in range(3)]
    jax_out = np.asarray(jax_pp.packed_gray_contrast(*jwords, interpret=True,
                                                     block_h=min(h, 8)))
    np.testing.assert_array_equal(want.numpy(), jax_out)
    chain = pp.t2_program()
    assert chain.c_out == 1 and chain.n_ops == 2
    for base in range(4):
        got = emulate_planar(list(chain.ops), [p.numpy() for p in planes],
                             bases=[base, (base + 1) % 4, (base + 3) % 4], out_base=0)
        np.testing.assert_array_equal(got[0].reshape(h, w // 4), want.numpy())


def test_planar_split_host_rules():
    """The split: the head reaches the output's first 16-byte boundary, the
    shifts are the inputs' word offsets from there."""
    for out in range(0, 16, 4):
        for n in (0, 1, 3, 4, 5, 100):
            head, runs, tail, shifts = pk.planar_split([4, 8, 0], (1 << 30) + out, n)
            assert head == min((16 - out) % 16 // 4, n)
            assert head + 4 * runs + tail == n and 0 <= tail < 4
            assert shifts == [(a + 4 * head) % 16 // 4 for a in (4, 8, 0)]


def test_row_slices_run_through_t1pw_and_t2_plain():
    """A plane that starts at any word (a row slice of a larger plane) is a
    valid input of both wrappers."""
    words = _planes(20, 36, 3, seed=5)
    sliced = [w[3:17] for w in words]
    pw = list(make_pipeline_ops("grayscale,contrast:3.5"))
    got = pk.run_group_packed_words(pw, None, sliced, 14, 36)[0]
    np.testing.assert_array_equal(got.numpy(), pp.packed_gray_contrast(*sliced).numpy())
    full = pk.run_group_packed_words(pw, None, words, 20, 36)[0]
    np.testing.assert_array_equal(got.numpy(), full[3:17].numpy())
    replay = emulate_planar(pw, [s.numpy() for s in sliced], bases=[3, 3, 3])
    np.testing.assert_array_equal(replay[0].reshape(14, 9), got.numpy())


# --------------------------------------------------------------------------
# The stencil form (T1, T1g)
# --------------------------------------------------------------------------

# one stencil of each family and halo, with and without a chain
STENCIL_GROUPS = [
    "gaussian:5",  # separable, halo 2
    "gaussian:7",  # separable, halo 3
    "box:3",  # separable, halo 1
    "sobel",  # magnitude
    "median:5",
    "median:3",
    "erode:3",  # min
    "dilate:5",  # max
    "laplacian:8",  # 2-D correlation
    "emboss:3",  # interior
    "invert,gaussian:5",
    "brightness:25,median:3",
]


def _group(spec):
    (pw, st), = ck.group_ops(make_pipeline_ops(spec))
    return pw, st


def _check(spec, h, w, n_in=1, seed=0, **kw):
    pw, st = _group(spec)
    words = _planes(h, w, n_in, seed=seed or h * 7 + w)
    want = pk.run_group_packed_words_plain(pw, st, words, h, w)
    got = emulate_t1(pw, st, [x.numpy() for x in words], h, w, **kw)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())


@pytest.mark.parametrize("spec", STENCIL_GROUPS)
def test_heights_around_chunk_boundaries(spec):
    """Heights of 1 to 2h + 1 rows either side of each chunk boundary, in
    runs of two and three chunks: ragged last chunks, runs cut mid-chunk,
    a last run of fewer rows than the halo."""
    h = _group(spec)[1].halo
    chunk = 2 * h + 1
    for rows in sorted({chunk * m + d for m in (1, 2, 3) for d in range(-2 * h - 1, 2 * h + 2)}):
        if rows <= h:
            continue
        for run_chunks in (2, 3):
            _check(spec, rows, 40, chunk_h=chunk, run_h=run_chunks * chunk, tile_w=8,
                   bases=[rows % 4])


@pytest.mark.parametrize("spec", ["gaussian:5", "sobel", "median:5", "emboss:3", "erode:3"])
@pytest.mark.parametrize("wp", [8, 9, 10, 11, 17, 35, 40])
def test_narrow_and_ragged_strips(spec, wp):
    """Widths of 8 words and of words not a multiple of 4, in every strip
    width: border strips on both sides, a ragged last strip."""
    for tile_w in pk.TILE_WIDTHS:
        _check(spec, 11, 4 * wp, chunk_h=4, run_h=8, tile_w=tile_w, bases=[wp % 4])


@pytest.mark.parametrize("spec", ["gaussian:7", "laplacian:8", "median:3", "dilate:5"])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_plane_starts_at_every_word(spec, base):
    """Planes at word offsets 0-3 (their rows, of 13 words, start at every
    offset too): the granules from the aligned address below each row."""
    _check(spec, 19, 52, chunk_h=5, run_h=10, bases=[base])


@pytest.mark.parametrize("spec,n_in", [("grayscale,gaussian:5", 3), ("sepia,gaussian:3", 3),
                                       ("grayscale,contrast:3.5,emboss:3", 3),
                                       ("grayscale601,box:3", 3), ("sepia,median:3", 3),
                                       ("grayscale,sobel", 3)])
def test_rgb_chains_into_stencils(spec, n_in):
    for bases in ([0, 1, 2], [3, 3, 1]):
        _check(spec, 17, 44, n_in=n_in, chunk_h=6, run_h=12, bases=bases)


def test_edge_mode_and_default_shape():
    """Edge mode (no registry stencil has it) and the host's own shape."""
    st = dataclasses.replace(make_op("box:5"), name="box5e", edge_mode="edge")
    words = _planes(70, 200, 1, seed=3)
    want = pk.run_group_packed_words_plain([], st, words, 70, 200)
    for kw in ({}, {"chunk_h": 7, "run_h": 21, "tile_w": 16}):
        got = emulate_t1([], st, [x.numpy() for x in words], 70, 200, **kw)
        np.testing.assert_array_equal(got[0], want[0].numpy())


@pytest.mark.parametrize("spec", ["gaussian:5", "sobel", "emboss:3", "median:5",
                                  "invert,dilate:3"])
@pytest.mark.parametrize("where", ["top", "middle", "bottom"])
def test_ghost_tiles_at_top_middle_bottom(spec, where):
    """T1g on the first, a middle and the last tile of a 61-row image, with
    the strips the sharded runner gives (the neighbours' rows, the
    reflect101 extension at the image's edges), runs cut mid-tile."""
    image_h, width = 61, 96
    ref = synthetic_image(image_h, width, channels=1, seed=12)
    pw, st = _group(spec)
    h = st.halo
    y0, local_h = {"top": (0, 20), "middle": (20, 21), "bottom": (41, 20)}[where]
    tile = ref[y0:y0 + local_h]
    top = ref[y0 - h:y0] if y0 else ref[1:1 + h][::-1]
    bot = (ref[y0 + local_h:y0 + local_h + h] if y0 + local_h < image_h
           else ref[image_h - 1 - h:image_h - 1][::-1])
    words, tops, bots = ([pk.pack_words(torch.from_numpy(a.copy()))] for a in (tile, top, bot))
    want = pk.run_group_packed_words_plain(pw, st, words, local_h, width, ghosts=(tops, bots),
                                           y0=y0, image_h=image_h)
    for chunk_h, run_h in ((4, 8), (3, 9), (pk.CHUNK_H, pk.CHUNK_H)):
        got = emulate_t1(pw, st, [words[0].numpy()], local_h, width, chunk_h=chunk_h,
                         run_h=run_h, ghosts=([tops[0].numpy()], [bots[0].numpy()]), y0=y0,
                         image_h=image_h, bases=[(y0 + chunk_h) % 4])
        np.testing.assert_array_equal(got[0], want[0].numpy())


@pytest.mark.parametrize("spec,ch", [("gaussian:5", 1), ("erode:3", 1), ("laplacian:8", 1),
                                     ("sobel", 1), ("median:5", 1), ("emboss:3", 1),
                                     ("grayscale,contrast:3.5,emboss:3", 3)])
def test_replay_equals_jax_interpret(spec, ch):
    """The replay against the JAX kernel in interpret mode, one case per
    family, chunk boundaries inside its 16-row blocks."""
    img = synthetic_image(40, 128, channels=ch, seed=7)
    img[::7, ::3] = 255
    jplanes = [jnp.asarray(img[..., c] if ch > 1 else img) for c in range(ch)]
    (jpw, jst), = jax_group_ops(JaxPipeline.parse(spec).ops)
    want = jax_pk.run_group_packed_words(jpw, jst, [jax_pk.pack_words(p) for p in jplanes],
                                         40, 128, interpret=True, block_h=16)
    pw, st = _group(spec)
    words = [np.asarray(jax_pk.pack_words(p)).view(np.int32) for p in jplanes]
    got = emulate_t1(pw, st, words, 40, 128, chunk_h=6, run_h=18, bases=[1] * ch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w).view(np.int32))


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_planar_split_matches_source(cuda_device):
    import ctypes

    lib = kr.load("packed_stream")
    out = (ctypes.c_longlong * 6)()
    for ins, o, n in [((4, 8, 12), 0, 100), ((0, 0, 0), 4, 3), ((12, 4, 8), 8, 1001)]:
        lib.packed_pointwise_split(*ins, 3, o, n, out)
        head, runs, tail, shifts = pk.planar_split(ins, o, n)
        assert list(out) == [head, runs, tail, *shifts]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,n_in", PLANAR_CHAINS)
def test_t1pw_on_row_slices_on_card(cuda_device, spec, n_in):
    pw = list(make_pipeline_ops(spec))
    words = _planes(40, 36, n_in, seed=2)
    for a in range(4):
        sliced = [w[a:a + 33] for w in words]
        want = pk.run_group_packed_words(pw, None, sliced, 33, 36)
        got = pk.run_group_packed_words(pw, None, [s.to(cuda_device) for s in sliced], 33, 36)
        for g, x in zip(got, want):
            assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", STENCIL_GROUPS)
def test_t1_chunk_boundaries_on_card(cuda_device, spec):
    pw, st = _group(spec)
    for rows in (st.halo + 1, pk.CHUNK_H - 1, pk.CHUNK_H, pk.CHUNK_H + 1, 3 * pk.CHUNK_H + 2):
        words = _planes(rows, 44, 1, seed=rows)
        want = pk.run_group_packed_words(pw, st, words, rows, 44)
        got = pk.run_group_packed_words(pw, st, [w.to(cuda_device) for w in words], rows, 44)
        assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("block_h", [1, 7, 400])
def test_block_h_changes_no_byte_on_card(cuda_device, block_h):
    # the JAX block height is checked and sets nothing: the launched T1
    # (3 planes in and out, halo 3), T1g and T2 give the plain version's
    # bytes and the default launch's at any block height
    pw, st = _group("sepia,gaussian:7")
    words = _planes(40, 128, 3, seed=block_h)
    dev = [w.to(cuda_device) for w in words]
    want = pk.run_group_packed_words(pw, st, words, 40, 128)
    base = pk.run_group_packed_words(pw, st, dev, 40, 128)
    got = pk.run_group_packed_words(pw, st, dev, 40, 128, block_h=block_h)
    for g, b, x in zip(got, base, want):
        assert torch.equal(g.cpu(), x) and torch.equal(g, b)
    top, bot = _planes(3, 128, 3, seed=1), _planes(3, 128, 3, seed=2)
    kw = dict(y0=40, image_h=120)
    want = pk.run_group_packed_words(pw, st, words, 40, 128, ghosts=(top, bot), **kw)
    got = pk.run_group_packed_words(
        pw, st, dev, 40, 128, block_h=block_h,
        ghosts=([t.to(cuda_device) for t in top], [b.to(cuda_device) for b in bot]), **kw)
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)
    want = pp.packed_gray_contrast(*words)
    assert torch.equal(pp.packed_gray_contrast(*dev, block_h=block_h).cpu(), want)
