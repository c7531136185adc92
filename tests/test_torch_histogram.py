"""The port's global-statistics ops (``ops/histogram.py``: equalize,
autocontrast, otsu) on the CPU, held byte for byte against the JAX
package's ``ops/histogram.py``:

* the cases of tests/test_histogram_ops.py (numpy oracles, the row mask,
  constant and full-range images, the colour refusal on every backend,
  Otsu on a bimodal image), each run through both packages;
* the ordered float32 prefix sum of Otsu's moments against ``jnp.cumsum``,
  and ``otsu_threshold_from_hist`` and the equalize and autocontrast tables
  against JAX's, on hypothesis-drawn histograms (one bin, two bins, counts
  of an 8K frame); ``torch.cumsum``'s order differs, which a test shows;
* every backend (torch, cuda, swar, mxu, auto) under every plan, against
  the JAX golden ops and the JAX ``pallas`` backend in interpret mode;
* ``Pipeline.sharded`` over 2, 3 and 8 CPU slots at heights 128, 131 and
  133 on every backend (both halo modes; the pad rows of the last shard
  stay out of the histogram), against the JAX sharded runner on 8 fake
  devices;
* the CLI's ``run`` with ``--gray-output`` after ``otsu`` and ``equalize``.

The tests that need a card carry the ``cuda`` marker. Every tolerance is 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from PIL import Image
from hypothesis import strategies as st

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops import histogram as JH
from mpi_cuda_imagemanipulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    load_image,
    save_image,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import histogram as H
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, registry_family_table
from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh

BACKENDS = ("torch", "cuda", "swar", "mxu", "auto")
PLANS = ("off", "auto", "pointwise", "fused", "fused-pallas", "fused-pallas-mxu")
LANES = [(b, p) for b in BACKENDS for p in PLANS
         if not (b in ("cuda", "auto") and p in ("pointwise", "fused"))]
SHARDED_LANES = [("torch", "off", "serial"), ("torch", "fused", "serial"),
                 ("cuda", "off", "serial"), ("cuda", "fused-pallas", "serial"),
                 ("cuda", "fused-pallas-mxu", "serial"), ("swar", "off", "serial"),
                 ("mxu", "off", "serial"), ("mxu", "fused-pallas", "serial"),
                 ("auto", "auto", "serial"), ("cuda", "off", "overlap"),
                 ("torch", "fused", "overlap")]
OPS = ("equalize", "autocontrast", "otsu")


def _jax(spec, img):
    return np.asarray(JaxPipeline.parse(spec)(jnp.asarray(img)))


def _both(spec, img):
    got = Pipeline.parse(spec)(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, _jax(spec, img), err_msg=spec)
    return got


# --------------------------------------------------------------------------
# numpy oracles (tests/test_histogram_ops.py's)
# --------------------------------------------------------------------------


def _np_equalize(img):
    hist = np.bincount(img.ravel(), minlength=256)
    cdf = np.cumsum(hist)
    total = cdf[-1]
    cdf_min = cdf[np.nonzero(hist)[0][0]]
    denom = np.float32(total - cdf_min)
    if denom <= 0:
        return img.copy()
    scaled = (cdf - cdf_min).astype(np.float32) * (np.float32(255.0) / denom)
    return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)[img]


def _np_autocontrast(img):
    lo, hi = np.float32(img.min()), np.float32(img.max())
    if hi <= lo:
        return img.copy()
    ident = np.arange(256, dtype=np.float32)
    lut = np.clip(np.rint((ident - lo) * (np.float32(255.0) / (hi - lo))), 0, 255)
    return lut.astype(np.uint8)[img]


def _np_otsu_threshold(img):
    hist = np.bincount(img.ravel(), minlength=256).astype(np.float64)
    best_t, best_v = 0, -1.0
    for t in range(256):
        w0, w1 = hist[: t + 1].sum(), hist[t + 1:].sum()
        if w0 == 0 or w1 == 0:
            continue
        mu0 = (hist[: t + 1] * np.arange(t + 1)).sum() / w0
        mu1 = (hist[t + 1:] * np.arange(t + 1, 256)).sum() / w1
        v = w0 * w1 * (mu0 - mu1) ** 2
        if v > best_v:
            best_t, best_v = t, v
    return best_t


# --------------------------------------------------------------------------
# tests/test_histogram_ops.py's cases, through both packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("valid_rows", [None, 24, 0, 31])
def test_histogram_counts_and_mask(valid_rows):
    img = synthetic_image(31, 17, channels=1, seed=50)
    valid = None if valid_rows is None else (np.arange(31) < valid_rows).astype(np.int32)[:, None]
    got = H.histogram_stats(torch.from_numpy(img), None if valid is None
                            else torch.from_numpy(valid))
    want = np.asarray(JH.histogram_stats(jnp.asarray(img), None if valid is None
                                         else jnp.asarray(valid)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    rows = 31 if valid_rows is None else valid_rows
    np.testing.assert_array_equal(got.numpy(), np.bincount(img[:rows].ravel(), minlength=256))
    # a boolean mask and a 2-D per-pixel mask count the same
    if valid is not None:
        full = np.broadcast_to(valid, img.shape)
        np.testing.assert_array_equal(
            H.histogram_stats(torch.from_numpy(img), torch.from_numpy(full.astype(bool))).numpy(),
            want)


def test_equalize_vs_oracle():
    img = (synthetic_image(64, 48, channels=1, seed=51) // 3 + 60).astype(np.uint8)
    got = _both("equalize", img)
    np.testing.assert_array_equal(got, _np_equalize(img))
    assert got.max() - got.min() > img.max() - img.min()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("value", [0, 77, 255])
def test_constant_images(op, value):
    img = np.full((16, 16), value, np.uint8)
    got = _both(op, img)
    if op != "otsu":
        np.testing.assert_array_equal(got, img)  # fixed points


@pytest.mark.parametrize("op", OPS)
def test_global_ops_refuse_colour_on_every_backend(op):
    img = synthetic_image(8, 8, channels=3, seed=52)
    with pytest.raises(ValueError, match="expects a 1-channel image"):
        make_op(op)(torch.from_numpy(img))
    for backend, plan in LANES:
        with pytest.raises(ValueError, match="expects a 1-channel image"):
            Pipeline.parse(op).jit(backend, device="cpu", plan=plan)(img)


def test_autocontrast_vs_oracle():
    img = (synthetic_image(40, 40, channels=1, seed=53) // 2 + 40).astype(np.uint8)
    got = _both("autocontrast", img)
    np.testing.assert_array_equal(got, _np_autocontrast(img))
    assert got.min() == 0 and got.max() == 255
    full = np.array([[0, 255], [128, 7]], np.uint8)
    np.testing.assert_array_equal(_both("autocontrast", full), full)


def test_otsu_bimodal():
    rng = np.random.default_rng(54)
    img = np.where(rng.random((64, 64)) < 0.5, rng.integers(20, 60, (64, 64)),
                   rng.integers(180, 230, (64, 64))).astype(np.uint8)
    got = _both("otsu", img)
    assert set(np.unique(got)) <= {0, 255}
    t = int(H.otsu_threshold_from_hist(H.histogram_stats(torch.from_numpy(img), None)))
    assert abs(t - _np_otsu_threshold(img)) <= 1  # float32 moments vs a float64 oracle
    assert 55 <= t <= 180
    np.testing.assert_array_equal(got, np.where(img > t, 255, 0))


# --------------------------------------------------------------------------
# The table arithmetic on drawn histograms
# --------------------------------------------------------------------------

_FRAME_8K = 4320 * 7680


@st.composite
def histograms(draw):
    """256-bin int32 histograms: random, one bin, two bins, sparse, and
    counts summing to an 8K frame's pixel count."""
    kind = draw(st.sampled_from(["random", "one", "two", "sparse", "frame"]))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    h = np.zeros(256, np.int64)
    if kind == "random":
        h[:] = rng.integers(0, draw(st.sampled_from([10, 3000, 300_000, 8_000_000])), 256)
    elif kind == "one":
        h[draw(st.integers(0, 255))] = draw(st.integers(1, _FRAME_8K))
    elif kind == "two":
        i, j = draw(st.lists(st.integers(0, 255), min_size=2, max_size=2, unique=True))
        h[i], h[j] = draw(st.integers(1, 2**24)), draw(st.integers(1, 2**24))
    elif kind == "sparse":
        idx = rng.choice(256, draw(st.integers(1, 12)), replace=False)
        h[idx] = rng.integers(1, 5_000_000, len(idx))
    else:
        p = rng.dirichlet(np.full(256, draw(st.sampled_from([0.05, 1.0, 20.0]))))
        h[:] = rng.multinomial(_FRAME_8K, p)
    return h.astype(np.int32)


_jax_otsu = jax.jit(JH.otsu_threshold_from_hist)


@settings(max_examples=150, deadline=None)
@given(histograms())
def test_ordered_prefix_sum_and_otsu_equal_jax(hist):
    """The moments' prefix sum passes 2^24, where the order of the float32
    adds decides the bits: the port's ordered sum equals ``jnp.cumsum`` bit
    for bit, and so the threshold equals JAX's, eager and jitted."""
    m = hist.astype(np.float32) * np.arange(256, dtype=np.float32)
    got = H._prefix_sum_f32(torch.from_numpy(m)).numpy()
    want = np.asarray(jnp.cumsum(jnp.asarray(m)))
    assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()
    t = int(H.otsu_threshold_from_hist(torch.from_numpy(hist)))
    assert t == int(JH.otsu_threshold_from_hist(jnp.asarray(hist)))
    assert t == int(_jax_otsu(jnp.asarray(hist)))


@settings(max_examples=100, deadline=None)
@given(histograms())
def test_equalize_and_autocontrast_tables_equal_jax(hist):
    """The tables, read through an image that holds every value once."""
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for ours, theirs in ((H.equalize_apply, JH.equalize_apply),
                         (H.autocontrast_apply, JH.autocontrast_apply),
                         (H.otsu_apply, JH.otsu_apply)):
        got = ours(torch.from_numpy(ramp), torch.from_numpy(hist)).numpy()
        want = np.asarray(theirs(jnp.asarray(ramp), jnp.asarray(hist)))
        np.testing.assert_array_equal(got, want)


def test_torch_cumsum_takes_another_order():
    """Why the ordered sum exists: on moments past 2^24, torch.cumsum's
    float32 partial sums differ from jnp.cumsum's."""
    rng = np.random.default_rng(7)
    differs = 0
    for _ in range(3):
        m = (rng.integers(0, 300_000, 256) * np.arange(256)).astype(np.float32)
        ours = torch.cumsum(torch.from_numpy(m), 0).numpy()
        differs += int(np.sum(ours != np.asarray(jnp.cumsum(jnp.asarray(m)))))
        assert np.array_equal(H._prefix_sum_f32(torch.from_numpy(m)).numpy(),
                              np.asarray(jnp.cumsum(jnp.asarray(m))))
    assert differs > 0


# --------------------------------------------------------------------------
# Every backend and plan, unsharded and sharded
# --------------------------------------------------------------------------


@functools.cache
def _jax_reference(spec, shape, seed):
    img = synthetic_image(*shape, seed=seed)
    pipe = JaxPipeline.parse(spec)
    golden = np.asarray(pipe(jnp.asarray(img)))
    np.testing.assert_array_equal(np.asarray(pipe.jit("pallas")(jnp.asarray(img))), golden)
    return golden


@pytest.mark.parametrize("spec", [
    "grayscale,gaussian:3,equalize", "grayscale,gaussian:3,autocontrast",
    "grayscale,gaussian:3,otsu", "grayscale,equalize,gaussian:5",
    "grayscale,autocontrast,emboss:3", "grayscale,contrast:3.5,otsu,sobel,equalize",
    "grayscale,invert,autocontrast,quantize:6,gaussian:5,otsu",
])
def test_every_backend_and_plan_equals_jax(spec):
    img = synthetic_image(48, 40, seed=55)
    want = _jax_reference(spec, (48, 40), 55)
    pipe = Pipeline.parse(spec)
    for backend, plan in LANES:
        got = pipe.jit(backend, device="cpu", plan=plan)(img)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{spec} [{backend}/{plan}]")


SHARDED_SPECS = ["grayscale,equalize", "grayscale,autocontrast", "grayscale,otsu",
                 "grayscale,equalize,gaussian:5", "grayscale,gaussian:3,otsu",
                 "grayscale,autocontrast,emboss:3"]


@functools.cache
def _jax_sharded_8(spec, height):
    img = synthetic_image(height, 56, channels=3, seed=56)
    return np.asarray(JaxPipeline.parse(spec).sharded(jax_make_mesh(8))(jnp.asarray(img)))


@pytest.mark.parametrize("height", [128, 131, 133])
@pytest.mark.parametrize("spec", SHARDED_SPECS)
def test_sharded_equals_jax(spec, height):
    """Pad rows (131 and 133 rows over 2, 3 or 8 slots) stay out of the
    histogram; the counts are summed over the slots."""
    img = synthetic_image(height, 56, channels=3, seed=56)
    want = _jax(spec, img)
    if height in (128, 131):  # the JAX test's own cases
        np.testing.assert_array_equal(_jax_sharded_8(spec, height), want)
    pipe = Pipeline.parse(spec)
    for n in (2, 3, 8):
        mesh = pmesh.make_mesh(n, devices=["cpu"] * n)
        for backend, plan, halo_mode in SHARDED_LANES:
            got = pipe.sharded(mesh, backend=backend, plan=plan, halo_mode=halo_mode)(img)
            np.testing.assert_array_equal(
                got.numpy(), want, err_msg=f"{spec} h={height} n={n} {backend}/{plan}/{halo_mode}")


@pytest.mark.parametrize("op", ["autocontrast", "otsu"])
def test_sharded_pad_rows_would_change_the_histogram(op):
    """The case the mask guards: at 131 rows over 8 slots the last shard
    holds 5 pad rows of zeros, and counting them would change the table
    (of an image with no zero; equalize's table happens not to move, since
    extra zeros shift its cdf and its cdf_min alike)."""
    img = (synthetic_image(131, 56, channels=1, seed=56) // 2 + 40).astype(np.uint8)
    padded = np.concatenate([img, np.zeros((5, 56), np.uint8)])
    assert not np.array_equal(_both(op, padded)[:131], _both(op, img))
    got = Pipeline.parse(op).sharded(pmesh.make_mesh(8, devices=["cpu"] * 8))(img)
    np.testing.assert_array_equal(got.numpy(), _both(op, img))


def test_cli_gray_output_after_global_ops(tmp_path):
    src = tmp_path / "in.png"
    img = synthetic_image(40, 64, channels=3, seed=57)
    save_image(src, img)
    for spec in ("grayscale,otsu", "grayscale,gaussian:3,equalize"):
        want = _jax(spec, img)
        for impl, plan, shards in (("cuda", "off", None), ("swar", "off", "4"),
                                   ("cuda", "fused-pallas", "4"), ("mxu", "fused-pallas-mxu", None),
                                   ("torch", "fused", "2")):
            out = tmp_path / f"{impl}-{plan}.png"
            argv = ["run", "--input", str(src), "--output", str(out), "--device", "cpu",
                    "--ops", spec, "--impl", impl, "--plan", plan, "--gray-output"]
            if shards:
                argv += ["--shards", shards]
            assert cli.main(argv) == 0, argv
            with Image.open(out) as im:
                assert im.mode == "L", argv  # one channel written
            got = load_image(out, grayscale=True)
            np.testing.assert_array_equal(got, want, err_msg=" ".join(argv))


def test_cli_info_lists_the_global_ops_as_ported(capsys):
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.strip().startswith("global-stat:"))
    assert {n.strip() for n in line.split(":", 1)[1].split(",")} == set(OPS)
    assert {n for n, f in registry_family_table().items() if f == "global-stat"} == set(OPS)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@settings(max_examples=50, deadline=None)
@given(hist=histograms())
def test_tables_on_the_card_equal_the_cpu(hist):
    """The ordered prefix sum and the table arithmetic give the card the
    CPU's bytes."""
    if not torch.cuda.is_available():  # decided here, not at import
        pytest.skip("needs a CUDA device")
    ramp = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    for fn in (H.equalize_apply, H.autocontrast_apply, H.otsu_apply):
        want = fn(ramp, torch.from_numpy(hist))
        got = fn(ramp.cuda(), torch.from_numpy(hist).cuda())
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_histogram_on_the_card_equals_the_cpu(cuda_device, op):
    img = synthetic_image(131, 77, channels=1, seed=58)
    x = torch.from_numpy(img)
    valid = (torch.arange(131) < 120).view(-1, 1)
    assert torch.equal(H.histogram_stats(x.to(cuda_device), valid.to(cuda_device)).cpu(),
                       H.histogram_stats(x, valid))
    assert torch.equal(make_op(op)(x.to(cuda_device)).cpu(), make_op(op)(x))
