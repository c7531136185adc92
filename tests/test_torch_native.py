"""The port's native codec (runtime/native/mcim_runtime.cpp, built by
runtime/build.py, bound by runtime/codec.py) and the rest of its
io/image.py, against the JAX package's on the CPU: the counterpart of
tests/test_native.py.

The codec builds with g++ under build/native/ at its first use (never next
to its source) and the port loads that build, never the JAX package's
library. Round trips, PIL parity both ways, the header alone, a missing
file, BatchLoader's order, buffer growth and decode failure, batch_load on
the native path against the PIL path (and against the JAX package's
batch_load), PGM normalised to RGB, skip on error, the byte codecs and
their failpoint. Exact byte equality throughout.
"""

import io
import os

import numpy as np
import pytest

import mpi_cuda_imagemanipulation_tpu.io.image as jax_io
import mpi_cuda_imagemanipulation_tpu_torch.io.image as io_image
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    batch_load,
    decode_image_bytes,
    encode_image_bytes,
    encode_image_into,
    load_image,
    save_image,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.resilience.failpoints import FailpointError
from mpi_cuda_imagemanipulation_tpu_torch.runtime import build, codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(REPO, "mpi_cuda_imagemanipulation_tpu_torch", "runtime", "native")


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


@pytest.fixture
def pil_only(monkeypatch):
    """io/image.py as it runs where the codec cannot be built."""
    monkeypatch.setattr(io_image, "_native_codec", lambda: None)


def test_codec_builds_under_build_and_leaves_the_tree_clean():
    """The library is the port's own build, under build/native/ (which
    .gitignore lists), named by its source's hash; the source directory
    holds the source and the Makefile only."""
    assert codec.available()
    path = codec.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path) == build.library_path().name
    assert sorted(os.listdir(NATIVE_SRC)) == ["Makefile", "mcim_runtime.cpp"]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()
    assert build.build(verbose=False) == build.library_path()  # built once


def test_port_loads_its_own_library_never_the_jax_one():
    jax_lib = os.path.join(REPO, "mpi_cuda_imagemanipulation_tpu", "runtime", "native",
                           "libmcim_runtime.so")
    assert os.path.realpath(codec.library_path()) != os.path.realpath(jax_lib)
    with open(os.path.join(REPO, "mpi_cuda_imagemanipulation_tpu_torch", "runtime",
                           "codec.py")) as f:
        assert "mpi_cuda_imagemanipulation_tpu.runtime" not in f.read()


@pytest.mark.parametrize("channels,ext", [(3, ".ppm"), (1, ".pgm")])
def test_roundtrip_counted(tmp_path, channels, ext):
    a = synthetic_image(37, 53, channels=channels, seed=1 + channels)
    p = str(tmp_path / f"a{ext}")
    reads, writes = codec.NATIVE_IO["read"], codec.NATIVE_IO["write"]
    codec.write_image(p, a)
    b = codec.read_image(p)
    assert b.shape == a.shape and b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert (codec.NATIVE_IO["read"] - reads, codec.NATIVE_IO["write"] - writes) == (1, 1)


def test_native_reads_pil_written_and_vice_versa(tmp_path):
    from PIL import Image

    a = synthetic_image(20, 30, channels=3, seed=3)
    p1 = str(tmp_path / "pil.ppm")
    Image.fromarray(a).save(p1)
    np.testing.assert_array_equal(codec.read_image(p1), a)
    p2 = str(tmp_path / "native.ppm")
    codec.write_image(p2, a)
    with Image.open(p2) as im:
        np.testing.assert_array_equal(np.asarray(im), a)


def test_native_and_jax_codec_files_agree(tmp_path):
    """The port's writer gives the JAX package's bytes, and each package's
    load_image reads the other's file to the same array."""
    a = synthetic_image(11, 17, channels=3, seed=4)
    ours, theirs = str(tmp_path / "ours.ppm"), str(tmp_path / "theirs.ppm")
    save_image(ours, a)
    jax_io.save_image(theirs, a)
    with open(ours, "rb") as f1, open(theirs, "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(load_image(theirs), jax_io.load_image(ours))


def test_header_only(tmp_path):
    p = str(tmp_path / "h.pgm")
    codec.write_image(p, synthetic_image(13, 29, channels=1, seed=5))
    assert codec.read_header(p) == (13, 29, 1)
    with open(p, "rb") as f:
        assert f.read(2) == b"P5"


def test_read_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        codec.read_image(str(tmp_path / "nope.ppm"))
    with pytest.raises(IOError):
        codec.read_header(str(tmp_path / "nope.ppm"))


def test_batch_loader_order_and_contents(tmp_path):
    paths = []
    for i in range(25):
        p = str(tmp_path / f"b{i:02d}.ppm")
        codec.write_image(p, synthetic_image(16 + i, 24, channels=3, seed=60 + i))
        paths.append(p)
    with codec.BatchLoader(paths, n_threads=5) as loader:
        got = list(loader)
    assert [idx for idx, _ in got] == list(range(25))
    for i, (_, arr) in enumerate(got):
        np.testing.assert_array_equal(arr, codec.read_image(paths[i]))


def test_batch_loader_buffer_growth(tmp_path):
    big = synthetic_image(700, 600, channels=3, seed=70)  # past the first 1 MiB buffer
    p = str(tmp_path / "big.ppm")
    codec.write_image(p, big)
    with codec.BatchLoader([p]) as loader:
        idx, arr = next(loader)
    assert idx == 0
    np.testing.assert_array_equal(arr, big)


def test_batch_loader_decode_failure_raises(tmp_path):
    good = str(tmp_path / "good.ppm")
    codec.write_image(good, synthetic_image(8, 8, channels=3, seed=71))
    with codec.BatchLoader([good, str(tmp_path / "missing.ppm")]) as loader:
        assert next(loader)[0] == 0
        with pytest.raises(IOError, match="missing.ppm"):
            next(loader)


def _files(tmp_path, n, ext=".ppm"):
    paths = []
    for i in range(n):
        p = str(tmp_path / f"x{i}{ext}")
        save_image(p, synthetic_image(12 + i, 20, channels=3, seed=80 + i))
        paths.append(p)
    return paths


def test_batch_load_native_matches_pil_path_and_jax(tmp_path, monkeypatch):
    paths = _files(tmp_path, 6)
    native = dict(batch_load(paths))
    monkeypatch.setattr(io_image, "_native_codec", lambda: None)
    fallback = dict(batch_load(paths))
    theirs = dict(jax_io.batch_load(paths))
    assert set(native) == set(fallback) == set(theirs) == set(range(6))
    for i in native:
        np.testing.assert_array_equal(native[i], fallback[i])
        np.testing.assert_array_equal(native[i], theirs[i])


def test_batch_load_uses_the_native_loader_for_ppm_only(tmp_path):
    """All PPM/PGM: the native BatchLoader (counted); a PNG among them: the
    PIL path for every file."""
    paths = _files(tmp_path, 3)
    reads = codec.NATIVE_IO["read"]
    assert len(list(batch_load(paths))) == 3
    assert codec.NATIVE_IO["read"] - reads == 3
    png = str(tmp_path / "y.png")
    save_image(png, synthetic_image(9, 20, channels=3, seed=89))
    reads = codec.NATIVE_IO["read"]
    got = list(batch_load(paths + [png]))
    assert [i for i, _ in got] == [0, 1, 2, 3]
    assert codec.NATIVE_IO["read"] - reads == 3  # load_image's native path per PPM


def test_batch_load_pgm_normalized_to_rgb(tmp_path, monkeypatch):
    gray = synthetic_image(14, 20, channels=1, seed=85)
    p = str(tmp_path / "g.pgm")
    codec.write_image(p, gray)
    (_, arr), = list(batch_load([p]))
    assert arr.shape == (14, 20, 3)
    np.testing.assert_array_equal(arr[..., 0], gray)
    monkeypatch.setattr(io_image, "_native_codec", lambda: None)
    (_, arr2), = list(batch_load([p]))
    np.testing.assert_array_equal(arr, arr2)
    (_, arr3), = list(jax_io.batch_load([p]))
    np.testing.assert_array_equal(arr, arr3)


@pytest.mark.parametrize("native", [True, False])
def test_batch_load_skip_on_error_and_digests(tmp_path, monkeypatch, native):
    from mpi_cuda_imagemanipulation_tpu_torch.resilience.journal import content_digest

    if not native:
        monkeypatch.setattr(io_image, "_native_codec", lambda: None)
    good0, bad, good1 = (str(tmp_path / n) for n in ("a.ppm", "missing.ppm", "b.ppm"))
    save_image(good0, synthetic_image(8, 8, channels=3, seed=86))
    save_image(good1, synthetic_image(9, 9, channels=3, seed=87))
    got = list(batch_load([good0, bad, good1], on_error="skip", with_digests=True))
    assert [i for i, _, _ in got] == [0, 2]
    assert [d for _, _, d in got] == [content_digest(good0), content_digest(good1)]
    with pytest.raises(IOError):
        list(batch_load([good0, bad, good1], on_error="raise"))
    with pytest.raises(ValueError, match="on_error"):
        list(batch_load([good0], on_error="ignore"))


def test_batch_load_bounds_its_lookahead(tmp_path, monkeypatch):
    """The PIL path submits at most MAX_AHEAD decodes ahead of the
    consumer."""
    monkeypatch.setattr(io_image, "_native_codec", lambda: None)
    paths = _files(tmp_path, 1) * 40
    started = []
    real = io_image.load_image
    monkeypatch.setattr(io_image, "load_image", lambda p: started.append(p) or real(p))
    it = batch_load(paths, n_threads=2)
    next(it)
    assert len(started) <= io_image.MAX_AHEAD + 1
    assert len(list(it)) == 39


@pytest.mark.parametrize("channels", [3, 1])
def test_load_image_grayscale_on_any_decoder_equals_jax(tmp_path, monkeypatch, channels):
    a = synthetic_image(15, 22, channels=channels, seed=90)
    p = str(tmp_path / ("c.ppm" if channels == 3 else "c.pgm"))
    save_image(p, a)
    want = jax_io.load_image(p, grayscale=True)
    np.testing.assert_array_equal(load_image(p, grayscale=True), want)
    monkeypatch.setattr(io_image, "_native_codec", lambda: None)
    np.testing.assert_array_equal(load_image(p, grayscale=True), want)
    np.testing.assert_array_equal(load_image(p), jax_io.load_image(p))


@pytest.mark.parametrize("fmt", ["PNG", "PPM", "BMP"])
@pytest.mark.parametrize("channels", [3, 1])
def test_byte_codecs_equal_jax(fmt, channels):
    a = synthetic_image(10, 14, channels=channels, seed=91)
    data = encode_image_bytes(a, format=fmt)
    assert data == jax_io.encode_image_bytes(a, format=fmt)
    np.testing.assert_array_equal(decode_image_bytes(data), jax_io.decode_image_bytes(data))
    np.testing.assert_array_equal(decode_image_bytes(data), a)
    sink = io.BytesIO()
    encode_image_into(a[..., None] if channels == 1 else a, sink, format=fmt)
    assert sink.getvalue() == data
    with pytest.raises(TypeError, match="uint8"):
        encode_image_bytes(a.astype(np.int16))


def test_decode_failpoint_fires_on_bytes_and_files(tmp_path):
    data = encode_image_bytes(synthetic_image(4, 4, seed=1))
    failpoints.configure("io.decode=always")
    with pytest.raises(FailpointError):
        decode_image_bytes(data)
    with pytest.raises(FailpointError):
        load_image(str(tmp_path / "never_opened.ppm"))


def test_without_the_codec_ppm_goes_through_pil(tmp_path, pil_only):
    """Without the codec (no g++), PPM/PGM go through PIL: same bytes."""
    a = synthetic_image(9, 13, channels=3, seed=92)
    p = str(tmp_path / "p.ppm")
    save_image(p, a)
    np.testing.assert_array_equal(load_image(p), a)
