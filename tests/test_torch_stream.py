"""The port's streaming tile engine (stream/, io/stream_codec.py,
ops/temporal.py, parallel/halo's host strips, CLI ``stream`` and ``batch
--stream-rows``) against the JAX package's, on the CPU: the counterpart of
tests/test_stream.py without its live sessions, its stream_ab bench lane and
its two engine cases (tests/test_torch_engine.py holds those).

Tolerance 0 everywhere: the port's streamed output equals the JAX package's
``stream_pipeline`` (impl ``xla``) and the whole-image golden byte for byte,
at every seam position (a seeded sweep and a hypothesis property), for every
stencil family, multi-op chains at 1 and 3 channels, every plan mode; the
PNG and PGM files equal the JAX writers' files byte for byte. The memory
test asserts the peak against the bound the runner's tracking implies
(``stream/runner.resident_bound``), which holds under any thread
interleaving, not against a second timed run.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import random
import sys
from collections import deque

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from mpi_cuda_imagemanipulation_tpu import cli as jax_cli
from mpi_cuda_imagemanipulation_tpu.io import stream_codec as jax_codec
from mpi_cuda_imagemanipulation_tpu.io.image import synthetic_tile as jax_synthetic_tile
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops import temporal as jax_temporal
from mpi_cuda_imagemanipulation_tpu.parallel import halo as jax_halo
from mpi_cuda_imagemanipulation_tpu.stream import StreamMetrics as JaxStreamMetrics
from mpi_cuda_imagemanipulation_tpu.stream import plan_tiles as jax_plan_tiles
from mpi_cuda_imagemanipulation_tpu.stream import stream_fingerprint as jax_fingerprint
from mpi_cuda_imagemanipulation_tpu.stream import stream_pipeline as jax_stream_pipeline
from mpi_cuda_imagemanipulation_tpu.stream import stream_video as jax_stream_video
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    load_image,
    synthetic_image,
    synthetic_tile,
)
from mpi_cuda_imagemanipulation_tpu_torch.io.stream_codec import (
    ArrayTileReader,
    ArrayTileWriter,
    PNGTileReader,
    PNGTileWriter,
    PNMTileReader,
    PNMTileWriter,
    SyntheticTileReader,
    UnsupportedStreamFormat,
    open_tile_reader,
    open_tile_writer,
)
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import temporal
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
from mpi_cuda_imagemanipulation_tpu_torch.parallel.halo import host_edge_strips, stitch_tile
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.resilience.journal import BatchJournal
from mpi_cuda_imagemanipulation_tpu_torch.stream import (
    StreamabilityError,
    StreamMetrics,
    plan_tiles,
    resumable_tiles,
    stream_fingerprint,
    stream_pipeline,
    stream_video,
)
from mpi_cuda_imagemanipulation_tpu_torch.stream import runner as stream_runner
from mpi_cuda_imagemanipulation_tpu_torch.stream.runner import TileStager, resident_bound
from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import out_channels

REFERENCE = "grayscale,contrast:3.5,emboss:3"


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


def golden(img: np.ndarray, spec: str) -> np.ndarray:
    """The port's whole-image golden ops on the CPU."""
    return Pipeline.parse(spec)(torch.from_numpy(img)).numpy()


def jax_golden(img: np.ndarray, spec: str) -> np.ndarray:
    return np.asarray(JaxPipeline.parse(spec).jit()(img))


def run_streamed(img: np.ndarray, spec: str, tile_rows: int, **kw):
    """Stream `img` through `spec` on the CPU; (result, output array)."""
    ops = Pipeline.parse(spec).ops
    c = img.shape[2] if img.ndim == 3 else 1
    writer = ArrayTileWriter(img.shape[0], img.shape[1], out_channels(ops, c))
    res = stream_pipeline(ArrayTileReader(img), writer, ops, tile_rows=tile_rows, device="cpu",
                          metrics=StreamMetrics(), **kw)
    return res, writer.array


def jax_streamed(img: np.ndarray, spec: str, tile_rows: int, **kw) -> np.ndarray:
    """The JAX package's stream_pipeline (impl xla unless `kw` says)."""
    ops = JaxPipeline.parse(spec).ops
    c = img.shape[2] if img.ndim == 3 else 1
    writer = jax_codec.ArrayTileWriter(img.shape[0], img.shape[1], out_channels(
        Pipeline.parse(spec).ops, c))
    jax_stream_pipeline(jax_codec.ArrayTileReader(img), writer, ops, tile_rows=tile_rows,
                        metrics=JaxStreamMetrics(), **kw)
    return writer.array


# --------------------------------------------------------------------------
# geometry, fingerprints, host strips, the windowed generator
# --------------------------------------------------------------------------


@pytest.mark.parametrize("halo", [0, 1, 2, 3, 6, 9])
def test_plan_tiles_equals_jax(halo):
    for height in list(range(1, 70)) + [97, 128, 255, 256, 1000]:
        for tile_rows in list(range(1, 20)) + [32, 64, 500]:
            try:
                want = jax_plan_tiles(height, tile_rows, halo)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    plan_tiles(height, tile_rows, halo)
                assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
                continue
            got = plan_tiles(height, tile_rows, halo)
            assert [(t.index, t.out_lo, t.out_hi, t.lead, t.tail) for t in got] == \
                [(t.index, t.out_lo, t.out_hi, t.lead, t.tail) for t in want], (height, tile_rows)


def test_plan_tiles_refusals():
    with pytest.raises(ValueError, match="tile_rows"):
        plan_tiles(10, 0, 0)
    with pytest.raises(ValueError, match="height"):
        plan_tiles(0, 8, 0)
    with pytest.raises(StreamabilityError, match="--tile-rows"):
        plan_tiles(100, 4, 6)


def test_plan_tiles_merges_short_last_band():
    tiles = plan_tiles(100, 32, halo=6)  # naive last band = 4 rows < halo
    assert tiles[-1].out_hi == 100
    assert tiles[-1].out_rows >= 6
    assert [t.out_lo for t in tiles] == [0, 32, 64]
    assert tiles[1].lead == 6 and tiles[1].tail == 6
    assert tiles[0].lead == 0 and tiles[-1].tail == 0


@pytest.mark.parametrize("args", [
    ("gaussian5", 100, 20, 1, 16, "xla"), ("gaussian5", 100, 20, 1, 16, "torch"),
    ("grayscale,contrast3.5,emboss3", 4320, 7680, 3, 512, "mxu"),
    ("framediff", 1, 1, 1, 1, "auto"),
])
def test_stream_fingerprint_equals_jax(args):
    assert stream_fingerprint(*args) == jax_fingerprint(*args)


def test_host_edge_strips_are_copies_and_equal_jax():
    tile = synthetic_image(10, 6, channels=1, seed=0)
    want = jax_halo.host_edge_strips(tile.copy(), 2)
    first, last = host_edge_strips(tile, 2)
    assert np.array_equal(first, want[0]) and np.array_equal(last, want[1])
    assert np.array_equal(first, tile[:2]) and np.array_equal(last, tile[-2:])
    tile[:] = 0  # mutating the donor must not corrupt the carried strip
    assert first.any() or last.any()
    ext = stitch_tile(first, tile, last)
    assert ext.shape[0] == 14
    assert np.array_equal(ext, jax_halo.stitch_tile(first, tile, last))
    assert stitch_tile(None, tile, None) is tile
    rgb = synthetic_image(9, 5, channels=3, seed=1)
    for axis in (0, 1):
        got = host_edge_strips(rgb, 3, axis=axis)
        want = jax_halo.host_edge_strips(rgb, 3, axis=axis)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("channels", [1, 3])
def test_synthetic_tile_matches_full_slicing(channels):
    full = synthetic_image(700, 37, channels=channels, seed=9)
    for row0, rows in [(0, 700), (0, 1), (255, 2), (256, 256), (13, 511), (699, 1)]:
        tile = synthetic_tile(row0, rows, 37, channels=channels, seed=9)
        assert np.array_equal(tile, full[row0 : row0 + rows]), (row0, rows)
        assert np.array_equal(tile, jax_synthetic_tile(row0, rows, 37, channels=channels,
                                                       seed=9))


def test_synthetic_tile_never_needs_the_height():
    t = synthetic_tile(10_000_000, 4, 64, channels=3, seed=0)
    assert t.shape == (4, 64, 3)
    reader = SyntheticTileReader(10_000_004, 64, channels=3, seed=0)
    reader.skip_rows(10_000_000)
    assert np.array_equal(reader.read_rows(9), t)  # read_rows stops at the height


# --------------------------------------------------------------------------
# seam exactness: every family, multi-op chains, every seam position
# --------------------------------------------------------------------------

FAMILY_SPECS = [
    "gaussian:5", "gaussian:7", "box:3", "sharpen", "unsharp",
    "sobel", "prewitt", "scharr", "laplacian:8",
    "emboss:3", "emboss:5", "emboss101:5",
    "median:3", "median:5", "erode:3", "dilate:5",
    "filter:1/2/1/2/4/2/1/2/1:0.0625",
]


@pytest.mark.parametrize("spec", FAMILY_SPECS)
def test_every_stencil_family_bitexact_across_seams(spec):
    img = synthetic_image(61, 40, channels=1, seed=3)
    _res, got = run_streamed(img, spec, tile_rows=8)
    assert np.array_equal(got, golden(img, spec)), spec
    assert np.array_equal(got, jax_golden(img, spec)), spec


MULTIOP = [
    (REFERENCE, 16, 3),  # the reference chain
    ("grayscale,gaussian:5,sharpen,median:3", 8, 3),  # halo 2+1+1
    ("gaussian:7,erode:3,box:3", 16, 1),
    ("unsharp,emboss:5", 32, 3),
    ("grayscale601,contrast:4.3,gamma:2.2", 8, 3),  # lookup-table ops stream
    ("sepia,solarize:99,posterize:3", 16, 3),
    ("threshold:100,gray2rgb", 8, 1),
]


@pytest.mark.parametrize("spec,tile_rows,channels", MULTIOP)
def test_multiop_chains_equal_jax_stream_and_golden(spec, tile_rows, channels):
    img = synthetic_image(97, 33, channels=channels, seed=3)
    assert tile_rows >= chain_halo(Pipeline.parse(spec).ops)
    res, got = run_streamed(img, spec, tile_rows=tile_rows)
    assert np.array_equal(got, golden(img, spec)), spec
    assert np.array_equal(got, jax_streamed(img, spec, tile_rows)), spec
    assert res.compiles <= 4  # at most four tile functions whatever the tile count


def test_mxu_impl_streams_equal_jax():
    img = synthetic_image(50, 32, channels=1, seed=2)
    _res, got = run_streamed(img, "gaussian:5,sharpen", tile_rows=16, impl="mxu")
    assert np.array_equal(got, golden(img, "gaussian:5,sharpen"))
    assert np.array_equal(got, jax_streamed(img, "gaussian:5,sharpen", 16, impl="mxu"))


@pytest.mark.parametrize("plan", ["fused-pallas", "fused-pallas-mxu"])
def test_megakernel_plan_modes_walk_in_the_stream_as_in_jax(plan):
    """A resolved fused-pallas[-mxu] keeps its stage partition and walks it
    (the megakernel does not model a band's context budget), in the port as
    in the JAX package."""
    img = synthetic_image(70, 29, channels=3, seed=5)
    spec = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"
    _res, got = run_streamed(img, spec, tile_rows=12, plan=plan)
    assert np.array_equal(got, golden(img, spec))
    assert np.array_equal(got, jax_streamed(img, spec, 12, plan=plan))


@pytest.mark.parametrize("plan", ["off", "pointwise", "fused", "auto"])
@pytest.mark.parametrize("impl", ["torch", "mxu", "auto"])
def test_every_plan_and_impl_streams_the_golden_bytes(plan, impl):
    img = synthetic_image(53, 31, channels=3, seed=6)
    spec = "grayscale,gaussian:3,contrast:3.5,emboss:3,median:3"
    _res, got = run_streamed(img, spec, tile_rows=7, plan=plan, impl=impl)
    assert np.array_equal(got, golden(img, spec)), (plan, impl)


_PROPERTY_SPECS = [
    "gaussian:5,sharpen",
    "emboss:3",  # 'interior' edge mode: global-coordinate mask
    "median:3,erode:3",
    "sobel,invert",
]


def _check_seam_bitexact(h, tile_rows, spec_i, channels):
    spec = _PROPERTY_SPECS[spec_i]
    halo = chain_halo(Pipeline.parse(spec).ops)
    tile_rows = max(tile_rows, halo)
    img = synthetic_image(h, 25, channels=channels, seed=h * 7 + spec_i)
    _res, got = run_streamed(img, spec, tile_rows=tile_rows)
    assert np.array_equal(got, golden(img, spec)), (h, tile_rows, spec)


@settings(max_examples=20, deadline=None)
@given(
    h=st.integers(min_value=17, max_value=120),
    tile_rows=st.integers(min_value=4, max_value=64),
    spec_i=st.integers(min_value=0, max_value=3),
    channels=st.sampled_from([1, 3]),
)
def test_seam_bitexactness_property(h, tile_rows, spec_i, channels):
    _check_seam_bitexact(h, tile_rows, spec_i, channels)


@pytest.mark.parametrize("case", range(20))
def test_seam_bitexactness_seeded_sweep(case):
    rng = random.Random(0xC1A0 + case)
    _check_seam_bitexact(h=rng.randint(17, 120), tile_rows=rng.randint(4, 64),
                         spec_i=rng.randrange(len(_PROPERTY_SPECS)), channels=rng.choice([1, 3]))


@pytest.mark.parametrize("spec", ["emboss:3", REFERENCE, "grayscale,contrast:3.5,emboss:5,emboss:3"])
def test_interior_guard_at_every_seam_position(spec):
    """The 'interior' mask sees global rows at every seam, including the
    short last band plan_tiles merges into its predecessor."""
    img = synthetic_image(40, 19, channels=3, seed=8)
    want = golden(img, spec)
    halo = chain_halo(Pipeline.parse(spec).ops)
    for tile_rows in range(max(halo, 1), 41):
        _res, got = run_streamed(img, spec, tile_rows=tile_rows)
        assert np.array_equal(got, want), (spec, tile_rows)


def test_single_tile_and_pointwise_only():
    img = synthetic_image(40, 20, channels=1, seed=1)
    _res, got = run_streamed(img, "gaussian:5", tile_rows=500)
    assert np.array_equal(got, golden(img, "gaussian:5"))
    res, got = run_streamed(img, "invert,brightness:7", tile_rows=8)
    assert np.array_equal(got, golden(img, "invert,brightness:7"))
    assert res.compiles == 1  # halo-0 chain: one variant serves every tile


def test_non_streamable_ops_rejected():
    img = synthetic_image(32, 16, channels=1, seed=0)
    with pytest.raises(StreamabilityError):
        run_streamed(img, "rot90", tile_rows=8)
    with pytest.raises(StreamabilityError):
        run_streamed(img, "equalize", tile_rows=8)


def test_tile_rows_below_chain_halo_rejected():
    img = synthetic_image(64, 16, channels=1, seed=0)
    with pytest.raises(StreamabilityError):
        run_streamed(img, "gaussian:7,gaussian:7", tile_rows=4)  # halo 6


def test_unknown_impl_rejected():
    img = synthetic_image(16, 16, channels=1, seed=0)
    with pytest.raises(ValueError, match="unknown stream impl"):
        run_streamed(img, "gaussian:3", tile_rows=8, impl="cuda")


def test_stream_entry_points_default_to_cuda(tmp_path):
    """No fallback hides the device: without CUDA the default raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    img = synthetic_image(16, 8, channels=1, seed=0)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        stream_pipeline(ArrayTileReader(img), ArrayTileWriter(16, 8, 1),
                        Pipeline.parse("gaussian:3").ops, tile_rows=8)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        stream_video([], tmp_path, "framediff")
    assert cli.main(["stream", "--synthetic", "16x8x1", "--output", str(tmp_path / "x.pgm"),
                     "--ops", "gaussian:3"]) == 2


# --------------------------------------------------------------------------
# resident bytes: the bound the runner's tracking implies
# --------------------------------------------------------------------------


def _stream_peak(h: int, *, inflight: int, io_threads: int, width=48, tile_rows=16):
    ops = Pipeline.parse(REFERENCE).ops
    metrics = StreamMetrics()
    writer = ArrayTileWriter(h, width, out_channels(ops, 3))
    with Engine(inflight=inflight, io_threads=io_threads,
                stage=TileStager("cpu", inflight=inflight, metrics=metrics),
                metrics=EngineMetrics(registry=metrics.registry), ordered_done=True,
                name="mem-test") as eng:
        stream_pipeline(SyntheticTileReader(h, width, channels=3, seed=5), writer, ops,
                        tile_rows=tile_rows, device="cpu", metrics=metrics, engine=eng)
        backlog = eng.encode_backlog
    assert np.array_equal(writer.array[:40], golden(synthetic_image(h, width, seed=5)[:41],
                                                     REFERENCE)[:40])
    bound = resident_bound(width=width, channels=3, out_chan=1, tile_rows=tile_rows,
                           halo=chain_halo(ops), inflight=inflight, encode_backlog=backlog,
                           pinned=False)
    return metrics.peak_resident_bytes, bound


def test_constant_memory_bound_20x_and_flat():
    h_big = 8192
    peak_big, bound = _stream_peak(h_big, inflight=2, io_threads=1)
    frame_bytes = h_big * 48 * 3
    # the bound, whatever the image height, is at least 20x below the frame
    assert frame_bytes >= 20 * bound, (frame_bytes, bound)
    assert 0 < peak_big <= bound, (peak_big, bound)
    # flat in height: resident_bound takes no height, and the peak of a
    # quarter of the image is held to that same bound
    peak_small, _ = _stream_peak(h_big // 4, inflight=2, io_threads=1)
    assert 0 < peak_small <= bound, (peak_small, bound)


@pytest.mark.parametrize("flag,env,want", [(None, None, 2), (None, "3", 3), (4, "3", 4), (0, None, 2)])
def test_both_stream_entry_points_take_one_inflight_default(monkeypatch, flag, env, want):
    """`stream` and `batch --stream-rows` read their in-flight depth from one
    helper: --inflight, else MCIM_STREAM_INFLIGHT, else 2."""
    if env is None:
        monkeypatch.delenv("MCIM_STREAM_INFLIGHT", raising=False)
    else:
        monkeypatch.setenv("MCIM_STREAM_INFLIGHT", env)
    assert cli._stream_inflight(argparse.Namespace(inflight=flag)) == want


def test_resident_bound_holds_under_a_short_switch_interval():
    """More engine threads than cores' worth of work and a 10 us switch
    interval: the peak stays within the bound in every interleaving."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for inflight, io_threads in [(1, 1), (3, 4), (4, 8)]:
            peak, bound = _stream_peak(640, inflight=inflight, io_threads=io_threads,
                                       tile_rows=8)
            assert 0 < peak <= bound, (inflight, io_threads, peak, bound)
    finally:
        sys.setswitchinterval(old)


class _FakePool:
    def __init__(self):
        self.held = 0
        self.cleared = 0

    def nbytes(self):
        return self.held

    def clear(self):
        self.cleared += 1
        self.held = 0


def test_stager_counts_its_pinned_buffers_and_releases_them(monkeypatch):
    """The stager's pool (pinned on a card) counts in the resident bytes and
    is released when each stream ends, so a batch over many shapes holds one
    stream's buffers at a time."""
    pool = _FakePool()

    def fake_stager(device, *, inflight):
        def stage(x):
            pool.held += np.asarray(x).nbytes  # a new buffer for every band shape
            return torch.as_tensor(x).clone()

        stage.pool = pool
        return stage

    monkeypatch.setattr(stream_runner, "device_stager", fake_stager)
    metrics = StreamMetrics()
    ops = Pipeline.parse("gaussian:3").ops
    with Engine(inflight=2, io_threads=1, stage=TileStager("cpu", inflight=2, metrics=metrics),
                metrics=EngineMetrics(registry=metrics.registry), ordered_done=True,
                name="pool-test") as eng:
        for k, h in enumerate([40, 57, 33]):
            img = synthetic_image(h, 21, channels=1, seed=k)
            writer = ArrayTileWriter(h, 21, 1)
            stream_pipeline(ArrayTileReader(img), writer, ops, tile_rows=8, device="cpu",
                            metrics=metrics, engine=eng)
            assert np.array_equal(writer.array, golden(img, "gaussian:3"))
            assert pool.cleared == k + 1 and pool.held == 0
            assert metrics.snapshot()["resident_bytes"] == 0
    assert metrics.peak_resident_bytes >= 4 * 10 * 21  # the pool counted while it was held


# --------------------------------------------------------------------------
# io/stream_codec: windowed decode, incremental encode, JAX's bytes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 3])
def test_png_streaming_reader_matches_pil_and_jax(tmp_path, channels):
    img = synthetic_image(133, 47, channels=channels, seed=9)
    img[::3] //= 7  # smooth rows, so that PIL picks Sub/Up/Average/Paeth filters
    p = tmp_path / "a.png"
    Image.fromarray(img).save(p)
    with PNGTileReader(p) as r, jax_codec.PNGTileReader(p) as jr:
        assert (r.height, r.width, r.channels) == (133, 47, channels)
        bands = []
        while (b := r.read_rows(17)) is not None:
            assert np.array_equal(b, jr.read_rows(17))
            bands.append(b)
    assert np.array_equal(np.concatenate(bands, axis=0), img)
    with PNGTileReader(p) as r:
        r.skip_rows(40)
        assert np.array_equal(r.read_rows(13), img[40:53])


@pytest.mark.parametrize("band", [1, 13, 90])
@pytest.mark.parametrize("channels", [1, 3])
def test_png_writer_bytes_equal_jax(tmp_path, channels, band):
    img = synthetic_image(90, 31, channels=channels, seed=2)
    sink = io.BytesIO()
    w = PNGTileWriter(sink, 90, 31, channels)
    jp = tmp_path / "j.png"
    jw = jax_codec.PNGTileWriter(str(jp), 90, 31, channels)
    for r0 in range(0, 90, band):
        w.write_rows(img[r0 : r0 + band])
        jw.write_rows(img[r0 : r0 + band])
    w.close()
    jw.close()
    assert sink.getvalue() == jp.read_bytes()
    assert np.array_equal(np.array(Image.open(io.BytesIO(sink.getvalue()))), img)


@pytest.mark.parametrize("channels,ext", [(1, ".pgm"), (3, ".ppm"), (1, ".ppm")])
def test_pnm_writer_bytes_equal_jax(tmp_path, channels, ext):
    img = synthetic_image(50, 20, channels=channels, seed=1)
    got, want = tmp_path / f"p{ext}", tmp_path / f"j{ext}"
    for path, opener in [(got, open_tile_writer), (want, jax_codec.open_tile_writer)]:
        w = opener(path, 50, 20, channels)
        for r0 in range(0, 50, 7):
            w.write_rows(img[r0 : r0 + 7])
        w.close()
    assert got.read_bytes() == want.read_bytes()
    with PNMTileReader(got) as r:
        assert np.array_equal(r.read_rows(50), img)


def test_pnm_writer_resume_roundtrip(tmp_path):
    img = synthetic_image(50, 20, channels=3, seed=1)
    p = tmp_path / "x.ppm"
    w = PNMTileWriter(p, 50, 20, 3)
    w.write_rows(img[:30])
    w.close()
    with open(p, "ab") as f:
        f.write(b"\x01\x02")  # a partial row a kill left behind
    w2 = PNMTileWriter.resume(p, 50, 20, 3, rows_done=30)
    w2.write_rows(img[30:])
    w2.close()
    with PNMTileReader(p) as r:
        assert np.array_equal(r.read_rows(50), img)
    j = tmp_path / "j.ppm"
    jw = jax_codec.PNMTileWriter(j, 50, 20, 3)
    jw.write_rows(img)
    jw.close()
    assert p.read_bytes() == j.read_bytes()


def test_open_tile_writer_rejects_unstreamable_container(tmp_path):
    with pytest.raises(UnsupportedStreamFormat):
        open_tile_writer(tmp_path / "x.jpg", 10, 10, 3)


def test_open_tile_reader_fallback_logs_but_works(tmp_path):
    img = synthetic_image(20, 10, channels=3, seed=0)
    p = tmp_path / "x.bmp"
    Image.fromarray(img).save(p)
    r = open_tile_reader(p)  # whole-image fallback
    assert np.array_equal(r.read_rows(20), img)
    with pytest.raises(UnsupportedStreamFormat):
        open_tile_reader(p, allow_fallback=False)


def test_pnm_reader_header_comments_and_rejections(tmp_path):
    img = synthetic_image(6, 5, channels=1, seed=3)
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P5\n# a comment\n5 6\n255\n" + img.tobytes())
    with PNMTileReader(p) as r:
        assert (r.height, r.width, r.channels) == (6, 5, 1)
        r.skip_rows(2)
        assert np.array_equal(r.read_rows(4), img[2:])
    bad = tmp_path / "b.pgm"
    bad.write_bytes(b"P5\n5 6\n65535\n")
    with pytest.raises(UnsupportedStreamFormat, match="maxval"):
        PNMTileReader(bad)


# --------------------------------------------------------------------------
# temporal ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["framediff", "tdenoise:2", "tdenoise:3", "tdenoise:5",
                                  "framediff,tdenoise:4"])
def test_temporal_ops_equal_jax(spec):
    ours, _ = temporal.split_temporal(spec)
    theirs, _ = jax_temporal.split_temporal(spec)
    assert [(o.name, o.window) for o in ours] == [(o.name, o.window) for o in theirs]
    rng = np.random.default_rng(11)
    rings = [deque(maxlen=o.window) for o in ours]
    jrings = [deque(maxlen=o.window) for o in theirs]
    for _ in range(7):
        frame = rng.integers(0, 256, size=(9, 11, 3), dtype=np.uint8)
        x = jx = frame
        for op, jop, ring, jring in zip(ours, theirs, rings, jrings):
            ring.append(x)
            jring.append(jx)
            x, jx = op(ring), jop(jring)
        assert x.dtype == np.uint8 and np.array_equal(x, jx)


def test_temporal_ops_must_lead_the_chain():
    with pytest.raises(ValueError, match="precede"):
        temporal.split_temporal("grayscale,framediff")
    got = temporal.split_temporal("framediff,tdenoise:4,grayscale,emboss:3")
    assert [t.name for t in got[0]] == ["framediff", "tdenoise4"]
    assert got[1] == "grayscale,emboss:3"
    with pytest.raises(ValueError, match=">= 2"):
        temporal.make_tdenoise(1)


# --------------------------------------------------------------------------
# failpoints, journal, kill-mid-stream resume
# --------------------------------------------------------------------------


def test_stream_tile_failpoint_fails_stream_after_durable_prefix(tmp_path):
    img = synthetic_image(160, 24, channels=1, seed=4)
    journal = BatchJournal(tmp_path / "j.jsonl")
    writer = ArrayTileWriter(160, 24, 1)
    failpoints.configure("stream.tile=after:3")
    with pytest.raises(RuntimeError, match="--resume"):
        stream_pipeline(ArrayTileReader(img), writer, Pipeline.parse("gaussian:5").ops,
                        tile_rows=16, device="cpu", metrics=StreamMetrics(), journal=journal)
    assert failpoints.counts()["stream.tile"]["fired"] >= 1
    recs = journal.load()
    assert recs["stream#tile0"]["status"] == "ok"
    assert recs["stream#tile3"]["status"] == "failed"
    assert np.array_equal(writer.array[:48], golden(img, "gaussian:5")[:48])


def test_stream_stitch_failpoint_fires():
    img = synthetic_image(64, 16, channels=1, seed=4)
    failpoints.configure("stream.stitch=once")
    with pytest.raises(RuntimeError):
        run_streamed(img, "gaussian:5", tile_rows=16)
    assert failpoints.counts()["stream.stitch"]["fired"] == 1


def test_resume_distrusts_changed_config(tmp_path):
    journal = BatchJournal(tmp_path / "j.jsonl")
    fp_a = stream_fingerprint("gaussian5", 100, 20, 1, 16, "torch")
    for k in range(3):
        journal.record_ok(f"stream#tile{k}", fp_a, f"rows{k * 16}")
    assert resumable_tiles(journal, "stream", fp_a, 7) == 3
    fp_b = stream_fingerprint("gaussian5", 100, 20, 1, 32, "torch")
    assert resumable_tiles(journal, "stream", fp_b, 7) == 0
    journal.record_ok("stream#tile4", fp_a, "rows64")  # after a gap: not durable
    assert resumable_tiles(journal, "stream", fp_a, 7) == 3
    assert resumable_tiles(None, "stream", fp_a, 7) == 0


@pytest.mark.parametrize("kill_at", [1, 4, 6])
def test_cli_kill_mid_stream_then_resume_runs_only_missing_tiles(tmp_path, kill_at):
    img = synthetic_image(300, 64, channels=3, seed=4)
    src, out = tmp_path / "in.png", tmp_path / "out.pgm"
    Image.fromarray(img).save(src)
    base = ["stream", "--input", str(src), "--output", str(out), "--ops", "grayscale,gaussian:5",
            "--tile-rows", "32", "--device", "cpu"]
    assert cli.main([*base, "--failpoints", f"stream.tile=after:{kill_at}"]) == 1
    failpoints.clear()
    assert (tmp_path / "out.pgm.journal.jsonl").exists()
    m = tmp_path / "m.json"
    assert cli.main([*base, "--resume", "--json-metrics", str(m)]) == 0
    rec = json.loads(m.read_text())
    assert (rec["tiles_resumed"], rec["tiles_done"]) == (kill_at, rec["tiles"] - kill_at)
    want = golden(img, "grayscale,gaussian:5")
    assert np.array_equal(load_image(out, grayscale=True), want)
    j = tmp_path / "j.pgm"
    assert jax_cli.main(["stream", "--input", str(src), "--output", str(j), "--ops",
                         "grayscale,gaussian:5", "--tile-rows", "32", "--no-journal"]) == 0
    assert out.read_bytes() == j.read_bytes()


def test_cli_resume_refuses_a_png_output(tmp_path, capsys):
    assert cli.main(["stream", "--synthetic", "40x16x1", "--output", str(tmp_path / "o.png"),
                     "--device", "cpu", "--ops", "gaussian:3", "--resume"]) == 2
    assert "ppm/pgm" in capsys.readouterr().err


# --------------------------------------------------------------------------
# video: temporal ops, bounded rings, per-frame resume
# --------------------------------------------------------------------------


def _write_frames(tmp_path, n=6, h=40, w=24):
    frames = [synthetic_image(h, w, channels=3, seed=50 + i) for i in range(n)]
    paths = []
    for i, f in enumerate(frames):
        p = tmp_path / f"f{i:03d}.png"
        Image.fromarray(f).save(p)
        paths.append(str(p))
    return frames, paths


def _framediff(frames, i):
    prev = frames[i - 1] if i else frames[0]
    return np.abs(frames[i].astype(np.int16) - prev.astype(np.int16)).astype(np.uint8)


def test_video_framediff_equals_jax_and_ring_bounded(tmp_path):
    frames, paths = _write_frames(tmp_path)
    spec = "framediff,grayscale,gaussian:3"
    rec = stream_video(paths, tmp_path / "out", spec, tile_rows=16, device="cpu")
    assert rec["frames_done"] == len(frames)
    assert rec["ring_sizes"] == [2]  # bounded: window frames, not the video
    jax_stream_video(paths, tmp_path / "jout", spec, tile_rows=16)
    for i in range(len(frames)):
        got = tmp_path / "out" / f"f{i:03d}.png"
        assert np.array_equal(load_image(got, grayscale=True),
                              golden(_framediff(frames, i), "grayscale,gaussian:3")), i
        assert got.read_bytes() == (tmp_path / "jout" / f"f{i:03d}.png").read_bytes(), i


def test_video_tdenoise_bitexact(tmp_path):
    frames, paths = _write_frames(tmp_path)
    rec = stream_video(paths, tmp_path / "out", "tdenoise:3,invert", tile_rows=16, device="cpu",
                       out_ext=".ppm")
    assert rec["ring_sizes"] == [3]
    jax_stream_video(paths, tmp_path / "jout", "tdenoise:3,invert", tile_rows=16,
                     out_ext=".ppm")
    ring: deque = deque(maxlen=3)
    for i, f in enumerate(frames):
        ring.append(f)
        acc = np.zeros(f.shape, np.int32)
        for x in ring:
            acc += x
        tf = np.rint(acc / np.float64(len(ring))).astype(np.uint8)
        got = tmp_path / "out" / f"f{i:03d}.ppm"
        assert np.array_equal(load_image(got), golden(tf, "invert")), i
        assert got.read_bytes() == (tmp_path / "jout" / f"f{i:03d}.ppm").read_bytes(), i


def test_video_resume_skips_done_frames_but_rebuilds_history(tmp_path):
    frames, paths = _write_frames(tmp_path)
    out = tmp_path / "out"
    journal = BatchJournal(tmp_path / "vj.jsonl")
    failpoints.configure("stream.tile=after:6")  # dies inside frame 3
    with pytest.raises(RuntimeError):
        stream_video(paths, out, "framediff,gaussian:3", tile_rows=20, device="cpu",
                     journal=journal, resume=False)
    failpoints.clear()
    done_before = {k for k, r in journal.load().items() if r["status"] == "ok"}
    assert done_before
    rec = stream_video(paths, out, "framediff,gaussian:3", tile_rows=20, device="cpu",
                       journal=journal, resume=True)
    assert rec["frames_resumed"] == len(done_before)
    assert rec["frames_done"] == len(frames) - len(done_before)
    for i in range(len(frames)):
        got = load_image(out / f"f{i:03d}.png")
        assert np.array_equal(got, golden(_framediff(frames, i), "gaussian:3")), i


def test_video_pure_temporal_chain(tmp_path):
    frames, paths = _write_frames(tmp_path, n=3)
    rec = stream_video(paths, tmp_path / "out", "framediff", tile_rows=16, device="cpu")
    assert rec["temporal"] == ["framediff"]
    for i in range(3):
        assert np.array_equal(load_image(tmp_path / "out" / f"f{i:03d}.png"),
                              _framediff(frames, i))


def test_mismatched_frame_shape_fails_loudly(tmp_path):
    _frames, paths = _write_frames(tmp_path, n=2)
    odd = tmp_path / "f999.png"
    Image.fromarray(synthetic_image(10, 24, channels=3, seed=1)).save(odd)
    with pytest.raises(ValueError, match="must match"):
        stream_video([*paths, str(odd)], tmp_path / "o", "framediff", tile_rows=16,
                     device="cpu")


# --------------------------------------------------------------------------
# CLI: stream and batch --stream-rows against the JAX package's
# --------------------------------------------------------------------------


def test_cli_stream_png_equals_jax(tmp_path):
    from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition

    img = synthetic_image(200, 48, channels=3, seed=4)
    src, out, jout = tmp_path / "in.png", tmp_path / "out.png", tmp_path / "j.png"
    mj, mo, jm = tmp_path / "m.json", tmp_path / "m.prom", tmp_path / "jm.json"
    Image.fromarray(img).save(src)
    assert cli.main(["stream", "--input", str(src), "--output", str(out), "--ops", REFERENCE,
                     "--tile-rows", "48", "--device", "cpu", "--json-metrics", str(mj),
                     "--metrics-out", str(mo)]) == 0
    assert jax_cli.main(["stream", "--input", str(src), "--output", str(jout), "--ops",
                         REFERENCE, "--tile-rows", "48", "--json-metrics", str(jm)]) == 0
    assert out.read_bytes() == jout.read_bytes()
    assert np.array_equal(load_image(out, grayscale=True), golden(img, REFERENCE))
    rec, jrec = json.loads(mj.read_text()), json.loads(jm.read_text())
    assert set(rec) == set(jrec)
    assert rec["event"] == "stream" and rec["tiles"] == rec["tiles_done"] == jrec["tiles"]
    assert rec["peak_resident_bytes"] > 0
    fams = parse_exposition(mo.read_text())
    assert {"mcim_stream_peak_resident_bytes", "mcim_stream_tiles_total",
            "mcim_engine_device_idle_seconds_total"} <= set(fams)


def test_cli_stream_synthetic_source(tmp_path):
    out, jout = tmp_path / "s.png", tmp_path / "j.png"
    assert cli.main(["stream", "--synthetic", "300x32x1", "--output", str(out), "--ops",
                     "gaussian:5", "--tile-rows", "64", "--device", "cpu"]) == 0
    assert jax_cli.main(["stream", "--synthetic", "300x32x1", "--output", str(jout), "--ops",
                         "gaussian:5", "--tile-rows", "64"]) == 0
    assert out.read_bytes() == jout.read_bytes()
    img = synthetic_image(300, 32, channels=1, seed=0)
    assert np.array_equal(load_image(out, grayscale=True), golden(img, "gaussian:5"))


def test_cli_stream_video_mode(tmp_path):
    _frames, _paths = _write_frames(tmp_path, n=3)
    for main, out in [(cli.main, "vout"), (jax_cli.main, "jout")]:
        extra = ["--device", "cpu"] if main is cli.main else []
        assert main(["stream", "--video-frames", str(tmp_path / "f*.png"), "--output-dir",
                     str(tmp_path / out), "--ops", "framediff,grayscale", "--tile-rows", "32",
                     *extra]) == 0
    frames_out = sorted(f for f in os.listdir(tmp_path / "vout") if not f.startswith("."))
    assert frames_out == ["f000.png", "f001.png", "f002.png"]
    for name in frames_out:
        assert (tmp_path / "vout" / name).read_bytes() == (tmp_path / "jout" / name).read_bytes()
    assert cli.main(["stream", "--video-frames", str(tmp_path / "none*.png"), "--output-dir",
                     str(tmp_path / "x"), "--device", "cpu"]) == 3


def test_cli_batch_stream_rows_equals_jax(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    imgs = {}
    for name, seed in [("a.png", 1), ("b.png", 2), ("c.ppm", 3)]:
        imgs[name] = synthetic_image(120, 40, channels=3, seed=seed)
        Image.fromarray(imgs[name]).save(src / name)
    args = ["--input-dir", str(src), "--ops", REFERENCE, "--stream-rows", "32"]
    assert cli.main(["batch", *args, "--output-dir", str(tmp_path / "out"),
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["batch", *args, "--output-dir", str(tmp_path / "jout"),
                         "--impl", "xla"]) == 0
    for name, img in imgs.items():
        got = tmp_path / "out" / name
        g = golden(img, REFERENCE)
        # the batch contract replicates gray output to RGB
        assert np.array_equal(load_image(got), np.broadcast_to(g[..., None], (*g.shape, 3)))
        assert got.read_bytes() == (tmp_path / "jout" / name).read_bytes(), name


def test_cli_batch_stream_rows_resume_and_gray_output(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    for name, seed in [("a.ppm", 1), ("b.ppm", 2)]:
        Image.fromarray(synthetic_image(50, 20, channels=3, seed=seed)).save(src / name)
    args = ["batch", "--input-dir", str(src), "--output-dir", str(tmp_path / "out"), "--ops",
            REFERENCE, "--stream-rows", "16", "--device", "cpu", "--gray-output"]
    assert cli.main(args) == 0
    out = load_image(tmp_path / "out" / "a.ppm", grayscale=True)
    assert out.shape == (50, 20)  # --gray-output: no gray -> RGB
    m = tmp_path / "m.json"
    assert cli.main([*args, "--resume", "--json-metrics", str(m)]) == 0
    rec = json.loads(m.read_text())
    assert (rec["mode"], rec["processed"], rec["resumed"]) == ("stream", 0, 2)


def test_cli_batch_stream_rows_rejects_stack():
    rc = cli.main(["batch", "--input-dir", "/nonexistent", "--output-dir", "/tmp/x",
                   "--stream-rows", "32", "--stack", "4", "--device", "cpu"])
    assert rc in (2, 3)  # clean error, no traceback


def test_cli_batch_stream_rows_rejects_stack_and_kernel_impls_by_name(tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    Image.fromarray(synthetic_image(20, 20, channels=3, seed=1)).save(src / "a.png")
    base = ["batch", "--input-dir", str(src), "--output-dir", str(tmp_path / "o"),
            "--stream-rows", "8", "--device", "cpu"]
    for extra, words in [(["--stack", "2"], "--stack/--shards"),
                         (["--shards", "2"], "--stack/--shards"),
                         (["--impl", "cuda"], "stage walker"),
                         (["--impl", "swar"], "stage walker")]:
        assert cli.main([*base, *extra]) == 2
        assert words in capsys.readouterr().err
