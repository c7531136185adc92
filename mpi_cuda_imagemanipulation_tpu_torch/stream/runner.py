"""The constant-footprint streaming tile runner. The counterpart of the JAX
package's ``stream/runner.py``, on the port's engine (engine/core.py).

One pass over the image, problem size decoupled from memory footprint:

    reader thread       caller thread                engine completion   encode pool
    -------------       -------------                -----------------   -----------
    read band k+2 --+
    (bounded queue, +-- stitch seam strips -> ext_k
     2 bands ahead)-+   submit: pinned H2D + walk  --> wait for the D2H --> ordered
                          ^ blocks at `inflight`       in submission       write_rows
                          | outstanding (backpressure) order               -> journal ok

Reads are single-pass: every row is decoded once. Tile k's extension is
assembled from the seam strips of its neighbours: the previous band's
trailing strip is carried forward on the host (parallel/halo.host_edge_strips)
and the next band, already read ahead, gives its head, so an interior seam
costs one `chain_halo` strip copy instead of a re-read. The reader thread
touches numpy only; every torch call runs on the caller's thread (staging,
the tile walk) or the engine's (the D2H wait). With `inflight >= 2` the H2D
copy of tile k+1 (TileStager: a pinned buffer, a copy stream) overlaps tile
k's compute and tile k-1's encode.

Failure model: a tile that fails at dispatch, force or encode fails the
stream (one output file), but every completed tile was already written and
journaled, so `--resume` restarts at the first missing tile; the journal
trusts a tile record only when its config fingerprint matches
(ops/shape/tile_rows/impl). The `stream.tile` and `stream.stitch`
failpoints inject exactly these faults.

The host bytes the runner holds are tracked in `StreamMetrics`
(stream/metrics.py): bands, seam strips, each in-flight tile's extension
and result block, and the stager's pinned buffers. `resident_bound` gives
the most they can add up to, from the tile geometry and the engine's knobs
alone, whatever the image height.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics, device_stager
from mpi_cuda_imagemanipulation_tpu_torch.io.stream_codec import TileReader, TileWriter
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.parallel.halo import host_edge_strips, stitch_tile
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.stream.metrics import StreamMetrics
from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import (
    TileFnCache,
    out_channels,
    plan_tiles,
    validate_stream_ops,
)
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

DEFAULT_TILE_ROWS = 512
# bands read ahead of the caller (the decode double buffer)
BAND_QUEUE = 2


def stream_fingerprint(
    ops_name: str, height: int, width: int, channels: int, tile_rows: int, impl: str,
) -> str:
    """The journal 'digest' for stream tiles: a resumed run must be the
    same decomposition of the same computation, or every prior tile is
    distrusted (cmd_batch's edited-input rule, applied to config)."""
    import hashlib

    key = f"{ops_name}|{height}x{width}x{channels}|T{tile_rows}|{impl}"
    return hashlib.sha256(key.encode()).hexdigest()


class TileStager:
    """The engine's ``stage`` for stream tiles: ``(ext band, y0)`` ->
    ``(tensor on device, y0)``. On a card the band goes through a pinned
    pool of its own (engine/core.device_stager: ``inflight + 1`` buffers a
    band shape, a copy stream); the pool's bytes count in `metrics`'
    resident bytes, and `release` (which `stream_pipeline` calls when its
    stream ends) drops them, so that a run over inputs of many shapes does
    not keep buffers for every shape: they go back to PyTorch's caching
    host allocator, which hands its blocks out again by size. On the CPU a
    copy."""

    def __init__(self, device, *, inflight: int, metrics: StreamMetrics):
        self._stage = device_stager(device, inflight=inflight)
        self._metrics = metrics
        self._tracked = 0

    def __call__(self, item):
        ext, y0 = item
        staged = self._stage(ext)
        pool = self._stage.pool
        if pool is not None:
            held = pool.nbytes()
            if held != self._tracked:
                self._metrics.track(held - self._tracked)
                self._tracked = held
        return staged, y0

    def release(self) -> None:
        if self._stage.pool is not None:
            self._stage.pool.clear()
        self._metrics.untrack(self._tracked)
        self._tracked = 0


def resident_bound(
    *, width: int, channels: int, out_chan: int, tile_rows: int, halo: int, inflight: int,
    encode_backlog: int, pinned: bool,
) -> int:
    """The most host bytes `stream_pipeline` tracks at once, from what it
    tracks (module docstring), for an image of any height:

      * bands of at most ``tile_rows + halo - 1`` rows (plan_tiles merges a
        last band shorter than the halo into its predecessor): the caller
        holds the current and the next, BAND_QUEUE wait in the queue, and
        the reader thread holds one it could not yet queue;
      * two seam strips of `halo` rows (the one in use and the next one);
      * tiles from stitch until their rows are written, each its extension
        (a band and two strips) and its result block: one the caller is
        submitting, `inflight` dispatched, one the engine's completion
        thread holds while it waits for an encode slot, and
        `encode_backlog` (``Engine.encode_backlog``) queued or encoding;
      * with `pinned` (a card), the stager's pool: ``inflight + 1``
        buffers for each of at most four extension shapes (first, middle,
        last band, and the short last one)."""
    row = width * channels
    band = tile_rows + max(halo - 1, 0)
    ext = (band + 2 * halo) * row
    tiles = 1 + inflight + 1 + encode_backlog
    total = (2 + BAND_QUEUE + 1) * band * row + 2 * halo * row
    total += tiles * (ext + band * width * out_chan)
    if pinned:
        total += 4 * (inflight + 1) * ext
    return total


@dataclass
class StreamResult:
    tiles: int
    tiles_done: int
    tiles_resumed: int
    rows: int
    wall_s: float
    peak_resident_bytes: int
    engine: dict
    compiles: int  # tile functions built (the JAX package's compiles)

    def as_dict(self) -> dict:
        return {
            "tiles": self.tiles,
            "tiles_done": self.tiles_done,
            "tiles_resumed": self.tiles_resumed,
            "rows": self.rows,
            "wall_s": self.wall_s,
            "peak_resident_bytes": self.peak_resident_bytes,
            "compiles": self.compiles,
            "engine": self.engine,
        }


def stream_pipeline(
    reader: TileReader,
    writer: TileWriter,
    ops,
    *,
    tile_rows: int = DEFAULT_TILE_ROWS,
    inflight: int = 2,
    io_threads: int = 2,
    impl: str = "torch",
    plan: str = "auto",
    device=None,
    metrics: StreamMetrics | None = None,
    engine: Engine | None = None,
    journal=None,
    journal_key: str = "stream",
    resume_tiles: int = 0,
    trace_parent=None,
    fn_cache: TileFnCache | None = None,
) -> StreamResult:
    """Run `ops` over `reader`'s rows into `writer` on `device` (default
    CUDA; raises without it), holding O(tile_rows) pixels on the host
    whatever the image height. Byte-identical to the whole-image golden
    path for every streamable chain (stream/tiles.py).

    `engine=None` creates a private ordered engine (staged by a
    `TileStager`) and closes it; a shared one (video mode, `batch
    --stream-rows`; its stage a `TileStager`) is flushed instead, so
    consecutive streams ride one steady state, and its stager released.
    `fn_cache` likewise shares the tile functions across same-shape runs.
    `resume_tiles` skips that many leading tiles: the caller has verified
    (journal and output state) that they are already durable."""
    log = get_logger()
    dev = resolve_device(device)
    metrics = metrics or StreamMetrics()
    halo = validate_stream_ops(tuple(ops))
    H, W = reader.height, reader.width
    tiles = plan_tiles(H, tile_rows, halo)
    fingerprint = stream_fingerprint(
        ",".join(op.name for op in ops), H, W, reader.channels, tile_rows, impl,
    )
    if fn_cache is not None and (
        fn_cache.global_h != H or fn_cache.global_w != W or fn_cache.impl != impl
    ):
        raise ValueError(
            f"shared fn_cache was built for {fn_cache.global_h}x{fn_cache.global_w}/"
            f"{fn_cache.impl}, stream is {H}x{W}/{impl}"
        )
    # the plan changes in-tile structure, never tile geometry, and output is
    # byte-identical across modes, so the resume fingerprint excludes it
    cache = fn_cache or TileFnCache(tuple(ops), global_h=H, global_w=W, impl=impl, plan=plan,
                                    device=dev)
    out_bytes = W * out_channels(tuple(ops), reader.channels)  # per output row

    own_engine = engine is None
    if own_engine:
        engine = Engine(
            inflight=inflight,
            io_threads=io_threads,
            stage=TileStager(dev, inflight=inflight, metrics=metrics),
            metrics=EngineMetrics(registry=metrics.registry),
            ordered_done=True,
            name="stream",
        )

    root_ctx = trace_parent if trace_parent is not None else obs_trace.current_context()

    errors: list[tuple[int, BaseException]] = []
    done = {"n": 0}
    # host bytes of each in-flight tile (its extension and its result
    # block), tracked from stitch until the tile resolves
    held: dict[int, int] = {}
    held_lock = threading.Lock()

    def drop(key) -> None:
        with held_lock:
            n = held.pop(key, 0)
        metrics.untrack(n)

    def on_done(key, host, info):
        spec = tiles[key]
        t0 = time.perf_counter()
        try:
            with obs_trace.span("stream.write", tile=key):
                writer.write_rows(np.asarray(host))
        finally:
            drop(key)
            metrics.on_stage(
                "write", time.perf_counter() - t0,
                exemplar=obs_trace.current_trace_id() or None,
            )
        if journal is not None:
            # flush first: the ok record claims these rows survive a kill
            writer.flush()
            journal.record_ok(f"{journal_key}#tile{key}", fingerprint, f"rows{spec.out_lo}")
        metrics.tiles.inc(outcome="ok")
        metrics.rows.inc(spec.out_rows)
        done["n"] += 1

    def on_error(key, exc):
        drop(key)
        metrics.tiles.inc(outcome="failed")
        errors.append((key, exc))
        if journal is not None:
            journal.record_failed(f"{journal_key}#tile{key}", fingerprint,
                                  f"{type(exc).__name__}: {exc}")
        log.error("stream tile %s failed: %s", key, exc)

    # -- resume fast-forward ------------------------------------------------
    resume_tiles = min(resume_tiles, len(tiles))
    prev_tail: np.ndarray | None = None
    start = resume_tiles
    if resume_tiles:
        skipped_rows = tiles[resume_tiles - 1].out_hi
        if start < len(tiles) and tiles[start].lead:
            reader.skip_rows(skipped_rows - halo)
            prev_tail = reader.read_rows(halo)
        else:
            reader.skip_rows(skipped_rows)
        metrics.tiles.inc(resume_tiles, outcome="resumed")
        metrics.rows.inc(skipped_rows)
        log.info("stream resume: %d/%d tiles (%d rows) already durable",
                 resume_tiles, len(tiles), skipped_rows)

    # -- decode prefetch thread --------------------------------------------
    # bands are read ahead of the submit loop on their own thread through a
    # bounded queue, so read latency overlaps tile compute; a full queue
    # stalls the reader, a full engine stalls the submitter, and both bounds
    # are constants
    band_q: queue.Queue = queue.Queue(maxsize=BAND_QUEUE)
    stop_reading = threading.Event()

    def _produce():
        try:
            for j in range(start, len(tiles)):
                t0 = time.perf_counter()
                with obs_trace.span("stream.prefetch", parent=root_ctx, tile=j):
                    b = reader.read_rows(tiles[j].out_rows)
                metrics.on_stage("read", time.perf_counter() - t0)
                metrics.track(b.nbytes)
                while not stop_reading.is_set():
                    try:
                        band_q.put((j, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop_reading.is_set():
                    metrics.untrack(b.nbytes)
                    return
            band_q.put((None, None))
        except BaseException as e:  # noqa: BLE001 - surfaced to the submit loop
            band_q.put((None, e))

    producer = threading.Thread(target=_produce, name="mcim-stream-read", daemon=True)

    def _next_band() -> np.ndarray | None:
        j, b = band_q.get()
        if j is None:
            if isinstance(b, BaseException):
                raise b
            return None
        return b

    t_start = time.perf_counter()
    band: np.ndarray | None = None
    try:
        producer.start()
        if start < len(tiles):
            band = _next_band()
        if prev_tail is not None:
            metrics.track(prev_tail.nbytes)

        for i in range(start, len(tiles)):
            if errors:
                break  # a failed tile fails the stream; stop feeding it
            spec = tiles[i]
            nxt = _next_band() if i + 1 < len(tiles) else None

            t0 = time.perf_counter()
            with obs_trace.span("stream.stitch", parent=root_ctx, tile=i):
                failpoints.maybe_fail("stream.stitch", tile=i)
                head = nxt[: spec.tail] if spec.tail else None
                ext = stitch_tile(prev_tail if spec.lead else None, band, head)
            metrics.on_stage("stitch", time.perf_counter() - t0)
            n_held = ext.nbytes + spec.out_rows * out_bytes
            with held_lock:
                held[i] = n_held
            metrics.track(n_held)

            # carry the seam strip for tile i+1 before the band is dropped
            new_tail = None
            if i + 1 < len(tiles) and tiles[i + 1].lead:
                new_tail = host_edge_strips(band, halo)[1]
                metrics.track(new_tail.nbytes)
            metrics.untrack(band.nbytes)
            if prev_tail is not None:
                metrics.untrack(prev_tail.nbytes)
            prev_tail, band = new_tail, nxt

            fn = cache.fn(spec)
            with obs_trace.span("stream.tile", parent=root_ctx, tile=i,
                                rows=spec.out_rows) as tspan:
                try:
                    failpoints.maybe_fail("stream.tile", tile=i)
                    engine.submit(
                        i,
                        lambda e=ext, y=spec.ext_lo: (e, y),
                        lambda x, f=fn: f(*x),
                        on_done=on_done,
                        on_error=on_error,
                    )
                except Exception as e:  # noqa: BLE001 - fails the stream, reported below
                    tspan.set(error=type(e).__name__)
                    on_error(i, e)
                    break
    finally:
        stop_reading.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                band_q.get_nowait()
            except queue.Empty:
                break
        if producer.is_alive():
            producer.join(timeout=10.0)
        if own_engine:
            engine.close()
        else:
            engine.flush()
        release = getattr(engine.stage, "release", None)
        if release is not None:
            release()
        reader.close()
    wall = time.perf_counter() - t_start

    if errors:
        k, exc = errors[0]
        raise RuntimeError(
            f"stream failed at tile {k} ({done['n'] + resume_tiles}/{len(tiles)} tiles durable; "
            f"re-run with --resume): {exc}"
        ) from exc

    return StreamResult(
        tiles=len(tiles),
        tiles_done=done["n"],
        tiles_resumed=resume_tiles,
        rows=H,
        wall_s=wall,
        peak_resident_bytes=metrics.peak_resident_bytes,
        engine=engine.metrics.snapshot(),
        compiles=cache.variants,
    )


def resumable_tiles(journal, journal_key: str, fingerprint: str, n_tiles: int) -> int:
    """The longest prefix of tiles journaled ok under `fingerprint`: a
    stream output is sequential, so only a contiguous prefix is durable (a
    lone ok tile after a gap is unreachable and re-run)."""
    if journal is None:
        return 0
    records = journal.load()
    k = 0
    while k < n_tiles:
        rec = records.get(f"{journal_key}#tile{k}")
        if not (rec and rec.get("status") == "ok" and rec.get("digest") == fingerprint):
            break
        k += 1
    return k
