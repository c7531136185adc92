"""Video mode: frame sequences through the same engine steady state. The
counterpart of the offline half of the JAX package's ``stream/video.py``
(its live sessions serve frames behind the fabric front door and come with
the fabric).

A video is a stream of same-shape frames; the per-frame steady state
(decode -> temporal combine -> tiled spatial chain -> incremental encode)
is the overlap workload the engine was built for, so the frame loop keeps
one ordered engine alive across frames and only the per-frame writers
rotate.

Temporal ops (ops/temporal.py) lead the chain and read from bounded
frame-history rings, one ring per temporal op, each capped at that op's
window, so an hour of video holds `sum(window)` frames, never the stream.
Spatial ops then run through the tile runner per frame (frames taller than
the tile budget stream in bands like any image).

Resume reuses the batch journal discipline: one record per frame, trusted
only when the input digest matches, written only after the frame's output
is durable. Skipped frames are still decoded on resume (the temporal rings
need their pixels) but pay no compute or encode; the log says so.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np

from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image
from mpi_cuda_imagemanipulation_tpu_torch.io.stream_codec import (
    ArrayTileReader,
    open_tile_writer,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.ops.temporal import TemporalOp, split_temporal
from mpi_cuda_imagemanipulation_tpu_torch.resilience.journal import content_digest
from mpi_cuda_imagemanipulation_tpu_torch.stream.metrics import StreamMetrics
from mpi_cuda_imagemanipulation_tpu_torch.stream.runner import (
    DEFAULT_TILE_ROWS,
    TileStager,
    stream_pipeline,
)
from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import TileFnCache, out_channels
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger


def parse_video_ops(spec: str):
    """(temporal_ops, spatial_ops) from one pipeline string. The spatial
    part goes through Pipeline.parse — same registry, same validation —
    and may be empty (a pure temporal pipeline like `framediff`)."""
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    temporal, rest = split_temporal(spec)
    spatial = Pipeline.parse(rest).ops if rest else ()
    return temporal, spatial


class FrameRings:
    """One bounded history ring per temporal op, chained: op k's ring
    holds op k-1's outputs. `push` advances all rings for one frame and
    returns the final temporal output. Memory = sum of windows, ever."""

    def __init__(self, temporal: tuple[TemporalOp, ...],
                 metrics: StreamMetrics | None = None):
        self.temporal = temporal
        self._rings: list[deque] = [
            deque(maxlen=op.window) for op in temporal
        ]
        self._metrics = metrics

    def push(self, frame: np.ndarray) -> np.ndarray:
        x = frame
        for op, ring in zip(self.temporal, self._rings):
            if self._metrics is not None:
                if len(ring) == ring.maxlen:
                    self._metrics.untrack(ring[0].nbytes)
                self._metrics.track(x.nbytes)
            ring.append(x)
            x = op(ring)
        return x

    def sizes(self) -> list[int]:
        return [len(r) for r in self._rings]


def stream_video(
    frame_paths,
    output_dir: str | os.PathLike,
    ops_spec: str,
    *,
    tile_rows: int = DEFAULT_TILE_ROWS,
    inflight: int = 2,
    io_threads: int = 2,
    impl: str = "torch",
    plan: str = "auto",
    device=None,
    out_ext: str = ".png",
    metrics: StreamMetrics | None = None,
    journal=None,
    resume: bool = False,
) -> dict:
    """Process an ordered frame sequence on `device` (default CUDA; raises
    without it); returns the summary record.

    Output frames land in `output_dir` under each input's basename with
    `out_ext`. Frames must share one shape (the tile functions and the
    temporal rings both require it): a mismatched frame fails the run with
    the offending path named."""
    log = get_logger()
    dev = resolve_device(device)
    metrics = metrics or StreamMetrics()
    temporal, spatial = parse_video_ops(ops_spec)
    frame_paths = [str(p) for p in frame_paths]
    if not frame_paths:
        raise ValueError("no video frames to process")
    os.makedirs(output_dir, exist_ok=True)

    prior = journal.load() if (journal is not None and resume) else {}
    rings = FrameRings(temporal, metrics)
    engine = Engine(
        inflight=inflight,
        io_threads=io_threads,
        stage=TileStager(dev, inflight=inflight, metrics=metrics),
        metrics=EngineMetrics(registry=metrics.registry),
        ordered_done=True,
        name="stream-video",
    )
    shape = None
    fn_cache = None  # shared across frames: one set of tile functions
    frames_done = 0
    frames_resumed = 0
    t0 = time.perf_counter()
    root = obs_trace.start_trace("stream.video", frames=len(frame_paths), ops=ops_spec)
    try:
        with root:
            for path in frame_paths:
                rel = os.path.basename(path)
                digest = content_digest(path)
                frame = np.asarray(load_image(path))
                if shape is None:
                    shape = frame.shape
                elif frame.shape != shape:
                    raise ValueError(
                        f"frame {path} has shape {frame.shape}; the stream is {shape} "
                        "(video frames must match)"
                    )
                # temporal rings always advance: a resumed frame's pixels
                # still feed its successors' history
                tframe = rings.push(frame)
                rec = prior.get(rel)
                if rec and rec.get("status") == "ok" and rec.get("digest") == digest:
                    frames_resumed += 1
                    metrics.frames.inc(outcome="resumed")
                    continue
                out_name = os.path.splitext(rel)[0] + out_ext
                out_path = os.path.join(output_dir, out_name)
                c = tframe.shape[2] if tframe.ndim == 3 else 1
                writer = open_tile_writer(out_path, tframe.shape[0], tframe.shape[1],
                                          out_channels(spatial, c))
                if fn_cache is None:
                    fn_cache = TileFnCache(tuple(spatial), global_h=tframe.shape[0],
                                           global_w=tframe.shape[1], impl=impl, plan=plan,
                                           device=dev)
                try:
                    stream_pipeline(
                        ArrayTileReader(tframe),
                        writer,
                        spatial,
                        tile_rows=min(tile_rows, tframe.shape[0]),
                        impl=impl,
                        device=dev,
                        metrics=metrics,
                        engine=engine,  # shared: one steady state
                        trace_parent=root.context(),
                        fn_cache=fn_cache,
                    )
                    writer.close()
                except Exception:
                    metrics.frames.inc(outcome="failed")
                    if journal is not None:
                        journal.record_failed(rel, digest, "frame failed")
                    raise
                if journal is not None:
                    journal.record_ok(rel, digest, out_name)
                metrics.frames.inc(outcome="ok")
                frames_done += 1
    finally:
        engine.close()
    wall = time.perf_counter() - t0
    if frames_resumed:
        log.info("video resume: %d frames re-decoded for temporal history, 0 recomputed",
                 frames_resumed)
    return {
        "frames": len(frame_paths),
        "frames_done": frames_done,
        "frames_resumed": frames_resumed,
        "temporal": [op.name for op in temporal],
        "ring_sizes": rings.sizes(),
        "wall_s": wall,
        "fps": frames_done / wall if wall > 0 else None,
        "peak_resident_bytes": metrics.peak_resident_bytes,
        "engine": engine.metrics.snapshot(),
    }
