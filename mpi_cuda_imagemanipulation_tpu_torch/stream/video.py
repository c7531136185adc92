"""Video mode: frame sequences through the same engine steady state. The
counterpart of the JAX package's ``stream/video.py``, offline and live.

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

Live sessions (`VideoSessionHost` + `stream_video_session`): the same
temporal rings, held as per-session replica state behind the fabric
router (fabric/session.py routes). The router owns stickiness and the
replayable journal tail; this module owns the ring arithmetic on the
replica and the ordered-stream client. The replay protocol is strict on
sequence numbers: a frame that is not exactly `last_seq + 1` is either an
idempotent duplicate (skipped) or a protocol gap (rejected), never
silently pushed, because a ring with a missing frame produces
plausible-but-wrong pixels forever after.
"""

from __future__ import annotations

import os
import threading
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


# --------------------------------------------------------------------------
# live sessions: per-session rings on a replica + the front-door client
# --------------------------------------------------------------------------


class SessionGapError(ValueError):
    """A live frame broke sequence contiguity: the rings cannot absorb it
    without lying. The HTTP layer maps this to 409 so the router rebinds
    with a proper journal-tail replay instead of serving corrupt temporal
    state."""


class _LiveSession:
    """One session's replica-side state: the temporal rings plus the
    sequence cursor the replay protocol is checked against."""

    def __init__(self, ops_spec: str):
        temporal, rest = split_temporal(ops_spec)
        self.ops_spec = ops_spec
        self.temporal = temporal
        self.rest = rest
        self.rings = FrameRings(temporal)
        self.last_seq = -1
        self.frames = 0
        self.lock = threading.Lock()
        self.last_active = time.monotonic()


class VideoSessionHost:
    """The replica side of live video sessions (fabric/session.py).

    Holds the temporal frame rings per session id and the spatial function
    per ops spec on `device` (default CUDA; raises without it), shared
    across sessions: two streams with one pipeline build one function. The
    spatial ops run the golden torch ops (``Pipeline.jit(backend='torch')``,
    the JAX package's default 'xla'); the temporal combine is host numpy
    (ops/temporal.py), byte-identical to the JAX package's.
    `process_frame` is the whole protocol: reset rebuilds from scratch
    (failover replay), a replayed frame pushes rings but skips compute and
    encode (the router discards the output anyway), duplicates are
    idempotent no-ops, and gaps raise `SessionGapError`: the byte-exactness
    of a resumed stream rests on this strictness."""

    def __init__(self, *, registry=None, max_sessions: int = 256, device=None):
        self.device = resolve_device(device)
        self.max_sessions = max_sessions
        self._lock = threading.Lock()
        self._sessions: dict[str, _LiveSession] = {}
        self._spatial: dict[str, object] = {}  # rest spec -> function
        self.evicted = 0
        if registry is not None:
            self._m_frames = registry.counter(
                "mcim_stream_session_frames_total",
                "Live-session frames on this replica by outcome "
                "(live/replay/skipped).",
                labels=("outcome",),
            )
            registry.gauge(
                "mcim_stream_sessions_live",
                "Live video sessions holding rings on this replica.",
                fn=lambda: float(len(self._sessions)),
            )
        else:
            self._m_frames = None

    def _count(self, outcome: str) -> None:
        if self._m_frames is not None:
            self._m_frames.inc(outcome=outcome)

    def _get(self, sid: str, ops_spec: str, *, reset: bool) -> _LiveSession:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None and not reset and sess.ops_spec == ops_spec:
                return sess
            if len(self._sessions) >= self.max_sessions and sid not in self._sessions:
                victim = min(self._sessions.items(), key=lambda kv: kv[1].last_active)[0]
                del self._sessions[victim]
                self.evicted += 1
            sess = self._sessions[sid] = _LiveSession(ops_spec)
            return sess

    def _spatial_fn(self, sess: _LiveSession):
        if not sess.rest:
            return None
        with self._lock:
            fn = self._spatial.get(sess.rest)
            if fn is None:
                from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

                fn = self._spatial[sess.rest] = Pipeline.parse(sess.rest).jit(
                    backend="torch", device=self.device)
        return fn

    def process_frame(
        self,
        sid: str,
        ops_spec: str,
        seq: int,
        frame: np.ndarray,
        *,
        replay: bool = False,
        reset: bool = False,
    ) -> np.ndarray | None:
        """Advance one session by one frame; returns the processed frame
        for live traffic, None for replayed or duplicate frames."""
        sess = self._get(sid, ops_spec, reset=reset)
        with sess.lock:
            sess.last_active = time.monotonic()
            if reset:
                # failover replay starts here: whatever rings an earlier
                # binding left behind are history that no longer matches
                # the router's journal tail
                sess.rings = FrameRings(sess.temporal)
                sess.last_seq = seq - 1
            if seq <= sess.last_seq:
                self._count("skipped")
                return None  # idempotent duplicate (replay overlap)
            if seq != sess.last_seq + 1:
                raise SessionGapError(
                    f"session {sid}: frame {seq} after {sess.last_seq}: "
                    "rings need a contiguous replay, not a gap"
                )
            out = sess.rings.push(np.asarray(frame))
            sess.last_seq = seq
            sess.frames += 1
            if replay:
                self._count("replay")
                return None
            fn = self._spatial_fn(sess)
            self._count("live")
            return fn(out).cpu().numpy() if fn is not None else out

    def stats(self) -> dict:
        with self._lock:
            return {
                "sessions": len(self._sessions),
                "evicted": self.evicted,
                "by_id": {
                    sid: {
                        "ops": s.ops_spec,
                        "last_seq": s.last_seq,
                        "frames": s.frames,
                        "ring_sizes": s.rings.sizes(),
                    }
                    for sid, s in self._sessions.items()
                },
            }


def post_session_frame(
    url: str,
    session_id: str,
    ops_spec: str,
    seq: int,
    blob,
    *,
    timeout_s: float = 60.0,
) -> dict:
    """One live frame to a fabric front door; returns {code, body,
    replica, seq}. Transport errors surface as code 599 (the caller's
    retry policy decides, the contract of loadgen.http_post_image)."""
    import urllib.error
    import urllib.request

    from mpi_cuda_imagemanipulation_tpu_torch.fabric import session as fsession

    req = urllib.request.Request(
        f"{url.rstrip('/')}{fsession.SESSION_PATH_PREFIX}{session_id}/frame",
        data=blob,
        headers={
            "Content-Type": "application/octet-stream",
            fsession.HDR_OPS: ops_spec,
            fsession.HDR_SEQ: str(seq),
        },
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return {
                "code": resp.status,
                "body": resp.read(),
                "replica": resp.headers.get("X-Fabric-Replica", ""),
                "seq": seq,
            }
    except urllib.error.HTTPError as e:
        return {
            "code": e.code,
            "body": e.read(),
            "replica": e.headers.get("X-Fabric-Replica", ""),
            "seq": seq,
        }
    except Exception:
        return {"code": 599, "body": b"", "replica": "", "seq": seq}


def stream_video_session(
    frames,
    url: str,
    ops_spec: str,
    *,
    session_id: str,
    start_seq: int = 0,
    timeout_s: float = 60.0,
    retries: int = 3,
    retry_delay_s: float = 0.5,
    on_frame=None,
) -> dict:
    """Drive an ordered frame sequence through a fabric front door as ONE
    live session. `frames` are uint8 arrays (or paths, loaded in order);
    each is PNG-encoded and posted with its sequence number. A shed or
    transport answer retries the SAME seq after a short delay (an ordered
    stream must not skip), so a mid-stream replica death costs latency,
    never frames. Returns the summary with decoded outputs."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
        decode_image_bytes,
        encode_image_bytes,
    )

    outputs = []
    replicas = []
    retried = 0
    for seq, frame in enumerate(frames, start=start_seq):
        if isinstance(frame, (str, os.PathLike)):
            frame = np.asarray(load_image(frame))
        blob = encode_image_bytes(np.asarray(frame))
        r = None
        for attempt in range(retries + 1):
            r = post_session_frame(url, session_id, ops_spec, seq, blob, timeout_s=timeout_s)
            if r["code"] == 200:
                break
            retried += 1
            time.sleep(retry_delay_s * (attempt + 1))
        if r is None or r["code"] != 200:
            raise RuntimeError(
                f"session {session_id}: frame {seq} failed with "
                f"{r['code'] if r else 'n/a'} after {retries + 1} attempts"
            )
        out = decode_image_bytes(r["body"])
        outputs.append(out)
        replicas.append(r["replica"])
        if on_frame is not None:
            on_frame(seq, out, r)
    return {
        "session_id": session_id,
        "frames": len(outputs),
        "outputs": outputs,
        "replicas": replicas,
        "retried": retried,
    }
