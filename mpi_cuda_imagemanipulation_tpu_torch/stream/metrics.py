"""Stream instrumentation — tile counters, stage latencies, and the
resident-bytes accounting the constant-memory claim rests on. The
counterpart of the JAX package's ``stream/metrics.py``, on the port's
``obs.metrics.Registry`` with the same ``mcim_stream_*`` families.

`mcim_stream_resident_bytes` tracks the bytes of pixel data the stream
runner holds on the host right now: decoded bands, seam strips, each
in-flight tile's extension and its result block (the pinned D2H copy
counted from dispatch until its rows are written), and on a card the
pinned staging buffers of the stream's H2D pool (stream/runner.TileStager);
`mcim_stream_peak_resident_bytes` is its high-water mark. The property the
tests assert is that the peak is bounded by a function of (tile_rows,
inflight, io_threads, chain halo) alone (stream/runner.resident_bound),
flat in image height. Device-side residency is bounded by the same knobs
(inflight tiles of fixed shape).

Shares a Registry with the engine's `mcim_engine_*` families so one
`--metrics-out` snapshot carries both."""

from __future__ import annotations

import threading

from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry

STAGES = ("read", "stitch", "write")


class StreamMetrics:
    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        r = self.registry
        self._lock = threading.Lock()
        self._resident = 0
        self.tiles = r.counter(
            "mcim_stream_tiles_total",
            "Stream tiles by outcome (ok/failed/resumed).",
            labels=("outcome",),
        )
        self.rows = r.counter(
            "mcim_stream_rows_total", "Output rows emitted by the stream."
        )
        self.frames = r.counter(
            "mcim_stream_frames_total",
            "Video frames by outcome (ok/failed/resumed).",
            labels=("outcome",),
        )
        self.stage = r.histogram(
            "mcim_stream_stage_seconds",
            "Host-side stream stage latency (read/stitch/write).",
            labels=("stage",),
        )
        self.resident = r.gauge(
            "mcim_stream_resident_bytes",
            "Host-resident pixel bytes held by the stream runner now.",
        )
        self.resident_peak = r.gauge(
            "mcim_stream_peak_resident_bytes",
            "High-water host-resident pixel bytes — the constant-memory "
            "acceptance gauge (flat in image size).",
        )

    # -- residency accounting ----------------------------------------------

    def track(self, nbytes: int) -> None:
        with self._lock:
            self._resident += int(nbytes)
            self.resident.set(self._resident)
            self.resident_peak.set_max(self._resident)

    def untrack(self, nbytes: int) -> None:
        with self._lock:
            self._resident = max(0, self._resident - int(nbytes))
            self.resident.set(self._resident)

    @property
    def peak_resident_bytes(self) -> int:
        return int(self.resident_peak.value())

    def on_stage(
        self, stage: str, seconds: float, exemplar: str | None = None
    ) -> None:
        # exemplar: the stream's trace id joins a stage-latency spike in
        # the exposition to its tile span chain (obs/metrics.py)
        self.stage.observe(seconds, stage=stage, exemplar=exemplar)

    def snapshot(self) -> dict:
        return {
            "tiles_ok": int(self.tiles.value(outcome="ok")),
            "tiles_failed": int(self.tiles.value(outcome="failed")),
            "tiles_resumed": int(self.tiles.value(outcome="resumed")),
            "rows": int(self.rows.value()),
            "resident_bytes": int(self.resident.value()),
            "peak_resident_bytes": self.peak_resident_bytes,
        }
