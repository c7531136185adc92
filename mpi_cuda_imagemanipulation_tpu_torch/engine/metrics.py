"""Engine instrumentation: per-stage latencies, in-flight depth, device
idle. The counterpart of the JAX package's ``engine/metrics.py``, copied
onto the port's ``obs.metrics.Registry``.

The numbers that tell whether the overlap is real:

  * ``device_idle_frac``: the fraction of the engine's active window
    (first dispatch to last completion) the device spent with NOTHING
    enqueued. Measured on the completion thread: any wait for a new item
    that starts with zero unforced dispatches outstanding is, by
    definition, device idle. The serial loop's idle fraction is about
    (decode + encode) / total; a working pipelined engine drives it
    toward 0, as long as the device work is not the smaller part.
  * ``inflight`` depth: outstanding (dispatched, not yet forced) items,
    sampled at every submit; the peak shows the pipeline kept
    ``--inflight`` items in the air rather than running serially.
  * stage latencies: host input build (``build``), H2D staging (``h2d``),
    enqueue (``enqueue``), the completion wait for the D2H copy
    (``force``), the encode and write worker (``encode``), as
    percentiles over the histogram's recent samples.

Storage is an ``obs.metrics.Registry`` (``mcim_engine_*`` families, the
stage a label of one histogram): ``batch --metrics-out`` renders it, and
``snapshot()`` is a view over the same objects.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry

PERCENTILES = (50, 95, 99)

STAGES = ("build", "h2d", "enqueue", "force", "encode")


class EngineMetrics:
    def __init__(self, registry: Registry | None = None,
                 sample_cap: int = 65536):
        self.registry = registry or Registry()
        r = self.registry
        self._lock = threading.Lock()
        # start of the completion thread's current idle wait (None when it
        # is not waiting idle): `idle_parts()` reads it, so that two reads
        # bracket exactly the idle time between them
        self._idle_from: float | None = None
        self._submitted = r.counter(
            "mcim_engine_submitted_total", "Batches submitted to the engine."
        )
        self._completed = r.counter(
            "mcim_engine_completed_total", "Batches whose on_done finished."
        )
        self._failed = r.counter(
            "mcim_engine_failed_total", "Batches routed to on_error."
        )
        self._inflight = r.gauge(
            "mcim_engine_inflight",
            "Dispatched-but-not-yet-forced batches (gauge).",
        )
        self._inflight_peak = r.gauge(
            "mcim_engine_inflight_peak", "High-water in-flight depth."
        )
        self._idle = r.counter(
            "mcim_engine_device_idle_seconds_total",
            "Device-idle seconds inside the engine's active window.",
        )
        self._stage = r.histogram(
            "mcim_engine_stage_seconds",
            "Per-stage engine latency (build/h2d/enqueue/force/encode).",
            labels=("stage",),
            sample_cap=sample_cap,
        )
        self.t_first_dispatch: float | None = None
        self.t_last_complete: float | None = None
        self._depth: deque = deque(maxlen=sample_cap)

    # -- registry-backed readers -------------------------------------------

    @property
    def submitted(self) -> int:
        return int(self._submitted.value())

    @property
    def inflight(self) -> int:
        return int(self._inflight.value())

    @property
    def inflight_peak(self) -> int:
        return int(self._inflight_peak.value())

    @property
    def idle_s(self) -> float:
        return self._idle.value()

    # -- recording ---------------------------------------------------------

    def on_submit(self, now: float) -> None:
        with self._lock:
            self._submitted.inc()
            self._inflight.inc()
            depth = self._inflight.value()
            self._inflight_peak.set_max(depth)
            self._depth.append(depth)
            if self.t_first_dispatch is None:
                self.t_first_dispatch = now

    def on_forced(self) -> None:
        with self._lock:
            self._inflight.dec()

    def unforced(self) -> int:
        """Dispatched-but-not-forced count (the completion thread's idle
        predicate: waiting while this is 0 means the device has nothing)."""
        with self._lock:
            return int(self._inflight.value())

    def on_idle(self, seconds: float) -> None:
        self._idle.inc(seconds)

    def idle_open(self, since: float) -> None:
        """An idle wait began at `since` (perf_counter)."""
        with self._lock:
            self._idle_from = since

    def idle_close(self, now: float, count: bool) -> None:
        """The idle wait ended at `now`; `count` adds it to the idle total,
        in the same step that closes it."""
        with self._lock:
            if count and self._idle_from is not None:
                self._idle.inc(now - self._idle_from)
            self._idle_from = None

    def idle_parts(self) -> tuple[float, float]:
        """(idle seconds counted, seconds of the idle wait in progress), read
        together: their sum, read twice, differs by the idle time between
        the two reads."""
        with self._lock:
            return self._idle.value(), (time.perf_counter() - self._idle_from
                                        if self._idle_from is not None else 0.0)

    def on_complete(self, now: float) -> None:
        with self._lock:
            self._completed.inc()
            self.t_last_complete = now

    def on_failed(self, now: float) -> None:
        with self._lock:
            self._failed.inc()
            self.t_last_complete = now

    def on_stage(
        self, stage: str, seconds: float, exemplar: str | None = None
    ) -> None:
        # exemplar: the item's trace id, so that a force or encode latency
        # spike in the exposition links to its trace (obs/metrics.py)
        self._stage.observe(seconds, stage=stage, exemplar=exemplar)

    # -- reporting ---------------------------------------------------------

    def active_window_s(self) -> float | None:
        with self._lock:
            if self.t_first_dispatch is None or self.t_last_complete is None:
                return None
            return max(self.t_last_complete - self.t_first_dispatch, 0.0)

    def device_idle_frac(self) -> float | None:
        window = self.active_window_s()
        if not window:
            return None
        return min(max(self._idle.value() / window, 0.0), 1.0)

    def snapshot(self) -> dict:
        idle = self.device_idle_frac()
        with self._lock:
            mean_depth = (
                sum(self._depth) / len(self._depth) if self._depth else None
            )
        return {
            "submitted": int(self._submitted.value()),
            "completed": int(self._completed.value()),
            "failed": int(self._failed.value()),
            "inflight": int(self._inflight.value()),
            "inflight_peak": int(self._inflight_peak.value()),
            "inflight_mean": mean_depth,
            "device_idle_frac": idle,
            "idle_s": self._idle.value(),
            "stages": {
                s: self._stage.percentiles_ms(PERCENTILES, stage=s)
                for s in STAGES
            },
        }

    def summary_line(self) -> str:
        s = self.snapshot()
        idle = s["device_idle_frac"]
        forced = s["stages"]["force"] or {}
        return (
            f"engine: {s['completed']}/{s['submitted']} batches "
            f"({s['failed']} failed), inflight peak {s['inflight_peak']}"
            + (f", device idle {idle * 100:.0f}%" if idle is not None else "")
            + (
                f", force p50 {forced['p50_ms']:.1f} ms"
                if forced
                else ""
            )
        )
