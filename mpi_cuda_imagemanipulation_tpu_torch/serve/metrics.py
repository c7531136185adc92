r"""Serving metrics — queue depth, batch occupancy, latency percentiles.
The counterpart of the JAX package's ``serve/metrics.py`` (jax-free there;
copied, with the imports pointed at the port).

This class is a thin recording facade over an `obs.Registry`: every
quantity lives in ONE named metric family (`mcim_serve_*`), the
Prometheus `GET /metrics` exposition renders the same objects, and
`snapshot()` — the `/stats` payload and shutdown report — is a *view*
over the registry, so the two endpoints cannot drift. Latency
percentiles come from the histograms' bounded reservoirs via
`utils.timing.percentiles` — the quantile definition every report of
the port uses, so offline and online reports are comparable; the reservoir
keeps the most recent `sample_cap` observations (a serving process must
not grow memory with request count — admission control bounds the queue,
this bounds the accounting).

Per-request timeline (host wall clocks; the dispatch's device time is the
wait for its result, measured where the result is forced):

    submit --queue_wait--> dispatch --[batch device time]--> done
      \__________________ e2e latency _________________________/
"""

from __future__ import annotations

import threading

from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.resilience import (
    deadline as deadline_mod,
)

PERCENTILES = (50, 95, 99)

# terminal request statuses, the label set of mcim_serve_requests_total
STATUSES = (
    "ok", "overloaded", "rejected", "deadline_expired", "error",
    "quarantined",
)


class ServeMetrics:
    def __init__(self, registry: Registry | None = None,
                 sample_cap: int = 65536):
        self.registry = registry or Registry()
        r = self.registry
        # one lock serialises multi-metric updates (e.g. queue depth +
        # its peak) so snapshots never see a torn pair
        self._lock = threading.Lock()
        self._submitted = r.counter(
            "mcim_serve_submitted_total", "Requests submitted for admission."
        )
        self._requests = r.counter(
            "mcim_serve_requests_total",
            "Requests resolved, by terminal status.",
            labels=("status",),
        )
        self._retries = r.counter(
            "mcim_serve_retries_total",
            "Dispatch attempts re-run by the retry executor.",
        )
        self._qos_shed = r.counter(
            "mcim_serve_qos_shed_total",
            "Sheds caused by a QoS class hitting its queue fraction "
            "before the full depth (low classes shed first; "
            "graph/tenancy ladder).",
            labels=("qos",),
        )
        self._degraded = r.counter(
            "mcim_serve_degraded_total",
            "Requests served via the golden fallback (breaker open).",
        )
        self._dispatches = r.counter(
            "mcim_serve_dispatches_total", "Micro-batch dispatches."
        )
        self._batch_slots = r.counter(
            "mcim_serve_batch_slots_total",
            "Compiled batch slots dispatched (incl. pad).",
        )
        self._batch_real = r.counter(
            "mcim_serve_batch_real_total", "Real requests dispatched."
        )
        self._queued = r.gauge(
            "mcim_serve_queue_depth", "Current admission-queue depth."
        )
        self._queued_peak = r.gauge(
            "mcim_serve_queue_depth_peak",
            "High-water admission-queue depth.",
        )
        self._queue_wait = r.histogram(
            "mcim_serve_queue_wait_seconds",
            "Admission-to-dispatch wait per request.",
            sample_cap=sample_cap,
        )
        self._device = r.histogram(
            "mcim_serve_device_seconds",
            "Device time per micro-batch dispatch.",
            sample_cap=sample_cap,
        )
        self._e2e = r.histogram(
            "mcim_serve_e2e_latency_seconds",
            "Submit-to-done latency per completed request.",
            sample_cap=sample_cap,
        )
        # the per-tier deadline-expiry counter (resilience/deadline.py):
        # shared by this process's HTTP edge ("replica"), queue-pop
        # expiry ("scheduler") and graph dispatch ("graph") — the
        # registry dedups, so each subsystem just asks for it
        self.deadline_tiers = deadline_mod.expired_counter(r)

    # -- registry-backed readers (back-compat attribute surface) -----------

    @property
    def submitted(self) -> int:
        return int(self._submitted.value())

    @property
    def completed(self) -> int:
        return int(self._requests.value(status="ok"))

    @property
    def retries(self) -> int:
        return int(self._retries.value())

    @property
    def queued(self) -> int:
        return int(self._queued.value())

    # -- recording ---------------------------------------------------------

    def on_submit(self) -> None:
        self._submitted.inc()

    def on_admit(self) -> None:
        with self._lock:
            self._queued.inc()
            self._queued_peak.set_max(self._queued.value())

    def on_shed(self, qos: str = "") -> None:
        """`qos` names the admission class when the shed happened at a
        class fraction BELOW the full queue depth (QoS-first shedding);
        "" is the plain full-queue shed."""
        self._requests.inc(status="overloaded")
        if qos:
            self._qos_shed.inc(qos=qos)

    def on_reject(self) -> None:
        self._requests.inc(status="rejected")

    def on_deadline_at_submit(self) -> None:
        """A request whose propagated budget was already dead at submit:
        resolved deadline_expired without ever being admitted (so no
        queue-depth bookkeeping, unlike `on_deadline`)."""
        self._requests.inc(status="deadline_expired")
        deadline_mod.count_expired(self.deadline_tiers, "scheduler")

    def on_deadline(self, queue_wait_s: float, trace_id: str = "") -> None:
        with self._lock:
            self._requests.inc(status="deadline_expired")
            self._queued.dec()
        # the queue-pop expiry is the LAST link of the propagated
        # deadline chain — same per-tier family the door/router use
        deadline_mod.count_expired(self.deadline_tiers, "scheduler")
        self._queue_wait.observe(queue_wait_s, exemplar=trace_id or None)

    def on_dispatch(
        self, n_real: int, n_slots: int, device_s: float,
        trace_id: str = "",
    ) -> None:
        self._dispatches.inc()
        self._batch_real.inc(n_real)
        self._batch_slots.inc(n_slots)
        self._device.observe(device_s, exemplar=trace_id or None)

    def on_complete(
        self, queue_wait_s: float, e2e_s: float, trace_id: str = ""
    ) -> None:
        """`trace_id` rides as the latency histograms' exemplar: a p99
        spike in the (federated) exposition then names the trace that
        caused it instead of an anonymous bucket count."""
        with self._lock:
            self._requests.inc(status="ok")
            self._queued.dec()
        self._queue_wait.observe(queue_wait_s, exemplar=trace_id or None)
        self._e2e.observe(e2e_s, exemplar=trace_id or None)

    def on_error(self, n: int = 1) -> None:
        with self._lock:
            self._requests.inc(n, status="error")
            self._queued.dec(n)

    def on_retry(self) -> None:
        self._retries.inc()

    def on_quarantine(self, n: int = 1) -> None:
        with self._lock:
            self._requests.inc(n, status="quarantined")
            self._queued.dec(n)

    def on_degraded(self, n: int = 1) -> None:
        # the request ALSO counts through on_complete (it succeeded); this
        # only tags how many went via the fallback path
        self._degraded.inc(n)

    # -- reporting ---------------------------------------------------------

    def e2e_exemplar(self, q: float = 99) -> dict | None:
        """The e2e-latency exemplar nearest the q-th percentile — the
        trace id loadgen/bench reports print next to the outlier
        percentile (obs/metrics.Histogram.exemplar_for_quantile)."""
        ex = self._e2e.exemplar_for_quantile(q)
        if ex is None:
            return None
        return {"trace_id": ex[0], "value_s": ex[1]}

    def snapshot(self) -> dict:
        dispatches = int(self._dispatches.value())
        batch_real = int(self._batch_real.value())
        batch_slots = int(self._batch_slots.value())
        return {
            "submitted": int(self._submitted.value()),
            "completed": int(self._requests.value(status="ok")),
            "shed_overloaded": int(self._requests.value(status="overloaded")),
            "rejected": int(self._requests.value(status="rejected")),
            "deadline_expired": int(
                self._requests.value(status="deadline_expired")
            ),
            "errors": int(self._requests.value(status="error")),
            "retries": int(self._retries.value()),
            "quarantined": int(self._requests.value(status="quarantined")),
            "degraded": int(self._degraded.value()),
            "queued": int(self._queued.value()),
            "queued_peak": int(self._queued_peak.value()),
            "dispatches": dispatches,
            "mean_batch_occupancy": (
                batch_real / dispatches if dispatches else None
            ),
            "batch_fill_frac": (
                batch_real / batch_slots if batch_slots else None
            ),
            "queue_wait": self._queue_wait.percentiles_ms(PERCENTILES),
            "device_per_dispatch": self._device.percentiles_ms(PERCENTILES),
            "e2e_latency": self._e2e.percentiles_ms(PERCENTILES),
        }

    def summary_line(self) -> str:
        s = self.snapshot()
        lat = s["e2e_latency"] or {}
        occ = s["mean_batch_occupancy"]
        return (
            f"served {s['completed']}/{s['submitted']} "
            f"(shed {s['shed_overloaded']}, rejected {s['rejected']}, "
            f"deadline {s['deadline_expired']}, errors {s['errors']}, "
            f"retries {s['retries']}, quarantined {s['quarantined']}, "
            f"degraded {s['degraded']}) in "
            f"{s['dispatches']} dispatches"
            + (f" (mean occupancy {occ:.2f})" if occ else "")
            + (
                f"; e2e p50/p95/p99 = {lat['p50_ms']:.1f}/"
                f"{lat['p95_ms']:.1f}/{lat['p99_ms']:.1f} ms"
                if lat
                else ""
            )
        )
