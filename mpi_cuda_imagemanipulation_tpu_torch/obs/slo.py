"""SLO burn-rate engine — declarative objectives over the federated view.
The counterpart of the JAX package's ``obs/slo.py``.

An SLO is a target fraction of GOOD events; the error budget is
`1 - target`. The **burn rate** is how fast that budget is being spent:
an error rate of exactly `1 - target` burns at 1.0 (the budget lasts the
whole period); burn 10 means the month's budget is gone in three days.
Alerting on burn rates over TWO windows — a fast window that reacts and a
slow window that confirms — is the standard multi-window construction: a
blip trips neither, a real outage trips both quickly, and a slow leak
still trips the slow window. The alert FIRES when both windows exceed the
threshold and CLEARS when either drops back under it.

Spec grammar (`MCIM_SLO_SPECS` / `--slo`, comma-separated):

    avail:99.5            availability: 99.5% of resolved requests ok
                          (good = status "ok"; total excludes "rejected"
                          — a client sending garbage is not our outage)
    latency:0.25:99       latency: 99% of requests complete within 0.25 s
                          (the bound must be a histogram bucket edge;
                          good = cumulative count at that bucket)
    headroom:0.1:99       device memory: 99% of evaluation ticks must
                          see >= 10% allocator headroom on EVERY device
                          of EVERY fresh replica (the federated
                          mcim_devmem_headroom_frac gauges, obs/devmem
                          — each tick is one good/bad event, so the
                          same burn-rate machinery applies)

All kinds read the FEDERATED families (obs/fleet.py) —
`mcim_serve_requests_total`, `mcim_serve_e2e_latency_seconds`,
`mcim_devmem_headroom_frac` — so the burn rates are fleet-wide — a
single replica melting down moves them in proportion to its traffic
share, which is what an error budget means.

The engine samples those cumulative counters into a bounded ring each
tick and differences ring endpoints to get windowed rates — no
per-request cost, and restarts of individual replicas are already
incarnation-folded by the aggregator, so windows never see counters move
backward. Alert transitions are recorded three ways: an instant event on
a dedicated mini-trace (`slo.alert` — it lands in the Perfetto export
next to the requests that burned the budget), a flight-recorder note
(post-mortem dumps show the alert history), and the
`mcim_slo_transitions_total` counter. Current state is exposed as
`mcim_slo_*` gauges on the router registry and as JSON at `GET /slo`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

ENV_SPECS = "MCIM_SLO_SPECS"
ENV_FAST_S = "MCIM_SLO_FAST_S"
ENV_SLOW_S = "MCIM_SLO_SLOW_S"
ENV_TICK_S = "MCIM_SLO_TICK_S"
ENV_BURN_THRESHOLD = "MCIM_SLO_BURN_THRESHOLD"

# availability: client-side rejections are not availability failures
_AVAIL_EXCLUDED_STATUSES = ("rejected",)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    name: str
    kind: str  # "availability" | "latency" | "headroom"
    target: float  # good fraction in (0, 1)
    # latency: bound in seconds (bucket edge); headroom: the minimum
    # free-fraction every device must keep
    le: float | None = None

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_slo_specs(spec: str) -> tuple[SLOSpec, ...]:
    """Parse the `avail:<pct>,latency:<le>:<pct>` grammar; raises
    ValueError with the offending token on anything else."""
    out: list[SLOSpec] = []
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        parts = tok.split(":")
        try:
            if parts[0] in ("avail", "availability") and len(parts) == 2:
                pct = float(parts[1])
                if not 0.0 < pct < 100.0:
                    raise ValueError
                out.append(
                    SLOSpec(
                        name=f"availability_{parts[1]}",
                        kind="availability",
                        target=pct / 100.0,
                    )
                )
                continue
            if parts[0] == "latency" and len(parts) == 3:
                le = float(parts[1])
                pct = float(parts[2])
                if le <= 0.0 or not 0.0 < pct < 100.0:
                    raise ValueError
                out.append(
                    SLOSpec(
                        name=f"latency_le{parts[1]}_{parts[2]}",
                        kind="latency",
                        target=pct / 100.0,
                        le=le,
                    )
                )
                continue
            if parts[0] == "headroom" and len(parts) == 3:
                frac = float(parts[1])
                pct = float(parts[2])
                if not 0.0 < frac < 1.0 or not 0.0 < pct < 100.0:
                    raise ValueError
                out.append(
                    SLOSpec(
                        name=f"headroom_{parts[1]}_{parts[2]}",
                        kind="headroom",
                        target=pct / 100.0,
                        le=frac,
                    )
                )
                continue
            raise ValueError
        except ValueError:
            raise ValueError(
                f"bad SLO spec token {tok!r} (want avail:<pct>, "
                "latency:<le_seconds>:<pct> or headroom:<min_frac>:<pct>)"
            ) from None
    return tuple(out)


def fleet_slo_source(merged_fn):
    """A `source()` over the fleet view: `{spec-kind key: (good, total)}`
    cumulative counts. `merged_fn()` is `FleetAggregator.merged` (or any
    callable returning the same shape, which is what the tests inject)."""

    # headroom specs turn each evaluation tick into one good/bad event
    # (gauges have no cumulative counter to difference); the accumulators
    # live here so the ring-endpoint machinery sees monotone counts
    headroom_cum: dict[str, list[float]] = {}

    def source(specs: tuple[SLOSpec, ...]) -> dict[str, tuple[float, float]]:
        merged = merged_fn()
        out: dict[str, tuple[float, float]] = {}
        req = merged.get("mcim_serve_requests_total")
        lat = merged.get("mcim_serve_e2e_latency_seconds")
        hr = merged.get("mcim_devmem_headroom_frac")
        for s in specs:
            good = total = 0.0
            if s.kind == "headroom":
                cum = headroom_cum.setdefault(s.name, [0.0, 0.0])
                series = (hr or {}).get("series", {})
                if series:
                    # the WORST device of the WORST fresh replica decides
                    worst = min(series.values())
                    cum[1] += 1.0
                    if worst >= (s.le or 0.0):
                        cum[0] += 1.0
                out[s.name] = (cum[0], cum[1])
                continue
            if s.kind == "availability" and req is not None:
                for key, v in req["series"].items():
                    status = key[0] if key else ""
                    if status in _AVAIL_EXCLUDED_STATUSES:
                        continue
                    total += v
                    if status == "ok":
                        good += v
            elif s.kind == "latency" and lat is not None:
                data = lat["series"].get(())
                if data:
                    bounds = lat["bounds"]
                    # the greatest bucket edge <= le holds the good count
                    idx = None
                    for i, ub in enumerate(bounds):
                        if ub <= s.le + 1e-12:
                            idx = i
                    if idx is not None:
                        good = float(data["buckets"][idx])
                    total = float(data["count"])
            out[s.name] = (good, total)
        return out

    return source


class _AlertState:
    def __init__(self):
        self.firing = False
        self.since: float | None = None
        self.transitions = 0


class SLOEngine:
    """Ticks `source` into a bounded ring, computes fast/slow burn rates
    by differencing ring endpoints, and drives the per-SLO alert machine.
    `start()` runs the ticker thread; tests call `tick(now)` directly
    with a fake clock."""

    def __init__(
        self,
        specs: tuple[SLOSpec, ...],
        source,
        *,
        fast_s: float | None = None,
        slow_s: float | None = None,
        tick_s: float | None = None,
        burn_threshold: float | None = None,
        registry: Registry | None = None,
        clock=time.monotonic,
    ):
        self.specs = tuple(specs)
        self._source = source
        self.fast_s = (
            float(env_registry.get(ENV_FAST_S)) if fast_s is None else fast_s
        )
        self.slow_s = (
            float(env_registry.get(ENV_SLOW_S)) if slow_s is None else slow_s
        )
        self.tick_s = (
            float(env_registry.get(ENV_TICK_S)) if tick_s is None else tick_s
        )
        self.burn_threshold = (
            float(env_registry.get(ENV_BURN_THRESHOLD))
            if burn_threshold is None
            else burn_threshold
        )
        self._clock = clock
        self._lock = threading.Lock()
        # ring of (t, {name: (good, total)}); sized to cover the slow
        # window at tick resolution with slack
        cap = max(int(self.slow_s / max(self.tick_s, 1e-3)) + 8, 16)
        self._ring: deque = deque(maxlen=cap)
        self._alerts = {s.name: _AlertState() for s in self.specs}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._log = get_logger()
        if registry is not None:
            self._register_gauges(registry)

    def _register_gauges(self, r: Registry) -> None:
        r.gauge(
            "mcim_slo_burn_rate",
            "Error-budget burn rate per SLO and window (1 = on budget).",
            labels=("slo", "window"),
            fn=self._burn_gauge,
        )
        r.gauge(
            "mcim_slo_alert_firing",
            "1 while the SLO's multi-window burn alert is firing.",
            labels=("slo",),
            fn=lambda: {
                (name,): 1.0 if st.firing else 0.0
                for name, st in self._alerts.items()
            },
        )
        r.gauge(
            "mcim_slo_target",
            "Configured good-fraction target per SLO.",
            labels=("slo",),
            fn=lambda: {(s.name,): s.target for s in self.specs},
        )
        self._m_transitions = r.counter(
            "mcim_slo_transitions_total",
            "Alert state transitions per SLO and new state.",
            labels=("slo", "to"),
        )

    def _burn_gauge(self) -> dict:
        out = {}
        for s in self.specs:
            burns = self.burn_rates(s.name)
            out[(s.name, "fast")] = burns.get("fast") or 0.0
            out[(s.name, "slow")] = burns.get("slow") or 0.0
        return out

    # -- sampling + windows --------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        """One evaluation: sample the source, update every alert."""
        now = self._clock() if now is None else now
        counts = self._source(self.specs)
        with self._lock:
            self._ring.append((now, counts))
        for s in self.specs:
            self._evaluate(s, now)

    def _window_rate(
        self, name: str, window_s: float, now: float
    ) -> float | None:
        """Error rate over the trailing window: difference the newest
        ring sample against the oldest one inside the window (or the
        first ever sample while the ring is still shorter than the
        window). None until two samples exist or when no events moved."""
        with self._lock:
            ring = list(self._ring)
        if len(ring) < 2:
            return None
        newest_t, newest = ring[-1]
        base_t, base = ring[0]
        for t, counts in ring:
            if t >= now - window_s:
                base_t, base = t, counts
                break
        if base_t >= newest_t:
            return None
        g1, t1 = newest.get(name, (0.0, 0.0))
        g0, t0 = base.get(name, (0.0, 0.0))
        d_total = t1 - t0
        if d_total <= 0:
            return None
        d_bad = (t1 - g1) - (t0 - g0)
        return max(min(d_bad / d_total, 1.0), 0.0)

    def burn_rates(self, name: str, now: float | None = None) -> dict:
        now = self._clock() if now is None else now
        spec = next(s for s in self.specs if s.name == name)
        out = {}
        for window, window_s in (("fast", self.fast_s), ("slow", self.slow_s)):
            rate = self._window_rate(name, window_s, now)
            out[window] = (
                None if rate is None else rate / max(spec.budget, 1e-9)
            )
        return out

    # -- alerting ------------------------------------------------------------

    def _evaluate(self, spec: SLOSpec, now: float) -> None:
        burns = self.burn_rates(spec.name, now)
        fast, slow = burns["fast"], burns["slow"]
        firing = (
            fast is not None
            and slow is not None
            and fast > self.burn_threshold
            and slow > self.burn_threshold
        )
        st = self._alerts[spec.name]
        if firing == st.firing:
            return
        st.firing = firing
        st.since = now
        st.transitions += 1
        state = "firing" if firing else "ok"
        if hasattr(self, "_m_transitions"):
            self._m_transitions.inc(slo=spec.name, to=state)
        recorder.note(
            "slo", slo=spec.name, state=state,
            burn_fast=fast, burn_slow=slow,
        )
        self._log.warning(
            "slo %s -> %s (burn fast %.2f / slow %.2f, threshold %.2f)",
            spec.name, state, fast or 0.0, slow or 0.0, self.burn_threshold,
        )
        # the transition lands on the trace timeline as its own
        # mini-trace: an instant event next to the requests that burned
        # the budget (merged exports line them up by wall clock)
        with obs_trace.start_trace(
            "slo.alert", slo=spec.name, state=state
        ) as root:
            obs_trace.event(
                "slo.transition", parent=root.context(),
                slo=spec.name, state=state,
                burn_fast=fast, burn_slow=slow,
            )

    # -- lifecycle + reporting ----------------------------------------------

    def start(self) -> "SLOEngine":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="mcim-slo-engine", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                self._log.exception("slo tick failed")
            self._stop.wait(self.tick_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def status(self, now: float | None = None) -> dict:
        """The `GET /slo` payload."""
        now = self._clock() if now is None else now
        slos = {}
        with self._lock:
            newest = self._ring[-1][1] if self._ring else {}
        for s in self.specs:
            burns = self.burn_rates(s.name, now)
            st = self._alerts[s.name]
            good, total = newest.get(s.name, (0.0, 0.0))
            slos[s.name] = {
                **s.to_dict(),
                "burn_fast": burns["fast"],
                "burn_slow": burns["slow"],
                "alert": "firing" if st.firing else "ok",
                "alert_since_s": (
                    None if st.since is None else now - st.since
                ),
                "transitions": st.transitions,
                "good": good,
                "total": total,
            }
        return {
            "windows": {
                "fast_s": self.fast_s,
                "slow_s": self.slow_s,
                "tick_s": self.tick_s,
            },
            "burn_threshold": self.burn_threshold,
            "slos": slos,
        }
