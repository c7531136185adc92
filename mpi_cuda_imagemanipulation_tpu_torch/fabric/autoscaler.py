"""Elastic control loop — replica count follows load, scale-down drains.
The counterpart of the JAX package's ``fabric/autoscaler.py``.

The pod was static: `--replicas N` at launch was N forever, however the
offered load moved. This loop closes the control circuit that the
fleet's signal plane opened: every tick it reads the signals the router already
holds — per-replica queue-fill fraction (heartbeats), the idle-replica
fraction (queued == 0, the device-idle proxy a heartbeat can carry), and
the federated e2e p99 (obs/fleet.py) — and moves the replica set between
`MCIM_FABRIC_MIN_REPLICAS` and `MCIM_FABRIC_MAX_REPLICAS`.

Hysteresis, not reflexes: a signal must persist for
`MCIM_FABRIC_SCALE_SUSTAIN_S` before the loop acts, every action starts
a `MCIM_FABRIC_SCALE_COOLDOWN_S` quiet period, and scale-up and
scale-down thresholds are separated (`SCALE_UP_FRAC` vs
`SCALE_DOWN_FRAC`) so the loop cannot oscillate on the boundary.

Scale-up is cheap: spawn one replica (the supervisor owns the process;
warmup + the first heartbeat make it routable). Scale-down is the part
that must not drop work — **drain-before-kill**:

    1. pick the victim (fewest warm buckets, then least queued — the
       cheapest affinity loss) and mark it draining ON THE ROUTER: new
       traffic stops immediately, and the next heartbeat ack tells the
       replica, which flips its health machine to `draining` (admission
       refused end to end).
    2. wait for the victim's heartbeat to report `draining` with an
       EMPTY queue — in-flight work finishes on the replica that
       admitted it; nothing is rerouted mid-request.
    3. only then SIGTERM (`scale_down` callback -> supervisor.remove);
       a victim that never empties is SIGTERMed at
       `MCIM_FABRIC_SCALE_DRAIN_DEADLINE_S` — the replica's own drain
       deadline still flushes what it holds.

The victim's warm buckets remap by the existing rendezvous hash the
moment it stops being routable; live video sessions bound to it replay
their journal tails to the new winner (fabric/session.py). Every action
increments `mcim_fabric_scale_events_total{direction}` and writes an
`autoscale` flight-recorder dump carrying the signals that drove it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from mpi_cuda_imagemanipulation_tpu_torch.fabric import canary as fabric_canary
from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder as flight_recorder
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

ENV_MIN_REPLICAS = "MCIM_FABRIC_MIN_REPLICAS"
ENV_MAX_REPLICAS = "MCIM_FABRIC_MAX_REPLICAS"
ENV_UP_FRAC = "MCIM_FABRIC_SCALE_UP_FRAC"
ENV_DOWN_FRAC = "MCIM_FABRIC_SCALE_DOWN_FRAC"
ENV_SUSTAIN_S = "MCIM_FABRIC_SCALE_SUSTAIN_S"
ENV_COOLDOWN_S = "MCIM_FABRIC_SCALE_COOLDOWN_S"
ENV_TICK_S = "MCIM_FABRIC_SCALE_TICK_S"
ENV_P99_TARGET_S = "MCIM_FABRIC_SCALE_P99_TARGET_S"
ENV_DRAIN_DEADLINE_S = "MCIM_FABRIC_SCALE_DRAIN_DEADLINE_S"


class AutoscalerConfig:
    """Resolved knobs (None falls back to the MCIM_FABRIC_* env)."""

    def __init__(
        self,
        *,
        min_replicas: int | None = None,
        max_replicas: int | None = None,
        up_frac: float | None = None,
        down_frac: float | None = None,
        sustain_s: float | None = None,
        cooldown_s: float | None = None,
        tick_s: float | None = None,
        p99_target_s: float | None = None,
        drain_deadline_s: float | None = None,
    ):
        def _f(v, name):
            return float(env_registry.get(name)) if v is None else float(v)

        self.min_replicas = (
            int(env_registry.get(ENV_MIN_REPLICAS))
            if min_replicas is None
            else int(min_replicas)
        )
        self.max_replicas = (
            int(env_registry.get(ENV_MAX_REPLICAS))
            if max_replicas is None
            else int(max_replicas)
        )
        self.up_frac = _f(up_frac, ENV_UP_FRAC)
        self.down_frac = _f(down_frac, ENV_DOWN_FRAC)
        self.sustain_s = _f(sustain_s, ENV_SUSTAIN_S)
        self.cooldown_s = _f(cooldown_s, ENV_COOLDOWN_S)
        self.tick_s = _f(tick_s, ENV_TICK_S)
        self.p99_target_s = (
            env_registry.get_float(ENV_P99_TARGET_S)
            if p99_target_s is None
            else float(p99_target_s)
        )
        self.drain_deadline_s = _f(drain_deadline_s, ENV_DRAIN_DEADLINE_S)
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"bad replica bounds [{self.min_replicas}, "
                f"{self.max_replicas}]"
            )


class Autoscaler:
    """The loop. `scale_up()` must spawn one replica and return its id;
    `scale_down(rid)` must SIGTERM + forget a (drained) replica. Both
    are the Fabric's; the loop itself only reads router state and holds
    the drain state machine. `tick(now)` is callable directly with a
    fake clock — the thread is just tick-on-a-timer."""

    def __init__(
        self,
        router,
        *,
        scale_up: Callable[[], str],
        scale_down: Callable[[str], None],
        live_count: Callable[[], int] | None = None,
        config: AutoscalerConfig | None = None,
        registry: Registry | None = None,
        clock=time.monotonic,
    ):
        self.router = router
        self.config = config or AutoscalerConfig()
        self._scale_up = scale_up
        self._scale_down = scale_down
        # how many replicas EXIST (supervisor view) — routable undercounts
        # during warmup, and a loop that counts only routable replicas
        # would over-spawn while the first ones are still compiling
        self._live_count = live_count
        self._clock = clock
        self._lock = threading.Lock()
        self._up_since: float | None = None
        self._down_since: float | None = None
        self._last_action: float = -1e18
        self.target = self.config.min_replicas
        # drain in flight: (rid, marked_at) — one at a time, on purpose:
        # parallel drains under a falling load could empty the pod
        self.draining: tuple[str, float] | None = None
        self.events: list[dict] = []  # bounded action history (/stats)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._log = get_logger()
        r = registry or Registry()
        self._m_events = r.counter(
            "mcim_fabric_scale_events_total",
            "Autoscaler actions by direction (up/down).",
            labels=("direction",),
        )
        r.gauge(
            "mcim_fabric_scale_target_replicas",
            "Replica count the autoscaler is currently steering toward.",
            fn=lambda: float(self.target),
        )
        r.gauge(
            "mcim_fabric_scale_draining",
            "1 while a scale-down drain is in flight.",
            fn=lambda: 1.0 if self.draining is not None else 0.0,
        )

    # -- signals -------------------------------------------------------------

    def signals(self) -> dict:
        """The tick's inputs, from state the router already holds: mean
        queue-fill and idle fraction over fresh routable replicas, the
        federated p99, and the current live count (routable + the one
        mid-drain, which still owns in-flight work)."""
        views = self.router._routable()
        if self._live_count is not None:
            n_live = self._live_count()
        else:
            n_live = len(views) + (1 if self.draining is not None else 0)
        fills = [v.load_frac() for v in views]
        idle = sum(1 for v in views if v.hb.queued == 0)
        p99 = None
        if self.config.p99_target_s is not None:
            try:
                p99 = self.router.fleet_p99().get("p99_s")
            except Exception:  # federation gap: queue fill still steers
                p99 = None
        return {
            "replicas": n_live,
            "routable": len(views),
            "queue_fill": sum(fills) / len(fills) if fills else 0.0,
            "idle_frac": idle / len(views) if views else 0.0,
            "p99_s": p99,
        }

    # -- the loop ------------------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            if self.draining is not None:
                self._check_drain(now)
                return
            sig = self.signals()
            n = sig["replicas"]
            cfg = self.config
            # bounds enforcement needs no hysteresis: below the floor is
            # an outage-shaped state, not a pressure signal
            if n < cfg.min_replicas:
                self._act_up(now, sig, reason="below min_replicas")
                return
            up = sig["routable"] > 0 and (
                sig["queue_fill"] >= cfg.up_frac
                or (
                    cfg.p99_target_s is not None
                    and sig["p99_s"] is not None
                    and sig["p99_s"] >= cfg.p99_target_s
                )
            )
            gate = getattr(self.router, "canary", None)
            down = (
                sig["routable"] > 0
                # only shrink on a COMPLETE picture: a replica that is
                # warming up or heartbeat-gapped makes the routable set
                # unrepresentative, and "the replicas I can see are
                # idle" is not "the pod is idle"
                and sig["routable"] >= sig["replicas"]
                and sig["queue_fill"] <= cfg.down_frac
                and sig["idle_frac"] >= 0.5
                # no membership churn under an active flip: draining a
                # replica mid-canary would skew the lane comparison (and
                # could drain the canary itself)
                and (gate is None or gate.state != fabric_canary.CANARY)
            )
            self._up_since = (
                (self._up_since or now) if up else None
            )
            self._down_since = (
                (self._down_since or now) if down else None
            )
            if now - self._last_action < cfg.cooldown_s:
                return
            if (
                up
                and n < cfg.max_replicas
                and now - self._up_since >= cfg.sustain_s
            ):
                self._act_up(now, sig, reason="sustained pressure")
            elif (
                down
                and n > cfg.min_replicas
                and now - self._down_since >= cfg.sustain_s
            ):
                self._act_down(now, sig)

    def _act_up(self, now: float, sig: dict, *, reason: str) -> None:
        rid = self._scale_up()
        self.target = sig["replicas"] + 1
        self._last_action = now
        self._up_since = self._down_since = None
        self._record("up", rid, now, sig, reason)

    def _act_down(self, now: float, sig: dict) -> None:
        victim = self._pick_victim()
        if victim is None:
            return
        self.router.mark_draining(victim)
        self.draining = (victim, now)
        self.target = sig["replicas"] - 1
        self._last_action = now
        self._up_since = self._down_since = None
        self._log.info(
            "autoscale: draining %s (queue_fill %.2f, idle %.2f)",
            victim, sig["queue_fill"], sig["idle_frac"],
        )

    def _pick_victim(self) -> str | None:
        """The cheapest replica to lose: fewest warm buckets (smallest
        affinity remap), then least queued, then highest id (so r0, the
        seed replica, goes last — deterministic for tests)."""
        views = self.router._routable()
        if not views:
            return None
        return min(
            views,
            key=lambda v: (
                len(v.hb.warm_buckets),
                v.hb.queued,
                # highest id first among ties
                tuple(-ord(c) for c in v.replica_id),
            ),
        ).replica_id

    def _check_drain(self, now: float) -> None:
        """Step 2/3 of drain-before-kill (lock held): SIGTERM only once
        the victim's heartbeat shows an empty queue in the draining
        state, or the drain deadline passes."""
        rid, since = self.draining
        view = self.router.table.get(rid)
        drained = (
            view is not None
            and view.hb.state == "draining"
            and view.hb.queued == 0
        )
        gone = view is None  # died mid-drain: nothing left to kill nicely
        expired = now - since >= self.config.drain_deadline_s
        if not (drained or gone or expired):
            return
        self.draining = None
        self._last_action = now
        try:
            self._scale_down(rid)
        finally:
            self.router.unmark_draining(rid)
        self._record(
            "down", rid, now, self.signals(),
            "drained" if drained else ("gone" if gone else "drain deadline"),
        )

    def _record(
        self, direction: str, rid: str, now: float, sig: dict, reason: str
    ) -> None:
        self._m_events.inc(direction=direction)
        event = {
            "direction": direction,
            "replica": rid,
            "reason": reason,
            "signals": sig,
            "t": now,
        }
        self.events.append(event)
        del self.events[:-50]
        self._log.info(
            "autoscale %s: %s (%s; queue_fill %.2f, idle %.2f, p99 %s)",
            direction, rid, reason, sig["queue_fill"], sig["idle_frac"],
            f"{sig['p99_s'] * 1e3:.1f}ms" if sig.get("p99_s") else "n/a",
        )
        # post-mortem-grade record: the router/supervisor ring holds the
        # heartbeats that produced these signals — freeze them with the
        # decision (rate-limited like every trigger)
        flight_recorder.dump("autoscale", extra=event)

    # -- lifecycle + introspection -------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="mcim-fabric-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                self._log.exception("autoscaler tick failed")
            self._stop.wait(self.config.tick_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def status(self) -> dict:
        with self._lock:
            return {
                "target": self.target,
                "bounds": [
                    self.config.min_replicas, self.config.max_replicas
                ],
                "draining": self.draining[0] if self.draining else None,
                "signals": self.signals(),
                "events": list(self.events[-10:]),
            }
