"""Front-door router — health- and affinity-aware load balancing over
replica workers. The counterpart of the JAX package's ``fabric/router.py``
(jax-free there; the port keeps its own copy, pointed at the port's
modules, so that its routing decisions and wires equal the JAX router's).

One `POST /v1/process` arrives; the router sniffs the image's shape
bucket from the PNG header (no full decode on the proxy path), orders the
live replicas, and proxies the body to the first that takes it:

  1. **sticky bucket affinity** — among fresh serving replicas, prefer
     those whose heartbeat lists the bucket as WARM in their function
     cache; the rendezvous hash of (bucket, replica_id) picks the sticky
     target inside that pool (and is the consistent-hash fallback when
     nothing reports warm): every router instance picks the same target
     without coordination, one replica's death only remaps ITS buckets,
     and a RESTARTED replica reclaims them as soon as warmup re-reports
     the grid.
  2. **shed when the sticky target is unhealthy** — degraded state, a
     breaker open for this very bucket, or queue fill past
     MCIM_FABRIC_SHED_FRAC demotes the sticky pick behind the
     least-loaded healthy replica (draining/stale replicas are excluded
     outright).
  3. **reroute on failure** — a connection error, timeout, or 5xx/429
     moves to the next candidate (up to MCIM_FABRIC_FORWARD_ATTEMPTS
     distinct replicas); connection-class failures feed that replica's
     circuit breaker so a dead worker is routed around for the breaker
     window instead of eating a timeout per request. A replica restart
     (new heartbeat incarnation) resets its breaker.
  4. **503 + Retry-After only when NO replica is serving** — the fabric's
     equivalent of the scheduler's explicit shed: callers get a clear
     signal, never a hang.

Requests too large for every replica bucket take the optional MESH lane
(fabric/mesh.py): one row-sharded `Pipeline.sharded` dispatch over the
slots of a mesh, in the router process — big requests span the mesh,
small requests ride data-parallel replicas.

Observability: every quantity is an `mcim_fabric_*` family on the
router's registry (`GET /metrics`), the router's root span propagates its
trace id to the replica via X-Trace-Id (the replica ADOPTS it — one trace
covers the full hop), and `router.forward` is a failpoint so rerouting is
testable without killing anything.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import http.client
import io as _io
import json
import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mpi_cuda_imagemanipulation_tpu_torch.fabric import canary as fabric_canary
from mpi_cuda_imagemanipulation_tpu_torch.fabric import session as fabric_session
from mpi_cuda_imagemanipulation_tpu_torch.fabric.control import (
    HEARTBEAT_PATH,
    Heartbeat,
)
from mpi_cuda_imagemanipulation_tpu_torch.federation import control as fed_control
from mpi_cuda_imagemanipulation_tpu_torch.graph import systolic as graph_systolic
from mpi_cuda_imagemanipulation_tpu_torch.obs import fleet as obs_fleet
from mpi_cuda_imagemanipulation_tpu_torch.obs import metrics as obs_metrics
from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder as flight_recorder
from mpi_cuda_imagemanipulation_tpu_torch.obs import slo as obs_slo
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.resilience import deadline as deadline_mod
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.resilience.breaker import BreakerBoard
from mpi_cuda_imagemanipulation_tpu_torch.serve import bucketing
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

ENV_STALE_S = "MCIM_FABRIC_STALE_S"
ENV_FORWARD_TIMEOUT_S = "MCIM_FABRIC_FORWARD_TIMEOUT_S"
ENV_FORWARD_ATTEMPTS = "MCIM_FABRIC_FORWARD_ATTEMPTS"
ENV_SHED_FRAC = "MCIM_FABRIC_SHED_FRAC"

# replica states that may receive proxied traffic at all; "serving" alone
# qualifies for the sticky fast path (degraded = shed to least-loaded)
_ROUTABLE = ("serving", "degraded")

# HTTP status -> the bounded label set of mcim_fabric_requests_total
_STATUS_LABEL = {
    200: "ok", 400: "rejected", 422: "quarantined", 429: "overloaded",
    503: "unavailable", 504: "deadline_expired",
}

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


class _ConnPool:
    """Keep-alive connection reuse per (addr, port): the proxy hot path
    must not pay a TCP handshake per forward. Connections come back to
    the pool only after a CLEAN full response; any error path closes and
    discards, so a half-read socket can never serve the next request."""

    def __init__(self, timeout_s: float, cap_per_target: int = 32):
        self.timeout_s = timeout_s
        self.cap = cap_per_target
        self._lock = threading.Lock()
        self._pools: dict[tuple[str, int], list] = {}

    def take(self, addr: str, port: int) -> http.client.HTTPConnection:
        with self._lock:
            pool = self._pools.get((addr, port))
            if pool:
                return pool.pop()
        return http.client.HTTPConnection(
            addr, port, timeout=self.timeout_s
        )

    def give(self, addr: str, port: int, conn) -> None:
        with self._lock:
            pool = self._pools.setdefault((addr, port), [])
            if len(pool) < self.cap:
                pool.append(conn)
                return
        conn.close()

    def close_all(self) -> None:
        with self._lock:
            conns = [c for pool in self._pools.values() for c in pool]
            self._pools.clear()
        for c in conns:
            c.close()


def _rendezvous_score(bucket: str, replica_id: str) -> int:
    """Deterministic cross-process score for consistent hashing (never
    builtins.hash — PYTHONHASHSEED would shuffle routing per process)."""
    import hashlib

    h = hashlib.blake2b(
        f"{bucket}|{replica_id}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big")


@dataclasses.dataclass
class ReplicaView:
    """The router's picture of one replica: the last heartbeat plus the
    router-side receive clock (freshness uses OUR clock — the wire
    timestamp would import cross-process clock skew)."""

    hb: Heartbeat
    last_seen: float  # router monotonic
    beats: int = 0

    @property
    def replica_id(self) -> str:
        return self.hb.replica_id

    def fresh(self, now: float, stale_s: float) -> bool:
        return now - self.last_seen <= stale_s

    def load_frac(self) -> float:
        depth = max(1, self.hb.queue_depth)
        return self.hb.queued / depth


class ReplicaTable:
    """Heartbeat-built replica registry. The lock guards only dict
    mutation; routing works on snapshot copies."""

    def __init__(self):
        self._lock = threading.Lock()
        self._replicas: dict[str, ReplicaView] = {}

    def observe(self, hb: Heartbeat, now: float) -> bool:
        """Fold one heartbeat in; returns True when this is a NEW
        incarnation of the replica id (first sight or restart)."""
        with self._lock:
            prev = self._replicas.get(hb.replica_id)
            new_inc = prev is None or prev.hb.incarnation != hb.incarnation
            beats = 1 if prev is None else prev.beats + 1
            self._replicas[hb.replica_id] = ReplicaView(
                hb=hb, last_seen=now, beats=beats
            )
            return new_inc

    def views(self) -> list[ReplicaView]:
        with self._lock:
            return list(self._replicas.values())

    def get(self, replica_id: str) -> ReplicaView | None:
        with self._lock:
            return self._replicas.get(replica_id)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    buckets: tuple[tuple[int, int], ...] = bucketing.DEFAULT_BUCKETS
    stale_s: float | None = None  # None: MCIM_FABRIC_STALE_S
    forward_timeout_s: float | None = None
    forward_attempts: int | None = None
    shed_frac: float | None = None
    # router-side per-replica breaker: trips fast (a dead replica costs a
    # connect timeout per probe) and resets fast (restarts should rejoin
    # within a breaker window, not a serving outage)
    breaker_threshold: int = 2
    breaker_reset_s: float = 3.0
    # SLO burn-rate engine (obs/slo.py) over the federated registries;
    # None fields fall back to their MCIM_SLO_* env defaults
    slo_specs: str | None = None
    slo_fast_s: float | None = None
    slo_slow_s: float | None = None
    slo_tick_s: float | None = None
    slo_burn_threshold: float | None = None
    # canary rollback gate knobs (fabric/canary.py); None fields fall
    # back to their MCIM_FABRIC_CANARY_* env defaults
    canary: fabric_canary.CanaryConfig | None = None
    # pod-level systolic execution (graph/systolic.py): stage-shard
    # eligible graph programs across systolic-advertising replicas
    systolic: bool = False
    # -- request lifecycle (resilience/deadline.py) ------------------------
    # retry-budget token bucket: deposit `frac` per accepted request,
    # withdraw 1 per retry/hedge; `reserve` covers cold-start failover.
    # None fields fall back to MCIM_RETRY_BUDGET_FRAC / _RESERVE
    retry_budget_frac: float | None = None
    retry_budget_reserve: float | None = None
    # hedged requests on the idempotent chain lane: a first attempt
    # still pending past hedge_delay_frac x (federated e2e p99) gets ONE
    # secondary forward to a different replica, first response wins;
    # hedges withdraw from the retry budget and are capped at
    # hedge_max_frac of accepted requests. delay frac 0 disables. None
    # fields fall back to MCIM_HEDGE_DELAY_FRAC / MCIM_HEDGE_MAX_FRAC
    hedge_delay_frac: float | None = None
    hedge_max_frac: float | None = None


class Router:
    """The front door. `start()` binds the HTTP listener; replicas
    register themselves by heartbeating `POST /control/heartbeat`.

        POST /v1/process        proxied to a replica (see module doc).
                                With X-MCIM-Pipeline/?pipeline=: the
                                graph lane — sticky on (tenant,
                                pipeline, bucket), headers forwarded,
                                stored specs re-pushed to replicas
                                whose heartbeat lacks the id
        POST /v1/pipelines      validate + store + broadcast a pipeline
                                spec to every routable replica (graph/)
        POST /v1/tenants        tenant QoS/quota config, same broadcast
        POST /v1/session/<sid>/frame
                                live video frame: sticky session routing
                                with journal-tail failover replay
                                (fabric/session.py)
        POST /control/heartbeat replica state push (fabric/control.py);
                                the ack carries drain/resync flags
        GET|POST /control/canary
                                canary gate status / deploy / abort
                                (fabric/canary.py)
        GET  /control/tune      tune controller status: current arm,
                                in-flight proposal, recent decisions
                                (tune/controller.py; Fabric tune=True)
        POST /control/profile   on-demand fleet profiling: relay a
                                rate-limited torch.profiler capture to one
                                replica under live traffic; the merged
                                host+device artifact path rides back
                                (obs/profile.capture_live)
        GET  /healthz           200 while >=1 routable fresh replica
        GET  /stats             replica table + routing counters (JSON)
        GET  /metrics           Prometheus exposition (mcim_fabric_*)
        GET  /slo               SLO burn-rate engine status (obs/slo.py)
    """

    def __init__(
        self,
        config: RouterConfig,
        *,
        registry: Registry | None = None,
        mesh_lane=None,
        clock=time.monotonic,
    ):
        self.config = config
        self.buckets = tuple(config.buckets)
        self.stale_s = (
            float(env_registry.get(ENV_STALE_S))
            if config.stale_s is None
            else config.stale_s
        )
        self.forward_timeout_s = (
            float(env_registry.get(ENV_FORWARD_TIMEOUT_S))
            if config.forward_timeout_s is None
            else config.forward_timeout_s
        )
        self.forward_attempts = (
            int(env_registry.get(ENV_FORWARD_ATTEMPTS))
            if config.forward_attempts is None
            else config.forward_attempts
        )
        self.shed_frac = (
            float(env_registry.get(ENV_SHED_FRAC))
            if config.shed_frac is None
            else config.shed_frac
        )
        self.table = ReplicaTable()
        self.breakers = BreakerBoard(
            failure_threshold=config.breaker_threshold,
            reset_timeout_s=config.breaker_reset_s,
        )
        # replicas the control plane is DRAINING (autoscaler scale-down):
        # routing stops here immediately, and the next heartbeat ack
        # carries drain=true so the replica stops admitting end to end
        self._draining: set[str] = set()
        self._draining_lock = threading.Lock()
        # canary rollback gate (fabric/canary.py); the Fabric wires the
        # deploy/rollback callbacks (it owns the replica processes)
        self.canary = fabric_canary.CanaryGate(config.canary, clock=clock)
        self.on_canary_deploy = None  # callable(flip: dict) -> replica_id
        self.on_canary_rollback = None  # callable(status: dict) -> None
        self._canary_rollback_handled = False
        # continuous autotuning (tune/controller.py); the Fabric wires a
        # TuneController here when started with tune=True — the router
        # only exposes its status (the controller drives canary_deploy
        # through the same hooks as an operator flip)
        self.tuner = None
        # live video sessions (fabric/session.py): sticky affinity +
        # journal-tail failover
        self.sessions = fabric_session.SessionTable()
        # pipeline-service state (graph/): specs registered THROUGH this
        # front door, keyed (tenant, pipeline id), plus tenant configs.
        # The router re-pushes a stored spec to any replica whose
        # heartbeat lacks the id before forwarding to it — so replica
        # restarts and late joiners reconverge without client retries.
        self._graph_lock = threading.Lock()
        self.graph_specs: dict[tuple[str, str], dict] = {}
        self.graph_tenants: dict[str, dict] = {}
        # (replica id, incarnation) -> tenants whose config this exact
        # process has received: tenant configs have no heartbeat echo
        # (unlike pipelines), so the re-push bookkeeping lives here — a
        # restart changes the incarnation and naturally re-pushes
        self._tenant_pushed: dict[tuple[str, str], set[str]] = {}
        # systolic lane state: compiled-program cache (compile_graph is
        # pure Python — cheap, but not per-request cheap) + the last
        # placement per pipeline for /stats
        self.systolic = config.systolic
        self.systolic_min_steps = int(
            env_registry.get(graph_systolic.ENV_MIN_STEPS)
        )
        self._systolic_programs: dict[tuple[str, str], object] = {}
        self._systolic_last: dict[str, dict] = {}
        # set by the Fabric when the elastic loop is armed (status only)
        self.autoscaler = None
        self.mesh_lane = mesh_lane
        # federation uplink (federation/): armed by federate() — this
        # router then represents its whole pod to a front door, pushing
        # pod-aggregate heartbeats and applying quota leases from acks
        self._fed_sender = None
        self._fed_pod_id: str | None = None
        self._fed_incarnation: str | None = None
        self._fed_source = None
        self._pool = _ConnPool(self.forward_timeout_s)
        self._clock = clock
        # request lifecycle (resilience/deadline.py): this tier's retry
        # budget + hedging knobs. The hedge worker pool is lazy — only
        # a router that actually hedges pays the threads.
        self.retry_budget = deadline_mod.RetryBudget(
            frac=(
                float(env_registry.get(deadline_mod.ENV_BUDGET_FRAC))
                if config.retry_budget_frac is None
                else config.retry_budget_frac
            ),
            reserve=(
                float(env_registry.get(deadline_mod.ENV_BUDGET_RESERVE))
                if config.retry_budget_reserve is None
                else config.retry_budget_reserve
            ),
        )
        self.hedge_delay_frac = (
            float(env_registry.get(deadline_mod.ENV_HEDGE_DELAY_FRAC))
            if config.hedge_delay_frac is None
            else config.hedge_delay_frac
        )
        self.hedge_max_frac = (
            float(env_registry.get(deadline_mod.ENV_HEDGE_MAX_FRAC))
            if config.hedge_max_frac is None
            else config.hedge_max_frac
        )
        self._hedge_lock = threading.Lock()
        self._hedge_pool = None
        self._hedges_fired = 0
        self._hedge_delay_cache: tuple[float, float | None] = (-1e18, None)
        self.registry = registry or Registry()
        # metrics federation (obs/fleet.py): per-replica registries fold
        # into this view via heartbeat deltas; staleness shares the
        # routing liveness window so "routable" and "counted" agree
        self.fleet = obs_fleet.FleetAggregator(
            stale_s=self.stale_s, clock=clock
        )
        self._fleet_scraped_at: dict[str, float] = {}
        # SLO burn-rate engine over the fleet view (obs/slo.py); the
        # ticker thread starts with the router
        self.slo = obs_slo.SLOEngine(
            obs_slo.parse_slo_specs(
                config.slo_specs
                if config.slo_specs is not None
                else env_registry.get(obs_slo.ENV_SPECS)
            ),
            obs_slo.fleet_slo_source(self.fleet.merged),
            fast_s=config.slo_fast_s,
            slow_s=config.slo_slow_s,
            tick_s=config.slo_tick_s,
            burn_threshold=config.slo_burn_threshold,
            registry=self.registry,
            clock=clock,
        )
        self._register_metrics()
        self.httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._closed = False
        self._log = get_logger()

    # -- metrics -----------------------------------------------------------

    def _register_metrics(self) -> None:
        r = self.registry
        self._m_requests = r.counter(
            "mcim_fabric_requests_total",
            "Front-door requests by terminal status.",
            labels=("status",),
        )
        self._m_forwards = r.counter(
            "mcim_fabric_forwards_total",
            "Proxy attempts per replica, by outcome (ok/http_error/"
            "net_error).",
            labels=("replica", "outcome"),
        )
        self._m_retries = r.counter(
            "mcim_fabric_forward_retries_total",
            "Requests re-forwarded to another replica after a failed "
            "attempt (attempt 2+ each counts once).",
        )
        self._m_route = r.counter(
            "mcim_fabric_route_total",
            "Routing decisions by policy (sticky/least_loaded/mesh).",
            labels=("policy",),
        )
        self._m_heartbeats = r.counter(
            "mcim_fabric_heartbeats_total",
            "Heartbeats accepted per replica.",
            labels=("replica",),
        )
        self._m_forward_s = r.histogram(
            "mcim_fabric_forward_seconds",
            "Router->replica proxy time per successful attempt.",
        )
        # request-lifecycle accounting (resilience/deadline.py)
        self._m_deadline = deadline_mod.expired_counter(r)
        self._m_budget_denied = deadline_mod.budget_denied_counter(r)
        self._m_hedges = deadline_mod.hedge_counter(r)
        # -- pipeline service (graph/) --------------------------------------
        self._m_graph_pushes = r.counter(
            "mcim_fabric_graph_pushes_total",
            "Pipeline specs re-pushed to a replica whose heartbeat "
            "lacked the id (restart/late-join reconvergence).",
        )
        r.gauge(
            "mcim_fabric_graph_specs",
            "(tenant, pipeline) specs registered through this router.",
            fn=lambda: float(len(self.graph_specs)),
        )
        # -- pod-level systolic execution (graph/systolic.py) ---------------
        self._m_sys_requests = r.counter(
            "mcim_systolic_requests_total",
            "Graph requests dispatched on the stage-sharded lane, by "
            "terminal outcome (ok = final owner's response relayed; "
            "refused = the entry owner's own 4xx/shed relayed verbatim).",
            labels=("status",),
        )
        self._m_sys_placed = r.counter(
            "mcim_systolic_stages_placed_total",
            "Step ranges placed onto stage owners (one per owner per "
            "placed request).",
        )
        self._m_sys_fallbacks = r.counter(
            "mcim_systolic_fallbacks_total",
            "Graph requests answered on the pinned-replica lane "
            "instead, by reason (graph/systolic.FALLBACK_REASONS — a "
            "closed vocabulary enforced at the count_fallback choke "
            "point).",
            labels=("reason",),
        )
        # -- on-demand fleet profiling (obs/profile.capture_live) -----------
        self._m_profile = r.counter(
            "mcim_fabric_profile_captures_total",
            "On-demand replica profile captures relayed through the "
            "front door, by outcome (ok/rate_limited/error).",
            labels=("outcome",),
        )
        # -- canary rollback gate (fabric/canary.py) ------------------------
        self._m_canary = r.counter(
            "mcim_fabric_canary_requests_total",
            "Canary-gate outcomes by lane (canary/stable) and result "
            "(ok/bad).",
            labels=("lane", "result"),
        )
        self._m_canary_shadow = r.counter(
            "mcim_fabric_canary_shadow_total",
            "Shadow digest spot checks by result (match/mismatch).",
            labels=("result",),
        )
        self._m_canary_rollbacks = r.counter(
            "mcim_fabric_canary_rollbacks_total",
            "Config flips auto-reverted by the rollback gate.",
        )
        r.gauge(
            "mcim_fabric_canary_active",
            "1 while a canary flip is under evaluation.",
            fn=lambda: (
                1.0 if self.canary.state == fabric_canary.CANARY else 0.0
            ),
        )
        # -- live video sessions (fabric/session.py) ------------------------
        self._m_session_frames = r.counter(
            "mcim_fabric_session_frames_total",
            "Session frames through the front door by outcome "
            "(ok/unavailable/error).",
            labels=("outcome",),
        )
        self._m_session_failovers = r.counter(
            "mcim_fabric_session_failovers_total",
            "Live sessions rebound to a new replica with journal-tail "
            "replay after their replica died or drained.",
        )
        self._m_session_replayed = r.counter(
            "mcim_fabric_session_replayed_frames_total",
            "Journal-tail frames replayed to rebuild temporal rings on "
            "a replacement replica.",
        )
        r.gauge(
            "mcim_fabric_sessions_live",
            "Video sessions the router currently tracks.",
            fn=lambda: float(len(self.sessions.sessions())),
        )
        r.gauge(
            "mcim_fabric_replicas_draining",
            "Replicas the control plane is draining (routing stopped, "
            "SIGTERM pending on empty queue).",
            fn=lambda: float(len(self.draining_ids())),
        )
        r.gauge(
            "mcim_fabric_replica_serving",
            "1 when the replica is fresh and routable (serving/degraded), "
            "0 otherwise.",
            labels=("replica",),
            fn=self._serving_gauge,
        )
        r.gauge(
            "mcim_fabric_replica_queue_depth",
            "Last-heartbeat admission-queue fill per replica.",
            labels=("replica",),
            fn=lambda: {
                (v.replica_id,): float(v.hb.queued)
                for v in self.table.views()
            },
        )
        r.gauge(
            "mcim_fabric_replicas_routable",
            "Count of fresh serving/degraded replicas.",
            fn=lambda: float(len(self._routable())),
        )
        r.gauge(
            "mcim_fabric_breaker_open_events",
            "Cumulative router-side replica-breaker trips.",
            fn=lambda: float(self.breakers.snapshot()["open_events"]),
        )
        # -- fleet federation health (obs/fleet.py) -------------------------
        r.gauge(
            "mcim_fleet_replicas",
            "Replicas currently contributing to the federated view.",
            fn=lambda: float(len(self.fleet.fresh_ids())),
        )
        r.gauge(
            "mcim_fleet_snapshot_age_seconds",
            "Seconds since each replica's metrics snapshot last advanced.",
            labels=("replica",),
            fn=lambda: {
                (rid,): age for rid, age in self.fleet.ages().items()
            },
        )
        r.gauge(
            "mcim_fleet_applied_deltas",
            "Heartbeat metrics deltas folded into the fleet view.",
            fn=lambda: float(self.fleet.applied_deltas),
        )
        r.gauge(
            "mcim_fleet_full_syncs",
            "Full snapshots applied (first beats, resyncs, scrapes).",
            fn=lambda: float(self.fleet.full_syncs),
        )
        r.gauge(
            "mcim_fleet_resyncs",
            "Heartbeat deltas refused for a stale baseline (the ack asked "
            "the replica to resend full).",
            fn=lambda: float(self.fleet.resyncs),
        )

    def _serving_gauge(self) -> dict:
        now = self._clock()
        return {
            (v.replica_id,): (
                1.0
                if v.fresh(now, self.stale_s) and v.hb.state in _ROUTABLE
                else 0.0
            )
            for v in self.table.views()
        }

    # -- drain control (autoscaler scale-down) -----------------------------

    def mark_draining(self, replica_id: str) -> None:
        """Stop routing to this replica NOW; its next heartbeat ack
        carries drain=true so the replica flips its health machine to
        draining (admission refused end to end). Its live sessions
        rebind with tail replay on their next frame."""
        with self._draining_lock:
            self._draining.add(replica_id)
        self._log.info("draining %s: routing stopped", replica_id)

    def unmark_draining(self, replica_id: str) -> None:
        with self._draining_lock:
            self._draining.discard(replica_id)

    def draining_ids(self) -> list[str]:
        with self._draining_lock:
            return sorted(self._draining)

    def _is_draining(self, replica_id: str) -> bool:
        with self._draining_lock:
            return replica_id in self._draining

    # -- routing policy ----------------------------------------------------

    def _routable(self) -> list[ReplicaView]:
        now = self._clock()
        with self._draining_lock:
            draining = set(self._draining)
        return [
            v
            for v in self.table.views()
            if v.fresh(now, self.stale_s)
            and v.hb.state in _ROUTABLE
            and v.replica_id not in draining
        ]

    def route(
        self, bucket: str, *, affinity_key: str | None = None,
        prefer_warm: bool = True,
    ) -> tuple[list[ReplicaView], str]:
        """Ordered forward candidates for a "HxW" bucket + the policy
        label. Pure over the current table snapshot (unit-testable).

        `affinity_key` overrides the rendezvous-hash key: graph requests
        sticky on (tenant, pipeline id, bucket) so one tenant-pipeline's
        built functions concentrate on one replica per bucket
        (`prefer_warm=False` there — chain-cache warmth says nothing
        about graph functions)."""
        live = self._routable()
        if not live:
            return [], "none"
        warm = (
            [v for v in live if bucket in v.hb.warm_buckets]
            if prefer_warm
            else []
        )
        pool = warm or live
        sticky = max(
            pool,
            key=lambda v: _rendezvous_score(
                affinity_key or bucket, v.replica_id
            ),
        )
        sticky_ok = (
            sticky.hb.state == "serving"
            and bucket not in sticky.hb.breaker_open
            and sticky.load_frac() < self.shed_frac
        )
        rest = sorted(
            (v for v in live if v.replica_id != sticky.replica_id),
            key=lambda v: (
                # a replica with THIS bucket's breaker open or in degraded
                # state is a last resort, then least-loaded first
                bucket in v.hb.breaker_open,
                v.hb.state != "serving",
                v.load_frac(),
            ),
        )
        if sticky_ok:
            return [sticky] + rest, "sticky"
        return rest + [sticky], "least_loaded"

    # -- request path ------------------------------------------------------

    @staticmethod
    def _sniff_dims(data: bytes) -> tuple[int, int]:
        """(h, w) from the image header only — the proxy path must not pay
        a full decode (or even a PIL import) for routing. PNG is the wire
        format, so its fixed-offset IHDR is read directly; anything else
        falls back to PIL's lazy header parse."""
        if data[:8] == _PNG_MAGIC and data[12:16] == b"IHDR":
            w = int.from_bytes(data[16:20], "big")
            h = int.from_bytes(data[20:24], "big")
            if h > 0 and w > 0:
                return h, w
        from PIL import Image

        with Image.open(_io.BytesIO(data)) as im:
            w, h = im.size
        return h, w

    def handle_process(
        self, body: bytes, headers, query: dict | None = None
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        """One front-door request -> (status, content_type, body, extra
        headers). Runs on the HTTP handler thread. A request carrying a
        pipeline id (X-MCIM-Pipeline header or ?pipeline=) takes the
        graph lane: sticky affinity on (tenant, pipeline, bucket), the
        tenant + pipeline headers forwarded verbatim, and a stored-spec
        re-push to any replica whose heartbeat lacks the id."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.service import (
            HDR_PIPELINE,
            HDR_TENANT,
        )

        q = query or {}

        def _pick(hname: str, qname: str) -> str:
            v = headers.get(hname)
            if v:
                return v
            vals = q.get(qname)
            return vals[0] if vals else ""

        tenant = _pick(HDR_TENANT, "tenant") or "default"
        pipeline = _pick(HDR_PIPELINE, "pipeline")
        # the federation identity thread: a front door stamps X-Fed-Pod
        # on its forward; the pod router relays it replica-deep so the
        # serving process can echo which pod carried the request
        fed_pod = headers.get(fed_control.HDR_FED_POD) or ""
        # the deadline chain (resilience/deadline.py): re-anchor the
        # remaining budget from the wire on this process's clock; a
        # request already dead answers 504 before any replica burns on it
        dl = deadline_mod.from_headers(headers, clock=self._clock)
        if dl is not None and dl.expired():
            deadline_mod.count_expired(self._m_deadline, "router")
            self._m_requests.inc(status="deadline_expired")
            return _json_response(
                504, deadline_mod.expired_response_body()
            )
        try:
            h, w = self._sniff_dims(body)
        except Exception as e:
            self._m_requests.inc(status="rejected")
            return _json_response(400, {"error": f"undecodable image: {e}"})
        if pipeline:
            return self._handle_graph_process(
                body, tenant, pipeline, h, w, fed_pod=fed_pod, deadline=dl
            )
        picked = bucketing.pick_bucket(h, w, self.buckets)
        if picked is None:
            if self.mesh_lane is not None:
                return self._dispatch_mesh(body, h, w)
            self._m_requests.inc(status="rejected")
            big = self.buckets[-1]
            return _json_response(
                400,
                {
                    "error": (
                        f"image {h}x{w} exceeds the largest bucket "
                        f"{big[0]}x{big[1]} and no mesh lane is configured"
                    )
                },
            )
        bucket = f"{picked[0]}x{picked[1]}"
        candidates, policy = self.route(bucket)
        if not candidates:
            self._m_requests.inc(status="unavailable")
            return _json_response(
                503,
                {"error": "no replica is serving", "status": "unavailable"},
                extra=[("Retry-After", "1")],
            )
        mode, canary_view, candidates = self._apply_canary(candidates)
        if not candidates and mode != "shadow":
            # the canary slice never strands a request: with no stable
            # replica left the canary itself is the only door
            candidates = [canary_view] if canary_view is not None else []
        self._m_route.inc(policy=policy)
        root = obs_trace.start_trace(
            "fabric.request", h=h, w=w, bucket=bucket, policy=policy
        )
        self.retry_budget.deposit()
        if mode == "shadow":
            code, ctype, out, extra = self._shadow_forward(
                root, bucket, body, canary_view, candidates
            )
        else:
            code, ctype, out, extra = self._forward_with_retries(
                root, bucket, body, candidates,
                extra_headers=(
                    ((fed_control.HDR_FED_POD, fed_pod),) if fed_pod else ()
                ),
                deadline=dl,
                # the chain lane is idempotent by construction (pure
                # image in -> image out), so it may hedge the tail
                hedge=True,
            )
        self._m_requests.inc(
            status=_STATUS_LABEL.get(code, "error" if code >= 500 else "ok")
        )
        root.set(status=code)
        root.end()
        if root.trace_id:
            extra = extra + [("X-Trace-Id", root.trace_id)]
        return code, ctype, out, extra

    def _forward_with_retries(
        self,
        root,
        bucket: str,
        body: bytes,
        candidates: list[ReplicaView],
        *,
        extra_headers: tuple[tuple[str, str], ...] = (),
        before_forward=None,
        admission_shed_is_final: bool = False,
        deadline: deadline_mod.Deadline | None = None,
        hedge: bool = False,
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        """Walk the replica candidates until one answers. Deadline-honest
        and retry-bounded (resilience/deadline.py): the remaining budget
        is re-checked before every attempt (an expired request answers
        504 HERE, never burns a replica), each forward carries the
        remainder on the wire, attempt 2+ must withdraw from the retry
        budget (a refused withdrawal gives up with the best answer so
        far), and — on the idempotent chain lane (`hedge=True`) — a
        first attempt still pending past the p99-based hedge delay gets
        one secondary forward to the next candidate, first response
        wins."""
        attempts = 0
        last: tuple[int, str, bytes, list] | None = None
        hedge_delay = self._hedge_delay_s() if hedge else None
        for ci, view in enumerate(candidates):
            if attempts >= self.forward_attempts:
                break
            if deadline is not None and deadline.expired():
                deadline_mod.count_expired(self._m_deadline, "router")
                self._m_requests.inc(status="deadline_expired")
                return _json_response(
                    504, deadline_mod.expired_response_body()
                )
            rid = view.replica_id
            breaker = self.breakers.get(rid)
            if not breaker.allow():
                continue  # routed around for the breaker window
            attempts += 1
            if attempts > 1:
                if not self.retry_budget.try_withdraw():
                    deadline_mod.count_budget_denied(
                        self._m_budget_denied, "router"
                    )
                    break  # give up with the best answer so far
                self._m_retries.inc()
                obs_trace.event(
                    "fabric.retry", parent=root.context(),
                    attempt=attempts, replica=rid,
                )
            fwd_extra = extra_headers
            if deadline is not None:
                # remaining-budget form, recomputed PER ATTEMPT so the
                # wire always carries what is actually left
                fwd_extra = tuple(fwd_extra) + (
                    (deadline_mod.HEADER, deadline.header_value()),
                )
            t0 = self._clock()
            try:
                with obs_trace.span(
                    "fabric.forward", parent=root.context(), replica=rid
                ):
                    failpoints.maybe_fail(
                        "router.forward", replica=rid, attempt=attempts
                    )
                    if before_forward is not None:
                        # graph lane: converge the replica's pipeline
                        # registry first (spec re-push); a push failure
                        # is a net-error-class miss — next candidate
                        before_forward(view)
                    if hedge_delay is not None and attempts == 1:
                        (
                            code, ctype, out, fwd_hdrs, rid, extra_fwds,
                        ) = self._forward_maybe_hedged(
                            view, candidates[ci + 1:], body,
                            root.trace_id, fwd_extra, hedge_delay,
                        )
                        attempts += extra_fwds
                        breaker = self.breakers.get(rid)
                    else:
                        code, ctype, out, fwd_hdrs = self._forward_once(
                            view, body, root.trace_id,
                            extra_headers=fwd_extra,
                        )
            except Exception as e:
                # connection-class failure: the replica is gone or wedged —
                # feed its breaker and move on to the next candidate
                breaker.on_failure()
                self._maybe_breaker_dump(rid, breaker)
                self._m_forwards.inc(replica=rid, outcome="net_error")
                self._canary_record(rid, False)
                self._log.warning(
                    "forward to %s failed (%s: %s)",
                    rid, type(e).__name__, str(e)[:120],
                )
                continue
            # a 422 from the CANARY replica is a flip signal, not a
            # poison-request verdict: the flip itself may be what breaks
            # the request, so the gate counts it bad and the client gets
            # the stable answer instead (stable 422s stay final — the
            # quarantine contract is per-request there)
            canary_quarantine = (
                code == 422
                and self.canary.state == fabric_canary.CANARY
                and rid == self.canary.replica_id
            )
            if (
                admission_shed_is_final
                and code == 503
                and _is_admission_shed(out)
            ):
                # a tenant-level admission verdict (quota window / QoS
                # ladder — the graph lane's {"status": "shed"} body):
                # rerouting it to a sibling would multiply the tenant's
                # budget by the replica count, so it relays as FINAL.
                # Drain/stopped 503s keep rerouting — those are about
                # the replica, not the tenant.
                self._m_forwards.inc(replica=rid, outcome="ok")
                return (
                    code, ctype, out,
                    [("X-Fabric-Replica", rid)] + fwd_hdrs,
                )
            if code == 504:
                # a downstream deadline_expired verdict is FINAL: the
                # request's budget is gone everywhere, so rerouting it
                # would burn another replica on work the caller already
                # abandoned. Not a replica-health signal either — the
                # deadline died, not the server.
                breaker.on_success()
                self._m_forwards.inc(replica=rid, outcome="http_error")
                return (
                    code, ctype, out,
                    [
                        ("X-Fabric-Replica", rid),
                        ("X-Fabric-Attempts", str(attempts)),
                    ]
                    + fwd_hdrs,
                )
            if code in (429, 503) or code >= 500 or canary_quarantine:
                # the replica answered but couldn't take it: 429 means
                # alive-but-full and 503 not-admitting (a draining
                # scale-down victim in its last heartbeat window — no
                # breaker signal, no canary signal, load shedding is not
                # a config defect; the next candidate may well take it),
                # 5xx feeds both
                if code >= 500:
                    breaker.on_failure()
                    self._maybe_breaker_dump(rid, breaker)
                if code >= 500 or canary_quarantine:
                    self._canary_record(rid, False)
                self._m_forwards.inc(replica=rid, outcome="http_error")
                # a relayed shed keeps its retry-later semantics: the
                # replica's 429/503 carried Retry-After (passed through
                # with its REAL value — a quota window's remainder, not
                # a router guess), and stripping it would turn an
                # explicit shed into apparent downtime in every
                # client's accounting
                shed_hdr = (
                    [("Retry-After", "1")]
                    if code in (429, 503)
                    and not any(k == "Retry-After" for k, _ in fwd_hdrs)
                    else []
                )
                last = (
                    code, ctype, out,
                    [("X-Fabric-Replica", rid)] + fwd_hdrs + shed_hdr,
                )
                continue
            breaker.on_success()
            self._m_forwards.inc(replica=rid, outcome="ok")
            self._canary_record(rid, True)
            # exemplar: the proxy-time histogram keeps this request's
            # trace id per bucket, so a forward-latency spike in the
            # exposition pulls up the exact router->replica trace
            self._m_forward_s.observe(
                self._clock() - t0, exemplar=root.trace_id or None
            )
            return (
                code, ctype, out,
                [
                    ("X-Fabric-Replica", rid),
                    ("X-Fabric-Attempts", str(attempts)),
                ]
                + fwd_hdrs,
            )
        if last is not None:
            # every candidate was tried; surface the most recent replica
            # answer (e.g. pod-wide 429) rather than masking it as 503
            return last
        return _json_response(
            503,
            {"error": "no replica accepted the request",
             "status": "unavailable"},
            extra=[("Retry-After", "1")],
        )

    def _maybe_breaker_dump(self, rid: str, breaker) -> None:
        """A router-side replica breaker that is (now) open is a
        post-mortem moment: dump the flight recorder (rate-limited per
        trigger, so a dead replica's retry storm writes one artifact)."""
        if breaker.state == "open":
            flight_recorder.dump(
                "breaker_open", extra={"scope": "router", "replica": rid}
            )

    # -- hedged forwards (resilience/deadline.py) --------------------------

    def _ensure_hedge_pool(self):
        with self._hedge_lock:
            if self._hedge_pool is None:
                self._hedge_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="mcim-hedge"
                )
            return self._hedge_pool

    def _hedge_delay_s(self) -> float | None:
        """The current hedge trigger delay: MCIM_HEDGE_DELAY_FRAC of the
        federated p99, cached for 1s (fleet_p99 merges every replica's
        histogram — too heavy per request). None = don't hedge (disabled
        or the fleet has no latency data yet)."""
        if self.hedge_delay_frac <= 0.0:
            return None
        now = self._clock()
        cached_at, cached = self._hedge_delay_cache
        if now - cached_at < 1.0:
            return cached
        try:
            p99 = self.fleet_p99().get("p99_s")
        except Exception:
            p99 = None
        delay = deadline_mod.hedge_delay_s(p99, self.hedge_delay_frac)
        self._hedge_delay_cache = (now, delay)
        return delay

    def _book_hedge_loser(self, view: ReplicaView):
        """Done-callback for the hedge leg that lost: its answer still
        feeds the breaker and forward accounting — a hedge must never
        make a replica's failures invisible."""

        def _cb(fut) -> None:
            rid = view.replica_id
            breaker = self.breakers.get(rid)
            try:
                code = fut.result()[0]
            except Exception:
                breaker.on_failure()
                self._maybe_breaker_dump(rid, breaker)
                self._m_forwards.inc(replica=rid, outcome="net_error")
                return
            if code >= 500 and code != 504:
                breaker.on_failure()
                self._maybe_breaker_dump(rid, breaker)
            else:
                breaker.on_success()
            self._m_forwards.inc(
                replica=rid,
                outcome="ok" if code < 400 else "http_error",
            )

        return _cb

    def _forward_maybe_hedged(
        self,
        view: ReplicaView,
        rest: list[ReplicaView],
        body: bytes,
        trace_id: str,
        extra_headers: tuple[tuple[str, str], ...],
        delay_s: float,
    ) -> tuple[int, str, bytes, list, str, int]:
        """First forward attempt with a tail hedge: if the primary is
        still pending after `delay_s` (a fraction of the federated p99),
        fire ONE secondary to the next routable candidate; the first
        usable response wins. Hedges withdraw from the retry budget and
        are capped at MCIM_HEDGE_MAX_FRAC of accepted requests, so the
        tail-chasing extra load is bounded like every other retry.

        Returns (code, ctype, out, fwd_hdrs, winner_replica_id,
        extra_forwards); raises the primary's exception if no leg
        produced a response. The caller books the winner's breaker /
        forward metrics as usual; the losing leg books itself via a done
        callback."""
        pool = self._ensure_hedge_pool()
        primary = pool.submit(
            self._forward_once, view, body, trace_id,
            extra_headers=extra_headers,
        )
        try:
            code, ctype, out, fwd_hdrs = primary.result(timeout=delay_s)
            return code, ctype, out, fwd_hdrs, view.replica_id, 0
        except concurrent.futures.TimeoutError:
            pass
        # the primary is past the hedge delay — find a different
        # routable replica to race it against
        second = next(
            (
                v for v in rest
                if v.replica_id != view.replica_id
                and self.breakers.get(v.replica_id).allow()
            ),
            None,
        )
        fire = second is not None
        if fire:
            with self._hedge_lock:
                cap = self.hedge_max_frac * max(
                    1.0, float(self.retry_budget.deposits)
                )
                if self._hedges_fired + 1 > cap:
                    fire = False
                else:
                    self._hedges_fired += 1
            if not fire:
                deadline_mod.count_hedge(self._m_hedges, "suppressed_cap")
            elif not self.retry_budget.try_withdraw():
                with self._hedge_lock:
                    self._hedges_fired -= 1
                deadline_mod.count_hedge(
                    self._m_hedges, "suppressed_budget"
                )
                fire = False
        if not fire:
            # no sibling / cap / budget: just wait out the primary
            code, ctype, out, fwd_hdrs = primary.result()
            return code, ctype, out, fwd_hdrs, view.replica_id, 0
        obs_trace.event(
            "fabric.hedge", primary=view.replica_id,
            secondary=second.replica_id, delay_s=round(delay_s, 4),
        )
        secondary = pool.submit(
            self._forward_once, second, body, trace_id,
            extra_headers=extra_headers,
        )
        legs = {primary: view, secondary: second}
        results: dict = {}
        pending = set(legs)
        winner = None
        while pending and winner is None:
            done, pending = concurrent.futures.wait(
                pending,
                return_when=concurrent.futures.FIRST_COMPLETED,
            )
            for fut in done:
                try:
                    results[fut] = ("ok", fut.result())
                except Exception as e:
                    results[fut] = ("err", e)
            for fut in (primary, secondary):  # primary-first: stable
                got = results.get(fut)
                if got is None or got[0] != "ok":
                    continue
                code = got[1][0]
                # usable = final for the request: not a shed/retryable
                # error (those fall back to the outer reroute loop),
                # where 504 counts as final (deadline verdicts relay)
                if code not in (429, 503) and (code < 500 or code == 504):
                    winner = fut
                    break
        if winner is not None:
            loser = secondary if winner is primary else primary
            loserv = legs[loser]
            loser.add_done_callback(self._book_hedge_loser(loserv))
            if winner is primary:
                deadline_mod.count_hedge(self._m_hedges, "lost")
            else:
                deadline_mod.count_hedge(self._m_hedges, "won")
            code, ctype, out, fwd_hdrs = results[winner][1]
            return (
                code, ctype, out, fwd_hdrs,
                legs[winner].replica_id, 1,
            )
        # both legs finished, neither final: book the secondary here and
        # surface the primary's outcome to the outer loop (which owns
        # the primary's breaker / reroute bookkeeping)
        deadline_mod.count_hedge(self._m_hedges, "lost")
        secondary.add_done_callback(self._book_hedge_loser(second))
        kind, payload = results[primary]
        if kind == "err":
            raise payload
        code, ctype, out, fwd_hdrs = payload
        return code, ctype, out, fwd_hdrs, view.replica_id, 1

    def _forward_once(
        self,
        view: ReplicaView,
        body: bytes,
        trace_id: str,
        *,
        extra_headers: tuple[tuple[str, str], ...] = (),
    ) -> tuple[int, str, bytes]:
        """One proxy attempt: POST the body to the replica, read fully.
        Connections are pooled (HTTP/1.1 keep-alive); an error closes the
        socket instead of returning it. `extra_headers` rides the graph
        lane's tenant + pipeline identity to the replica verbatim.
        Returns (status, content type, body, pass-through headers) — the
        replica's Retry-After (the REAL quota-window remainder, not a
        router guess) and the graph side-output headers survive the hop."""
        addr = view.hb.addr or "127.0.0.1"
        port = view.hb.port
        conn = self._pool.take(addr, port)
        try:
            hdrs = {"Content-Type": "application/octet-stream"}
            for k, v in extra_headers:
                hdrs[k] = v
            if trace_id:
                # the distributed-trace hop: the replica adopts this id as
                # its serve.request root, so both processes' exports join
                hdrs["X-Trace-Id"] = trace_id
            conn.request("POST", "/v1/process", body=body, headers=hdrs)
            resp = conn.getresponse()
            out = resp.read()
            ctype = resp.getheader("Content-Type", "application/json")
            passthrough = [
                (name, val)
                for name in (
                    "Retry-After", "X-MCIM-Histogram", "X-MCIM-Stats",
                )
                if (val := resp.getheader(name))
            ]
        except BaseException:
            conn.close()
            raise
        self._pool.give(addr, port, conn)
        return resp.status, ctype, out, passthrough

    def _dispatch_mesh(
        self, body: bytes, h: int, w: int
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        """The oversize lane: ONE request row-sharded over the mesh lane's
        slots in the router process (fabric/mesh.py)."""
        from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
            decode_image_bytes,
            encode_image_bytes,
        )

        self._m_route.inc(policy="mesh")
        root = obs_trace.start_trace(
            "fabric.request", h=h, w=w, bucket="mesh", policy="mesh"
        )
        try:
            with obs_trace.span("fabric.mesh", parent=root.context()):
                img = decode_image_bytes(body)
                out = self.mesh_lane.process(img)
            png = encode_image_bytes(out)
        except Exception as e:
            self._m_requests.inc(status="error")
            root.set(status=500)
            root.end()
            return _json_response(
                500, {"error": f"mesh dispatch failed: {e}"}
            )
        self._m_requests.inc(status="ok")
        root.set(status=200)
        root.end()
        extra = [("X-Fabric-Replica", "mesh")]
        if root.trace_id:
            extra.append(("X-Trace-Id", root.trace_id))
        return 200, "image/png", png, extra

    # -- pipeline service lane (graph/) ------------------------------------

    def _systolic_program(self, tenant: str, pipeline: str):
        """The compiled GraphProgram for a stored spec (placement needs
        its step structure + balancer weights), cached per (tenant,
        pipeline) — compile_graph is pure Python, but not per-request
        cheap. None when the spec never registered through this router."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.compile import (
            compile_graph,
            split_for_placement,
        )
        from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import parse_spec

        with self._graph_lock:
            prog = self._systolic_programs.get((tenant, pipeline))
            reg = self.graph_specs.get((tenant, pipeline))
        if prog is not None:
            return prog
        if reg is None:
            return None
        try:
            # the canonical systolic step form — plan='off' + stage
            # splitting, matching graph/service._sub_fn exactly so the
            # placement's step indices mean the same thing on the owners
            prog = split_for_placement(
                compile_graph(parse_spec(reg["spec"]), plan="off")
            )
        except Exception:
            return None
        with self._graph_lock:
            self._systolic_programs[(tenant, pipeline)] = prog
        return prog

    def _systolic_owners(self, tenant: str, pipeline: str):
        """Routable stage-owner candidates, rendezvous-ordered per
        pipeline so repeated requests land on the same owners (warm
        subrange executables), in a stable stage order."""
        views = [v for v in self._routable() if v.hb.systolic]
        views.sort(
            key=lambda v: _rendezvous_score(
                f"systolic|{tenant}|{pipeline}", v.replica_id
            ),
            reverse=True,
        )
        return views

    def _try_systolic(
        self, body: bytes, tenant: str, pipeline: str, h: int, w: int,
        deadline: deadline_mod.Deadline | None = None,
    ):
        """Attempt the stage-sharded lane for one graph request. Returns
        a complete HTTP response tuple, or None to fall back to the
        pinned-replica lane — every None counts exactly one closed-
        vocabulary fallback reason, and the failure-shaped reasons
        (owner_down / forward_failed) file a flight-recorder dump. A
        fallback re-dispatches the SAME body pinned, so a broken chain
        can slow an answer but never wrong it."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.compile import place_steps

        fall = self._m_sys_fallbacks
        program = self._systolic_program(tenant, pipeline)
        if program is None or len(program.steps) < self.systolic_min_steps:
            graph_systolic.count_fallback(fall, "ineligible")
            return None
        owners = self._systolic_owners(tenant, pipeline)
        if len(owners) < 2:
            graph_systolic.count_fallback(fall, "replicas")
            return None
        placement = place_steps(program, len(owners))
        if placement is None:
            graph_systolic.count_fallback(fall, "ineligible")
            return None
        owners = owners[: placement.n_ranges]
        try:
            for v in owners:
                self._ensure_graph_state(v, tenant, pipeline)
        except Exception as e:
            graph_systolic.count_fallback(fall, "owner_down")
            flight_recorder.dump(
                "systolic_fallback",
                extra={
                    "reason": "owner_down",
                    "tenant": tenant,
                    "pipeline": pipeline,
                    "error": f"{type(e).__name__}: {e}",
                },
            )
            return None
        root = obs_trace.start_trace(
            "fabric.systolic", tenant=tenant, pipeline=pipeline,
            h=h, w=w, owners=len(owners),
        )
        header = graph_systolic.encode_placement(
            tenant=tenant,
            pipeline=pipeline,
            ranges=placement.ranges,
            addrs=[
                f"{v.hb.addr or '127.0.0.1'}:{v.hb.port}" for v in owners
            ],
            trace_id=root.trace_id,
        )
        from mpi_cuda_imagemanipulation_tpu_torch.graph.service import (
            HDR_PIPELINE,
            HDR_TENANT,
        )

        sys_extra = (
            (HDR_TENANT, tenant),
            (HDR_PIPELINE, pipeline),
            (graph_systolic.HDR_PLAN, header),
        )
        if deadline is not None:
            # the stage chain inherits the remaining budget: the entry
            # owner's scheduler (and each stage handoff behind it) must
            # expire this request like any other
            sys_extra += ((deadline_mod.HEADER, deadline.header_value()),)
        try:
            code, ctype, out, passthrough = self._forward_once(
                owners[0], body, root.trace_id,
                extra_headers=sys_extra,
            )
        except Exception as e:
            root.set(status="owner_down")
            root.end()
            graph_systolic.count_fallback(fall, "owner_down")
            flight_recorder.dump(
                "systolic_fallback",
                extra={
                    "reason": "owner_down",
                    "tenant": tenant,
                    "pipeline": pipeline,
                    "owner": owners[0].replica_id,
                    "error": f"{type(e).__name__}: {e}",
                },
            )
            return None
        if code == 424 or (code >= 500 and code != 504):
            # a broken stage chain (entry answered systolic-broken, or
            # an owner died into a 5xx): rerun pinned — idempotent
            # compute, so the client still gets the bit-exact answer.
            # 504 stays FINAL: the deadline died, not the chain, and a
            # pinned rerun would burn replicas on abandoned work
            root.set(status="forward_failed", code=code)
            root.end()
            graph_systolic.count_fallback(fall, "forward_failed")
            flight_recorder.dump(
                "systolic_fallback",
                extra={
                    "reason": "forward_failed",
                    "tenant": tenant,
                    "pipeline": pipeline,
                    "owner": owners[0].replica_id,
                    "code": code,
                },
            )
            return None
        # 200 (relayed final response) or the entry owner's own
        # refusal/shed — either way the systolic lane answered
        self._m_sys_placed.inc(placement.n_ranges)
        self._m_sys_requests.inc(
            status="ok" if code == 200 else "refused"
        )
        self._m_requests.inc(
            status=_STATUS_LABEL.get(code, "error" if code >= 500 else "ok")
        )
        with self._graph_lock:
            self._systolic_last[pipeline] = {
                "tenant": tenant,
                "ranges": [list(r) for r in placement.ranges],
                "owners": [v.replica_id for v in owners],
                "weights": [
                    round(placement.range_weight(k), 3)
                    for k in range(placement.n_ranges)
                ],
                "source": placement.source,
            }
        root.set(status=code)
        root.end()
        extra = list(passthrough)
        if root.trace_id:
            extra.append(("X-Trace-Id", root.trace_id))
        return code, ctype, out, extra

    def _handle_graph_process(
        self, body: bytes, tenant: str, pipeline: str, h: int, w: int,
        fed_pod: str = "",
        deadline: deadline_mod.Deadline | None = None,
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        """The graph lane: sticky affinity keyed on (tenant, pipeline,
        bucket), tenant + pipeline headers forwarded verbatim, stored
        specs re-pushed to replicas whose heartbeat lacks the id. The
        canary gate does not slice this lane — a pipeline flip is its
        own deploy unit (the spec re-registers), not a replica config."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.service import (
            HDR_PIPELINE,
            HDR_TENANT,
        )

        picked = bucketing.pick_bucket(h, w, self.buckets)
        if picked is None:
            self._m_requests.inc(status="rejected")
            big = self.buckets[-1]
            return _json_response(
                400,
                {
                    "code": "bad-image",
                    "error": (
                        f"image {h}x{w} exceeds the largest bucket "
                        f"{big[0]}x{big[1]} (the mesh lane serves chains "
                        "only)"
                    ),
                },
            )
        bucket = f"{picked[0]}x{picked[1]}"
        if self.systolic:
            resp = self._try_systolic(
                body, tenant, pipeline, h, w, deadline=deadline
            )
            if resp is not None:
                return resp
        else:
            # knob accounting: every graph request lands in exactly one
            # lane, so fallbacks_total partitions the traffic even when
            # the mode is off
            graph_systolic.count_fallback(self._m_sys_fallbacks, "off")
        candidates, policy = self.route(
            bucket,
            affinity_key=f"{tenant}|{pipeline}|{bucket}",
            prefer_warm=False,
        )
        if not candidates:
            self._m_requests.inc(status="unavailable")
            return _json_response(
                503,
                {"error": "no replica is serving", "status": "unavailable"},
                extra=[("Retry-After", "1")],
            )
        self._m_route.inc(policy=policy)
        root = obs_trace.start_trace(
            "fabric.request", h=h, w=w, bucket=bucket, policy=policy,
            tenant=tenant, pipeline=pipeline,
        )
        # both lanes fund the SAME router budget: graph traffic earns
        # the retry headroom its own reroutes spend
        self.retry_budget.deposit()
        code, ctype, out, extra = self._forward_with_retries(
            root, bucket, body, candidates,
            extra_headers=(
                (HDR_TENANT, tenant), (HDR_PIPELINE, pipeline),
            )
            + (((fed_control.HDR_FED_POD, fed_pod),) if fed_pod else ()),
            before_forward=lambda v: self._ensure_graph_state(
                v, tenant, pipeline
            ),
            admission_shed_is_final=True,
            # the graph lane propagates the deadline but does NOT hedge:
            # DAG dispatch may carry side outputs / tenant accounting a
            # duplicate dispatch would double-bill
            deadline=deadline,
        )
        self._m_requests.inc(
            status=_STATUS_LABEL.get(code, "error" if code >= 500 else "ok")
        )
        root.set(status=code)
        root.end()
        if root.trace_id:
            extra = extra + [("X-Trace-Id", root.trace_id)]
        return code, ctype, out, extra

    def _push_json(self, view: ReplicaView, path: str, payload: dict):
        """POST one JSON control payload to a replica over the pooled
        proxy connection; (status, body) back, errors propagate."""
        addr = view.hb.addr or "127.0.0.1"
        port = view.hb.port
        conn = self._pool.take(addr, port)
        try:
            conn.request(
                "POST", path, body=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            out = resp.read()
        except BaseException:
            conn.close()
            raise
        self._pool.give(addr, port, conn)
        return resp.status, out

    def _ensure_graph_state(
        self, view: ReplicaView, tenant: str, pipeline: str
    ) -> None:
        """Converge one replica's graph state before a forward: push the
        stored spec when its heartbeat lacks the pipeline id, and push
        the stored tenant config when THIS incarnation has never
        received it (tenant configs have no heartbeat echo, so the
        bookkeeping is per (replica, incarnation) — a restart re-pushes
        both). Restart/late-join recovery, the graph analogue of warmup
        re-reporting the chain buckets."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.service import (
            PIPELINES_PATH,
            TENANTS_PATH,
        )

        inc_key = (view.replica_id, view.hb.incarnation)
        with self._graph_lock:
            reg = self.graph_specs.get((tenant, pipeline))
            tcfg = self.graph_tenants.get(tenant)
            need_tenant = (
                tcfg is not None
                and tenant not in self._tenant_pushed.get(inc_key, ())
            )
        need_spec = (
            reg is not None and pipeline not in (view.hb.pipelines or ())
        )
        # a pipeline never registered through this front door forwards
        # as-is: the replica may know it (direct registration), and its
        # structured unknown-pipeline refusal beats a router guess
        if not need_tenant and not need_spec:
            return
        if need_tenant:
            code, out = self._push_json(view, TENANTS_PATH, tcfg)
            if code != 200:
                raise RuntimeError(
                    f"tenant push to {view.replica_id} answered {code}: "
                    f"{out[:120]!r}"
                )
            self._note_tenant_pushed(view, tenant)
        if need_spec:
            code, out = self._push_json(view, PIPELINES_PATH, reg)
            if code != 200:
                raise RuntimeError(
                    f"spec push to {view.replica_id} answered {code}: "
                    f"{out[:120]!r}"
                )
        self._m_graph_pushes.inc()
        self._log.info(
            "graph: re-pushed %s/%s to %s (tenant=%s spec=%s)",
            tenant, pipeline, view.replica_id, need_tenant, need_spec,
        )

    def _note_tenant_pushed(self, view: ReplicaView, tenant: str) -> None:
        with self._graph_lock:
            self._tenant_pushed.setdefault(
                (view.replica_id, view.hb.incarnation), set()
            ).add(tenant)

    def handle_graph_register(self, body: bytes) -> tuple[int, dict]:
        """`POST /v1/pipelines` at the front door: validate HERE (the
        closed taxonomy — a malformed spec never costs a replica
        round-trip), store for re-push, broadcast to every routable
        replica, answer with the per-replica outcome."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.ir import dag_fingerprint
        from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import (
            SpecError,
            parse_spec,
        )

        try:
            try:
                payload = json.loads(body or b"null")
            except ValueError as e:
                raise SpecError(
                    "bad-json", f"body is not JSON: {e}"
                ) from None
            if not isinstance(payload, dict):
                raise SpecError(
                    "bad-root", "registration body must be an object"
                )
            spec = payload.get("spec", payload)
            tenant = payload.get("tenant") or "default"
            graph = parse_spec(spec)
        except SpecError as e:
            return (
                400 if e.code == "bad-json" else 422,
                {"status": "rejected", "code": e.code, "error": str(e)},
            )
        pid = dag_fingerprint(graph)
        reg = {"tenant": tenant, "spec": spec}
        with self._graph_lock:
            self.graph_specs[(tenant, pid)] = reg
        pushed: dict[str, object] = {}
        for v in self._routable():
            try:
                code, _out = self._push_json(v, "/v1/pipelines", reg)
                pushed[v.replica_id] = code
            except Exception as e:
                pushed[v.replica_id] = f"error: {type(e).__name__}"
        return 200, {
            "pipeline": pid,
            "tenant": tenant,
            "name": graph.name,
            "nodes": len(graph.nodes),
            "outputs": sorted(graph.outputs),
            "replicas": pushed,
        }

    def handle_graph_tenant(self, body: bytes) -> tuple[int, dict]:
        """`POST /v1/tenants` at the front door: validate, store for
        re-push, broadcast (same shape as spec registration)."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError
        from mpi_cuda_imagemanipulation_tpu_torch.graph.tenancy import (
            TenantConfig,
        )

        try:
            try:
                payload = json.loads(body or b"null")
            except ValueError as e:
                raise SpecError(
                    "bad-json", f"body is not JSON: {e}"
                ) from None
            if not isinstance(payload, dict):
                raise SpecError(
                    "bad-root", "tenant config must be an object"
                )
            TenantConfig(  # validation only; replicas hold the state
                tenant_id=payload.get("tenant", ""),
                qos=payload.get("qos", "standard"),
                quota_requests=payload.get("quota_requests"),
                quota_bytes=payload.get("quota_bytes"),
                window_s=payload.get("window_s"),
            )
        except SpecError as e:
            return (
                400 if e.code == "bad-json" else 422,
                {"status": "rejected", "code": e.code, "error": str(e)},
            )
        tenant = payload["tenant"]
        with self._graph_lock:
            self.graph_tenants[tenant] = payload
        pushed: dict[str, object] = {}
        for v in self._routable():
            try:
                code, _out = self._push_json(v, "/v1/tenants", payload)
                pushed[v.replica_id] = code
                if code == 200:
                    self._note_tenant_pushed(v, tenant)
            except Exception as e:
                pushed[v.replica_id] = f"error: {type(e).__name__}"
        return 200, {"tenant": tenant, "replicas": pushed}

    # -- canary / shadow routing (fabric/canary.py) ------------------------

    def _apply_canary(
        self, candidates: list[ReplicaView]
    ) -> tuple[str, ReplicaView | None, list[ReplicaView]]:
        """Split routing for an in-flight flip: stable traffic never
        touches the canary replica; the deterministic ~frac slice routes
        canary-first (stable candidates stay as fallback, so a broken
        canary costs the client a retry, not an error); every k-th
        canary request shadows instead. Returns (mode, canary view,
        forward candidates)."""
        gate = self.canary
        if gate.state != fabric_canary.CANARY:
            return "off", None, candidates
        crid = gate.replica_id
        canary_view = next(
            (v for v in candidates if v.replica_id == crid), None
        )
        stable = [v for v in candidates if v.replica_id != crid]
        if canary_view is None:
            return "off", None, stable or candidates
        if not gate.take_canary():
            return "stable", canary_view, stable
        if gate.take_shadow():
            return "shadow", canary_view, stable
        return "canary", canary_view, [canary_view] + stable

    def _canary_record(self, rid: str, ok: bool) -> None:
        gate = self.canary
        if gate.state != fabric_canary.CANARY:
            return
        lane = "canary" if rid == gate.replica_id else "stable"
        self._m_canary.inc(lane=lane, result="ok" if ok else "bad")
        if gate.record(lane, ok) == fabric_canary.ROLLED_BACK:
            self._handle_canary_rollback()

    def _shadow_forward(
        self,
        root,
        bucket: str,
        body: bytes,
        canary_view: ReplicaView,
        stable_candidates: list[ReplicaView],
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        """The bit-exactness spot check: duplicate one sampled request to
        canary AND stable, compare response digests, answer the client
        from STABLE — the canary cannot hurt a shadowed request no
        matter how broken the flip is."""
        import hashlib

        c_code = None
        c_digest = None
        try:
            with obs_trace.span(
                "fabric.shadow", parent=root.context(),
                replica=canary_view.replica_id,
            ):
                c_code, _ct, c_out, _ph = self._forward_once(
                    canary_view, body, root.trace_id
                )
            if c_code == 200:
                c_digest = hashlib.sha256(c_out).hexdigest()
        except Exception as e:
            self._log.warning(
                "shadow forward to canary %s failed (%s)",
                canary_view.replica_id, type(e).__name__,
            )
        self._canary_record(
            canary_view.replica_id,
            c_code is not None and c_code < 500 and c_code != 422,
        )
        code, ctype, out, extra = self._forward_with_retries(
            root, bucket, body, stable_candidates or [canary_view]
        )
        if c_code == 200 and code == 200:
            match = hashlib.sha256(out).hexdigest() == c_digest
            self._m_canary_shadow.inc(
                result="match" if match else "mismatch"
            )
            if (
                self.canary.record_shadow(match)
                == fabric_canary.ROLLED_BACK
            ):
                self._handle_canary_rollback()
        return code, ctype, out, extra + [
            ("X-Fabric-Shadow", canary_view.replica_id)
        ]

    def _handle_canary_rollback(self) -> None:
        """Breach -> exactly one rollback: dump the post-mortem, count
        it, and hand the revert to the Fabric OFF the request thread
        (the respawn takes seconds; the breaching request must not)."""
        with self._draining_lock:
            if self._canary_rollback_handled:
                return
            self._canary_rollback_handled = True
        status = self.canary.status()
        self._m_canary_rollbacks.inc()
        flight_recorder.dump("canary_rollback", extra=status)
        self._log.warning(
            "canary rollback on %s: %s", status["replica"], status["reason"]
        )
        cb = self.on_canary_rollback
        if cb is not None:
            threading.Thread(
                target=cb, args=(status,),
                name="mcim-canary-rollback", daemon=True,
            ).start()

    def canary_deploy(self, flip: dict) -> dict:
        """Start a flip: the Fabric's deploy hook respawns one replica
        with the flip config and blocks until it is serving again; only
        then does the gate open the traffic slice."""
        if self.on_canary_deploy is None:
            raise RuntimeError(
                "no canary deploy hook (router running without a Fabric)"
            )
        rid = self.on_canary_deploy(flip)
        with self._draining_lock:
            self._canary_rollback_handled = False
        self.canary.start(rid, flip)
        return self.canary.status()

    # -- live video sessions (fabric/session.py) ---------------------------

    def handle_session_frame(
        self, sid: str, body: bytes, headers
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        """One session frame through the front door. Frames of one
        session serialize on its lock (an ordered stream has no
        concurrency to exploit); the sticky binding, tail bookkeeping
        and failover replay all happen under it."""
        ops = headers.get(fabric_session.HDR_OPS) or ""
        if not ops:
            self._m_session_frames.inc(outcome="error")
            return _json_response(
                400, {"error": f"missing {fabric_session.HDR_OPS} header"}
            )
        sess = self.sessions.get_or_create(sid, ops)
        with sess.lock:
            raw_seq = headers.get(fabric_session.HDR_SEQ)
            try:
                seq = sess.next_seq if raw_seq is None else int(raw_seq)
            except ValueError:
                self._m_session_frames.inc(outcome="error")
                return _json_response(
                    400, {"error": f"bad {fabric_session.HDR_SEQ} {raw_seq!r}"}
                )
            with obs_trace.start_trace(
                "fabric.session", sid=sid, seq=seq
            ) as root:
                # each accepted frame banks retry-budget tokens, same as
                # a chain request — failover retries withdraw from it
                self.retry_budget.deposit()
                code, ctype, out, extra = self._forward_session(
                    root, sess, seq, body
                )
                root.set(status=code)
            if root.trace_id:
                extra = extra + [("X-Trace-Id", root.trace_id)]
            return code, ctype, out, extra

    def _forward_session(
        self, root, sess, seq: int, body: bytes
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        prev_rid = sess.replica_id if sess.frames > 0 else None
        tried: set[str] = set()
        last: tuple[int, str, bytes, list] | None = None
        for _attempt in range(self.forward_attempts):
            if _attempt > 0 and not self.retry_budget.try_withdraw():
                # session failover retries draw from the same bucket as
                # chain reroutes: a brownout must not amplify through
                # the stateful lane either
                deadline_mod.count_budget_denied(
                    self._m_budget_denied, "router"
                )
                break
            live = [
                v for v in self._routable() if v.replica_id not in tried
            ]
            if not live:
                break
            bound = next(
                (v for v in live if v.replica_id == sess.replica_id), None
            )
            if bound is None:
                # rebind: rendezvous winner among survivors — the same
                # hash discipline as bucket affinity, keyed by session
                view = max(
                    live,
                    key=lambda v: _rendezvous_score(
                        "sess|" + sess.sid, v.replica_id
                    ),
                )
                rebind = True
            else:
                view, rebind = bound, False
            rid = view.replica_id
            breaker = self.breakers.get(rid)
            if not breaker.allow():
                tried.add(rid)
                continue
            try:
                with obs_trace.span(
                    "fabric.session_forward", parent=root.context(),
                    replica=rid, rebind=rebind,
                ):
                    if rebind:
                        self._replay_tail(view, sess, seq, root.trace_id)
                    code, ctype, out = self._forward_session_once(
                        view, sess, seq, body, root.trace_id,
                        replay=False, reset=False,
                    )
            except Exception as e:
                breaker.on_failure()
                self._maybe_breaker_dump(rid, breaker)
                tried.add(rid)
                sess.replica_id = None  # force a clean replay elsewhere
                self._log.warning(
                    "session %s frame %d to %s failed (%s: %s)",
                    sess.sid, seq, rid, type(e).__name__, str(e)[:120],
                )
                continue
            if code in (429, 503) or code >= 500:
                if code >= 500:
                    breaker.on_failure()
                    self._maybe_breaker_dump(rid, breaker)
                tried.add(rid)
                sess.replica_id = None
                last = (code, ctype, out, [("X-Fabric-Replica", rid)])
                continue
            breaker.on_success()
            if rebind and prev_rid is not None and rid != prev_rid:
                sess.failovers += 1
                self._m_session_failovers.inc()
                self._log.info(
                    "session %s failed over %s -> %s at frame %d "
                    "(%d tail frames replayed)",
                    sess.sid, prev_rid, rid, seq, len(sess.tail),
                )
            sess.replica_id = rid
            if code == 200:
                sess.remember(seq, bytes(body))
                self._m_session_frames.inc(outcome="ok")
            else:
                self._m_session_frames.inc(outcome="error")
            return (
                code, ctype, out,
                [
                    ("X-Fabric-Replica", rid),
                    (fabric_session.HDR_SEQ, str(seq)),
                ],
            )
        if last is not None:
            self._m_session_frames.inc(outcome="error")
            return last
        self._m_session_frames.inc(outcome="unavailable")
        return _json_response(
            503,
            {"error": "no replica can take the session frame",
             "status": "unavailable"},
            extra=[("Retry-After", "1")],
        )

    def _replay_tail(self, view, sess, before_seq: int, trace_id) -> int:
        """Rebuild the temporal rings on a replacement replica: push the
        journal tail (oldest first, reset on the first frame so stale
        state from an earlier binding can never contaminate the rings);
        replayed frames decode + push but skip compute/encode (204)."""
        frames = sess.replay_frames(before_seq)
        n = 0
        for i, (s, b) in enumerate(frames):
            code, _ct, _out = self._forward_session_once(
                view, sess, s, b, trace_id, replay=True, reset=(i == 0)
            )
            if code not in (200, 204):
                raise RuntimeError(
                    f"session {sess.sid}: replay of frame {s} to "
                    f"{view.replica_id} answered {code}"
                )
            n += 1
        if n:
            self._m_session_replayed.inc(n)
        return n

    def _forward_session_once(
        self, view, sess, seq: int, body: bytes, trace_id,
        *, replay: bool, reset: bool,
    ) -> tuple[int, str, bytes]:
        addr = view.hb.addr or "127.0.0.1"
        port = view.hb.port
        conn = self._pool.take(addr, port)
        try:
            hdrs = {
                "Content-Type": "application/octet-stream",
                fabric_session.HDR_OPS: sess.ops,
                fabric_session.HDR_SEQ: str(seq),
            }
            if replay:
                hdrs[fabric_session.HDR_REPLAY] = "1"
            if reset:
                hdrs[fabric_session.HDR_RESET] = "1"
            if trace_id:
                hdrs["X-Trace-Id"] = trace_id
            conn.request(
                "POST",
                f"{fabric_session.SESSION_PATH_PREFIX}{sess.sid}/frame",
                body=body,
                headers=hdrs,
            )
            resp = conn.getresponse()
            out = resp.read()
            ctype = resp.getheader("Content-Type", "application/json")
        except BaseException:
            conn.close()
            raise
        self._pool.give(addr, port, conn)
        return resp.status, ctype, out

    # -- control + introspection ------------------------------------------

    def handle_profile(self, body: bytes) -> tuple[int, dict]:
        """`POST /control/profile`: target ONE replica with an on-demand
        `torch.profiler` capture under live traffic (body: {"replica":
        optional id, "seconds": optional float}). The replica runs the
        rate-limited capture (obs/profile.capture_live), merges its obs
        host spans onto the device timeline, files the artifact + a
        `profile_capture` recorder dump, and the whole result relays
        back through the front door — so a fleet operator profiles a
        serving pod with one HTTP call and zero SSH."""
        try:
            payload = json.loads(body or b"{}")
        except ValueError as e:
            return 400, {"error": f"body is not JSON: {e}"}
        if not isinstance(payload, dict):
            return 400, {"error": "profile request must be an object"}
        want = payload.get("replica") or ""
        live = self._routable()
        if not live:
            self._m_profile.inc(outcome="error")
            return 503, {"error": "no replica is serving"}
        if want:
            view = next(
                (v for v in live if v.replica_id == want), None
            )
            if view is None:
                self._m_profile.inc(outcome="error")
                return 404, {
                    "error": f"replica {want!r} is not routable",
                    "routable": sorted(v.replica_id for v in live),
                }
        else:
            # default target: the least-loaded serving replica — the
            # capture steals cycles, so don't aim it at the hottest one
            # unless the operator names it
            view = min(live, key=lambda v: v.load_frac())
        try:
            code, out = self._push_json(
                view, "/control/profile",
                {"seconds": payload.get("seconds")},
            )
        except Exception as e:
            self._m_profile.inc(outcome="error")
            return 502, {
                "error": (
                    f"profile relay to {view.replica_id} failed "
                    f"({type(e).__name__}: {str(e)[:120]})"
                ),
                "replica": view.replica_id,
            }
        try:
            resp = json.loads(out)
        except ValueError:
            resp = {"raw": out[:200].decode(errors="replace")}
        self._m_profile.inc(
            outcome="ok" if code == 200
            else "rate_limited" if code == 429 else "error"
        )
        return code, {"replica": view.replica_id, **resp}

    def handle_heartbeat(self, body: bytes) -> tuple[int, dict]:
        try:
            hb = Heartbeat.from_json(body)
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad heartbeat: {e}"}
        now = self._clock()
        prev = self.table.get(hb.replica_id)
        new_inc = self.table.observe(hb, now)
        if new_inc:
            # fresh process behind the same id: it must not inherit its
            # predecessor's open breaker (the restart IS the recovery)
            self.breakers.reset(hb.replica_id)
            self._log.info(
                "replica %s registered (incarnation %s, %s:%d, state %s)",
                hb.replica_id, hb.incarnation, hb.addr or "127.0.0.1",
                hb.port, hb.state,
            )
        if (
            new_inc
            or prev is None
            or prev.hb.state != hb.state
            or prev.hb.breaker_open != hb.breaker_open
            or set(prev.hb.warm_buckets) != set(hb.warm_buckets)
        ):
            # flight recorder (obs/recorder.py): the router's ring keeps
            # each replica's last meaningful heartbeat, so a post-mortem
            # dump after a SIGKILL still names the dead replica's warm
            # buckets (the supervisor's replica_death dump reads this)
            flight_recorder.note(
                "heartbeat",
                replica=hb.replica_id,
                state=hb.state,
                queued=hb.queued,
                warm_buckets=list(hb.warm_buckets),
                breaker_open=list(hb.breaker_open),
                incarnation=hb.incarnation,
            )
        self._m_heartbeats.inc(replica=hb.replica_id)
        # metrics federation: fold the beat's delta in; a refused
        # baseline rides back on the ack as resync=true and the replica
        # pushes a full snapshot next beat
        ok = self.fleet.apply(
            hb.replica_id, hb.incarnation, hb.metrics, now
        )
        # drain=true tells a scale-down victim to stop admitting: the
        # router already stopped routing to it (mark_draining); the ack
        # closes the loop on the replica side within one heartbeat
        return 200, {
            "ok": True,
            "resync": not ok,
            "drain": self._is_draining(hb.replica_id),
        }

    def _fleet_refresh(self) -> None:
        """Full-scrape fallback: a replica the table knows about whose
        fleet snapshot is stale (heartbeats lost or deltas refused) gets
        one `GET /fleet/snapshot` pull per staleness window — the
        federation survives heartbeat gaps as long as the replica's HTTP
        port answers. Runs on the /metrics//slo scrape path, bounded by
        a short timeout per replica."""
        now = self._clock()
        ages = self.fleet.ages(now)
        for v in self.table.views():
            rid = v.replica_id
            age = ages.get(rid)
            if age is not None and age <= self.stale_s:
                continue
            if now - self._fleet_scraped_at.get(rid, -1e18) < self.stale_s:
                continue
            self._fleet_scraped_at[rid] = now
            url = (
                f"http://{v.hb.addr or '127.0.0.1'}:{v.hb.port}"
                f"{obs_fleet.SNAPSHOT_PATH}"
            )
            try:
                with urllib.request.urlopen(url, timeout=2.0) as resp:
                    snap = json.loads(resp.read())
                self.fleet.full_sync(rid, v.hb.incarnation, snap, now)
                self._log.info(
                    "fleet: full-scraped %s (snapshot age was %s)",
                    rid, "inf" if age is None else f"{age:.1f}s",
                )
            except Exception as e:
                self._log.debug(
                    "fleet: full scrape of %s failed (%s)", rid,
                    type(e).__name__,
                )

    # -- federation uplink (federation/) -----------------------------------

    def federate(
        self, frontdoor_url: str, pod_id: str, *,
        interval_s: float | None = None,
    ):
        """Arm this router's pod-level uplink to a federation front
        door: a PodHeartbeatSender pushing pod aggregates (the same
        push protocol the replicas speak to THIS router, one tier up),
        with the ack applying quota leases and metrics-resync. The pod
        incarnation is minted per call, so a pod restart is visible to
        the front door the way a replica restart is visible here."""
        if self._fed_sender is not None:
            return self._fed_sender
        self._fed_pod_id = pod_id
        self._fed_incarnation = f"{os.getpid():x}-{time.time_ns():x}"
        # second federation hop: the delta rides the pod heartbeat and
        # the front door's FleetAggregator folds it in keyed by pod id
        self._fed_source = obs_fleet.DeltaSource([self.registry])
        self._fed_sender = fed_control.PodHeartbeatSender(
            frontdoor_url,
            self._collect_pod_heartbeat,
            interval_s=interval_s,
            on_ack=self._on_fed_ack,
        ).start()
        self._log.info(
            "federation: pod %s heartbeating to %s", pod_id, frontdoor_url
        )
        return self._fed_sender

    def _collect_pod_heartbeat(self, seq: int) -> fed_control.PodHeartbeat:
        live = self._routable()
        with self._graph_lock:
            pipelines = {p for (_t, p) in self.graph_specs}
        for v in live:
            pipelines.update(v.hb.pipelines or ())
        addr, port = self.address
        return fed_control.PodHeartbeat(
            pod_id=self._fed_pod_id or "",
            addr="" if addr in ("", "0.0.0.0") else addr,
            port=port,
            pid=os.getpid(),
            incarnation=self._fed_incarnation or "",
            routable=len(live),
            queued=sum(v.hb.queued for v in live),
            queue_depth=max(1, sum(v.hb.queue_depth for v in live)),
            warm_buckets=sorted(
                {b for v in live for b in v.hb.warm_buckets}
            ),
            pipelines=sorted(pipelines),
            seq=seq,
            sent_unix_s=time.time(),
            metrics=self._fed_source.delta(),
        )

    def _on_fed_ack(self, hb, ack: dict) -> None:
        if ack.get("resync"):
            self._fed_source.force_full()
        elif hb.metrics is not None:
            self._fed_source.ack(hb.metrics["seq"])
        leases = ack.get("leases")
        if leases:
            self._apply_leases(leases)

    def _apply_leases(self, leases: dict) -> None:
        """Overwrite stored tenant quotas with the front door's leased
        shares and force a re-push to the replicas (their TenantRegistry
        keeps spent window counters across a configure(), so a
        mid-window lease update never refunds spent tokens). A tenant
        the front door leases but this pod never saw is adopted — the
        lease payload IS a valid tenant config."""
        changed: list[str] = []
        with self._graph_lock:
            for tenant, lease in leases.items():
                if not isinstance(lease, dict):
                    continue
                cfg = self.graph_tenants.get(tenant)
                if cfg is None:
                    cfg = {"tenant": tenant}
                new = {
                    **cfg,
                    "quota_requests": lease.get("quota_requests"),
                    "quota_bytes": lease.get("quota_bytes"),
                }
                if new == cfg and tenant in self.graph_tenants:
                    continue
                self.graph_tenants[tenant] = new
                changed.append(tenant)
            if changed:
                # replica re-push happens lazily on the next forward
                # (_ensure_graph_state), exactly like a fresh config
                for pushed in self._tenant_pushed.values():
                    pushed.difference_update(changed)
        for tenant in changed:
            self._log.info(
                "federation: lease applied for tenant %s "
                "(quota_requests=%s quota_bytes=%s)",
                tenant,
                self.graph_tenants[tenant].get("quota_requests"),
                self.graph_tenants[tenant].get("quota_bytes"),
            )

    def render_metrics(self) -> str:
        """The router `GET /metrics` body: the router's own families plus
        the FEDERATED replica families (counters summed, histograms
        bucket-merged, gauges labeled {replica=...})."""
        self._fleet_refresh()
        return self.registry.render() + self.fleet.render()

    def fleet_p99(self) -> dict:
        """The federated e2e p99 with its exemplar trace id — the number
        the pod's operators actually ask for, joined to the trace that
        shows where the time went."""
        merged = self.fleet.merged()
        entry = merged.get("mcim_serve_e2e_latency_seconds")
        if not entry:
            return {"p99_s": None, "exemplar_trace_id": None}
        data = entry["series"].get(())
        if not data:
            return {"p99_s": None, "exemplar_trace_id": None}
        p99 = obs_fleet.quantile_from_buckets(
            entry["bounds"], data["buckets"], data["count"], 99
        )
        ex = obs_fleet.merged_exemplar_for_quantile(entry, 99)
        return {
            "p99_s": p99,
            "exemplar_trace_id": ex[0] if ex else None,
            "exemplar_value_s": ex[1] if ex else None,
        }

    def slo_status(self) -> dict:
        """The `GET /slo` body: engine status + the federated p99 and
        fleet freshness, one JSON for dashboards and the acceptance
        tests."""
        self._fleet_refresh()
        return {
            **self.slo.status(),
            "fleet": self.fleet.stats(),
            "p99": self.fleet_p99(),
        }

    def healthz(self) -> tuple[int, dict]:
        routable = self._routable()
        code = 200 if routable else 503
        return code, {
            "state": "serving" if routable else "unavailable",
            "routable": sorted(v.replica_id for v in routable),
            "known": len(self.table.views()),
        }

    def stats(self) -> dict:
        now = self._clock()
        return {
            "buckets": [f"{h}x{w}" for h, w in self.buckets],
            "stale_s": self.stale_s,
            "forward_attempts": self.forward_attempts,
            "shed_frac": self.shed_frac,
            "retry_budget": self.retry_budget.stats(),
            "hedge": {
                "delay_frac": self.hedge_delay_frac,
                "max_frac": self.hedge_max_frac,
                "fired": self._hedges_fired,
                "delay_s": self._hedge_delay_cache[1],
            },
            "draining": self.draining_ids(),
            "graph": {
                "specs": sorted(
                    f"{t}/{p}" for (t, p) in self.graph_specs
                ),
                "tenants": sorted(self.graph_tenants),
            },
            "systolic": {
                "enabled": self.systolic,
                "min_steps": self.systolic_min_steps,
                "placements": dict(self._systolic_last),
            },
            "canary": self.canary.status(),
            "tune": self.tuner.status() if self.tuner is not None else None,
            "sessions": self.sessions.stats(),
            "autoscaler": (
                self.autoscaler.status()
                if self.autoscaler is not None
                else None
            ),
            "mesh_lane": (
                self.mesh_lane.stats() if self.mesh_lane is not None else None
            ),
            "federation": (
                {
                    "pod_id": self._fed_pod_id,
                    "incarnation": self._fed_incarnation,
                    "sent": self._fed_sender.sent,
                    "dropped": self._fed_sender.dropped,
                    "failed": self._fed_sender.failed,
                }
                if self._fed_sender is not None
                else None
            ),
            "fleet": self.fleet.stats(now),
            "slo": self.slo.status(),
            "replicas": {
                v.replica_id: {
                    "addr": v.hb.addr or "127.0.0.1",
                    "port": v.hb.port,
                    "pid": v.hb.pid,
                    "incarnation": v.hb.incarnation,
                    "state": v.hb.state,
                    "fresh": v.fresh(now, self.stale_s),
                    "age_s": now - v.last_seen,
                    "queued": v.hb.queued,
                    "queue_depth": v.hb.queue_depth,
                    "breaker_open": v.hb.breaker_open,
                    "warm_buckets": v.hb.warm_buckets,
                    "systolic": v.hb.systolic,
                    "beats": v.beats,
                }
                for v in self.table.views()
            },
            "breakers": self.breakers.snapshot(),
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self, host: str = "", port: int = 0) -> "Router":
        try:
            self.httpd = _RouterHTTPServer(
                (host, port), _make_handler(self)
            )
            self._http_thread = threading.Thread(
                target=self.httpd.serve_forever,
                name="mcim-fabric-router",
                daemon=True,
            )
            self._http_thread.start()
            self.slo.start()
        except BaseException:
            self.close()
            raise
        return self

    @property
    def address(self) -> tuple[str, int]:
        assert self.httpd is not None, "Router not started"
        host, port = self.httpd.server_address[:2]
        return (host, port)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.address[1]}"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._fed_sender is not None:
            self._fed_sender.stop()
        self.slo.stop()
        if self.httpd is not None:
            try:
                self.httpd.shutdown()
            except Exception:
                pass
            self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10.0)
        with self._hedge_lock:
            pool, self._hedge_pool = self._hedge_pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        self._pool.close_all()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class _RouterHTTPServer(ThreadingHTTPServer):
    # the front door takes every client's connection burst: the stock
    # backlog of 5 turns load spikes into refused connections
    request_queue_size = 128


def _is_admission_shed(body: bytes) -> bool:
    """Whether a replica's 503 body is the graph lane's tenant-level
    admission shed ({"status": "shed", ...}) as opposed to a
    replica-level drain/stopped refusal."""
    try:
        return json.loads(body).get("status") == "shed"
    except Exception:
        return False


def _json_response(
    code: int, payload: dict, extra: list[tuple[str, str]] | None = None
) -> tuple[int, str, bytes, list[tuple[str, str]]]:
    return (
        code,
        "application/json",
        json.dumps(payload).encode(),
        list(extra or ()),
    )


def _make_handler(router: Router):
    log = get_logger()

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive toward clients too (Content-Length is
        # always set, so persistent connections are safe)
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("fabric-http: " + fmt, *args)

        def _reply(self, code, ctype, body, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code, payload, extra=()):
            c, t, b, e = _json_response(code, payload, list(extra))
            self._reply(c, t, b, e)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/healthz":
                code, payload = router.healthz()
                self._reply_json(code, payload)
            elif self.path == "/stats":
                self._reply_json(200, router.stats())
            elif self.path == "/metrics":
                # router families + the federated per-replica families
                body = router.render_metrics().encode()
                self._reply(200, obs_metrics.CONTENT_TYPE, body)
            elif self.path == "/slo":
                self._reply_json(200, router.slo_status())
            elif self.path == obs_fleet.SNAPSHOT_PATH:
                # the federation front door's full-scrape fallback: the
                # pod router's own registry (the same payload the pod
                # heartbeat's delta narrows), one tier above the
                # replica's /fleet/snapshot
                self._reply_json(
                    200, obs_fleet.snapshot_registries([router.registry])
                )
            elif self.path == "/control/canary":
                self._reply_json(200, router.canary.status())
            elif self.path == "/control/tune":
                self._reply_json(
                    200,
                    router.tuner.status()
                    if router.tuner is not None
                    else {"enabled": False},
                )
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            from urllib.parse import parse_qs, urlsplit

            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n)
            split = urlsplit(self.path)
            path = split.path
            if self.path == HEARTBEAT_PATH:
                code, payload = router.handle_heartbeat(body)
                self._reply_json(code, payload)
            elif path == "/v1/process":
                code, ctype, out, extra = router.handle_process(
                    body, self.headers, query=parse_qs(split.query)
                )
                self._reply(code, ctype, out, extra)
            elif path == "/v1/pipelines":
                code, payload = router.handle_graph_register(body)
                self._reply_json(code, payload)
            elif path == "/v1/tenants":
                code, payload = router.handle_graph_tenant(body)
                self._reply_json(code, payload)
            elif (route := fabric_session.parse_session_path(self.path)):
                code, ctype, out, extra = router.handle_session_frame(
                    route[0], body, self.headers
                )
                self._reply(code, ctype, out, extra)
            elif self.path == "/control/profile":
                code, payload = router.handle_profile(body)
                extra = (
                    # keep the replica's real rate-limit remainder on the
                    # relayed shed, like every other Retry-After pass-through
                    [("Retry-After",
                      str(max(1, int(payload.get("retry_after_s", 1)))))]
                    if code == 429
                    else []
                )
                self._reply_json(code, payload, extra)
            elif self.path == "/control/canary":
                # operator/bench control plane: start a flip ({"env":
                # {...}, "argv": [...]}) or abort the one in flight
                try:
                    req = json.loads(body or b"{}")
                    if req.get("action") == "abort":
                        router.canary.abort("operator abort")
                        router._handle_canary_rollback()
                        self._reply_json(200, router.canary.status())
                    else:
                        self._reply_json(200, router.canary_deploy(req))
                except Exception as e:
                    self._reply_json(400, {"error": str(e)})
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

    return Handler
