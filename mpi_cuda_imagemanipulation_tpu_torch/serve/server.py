"""Serving front ends: ServeApp (wiring), in-process Client, HTTP server.
The counterpart of the JAX package's ``serve/server.py``: the chain path,
the pipeline service's graph lane, the replica half of systolic
execution, on-demand profiling, and the health, stats and metrics
endpoints.

`ServeApp` assembles the subsystem from a `ServeConfig`: parse the
pipeline, warm the shape-bucket function cache on the device, start the
scheduler. Two front doors share it:

  * `Client`: in-process, numpy image in, numpy image out. Used by tests
    and the load generator (serve/loadgen.py).
  * `Server`: context-manager ownership of app + HTTP listener: the
    socket and the scheduler thread are released on EVERY exit path
    (exception mid-start included), so repeated runs cannot hit
    EADDRINUSE.
        POST /v1/process   PNG (or any PIL-decodable) bytes in, PNG out
                           (X-Trace-Id response header when traced).
                           With X-MCIM-Pipeline/?pipeline=: the graph
                           lane, a tenant-admitted DAG dispatch with the
                           side outputs in X-MCIM-Histogram/-Stats
                           headers (graph/service.py); with the
                           X-MCIM-Systolic-Plan placement header on a
                           systolic replica, this replica runs the first
                           step range and relays the chain's answer
        POST /v1/pipelines register a pipeline spec for a tenant
                           (graph/spec.py schema; refusals are 4xx
                           structured JSON with the taxonomy code)
        GET  /v1/pipelines the pipeline service's tenants and specs
        POST /v1/tenants   tenant QoS class + quota configuration
        POST /v1/systolic  one interior/final stage of a placed program
                           (graph/systolic.py handoff frame)
        POST /control/profile  one rate-limited torch.profiler capture
                           under live traffic (obs/profile.py; 429 while
                           one runs or within the rate limit)
        GET  /healthz      health state machine (resilience/health.py):
                           200 serving/degraded, 503 otherwise
        GET  /stats        metrics snapshot: a JSON view over the app's
                           registry (serve/metrics.py schema)
        GET  /metrics      Prometheus text exposition over the SAME
                           registry (serving + engine + health/breaker/
                           cache/devmem families), the planner's
                           (mcim_plan_*) and the cost ledger's
    Status mapping: 200 ok, 400 rejected (undecodable/out-of-range),
    422 quarantined (poison request: failed solo after batch bisection),
    429 overloaded (shed, with Retry-After), 503 shutting down,
    504 deadline_expired, 500 error; the graph lane's refusals are 404
    (unknown pipeline or tenant), 400 (bad image or JSON) or 422 (any
    other taxonomy code), its sheds 503 with Retry-After, a broken
    systolic chain 424.
        GET  /fleet/snapshot  a full metrics-federation snapshot of this
                           replica's registries (obs/fleet.py): the fabric
                           router's heartbeat-gap fallback reads it
        POST /v1/session/<id>/frame  one live video-session frame
                           (fabric/session.py protocol; stream/video.py
                           VideoSessionHost): 200 PNG for a live frame,
                           204 for a replayed or duplicate one, 409 on a
                           sequence gap

Fault tolerance: ServeApp owns the HealthState machine and a per-bucket
BreakerBoard; dispatch runs under the retrying executor and degrades to
the golden per-request path (``Pipeline.jit(backend='torch', plan='off')``
on the same device) while a bucket's breaker is open
(serve/scheduler.py). `Server.drain()` is the SIGTERM path: stop
admission, flush in-flight under a deadline, then stop.

Threading model: HTTP handler threads and Client callers only touch the
bounded admission queue; the single scheduler thread owns the device.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mpi_cuda_imagemanipulation_tpu_torch.graph.compile import GRAPH_IMPLS
from mpi_cuda_imagemanipulation_tpu_torch.graph.service import (
    HDR_HISTOGRAM,
    HDR_PIPELINE,
    HDR_STATS,
    HDR_TENANT,
    PIPELINES_PATH,
    TENANTS_PATH,
    GraphService,
)
from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.obs import metrics as obs_metrics
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.obs.cost import cost_ledger
from mpi_cuda_imagemanipulation_tpu_torch.obs.devmem import DevMemGauges
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.resilience import deadline as deadline_mod
from mpi_cuda_imagemanipulation_tpu_torch.resilience.breaker import CLOSED, BreakerBoard
from mpi_cuda_imagemanipulation_tpu_torch.resilience.health import (
    DRAINING,
    SERVING,
    STARTING,
    STATES,
    STOPPED,
    HealthState,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience.retry import RetryPolicy
from mpi_cuda_imagemanipulation_tpu_torch.serve import bucketing
from mpi_cuda_imagemanipulation_tpu_torch.serve.cache import CompileCache
from mpi_cuda_imagemanipulation_tpu_torch.serve.metrics import ServeMetrics
from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import accepts_channels
from mpi_cuda_imagemanipulation_tpu_torch.serve.scheduler import (
    STATUS_DEADLINE,
    STATUS_OVERLOADED,
    STATUS_QUARANTINED,
    STATUS_REJECTED,
    STATUS_SHUTDOWN,
    MicroBatchScheduler,
    Request,
)
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

_HTTP_STATUS = {
    STATUS_REJECTED: 400,
    STATUS_QUARANTINED: 422,
    STATUS_OVERLOADED: 429,
    STATUS_SHUTDOWN: 503,
    STATUS_DEADLINE: 504,
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    ops: str = "grayscale,contrast:3.5,emboss:3"
    buckets: tuple[tuple[int, int], ...] = bucketing.DEFAULT_BUCKETS
    max_batch: int = 8
    max_delay_ms: float = 5.0
    queue_depth: int = 64
    channels: tuple[int, ...] = (1, 3)
    shards: int = 1
    # the stencil accumulation of the padded executor: 'torch' (the JAX
    # package's 'xla'), 'mxu' or 'auto' (serve/padded.SERVING_BACKENDS)
    backend: str = "torch"
    # fusion-planner mode for the padded executors (models.pipeline
    # PLAN_MODES); the cache keys functions by the RESOLVED plan's
    # fingerprint, so a calibration flip rebuilds instead of serving stale
    plan: str = "auto"
    # systolic execution (graph/systolic.py): accept stage-sharded graph
    # dispatches, run a placed step range and forward the live env to the
    # next stage owner instead of running whole programs
    systolic: bool = False
    default_deadline_ms: float | None = None
    # the torch device (default CUDA; 'cpu' runs the plain ops on the host)
    device: str | None = None
    # -- async execution engine (engine/) ----------------------------------
    inflight: int = 2  # micro-batch dispatches kept outstanding
    io_threads: int = 4  # completion/crop worker pool size
    # -- fault tolerance (resilience/) ------------------------------------
    retry_attempts: int = 3  # per dispatch, incl. the first try
    retry_base_delay_ms: float = 5.0
    breaker_threshold: int = 5  # consecutive failures to trip a bucket open
    breaker_reset_s: float = 30.0  # quiet window before a half-open probe
    degrade_to_golden: bool = True  # open breaker -> per-request fallback


class ServeApp:
    """The wired subsystem. `start()` pays every first call up front
    (cache.warmup) before the first request can arrive."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self.pipe = Pipeline.parse(config.ops)
        self.device = resolve_device(config.device)
        mesh = None
        if config.shards > 1:
            from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh

            # every visible card, one slot each; on the CPU the slots share it
            mesh = make_mesh(
                config.shards,
                devices=[self.device] * config.shards if self.device.type == "cpu" else None,
            )
        # ONE registry per app: serving counters, the engine's metrics (the
        # scheduler's engine registers into it) and the callback gauges
        # below render through the same `GET /metrics` scrape, and `/stats`
        # reads the same objects
        self.registry = Registry()
        self.metrics = ServeMetrics(registry=self.registry)
        channels = tuple(ch for ch in config.channels if accepts_channels(self.pipe, ch))
        if not channels:
            raise ValueError(
                f"pipeline {self.pipe.name!r} accepts none of the configured "
                f"channel counts {config.channels}"
            )
        self.cache = CompileCache(
            self.pipe,
            config.buckets,
            bucketing.batch_buckets(config.max_batch, config.shards),
            channels=channels,
            backend=config.backend,
            mesh=mesh,
            plan=config.plan,
            device=self.device,
        )
        self.health = HealthState()
        self.breakers = BreakerBoard(
            failure_threshold=config.breaker_threshold,
            reset_timeout_s=config.breaker_reset_s,
        )
        # degraded mode: the golden per-request path on the same device
        # (byte-identical to the padded executor by the serving contract).
        # plan='off': the fallback IS the per-op golden reference, which a
        # calibration flip must never restructure
        self._fallback_fn = (
            self.pipe.jit(backend="torch", plan="off", device=self.cache.device)
            if config.degrade_to_golden else None
        )
        self.scheduler = MicroBatchScheduler(
            self.cache,
            max_batch=config.max_batch,
            max_delay_ms=config.max_delay_ms,
            queue_depth=config.queue_depth,
            metrics=self.metrics,
            retry_policy=RetryPolicy(
                max_attempts=config.retry_attempts,
                base_delay_s=config.retry_base_delay_ms / 1e3,
            ),
            breakers=self.breakers,
            health=self.health,
            fallback=self._fallback_fn,
            inflight=config.inflight,
            io_threads=config.io_threads,
        )
        self._register_state_gauges()
        # device-memory observability (obs/devmem.py): live/peak allocator
        # and headroom gauges on the app registry
        self.devmem = DevMemGauges(self.registry)
        # live video sessions (stream/video.VideoSessionHost): created on
        # the first session frame, so a server carrying no video pays
        # nothing
        self._session_host = None
        self._session_lock = threading.Lock()
        # the pipeline service (graph/service.py): created on the first
        # spec registration, so a server of the configured chain alone
        # pays nothing
        self._graph_service = None
        self._graph_lock = threading.Lock()
        self._log = get_logger()

    def _register_state_gauges(self) -> None:
        """Callback gauges over live subsystem state, evaluated at scrape
        time, so /metrics always reports the current health/breaker/cache
        picture without anything pushing updates."""
        r = self.registry
        r.gauge(
            "mcim_health_state",
            "Health state machine: 1 for the current state, 0 otherwise.",
            labels=("state",),
            fn=lambda: {(s,): 1.0 if s == self.health.state else 0.0 for s in STATES},
        )
        r.gauge(
            "mcim_breaker_not_closed",
            "Per-bucket circuit breaker: 1 when open/half-open (traffic "
            "degraded), 0 when closed.",
            labels=("bucket",),
            fn=lambda: {
                (str(k),): 0.0 if st["state"] == CLOSED else 1.0
                for k, st in self.breakers.snapshot()["by_key"].items()
            },
        )
        r.gauge(
            "mcim_breaker_open_events",
            "Cumulative breaker trips across all buckets.",
            fn=lambda: float(self.breakers.snapshot()["open_events"]),
        )
        r.gauge(
            "mcim_cache_compiled",
            "Functions in the shape-bucket cache.",
            fn=lambda: float(self.cache.stats()["compiled"]),
        )
        r.gauge(
            "mcim_cache_traces_since_warmup",
            "First calls of a built function for a new input shape after "
            "warmup (0 under any admitted load).",
            fn=lambda: float(self.cache.stats()["traces_since_warmup"]),
        )
        r.gauge(
            "mcim_cache_hits",
            "Function-cache hits per shape bucket.",
            labels=("bucket",),
            fn=lambda: {(b,): float(n) for b, n in self.cache.stats()["hits_by_bucket"].items()},
        )
        r.gauge(
            "mcim_cache_misses",
            "Function-cache misses (off-grid keys: a scheduler bug).",
            fn=lambda: float(self.cache.stats()["misses"]),
        )

    @property
    def session_host(self):
        """The per-session temporal-ring host (lazy; the fabric router's
        session routes land here through the HTTP handler), running the
        sessions' spatial ops on the app's device."""
        with self._session_lock:
            if self._session_host is None:
                from mpi_cuda_imagemanipulation_tpu_torch.stream.video import VideoSessionHost

                self._session_host = VideoSessionHost(registry=self.registry,
                                                      device=self.device)
            return self._session_host

    @property
    def graph_service(self):
        """The multi-tenant pipeline service (lazy; POST /v1/pipelines and
        pipeline-tagged /v1/process requests land here), on the app's
        device and registry, so the mcim_graph_* families render in the
        same /metrics scrape. Graph segments run the stage walker, so the
        backend is the configured one when the walker takes it ('torch',
        'mxu', 'auto'), else 'torch' (as the JAX package pins 'xla')."""
        with self._graph_lock:
            if self._graph_service is None:
                backend = self.config.backend
                if backend not in GRAPH_IMPLS:
                    backend = "torch"
                self._graph_service = GraphService(
                    registry=self.registry,
                    backend=backend,
                    plan=self.config.plan,
                    systolic=self.config.systolic,
                    # the QoS ladder sheds on the WORSE of the graph
                    # service's own inflight fraction and the chain
                    # scheduler's queue fill: one load signal for both
                    # traffic classes
                    load_frac=self.scheduler.queue_fill_frac,
                    # admitted graph dispatches coalesce through the chain
                    # scheduler's group lanes keyed (dag fingerprint, true
                    # shape); MCIM_GRAPH_COALESCE=0 keeps the per-request
                    # path
                    coalescer=(self.scheduler if env_registry.get_bool("MCIM_GRAPH_COALESCE")
                               else None),
                    device=self.device,
                )
            return self._graph_service

    def graph_pipeline_ids(self) -> list[str]:
        """Registered pipeline ids, [] when the service was never touched
        (must not instantiate anything)."""
        with self._graph_lock:
            svc = self._graph_service
        return svc.pipeline_ids() if svc is not None else []

    def tenant_qos(self, tenant_id: str | None) -> str:
        """The admission class chain traffic from `tenant_id` submits
        under: the tenant's configured QoS when the pipeline service knows
        it, the full-depth default otherwise (an unknown tenant on the
        chain path is ordinary anonymous traffic, not an error)."""
        with self._graph_lock:
            svc = self._graph_service
        if not tenant_id or svc is None:
            return "interactive"
        try:
            return svc.tenants.get(tenant_id).config.qos
        except Exception:
            return "interactive"

    def profile_capture(self, payload: dict) -> tuple[int, dict]:
        """One on-demand profiler capture UNDER LIVE TRAFFIC on the app's
        device (obs/profile.capture_live). Rate-limited per process; the
        merged host+device artifact path and summary ride back."""
        from mpi_cuda_imagemanipulation_tpu_torch.obs import profile as obs_profile

        try:
            result = obs_profile.capture_live(payload.get("seconds"), device=self.device)
        except obs_profile.ProfileUnavailable as e:
            return 429, {"status": "unavailable", "error": e.reason,
                         "retry_after_s": e.retry_after_s}
        except Exception as e:
            return 500, {"status": "error", "error": f"profile capture failed: {e}"}
        return 200, {"status": "ok", **result}

    def render_metrics(self) -> str:
        """The `GET /metrics` body: Prometheus text exposition over the
        app's registry (serving + engine + health/breaker/cache/devmem
        gauges), the planner's process-wide registry (plan/metrics.py:
        serving builds a plan per resolution, so calibration flips show
        here) and the cost ledger's (obs/cost.py)."""
        return (self.registry.render() + plan_metrics.registry.render()
                + cost_ledger.registry.render())

    def fleet_registries(self) -> list[Registry]:
        """The registries this process federates to the fabric router
        (obs/fleet.py): the app registry (serve + engine + gauges, devmem
        included), the planner's (serving rebuilds on calibration flips
        are fleet-relevant), the cost ledger's and the online tuning
        registry (tune/metrics.py: the control loop's inputs arriving)."""
        from mpi_cuda_imagemanipulation_tpu_torch.tune.metrics import tune_metrics

        return [
            self.registry,
            plan_metrics.registry,
            cost_ledger.registry,
            tune_metrics.registry,
        ]

    def fleet_snapshot(self) -> dict:
        """A full federation snapshot (the `GET /fleet/snapshot` body: the
        router's heartbeat-gap fallback and the federation equality check
        read it)."""
        from mpi_cuda_imagemanipulation_tpu_torch.obs import fleet

        return fleet.snapshot_registries(self.fleet_registries())

    def start(self) -> "ServeApp":
        if self.device.type == "cuda":
            # the profiler's set-up must happen on this (the importing)
            # thread for POST /control/profile's captures, which start on
            # handler threads, to record the card (obs/profile.py)
            from mpi_cuda_imagemanipulation_tpu_torch.obs.profile import init_profiler

            init_profiler(self.device)
        warm_s = self.cache.warmup()
        self._log.info(
            "function cache warm: %d functions in %.1fs (%s buckets x channels %s x "
            "batches %s) on %s",
            self.cache.stats()["compiled"], warm_s,
            "/".join(f"{h}x{w}" for h, w in self.cache.buckets),
            list(self.cache.channels), list(self.cache.batch_buckets), self.cache.device,
        )
        self.scheduler.start()
        self.health.to(SERVING)
        return self

    def stop(self, *, drain: bool = True, deadline_s: float = 30.0) -> None:
        """Idempotent shutdown: health -> draining (admission is refused by
        the stopping scheduler), flush under `deadline_s` when draining,
        then health -> stopped."""
        if self.health.state == STOPPED:
            return
        if self.health.state not in (STARTING,):
            self.health.to(DRAINING)
        self.scheduler.stop(drain=drain, timeout=deadline_s)
        self.health.to(STOPPED)
        self._log.info("serve shutdown: %s", self.metrics.summary_line())

    def _engine_stats(self) -> dict:
        """The engine's snapshot, with its idle seconds and the idle wait
        in progress (`idle_open_s`) read together: the idle time between
        two reads of /stats is the difference of their sums."""
        m = self.scheduler.engine.metrics
        out = m.snapshot()
        out["idle_s"], out["idle_open_s"] = m.idle_parts()
        return out

    def stats(self) -> dict:
        return {
            "pipeline": self.pipe.name,
            "buckets": [f"{h}x{w}" for h, w in self.cache.buckets],
            "batch_buckets": list(self.cache.batch_buckets),
            "max_batch": self.config.max_batch,
            "max_delay_ms": self.config.max_delay_ms,
            "queue_depth": self.config.queue_depth,
            "shards": self.config.shards,
            "inflight": self.config.inflight,
            "device": str(self.cache.device),
            "health": self.health.to_dict(),
            "breakers": self.breakers.snapshot(),
            "cache": self.cache.stats(),
            "devmem": self.devmem.snapshot(),
            "sessions": (self._session_host.stats() if self._session_host is not None
                         else None),
            "graph": (self._graph_service.stats() if self._graph_service is not None
                      else None),
            "engine": (
                self._engine_stats()
                if self.scheduler.engine is not None
                else None
            ),
            **self.metrics.snapshot(),
        }


class Client:
    """In-process client over the scheduler: the test and loadgen front end."""

    def __init__(self, app: ServeApp):
        self._app = app

    def submit(self, img: np.ndarray, *, deadline_ms: float | None = None) -> Request:
        """Non-blocking: returns the Request handle (open-loop callers
        fire and collect; `.wait()` blocks for the response)."""
        if deadline_ms is None:
            deadline_ms = self._app.config.default_deadline_ms
        return self._app.scheduler.submit(img, deadline_ms=deadline_ms)

    def process(self, img: np.ndarray, *, deadline_ms: float | None = None,
                timeout: float | None = 60.0) -> np.ndarray:
        """Blocking round trip; raises Overloaded / RequestRejected /
        DeadlineExceeded / ServeError on non-ok statuses."""
        return self.submit(img, deadline_ms=deadline_ms).wait(timeout)


def _make_handler(app: ServeApp):
    log = get_logger()

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: persistent connections (every response carries
        # Content-Length)
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            log.debug("http: " + fmt, *args)

        def _send_json(self, code: int, payload: dict, extra=()) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _unknown_route(self, path: str) -> None:
            self._send_json(404, {"code": "unknown-route", "error": f"no route {path}"})

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(n)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/healthz":
                # the health state machine, not a static "ok": 200 while
                # admitting (serving/degraded), 503 starting/draining/stopped
                self._send_json(app.health.http_code(), app.health.to_dict())
            elif self.path == "/stats":
                self._send_json(200, app.stats())
            elif self.path == "/metrics":
                body = app.render_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type", obs_metrics.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/fleet/snapshot":
                # full federation snapshot (obs/fleet.py): the router's
                # heartbeat-gap full-scrape fallback reads it
                self._send_json(200, app.fleet_snapshot())
            elif self.path == PIPELINES_PATH:
                # the pipeline service's registry view (tenants, specs,
                # cache namespaces); an empty shape until the first
                # registration
                svc = app._graph_service
                self._send_json(200, svc.stats() if svc is not None else {"tenants": {}})
            else:
                self._unknown_route(self.path)

        # -- the graph lane (graph/service.py) ---------------------------

        def _graph_refusal(self, e, trace_id: str) -> None:
            """One closed-taxonomy refusal (graph/spec.SpecError) as
            structured JSON {status, code, error, trace_id}: 404 for an
            unknown pipeline or tenant, 400 for a bad image or JSON body,
            422 for every other code."""
            http = (404 if e.code in ("unknown-pipeline", "unknown-tenant")
                    else 400 if e.code in ("bad-image", "bad-json") else 422)
            self._send_json(
                http,
                {"status": "rejected", "code": e.code, "error": str(e),
                 **({"trace_id": trace_id} if trace_id else {})},
                [("X-Trace-Id", trace_id)] if trace_id else [],
            )

        def _handle_graph_register(self) -> None:
            """POST /v1/pipelines: {"tenant": ..., "spec": {...}} (or the
            spec itself with the tenant in X-MCIM-Tenant). Malformed specs
            are ALWAYS 4xx with a taxonomy code, never 500."""
            data = self._read_body()
            with obs_trace.start_trace("graph.register") as root:
                tid = root.trace_id
                try:
                    try:
                        payload = json.loads(data or b"null")
                    except ValueError as e:
                        raise SpecError("bad-json", f"body is not JSON: {e}") from None
                    if not isinstance(payload, dict):
                        raise SpecError("bad-root", "registration body must be an object")
                    spec = payload.get("spec", payload)
                    tenant = payload.get("tenant") or self.headers.get(HDR_TENANT) or "default"
                    result = app.graph_service.register(tenant, spec)
                except SpecError as e:
                    root.set(code=e.code)
                    self._graph_refusal(e, tid)
                    return
                self._send_json(200, {**result, **({"trace_id": tid} if tid else {})},
                                [("X-Trace-Id", tid)] if tid else [])

        def _handle_tenant_config(self) -> None:
            """POST /v1/tenants: QoS class + quota configuration."""
            data = self._read_body()
            try:
                try:
                    payload = json.loads(data or b"null")
                except ValueError as e:
                    raise SpecError("bad-json", f"body is not JSON: {e}") from None
                result = app.graph_service.configure_tenant(payload)
            except SpecError as e:
                self._graph_refusal(e, "")
                return
            self._send_json(200, result)

        def _handle_graph_process(self, tenant: str, pipeline_id: str) -> None:
            """One pipeline-tagged /v1/process request: a tenant-admitted
            graph dispatch, image + side outputs in ONE response (the side
            outputs ride X-MCIM-Histogram / X-MCIM-Stats JSON headers)."""
            from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import (
                HDR_PLAN,
                decode_placement,
            )
            from mpi_cuda_imagemanipulation_tpu_torch.graph.tenancy import GraphShed
            from mpi_cuda_imagemanipulation_tpu_torch.io.image import decode_image_bytes

            data = self._read_body()
            if not app.health.is_admitting():
                self._send_json(503, {"status": app.health.state, "error": "not admitting"},
                                [("Retry-After", "1")])
                return
            # the propagated deadline: dead on arrival answers 504 before
            # the tenant ladder or the DAG dispatch see the request
            dl = deadline_mod.from_headers(self.headers)
            if dl is not None and dl.expired():
                deadline_mod.count_expired(app.metrics.deadline_tiers, "replica")
                self._send_json(504, deadline_mod.expired_response_body())
                return
            root = obs_trace.start_trace(
                "graph.request", tenant=tenant, pipeline=pipeline_id,
                trace_id=self.headers.get("X-Trace-Id") or None,
            )
            tid = root.trace_id
            trace_hdr = [("X-Trace-Id", tid)] if tid else []
            try:
                try:
                    img = decode_image_bytes(data)
                except Exception as e:
                    app.graph_service.on_reject("bad-image")
                    raise SpecError("bad-image", f"undecodable image: {e}") from None
                plan_hdr = self.headers.get(HDR_PLAN)
                if plan_hdr and app.graph_service.systolic:
                    # the stage-0 owner of a placed program: run our range,
                    # forward the live env down the chain, relay the final
                    # owner's response (with the knob off the whole program
                    # runs here: never a wrong answer)
                    try:
                        placement = decode_placement(plan_hdr)
                    except ValueError as e:
                        raise SpecError("bad-json", f"bad placement header: {e}") from None
                    kind, val = app.graph_service.systolic_process(
                        placement, 0, img, nbytes=len(data), trace_id=tid,
                    )
                    if kind == "env":
                        self._systolic_forward_and_relay(placement, 1, val, tid, trace_hdr,
                                                         deadline=dl)
                        return
                    out = val
                else:
                    out = app.graph_service.process(
                        tenant, pipeline_id, img, nbytes=len(data), trace_id=tid, deadline=dl,
                    )
            except deadline_mod.DeadlineExpired:
                # the graph service found the budget dead at dispatch time
                # (tier "graph" counted there); 504 is the verdict
                root.set(status="deadline_expired")
                self._send_json(504, deadline_mod.expired_response_body(), trace_hdr)
                return
            except SpecError as e:
                root.set(status="rejected", code=e.code)
                self._graph_refusal(e, tid)
                return
            except GraphShed as e:
                # an explicit shed, "come back later", never an error: 503
                # + Retry-After, which the loadgen accounting reads as shed
                root.set(status="shed", reason=e.reason)
                self._send_json(
                    503,
                    {"status": "shed", "reason": e.reason, "error": str(e),
                     **({"trace_id": tid} if tid else {})},
                    [("Retry-After", str(max(1, int(round(e.retry_after_s)))))] + trace_hdr,
                )
                return
            except Exception as e:
                root.set(status="error")
                self._send_json(
                    500,
                    {"status": "error", "error": f"graph dispatch failed: {e}",
                     **({"trace_id": tid} if tid else {})},
                    trace_hdr,
                )
                return
            finally:
                root.end()
            self._send_graph_result(out, trace_hdr)

        def _send_graph_result(self, out: dict, trace_hdr) -> None:
            """The graph dispatch's success response: PNG body, side
            outputs in X-MCIM-Histogram / X-MCIM-Stats JSON headers."""
            from mpi_cuda_imagemanipulation_tpu_torch.io.image import encode_image_bytes

            png = encode_image_bytes(out["image"])
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            if "histogram" in out:
                self.send_header(HDR_HISTOGRAM, json.dumps(out["histogram"]))
            if "stats" in out:
                self.send_header(HDR_STATS, json.dumps(out["stats"]))
            for k, v in trace_hdr:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(png)

        # -- the replica half of systolic execution (graph/systolic.py) ---

        def _systolic_post(self, addr: str, body: bytes):
            """POST a handoff frame to a peer stage owner's /v1/systolic.
            Returns (status, headers, body), or None on a transport
            failure."""
            import http.client

            from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import SYSTOLIC_PATH

            host, _, port = addr.rpartition(":")
            try:
                conn = http.client.HTTPConnection(host, int(port), timeout=30)
                try:
                    conn.request("POST", SYSTOLIC_PATH, body,
                                 {"Content-Type": "application/octet-stream"})
                    r = conn.getresponse()
                    return r.status, dict(r.getheaders()), r.read()
                finally:
                    conn.close()
            except (OSError, ValueError, http.client.HTTPException):
                return None

        def _relay(self, code: int, headers: dict, body: bytes, names, trace_hdr) -> None:
            self.send_response(code)
            self.send_header("Content-Type", headers.get("Content-Type", "application/json"))
            self.send_header("Content-Length", str(len(body)))
            for h in names:
                if headers.get(h):
                    self.send_header(h, headers[h])
            for k, v in trace_hdr:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _systolic_forward_and_relay(self, placement: dict, next_idx: int, env: dict,
                                        tid: str, trace_hdr, deadline=None) -> None:
            """Hand the live env to stage owner `next_idx` and relay its
            (eventually the final owner's) response verbatim: success
            replies chain back through the nested forwards, so one POST per
            stage boundary is the whole transport story. Any downstream
            failure becomes 424 systolic-broken (a caller reruns the
            request on the pinned lane: idempotent compute, so a broken
            chain can delay an answer but never wrong it)."""
            from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import encode_handoff

            meta = {"placement": placement, "idx": next_idx, "trace_id": tid}
            if deadline is not None:
                # the chain carries the REMAINING budget in the frame; each
                # owner re-anchors and re-checks
                meta["deadline_ms"] = deadline.remaining_ms()
            body = encode_handoff(meta, env)
            resp = self._systolic_post(placement["addrs"][next_idx], body)
            if resp is not None and resp[0] == 504:
                # a downstream stage found the deadline dead: relay the
                # verdict, not a broken chain (a 424 would rerun abandoned
                # work)
                self._relay(504, resp[1], resp[2], (), trace_hdr)
                return
            if resp is None or resp[0] != 200:
                status = "unreachable" if resp is None else resp[0]
                self._send_json(
                    424,
                    {"status": "systolic-broken",
                     "error": f"stage owner {next_idx} failed ({status})",
                     **({"trace_id": tid} if tid else {})},
                    trace_hdr,
                )
                return
            app.graph_service.count_forward(len(body))
            _, headers, rbody = resp
            self._relay(200, {"Content-Type": "image/png", **headers}, rbody,
                        (HDR_HISTOGRAM, HDR_STATS), trace_hdr)

        def _handle_systolic_hop(self) -> None:
            """POST /v1/systolic: one interior/final stage of a placed
            program. The request was admitted at the entry owner; here the
            live env is decoded, this replica's range runs, and the result
            is forwarded to the next owner or rendered as the answer."""
            from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import decode_handoff

            data = self._read_body()
            if not app.graph_service.systolic:
                self._send_json(409, {"status": "systolic-broken",
                                      "error": "systolic mode disabled on this replica"})
                return
            try:
                meta, env = decode_handoff(data)
                placement = meta["placement"]
                idx = int(meta["idx"])
                tid = str(meta.get("trace_id") or "")
                if not isinstance(placement, dict):
                    raise ValueError("placement must be an object")
            except (KeyError, TypeError, ValueError) as e:
                self._send_json(400, {"status": "rejected", "code": "bad-json",
                                      "error": f"bad handoff frame: {e}"})
                return
            trace_hdr = [("X-Trace-Id", tid)] if tid else []
            dl = None
            raw_dl = meta.get("deadline_ms")
            if raw_dl is not None:
                try:
                    dl = deadline_mod.Deadline(float(raw_dl))
                except (TypeError, ValueError):
                    dl = None  # a garbled budget degrades to none
            if dl is not None and dl.expired():
                # the budget died in transit between stage owners: stop the
                # chain here; upstream relays the 504 verbatim
                deadline_mod.count_expired(app.metrics.deadline_tiers, "replica")
                self._send_json(504, deadline_mod.expired_response_body(), trace_hdr)
                return
            try:
                kind, val = app.graph_service.systolic_process(placement, idx, env, trace_id=tid)
            except Exception as e:
                # a SpecError included: an admitted request failing at a
                # hop is a broken chain, not a client refusal; the 5xx
                # propagates up and the entry owner answers 424
                self._send_json(
                    500,
                    {"status": "error", "error": f"systolic stage failed: {e}",
                     **({"trace_id": tid} if tid else {})},
                    trace_hdr,
                )
                return
            if kind == "env":
                self._systolic_forward_and_relay(placement, idx + 1, val, tid, trace_hdr,
                                                 deadline=dl)
                return
            self._send_graph_result(val, trace_hdr)

        def _handle_profile(self) -> None:
            """POST /control/profile: one on-demand capture under live
            traffic (obs/profile.capture_live); 429 + Retry-After while
            one runs or inside the rate limit."""
            data = self._read_body()
            try:
                payload = json.loads(data or b"{}")
            except ValueError:
                payload = {}
            code, resp = app.profile_capture(payload if isinstance(payload, dict) else {})
            extra = ([("Retry-After", str(int(resp.get("retry_after_s", 1))))]
                     if code == 429 else [])
            self._send_json(code, resp, extra)

        def _handle_session_frame(self, sid: str) -> None:
            """One live-session frame (fabric/session.py protocol): push
            the temporal rings, return the processed frame (200 PNG) for
            live traffic or an empty 204 for replays and duplicates. 409 on
            a sequence gap tells the router to rebind with a replay."""
            # lazy imports: the protocol constants live with the router's
            # session table, and a bare Server must not drag the pod stack
            # in at import
            from mpi_cuda_imagemanipulation_tpu_torch.fabric import session as fabric_session
            from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
                decode_image_bytes,
                encode_image_bytes,
            )
            from mpi_cuda_imagemanipulation_tpu_torch.stream.video import SessionGapError

            # drain the body first: an early 400 that leaves it unread
            # would desync the router's keep-alive connection
            data = self._read_body()
            ops = self.headers.get(fabric_session.HDR_OPS) or ""
            raw_seq = self.headers.get(fabric_session.HDR_SEQ)
            try:
                seq = int(raw_seq)
            except (TypeError, ValueError):
                self._send_json(400, {"error": f"bad {fabric_session.HDR_SEQ} {raw_seq!r}"})
                return
            if not ops:
                self._send_json(400, {"error": f"missing {fabric_session.HDR_OPS} header"})
                return
            try:
                frame = decode_image_bytes(data)
            except Exception as e:
                self._send_json(400, {"error": f"undecodable frame: {e}"})
                return
            try:
                out = app.session_host.process_frame(
                    sid, ops, seq, frame,
                    replay=bool(self.headers.get(fabric_session.HDR_REPLAY)),
                    reset=bool(self.headers.get(fabric_session.HDR_RESET)),
                )
            except SessionGapError as e:
                self._send_json(409, {"error": str(e)})
                return
            except Exception as e:
                self._send_json(500, {"error": f"session frame failed: {e}"})
                return
            if out is None:  # replay or duplicate: rings advanced, no pixels
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            png = encode_image_bytes(out)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

        def do_POST(self):  # noqa: N802
            from urllib.parse import parse_qs, urlsplit

            from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import SYSTOLIC_PATH
            from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
                decode_image_bytes,
                encode_image_bytes,
            )

            split = urlsplit(self.path)
            path = split.path
            query = parse_qs(split.query)
            routes = {
                PIPELINES_PATH: self._handle_graph_register,
                TENANTS_PATH: self._handle_tenant_config,
                SYSTOLIC_PATH: self._handle_systolic_hop,
                "/control/profile": self._handle_profile,
            }
            if path in routes:
                routes[path]()
                return
            if path != "/v1/process":
                from mpi_cuda_imagemanipulation_tpu_torch.fabric import session as fabric_session

                route = fabric_session.parse_session_path(path)
                if route is not None:
                    self._handle_session_frame(route[0])
                    return
                # the body is read so that the persistent connection
                # stays in step
                self._read_body()
                self._unknown_route(path)
                return
            tenant = self.headers.get(HDR_TENANT) or (query.get("tenant") or [""])[0]
            pipeline = self.headers.get(HDR_PIPELINE) or (query.get("pipeline") or [""])[0]
            if pipeline:
                # pipeline-tagged: the graph service's dispatch path
                self._handle_graph_process(tenant or "default", pipeline)
                return
            if not app.health.is_admitting():
                # draining/stopped: an explicit retry-later, never admission
                # into a queue about to be torn down
                self._read_body()
                self._send_json(
                    503, {"status": app.health.state, "error": "not admitting"},
                    [("Retry-After", "1")],
                )
                return
            # the propagated deadline (resilience/deadline.py): a budget
            # already dead on arrival answers 504 here, before decode or
            # queue admission
            dl = deadline_mod.from_headers(self.headers)
            if dl is not None and dl.expired():
                self._read_body()
                deadline_mod.count_expired(app.metrics.deadline_tiers, "replica")
                self._send_json(504, deadline_mod.expired_response_body())
                return
            try:
                img = decode_image_bytes(self._read_body())
            except Exception as e:
                # counted as submitted + rejected, so the accounting
                # invariant (submitted == resolved + queued) holds here too
                app.metrics.on_submit()
                app.metrics.on_reject()
                self._send_json(400, {"error": f"undecodable image: {e}"})
                return
            req = app.scheduler.submit(
                img,
                deadline_ms=(dl.remaining_ms() if dl is not None
                             else app.config.default_deadline_ms),
                trace_id=self.headers.get("X-Trace-Id") or None,
                # a known tenant's chain traffic admits under its QoS class
                # (graph/tenancy's ladder: low classes shed first)
                qos=app.tenant_qos(tenant),
            )
            req.done.wait()
            trace_hdr = [("X-Trace-Id", req.trace_id)] if req.trace_id else []
            if req.status == "ok":
                png = encode_image_bytes(req.result)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                for k, v in trace_hdr:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(png)
                return
            code = _HTTP_STATUS.get(req.status, 500)
            extra = [("Retry-After", "1")] if code == 429 else []
            self._send_json(
                code,
                {"status": req.status, "error": req.error,
                 **({"trace_id": req.trace_id} if req.trace_id else {})},
                extra + trace_hdr,
            )

    return Handler


class _ServeHTTPServer(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a connection burst
    # overflows it and clients see refused connections
    request_queue_size = 128


def make_http_server(app: ServeApp, host: str = "", port: int = 8000):
    """A ThreadingHTTPServer bound to (host, port); port 0 picks a free one
    (the bound port is `server.server_address[1]`). The caller owns
    serve_forever()/shutdown(). Prefer `Server`, which releases on
    exception paths."""
    return _ServeHTTPServer((host, port), _make_handler(app))


class Server:
    """The full serving stack as a context manager.

    The warmup (the slow part that can fail) runs BEFORE the socket binds,
    and any exception on the way up tears down whatever did come up, so a
    crashed start never leaks the listener or the scheduler thread.

        with Server(cfg, port=0) as srv:
            ... srv.address, srv.app ...
        # socket closed + scheduler stopped on ANY exit, exception included

    `drain(deadline_s)` is the SIGTERM path: health -> draining, admission
    refused, in-flight + queued work flushed under the deadline, listener
    closed, health -> stopped.
    """

    def __init__(self, config: ServeConfig, host: str = "", port: int = 0):
        self.app = ServeApp(config)
        self.host = host
        self.port = port
        self.httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._closed = False

    def start(self) -> "Server":
        try:
            self.app.start()  # warmup + scheduler; no socket yet
            self.httpd = make_http_server(self.app, self.host, self.port)
            self._http_thread = threading.Thread(
                target=self.httpd.serve_forever, name="mcim-serve-http", daemon=True,
            )
            self._http_thread.start()
        except BaseException:
            self.close(drain=False)
            raise
        return self

    @property
    def address(self) -> tuple[str, int]:
        assert self.httpd is not None, "Server not started"
        host, port = self.httpd.server_address[:2]
        return (host, port)

    def drain(self, deadline_s: float = 30.0) -> None:
        """Graceful SIGTERM shutdown: flush everything admitted, bounded."""
        self.close(drain=True, deadline_s=deadline_s)

    def close(self, *, drain: bool = True, deadline_s: float = 30.0) -> None:
        """Idempotent teardown of listener + scheduler, every exit path."""
        if self._closed:
            return
        self._closed = True
        if self.httpd is not None:
            try:
                self.httpd.shutdown()  # stops serve_forever; no new connections
            except Exception:
                pass
            self.httpd.server_close()  # releases the listener socket
        if self._http_thread is not None:
            self._http_thread.join(timeout=10.0)
        self.app.stop(drain=drain, deadline_s=deadline_s)

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

