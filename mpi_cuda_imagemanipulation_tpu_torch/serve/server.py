"""Serving front ends: ServeApp (wiring), in-process Client, HTTP server.
The counterpart of the JAX package's ``serve/server.py``: the chain path
(``POST /v1/process``) and the health, stats and metrics endpoints.

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
                           (X-Trace-Id response header when traced)
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
    504 deadline_expired, 500 error.
    The JAX package's other routes (sessions, /v1/pipelines, /v1/tenants,
    /v1/systolic, /control/profile, /fleet/snapshot) and pipeline-tagged
    /v1/process requests answer its own ``unknown-route`` 404 here: they
    come with the pipeline service and the fabric (ROADMAP queue 1, items
    6-7).

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

from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.obs import metrics as obs_metrics
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
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

_HTTP_STATUS = {
    STATUS_REJECTED: 400,
    STATUS_QUARANTINED: 422,
    STATUS_OVERLOADED: 429,
    STATUS_SHUTDOWN: 503,
    STATUS_DEADLINE: 504,
}

# request headers that tag the JAX package's graph lane (graph/service.py)
_HDR_PIPELINE = "X-MCIM-Pipeline"


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

    def render_metrics(self) -> str:
        """The `GET /metrics` body: Prometheus text exposition over the
        app's registry (serving + engine + health/breaker/cache/devmem
        gauges), the planner's process-wide registry (plan/metrics.py:
        serving builds a plan per resolution, so calibration flips show
        here) and the cost ledger's (obs/cost.py)."""
        return (self.registry.render() + plan_metrics.registry.render()
                + cost_ledger.registry.render())

    def start(self) -> "ServeApp":
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
            "engine": (
                self.scheduler.engine.metrics.snapshot()
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
            else:
                self._unknown_route(self.path)

        def do_POST(self):  # noqa: N802
            from urllib.parse import parse_qs, urlsplit

            from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
                decode_image_bytes,
                encode_image_bytes,
            )

            split = urlsplit(self.path)
            path = split.path
            query = parse_qs(split.query)
            if path != "/v1/process" or (
                self.headers.get(_HDR_PIPELINE) or (query.get("pipeline") or [""])[0]
            ):
                # the JAX package's other POST routes and its graph lane
                # (a pipeline-tagged request) come with the pipeline
                # service and the fabric; the body is read so that the
                # persistent connection stays in step
                self._read_body()
                self._unknown_route(self.path)
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

