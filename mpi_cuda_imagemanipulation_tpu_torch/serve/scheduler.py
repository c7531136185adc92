"""Micro-batching scheduler: bounded admission, same-bucket coalescing.
The counterpart of the JAX package's ``serve/scheduler.py`` (jax-free
there apart from its imports; copied, with the device work on the port's
engine and tensors).

One thread owns the device: it pulls admitted requests out of per-bucket
FIFO queues and ships them as stacked dispatches through the pre-warmed
function cache (serve/cache.py). Dispatch policy (the classic micro-batching tradeoff):

  * a bucket with `max_batch` waiting requests dispatches immediately
    (full stack — best amortisation);
  * otherwise the bucket whose OLDEST request has waited `max_delay_ms`
    dispatches with whatever it has (bounded added latency);
  * the scheduler sleeps exactly until the nearest such deadline — no
    polling.

Admission control happens at submit time, on the caller's thread:

  * malformed requests (wrong channel count, dims above every bucket or
    below the pipeline's reflect bound) are REJECTED outright;
  * beyond `queue_depth` total queued requests the scheduler SHEDS with the
    distinct `overloaded` status — callers get an immediate, explicit
    signal (the HTTP front end maps it to 429) instead of unbounded
    buffering, which under sustained overload is just an OOM with extra
    steps;
  * admitted requests carry an optional deadline; ones that expire while
    queued are answered `deadline_expired` at pop time and never waste a
    device slot.

Bit-exactness note: a dispatch pads each image to the bucket and the stack
to a warmed batch size (serve/bucketing), runs the serving function
(serve/padded — true shapes ride along), then crops each response back to
its true shape. The pad slots repeat the last image and are dropped.

Fault tolerance (resilience/): each dispatch runs under a retrying
executor (exponential backoff + jitter) behind a per-bucket circuit
breaker. A batch that still fails after retries is bisected — every
member re-dispatched solo — so one poison request is quarantined with the
distinct `quarantined` status instead of failing its whole micro-batch.
While a bucket's breaker is open its traffic runs the golden per-request
fallback (bit-identical, just slower) and the health state machine reports
`degraded`; half-open probes restore the fast path when it recovers.

Async execution (engine/core.py): the scheduler thread only ENQUEUES
dispatches and moves on to coalescing the next micro-batch, keeping
`inflight` batches outstanding. The stack and the two true-shape vectors
go up through the engine's `device_stager` (pinned buffers, a copy stream
of their own), the serving function's launches return at once (CUDA
launches are asynchronous), and the engine enqueues the result's D2H on
its side stream; its completion thread waits for the copies in submission
order and its worker pool crops + resolves responses. The serial
alternative (a synchronous copy back inside the dispatch loop) leaves the
device idle during every crop/resolve and caps the pipeline at one batch in
flight. Failure composition is
unchanged: enqueue-time errors (incl. the `serve.dispatch` failpoint)
retry exactly as before on the scheduler thread; completion-time errors
(D2H, the `engine.complete` failpoint) re-run the batch through the
synchronous retry unit and fall through to the same bisect/quarantine/
breaker machinery.

Group lanes (graph/ DAG dispatch): `submit_group` admits traffic whose
coalescing unit is an opaque lane key instead of a spatial bucket — for
graphs, (dag fingerprint, true shape) — so same-program same-shape
requests stack into one batched dispatch instead of one per request.
Lane members are never spatially padded (stencil border extension at a
pad seam would change values); only the batch dimension pads. Everything
else — queue depth, QoS ladder, aged-bucket pops, retry, per-lane
breaker, bisect/quarantine, the async engine — is the same machinery.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics, device_stager
from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder as flight_recorder
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.resilience.breaker import (
    CLOSED,
    BreakerBoard,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience.health import (
    DEGRADED,
    SERVING,
    HealthState,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience.retry import (
    RetryPolicy,
    call_with_retry,
)
from mpi_cuda_imagemanipulation_tpu_torch.serve import bucketing
from mpi_cuda_imagemanipulation_tpu_torch.serve.cache import CompileCache
from mpi_cuda_imagemanipulation_tpu_torch.serve.metrics import ServeMetrics
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

STATUS_OK = "ok"
STATUS_OVERLOADED = "overloaded"
STATUS_REJECTED = "rejected"
STATUS_DEADLINE = "deadline_expired"
STATUS_ERROR = "error"
STATUS_SHUTDOWN = "shutdown"
STATUS_QUARANTINED = "quarantined"


class ServeError(Exception):
    status = STATUS_ERROR


class Overloaded(ServeError):
    """Shed by admission control: queue at --queue-depth."""

    status = STATUS_OVERLOADED


class RequestRejected(ServeError):
    """Malformed request: bad channels, or dims outside the servable range."""

    status = STATUS_REJECTED


class DeadlineExceeded(ServeError):
    status = STATUS_DEADLINE


class Quarantined(ServeError):
    """A poison request: it failed alone (after batch bisection + retries),
    so the failure is attributed to this request, not its batch-mates."""

    status = STATUS_QUARANTINED


@dataclasses.dataclass
class GroupSpec:
    """A coalescing lane for non-chain traffic (graph/ DAG dispatch).

    The lane key replaces the spatial bucket as the coalescing unit: a
    producer keys it on everything that must match for two requests to
    share one dispatch — for graphs that is (dag fingerprint,
    TRUE shape), so members are value-identical under batching and there
    is never any spatial padding (stencil border extension at a pad seam
    would change values; only the batch dimension pads, repeat-last,
    dropped on the completion slice).

      key       opaque hashable lane id; also the breaker key, so a
                poisoned lane degrades without touching chain buckets
      get_fn    nb -> callable(imgs[nb, ...]) returning a result tree
                (a tensor, or dicts/lists/tuples of them)
                (called on the dispatch thread; expected to hit the
                producer's own function cache)
      fallback  img -> result tree — the golden per-request path this
                lane degrades to while its breaker is open (bit-exact
                with the batched path by construction)
    """

    key: tuple
    get_fn: object
    fallback: object = None


@dataclasses.dataclass
class Request:
    img: np.ndarray
    true_h: int
    true_w: int
    # (bucket_h, bucket_w, channels) for chain traffic; an opaque
    # GroupSpec.key for group-lane traffic (graph/ DAG dispatch)
    bucket: tuple
    t_submit: float
    deadline: float | None  # absolute monotonic seconds, or None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    status: str = STATUS_OK
    # chain responses are cropped u8 arrays; group-lane responses are the
    # producer's result tree sliced per member
    result: object = None
    error: str | None = None
    group: GroupSpec | None = None
    t_dispatch: float | None = None
    t_done: float | None = None
    # -- observability (obs/trace.py): the request's root span + id -------
    # trace is the live root Span handle (the shared no-op when tracing is
    # disarmed or this request sampled out); trace_id is "" then — the
    # join key for log lines, /metrics outliers and X-Trace-Id headers
    trace: object = obs_trace.NOOP_SPAN
    trace_id: str = ""
    coalesce_span: object = obs_trace.NOOP_SPAN

    def trace_ctx(self) -> obs_trace.SpanContext:
        return self.trace.context()

    def wait(self, timeout: float | None = None) -> np.ndarray:
        """Block for the response; raise the status-matching ServeError on
        anything but success."""
        if not self.done.wait(timeout):
            raise TimeoutError("request still in flight")
        if self.status == STATUS_OK:
            assert self.result is not None
            return self.result
        exc = {
            STATUS_OVERLOADED: Overloaded,
            STATUS_REJECTED: RequestRejected,
            STATUS_DEADLINE: DeadlineExceeded,
            STATUS_QUARANTINED: Quarantined,
        }.get(self.status, ServeError)
        raise exc(self.error or self.status)


class MicroBatchScheduler:
    def __init__(
        self,
        cache: CompileCache,
        *,
        max_batch: int,
        max_delay_ms: float,
        queue_depth: int,
        metrics: ServeMetrics | None = None,
        clock=time.monotonic,
        retry_policy: RetryPolicy | None = None,
        breakers: BreakerBoard | None = None,
        health: HealthState | None = None,
        fallback=None,
        retry_seed: int = 0,
        inflight: int = 2,
        io_threads: int = 4,
    ):
        if max_batch > max(cache.batch_buckets):
            raise ValueError(
                f"max_batch {max_batch} exceeds the largest warmed batch "
                f"bucket {max(cache.batch_buckets)}"
            )
        self.cache = cache
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.queue_depth = queue_depth
        self.metrics = metrics or ServeMetrics()
        self.min_dim = _min_dim(cache)
        # -- fault tolerance (resilience/): retry + breaker + fallback ------
        self.retry_policy = retry_policy or RetryPolicy()
        self.breakers = breakers or BreakerBoard()
        self.health = health  # None: no state machine attached (tests)
        # fallback(img: np.ndarray) -> np.ndarray — the golden per-request
        # path a bucket degrades to while its breaker is open
        self.fallback = fallback
        self._retry_rng = random.Random(retry_seed)
        self._clock = clock
        # bucket width -> (pipeline_fp, "plan:<mode>") memo for the online
        # tuning observation (tune/store) recorded per dispatch
        self._tune_keys: dict = {}
        # -- async execution engine (engine/): bounded in-flight dispatch --
        self._inflight = max(1, inflight)
        self._io_threads = max(1, io_threads)
        self.engine: Engine | None = None
        self._cond = threading.Condition()
        # bucket/lane key -> FIFO of Requests; OrderedDict so the
        # aged-bucket scan is deterministic under equal deadlines
        self._pending: OrderedDict[tuple, deque] = OrderedDict()
        self._queued = 0
        self._running = False
        self._thread: threading.Thread | None = None
        self._log = get_logger()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._cond:
            if self._running:
                return
            self._running = True
        if self.engine is None or self.engine.closed:
            # the engine shares the serving registry, so /metrics exposes
            # serve + engine families in one scrape (no second island); its
            # stager copies each dispatch's host arrays up through pinned
            # buffers on a copy stream of their own
            stage = device_stager(self.cache.device, inflight=self._inflight)
            self.engine = Engine(
                inflight=self._inflight,
                io_threads=self._io_threads,
                stage=lambda arrays: tuple(stage(a) for a in arrays),
                metrics=EngineMetrics(registry=self.metrics.registry),
                name="serve",
            )
        self._thread = threading.Thread(
            target=self._loop, name="mcim-serve-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the dispatch loop. `drain=True` ships everything already
        admitted first; `drain=False` answers queued requests `shutdown`.
        In-flight engine batches complete either way (they already own
        device work — finishing them is strictly cheaper than dropping)."""
        with self._cond:
            if not self._running:
                return
            self._running = False
            self._drain_on_stop = drain
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        if self.engine is not None:
            self.engine.close(timeout)

    def queue_fill_frac(self) -> float:
        """Current admission-queue fill fraction — the load signal the
        graph service's QoS ladder shares with chain admission."""
        with self._cond:
            return self._queued / max(1, self.queue_depth)

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        img: np.ndarray,
        *,
        deadline_ms: float | None = None,
        trace_id: str | None = None,
        qos: str = "interactive",
    ) -> Request:
        """Admit one image; returns a Request whose `.wait()` yields the
        response. Never blocks: over-depth submissions fail immediately
        with `overloaded` (the Request is returned already-resolved, so
        open-loop callers can fire-and-collect). `trace_id` adopts an
        upstream distributed-trace id (the fabric router's X-Trace-Id
        hop) instead of minting one here.

        `qos` is the tenant's admission class (graph/tenancy.QOS_CLASSES
        — the pipeline-service ladder, honored here for chain traffic
        too): a non-interactive class admits only while the queue is
        below its fraction of `queue_depth`, so under load the LOW
        classes shed first and interactive keeps the full depth (the
        default preserves the historical single-class behavior)."""
        now = self._clock()
        self.metrics.on_submit()
        img = np.asarray(img)
        req = Request(
            img=img,
            true_h=img.shape[0] if img.ndim >= 2 else 0,
            true_w=img.shape[1] if img.ndim >= 2 else 0,
            bucket=(0, 0, 0),
            t_submit=now,
            deadline=now + deadline_ms / 1e3 if deadline_ms is not None else None,
        )
        # root span: one trace per request, made HERE (the only sampling
        # decision on this request's path — everything downstream anchors
        # to it or no-ops; an adopted upstream id overrides the decision)
        root = obs_trace.start_trace(
            "serve.request", trace_id=trace_id, h=req.true_h, w=req.true_w
        )
        req.trace = root
        req.trace_id = root.trace_id
        enq = obs_trace.span("serve.enqueue", parent=root.context())
        if deadline_ms is not None and deadline_ms <= 0.0:
            # a propagated budget already dead on arrival (the HTTP edge
            # forwards the wire remainder, floored at 0): resolve it
            # without queue admission — the pop-time check would only
            # discover the same verdict after a pointless wait. Counted
            # as a resolution (never on_admit'd, so no queue-gauge
            # bookkeeping like metrics.on_deadline does).
            self.metrics.on_deadline_at_submit()
            enq.end()
            return self._resolve(
                req, STATUS_DEADLINE, "expired before admission"
            )
        problem = self._validate(img)
        if problem is not None:
            self.metrics.on_reject()
            enq.end()
            return self._resolve(req, STATUS_REJECTED, problem)
        ch = img.shape[2] if img.ndim == 3 else 1
        bh, bw = bucketing.pick_bucket(
            img.shape[0], img.shape[1], self.cache.buckets
        )
        req.bucket = (bh, bw, ch)
        enq.set(bucket=f"{bh}x{bw}x{ch}")
        return self._admit_queued(req, qos, enq)

    def submit_group(
        self,
        img: np.ndarray,
        group: GroupSpec,
        *,
        deadline_ms: float | None = None,
        trace_id: str | None = None,
        qos: str = "interactive",
    ) -> Request:
        """Admit one ALREADY-VALIDATED image into an opaque coalescing
        lane (graph/ DAG dispatch — the producer has run its own
        validation and tenant admission before calling this). Shares the
        chain path's queue depth, QoS ladder, dispatch loop, retry/
        breaker/bisect machinery and engine; differs only in the
        coalescing key (the GroupSpec's lane id instead of a spatial
        bucket) and in `.wait()` yielding the lane's result tree
        sliced per member instead of a cropped array."""
        now = self._clock()
        self.metrics.on_submit()
        img = np.asarray(img)
        req = Request(
            img=img,
            true_h=img.shape[0] if img.ndim >= 2 else 0,
            true_w=img.shape[1] if img.ndim >= 2 else 0,
            bucket=group.key,
            t_submit=now,
            deadline=(
                now + deadline_ms / 1e3 if deadline_ms is not None else None
            ),
            group=group,
        )
        root = obs_trace.start_trace(
            "serve.request", trace_id=trace_id, h=req.true_h, w=req.true_w
        )
        req.trace = root
        req.trace_id = root.trace_id
        enq = obs_trace.span("serve.enqueue", parent=root.context())
        enq.set(bucket=str(group.key))
        return self._admit_queued(req, qos, enq)

    def _admit_queued(self, req: Request, qos: str, enq) -> Request:
        """Shared admission tail (chain + group lanes): depth check under
        the lock, enqueue + notify, open the coalesce span."""
        limit = self._qos_depth(qos)
        with self._cond:
            if not self._running:
                enq.end()
                return self._resolve(req, STATUS_SHUTDOWN, "scheduler stopped")
            if self._queued >= limit:
                self.metrics.on_shed(
                    qos=qos if limit < self.queue_depth else ""
                )
                enq.end()
                return self._resolve(
                    req,
                    STATUS_OVERLOADED,
                    f"queue at capacity ({limit} of {self.queue_depth} "
                    f"for qos={qos})"
                    if limit < self.queue_depth
                    else f"queue at capacity ({self.queue_depth})",
                )
            self._pending.setdefault(req.bucket, deque()).append(req)
            self._queued += 1
            self.metrics.on_admit()
            self._cond.notify_all()
        enq.end()
        # the coalesce span is opened on the caller's thread and ended on
        # the scheduler thread when the batch pops — its duration IS the
        # micro-batching queue wait on the timeline
        req.coalesce_span = obs_trace.span(
            "serve.coalesce", parent=req.trace.context()
        )
        return req

    def _qos_depth(self, qos: str) -> int:
        """The queue depth this admission class may fill: interactive
        (and any unknown label — never punish a typo with data loss)
        keeps the full depth; lower classes stop at their fraction of
        it, so as the queue grows past the shed threshold the low-QoS
        tenants shed FIRST (graph/tenancy.qos_admit_frac)."""
        if qos in (None, "", "interactive"):
            return self.queue_depth
        from mpi_cuda_imagemanipulation_tpu_torch.graph.tenancy import (
            QOS_CLASSES,
            qos_admit_frac,
        )

        if qos not in QOS_CLASSES:
            return self.queue_depth
        return max(1, int(self.queue_depth * qos_admit_frac(qos)))

    def _validate(self, img: np.ndarray) -> str | None:
        if img.dtype != np.uint8 or img.ndim not in (2, 3):
            return f"expected a (H, W[, C]) uint8 image, got {img.dtype} ndim={img.ndim}"
        ch = img.shape[2] if img.ndim == 3 else 1
        if ch not in self.cache.channels:
            return (
                f"{ch}-channel images are not served (configured: "
                f"{self.cache.channels})"
            )
        h, w = img.shape[:2]
        if min(h, w) < self.min_dim:
            return (
                f"image {h}x{w} is below the pipeline's minimum servable "
                f"dimension {self.min_dim} (stencil border extension)"
            )
        if bucketing.pick_bucket(h, w, self.cache.buckets) is None:
            big = self.cache.buckets[-1]
            return f"image {h}x{w} exceeds the largest bucket {big[0]}x{big[1]}"
        return None

    @staticmethod
    def _resolve(req: Request, status: str, error: str | None) -> Request:
        req.status = status
        req.error = error
        req.t_done = time.monotonic()
        req.coalesce_span.end()
        req.trace.set(status=status)
        req.trace.end()
        req.done.set()
        return req

    # -- dispatch loop -----------------------------------------------------

    def _loop(self) -> None:
        try:
            self._loop_body()
        finally:
            # every dispatched batch must resolve before the loop thread
            # dies — stop()'s join is the caller's completion barrier
            if self.engine is not None:
                self.engine.flush()

    def _loop_body(self) -> None:
        while True:
            batch: list[Request] | None = None
            with self._cond:
                while True:
                    if not self._running:
                        break
                    batch = self._pop_dispatchable()
                    if batch is not None:
                        break
                    self._cond.wait(timeout=self._sleep_s())
                if not self._running and batch is None:
                    leftovers: list[Request] = []
                    for q in self._pending.values():
                        leftovers.extend(q)
                        self._queued -= len(q)
                    self._pending.clear()
                    drain = getattr(self, "_drain_on_stop", True)
                    if not drain:
                        for r in leftovers:
                            self.metrics.on_error()
                            self._resolve(r, STATUS_SHUTDOWN, "server stopped")
                        return
                    # drain: ship what was admitted, bucket by bucket
                    for r in leftovers:
                        self._pending.setdefault(r.bucket, deque()).append(r)
                        self._queued += 1
                    if not self._pending:
                        return
                    key = next(iter(self._pending))
                    batch = self._pop_bucket(key)
            if batch:
                self._dispatch(batch)
            with self._cond:
                if not self._running and not self._pending:
                    return

    def _sleep_s(self) -> float | None:
        """Seconds until the oldest queued request hits max_delay (None =
        sleep until notified). Called under the lock."""
        heads = [q[0].t_submit for q in self._pending.values() if q]
        if not heads:
            return None
        due = min(heads) + self.max_delay_s
        return max(due - self._clock(), 0.0)

    def _pop_dispatchable(self) -> list[Request] | None:
        """Under the lock: a full bucket, else the most-overdue aged bucket."""
        now = self._clock()
        aged_key = None
        aged_t = None
        for key, q in self._pending.items():
            if not q:
                continue
            if len(q) >= self.max_batch:
                return self._pop_bucket(key)
            if now - q[0].t_submit >= self.max_delay_s and (
                aged_t is None or q[0].t_submit < aged_t
            ):
                aged_key, aged_t = key, q[0].t_submit
        if aged_key is not None:
            return self._pop_bucket(aged_key)
        return None

    def _pop_bucket(self, key: tuple[int, int, int]) -> list[Request]:
        q = self._pending[key]
        batch = [q.popleft() for _ in range(min(len(q), self.max_batch))]
        if not q:
            del self._pending[key]
        self._queued -= len(batch)
        return batch

    @staticmethod
    def _trace_parent(live: list[Request]) -> obs_trace.SpanContext | None:
        """The batch's trace anchor: the calling thread's active span if
        any, else the first sampled member's root. A batch mixes traced
        and untraced requests — the span rides the first traced one, the
        rest get their own membership events."""
        cur = obs_trace.current_context()
        if cur is not None and cur.sampled:
            return cur
        for r in live:
            ctx = r.trace_ctx()
            if ctx.sampled:
                return ctx
        return None

    def _dispatch(self, batch: list[Request]) -> None:
        now = self._clock()
        live: list[Request] = []
        for r in batch:
            r.coalesce_span.end()  # popped: the micro-batching wait is over
            if r.deadline is not None and now > r.deadline:
                self.metrics.on_deadline(now - r.t_submit, r.trace_id)
                self._resolve(r, STATUS_DEADLINE, "expired while queued")
            else:
                live.append(r)
        if not live:
            return
        bucket = live[0].bucket
        breaker = self.breakers.get(bucket)
        if not breaker.allow():
            # breaker open (and no half-open probe slot): golden fallback
            with obs_trace.span(
                "serve.degraded", parent=self._trace_parent(live),
                bucket=str(bucket), n=len(live),
            ):
                self._dispatch_degraded(live)
            return
        with obs_trace.span(
            "serve.dispatch", parent=self._trace_parent(live),
            bucket=str(bucket), n=len(live),
        ) as dspan:
            if len(live) > 1 and dspan is not obs_trace.NOOP_SPAN:
                # batch-mates of the anchoring trace stay joinable by id
                dspan.set(
                    batch_traces=[r.trace_id for r in live if r.trace_id]
                )
            if self.engine is None:
                # engine not started (direct-driven tests): serial fallback
                self._dispatch_sync(live, bucket, breaker)
                return
            # async fast path: enqueue only — the engine's completion
            # thread forces + resolves while this thread coalesces the next
            # batch. Enqueue-time failures (incl. the serve.dispatch
            # failpoint) are host-side and retry here, exactly like the
            # serial path did.
            try:
                call_with_retry(
                    lambda: self._enqueue_batch(live),
                    policy=self.retry_policy,
                    rng=self._retry_rng,
                    on_retry=lambda a, e, d: self._note_retry(
                        bucket, a, e, d, live=live
                    ),
                )
            except Exception as e:
                self._fail_batch(live, bucket, breaker, e)

    def _dispatch_sync(self, live, bucket, breaker) -> None:
        """The serial dispatch unit (pre-engine behavior): force inline."""
        try:
            out, nb, device_s = call_with_retry(
                lambda: self._run_batch(live),
                policy=self.retry_policy,
                rng=self._retry_rng,
                on_retry=lambda a, e, d: self._note_retry(
                    bucket, a, e, d, live=live
                ),
            )
        except Exception as e:  # retries exhausted: fail the path, not the loop
            self._fail_batch(live, bucket, breaker, e)
            return
        breaker.on_success()
        self._update_health()
        self._complete(live, out, nb, device_s)

    def _fail_batch(self, live, bucket, breaker, e) -> None:
        """Retries exhausted for a whole batch: feed the breaker, then
        quarantine (solo) or bisect (grouped)."""
        breaker.on_failure()
        if breaker.state != CLOSED:
            # breaker transition/holding state is an event on the trace —
            # a p99 outlier pulled up by id shows WHY it degraded
            for r in live:
                obs_trace.event(
                    "breaker.not_closed", parent=r.trace_ctx(),
                    bucket=str(bucket), state=breaker.state,
                )
            # breaker-open is a flight-recorder dump trigger: the ring
            # (recent dispatches, failpoint hits, warnings) explains
            # which bucket was hot when the path failed (rate-limited)
            flight_recorder.dump(
                "breaker_open",
                extra={"scope": "serve", "bucket": str(bucket)},
            )
        self._update_health()
        self._log.warning(
            "dispatch failed after %d attempts for bucket %s: %s",
            self.retry_policy.max_attempts, bucket, e,
        )
        if len(live) == 1:
            self.metrics.on_quarantine()
            obs_trace.event(
                "serve.quarantine", parent=live[0].trace_ctx(),
                error=type(e).__name__,
            )
            flight_recorder.dump(
                "quarantine",
                extra={"bucket": str(bucket), "error": type(e).__name__},
            )
            self._resolve(
                live[0], STATUS_QUARANTINED, f"{type(e).__name__}: {e}"
            )
        else:
            # poison isolation: re-dispatch every member solo so one bad
            # request cannot fail its batch-mates
            self._bisect_solo(live)

    def _prepare_batch(self, live: list[Request]):
        """(fn, host inputs, batch bucket) for one dispatch attempt."""
        nb = bucketing.pick_batch_bucket(len(live), self.cache.batch_buckets)
        group = live[0].group
        if group is not None:
            # group lane: the key IS the true shape, so members stack
            # as-is — no spatial padding (stencil border extension at a
            # pad seam would change values); only the batch dimension
            # pads, repeat-last, dropped on the completion slice
            fn = group.get_fn(nb)
            imgs = np.stack(
                [r.img for r in live] + [live[-1].img] * (nb - len(live))
            )
            return fn, (imgs,), nb
        bh, bw, ch = live[0].bucket
        fn = self.cache.get(bh, bw, ch, nb)
        imgs = bucketing.pad_stack(
            [bucketing.pad_to_bucket(r.img, bh, bw) for r in live], nb
        )
        th = np.asarray(
            [r.true_h for r in live] + [live[-1].true_h] * (nb - len(live)),
            dtype=np.int32,
        )
        tw = np.asarray(
            [r.true_w for r in live] + [live[-1].true_w] * (nb - len(live)),
            dtype=np.int32,
        )
        return fn, (imgs, th, tw), nb

    def _enqueue_batch(self, live: list[Request]) -> None:
        """One async dispatch attempt: build + enqueue, never force."""
        failpoints.maybe_fail("serve.dispatch", requests=live)
        fn, inputs, nb = self._prepare_batch(live)
        now = self._clock()
        for r in live:
            r.t_dispatch = now
        assert self.engine is not None
        self.engine.submit(
            (tuple(live), nb),
            lambda: inputs,
            lambda a: fn(*a),  # enqueue only: the launches return at once
            on_done=self._on_engine_done,
            on_error=self._on_engine_error,
        )

    def _on_engine_done(self, key, out, info) -> None:
        """Engine worker pool: the batch's host result landed — crop and
        resolve each member, report breaker success."""
        live, nb = key
        live = list(live)
        breaker = self.breakers.get(live[0].bucket)
        breaker.on_success()
        self._update_health()
        # group-lane results are trees (the engine's force already copied
        # them leaf by leaf); chain results normalise to one ndarray
        host = out if live[0].group is not None else np.asarray(out)
        self._complete(live, host, nb, info.get("force_s", 0.0))

    def _on_engine_error(self, key, exc) -> None:
        """Completion-stage failure (D2H / engine.complete failpoint): the
        async fast path lost this batch's result after a clean enqueue.
        Re-run it through the synchronous retry unit on this (engine
        completion) thread — the scheduler thread keeps coalescing and the
        engine keeps draining behind us; exhaustion falls through to the
        same bisect/quarantine/breaker machinery as always."""
        live, nb = key
        live = list(live)
        bucket = live[0].bucket
        breaker = self.breakers.get(bucket)
        # the lost async attempt
        self._note_retry(bucket, 1, exc, 0.0, live=live)
        try:
            out, nb2, device_s = call_with_retry(
                lambda: self._run_batch(live),
                policy=self.retry_policy,
                rng=self._retry_rng,
                on_retry=lambda a, e, d: self._note_retry(
                    bucket, a, e, d, live=live
                ),
            )
        except Exception as e:
            self._fail_batch(live, bucket, breaker, e)
            return
        breaker.on_success()
        self._update_health()
        self._complete(live, out, nb2, device_s)

    def _run_batch(self, live: list[Request]):
        """One synchronous padded-executor dispatch attempt (the retry
        unit for the serial path, bisection, and completion-failure
        re-runs)."""
        parent = obs_trace.current_context()
        with obs_trace.span(
            "serve.attempt",
            parent=parent if parent else self._trace_parent(live),
            n=len(live),
        ):
            failpoints.maybe_fail("serve.dispatch", requests=live)
            fn, inputs, nb = self._prepare_batch(live)
            now = self._clock()
            for r in live:
                r.t_dispatch = now
            t0 = self._clock()
            out = _force_host(fn(*inputs))  # forces completion + transfer
            # completion-stage failpoint fires on the sync path too, so an
            # `always`-armed site drives the full quarantine pipeline
            failpoints.maybe_fail("engine.complete", requests=live)
            return out, nb, self._clock() - t0

    def _complete(self, live, out, nb, device_s) -> None:
        batch_tid = next((r.trace_id for r in live if r.trace_id), "")
        self.metrics.on_dispatch(len(live), nb, device_s, batch_tid)
        group = live[0].group
        if group is None:
            self._note_tune_observation(live[0].bucket, len(live), device_s)
        # flight recorder: per-dispatch bucket summaries are the "which
        # bucket was hot" evidence a post-mortem dump aggregates
        flight_recorder.note(
            "dispatch",
            bucket=(
                str(live[0].bucket) if group is not None
                else "{}x{}x{}".format(*live[0].bucket)
            ),
            n=len(live),
            device_ms=device_s * 1e3,
        )
        t_done = self._clock()
        for k, r in enumerate(live):
            if group is not None:
                # lane members ran at their true shape: slice, don't crop
                r.result = _tree_index(out, k)
            else:
                r.result = out[k, : r.true_h, : r.true_w, ...]
            r.t_done = t_done
            r.status = STATUS_OK
            self.metrics.on_complete(
                (r.t_dispatch or r.t_submit) - r.t_submit,
                t_done - r.t_submit,
                r.trace_id,
            )
            r.trace.set(status=STATUS_OK)
            r.trace.end()
            r.done.set()

    def _note_tune_observation(self, bucket, n, device_s) -> None:
        """Feed the online autotuning store one per-image device-seconds
        sample for this dispatch, keyed (pipeline fingerprint, bucket
        width, resolved-plan arm). Memoized per bucket width — resolving
        the serving plan is cached in the CompileCache but the arm string
        need not be rebuilt per dispatch. Never allowed to fail a
        completed dispatch: the observation is advisory."""
        try:
            bh, bw, ch = bucket
            key = self._tune_keys.get(bw)
            if key is None:
                from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import (
                    pipeline_fingerprint,
                )
                from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import (
                    resolve_serving_plan,
                )

                built = resolve_serving_plan(
                    self.cache.pipe, self.cache.plan, self.cache.backend, bw,
                    self.cache.device,
                )
                arm = "plan:" + ("off" if built is None else built.mode)
                key = (pipeline_fingerprint(self.cache.pipe.ops), arm)
                self._tune_keys[bw] = key
            pipe_fp, arm = key
            from mpi_cuda_imagemanipulation_tpu_torch.tune.store import (
                online_store,
            )

            online_store.record_dispatch(
                pipe_fp, bw, arm, device_s / max(n, 1)
            )
        except Exception:
            # the dispatch already succeeded; a tuning-store hiccup (no
            # backend, corrupt file, unexpected plan shape) must not
            # surface as a serving error
            pass

    def _note_retry(self, bucket, attempt, exc, delay_s, live=()) -> None:
        self.metrics.on_retry()
        for r in live:
            # retry attempts are events on the request's trace, so a p99
            # outlier pulled up by id shows its whole recovery history
            obs_trace.event(
                "serve.retry", parent=r.trace_ctx(), attempt=attempt,
                error=type(exc).__name__, backoff_ms=delay_s * 1e3,
            )
        self._log.info(
            "retrying bucket %s after %s (attempt %d, backoff %.1fms)",
            bucket, type(exc).__name__, attempt, delay_s * 1e3,
        )

    def _bisect_solo(self, live: list[Request]) -> None:
        """Failed-batch isolation: each member gets its own retried solo
        dispatch. Survivors complete normally; the poison fails alone with
        the distinct `quarantined` status."""
        bucket = live[0].bucket
        breaker = self.breakers.get(bucket)
        for r in live:
            with obs_trace.span(
                "serve.bisect", parent=r.trace_ctx(), bucket=str(bucket)
            ):
                try:
                    out, nb, device_s = call_with_retry(
                        lambda r=r: self._run_batch([r]),
                        policy=self.retry_policy,
                        rng=self._retry_rng,
                        on_retry=lambda a, e, d, r=r: self._note_retry(
                            bucket, a, e, d, live=(r,)
                        ),
                    )
                except Exception as e:
                    self.metrics.on_quarantine()
                    obs_trace.event(
                        "serve.quarantine", parent=r.trace_ctx(),
                        error=type(e).__name__,
                    )
                    flight_recorder.dump(
                        "quarantine",
                        extra={
                            "bucket": str(bucket),
                            "error": type(e).__name__,
                        },
                    )
                    self._resolve(
                        r, STATUS_QUARANTINED, f"{type(e).__name__}: {e}"
                    )
                    continue
            # the path works without the poison: healthy signal
            breaker.on_success()
            self._complete([r], out, nb, device_s)
        self._update_health()

    def _dispatch_degraded(self, live: list[Request]) -> None:
        """Open-breaker path: serve each request through the golden
        per-request fallback (bit-identical output, no micro-batching).
        Group lanes bring their own fallback (the producer's solo
        dispatch); chain buckets use the scheduler-wide one."""
        group = live[0].group
        fallback = group.fallback if group is not None else self.fallback
        if fallback is None:
            self.metrics.on_error(len(live))
            for r in live:
                self._resolve(
                    r, STATUS_ERROR,
                    f"circuit open for bucket {r.bucket} and no fallback",
                )
            return
        for r in live:
            r.t_dispatch = self._clock()
            try:
                out = _force_host(fallback(r.img))
            except Exception as e:
                self.metrics.on_quarantine()
                self._resolve(
                    r, STATUS_QUARANTINED, f"{type(e).__name__}: {e}"
                )
                continue
            t_done = self._clock()
            r.result = out
            r.t_done = t_done
            r.status = STATUS_OK
            self.metrics.on_degraded()
            self.metrics.on_complete(
                r.t_dispatch - r.t_submit, t_done - r.t_submit, r.trace_id
            )
            r.trace.set(status=STATUS_OK, degraded=True)
            r.trace.end()
            r.done.set()

    def _update_health(self) -> None:
        """Drive the serving <-> degraded edge off the breaker board."""
        if self.health is None:
            return
        state = self.health.state
        if state == SERVING and self.breakers.any_open():
            self._log.warning("dispatch breaker open: health -> degraded")
            self.health.to(DEGRADED)
        elif state == DEGRADED and not self.breakers.any_open():
            self._log.info("breakers recovered: health -> serving")
            self.health.to(SERVING)


def _min_dim(cache: CompileCache) -> int:
    from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import min_true_dim

    return min_true_dim(cache.pipe)


def _host(x) -> np.ndarray:
    """One leaf on the host as numpy: a tensor is copied back (waiting for
    the work that makes it), an array passes through."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _force_host(out):
    """Force a device result to host, structure-preserving: chain
    dispatches return one stacked tensor, group lanes a result tree."""
    if isinstance(out, dict):
        return {k: _force_host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_force_host(v) for v in out)
    return _host(out)


def _tree_index(out, k: int):
    """Slice member k out of a stacked result tree (group lanes): every
    leaf loses its batch dimension, the structure is preserved."""
    if isinstance(out, dict):
        return {key: _tree_index(v, k) for key, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_tree_index(v, k) for v in out)
    return _host(out)[k]
