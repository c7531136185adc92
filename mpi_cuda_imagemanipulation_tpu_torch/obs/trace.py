"""Request-scoped trace spans: one timeline per run or request. The
counterpart of the JAX package's ``obs/trace.py``, with the same spans,
sampling, tail keep and export.

A span is a named wall-clock interval on one thread; spans form a tree
per *trace* (one trace per CLI run or dispatch), and retries or breaker
transitions are instant events on the owning trace.

Design constraints, in order:

  * **Disarmed cost ~ zero.** `span()`/`event()` check one module flag and
    return a shared no-op singleton: no allocation, no lock, no clock
    read. Sampled-out traces behave the same: the root decision is made
    once per trace, and every descendant sees `sampled=False` and gets the
    same singleton back.
  * **Thread-safe, cross-thread parentage.** A `SpanContext` is a value
    (trace_id, span_id, sampled) that travels with the work item, and
    `span(name, parent=ctx)` re-anchors on any thread. Same-thread nesting
    rides a `contextvars.ContextVar`, so `with span(...)` blocks compose
    without plumbing. Completed spans append to one bounded deque under a
    lock.
  * **Traces start only on purpose.** `span()` with no resolvable parent
    is a no-op, never an implicit new trace: only `start_trace()` makes
    the sampling decision.

A span is a host-clock interval. CUDA launches are asynchronous, so a
span around kernel launches measures their enqueue unless the caller
synchronises the device inside it (the CLI's ``run.compile_and_run`` and
``run.steady`` do; ``sharded.dispatch`` is a host-enqueue span).

Export is Chrome/Perfetto trace-event JSON (`ph:"X"` duration events,
`ph:"i"` instants, metadata names), loadable in `ui.perfetto.dev`.
Timestamps use `time.perf_counter()` relative to the tracer's start, in
microseconds. Sampling is deterministic (every k-th trace at rate 1/k),
so a traced A/B re-run selects the same requests.

**Deferred tail keep** (`MCIM_TRACE_TAIL`, default 256 under an armed
tracer): with a tail buffer, a sampled-OUT root still records: its spans
go to a bounded side buffer (`tail` concurrently open traces; the oldest
evicts when full), and when the root span ends the trace is PROMOTED into
the event buffer (the root recorded an error-class status, or its
duration is at or above the p99 of recent roots) or dropped whole.
`trace_kept(trace_id)` tells reporting layers which ids resolve in the
export. MCIM_TRACE_TAIL=0 gives pure root sampling.
"""

from __future__ import annotations

import contextvars
import json
import math
import os
import threading
import time
from collections import OrderedDict, deque
from typing import NamedTuple

from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder


class SpanContext(NamedTuple):
    """The value that carries parentage across threads: put it on the work
    item at submit, pass it as `parent=` where the work resumes."""

    trace_id: str
    span_id: int
    sampled: bool


NOT_SAMPLED = SpanContext("", 0, False)

_current: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "mcim_obs_span", default=None
)


class _NoopSpan:
    """The shared do-nothing span: every disarmed/sampled-out call returns
    THIS object (tests assert identity — that is the no-allocation
    guarantee on the hot path)."""

    __slots__ = ()
    trace_id = ""
    span_id = 0

    def context(self) -> SpanContext:
        return NOT_SAMPLED

    def set(self, **args) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One live span. `end()` (or context-manager exit) records it; `set()`
    attaches attributes; `context()` is the handle children parent to.
    A Span may be ended from a different thread than the one that opened
    it (the retroactive queue-wait pattern: open at submit, end at pop)."""

    __slots__ = (
        "_tracer", "name", "trace_id", "span_id", "parent_id",
        "t0", "tid", "args", "_token", "_ended",
    )

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: int, parent_id: int, args: dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.args = args
        self.tid = threading.get_ident()
        self._token = None
        self._ended = False
        self.t0 = time.perf_counter()

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, True)

    def set(self, **args) -> None:
        self.args.update(args)

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self._tracer._record(self, time.perf_counter())

    def __enter__(self) -> "Span":
        self._token = _current.set(self.context())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.end()
        return False


# root statuses that must NOT promote a buffered tail trace: intentional
# outcomes (ok, explicit sheds, client garbage) — a shed storm promoting
# every trace would defeat sampling exactly when it matters most
_TAIL_BENIGN_STATUSES = {
    "ok", "overloaded", "shed", "rejected",
    "200", "204", "400", "429", "503",
}
# minimum recent-root sample before the slow-promotion threshold engages
_TAIL_MIN_DURS = 32


class Tracer:
    """Span collector: bounded event buffer behind one lock, deterministic
    trace-level sampling, deferred tail keep, Chrome trace-event export."""

    def __init__(self, *, sample: float = 1.0, max_events: int = 200_000,
                 tail: int = 0):
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.sample = sample
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._thread_names: dict[int, str] = {}
        self._next_span = 0
        self._n_traces = 0
        self._n_sampled = 0
        # deferred tail keep (module docstring): sampled-out traces buffer
        # here until their root decides; bounded at `tail` open traces
        self.tail_cap = max(0, int(tail))
        self._tail: OrderedDict[str, list] = OrderedDict()
        # recently dropped provisional ids (bounded): trace_kept() answers
        # "will this id resolve in the export" for reporting layers
        self._tail_dropped: OrderedDict[str, None] = OrderedDict()
        self._root_durs: deque = deque(maxlen=512)
        self.tail_counts = {
            "buffered": 0, "kept_error": 0, "kept_slow": 0,
            "dropped": 0, "evicted": 0,
        }
        self.t0 = time.perf_counter()
        # run-unique trace-id prefix so merged multi-process traces never
        # collide (pid + coarse start time)
        self._prefix = f"{os.getpid():x}{int(time.time()) & 0xffffff:x}"

    # -- span creation -----------------------------------------------------

    def _new_span(self, name: str, trace_id: str, parent_id: int,
                  args: dict) -> Span:
        with self._lock:
            self._next_span += 1
            sid = self._next_span
            tid = threading.get_ident()
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
        return Span(self, name, trace_id, sid, parent_id, args)

    def start_trace(self, name: str, *, trace_id: str | None = None,
                    **args) -> Span:
        """Root span of a NEW trace — the only call that makes a sampling
        decision. Deterministic: at rate f, trace n is kept iff
        floor(n*f) > floor((n-1)*f), i.e. evenly every 1/f traces.

        `trace_id` ADOPTS an upstream id instead of minting one (the
        fabric router → replica hop: the router made the sampling
        decision and propagated the id via X-Trace-Id, so the replica's
        root span joins the same distributed trace rather than rolling
        its own dice — exports from both processes merge on the id)."""
        with self._lock:
            self._n_traces += 1
            n = self._n_traces
            take = trace_id is not None or math.floor(
                n * self.sample
            ) > math.floor((n - 1) * self.sample)
            if take:
                self._n_sampled += 1
        if not take:
            if self.tail_cap <= 0:
                return NOOP_SPAN
            # deferred tail keep: record this trace provisionally; the
            # root's end decides promote-or-drop (module docstring)
            trace_id = f"{self._prefix}-{n:x}"
            with self._lock:
                self._tail[trace_id] = []
                self.tail_counts["buffered"] += 1
                while len(self._tail) > self.tail_cap:
                    old_tid, _evs = self._tail.popitem(last=False)
                    self._mark_dropped_locked(old_tid)
                    self.tail_counts["evicted"] += 1
        trace_id = trace_id or f"{self._prefix}-{n:x}"
        span = self._new_span(name, trace_id, 0, args)
        span.args.setdefault("trace_id", trace_id)
        return span

    def span(self, name: str, parent: SpanContext | None = None, **args):
        """Child span. `parent=None` uses the calling thread's current
        span; no resolvable sampled parent → the shared no-op (a span
        never implicitly starts a trace)."""
        if parent is None:
            parent = _current.get()
        if parent is None or not parent.sampled:
            return NOOP_SPAN
        return self._new_span(name, parent.trace_id, parent.span_id, args)

    def event(self, name: str, parent: SpanContext | None = None,
              **args) -> None:
        """Instant event on the parent's trace (retry attempts, breaker
        transitions). Same no-op rule as `span`."""
        if parent is None:
            parent = _current.get()
        if parent is None or not parent.sampled:
            return
        ts = (time.perf_counter() - self.t0) * 1e6
        tid = threading.get_ident()
        args.setdefault("trace_id", parent.trace_id)
        args.setdefault("parent_id", parent.span_id)
        ev = {
            "ph": "i", "s": "t", "name": name, "ts": ts,
            "tid": tid, "args": args,
        }
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            buf = self._tail.get(parent.trace_id)
            if buf is not None:
                buf.append(ev)  # provisional: the root's end decides
            elif parent.trace_id not in self._tail_dropped:
                self._events.append(ev)

    def _record(self, span: Span, t1: float) -> None:
        ts = (span.t0 - self.t0) * 1e6
        args = span.args
        args.setdefault("trace_id", span.trace_id)
        args["span_id"] = span.span_id
        if span.parent_id:
            args.setdefault("parent_id", span.parent_id)
        dur_us = max((t1 - span.t0) * 1e6, 0.0)
        ev = {
            "ph": "X", "name": span.name, "ts": ts,
            "dur": dur_us,
            "tid": span.tid, "args": args,
        }
        is_root = span.parent_id == 0
        with self._lock:
            buf = self._tail.get(span.trace_id)
            if buf is not None:
                buf.append(ev)
                if is_root:
                    # the provisional trace is complete: promote or drop
                    self._decide_tail_locked(span.trace_id, args, dur_us)
            elif span.trace_id not in self._tail_dropped:
                self._events.append(ev)
            if is_root:
                # every root (sampled-in included) feeds the slow
                # threshold, so "p99-slow" means p99 of ALL roots
                self._root_durs.append(dur_us)
        # flight-recorder summary (obs/recorder.py): the always-on ring
        # keeps recent span names/durations even after this buffer wraps,
        # so a post-mortem dump shows what the process was doing
        recorder.note(
            "span", name=span.name, dur_ms=dur_us / 1e3,
            trace_id=span.trace_id,
        )

    # -- deferred tail keep (all called under self._lock) --------------------

    def _mark_dropped_locked(self, trace_id: str) -> None:
        self._tail_dropped[trace_id] = None
        while len(self._tail_dropped) > 4096:
            self._tail_dropped.popitem(last=False)

    def _tail_reason_locked(self, args: dict, dur_us: float) -> str | None:
        if "error" in args:
            return "error"
        status = args.get("status")
        if (
            status is not None
            and str(status) not in _TAIL_BENIGN_STATUSES
        ):
            # quarantined / deadline_expired / 422 / 5xx / anything the
            # caller flagged beyond the intentional outcomes
            return "error"
        if len(self._root_durs) >= _TAIL_MIN_DURS:
            durs = sorted(self._root_durs)
            p99 = durs[min(len(durs) - 1, int(0.99 * len(durs)))]
            if dur_us >= p99:
                return "slow"
        return None

    def _decide_tail_locked(
        self, trace_id: str, root_args: dict, dur_us: float
    ) -> None:
        buf = self._tail.pop(trace_id, None)
        if buf is None:
            return
        reason = self._tail_reason_locked(root_args, dur_us)
        if reason is None:
            self._mark_dropped_locked(trace_id)
            self.tail_counts["dropped"] += 1
            return
        root_args.setdefault("tail_kept", reason)
        self._events.extend(buf)
        self.tail_counts[f"kept_{reason}"] += 1

    def trace_kept(self, trace_id: str) -> bool:
        """Whether `trace_id` will resolve in this tracer's export:
        False only for a provisional trace that was dropped/evicted
        (in-flight and sampled-in ids report True)."""
        with self._lock:
            return trace_id not in self._tail_dropped

    # -- reporting ---------------------------------------------------------

    def counts(self) -> dict:
        with self._lock:
            return {
                "traces": self._n_traces,
                "sampled": self._n_sampled,
                "events": len(self._events),
                "sample": self.sample,
                "tail": dict(self.tail_counts),
                "tail_open": len(self._tail),
            }

    def drain(self) -> list[dict]:
        """Pop every buffered raw event (tests / incremental export)."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
        return out

    def chrome_events(self, *, pid: int | None = None,
                      process_name: str = "mcim-host") -> list[dict]:
        """The buffered spans as Chrome trace-event dicts (non-draining),
        with process/thread metadata prepended."""
        pid = os.getpid() if pid is None else pid
        with self._lock:
            events = [dict(e) for e in self._events]
            names = dict(self._thread_names)
        meta: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]
        for tid, tname in sorted(names.items()):
            meta.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
        for e in events:
            e["pid"] = pid
        return meta + events

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON (`{"traceEvents": [...]}`); returns
        the number of events written. Load in ui.perfetto.dev, or merge
        with a device trace in Perfetto."""
        events = self.chrome_events()
        with open(path, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"}, f
            )
        return len(events)


# -- module-level default tracer (the CLI/server wiring surface) -----------

ENV_SAMPLE = "MCIM_TRACE_SAMPLE"
ENV_TAIL = "MCIM_TRACE_TAIL"


def _tail_from_env(env=None) -> int:
    from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

    raw = env_registry.get(ENV_TAIL, env=env)
    return int(raw) if raw else 0


_tracer: Tracer | None = None
_enabled = False  # lock-free fast-path flag, flipped only by (de)configure


def configure(*, sample: float = 1.0, max_events: int = 200_000,
              tail: int | None = None) -> Tracer:
    """Arm the process-wide tracer (idempotent per call: a fresh buffer).
    `--trace-sample` < 1 keeps tracing cheap enough to leave on; the
    deferred tail-keep buffer (`tail`, default MCIM_TRACE_TAIL) then
    guarantees error/quarantine/p99-slow traces still export."""
    global _tracer, _enabled
    if tail is None:
        tail = _tail_from_env()
    _tracer = Tracer(sample=sample, max_events=max_events, tail=tail)
    _enabled = True
    return _tracer


def configure_from_env(env=None) -> Tracer | None:
    """Arm iff MCIM_TRACE_SAMPLE is set (a fraction; 1 = every trace)."""
    from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

    raw = env_registry.get(ENV_SAMPLE, env=env)
    if raw:
        return configure(
            sample=float(raw), tail=_tail_from_env(env)
        )
    return None


def disable() -> None:
    global _tracer, _enabled
    _enabled = False
    _tracer = None


def enabled() -> bool:
    return _enabled


def get_tracer() -> Tracer | None:
    return _tracer


def start_trace(name: str, *, trace_id: str | None = None, **args):
    if not _enabled:
        return NOOP_SPAN
    return _tracer.start_trace(name, trace_id=trace_id, **args)


def span(name: str, parent: SpanContext | None = None, **args):
    if not _enabled:
        return NOOP_SPAN
    return _tracer.span(name, parent=parent, **args)


def event(name: str, parent: SpanContext | None = None, **args) -> None:
    if not _enabled:
        return
    _tracer.event(name, parent=parent, **args)


def current_context() -> SpanContext | None:
    """The calling thread's active span context (None outside any span).
    Capture at submit time, hand to the thread that resumes the work."""
    return _current.get()


def current_trace_id() -> str:
    """The active trace id or "" — the log-line join key (utils/log.py)."""
    ctx = _current.get()
    return ctx.trace_id if ctx is not None and ctx.sampled else ""


def export(path: str) -> int:
    """Export the default tracer's buffer; 0 when tracing is disarmed."""
    if _tracer is None:
        return 0
    return _tracer.export(path)


def trace_kept(trace_id: str) -> bool:
    """Whether `trace_id` resolves in the default tracer's export: False
    only for a tail-dropped provisional trace. Reporting layers use this
    to prefer ids a reader can actually pull up (serve/loadgen's
    slow-trace column)."""
    if not _enabled or _tracer is None or not trace_id:
        return True
    return _tracer.trace_kept(trace_id)
