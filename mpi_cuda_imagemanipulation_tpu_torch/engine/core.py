"""Bounded-depth asynchronous execution engine: keep the device busy while
the host decodes, copies and encodes. The counterpart of the JAX package's
``engine/core.py``, rewritten for PyTorch and CUDA streams.

The serial loop runs decode -> H2D -> compute -> D2H -> encode with the
device idle during every host phase (the reference's per-launch
scatter/compute/gather round trip, kernel.cu:163,202). CUDA launches are
asynchronous, so the fix is structural: software-pipeline the stages over
consecutive work items.

    caller thread              completion thread        encode pool
    -------------              -----------------        -----------
    make_input (host build)
    stage (pinned H2D on a     +---------------+
      copy stream)             | bounded FIFO  |
    run (enqueue only)         | (<= inflight) |-> force (wait for the
    D2H enqueued on a side  -> +---------------+    D2H's event, in
      stream after the                              submission order)
      compute's event                                 |
          ^                                           +-> on_done(key, out)
          +-- blocks when full (backpressure)             [<= io_threads]

Invariants (as in the JAX engine):

  * **Bounded everywhere.** At most ``inflight`` dispatches are
    outstanding: a slot is taken before the computation enqueues and given
    back when its result is forced, so taking it blocks the caller. The
    encode pool's backlog is capped by a semaphore, so a slow writer stalls
    the completion thread rather than buffering results without bound.
  * **Completion in submission order.** Results are forced and handed to
    the pool in submission order. ``on_done`` callbacks of different items
    may interleave across pool workers (``io_threads=1`` serialises them);
    ``ordered_done=True`` delivers them strictly in order, and a failed
    item advances that gate.
  * **Results are bit-identical to the serial loop**: the engine changes
    when work happens, never what runs.
  * **Failure is per item.** A force failure goes to that item's
    ``on_error`` on the completion thread; an ``on_done`` failure on the
    pool worker. The armed ``engine.complete`` failpoint
    (resilience/failpoints.py) injects the first kind.

What replaces JAX's transfers:

  * ``stage`` (JAX: ``jax.device_put``): ``device_stager(device)`` copies
    the host array into a pinned buffer (``PinnedPool``: ``inflight + 1``
    buffers a shape, each reused only once its copy's event has fired),
    issues ``to(device, non_blocking=True)`` on a copy stream of its own
    (``torch.cuda.Stream()``, never the legacy default stream, so the copy
    does not serialise with compute), makes the caller's current stream
    wait on that copy, and calls ``record_stream`` on the staged tensor so
    that the caching allocator does not hand its memory to a later
    allocation while a kernel on the compute stream still reads it.
  * the D2H (JAX: ``jax.device_get`` on the completion thread): right after
    ``run`` returns, on the caller's thread, ``submit`` enqueues each CUDA
    tensor of the result into pinned host memory on a side stream, ordered
    after the compute by an event; the completion thread only waits on the
    copy's event (``_force``). The pinned result comes from PyTorch's
    caching host allocator: its block is reused only after the consumer
    drops the array.

``run`` must only enqueue. Pair the engine with
``Pipeline.jit(donate=True)`` / ``Pipeline.batched(donate=True)`` so that
each dispatch's staged buffer goes back to the caching allocator once the
work is enqueued. On the CPU ``stage`` and the D2H are plain copies and
the engine's logic is the same.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.engine.metrics import EngineMetrics
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

DEFAULT_INFLIGHT = 2
DEFAULT_IO_THREADS = 4


class PinnedPool:
    """Pinned host buffers for H2D staging, at most `depth` per (shape,
    dtype). A buffer is handed out again only once the event recorded after
    its last copy has fired; with every buffer of a shape in flight,
    `acquire` waits for the oldest copy."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self._bufs: dict[tuple, list[list]] = {}  # key -> [[buffer, event or None]]
        self._lock = threading.Lock()

    def acquire(self, shape, dtype) -> list:
        """An entry [buffer, event] whose buffer no copy reads any more."""
        key = (tuple(shape), dtype)
        with self._lock:
            entries = self._bufs.setdefault(key, [])
            for e in entries:
                if e[1] is None or e[1].query():
                    entries.remove(e)
                    entries.append(e)  # most recently used last
                    return e
            if len(entries) < self.depth:
                e = [torch.empty(shape, dtype=dtype, pin_memory=True), None]
                entries.append(e)
                return e
            e = entries.pop(0)  # the oldest copy in flight
            entries.append(e)
        e[1].synchronize()
        return e

    def nbytes(self) -> int:
        """The bytes of every buffer the pool holds."""
        with self._lock:
            return sum(e[0].nbytes for entries in self._bufs.values() for e in entries)

    def clear(self) -> None:
        """Drop every buffer, once its last copy has finished."""
        with self._lock:
            held = [e for entries in self._bufs.values() for e in entries]
            self._bufs.clear()
        for e in held:
            if e[1] is not None:
                e[1].synchronize()


def device_stager(device, *, inflight: int = DEFAULT_INFLIGHT) -> Callable[[Any], torch.Tensor]:
    """The engine's ``stage`` for `device`: a host array (numpy or CPU
    tensor) -> a tensor on `device` whose copy is ordered before any work
    the calling thread's current stream enqueues after it (module
    docstring). On the CPU a plain copy. The function's `pool` attribute is
    its PinnedPool (None on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        def copy(x) -> torch.Tensor:
            return torch.as_tensor(x).clone()

        copy.pool = None
        return copy
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    pool = PinnedPool(inflight + 1)
    copy_stream = torch.cuda.Stream(device)

    def stage(x) -> torch.Tensor:
        src = torch.as_tensor(x)
        entry = pool.acquire(src.shape, src.dtype)
        buf = entry[0]
        buf.copy_(src)
        with torch.cuda.stream(copy_stream):
            staged = buf.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        entry[1] = done
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        staged.record_stream(compute)
        return staged

    stage.pool = pool
    return stage


@dataclass
class _D2H:
    """One result tensor's copy to pinned host memory, in flight."""

    host: torch.Tensor
    done: torch.cuda.Event


_SENTINEL = object()


@dataclass
class _InFlight:
    key: Any
    out: Any  # the result, its CUDA tensors as D2H copies in flight (_D2H)
    on_done: Callable[[Any, Any, dict], None]
    on_error: Callable[[Any, BaseException], None]
    info: dict = field(default_factory=dict)
    seq: int = 0  # submission index (ordered_done delivery gate)


class Engine:
    """The async pipeline behind ``batch --inflight``. One instance owns one
    completion thread, one encode pool and a D2H stream per device;
    ``submit`` is single-producer by convention (the batch loop),
    completions fan out to the pool."""

    def __init__(
        self,
        *,
        inflight: int = DEFAULT_INFLIGHT,
        io_threads: int = DEFAULT_IO_THREADS,
        stage: Callable[[Any], Any] | None = None,
        metrics: EngineMetrics | None = None,
        name: str = "engine",
        ordered_done: bool = False,
    ):
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        if io_threads < 1:
            raise ValueError(f"io_threads must be >= 1, got {io_threads}")
        self.inflight = inflight
        self.io_threads = io_threads
        # H2D staging hook (device_stager): runs on the caller thread ahead
        # of dispatch so the transfer is already in flight when the
        # computation enqueues. None = inputs go up with the dispatch
        # (sharded/data-parallel callables place their own inputs).
        self._stage = stage
        self._d2h_streams: dict[torch.device, torch.cuda.Stream] = {}
        self.metrics = metrics or EngineMetrics()
        self.name = name
        # the in-flight bound: a dispatch slot is reserved BEFORE the
        # computation enqueues and released once its result is forced, so
        # at most `inflight` dispatches are ever outstanding on the device
        # (the completion FIFO itself never exceeds that)
        self._slots = threading.BoundedSemaphore(inflight)
        self._q: queue.Queue = queue.Queue()
        self._pool: ThreadPoolExecutor | None = None
        # encode backlog bound: a slow writer blocks the completion thread
        # (and transitively the submitter) instead of buffering results
        self.encode_backlog = max(2 * io_threads, inflight)
        self._encode_slots = threading.BoundedSemaphore(self.encode_backlog)
        self._outstanding = 0  # submitted, not yet fully resolved
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._log = get_logger()
        # ordered_done: deliver on_done strictly in submission order (the
        # tile-stream mode - an incremental encoder can only append row
        # band k after k-1). Results are already FORCED in submission
        # order; this gate additionally serialises the pool's delivery.
        # Deadlock-free: the completion thread hands items to the FIFO
        # pool in order, so the lowest outstanding seq is always running
        # or queued ahead of every waiter.
        self._ordered = ordered_done
        self._seq = 0
        self._next_done = 0
        self._resolved: set[int] = set()  # seqs resolved past the gate
        self._order_cond = threading.Condition()

    # -- lifecycle ---------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def stage(self) -> Callable[[Any], Any] | None:
        """The H2D staging hook this engine was built with (None: none)."""
        return self._stage

    def _ensure_started(self) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError(f"{self.name} is closed")
            if self._thread is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.io_threads,
                    thread_name_prefix=f"mcim-{self.name}-io",
                )
                self._thread = threading.Thread(
                    target=self._completion_loop,
                    name=f"mcim-{self.name}-complete",
                    daemon=True,
                )
                self._thread.start()

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every submitted item has fully resolved (on_done or
        on_error returned). True on drained, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._outstanding > 0:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        return True

    def close(self, timeout: float | None = None) -> None:
        """Drain, then stop the completion thread and the encode pool.
        Idempotent; safe to call with work in flight (it finishes first)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
        drained = self.flush(timeout)
        if self._thread is not None:
            self._q.put(_SENTINEL)
            self._thread.join(timeout=timeout)
        if self._pool is not None:
            # a timed-out drain must not hang interpreter exit on a wedged
            # writer; the pool threads are abandoned (daemonic teardown)
            self._pool.shutdown(wait=drained)
        if not drained:
            self._log.warning(
                "%s: close timed out with %d submissions unresolved",
                self.name, self._outstanding,
            )

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- dispatch stage (caller thread) ------------------------------------

    def submit(
        self,
        key: Any,
        make_input: Callable[[], Any],
        run: Callable[[Any], Any],
        *,
        on_done: Callable[[Any, Any, dict], None],
        on_error: Callable[[Any, BaseException], None],
    ) -> None:
        """Build + stage + asynchronously dispatch one work item.

        ``make_input()`` and ``run(staged_input)`` execute on the calling
        thread; ``run`` must only *enqueue* (CUDA launches are
        asynchronous); its exceptions (host-side dispatch failures, armed
        failpoints) propagate to the caller, which still owns retry policy
        at this stage. After a successful enqueue the result's D2H copy is
        enqueued (`_start_d2h`) and the item is handed to the completion
        thread; blocks while ``inflight`` items are outstanding.

        ``on_done(key, host_out, info)`` runs on the encode pool;
        ``on_error(key, exc)`` runs on the completion thread (force
        failures) or the pool worker (``on_done`` failures). ``info``
        carries the item's stage timings (seconds): build/h2d/enqueue at
        submit, queue_wait/force stamped at completion."""
        self._ensure_started()
        info: dict = {}
        t0 = time.perf_counter()
        x = make_input()
        t1 = time.perf_counter()
        if self._stage is not None:
            # H2D can start NOW even when every dispatch slot is taken —
            # the upload overlaps the in-flight compute
            x = self._stage(x)
        t2 = time.perf_counter()
        # backpressure: all `inflight` slots taken means the device already
        # has that many dispatches outstanding - stall the producer here,
        # before it enqueues (and before it decodes further upstream)
        self._slots.acquire()
        try:
            out = self._start_d2h(run(x))
        except BaseException:
            self._slots.release()
            raise
        del x  # the staged input: nothing here reads it again
        t3 = time.perf_counter()
        info["build_s"] = t1 - t0
        info["h2d_s"] = t2 - t1
        info["enqueue_s"] = t3 - t2
        info["t_dispatch"] = t3
        # trace parentage hops threads with the item: the caller's active
        # span (a batch root) anchors the completion thread's force span and
        # the pool's encode span
        info["trace"] = obs_trace.current_context()
        self.metrics.on_stage("build", info["build_s"])
        self.metrics.on_stage("h2d", info["h2d_s"])
        self.metrics.on_stage("enqueue", info["enqueue_s"])
        with self._cond:
            self._outstanding += 1
            seq = self._seq
            self._seq += 1
        self.metrics.on_submit(t3)
        self._q.put(_InFlight(key, out, on_done, on_error, info, seq))

    # -- completion stage (own thread) -------------------------------------

    def _completion_loop(self) -> None:
        while True:
            idle_from = (
                time.perf_counter()
                if self.metrics.unforced() == 0
                else None
            )
            if idle_from is not None:
                self.metrics.idle_open(idle_from)
            item = self._q.get()
            if item is _SENTINEL:
                return
            if idle_from is not None:
                # nothing was enqueued on the device while we waited: that
                # whole wait is device-idle time (the serial loop's decode
                # and encode stalls show up exactly here)
                self.metrics.idle_close(time.perf_counter(),
                                        count=self.metrics.submitted > 0)
            self._complete_one(item)

    def _complete_one(self, item: _InFlight) -> None:
        t0 = time.perf_counter()
        item.info["queue_wait_s"] = t0 - item.info["t_dispatch"]
        fspan = obs_trace.span(
            "engine.force", parent=item.info.get("trace")
        )
        try:
            # injected completion-stage fault (the D2H and transfer class);
            # the recovery behind it is the caller's on_error
            failpoints.maybe_fail("engine.complete", key=item.key)
            host = self._force(item.out)
        except Exception as e:
            fspan.set(error=type(e).__name__)
            fspan.end()
            self.metrics.on_forced()
            self._slots.release()
            self.metrics.on_failed(time.perf_counter())
            # an item that dies before the pool must still advance the
            # ordered-delivery gate, or every later tile waits forever
            self._advance_order(item)
            self._resolve_error(item, e)
            return
        fspan.end()
        t1 = time.perf_counter()
        item.info["force_s"] = t1 - t0
        self.metrics.on_forced()
        self._slots.release()
        ctx = item.info.get("trace")
        self.metrics.on_stage(
            "force", item.info["force_s"],
            exemplar=ctx.trace_id if ctx is not None and ctx.sampled else None,
        )
        self._encode_slots.acquire()
        assert self._pool is not None
        try:
            self._pool.submit(self._encode_one, item, host)
        except BaseException:
            self._encode_slots.release()
            raise

    def _start_d2h(self, out):
        """Enqueue the copy of each CUDA tensor of `out` (walking tuples and
        lists) into pinned host memory on the device's D2H stream, after an
        event recorded on the current stream behind the compute; anything
        else passes through."""
        if isinstance(out, (tuple, list)):
            return type(out)(self._start_d2h(o) for o in out)
        if not (isinstance(out, torch.Tensor) and out.device.type == "cuda"):
            return out
        dev = out.device
        side = self._d2h_streams.get(dev)
        if side is None:
            side = self._d2h_streams[dev] = torch.cuda.Stream(dev)
        computed = torch.cuda.Event()
        computed.record(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            side.wait_event(computed)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        out.record_stream(side)  # its memory is not reused before the copy ends
        return _D2H(host, done)

    @staticmethod
    def _force(out):
        """Wait for the result in host memory and return it as numpy, as
        `jax.device_get` does: walks tuples and lists; an in-flight D2H
        copy is waited on (its event); numpy arrays pass through, CPU
        tensors become their numpy view, and a CUDA tensor not yet copied
        is copied here."""
        if isinstance(out, (tuple, list)):
            return type(out)(Engine._force(o) for o in out)
        if isinstance(out, _D2H):
            out.done.synchronize()
            return out.host.numpy()
        if isinstance(out, torch.Tensor):
            return out.cpu().numpy()
        return out

    # -- encode stage (worker pool) ----------------------------------------

    def _wait_turn(self, item: _InFlight) -> None:
        """Block until every earlier submission's on_done has resolved
        (ordered_done mode). Runs on a pool worker; the lock is released
        before on_done runs, so user callbacks never execute under it."""
        with self._order_cond:
            while item.seq != self._next_done:
                self._order_cond.wait()

    def _advance_order(self, item: _InFlight) -> None:
        """Mark `item` resolved; the gate moves past every resolved seq in a
        row. (The JAX engine sets the gate to seq + 1, so an item that fails
        at force while earlier ones still wait their turn in the pool moves
        the gate past them and they wait forever.)"""
        if not self._ordered:
            return
        with self._order_cond:
            self._resolved.add(item.seq)
            while self._next_done in self._resolved:
                self._resolved.discard(self._next_done)
                self._next_done += 1
            self._order_cond.notify_all()

    def _encode_one(self, item: _InFlight, host) -> None:
        if self._ordered:
            self._wait_turn(item)
        t0 = time.perf_counter()
        try:
            # entered (not just timed) so the caller's on_done - response
            # crop/resolve, file encode/write - nests under engine.encode
            with obs_trace.span(
                "engine.encode", parent=item.info.get("trace")
            ):
                item.on_done(item.key, host, item.info)
        except Exception as e:
            self.metrics.on_failed(time.perf_counter())
            self._resolve_error(item, e)
            return
        finally:
            self._advance_order(item)
            self._encode_slots.release()
            self.metrics.on_stage("encode", time.perf_counter() - t0)
        self.metrics.on_complete(time.perf_counter())
        self._mark_resolved()

    def _resolve_error(self, item: _InFlight, exc: BaseException) -> None:
        try:
            item.on_error(item.key, exc)
        except Exception:
            self._log.exception(
                "%s: on_error handler failed for %r", self.name, item.key
            )
        finally:
            self._mark_resolved()

    def _mark_resolved(self) -> None:
        with self._cond:
            self._outstanding -= 1
            self._cond.notify_all()
