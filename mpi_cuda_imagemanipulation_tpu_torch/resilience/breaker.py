"""Circuit breakers: stop hammering a failing path, probe for recovery.
The counterpart of the JAX package's ``resilience/breaker.py``.

`CircuitBreaker` is the classic three-state machine:

    closed     normal operation; `failure_threshold` CONSECUTIVE failures
               trip it open (any success resets the streak);
    open       calls are refused (`allow()` is False) for `reset_timeout_s`
               — the failing resource gets quiet time instead of a retry
               storm, and the scheduler falls back to the golden path;
    half-open  after the timeout ONE probe call is admitted: success
               closes the breaker, failure re-opens it for another window.

`BreakerBoard` keys independent breakers by an arbitrary hashable (the
serving scheduler uses the shape bucket, so one poisoned bucket cannot
black out the others) and reports whether any member is open — the signal
that drives the health state machine's serving ⇄ degraded edge.

Everything is lock-protected and takes an injectable clock, so tests step
time explicitly.
"""

from __future__ import annotations

import threading
import time

from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder as flight_recorder

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        clock=time.monotonic,
        key=None,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        self._probe_in_flight = False
        self.open_events = 0  # cumulative trips (metrics)
        # the board's key (shape bucket / replica id) — only used to label
        # flight-recorder transition notes; None for standalone breakers
        self.key = key

    def _note_transition(self, new_state: str) -> None:
        # flight recorder (obs/recorder.py): breaker transitions are core
        # post-mortem evidence. A deque append — safe under self._lock.
        flight_recorder.note(
            "breaker", key=str(self.key), state=new_state
        )

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        # under lock: open -> half_open once the quiet window has elapsed
        if (
            self._state == OPEN
            and self._opened_at is not None
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._state = HALF_OPEN
            self._probe_in_flight = False
            self._note_transition(HALF_OPEN)

    def allow(self) -> bool:
        """May the caller attempt the protected operation right now?
        Half-open admits exactly one probe until its outcome is reported."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            was = self._state
            self._state = CLOSED
            self._consecutive_failures = 0
            self._opened_at = None
            self._probe_in_flight = False
            if was != CLOSED:
                self._note_transition(CLOSED)

    def on_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                # failed probe: straight back to open for another window
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_in_flight = False
                self.open_events += 1
                self._note_transition(OPEN)
                return
            self._consecutive_failures += 1
            if (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._state = OPEN
                self._opened_at = self._clock()
                self.open_events += 1
                self._note_transition(OPEN)

    def snapshot(self) -> dict:
        """State + cumulative trips, read atomically under this breaker's
        lock (the board's snapshot uses this so `open_events` is never
        read lockless while on_failure writes it)."""
        with self._lock:
            self._maybe_half_open()
            return {"state": self._state, "open_events": self.open_events}


class BreakerBoard:
    """Independent per-key breakers sharing one configuration."""

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        clock=time.monotonic,
    ):
        self._kw = dict(
            failure_threshold=failure_threshold,
            reset_timeout_s=reset_timeout_s,
            clock=clock,
        )
        self._lock = threading.Lock()
        self._breakers: dict = {}
        # trips of breakers since reset() — open_events is CUMULATIVE
        # over the board's lifetime, so dropping a replica's breaker on
        # restart cannot erase the evidence that it tripped
        self._reset_open_events = 0

    def get(self, key) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = self._breakers[key] = CircuitBreaker(**self._kw, key=key)
            return b

    def any_open(self) -> bool:
        with self._lock:
            breakers = list(self._breakers.values())
        return any(b.state != CLOSED for b in breakers)

    def open_keys(self) -> list:
        """The RAW keys whose breaker is not closed (snapshot() stringifies
        them for JSON) — the fabric heartbeat reports these per replica so
        the router can route a bucket around a replica whose breaker for
        exactly that bucket is open."""
        with self._lock:
            breakers = list(self._breakers.items())
        return [k for k, b in breakers if b.state != CLOSED]

    def reset(self, key) -> None:
        """Drop the breaker for `key` entirely (fresh CLOSED on next get).
        The fabric router calls this when a replica restarts — a new
        incarnation must not inherit its predecessor's open breaker. The
        dropped breaker's trips stay in the board's cumulative count."""
        with self._lock:
            b = self._breakers.pop(key, None)
        if b is None:
            return
        # the dropped breaker's trips are read under ITS lock (snapshot)
        # with the board lock released, then folded back in
        trips = b.snapshot()["open_events"]
        with self._lock:
            self._reset_open_events += trips

    def snapshot(self) -> dict:
        with self._lock:
            breakers = list(self._breakers.items())
            dropped = self._reset_open_events
        # each member read atomically under ITS lock (board lock released
        # first — the board->breaker order here matches every other path)
        per_key = {str(k): b.snapshot() for k, b in breakers}
        return {
            "open_events": dropped
            + sum(s["open_events"] for s in per_key.values()),
            "by_key": per_key,
        }
