"""Serving health state machine: what /healthz means. The counterpart of
the JAX package's ``resilience/health.py``; the port's serving layer,
which drives it, is still to come.

    starting   compile-cache warmup in progress; not admitting (503)
    serving    normal operation (200)
    degraded   admitting, but at least one dispatch breaker is open and
               traffic for those buckets runs the golden fallback (200 —
               load balancers should keep sending; the body says degraded)
    draining   SIGTERM received: admission stopped, in-flight work is
               being flushed under a deadline (503 — take me out of
               rotation, but don't kill me yet)
    stopped    terminal (503)

Transitions are whitelisted; an illegal one raises (a scheduler callback
firing after shutdown is a bug worth surfacing, not a log line). The
serving ⇄ degraded pair is driven by the BreakerBoard via the scheduler;
starting → serving by ServeApp.start(); draining/stopped by Server.close()
and the SIGTERM handler.
"""

from __future__ import annotations

import threading
import time

STARTING = "starting"
SERVING = "serving"
DEGRADED = "degraded"
DRAINING = "draining"
STOPPED = "stopped"

# every state, in lifecycle order — the /metrics health gauge's label set
STATES = (STARTING, SERVING, DEGRADED, DRAINING, STOPPED)

_TRANSITIONS: dict[str, tuple[str, ...]] = {
    STARTING: (SERVING, STOPPED),
    SERVING: (DEGRADED, DRAINING, STOPPED),
    DEGRADED: (SERVING, DRAINING, STOPPED),
    DRAINING: (STOPPED,),
    STOPPED: (),
}

# /healthz HTTP mapping: 200 = keep routing traffic here.
HTTP_OK = (SERVING, DEGRADED)


class HealthState:
    def __init__(self, *, clock=time.time):
        self._lock = threading.Lock()
        self._clock = clock
        self._state = STARTING
        self._since = clock()
        self.transitions: list[tuple[str, str]] = []

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def to(self, new: str) -> None:
        """Transition, validating against the whitelist. Self-transitions
        are no-ops (breaker callbacks may re-assert the current state)."""
        with self._lock:
            if new == self._state:
                return
            if new not in _TRANSITIONS[self._state]:
                raise ValueError(
                    f"illegal health transition {self._state!r} -> {new!r}"
                )
            self.transitions.append((self._state, new))
            self._state = new
            self._since = self._clock()

    def is_admitting(self) -> bool:
        return self.state in (SERVING, DEGRADED)

    def http_code(self) -> int:
        return 200 if self.state in HTTP_OK else 503

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "since_unix_s": self._since,
                "transitions": len(self.transitions),
            }
