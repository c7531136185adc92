"""Always-on flight recorder: a bounded ring of recent facts, dumped on
failure. The counterpart of the JAX package's ``obs/recorder.py``, with
the same ring, triggers, environment and file format.

Traces answer "where did request X go" when sampling kept it; the
recorder answers "what was this process doing just before it broke",
always. Every process keeps a bounded ring (a `deque(maxlen=cap)`:
CPython's deque append is atomic under the GIL, so no lock) of recent

  * span summaries (name, duration, trace id; obs/trace.py notes each
    recorded span),
  * dispatch summaries (bucket, batch size, device ms),
  * failpoint hits (site and call number, resilience/failpoints.py),
  * breaker transitions (key and new state, resilience/breaker.py),
  * heartbeat observations, and
  * WARNING+ log lines (utils/log.py attaches a handler).

`dump(trigger)` freezes the ring into one JSON artifact. The trigger
vocabulary is CLOSED: `KNOWN_TRIGGERS` is the JAX package's tuple as it
is, and the repository's static check (`tools/mcim_check.py`, rules
`obs-recorder-trigger-*`) holds every literal `dump("...")` in the
repository to it. In the port ``manual`` (operator- or test-initiated)
and the serving layer's ``breaker_open``, ``quarantine`` and
``sigterm_drain`` fire; the others name the JAX package's fabric and
profiling failure paths (replica_death, autoscale, preempt,
canary_rollback, systolic_fallback, profile_capture).

Dumps are rate-limited per trigger (`MCIM_RECORDER_MIN_INTERVAL_S`) so a
storm produces one artifact, not thousands; `force=True` bypasses the
limit. Artifacts land in `MCIM_RECORDER_DIR` (default
`artifacts/recorder/`) as `recorder_<trigger>_<pid>_<seq>.json`, with a
summary header (entry counts by kind, hot buckets by dispatch count, last
heartbeat per replica) before the raw ring.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

ENV_DIR = "MCIM_RECORDER_DIR"
ENV_CAP = "MCIM_RECORDER_CAP"
ENV_MIN_INTERVAL_S = "MCIM_RECORDER_MIN_INTERVAL_S"

# the closed trigger vocabulary — every dump() literal must name one of
# these, and every entry must have a dump() caller (mcim-check
# obs-recorder-trigger-unknown / obs-recorder-trigger-unused)
KNOWN_TRIGGERS = (
    "breaker_open",
    "quarantine",
    "sigterm_drain",
    "replica_death",
    "autoscale",
    "preempt",
    "canary_rollback",
    "systolic_fallback",  # stage-sharded dispatch fell back pinned
    #                       (owner death / broken hop — fabric/router.py)
    "profile_capture",
    "manual",
)


class FlightRecorder:
    """One process's ring. The hot path is `note()` — one tuple build and
    one deque append, no lock (the deque's maxlen discipline IS the
    bound). Only `dump()` takes a lock, for the per-trigger rate limit."""

    def __init__(self, cap: int | None = None):
        if cap is None:
            cap = int(env_registry.get(ENV_CAP) or 2048)
        self.cap = cap
        self._ring: deque = deque(maxlen=cap)
        self._dump_lock = threading.Lock()
        self._last_dump: dict[str, float] = {}  # trigger -> unix ts
        self._dump_seq = 0
        self.noted = 0  # approximate (racy by design; the ring is exact)

    # -- recording (hot path, lock-free) ------------------------------------

    def note(self, kind: str, **fields) -> None:
        self._ring.append((time.time(), kind, fields))
        self.noted += 1

    def entries(self) -> list[tuple[float, str, dict]]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    # -- dumping -------------------------------------------------------------

    def summary(self, entries: list | None = None) -> dict:
        """The readable header of a dump: counts by kind, dispatch-count
        per bucket ("which bucket was hot"), breaker transitions, and the
        last heartbeat seen per replica (the router/supervisor process's
        ring holds these — a dead replica's warm buckets survive here)."""
        if entries is None:
            entries = self.entries()
        by_kind: dict[str, int] = {}
        hot_buckets: dict[str, int] = {}
        breaker_transitions: list[dict] = []
        last_heartbeat: dict[str, dict] = {}
        for ts, kind, fields in entries:
            by_kind[kind] = by_kind.get(kind, 0) + 1
            if kind == "dispatch" and "bucket" in fields:
                b = str(fields["bucket"])
                hot_buckets[b] = hot_buckets.get(b, 0) + int(
                    fields.get("n", 1)
                )
            elif kind == "breaker":
                breaker_transitions.append({"ts": ts, **fields})
            elif kind == "heartbeat" and "replica" in fields:
                last_heartbeat[str(fields["replica"])] = {"ts": ts, **fields}
        return {
            "entries": len(entries),
            "by_kind": by_kind,
            "hot_buckets": dict(
                sorted(hot_buckets.items(), key=lambda kv: -kv[1])
            ),
            "breaker_transitions": breaker_transitions[-20:],
            "last_heartbeat": last_heartbeat,
        }

    def dump(
        self,
        trigger: str,
        *,
        path: str | None = None,
        extra: dict | None = None,
        force: bool = False,
    ) -> str | None:
        """Freeze the ring into a JSON post-mortem artifact; returns the
        path, or None when rate-limited/unwritable (a dump must never
        take its process down — it runs on failure paths)."""
        if trigger not in KNOWN_TRIGGERS:
            raise ValueError(
                f"unknown recorder trigger {trigger!r}; known: "
                f"{KNOWN_TRIGGERS}"
            )
        now = time.time()
        min_interval = float(
            env_registry.get(ENV_MIN_INTERVAL_S) or 30.0
        )
        with self._dump_lock:
            last = self._last_dump.get(trigger)
            if not force and last is not None and now - last < min_interval:
                return None
            self._last_dump[trigger] = now
            self._dump_seq += 1
            seq = self._dump_seq
        entries = self.entries()
        payload = {
            "trigger": trigger,
            "ts": now,
            "pid": os.getpid(),
            "extra": extra or {},
            "summary": self.summary(entries),
            "entries": [
                {"ts": ts, "kind": kind, **fields}
                for ts, kind, fields in entries
            ],
        }
        if path is None:
            out_dir = env_registry.get(ENV_DIR) or os.path.join(
                "artifacts", "recorder"
            )
            path = os.path.join(
                out_dir, f"recorder_{trigger}_{os.getpid()}_{seq}.json"
            )
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, default=str)
        except OSError:
            return None
        return path


# -- module-level default recorder (the process-wide ring) -------------------

_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def configure(cap: int) -> FlightRecorder:
    """Replace the process ring (tests / cap changes); the old entries
    are dropped."""
    global _recorder
    _recorder = FlightRecorder(cap)
    return _recorder


def note(kind: str, **fields) -> None:
    _recorder.note(kind, **fields)


def dump(
    trigger: str,
    *,
    path: str | None = None,
    extra: dict | None = None,
    force: bool = False,
) -> str | None:
    return _recorder.dump(trigger, path=path, extra=extra, force=force)
