"""Live video sessions — sticky affinity + journal-tail failover state.
The counterpart of the JAX package's ``fabric/session.py``.

A video session is an ordered frame stream whose temporal ops make each
output depend on the last `window` INPUT frames: the serving replica
holds that history in per-session frame rings (stream/video.py
`VideoSessionHost`), which makes a replica death mid-stream a stateful
loss — unless someone can rebuild the rings. The router can, because it
is the only hop every frame already crosses:

  * **sticky affinity** — a session binds to the rendezvous-hash winner
    of (session id, replica id) over the routable set at FIRST frame,
    and stays bound while that replica serves (scale-up must never
    migrate a live ring just because the hash winner changed; only
    death/drain unbinds).
  * **journal tail** — the router retains the last K frame bodies per
    session (K = sum of the pipeline's temporal windows, the exact
    history the rings need — `MCIM_FABRIC_SESSION_TAIL` overrides). The
    tail is the session's journal: bounded, newest-suffix, enough to
    reconstruct every ring bit-exactly.
  * **failover replay** — when the bound replica dies (forward failure
    or no longer routable), the router rebinds to the current rendezvous
    winner among survivors and REPLAYS the tail with the replay flag
    set: the replica decodes and pushes rings but skips compute+encode
    (204), then the live frame processes normally — bit-exact with the
    uninterrupted stream, which the churn test asserts pixel for pixel.

This module is the pure state side (table, binding, tail arithmetic);
fabric/router.py owns the HTTP forwarding around it.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

ENV_SESSION_TAIL = "MCIM_FABRIC_SESSION_TAIL"

SESSION_PATH_PREFIX = "/v1/session/"

# request headers the session hop rides on
HDR_SEQ = "X-Session-Seq"
HDR_OPS = "X-Video-Ops"
HDR_REPLAY = "X-Session-Replay"
HDR_RESET = "X-Session-Reset"


def tail_capacity(ops_spec: str) -> int:
    """Frames of history that reconstruct every temporal ring exactly:
    ring k's oldest retained output needs full upstream history, which a
    replay of sum(window_i) frames always provides (>= the tight
    sum(window_i - 1) + 1 bound). Env override wins when larger."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.temporal import split_temporal

    temporal, _rest = split_temporal(ops_spec)
    need = max(1, sum(op.window for op in temporal))
    override = int(env_registry.get(ENV_SESSION_TAIL) or 0)
    return max(need, override)


class Session:
    """One live stream as the router sees it: the binding plus the
    replayable frame tail. Guarded by its own lock — frames of ONE
    session serialize (ordered stream), different sessions don't."""

    def __init__(self, sid: str, ops: str):
        self.sid = sid
        self.ops = ops
        self.lock = threading.Lock()
        self.replica_id: str | None = None
        self.next_seq = 0
        self.tail: deque[tuple[int, bytes]] = deque(
            maxlen=tail_capacity(ops)
        )
        self.frames = 0
        self.failovers = 0
        self.last_active = time.monotonic()

    def remember(self, seq: int, body: bytes) -> None:
        self.tail.append((seq, body))
        self.next_seq = seq + 1
        self.frames += 1
        self.last_active = time.monotonic()

    def replay_frames(self, before_seq: int) -> list[tuple[int, bytes]]:
        """The journal tail strictly before `before_seq`, oldest first —
        what a fresh replica must ingest before the live frame."""
        return [(s, b) for s, b in self.tail if s < before_seq]

    def to_dict(self) -> dict:
        return {
            "ops": self.ops,
            "replica": self.replica_id,
            "next_seq": self.next_seq,
            "frames": self.frames,
            "failovers": self.failovers,
            "tail": len(self.tail),
            "tail_cap": self.tail.maxlen,
        }


class SessionTable:
    """sid -> Session, bounded. The cap is a safety valve against id
    churn (every sid mints a tail buffer); eviction is oldest-idle
    first, never the youngest — a live stream cannot be evicted by
    garbage sids."""

    def __init__(self, cap: int = 512):
        self.cap = cap
        self._lock = threading.Lock()
        self._sessions: dict[str, Session] = {}
        self.evicted = 0

    def get_or_create(self, sid: str, ops: str) -> Session:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                return sess
            if len(self._sessions) >= self.cap:
                victim = min(
                    self._sessions.values(), key=lambda s: s.last_active
                )
                del self._sessions[victim.sid]
                self.evicted += 1
            sess = self._sessions[sid] = Session(sid, ops)
            return sess

    def get(self, sid: str) -> Session | None:
        with self._lock:
            return self._sessions.get(sid)

    def sessions(self) -> list[Session]:
        with self._lock:
            return list(self._sessions.values())

    def bound_to(self, replica_id: str) -> list[Session]:
        with self._lock:
            return [
                s
                for s in self._sessions.values()
                if s.replica_id == replica_id
            ]

    def stats(self) -> dict:
        with self._lock:
            return {
                "sessions": len(self._sessions),
                "evicted": self.evicted,
                "by_id": {
                    sid: s.to_dict() for sid, s in self._sessions.items()
                },
            }


def parse_session_path(path: str) -> tuple[str, str] | None:
    """`/v1/session/<sid>/frame` -> (sid, verb); None when the path is
    not a session route."""
    if not path.startswith(SESSION_PATH_PREFIX):
        return None
    rest = path[len(SESSION_PATH_PREFIX):]
    sid, sep, verb = rest.partition("/")
    if not sid or not sep or verb != "frame":
        return None
    return sid, verb
