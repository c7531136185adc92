"""Fabric control plane — the replica -> router heartbeat protocol. The
counterpart of the JAX package's ``fabric/control.py``: the same wire,
byte for byte, for the same fields.

Replicas PUSH state; the router never polls. Every `MCIM_FABRIC_HEARTBEAT_S`
seconds each replica POSTs one JSON `Heartbeat` to the router's
`/control/heartbeat` endpoint:

    replica_id    stable identity (the supervisor reuses it across restarts,
                  so routing affinity and metrics labels stay bounded)
    incarnation   unique per process start — the router detects a restart
                  by the change and resets that replica's breaker (a new
                  process must not inherit its predecessor's open circuit)
    addr/port     where /v1/process actually listens (replicas bind port 0
                  and report the real port here, so there is no port-
                  assignment race between supervisor and worker)
    pid           the worker's OS pid — surfaced in the router's /stats so
                  an external churn generator (the fabric_loadgen lane)
                  can SIGKILL a specific replica without asking the
                  supervisor
    state         the health state machine (resilience/health.py): only
                  serving/degraded replicas receive traffic
    queued/queue_depth   current admission-queue fill — the router's
                  least-loaded shedding signal
    breaker_open  "HxW" buckets whose dispatch breaker is not closed on
                  this replica — the router routes exactly those buckets
                  around it while the rest of its traffic flows normally
    warm_buckets  "HxW" buckets with a built function in this
                  replica's cache — the warm-affinity signal. Warmup
                  rebuilds it on restart, so a respawned replica reclaims
                  its consistent-hash buckets (a serving-history signal
                  would starve it forever)
    metrics       compact metrics-federation delta (obs/fleet.py
                  DeltaSource payload: only the series that changed since
                  the last router-ACKED snapshot, absolute values) — the
                  router folds these into its fleet view so federation
                  costs no extra scrape round-trip. The router's ack body
                  carries `resync: true` when its baseline is stale
                  (router restart, missed epoch); the sender then resets
                  its DeltaSource and the next beat pushes a FULL
                  snapshot. May be None (metrics-less heartbeat).

The router's ACK body closes two control loops without a second channel:
`resync: true` asks for a full metrics snapshot next beat (obs/fleet.py),
and `drain: true` tells a scale-down victim to stop admitting — the
router already stopped routing to it (`mark_draining`), so within one
heartbeat period the drain is honored end to end and the replica's
subsequent beats report `state: draining` with a falling queue, which is
exactly the signal the autoscaler waits on before SIGTERM
(drain-before-kill, fabric/autoscaler.py).

A replica that exits with `PREEMPT_EXIT_CODE` was PREEMPTED (spot/
maintenance eviction, or the `replica.preempt` failpoint): it drained
gracefully and dumped the `preempt` flight-recorder artifact on its way
out. The supervisor replaces it immediately — no crash-loop backoff,
because a preemption is the platform's doing, not the replica's.

Liveness is the ABSENCE of heartbeats: the router marks a replica stale
after `MCIM_FABRIC_STALE_S` without a beat and routes around it. The
`replica.heartbeat` failpoint drops beats (the loss is injected on the
sender, so the replica keeps serving — exactly the partition the router
must tolerate; the fleet view falls back to a full scrape of the
replica's `GET /fleet/snapshot`), and a router outage only costs the
replica a log line.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import urllib.request
from typing import Callable

from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

ENV_HEARTBEAT_S = "MCIM_FABRIC_HEARTBEAT_S"

HEARTBEAT_PATH = "/control/heartbeat"

# exit status of a replica that drained after a preemption notice — the
# supervisor reads it to skip crash-loop backoff (immediate replacement)
PREEMPT_EXIT_CODE = 43


@dataclasses.dataclass
class Heartbeat:
    """One replica's pushed state — the wire format is its JSON dict."""

    replica_id: str
    addr: str
    port: int
    pid: int
    incarnation: str
    state: str
    queued: int
    queue_depth: int
    breaker_open: list[str]
    warm_buckets: list[str]
    seq: int
    sent_unix_s: float
    # metrics-federation delta (obs/fleet.py DeltaSource payload), or
    # None for a metrics-less beat
    metrics: dict | None = None
    # pipeline-service state (graph/service.py): the pipeline ids this
    # replica has registered. The router re-pushes a stored spec before
    # forwarding a graph request to a replica whose beat lacks its id —
    # so a RESTARTED replica (empty registry, same warm discipline as
    # the function cache) reconverges within one forward, not never.
    pipelines: list[str] | None = None
    # stage-ownership advert (graph/systolic.py): True when this replica
    # accepts /v1/systolic hops, so the router only places program
    # stages on replicas that will run them. None (the wire default) is
    # "not advertised" — old beats parse, and the router treats both
    # None and False as ineligible.
    systolic: bool | None = None

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Heartbeat":
        raw = json.loads(data)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            # tolerate FUTURE extra fields? No: the fabric ships router and
            # replica from one tree, so an unknown field is a version skew
            # bug worth failing loudly on, not silently dropping
            raise ValueError(f"heartbeat has unknown fields {sorted(unknown)}")
        required = {
            f.name
            for f in dataclasses.fields(cls)
            if f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        }
        missing = required - set(raw)
        if missing:
            raise ValueError(f"heartbeat missing fields {sorted(missing)}")
        return cls(**raw)


def default_heartbeat_s() -> float:
    return float(env_registry.get(ENV_HEARTBEAT_S))


class HeartbeatSender:
    """The replica-side push loop: one daemon thread POSTing `collect()`'s
    Heartbeat to the router until `stop()`.

    Failure posture: a dropped beat (armed `replica.heartbeat` failpoint)
    or an unreachable router NEVER raises out of the loop — the replica's
    job is serving, and the router's staleness window is the protocol's
    loss handling. Send timeouts are bounded by the interval so a wedged
    router can't back beats up behind a stuck socket."""

    def __init__(
        self,
        control_url: str,
        collect: Callable[[int], Heartbeat],
        *,
        interval_s: float | None = None,
        on_ack: Callable[[Heartbeat, dict], None] | None = None,
    ):
        # control_url is the router base (http://host:port); beats go to
        # its /control/heartbeat route
        self.url = control_url.rstrip("/") + HEARTBEAT_PATH
        self._collect = collect
        # on_ack(hb, ack_body): the router acknowledged this beat — the
        # metrics DeltaSource advances its baseline here (and resets it
        # when the ack carries resync=true)
        self._on_ack = on_ack
        self.interval_s = (
            default_heartbeat_s() if interval_s is None else interval_s
        )
        self.sent = 0
        self.dropped = 0  # failpoint-dropped beats
        self.failed = 0  # router unreachable / send error
        self._seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._log = get_logger()

    def start(self) -> "HeartbeatSender":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="mcim-fabric-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _loop(self) -> None:
        # first beat immediately: the router learns the replica's bound
        # port from it, so registration latency is one send, not one period
        while not self._stop.is_set():
            self.beat()
            self._stop.wait(self.interval_s)

    def beat(self) -> bool:
        """One send attempt; returns True when the router acknowledged."""
        self._seq += 1
        hb = self._collect(self._seq)
        try:
            # an armed replica.heartbeat failpoint models HEARTBEAT LOSS:
            # the beat is dropped before the socket, the replica serves on
            failpoints.maybe_fail(
                "replica.heartbeat", replica=hb.replica_id, seq=hb.seq
            )
        except failpoints.FailpointError:
            self.dropped += 1
            return False
        req = urllib.request.Request(
            self.url,
            data=hb.to_json(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(
                req, timeout=max(self.interval_s, 0.2)
            ) as resp:
                body = resp.read()
            self.sent += 1
            if self._on_ack is not None:
                try:
                    ack = json.loads(body) if body else {}
                except ValueError:
                    ack = {}
                self._on_ack(hb, ack)
            return True
        except Exception as e:  # router down/restarting: serve on, log once
            self.failed += 1
            if self.failed in (1, 10, 100):
                self._log.warning(
                    "heartbeat %s -> %s failed (%s; %d so far)",
                    hb.replica_id, self.url, type(e).__name__, self.failed,
                )
            return False
