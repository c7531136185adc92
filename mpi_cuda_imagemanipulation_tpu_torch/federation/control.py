"""Federation control plane — the pod -> front-door heartbeat protocol.
The counterpart of the JAX package's ``federation/control.py``: the same
wire, byte for byte, for the same fields.

The fabric's replica->router protocol (fabric/control.py) applied one
tier up, with the pod as the unit of membership: each pod's ROUTER
pushes one JSON `PodHeartbeat` to the front door's
`/control/podheartbeat` every `MCIM_FED_HEARTBEAT_S` seconds:

    pod_id        stable identity across pod restarts (the operator
                  names it; routing affinity and metric labels key on it)
    incarnation   unique per router process start — the front door
                  detects a pod restart by the change, resets that pod's
                  breaker, and re-pushes tenant/spec state before the
                  cold pod receives its first forward
    addr/port     where the pod's /v1/* front door actually listens
    routable      how many replicas the pod can currently route to —
                  0 means the pod is alive but has no serving capacity,
                  and the front door routes around it
    queued/queue_depth   pod-aggregate admission-queue fill (summed over
                  routable replicas) — the front door's load signal
    warm_buckets  union of the routable replicas' warm "HxW" buckets
    pipelines     pipeline ids this pod can serve (specs registered
                  through its router plus replica heartbeat echoes) —
                  the front door re-pushes a stored spec before
                  forwarding to a pod whose beat lacks the id
    metrics       metrics-federation delta over the pod ROUTER's own
                  registry (obs/fleet.py DeltaSource payload) — the same
                  machinery that federates replica->router is applied a
                  second time router->frontdoor, keyed by pod id

The front door's ack body closes the control loops without a second
channel: `resync: true` asks for a full metrics snapshot next beat, and
`leases` carries the pod's current per-tenant quota-share leases
(federation/quota.py) — the pod applies them by overwriting the quota
fields of its stored tenant configs and re-pushing to its replicas, so
a tenant's GLOBAL fixed-window budget holds no matter how many pods it
drives (the admission_shed_is_final invariant, re-proven at pod
granularity).

Liveness is the absence of beats (`MCIM_FED_STALE_S`), exactly like the
replica protocol. The `pod.heartbeat` failpoint drops beats on the
sender so partition handling is testable without killing anything.
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

ENV_FED_HEARTBEAT_S = "MCIM_FED_HEARTBEAT_S"

POD_HEARTBEAT_PATH = "/control/podheartbeat"

# request header the front door stamps on every forward so the serving
# replica (serve/server.py) can echo which pod carried the request —
# the end-to-end federation identity thread for traces and smoke checks
HDR_FED_POD = "X-Fed-Pod"


@dataclasses.dataclass
class PodHeartbeat:
    """One pod's pushed aggregate state — the wire format is its JSON
    dict, with the same strictness as the replica heartbeat: front door
    and pod routers ship from one tree, so unknown or missing fields are
    version-skew bugs worth failing loudly on."""

    pod_id: str
    addr: str
    port: int
    pid: int
    incarnation: str
    routable: int
    queued: int
    queue_depth: int
    warm_buckets: list[str]
    pipelines: list[str]
    seq: int
    sent_unix_s: float
    # metrics-federation delta (obs/fleet.py DeltaSource payload) over
    # the pod router's registry, or None for a metrics-less beat
    metrics: dict | None = None

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "PodHeartbeat":
        raw = json.loads(data)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(
                f"pod heartbeat has unknown fields {sorted(unknown)}"
            )
        required = {
            f.name
            for f in dataclasses.fields(cls)
            if f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        }
        missing = required - set(raw)
        if missing:
            raise ValueError(
                f"pod heartbeat missing fields {sorted(missing)}"
            )
        return cls(**raw)


def default_fed_heartbeat_s() -> float:
    return float(env_registry.get(ENV_FED_HEARTBEAT_S))


class PodHeartbeatSender:
    """The pod-side push loop: one daemon thread POSTing `collect()`'s
    PodHeartbeat to the front door until `stop()`. Same failure posture
    as the replica sender (fabric/control.HeartbeatSender): a dropped
    beat or an unreachable front door never raises — the pod's job is
    serving, and the front door's staleness window is the protocol's
    loss handling."""

    def __init__(
        self,
        frontdoor_url: str,
        collect: Callable[[int], PodHeartbeat],
        *,
        interval_s: float | None = None,
        on_ack: Callable[[PodHeartbeat, dict], None] | None = None,
    ):
        self.url = frontdoor_url.rstrip("/") + POD_HEARTBEAT_PATH
        self._collect = collect
        # on_ack(hb, ack_body): the front door acknowledged — the pod's
        # DeltaSource advances its baseline here and the ack's quota
        # leases are applied (fabric/router.Router._apply_leases)
        self._on_ack = on_ack
        self.interval_s = (
            default_fed_heartbeat_s() if interval_s is None else interval_s
        )
        self.sent = 0
        self.dropped = 0  # failpoint-dropped beats
        self.failed = 0  # front door unreachable / send error
        self._seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._log = get_logger()

    def start(self) -> "PodHeartbeatSender":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="mcim-fed-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _loop(self) -> None:
        # first beat immediately: the front door learns the pod's
        # address from it, so registration latency is one send
        while not self._stop.is_set():
            self.beat()
            self._stop.wait(self.interval_s)

    def beat(self) -> bool:
        """One send attempt; True when the front door acknowledged."""
        self._seq += 1
        hb = self._collect(self._seq)
        try:
            # an armed pod.heartbeat failpoint models POD-LINK LOSS: the
            # beat is dropped before the socket, the pod serves on
            failpoints.maybe_fail(
                "pod.heartbeat", pod=hb.pod_id, seq=hb.seq
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
        except Exception as e:  # front door down: serve on, log sparsely
            self.failed += 1
            if self.failed in (1, 10, 100):
                self._log.warning(
                    "pod heartbeat %s -> %s failed (%s; %d so far)",
                    hb.pod_id, self.url, type(e).__name__, self.failed,
                )
            return False
