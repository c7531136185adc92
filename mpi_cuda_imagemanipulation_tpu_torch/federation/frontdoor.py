"""The federation front door — a meta-router over whole pods.

The counterpart of the JAX package's ``federation/frontdoor.py``: the same
routing, wire, journal and ``mcim_fed_*`` metric families. The front door
launches nothing on a card; its pods' replicas compute.

The fabric router's design (fabric/router.py) applied one tier up, with
the pod as the unit of membership:

  * pods register by PUSHING `PodHeartbeat`s (federation/control.py) —
    the front door never polls; liveness is the absence of beats past
    `MCIM_FED_STALE_S`;
  * routing is rendezvous-sticky per affinity key (tenant|pipeline|
    bucket for graph traffic, the bucket for chains, "sess|sid" for
    video sessions) so pod death reroutes ONLY the dead pod's affinity
    slice — every other key keeps its pod and its warm executables;
  * per-pod breakers trip fast and reset fast, and a pod-level
    admission shed (`{"status": "shed"}` 503) relays as FINAL — exactly
    the replica-tier rule that stops retries from multiplying a
    tenant's budget, re-proven at pod granularity;
  * tenant configs and pipeline specs are DURABLE here
    (federation/registry.py): an accepted registration is fsync'd
    before the 200, rehydrated on restart, and re-pushed to any pod
    whose heartbeat lacks the state before that pod sees a forward —
    so neither a pod restart nor a front-door restart costs a client a
    re-registration;
  * tenant quota budgets are LEASED to pods (federation/quota.py) on
    the heartbeat ack, never copied — a tenant driving every pod at
    once still gets one global budget per window.

Every routed-away-from-affinity request is counted in
`mcim_fed_reroutes_total{reason=...}` with a reason from the CLOSED
vocabulary `REROUTE_REASONS` via the `count_reroute` choke point — the
same discipline as the systolic fallback ladder (graph/systolic.py),
enforced in the JAX package by mcim-check (analysis/rules_obs.py).

Session placement is locality-aware by construction: a session id binds
to one pod, frames forward there, and the journal-tail failover replay
happens WITHIN that pod (its router owns the tail). A cross-pod move —
only after the owning pod dies — starts the session fresh on the new
pod (counted `session_reset`): replaying a tail across pods would mean
shipping every session's frames through the federation tier, which is
exactly the locality the Casper placement argument says not to give up.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mpi_cuda_imagemanipulation_tpu_torch.fabric import session as fabric_session
from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import (
    Router,
    _is_admission_shed,
    _json_response,
    _rendezvous_score,
    _ConnPool,
    _STATUS_LABEL,
)
from mpi_cuda_imagemanipulation_tpu_torch.federation.control import (
    HDR_FED_POD,
    POD_HEARTBEAT_PATH,
    PodHeartbeat,
)
from mpi_cuda_imagemanipulation_tpu_torch.federation.quota import LeaseLedger
from mpi_cuda_imagemanipulation_tpu_torch.federation.registry import (
    DEFAULT_NAME,
    DurableRegistry,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs import fleet as obs_fleet
from mpi_cuda_imagemanipulation_tpu_torch.obs import metrics as obs_metrics
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.resilience import deadline as deadline_mod
from mpi_cuda_imagemanipulation_tpu_torch.resilience.breaker import BreakerBoard
from mpi_cuda_imagemanipulation_tpu_torch.serve import bucketing
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

ENV_FED_STALE_S = "MCIM_FED_STALE_S"
ENV_FED_FORWARD_TIMEOUT_S = "MCIM_FED_FORWARD_TIMEOUT_S"
ENV_FED_FORWARD_ATTEMPTS = "MCIM_FED_FORWARD_ATTEMPTS"
ENV_FED_REGISTRY = "MCIM_FED_REGISTRY"

# The CLOSED vocabulary of reasons a request is served away from its
# rendezvous pod. Every reroute increments mcim_fed_reroutes_total with
# exactly one of these via count_reroute — mcim-check rejects unknown
# reasons, dynamic reason expressions, and vocabulary entries nothing
# uses (analysis/rules_obs.py, the systolic-fallback discipline).
#
#   pod_down        the affinity pod is stale/dead — its slice reroutes
#   breaker_open    the affinity pod's breaker refused the attempt
#   overloaded      the affinity pod is over the shed fraction
#   forward_failed  an attempt on the affinity pod failed; survivors took it
#   session_reset   a session's owning pod died; the session restarted
#                   fresh on a new pod (no cross-pod tail replay)
#   retry_budget    the token-bucket retry budget (resilience/deadline.py)
#                   refused the reroute: the request gave up with its best
#                   answer so far instead of amplifying a brownout
REROUTE_REASONS = (
    "pod_down",
    "breaker_open",
    "overloaded",
    "forward_failed",
    "session_reset",
    "retry_budget",
)


def count_reroute(counter, reason: str) -> None:
    """The single choke point for reroute accounting: an unknown reason
    is a bug in THIS tree, not a metric label."""
    if reason not in REROUTE_REASONS:
        raise ValueError(
            f"unknown reroute reason {reason!r} "
            f"(known: {REROUTE_REASONS})"
        )
    counter.inc(reason=reason)


class PodView:
    """One pod's last-observed heartbeat + bookkeeping."""

    __slots__ = ("hb", "last_seen", "beats")

    def __init__(self, hb: PodHeartbeat, now: float):
        self.hb = hb
        self.last_seen = now
        self.beats = 1

    @property
    def pod_id(self) -> str:
        return self.hb.pod_id

    def fresh(self, now: float, stale_s: float) -> bool:
        return (now - self.last_seen) <= stale_s

    def load_frac(self) -> float:
        return self.hb.queued / max(1, self.hb.queue_depth)


class PodTable:
    """The pod membership table (fabric/router.ReplicaTable one tier up)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pods: dict[str, PodView] = {}

    def observe(self, hb: PodHeartbeat, now: float) -> bool:
        """Fold one beat in; True when this is a NEW incarnation (first
        beat ever, or a pod restart behind the same id)."""
        with self._lock:
            view = self._pods.get(hb.pod_id)
            if view is None:
                self._pods[hb.pod_id] = PodView(hb, now)
                return True
            new_inc = view.hb.incarnation != hb.incarnation
            view.hb = hb
            view.last_seen = now
            view.beats += 1
            return new_inc

    def views(self) -> list[PodView]:
        with self._lock:
            return list(self._pods.values())

    def get(self, pod_id: str) -> PodView | None:
        with self._lock:
            return self._pods.get(pod_id)


@dataclasses.dataclass
class FrontDoorConfig:
    registry_path: str | None = None  # None: MCIM_FED_REGISTRY
    buckets: tuple[tuple[int, int], ...] = bucketing.DEFAULT_BUCKETS
    stale_s: float | None = None  # None: MCIM_FED_STALE_S
    forward_timeout_s: float | None = None
    forward_attempts: int | None = None
    # pod-level load shed point: a pod at/over this queue-fill fraction
    # loses sticky preference (counted `overloaded`)
    shed_frac: float = 0.9
    # per-pod breaker: same fast-trip/fast-reset posture as the
    # router's per-replica board — a dead pod costs one connect timeout
    # per probe, a restarted pod rejoins within a breaker window
    breaker_threshold: int = 2
    breaker_reset_s: float = 3.0
    # -- request lifecycle (resilience/deadline.py) ------------------------
    # edge deadline applied to requests that arrive WITHOUT their own
    # X-MCIM-Deadline-Ms budget; 0 disables. None: MCIM_FED_DEADLINE_MS
    default_deadline_ms: float | None = None
    # retry-budget token bucket: deposit `frac` per accepted request,
    # withdraw 1 per reroute; `reserve` covers cold-start failover.
    # None fields fall back to MCIM_RETRY_BUDGET_FRAC / _RESERVE
    retry_budget_frac: float | None = None
    retry_budget_reserve: float | None = None


class FrontDoor:
    """The federation front door. `start()` binds the HTTP listener;
    pods register by heartbeating `POST /control/podheartbeat`.

        POST /v1/process          proxied to a pod (graph lane sticky on
                                  tenant|pipeline|bucket, chain lane on
                                  the bucket; pod-level admission sheds
                                  relay FINAL)
        POST /v1/pipelines        validate + PERSIST + broadcast a spec
        POST /v1/tenants          tenant config, persisted + broadcast
                                  with each pod's LEASED quota share
        POST /v1/session/<sid>/frame
                                  sticky pod binding keyed by session id
        POST /control/podheartbeat  pod aggregate push; the ack carries
                                  resync + the pod's quota leases
        GET  /healthz             200 while >=1 fresh pod has capacity
        GET  /stats               pod table + federation state (JSON)
        GET  /metrics             mcim_fed_* + the federated pod
                                  families (obs/fleet.py, second hop)
    """

    def __init__(
        self,
        config: FrontDoorConfig | None = None,
        *,
        registry: Registry | None = None,
        clock=time.monotonic,
    ):
        self.config = config or FrontDoorConfig()
        self.stale_s = (
            float(env_registry.get(ENV_FED_STALE_S))
            if self.config.stale_s is None
            else self.config.stale_s
        )
        self.forward_timeout_s = (
            float(env_registry.get(ENV_FED_FORWARD_TIMEOUT_S))
            if self.config.forward_timeout_s is None
            else self.config.forward_timeout_s
        )
        self.forward_attempts = (
            int(env_registry.get(ENV_FED_FORWARD_ATTEMPTS))
            if self.config.forward_attempts is None
            else self.config.forward_attempts
        )
        self.buckets = tuple(self.config.buckets)
        self.shed_frac = self.config.shed_frac
        self.default_deadline_ms = (
            float(env_registry.get(deadline_mod.ENV_DEADLINE_MS))
            if self.config.default_deadline_ms is None
            else self.config.default_deadline_ms
        )
        self.retry_budget = deadline_mod.RetryBudget(
            frac=(
                float(env_registry.get(deadline_mod.ENV_BUDGET_FRAC))
                if self.config.retry_budget_frac is None
                else self.config.retry_budget_frac
            ),
            reserve=(
                float(env_registry.get(deadline_mod.ENV_BUDGET_RESERVE))
                if self.config.retry_budget_reserve is None
                else self.config.retry_budget_reserve
            ),
        )
        path = (
            self.config.registry_path
            or env_registry.get(ENV_FED_REGISTRY)
            or DEFAULT_NAME
        )
        # durable state FIRST: everything below serves what this replays
        self.durable = DurableRegistry(path).load()
        self._state_lock = threading.Lock()
        # tenant -> registered payload (global budgets, not leases)
        self.fed_tenants: dict[str, dict] = self.durable.items("tenant")
        # "tenant/pipeline" -> {"tenant": ..., "spec": ...}
        self.fed_specs: dict[str, dict] = self.durable.items("pipeline")
        # session id -> {"pod": ..., "ops": ...}
        self.session_pods: dict[str, dict] = self.durable.items("session")
        self.leases = LeaseLedger(clock=clock)
        self.table = PodTable()
        self.breakers = BreakerBoard(
            failure_threshold=self.config.breaker_threshold,
            reset_timeout_s=self.config.breaker_reset_s,
        )
        # (pod id, incarnation) -> tenants whose LEASED config that
        # exact pod process has received (the router's _tenant_pushed
        # discipline one tier up — a pod restart naturally re-pushes)
        self._pod_pushed: dict[tuple[str, str], set[str]] = {}
        self._pool = _ConnPool(self.forward_timeout_s)
        self._clock = clock
        self.registry = registry or Registry()
        # second federation hop (obs/fleet.py): pod-router registries
        # fold in via pod-heartbeat deltas, keyed by pod id
        self.fleet = obs_fleet.FleetAggregator(
            stale_s=self.stale_s, clock=clock
        )
        self._fleet_scraped_at: dict[str, float] = {}
        self._register_metrics()
        self.httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._closed = False
        self._log = get_logger()

    # -- metrics -----------------------------------------------------------

    def _register_metrics(self) -> None:
        r = self.registry
        self._m_requests = r.counter(
            "mcim_fed_requests_total",
            "Front-door requests by terminal status.",
            labels=("status",),
        )
        self._m_forwards = r.counter(
            "mcim_fed_forwards_total",
            "Proxy attempts per pod, by outcome (ok/shed/http_error/"
            "net_error).",
            labels=("pod", "outcome"),
        )
        self._m_retries = r.counter(
            "mcim_fed_forward_retries_total",
            "Requests re-forwarded to another pod after a failed "
            "attempt (attempt 2+ each counts once).",
        )
        self._m_reroutes = r.counter(
            "mcim_fed_reroutes_total",
            "Requests served away from their rendezvous pod, by closed-"
            "vocabulary reason (REROUTE_REASONS — count_reroute is the "
            "only increment site).",
            labels=("reason",),
        )
        self._m_heartbeats = r.counter(
            "mcim_fed_heartbeats_total",
            "Pod heartbeats accepted, per pod.",
            labels=("pod",),
        )
        self._m_forward_s = r.histogram(
            "mcim_fed_forward_seconds",
            "Front-door -> pod proxy time per successful attempt.",
        )
        # request-lifecycle accounting (resilience/deadline.py): expiry
        # answered locally at THIS tier, and reroutes the retry budget
        # refused (the latter also count a `retry_budget` reroute)
        self._m_deadline = deadline_mod.expired_counter(r)
        self._m_budget_denied = deadline_mod.budget_denied_counter(r)
        self._m_pushes = r.counter(
            "mcim_fed_pushes_total",
            "Tenant/spec state re-pushed to a pod whose heartbeat "
            "lacked it (cold-pod / restart reconvergence).",
        )
        self._m_lease_grants = r.counter(
            "mcim_fed_lease_grants_total",
            "Quota-share leases granted to pods (one per pod per "
            "tenant per window; reconnects return the held lease and "
            "do not count).",
        )
        self._m_session_frames = r.counter(
            "mcim_fed_session_frames_total",
            "Session frames through the front door, by outcome.",
            labels=("outcome",),
        )
        r.gauge(
            "mcim_fed_pods",
            "Fresh pods with routable capacity.",
            fn=lambda: float(len(self._live())),
        )
        r.gauge(
            "mcim_fed_tenants",
            "Tenant configs in the durable registry.",
            fn=lambda: float(len(self.fed_tenants)),
        )
        r.gauge(
            "mcim_fed_specs",
            "(tenant, pipeline) specs in the durable registry.",
            fn=lambda: float(len(self.fed_specs)),
        )
        r.gauge(
            "mcim_fed_sessions",
            "Session -> pod bindings held (durable).",
            fn=lambda: float(len(self.session_pods)),
        )

    # -- membership / routing ----------------------------------------------

    def _live(self) -> list[PodView]:
        now = self._clock()
        return [
            v
            for v in self.table.views()
            if v.fresh(now, self.stale_s) and v.hb.routable > 0
        ]

    def route_pod(
        self, affinity_key: str
    ) -> tuple[list[PodView], str | None, str | None]:
        """(ordered candidates, preferred pod id, demotion reason).

        The preferred pod is the rendezvous winner over ALL KNOWN pods —
        including stale ones — so a request served elsewhere because its
        pod died is counted `pod_down`, not silently re-homed. The
        candidate order starts at the sticky live winner unless it is
        over the shed fraction (`overloaded`)."""
        known = self.table.views()
        preferred = (
            max(
                known,
                key=lambda v: _rendezvous_score(affinity_key, v.pod_id),
            ).pod_id
            if known
            else None
        )
        live = self._live()
        if not live:
            return [], preferred, None
        sticky = max(
            live, key=lambda v: _rendezvous_score(affinity_key, v.pod_id)
        )
        rest = sorted(
            (v for v in live if v.pod_id != sticky.pod_id),
            key=lambda v: v.load_frac(),
        )
        if preferred is not None and sticky.pod_id != preferred:
            return [sticky] + rest, preferred, "pod_down"
        if sticky.load_frac() >= self.shed_frac:
            return rest + [sticky], preferred, "overloaded"
        return [sticky] + rest, preferred, None

    # -- forwarding --------------------------------------------------------

    def _forward_once(
        self,
        view: PodView,
        path: str,
        body: bytes,
        extra_headers,
        trace_id: str,
    ):
        addr = view.hb.addr or "127.0.0.1"
        port = view.hb.port
        conn = self._pool.take(addr, port)
        try:
            hdrs = {
                "Content-Type": "application/octet-stream",
                HDR_FED_POD: view.pod_id,
            }
            for k, v in extra_headers:
                hdrs[k] = v
            if trace_id:
                hdrs["X-Trace-Id"] = trace_id
            conn.request("POST", path, body=body, headers=hdrs)
            resp = conn.getresponse()
            out = resp.read()
            ctype = resp.getheader("Content-Type", "application/json")
            passthrough = [
                (h, resp.getheader(h))
                for h in (
                    "Retry-After",
                    "X-MCIM-Histogram",
                    "X-MCIM-Stats",
                    "X-Fabric-Replica",
                )
                if resp.getheader(h)
            ]
        except BaseException:
            conn.close()
            raise
        self._pool.give(addr, port, conn)
        return resp.status, ctype, out, passthrough

    def _forward_with_retries(
        self,
        root,
        path: str,
        body: bytes,
        candidates: list[PodView],
        preferred: str | None,
        base_reason: str | None,
        *,
        extra_headers=(),
        before_forward=None,
        admission_shed_is_final: bool = False,
        deadline: deadline_mod.Deadline | None = None,
    ):
        """Walk the pod candidates until one answers. The reroute
        accounting fires exactly once, when the request completes on a
        pod other than its rendezvous-preferred one — with the most
        specific reason observed (`base_reason` from routing, upgraded
        by what actually happened to the preferred pod in this loop).

        Deadline-honest and retry-bounded (resilience/deadline.py): the
        remaining budget is re-checked before every attempt (an expired
        request answers 504 HERE instead of burning a pod), each forward
        carries the remainder on the wire, and attempt 2+ must withdraw
        from the retry budget — a refused withdrawal gives up with the
        best answer so far, counted under the closed `retry_budget`
        reroute reason."""
        reason = base_reason
        last: tuple | None = None
        attempts = 0
        for view in candidates:
            if deadline is not None and deadline.expired():
                deadline_mod.count_expired(self._m_deadline, "door")
                return _json_response(
                    504, deadline_mod.expired_response_body()
                )
            pod = view.pod_id
            breaker = self.breakers.get(pod)
            if not breaker.allow():
                if pod == preferred and reason is None:
                    reason = "breaker_open"
                continue
            attempts += 1
            if attempts > 1:
                if not self.retry_budget.try_withdraw():
                    deadline_mod.count_budget_denied(
                        self._m_budget_denied, "door"
                    )
                    count_reroute(self._m_reroutes, "retry_budget")
                    break
                self._m_retries.inc()
            fwd_extra = tuple(extra_headers)
            if deadline is not None:
                fwd_extra = fwd_extra + (
                    (deadline_mod.HEADER, deadline.header_value()),
                )
            if before_forward is not None:
                try:
                    before_forward(view)
                except Exception as e:
                    breaker.on_failure()
                    self._m_forwards.inc(pod=pod, outcome="net_error")
                    if pod == preferred and reason is None:
                        reason = "forward_failed"
                    self._log.warning(
                        "fed: state push to pod %s failed (%s: %s)",
                        pod, type(e).__name__, str(e)[:120],
                    )
                    continue
            t0 = self._clock()
            try:
                with obs_trace.span(
                    "fed.forward", parent=root.context(), pod=pod
                ):
                    code, ctype, out, passthrough = self._forward_once(
                        view, path, body, fwd_extra, root.trace_id
                    )
            except Exception as e:
                breaker.on_failure()
                self._m_forwards.inc(pod=pod, outcome="net_error")
                if pod == preferred and reason is None:
                    reason = "forward_failed"
                self._log.warning(
                    "fed: forward to pod %s failed (%s: %s)",
                    pod, type(e).__name__, str(e)[:120],
                )
                continue
            if code == 504:
                # a downstream deadline verdict is FINAL by definition:
                # the budget is as gone on every sibling pod as it was
                # on this one, so a retry could only burn more replica
                # time on work the caller already abandoned. Not a pod
                # fault either — the pod answered honestly.
                breaker.on_success()
                self._m_forwards.inc(pod=pod, outcome="http_error")
                return (
                    code, ctype, out,
                    passthrough + [(HDR_FED_POD, pod)],
                )
            if (
                admission_shed_is_final
                and code == 503
                and _is_admission_shed(out)
            ):
                # a pod-level quota/QoS shed is FINAL: trying the next
                # pod would hand the tenant another pod's lease on top
                # of the one it just exhausted (the budget x pods bug)
                breaker.on_success()
                self._m_forwards.inc(pod=pod, outcome="shed")
                return (
                    code, ctype, out,
                    passthrough + [(HDR_FED_POD, pod)],
                )
            if code in (429, 503) or code >= 500:
                if code >= 500:
                    breaker.on_failure()
                self._m_forwards.inc(pod=pod, outcome="http_error")
                if pod == preferred and reason is None:
                    reason = "forward_failed"
                if not any(k == "Retry-After" for k, _ in passthrough):
                    passthrough = passthrough + [("Retry-After", "1")]
                last = (
                    code, ctype, out,
                    passthrough + [(HDR_FED_POD, pod)],
                )
                continue
            breaker.on_success()
            self._m_forwards.inc(pod=pod, outcome="ok")
            self._m_forward_s.observe(
                self._clock() - t0, exemplar=root.trace_id or None
            )
            if preferred is not None and pod != preferred:
                # literal per-reason sites: the closed REROUTE_REASONS
                # vocabulary stays machine-checkable (mcim-check walks
                # every count_reroute caller for a literal member)
                if reason == "pod_down":
                    count_reroute(self._m_reroutes, "pod_down")
                elif reason == "breaker_open":
                    count_reroute(self._m_reroutes, "breaker_open")
                elif reason == "overloaded":
                    count_reroute(self._m_reroutes, "overloaded")
                else:
                    count_reroute(self._m_reroutes, "forward_failed")
            return (
                code, ctype, out,
                passthrough
                + [(HDR_FED_POD, pod), ("X-Fed-Attempts", str(attempts))],
            )
        if last is not None:
            return last
        return _json_response(
            503,
            {"error": "no pod is serving", "status": "unavailable"},
            extra=[("Retry-After", "1")],
        )

    # -- request path ------------------------------------------------------

    def handle_process(
        self, body: bytes, headers, query: dict | None = None
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        """One `/v1/process` through the federation tier. The graph lane
        stickies on (tenant, pipeline, bucket) and converges the target
        pod's tenant/spec state before the first forward; the chain lane
        stickies on the bucket so a pod's warm executables keep their
        traffic."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.service import (
            HDR_PIPELINE,
            HDR_TENANT,
        )

        q = query or {}

        def _pick(hname: str, qname: str) -> str:
            v = headers.get(hname)
            if v:
                return v
            vals = q.get(qname)
            return vals[0] if vals else ""

        tenant = _pick(HDR_TENANT, "tenant") or "default"
        pipeline = _pick(HDR_PIPELINE, "pipeline")
        # the deadline chain starts HERE: adopt the client's remaining
        # budget, or mint the edge default for clients that sent none
        dl = deadline_mod.from_headers(headers, clock=self._clock)
        if dl is None and self.default_deadline_ms > 0:
            dl = deadline_mod.Deadline(
                self.default_deadline_ms, clock=self._clock
            )
        if dl is not None and dl.expired():
            deadline_mod.count_expired(self._m_deadline, "door")
            self._m_requests.inc(status="deadline_expired")
            return _json_response(
                504, deadline_mod.expired_response_body()
            )
        try:
            h, w = Router._sniff_dims(body)
        except Exception as e:
            self._m_requests.inc(status="rejected")
            return _json_response(
                400, {"error": f"undecodable image: {e}"}
            )
        picked = bucketing.pick_bucket(h, w, self.buckets)
        bucket = f"{picked[0]}x{picked[1]}" if picked else f"{h}x{w}"
        if pipeline:
            affinity = f"{tenant}|{pipeline}|{bucket}"
            extra = ((HDR_TENANT, tenant), (HDR_PIPELINE, pipeline))
            before = lambda v: self._ensure_pod_state(v, tenant, pipeline)  # noqa: E731
            shed_final = True
        else:
            affinity = bucket
            extra = ()
            before = None
            shed_final = False
        candidates, preferred, base_reason = self.route_pod(affinity)
        if not candidates:
            self._m_requests.inc(status="unavailable")
            return _json_response(
                503,
                {"error": "no pod is serving", "status": "unavailable"},
                extra=[("Retry-After", "1")],
            )
        root = obs_trace.start_trace(
            "fed.request", h=h, w=w, bucket=bucket,
            tenant=tenant, pipeline=pipeline or None,
        )
        # one accepted request = one retry-budget deposit (the bucket
        # the reroute withdrawals below draw down)
        self.retry_budget.deposit()
        code, ctype, out, hdrs_out = self._forward_with_retries(
            root, "/v1/process", body, candidates, preferred,
            base_reason, extra_headers=extra, before_forward=before,
            admission_shed_is_final=shed_final, deadline=dl,
        )
        self._m_requests.inc(
            status=_STATUS_LABEL.get(
                code, "error" if code >= 500 else "ok"
            )
        )
        root.set(status=code)
        root.end()
        if root.trace_id:
            hdrs_out = hdrs_out + [("X-Trace-Id", root.trace_id)]
        return code, ctype, out, hdrs_out

    # -- state convergence -------------------------------------------------

    def _push_json(self, view: PodView, path: str, payload: dict):
        addr = view.hb.addr or "127.0.0.1"
        port = view.hb.port
        conn = self._pool.take(addr, port)
        try:
            conn.request(
                "POST", path, body=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            out = resp.read()
        except BaseException:
            conn.close()
            raise
        self._pool.give(addr, port, conn)
        return resp.status, out

    def _leased_payload(self, payload: dict, pod_id: str) -> dict:
        """The tenant config AS THIS POD RECEIVES IT: quota fields
        replaced by the pod's current window lease. Quota-less tenants
        pass through untouched."""
        if (
            payload.get("quota_requests") is None
            and payload.get("quota_bytes") is None
        ):
            return payload
        before = self.leases.grants_issued
        lease = self.leases.lease(
            payload["tenant"], payload, pod_id,
            [v.pod_id for v in self._live()], self._clock(),
        )
        grew = self.leases.grants_issued - before
        if grew:
            self._m_lease_grants.inc(grew)
        return {
            **payload,
            "quota_requests": lease["quota_requests"],
            "quota_bytes": lease["quota_bytes"],
        }

    def _ensure_pod_state(
        self, view: PodView, tenant: str, pipeline: str
    ) -> None:
        """Converge one pod's federation state before a forward: push
        the stored spec when the pod's heartbeat lacks the pipeline id,
        and push the tenant's LEASED config when this exact pod
        incarnation has never received it. The router's
        `_ensure_graph_state` discipline one tier up — a restarted
        (cold) pod reconverges within one forward, not never."""
        inc_key = (view.pod_id, view.hb.incarnation)
        with self._state_lock:
            reg = self.fed_specs.get(f"{tenant}/{pipeline}")
            tcfg = self.fed_tenants.get(tenant)
            need_tenant = (
                tcfg is not None
                and tenant not in self._pod_pushed.get(inc_key, ())
            )
        need_spec = (
            reg is not None and pipeline not in (view.hb.pipelines or ())
        )
        if not need_tenant and not need_spec:
            return
        if need_tenant:
            leased = self._leased_payload(tcfg, view.pod_id)
            code, out = self._push_json(view, "/v1/tenants", leased)
            if code != 200:
                raise RuntimeError(
                    f"tenant push to pod {view.pod_id} answered {code}: "
                    f"{out[:120]!r}"
                )
            with self._state_lock:
                self._pod_pushed.setdefault(inc_key, set()).add(tenant)
        if need_spec:
            code, out = self._push_json(view, "/v1/pipelines", reg)
            if code != 200:
                raise RuntimeError(
                    f"spec push to pod {view.pod_id} answered {code}: "
                    f"{out[:120]!r}"
                )
        self._m_pushes.inc()
        self._log.info(
            "fed: re-pushed %s/%s to pod %s (tenant=%s spec=%s)",
            tenant, pipeline, view.pod_id, need_tenant, need_spec,
        )

    # -- registration ------------------------------------------------------

    def handle_graph_register(self, body: bytes) -> tuple[int, dict]:
        """`POST /v1/pipelines` at the federation tier: validate (the
        closed taxonomy), PERSIST (the fsync happens before any client
        sees the 200), broadcast to every live pod."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.ir import dag_fingerprint
        from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import (
            SpecError,
            parse_spec,
        )

        try:
            try:
                payload = json.loads(body or b"null")
            except ValueError as e:
                raise SpecError(
                    "bad-json", f"body is not JSON: {e}"
                ) from None
            if not isinstance(payload, dict):
                raise SpecError(
                    "bad-root", "registration body must be an object"
                )
            spec = payload.get("spec", payload)
            tenant = payload.get("tenant") or "default"
            graph = parse_spec(spec)
        except SpecError as e:
            return (
                400 if e.code == "bad-json" else 422,
                {"status": "rejected", "code": e.code, "error": str(e)},
            )
        pid = dag_fingerprint(graph)
        reg = {"tenant": tenant, "spec": spec}
        self.durable.put("pipeline", f"{tenant}/{pid}", reg)
        with self._state_lock:
            self.fed_specs[f"{tenant}/{pid}"] = reg
        pushed: dict[str, object] = {}
        for v in self._live():
            try:
                code, _out = self._push_json(v, "/v1/pipelines", reg)
                pushed[v.pod_id] = code
            except Exception as e:
                pushed[v.pod_id] = f"error: {type(e).__name__}"
        return 200, {
            "pipeline": pid,
            "tenant": tenant,
            "name": graph.name,
            "nodes": len(graph.nodes),
            "outputs": sorted(graph.outputs),
            "persisted": True,
            "pods": pushed,
        }

    def handle_graph_tenant(self, body: bytes) -> tuple[int, dict]:
        """`POST /v1/tenants` at the federation tier: validate, persist
        the GLOBAL config, broadcast each pod its LEASED share."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError
        from mpi_cuda_imagemanipulation_tpu_torch.graph.tenancy import (
            TenantConfig,
        )

        try:
            try:
                payload = json.loads(body or b"null")
            except ValueError as e:
                raise SpecError(
                    "bad-json", f"body is not JSON: {e}"
                ) from None
            if not isinstance(payload, dict):
                raise SpecError(
                    "bad-root", "tenant config must be an object"
                )
            TenantConfig(  # validation only; pods hold the live state
                tenant_id=payload.get("tenant", ""),
                qos=payload.get("qos", "standard"),
                quota_requests=payload.get("quota_requests"),
                quota_bytes=payload.get("quota_bytes"),
                window_s=payload.get("window_s"),
            )
        except SpecError as e:
            return (
                400 if e.code == "bad-json" else 422,
                {"status": "rejected", "code": e.code, "error": str(e)},
            )
        tenant = payload["tenant"]
        self.durable.put("tenant", tenant, payload)
        with self._state_lock:
            self.fed_tenants[tenant] = payload
        pushed: dict[str, object] = {}
        for v in self._live():
            try:
                leased = self._leased_payload(payload, v.pod_id)
                code, _out = self._push_json(v, "/v1/tenants", leased)
                pushed[v.pod_id] = code
                if code == 200:
                    with self._state_lock:
                        self._pod_pushed.setdefault(
                            (v.pod_id, v.hb.incarnation), set()
                        ).add(tenant)
            except Exception as e:
                pushed[v.pod_id] = f"error: {type(e).__name__}"
        return 200, {"tenant": tenant, "persisted": True, "pods": pushed}

    # -- sessions ----------------------------------------------------------

    def handle_session_frame(
        self, sid: str, body: bytes, headers
    ) -> tuple[int, str, bytes, list[tuple[str, str]]]:
        """One session frame: sticky pod binding keyed by session id,
        persisted so a front-door restart keeps every session on its
        pod. Failover WITHIN a pod (replica death) is the pod router's
        journal-tail replay and is invisible here; a cross-pod move —
        only when the owning pod is gone — restarts the session fresh
        on the rendezvous survivor (counted `session_reset`)."""
        ops = headers.get(fabric_session.HDR_OPS) or ""
        if not ops:
            self._m_session_frames.inc(outcome="error")
            return _json_response(
                400,
                {"error": f"missing {fabric_session.HDR_OPS} header"},
            )
        live = self._live()
        if not live:
            self._m_session_frames.inc(outcome="unavailable")
            return _json_response(
                503,
                {"error": "no pod is serving", "status": "unavailable"},
                extra=[("Retry-After", "1")],
            )
        with self._state_lock:
            bound = self.session_pods.get(sid, {}).get("pod")
        view = next((v for v in live if v.pod_id == bound), None)
        moved = False
        if view is None:
            view = max(
                live,
                key=lambda v: _rendezvous_score("sess|" + sid, v.pod_id),
            )
            moved = bound is not None and bound != view.pod_id
        if bound != view.pod_id:
            self.durable.put(
                "session", sid, {"pod": view.pod_id, "ops": ops}
            )
            with self._state_lock:
                self.session_pods[sid] = {
                    "pod": view.pod_id, "ops": ops,
                }
        if moved:
            # the owning pod died: its tail died with it — the session
            # restarts fresh on the survivor rather than shipping every
            # frame through this tier to make cross-pod replay possible
            count_reroute(self._m_reroutes, "session_reset")
            self._log.info(
                "fed: session %s moved %s -> %s (fresh start, no "
                "cross-pod tail replay)", sid, bound, view.pod_id,
            )
        fwd_headers = [(fabric_session.HDR_OPS, ops)]
        raw_seq = headers.get(fabric_session.HDR_SEQ)
        if raw_seq is not None:
            fwd_headers.append((fabric_session.HDR_SEQ, raw_seq))
        root = obs_trace.start_trace("fed.session", sid=sid)
        try:
            code, ctype, out, passthrough = self._forward_once(
                view,
                f"{fabric_session.SESSION_PATH_PREFIX}{sid}/frame",
                body, fwd_headers, root.trace_id,
            )
        except Exception as e:
            self.breakers.get(view.pod_id).on_failure()
            self._m_session_frames.inc(outcome="error")
            root.set(status=502)
            root.end()
            return _json_response(
                502,
                {"error": (
                    f"session forward to pod {view.pod_id} failed "
                    f"({type(e).__name__}: {str(e)[:120]})"
                )},
            )
        self.breakers.get(view.pod_id).on_success()
        self._m_session_frames.inc(
            outcome="ok" if code == 200 else "error"
        )
        root.set(status=code)
        root.end()
        extra = passthrough + [(HDR_FED_POD, view.pod_id)]
        if root.trace_id:
            extra = extra + [("X-Trace-Id", root.trace_id)]
        return code, ctype, out, extra

    # -- control -----------------------------------------------------------

    def handle_pod_heartbeat(self, body: bytes) -> tuple[int, dict]:
        try:
            hb = PodHeartbeat.from_json(body)
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad pod heartbeat: {e}"}
        now = self._clock()
        new_inc = self.table.observe(hb, now)
        if new_inc:
            # a restarted pod must not inherit its predecessor's open
            # breaker, and must get every tenant/spec re-pushed before
            # its first forward (the _pod_pushed key rolls with the
            # incarnation, so that happens by construction)
            self.breakers.reset(hb.pod_id)
            self._log.info(
                "pod %s registered (incarnation %s, %s:%d, %d routable)",
                hb.pod_id, hb.incarnation, hb.addr or "127.0.0.1",
                hb.port, hb.routable,
            )
        self._m_heartbeats.inc(pod=hb.pod_id)
        ok = self.fleet.apply(hb.pod_id, hb.incarnation, hb.metrics, now)
        with self._state_lock:
            tenants = dict(self.fed_tenants)
        before = self.leases.grants_issued
        leases = self.leases.leases_for_pod(
            hb.pod_id, tenants, [v.pod_id for v in self._live()]
        )
        grew = self.leases.grants_issued - before
        if grew:
            self._m_lease_grants.inc(grew)
        return 200, {"ok": True, "resync": not ok, "leases": leases}

    def _fleet_refresh(self) -> None:
        """Full-scrape fallback, second hop: a pod whose metrics view is
        stale (beats lost or deltas refused) gets one pull of its
        router's `GET /fleet/snapshot` per staleness window."""
        now = self._clock()
        ages = self.fleet.ages(now)
        for v in self.table.views():
            pid = v.pod_id
            age = ages.get(pid)
            if age is not None and age <= self.stale_s:
                continue
            if now - self._fleet_scraped_at.get(pid, -1e18) < self.stale_s:
                continue
            self._fleet_scraped_at[pid] = now
            url = (
                f"http://{v.hb.addr or '127.0.0.1'}:{v.hb.port}"
                f"{obs_fleet.SNAPSHOT_PATH}"
            )
            try:
                with urllib.request.urlopen(url, timeout=2.0) as resp:
                    snap = json.loads(resp.read())
                self.fleet.full_sync(pid, v.hb.incarnation, snap, now)
            except Exception as e:
                self._log.debug(
                    "fed: full scrape of pod %s failed (%s)", pid,
                    type(e).__name__,
                )

    def render_metrics(self) -> str:
        self._fleet_refresh()
        return self.registry.render() + self.fleet.render()

    def healthz(self) -> tuple[int, dict]:
        live = self._live()
        code = 200 if live else 503
        return code, {
            "state": "serving" if live else "unavailable",
            "pods": sorted(v.pod_id for v in live),
            "known": len(self.table.views()),
        }

    def stats(self) -> dict:
        now = self._clock()
        with self._state_lock:
            tenants = sorted(self.fed_tenants)
            specs = sorted(self.fed_specs)
            sessions = {
                sid: dict(b) for sid, b in self.session_pods.items()
            }
        return {
            "stale_s": self.stale_s,
            "forward_attempts": self.forward_attempts,
            "default_deadline_ms": self.default_deadline_ms,
            "retry_budget": self.retry_budget.stats(),
            "registry": {
                "path": self.durable.path,
                "counts": self.durable.counts(),
                "loaded_records": self.durable.loaded_records,
                "skipped_lines": self.durable.skipped_lines,
            },
            "tenants": tenants,
            "specs": specs,
            "sessions": sessions,
            "leases": self.leases.stats(),
            "fleet": self.fleet.stats(now),
            "pods": {
                v.pod_id: {
                    "addr": v.hb.addr or "127.0.0.1",
                    "port": v.hb.port,
                    "pid": v.hb.pid,
                    "incarnation": v.hb.incarnation,
                    "routable": v.hb.routable,
                    "fresh": v.fresh(now, self.stale_s),
                    "age_s": now - v.last_seen,
                    "queued": v.hb.queued,
                    "queue_depth": v.hb.queue_depth,
                    "warm_buckets": v.hb.warm_buckets,
                    "pipelines": v.hb.pipelines,
                    "beats": v.beats,
                }
                for v in self.table.views()
            },
            "breakers": self.breakers.snapshot(),
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self, host: str = "", port: int = 0) -> "FrontDoor":
        try:
            self.httpd = _FrontDoorHTTPServer(
                (host, port), _make_handler(self)
            )
            self._http_thread = threading.Thread(
                target=self.httpd.serve_forever,
                name="mcim-fed-frontdoor",
                daemon=True,
            )
            self._http_thread.start()
        except BaseException:
            self.close()
            raise
        return self

    @property
    def address(self) -> tuple[str, int]:
        assert self.httpd is not None, "FrontDoor not started"
        host, port = self.httpd.server_address[:2]
        return (host, port)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.address[1]}"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.httpd is not None:
            try:
                self.httpd.shutdown()
            except Exception:
                pass
            self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10.0)
        self._pool.close_all()

    def __enter__(self) -> "FrontDoor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class _FrontDoorHTTPServer(ThreadingHTTPServer):
    # the federation tier fronts every pod's client burst
    request_queue_size = 128


def _make_handler(door: FrontDoor):
    log = get_logger()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("fed-http: " + fmt, *args)

        def _reply(self, code, ctype, body, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code, payload, extra=()):
            c, t, b, e = _json_response(code, payload, list(extra))
            self._reply(c, t, b, e)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/healthz":
                code, payload = door.healthz()
                self._reply_json(code, payload)
            elif self.path == "/stats":
                self._reply_json(200, door.stats())
            elif self.path == "/metrics":
                body = door.render_metrics().encode()
                self._reply(200, obs_metrics.CONTENT_TYPE, body)
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            from urllib.parse import parse_qs, urlsplit

            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n)
            split = urlsplit(self.path)
            path = split.path
            if self.path == POD_HEARTBEAT_PATH:
                code, payload = door.handle_pod_heartbeat(body)
                self._reply_json(code, payload)
            elif path == "/v1/process":
                code, ctype, out, extra = door.handle_process(
                    body, self.headers, query=parse_qs(split.query)
                )
                self._reply(code, ctype, out, extra)
            elif path == "/v1/pipelines":
                code, payload = door.handle_graph_register(body)
                self._reply_json(code, payload)
            elif path == "/v1/tenants":
                code, payload = door.handle_graph_tenant(body)
                self._reply_json(code, payload)
            elif (route := fabric_session.parse_session_path(self.path)):
                code, ctype, out, extra = door.handle_session_frame(
                    route[0], body, self.headers
                )
                self._reply(code, ctype, out, extra)
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

    return Handler
