"""Multi-tenant admission: tenant registry, quotas, QoS classes, bounded
per-tenant function-cache namespaces. The counterpart of the JAX package's
``graph/tenancy.py`` (no jax in it; the port keeps its own copy).

A *tenant* is the unit of isolation the pipeline service admits by:

  * **registered specs**: each tenant registers its own pipeline specs
    (idempotent; the id is the spec's `dag_fingerprint`, so two tenants
    registering the same spec get the same id but separate namespaces);
  * **function-cache namespace**: built graph functions live in a
    per-tenant LRU bounded at `MCIM_GRAPH_CACHE_CAP` entries (a tenant
    registering pipelines without bound recycles ITS OWN cache slots;
    evictions are counted, nothing grows with tenant behaviour);
  * **quotas**: fixed-window request/byte budgets
    (`quota_requests`/`quota_bytes` per `window_s`); an exhausted window
    SHEDS with Retry-After = the window remainder (an explicit "come back
    later", counted as shed, never an error);
  * **QoS admission class**: interactive / standard / batch. Under load
    the LOW class sheds first: a class admits only while the load
    fraction is below its admit threshold (batch: the
    `MCIM_GRAPH_QOS_SHED_FRAC` shed threshold; standard: halfway between
    that and 1; interactive: full capacity). The serving scheduler honours
    the same ladder for chain traffic
    (``serve/scheduler.MicroBatchScheduler.submit(qos=...)``).

The registry itself is bounded (`MCIM_GRAPH_MAX_TENANTS`): tenant ids are
also metric labels, and an unbounded tenant set would be an unbounded
label set.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import _ID_RE, SpecError
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

ENV_MAX_TENANTS = "MCIM_GRAPH_MAX_TENANTS"
ENV_CACHE_CAP = "MCIM_GRAPH_CACHE_CAP"
ENV_QOS_SHED_FRAC = "MCIM_GRAPH_QOS_SHED_FRAC"
ENV_QUOTA_WINDOW_S = "MCIM_GRAPH_QUOTA_WINDOW_S"

# admission classes, best first. The scheduler and the graph service share
# this ladder, so "low QoS sheds first" means the same on both the chain
# and the graph paths.
QOS_CLASSES = ("interactive", "standard", "batch")


def qos_admit_frac(qos: str, shed_frac: float | None = None) -> float:
    """The load fraction below which `qos` still admits: interactive rides
    to full capacity, batch stops at the shed threshold, standard halfway
    between, so as load climbs past the threshold the classes shed strictly
    low-first."""
    if shed_frac is None:
        shed_frac = float(env_registry.get(ENV_QOS_SHED_FRAC))
    return {
        "interactive": 1.0,
        "standard": (1.0 + shed_frac) / 2.0,
        "batch": shed_frac,
    }[qos]


class GraphShed(Exception):
    """An explicit shed (quota window exhausted or QoS class over the
    load threshold): HTTP 503 + Retry-After, counted as shed."""

    def __init__(self, reason: str, message: str, retry_after_s: float):
        super().__init__(message)
        self.reason = reason  # 'quota' | 'qos' | 'inflight'
        self.retry_after_s = max(retry_after_s, 0.05)


@dataclasses.dataclass
class TenantConfig:
    tenant_id: str
    qos: str = "standard"
    quota_requests: int | None = None  # per window; None = unlimited
    quota_bytes: int | None = None
    window_s: float | None = None  # None: MCIM_GRAPH_QUOTA_WINDOW_S

    def __post_init__(self):
        if not isinstance(self.tenant_id, str) or not _ID_RE.match(
            self.tenant_id
        ):
            raise SpecError(
                "bad-tenant-id", f"bad tenant id {self.tenant_id!r}"
            )
        if self.qos not in QOS_CLASSES:
            raise SpecError(
                "bad-qos",
                f"unknown QoS class {self.qos!r} (known: {QOS_CLASSES})",
            )
        for field in ("quota_requests", "quota_bytes"):
            v = getattr(self, field)
            if v is not None and (
                not isinstance(v, (int, float)) or v < 0
            ):
                raise SpecError(
                    "bad-quota", f"{field} must be a non-negative number"
                )
        if self.window_s is None:
            self.window_s = float(env_registry.get(ENV_QUOTA_WINDOW_S))


class TenantState:
    """One tenant's live state: registered programs, its function-cache
    namespace (LRU, capped), and the current quota window."""

    def __init__(self, config: TenantConfig, cache_cap: int):
        self.config = config
        self.cache_cap = cache_cap
        # pipeline id -> (PipelineGraph, canonical spec dict)
        self.pipelines: dict[str, tuple] = {}
        # the function-cache namespace: pipeline id -> built function; its
        # own leaf lock (dict bookkeeping only: builds happen off-lock in
        # the service, serve/cache.py's discipline)
        self._cache_lock = threading.Lock()
        self.cache: OrderedDict[str, object] = OrderedDict()
        self.cache_evictions = 0
        # fixed quota window
        self.window_start = 0.0
        self.window_requests = 0
        self.window_bytes = 0
        # lifetime accounting (metrics/stats)
        self.requests_ok = 0
        self.requests_shed = 0

    def cache_put(self, key: str, fn) -> None:
        with self._cache_lock:
            self.cache[key] = fn
            self.cache.move_to_end(key)
            while len(self.cache) > self.cache_cap:
                self.cache.popitem(last=False)
                self.cache_evictions += 1

    def cache_get(self, key: str):
        with self._cache_lock:
            fn = self.cache.get(key)
            if fn is not None:
                self.cache.move_to_end(key)
            return fn


class TenantRegistry:
    """The bounded tenant table. `ensure` creates with defaults (a spec
    registration is enough to become a tenant); `configure` overwrites
    QoS/quotas. All mutation is under one lock; dispatch-path reads take
    the same lock briefly (dict lookups, no builds: builds happen off-lock
    in the service, as in serve/cache.py)."""

    def __init__(self, *, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, TenantState] = {}
        self.max_tenants = int(env_registry.get(ENV_MAX_TENANTS))
        self.cache_cap = int(env_registry.get(ENV_CACHE_CAP))
        self.qos_shed_frac = float(env_registry.get(ENV_QOS_SHED_FRAC))

    def ensure(self, tenant_id: str) -> TenantState:
        with self._lock:
            st = self._tenants.get(tenant_id)
            if st is not None:
                return st
            if len(self._tenants) >= self.max_tenants:
                raise SpecError(
                    "tenant-limit",
                    f"tenant registry is at its cap of {self.max_tenants}",
                )
            st = TenantState(TenantConfig(tenant_id), self.cache_cap)
            self._tenants[tenant_id] = st
            return st

    def configure(self, config: TenantConfig) -> TenantState:
        st = self.ensure(config.tenant_id)
        with self._lock:
            st.config = config
        return st

    def get(self, tenant_id: str) -> TenantState:
        with self._lock:
            st = self._tenants.get(tenant_id)
        if st is None:
            raise SpecError(
                "unknown-tenant", f"unknown tenant {tenant_id!r}"
            )
        return st

    def tenants(self) -> list[TenantState]:
        with self._lock:
            return list(self._tenants.values())

    # -- admission ---------------------------------------------------------

    def admit(
        self, st: TenantState, nbytes: int, load_frac: float
    ) -> None:
        """One request's quota + QoS gate; raises GraphShed on refusal.
        Quota windows are fixed (reset at each boundary): deterministic
        under a fake clock, O(1) per request."""
        now = self._clock()
        cfg = st.config
        with self._lock:
            if now - st.window_start >= cfg.window_s:
                st.window_start = now
                st.window_requests = 0
                st.window_bytes = 0
            remain = cfg.window_s - (now - st.window_start)
            if (
                cfg.quota_requests is not None
                and st.window_requests + 1 > cfg.quota_requests
            ):
                st.requests_shed += 1
                raise GraphShed(
                    "quota",
                    f"tenant {cfg.tenant_id!r} exceeded its "
                    f"{cfg.quota_requests}-request window",
                    remain,
                )
            if (
                cfg.quota_bytes is not None
                and st.window_bytes + nbytes > cfg.quota_bytes
            ):
                st.requests_shed += 1
                raise GraphShed(
                    "quota",
                    f"tenant {cfg.tenant_id!r} exceeded its "
                    f"{cfg.quota_bytes}-byte window",
                    remain,
                )
            if load_frac >= qos_admit_frac(cfg.qos, self.qos_shed_frac):
                st.requests_shed += 1
                raise GraphShed(
                    "qos",
                    f"load {load_frac:.2f} sheds QoS class "
                    f"{cfg.qos!r} (admits below "
                    f"{qos_admit_frac(cfg.qos, self.qos_shed_frac):.2f})",
                    1.0,
                )
            st.window_requests += 1
            st.window_bytes += nbytes

    def stats(self) -> dict:
        with self._lock:
            return {
                "tenants": {
                    tid: {
                        "qos": st.config.qos,
                        "quota_requests": st.config.quota_requests,
                        "quota_bytes": st.config.quota_bytes,
                        "window_s": st.config.window_s,
                        "pipelines": sorted(st.pipelines),
                        "cache_entries": len(st.cache),
                        "cache_evictions": st.cache_evictions,
                        "ok": st.requests_ok,
                        "shed": st.requests_shed,
                    }
                    for tid, st in self._tenants.items()
                },
                "max_tenants": self.max_tenants,
                "cache_cap": self.cache_cap,
                "qos_shed_frac": self.qos_shed_frac,
            }
