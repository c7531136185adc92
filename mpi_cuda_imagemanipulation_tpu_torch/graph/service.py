"""The pipeline service: registration + tenant-admitted graph dispatch. The
counterpart of the JAX package's ``graph/service.py``.

`GraphService` is the engine behind the HTTP surface (serve/server.py):

    register(tenant, spec)   validate (closed taxonomy, graph/spec.py),
                             compile-plan the DAG, store under the
                             tenant; returns the pipeline id, the spec's
                             `dag_fingerprint`, so registration is
                             idempotent and two tenants (or a port and a
                             JAX replica) registering one spec agree on
                             the id.
    process(tenant, id, img) admission (quota + QoS ladder,
                             graph/tenancy.py) -> per-tenant function
                             cache -> ONE call producing image + any
                             declared side outputs, on the service's
                             device (CUDA by default).

Wire surface (the JAX package's headers and paths):

    POST /v1/pipelines                  {"tenant": ..., "spec": {...}}
    POST /v1/tenants                    {"tenant": ..., "qos": ...,
                                         "quota_requests"/"quota_bytes"}
    POST /v1/process?pipeline=<id>      X-MCIM-Tenant / X-MCIM-Pipeline
                                        headers work too

Where the JAX package jits the program per pipeline, the port builds a
function once per pipeline (`graph/compile.graph_callable`, whose
accumulator routing is resolved once per image width), caches it in the
tenant's namespace, and wraps it with the cost ledger
(``obs/cost.wrap_cache_fn("graph", ...)``) under the DAG's boundary model
(`_graph_modeled_bytes`); `mcim_graph_compiles_total` counts those builds.
The group lane's stacked function (`_batched_fn`) runs a (B, H, W[, C])
stack image by image inside one call, so every image keeps its own border
and its own histogram: the batched answer is byte-equal to B solo calls.

Failure posture: every refusal is a `SpecError` (4xx-class structured
JSON with the taxonomy code) or a `GraphShed` (503 + Retry-After, counted
as shed); a hostile spec or request can never 500. The `graph.dispatch`
failpoint injects the one genuine 500 class (a device dispatch failure)
so the error path stays testable.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.graph.compile import (
    MergeStep,
    compile_graph,
    graph_callable,
    graph_sub_callable,
    live_keys_at,
    split_for_placement,
)
from mpi_cuda_imagemanipulation_tpu_torch.graph.ir import MergeNode, OpNode
from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError, parse_spec
from mpi_cuda_imagemanipulation_tpu_torch.graph.tenancy import (
    GraphShed,
    TenantConfig,
    TenantRegistry,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.resilience import deadline as deadline_mod
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import out_channels
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import as_image_tensor, resolve_device
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

ENV_MAX_INFLIGHT = "MCIM_GRAPH_MAX_INFLIGHT"

# the graph wire headers
HDR_TENANT = "X-MCIM-Tenant"
HDR_PIPELINE = "X-MCIM-Pipeline"
HDR_HISTOGRAM = "X-MCIM-Histogram"
HDR_STATS = "X-MCIM-Stats"
PIPELINES_PATH = "/v1/pipelines"
TENANTS_PATH = "/v1/tenants"

# bounded terminal-status label set of mcim_graph_requests_total
STATUSES = ("ok", "shed", "rejected", "error")

# bytes of the declared side outputs: int32[256]; int32 count/min/max and
# a float32 mean
_SIDE_BYTES = {"histogram": 256 * 4, "stats": 4 * 4}


def _node_channels(graph, channels: int) -> dict[str, int]:
    """Each node's channel count for a `channels`-channel source (the
    graph passed its channel checks)."""
    ch = {graph.source_id: channels}
    for n in graph.nodes:
        if isinstance(n, OpNode):
            ch[n.id] = n.op.out_channels or ch[n.input]
        elif isinstance(n, MergeNode):
            ch[n.id] = ch[n.inputs[0]]
    return ch


def _env_channels(program, channels: int) -> dict[str, int]:
    """Each env key's channel count (synthesized split keys included)."""
    ch = {program.graph.source_id: channels}
    for step in program.steps:
        if isinstance(step, MergeStep):
            ch[step.dst] = ch[step.node.inputs[0]]
        else:
            ch[step.dst] = out_channels(step.plan.ops, ch[step.src])
    return ch


def _img_channels(shape) -> int:
    return shape[2] if len(shape) == 3 else 1


def _outputs_bytes(graph, h: int, w: int, ch_of: dict) -> int:
    """The declared outputs' bytes: the u8 image and the side outputs."""
    total = h * w * ch_of[graph.outputs["image"]]
    return total + sum(_SIDE_BYTES[k] for k in graph.outputs if k in _SIDE_BYTES)


def _graph_modeled_bytes(program, args) -> float:
    """The DAG's boundary model for cost attribution (obs/cost): the u8
    source in, the DECLARED outputs out (image + histogram/stats side
    outputs); shared prefixes, merge joins and fused segments are inside
    the function and add nothing at the boundary. Computed from the spec
    alone (the function returns exactly the spec's `outputs` mapping)."""
    shape = tuple(args[0].shape)
    h, w = shape[0], shape[1]
    ch_of = _node_channels(program.graph, _img_channels(shape))
    return float(h * w * _img_channels(shape) + _outputs_bytes(program.graph, h, w, ch_of))


def _sub_modeled_bytes(program, hi: int, env: dict) -> float | None:
    """The boundary model of a step subrange ending at `hi`: the live env
    in, the live env at `hi` out (the declared outputs at the final step),
    channel counts from the spec for the source channel count the env's
    shapes imply (None when none does)."""
    some = next(iter(env.values()))
    h, w = some.shape[0], some.shape[1]
    for c in (1, 3):
        ch_of = _env_channels(program, c)
        if all(_img_channels(v.shape) == ch_of.get(k) for k, v in env.items()):
            break
    else:
        return None
    total = sum(v.numel() * v.element_size() for v in env.values())
    if hi == len(program.steps):
        return float(total + _outputs_bytes(program.graph, h, w, _node_channels(program.graph, c)))
    return float(total + sum(h * w * ch_of[k] for k in live_keys_at(program, hi)))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _result(out: dict, prefix: str = "") -> dict:
    """A call's outputs in the `process()` shape: the image as a host u8
    array, the histogram as ints, the stats with the mean rounded to 4
    places."""
    result: dict = {"image": _host(out[prefix + "image"])}
    if prefix + "histogram" in out:
        result["histogram"] = [int(v) for v in _host(out[prefix + "histogram"])]
    if prefix + "stats" in out:
        s = out[prefix + "stats"]
        result["stats"] = {
            "count": int(s["count"]),
            "min": int(s["min"]),
            "max": int(s["max"]),
            "mean": round(float(s["mean"]), 4),
        }
    return result


class GraphService:
    def __init__(
        self,
        *,
        registry: Registry | None = None,
        backend: str = "torch",
        plan: str = "auto",
        systolic: bool = False,
        load_frac=None,
        coalescer=None,
        clock=time.monotonic,
        device=None,
    ):
        self.registry = registry or Registry()
        self.backend = backend
        self.plan = plan
        # the torch device the graph functions run on (default CUDA; 'cpu'
        # runs the plain ops on the host)
        self.device = resolve_device(device)
        # serve/scheduler.MicroBatchScheduler (or None): when attached,
        # admitted graph dispatches ride the chain path's coalescing queue
        # as group lanes keyed (dag fingerprint, true shape), one stacked
        # function per (pipeline, batch bucket)
        self.coalescer = coalescer
        # stage-sharded execution across replicas (graph/systolic.py):
        # accept /v1/systolic hops and placement headers
        self.systolic = systolic
        self.tenants = TenantRegistry(clock=clock)
        # external load signal (the serving scheduler's queue fill); the
        # QoS ladder sheds on max(external, own-inflight fraction)
        self._load_frac = load_frac
        self.max_inflight = int(env_registry.get(ENV_MAX_INFLIGHT))
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._clock = clock
        self._log = get_logger()
        r = self.registry
        self._m_requests = r.counter(
            "mcim_graph_requests_total",
            "Graph-pipeline requests by terminal status "
            "(ok/shed/rejected/error).",
            labels=("status",),
        )
        self._m_rejections = r.counter(
            "mcim_graph_rejections_total",
            "Spec/request refusals by closed-taxonomy code "
            "(graph/spec.TAXONOMY: a bounded label set by construction).",
            labels=("code",),
        )
        self._m_shed = r.counter(
            "mcim_graph_shed_total",
            "Explicit sheds by reason (quota window / qos ladder / "
            "inflight cap).",
            labels=("reason",),
        )
        self._m_registrations = r.counter(
            "mcim_graph_registrations_total",
            "Accepted pipeline-spec registrations (idempotent re-posts "
            "count: the wire cost is real either way).",
        )
        self._m_deadline = deadline_mod.expired_counter(r)
        self._m_dispatch_s = r.histogram(
            "mcim_graph_dispatch_seconds",
            "Device+host time per graph dispatch.",
        )
        self._m_compiles = r.counter(
            "mcim_graph_compiles_total",
            "Graph functions built into a tenant cache namespace.",
        )
        self._m_coalesced = r.counter(
            "mcim_graph_coalesced_total",
            "Graph dispatches routed through the serving scheduler's "
            "group lanes, by outcome (batched = answered by the lane; "
            "fallback = lane refused, answered by the solo golden path: "
            "a bounded two-label set).",
            labels=("outcome",),
        )
        # replica-side systolic accounting (these live where the bytes move)
        self._m_sys_tiles = r.counter(
            "mcim_systolic_tiles_forwarded_total",
            "Live-env handoffs forwarded to the next stage owner "
            "(one per stage boundary per request).",
        )
        self._m_sys_bytes = r.counter(
            "mcim_systolic_exchange_bytes_total",
            "u8 payload bytes crossing stage boundaries replica-to-"
            "replica.",
        )
        r.gauge(
            "mcim_graph_tenants",
            "Tenants in the registry (bounded by MCIM_GRAPH_MAX_TENANTS).",
            fn=lambda: float(len(self.tenants.tenants())),
        )
        r.gauge(
            "mcim_graph_pipelines",
            "Registered (tenant, pipeline) pairs.",
            fn=lambda: float(sum(len(t.pipelines) for t in self.tenants.tenants())),
        )
        r.gauge(
            "mcim_graph_cache_entries",
            "Built functions across all tenant cache namespaces "
            "(each namespace capped at MCIM_GRAPH_CACHE_CAP).",
            fn=lambda: float(sum(len(t.cache) for t in self.tenants.tenants())),
        )
        r.gauge(
            "mcim_graph_cache_evictions",
            "Cumulative LRU evictions out of tenant cache namespaces.",
            fn=lambda: float(sum(t.cache_evictions for t in self.tenants.tenants())),
        )

    # -- registration ------------------------------------------------------

    def on_reject(self, code: str) -> None:
        """Count one closed-taxonomy refusal (the HTTP layer calls this for
        refusals it maps itself, e.g. undecodable request bodies)."""
        self._m_requests.inc(status="rejected")
        self._m_rejections.inc(code=code)

    def _compile(self, graph, width: int | None = None, plan: str | None = None):
        return compile_graph(graph, plan=self.plan if plan is None else plan,
                             backend=self.backend, width=width, device=self.device)

    def register(self, tenant_id: str, spec_raw) -> dict:
        """Validate + store one spec under the tenant; idempotent. Raises
        SpecError (closed taxonomy) on any refusal."""
        try:
            graph = parse_spec(spec_raw)
            st = self.tenants.ensure(tenant_id)
        except SpecError as e:
            self._m_rejections.inc(code=e.code)
            raise
        program = self._compile(graph)
        pid = program.dag_fp
        canonical = spec_raw if isinstance(spec_raw, dict) else None
        st.pipelines[pid] = (graph, canonical)
        self._m_registrations.inc()
        chain = graph.as_linear_chain()
        self._log.info(
            "graph: tenant %s registered %s (%s, %d nodes, %d segments)",
            tenant_id, pid, graph.name or "<unnamed>", len(graph.nodes), program.n_segments,
        )
        return {
            "pipeline": pid,
            "tenant": tenant_id,
            "name": graph.name,
            "nodes": len(graph.nodes),
            "segments": program.n_segments,
            "merges": program.n_merges,
            "outputs": sorted(graph.outputs),
            "linear_chain": ",".join(op.name for op in chain) if chain else None,
            "fingerprint": program.fingerprint,
        }

    def configure_tenant(self, body: dict) -> dict:
        """`POST /v1/tenants` body -> stored TenantConfig; SpecError on any
        refusal (bad-tenant-id / bad-qos / bad-quota)."""
        if not isinstance(body, dict):
            raise SpecError("bad-root", "tenant config must be an object")
        unknown = set(body) - {"tenant", "qos", "quota_requests", "quota_bytes", "window_s"}
        if unknown:
            raise SpecError("unknown-field", f"unknown tenant fields {sorted(unknown)}")
        cfg = TenantConfig(
            tenant_id=body.get("tenant", ""),
            qos=body.get("qos", "standard"),
            quota_requests=body.get("quota_requests"),
            quota_bytes=body.get("quota_bytes"),
            window_s=body.get("window_s"),
        )
        st = self.tenants.configure(cfg)
        return {
            "tenant": cfg.tenant_id,
            "qos": cfg.qos,
            "quota_requests": cfg.quota_requests,
            "quota_bytes": cfg.quota_bytes,
            "window_s": st.config.window_s,
        }

    # -- dispatch ----------------------------------------------------------

    def _current_load(self) -> float:
        own = self._inflight / max(1, self.max_inflight)
        ext = 0.0
        if self._load_frac is not None:
            try:
                ext = float(self._load_frac())
            except Exception:  # the signal must never fail a request
                ext = 0.0
        return max(own, ext)

    def _lookup(self, tenant_id: str, pipeline_id: str):
        st = self.tenants.get(tenant_id)
        entry = st.pipelines.get(pipeline_id)
        if entry is None:
            raise SpecError(
                "unknown-pipeline", f"tenant {tenant_id!r} has no pipeline {pipeline_id!r}"
            )
        return st, entry[0]

    def _admit(self, st, nbytes: int) -> None:
        """The quota/QoS gate and the inflight cap; counts a shed."""
        try:
            self.tenants.admit(st, nbytes, self._current_load())
        except GraphShed as e:
            self._m_requests.inc(status="shed")
            self._m_shed.inc(reason=e.reason)
            raise
        with self._inflight_lock:
            if self._inflight >= self.max_inflight:
                self._m_requests.inc(status="shed")
                self._m_shed.inc(reason="inflight")
                raise GraphShed(
                    "inflight",
                    f"{self._inflight} graph dispatches already in flight "
                    f"(cap {self.max_inflight})",
                    0.5,
                )
            self._inflight += 1

    def _release(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def process(
        self,
        tenant_id: str,
        pipeline_id: str,
        img: np.ndarray,
        *,
        nbytes: int | None = None,
        trace_id: str = "",
        deadline: deadline_mod.Deadline | None = None,
    ) -> dict:
        """One admitted graph dispatch -> {'image': np.uint8 array,
        'histogram'?: list[int], 'stats'?: dict}. Raises SpecError
        (rejected) / GraphShed (shed) / DeadlineExpired (the propagated
        budget died before dispatch) / anything else = a real error."""
        try:
            st, graph = self._lookup(tenant_id, pipeline_id)
            self._validate_image(graph, img)
        except SpecError as e:
            self._m_requests.inc(status="rejected")
            self._m_rejections.inc(code=e.code)
            raise
        if deadline is not None and deadline.expired():
            # checked between validation and admission: a dead budget must
            # not charge the tenant's quota window, and certainly not reach
            # the dispatch
            deadline_mod.count_expired(self._m_deadline, "graph")
            self._m_requests.inc(status="deadline_expired")
            raise deadline_mod.DeadlineExpired("graph dispatch budget exhausted before admission")
        self._admit(st, img.nbytes if nbytes is None else nbytes)
        t0 = self._clock()
        try:
            failpoints.maybe_fail("graph.dispatch", tenant=tenant_id, pipeline=pipeline_id)
            width = img.shape[1]
            if self.coalescer is not None:
                out = self._coalesced(st, pipeline_id, graph, img, width,
                                      qos=st.config.qos, trace_id=trace_id)
            else:
                out = self._pipeline_fn(st, pipeline_id, graph, width)(img)
            result = _result(out)
        except Exception:
            self._m_requests.inc(status="error")
            raise
        finally:
            self._release()
        self._m_dispatch_s.observe(self._clock() - t0, exemplar=trace_id or None)
        self._m_requests.inc(status="ok")
        st.requests_ok += 1
        return result

    # -- built functions ---------------------------------------------------

    def _on_device(self, fn):
        """`fn` taking host arrays or tensors: moved to the service's device
        first (the group lane hands the engine's staged tensors, its sync
        paths host arrays)."""
        dev = self.device
        return lambda x: fn(as_image_tensor(x, dev))

    def _pipeline_fn(self, st, pipeline_id: str, graph, width: int | None):
        """Cached solo function for the whole program (the uncoalesced path
        and the group lane's golden fallback)."""
        fn = st.cache_get(pipeline_id)
        if fn is None:
            # built OFF the registry lock (serve/cache.py's discipline); a
            # racing miss builds twice and cache_put keeps the newest; both
            # are the same program
            program = self._compile(graph, width)
            # cost attribution rides the insertion (obs/cost): the first
            # call lands its measured boundary bytes in the ledger under
            # the program's execution-structure fingerprint
            fn = self._on_device(obs_cost.wrap_cache_fn(
                "graph", program.fingerprint,
                graph_callable(program, impl=self.backend),
                modeled_fn=lambda args, p=program: _graph_modeled_bytes(p, args),
            ))
            st.cache_put(pipeline_id, fn)
            self._m_compiles.inc()
        return fn

    def _batched_fn(self, st, pipeline_id: str, graph, width: int | None, nb: int):
        """Cached stacked function for nb-image group-lane dispatch, cached
        as f"{pipeline_id}@b{nb}" in the same tenant namespace (the '@'
        separator cannot appear in a pipeline id). The (nb, H, W[, C]) stack
        runs image by image inside the call: every image keeps its own
        border extension and its own histogram, so the batched outputs are
        byte-equal to nb solo calls (the group lane's premise)."""
        key = f"{pipeline_id}@b{nb}"
        fn = st.cache_get(key)
        if fn is None:
            program = self._compile(graph, width)
            solo = graph_callable(program, impl=self.backend)

            def stacked(x: torch.Tensor) -> dict:
                outs = [solo(x[k]) for k in range(x.shape[0])]
                return _stack_trees(outs)

            fn = self._on_device(obs_cost.wrap_cache_fn(
                "graph", f"{program.fingerprint}@b{nb}", stacked,
                modeled_fn=lambda args, p=program, n=nb: n * _graph_modeled_bytes(
                    p, (args[0][0],)),
            ))
            st.cache_put(key, fn)
            self._m_compiles.inc()
        return fn

    def _coalesced(self, st, pipeline_id: str, graph, img, width: int | None, *,
                   qos: str, trace_id: str):
        """One dispatch through the serving scheduler's group lane, keyed
        (dag fingerprint, true shape) so same-program same-shape requests
        share one stacked function per batch bucket. Coalescing is a pure
        optimisation: any lane-level refusal (queue at depth, lane
        quarantined, scheduler stopping) falls back to the solo golden
        path (tenant admission already passed, so the request must still
        be answered, and the solo output is byte-equal to the batched
        one)."""
        from mpi_cuda_imagemanipulation_tpu_torch.serve.scheduler import GroupSpec

        spec = GroupSpec(
            key=("graph", pipeline_id, img.shape[0], img.shape[1], _img_channels(img.shape)),
            get_fn=lambda nb: self._batched_fn(st, pipeline_id, graph, width, nb),
            fallback=lambda im: self._pipeline_fn(st, pipeline_id, graph, width)(im),
        )
        req = self.coalescer.submit_group(img, spec, trace_id=trace_id or None, qos=qos)
        try:
            out = req.wait()
        except Exception:
            self._m_coalesced.inc(outcome="fallback")
            return self._pipeline_fn(st, pipeline_id, graph, width)(img)
        self._m_coalesced.inc(outcome="batched")
        return out

    # -- systolic (stage-sharded) dispatch ---------------------------------

    def _sub_fn(self, st, pipeline_id: str, graph, lo: int, hi: int, width: int | None):
        """Cached function for the step subrange [lo, hi), in the same
        tenant namespace as the pinned function (the '#' cache-key
        separator cannot appear in a pipeline id), with cost attribution
        keyed by fingerprint + range, so the ledger tells a stage owner's
        share from the whole program. It takes and returns an env of
        tensors on the service's device."""
        key = f"{pipeline_id}#r{lo}-{hi}"
        fn = st.cache_get(key)
        if fn is None:
            # the canonical systolic step form: plan='off' (per-op stages,
            # no calibration dependence) + stage-boundary splitting, so
            # every owner derives the SAME step indices from the spec with
            # no shared state; plan partitioning never changes values
            program = split_for_placement(self._compile(graph, width, plan="off"))
            sub = graph_sub_callable(program, lo, hi, impl=self.backend)

            def modeled(args, p=program):
                return _sub_modeled_bytes(p, hi, args[0])

            fn = obs_cost.wrap_cache_fn(
                "graph", f"{program.fingerprint}:r{lo}-{hi}", sub, modeled_fn=modeled,
            )
            st.cache_put(key, fn)
            self._m_compiles.inc()
        return fn

    def count_forward(self, nbytes: int) -> None:
        """One live-env handoff left this replica (the HTTP layer calls
        this after a successful peer POST)."""
        self._m_sys_tiles.inc()
        self._m_sys_bytes.inc(nbytes)

    def systolic_process(self, placement: dict, idx: int, payload, *,
                         nbytes: int | None = None, trace_id: str = ""):
        """Run this replica's step range of a placed program.

        `idx` is this replica's index in placement['ranges']. At the entry
        owner (idx 0) `payload` is the decoded u8 image and the FULL
        admission path runs (validation, quota/QoS, inflight cap): a
        refusal here is the request's real refusal, relayed verbatim. At
        interior owners `payload` is the live env decoded from the handoff
        frame; the request was already admitted, so a hop never sheds
        (shedding mid-chain would break accepted => answered).

        Returns ``("env", env)`` with the [hi) boundary env (host u8 arrays)
        to forward, or ``("result", result)`` at the final owner, `result`
        in the exact `process()` shape, counted as the request's one
        terminal 'ok'."""
        tenant_id = placement["tenant"]
        pipeline_id = placement["pipeline"]
        ranges = placement["ranges"]
        lo, hi = ranges[idx]
        entry = idx == 0
        final = idx == len(ranges) - 1
        try:
            st, graph = self._lookup(tenant_id, pipeline_id)
            if entry:
                self._validate_image(graph, payload)
        except SpecError as e:
            self._m_requests.inc(status="rejected")
            self._m_rejections.inc(code=e.code)
            raise
        if entry:
            self._admit(st, payload.nbytes if nbytes is None else nbytes)
            env = {graph.source_id: payload}
        else:
            # a decoded handoff frame's arrays are read-only views of the
            # body: the tensors get writable copies
            env = {k: v if v.flags.writeable else v.copy() for k, v in payload.items()}
        width = next(iter(env.values())).shape[1]
        t0 = self._clock()
        try:
            if entry:
                failpoints.maybe_fail("graph.dispatch", tenant=tenant_id, pipeline=pipeline_id)
            fn = self._sub_fn(st, pipeline_id, graph, lo, hi, width)
            out = fn({k: as_image_tensor(v, self.device) for k, v in env.items()})
            if not final:
                out = {k: _host(v) for k, v in out.items()}
            else:
                out = _result(out, "~")
        except Exception:
            self._m_requests.inc(status="error")
            raise
        finally:
            if entry:
                self._release()
        self._m_dispatch_s.observe(self._clock() - t0, exemplar=trace_id or None)
        if not final:
            return "env", out
        self._m_requests.inc(status="ok")
        st.requests_ok += 1
        return "result", out

    def _validate_image(self, graph, img: np.ndarray) -> None:
        if not isinstance(img, np.ndarray) or img.dtype != np.uint8 or img.ndim not in (2, 3):
            raise SpecError("bad-image", "graphs take (H, W[, C]) uint8 images")
        if min(img.shape[:2]) < graph.min_true_dim:
            raise SpecError(
                "bad-image",
                f"image {img.shape[0]}x{img.shape[1]} is below the graph's minimum "
                f"dimension {graph.min_true_dim} (stencil border extension)",
            )
        graph.check_channels(_img_channels(img.shape))

    def pipeline_ids(self) -> list[str]:
        """Every registered pipeline id across tenants."""
        ids: set[str] = set()
        for st in self.tenants.tenants():
            ids.update(st.pipelines)
        return sorted(ids)

    def stats(self) -> dict:
        return {
            "backend": self.backend,
            "plan": self.plan,
            "systolic": self.systolic,
            "device": str(self.device),
            "max_inflight": self.max_inflight,
            "inflight": self._inflight,
            **self.tenants.stats(),
        }


def _stack_trees(outs: list):
    """Stack a list of equal-structured result trees leaf by leaf."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack_trees([o[k] for o in outs]) for k in first}
    return torch.stack(outs)
