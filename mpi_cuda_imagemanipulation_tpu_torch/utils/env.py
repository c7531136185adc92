"""The registry of the ``MCIM_*`` environment variables the port reads.

The counterpart of the JAX package's ``utils/env.py``. Every variable is
declared once with its default, the module that reads it and a one-line
doc, and the port reads the environment only through `get`,
`get_bool`, `get_int` and `get_float`, which raise on an unregistered
name, so a misspelt name fails where it is read.

The port declares only names the JAX package registers, with the same
defaults: both packages may run in one process (the tests do) and read
one environment, and the repository's static check
(``tools/mcim_check.py``, rule ``env-unregistered``) holds every
``MCIM_*`` literal in the repository to the JAX registry. A knob only the
port has cannot take an ``MCIM_`` name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class EnvVar:
    name: str
    default: str | None  # value get() returns when unset (None = unset)
    consumer: str  # the module of the port that reads it
    doc: str


_VARS = (
    # -- fault injection (resilience/failpoints.py) -------------------------
    EnvVar("MCIM_FAILPOINTS", None, "resilience/failpoints.py",
           "Arm deterministic fault injection: comma-separated site=mode "
           "pairs (e.g. io.decode=first:2,halo.exchange=always)."),
    EnvVar("MCIM_FAILPOINT_SEED", "0", "resilience/failpoints.py",
           "Seed for probabilistic failpoint modes (deterministic "
           "fail/pass sequence per site)."),
    # -- logging (utils/log.py) ----------------------------------------------
    EnvVar("MCIM_LOG_LEVEL", None, "utils/log.py",
           "Logger verbosity: level name or number (DEBUG..CRITICAL or "
           "10..50); default INFO."),
    # -- tracing (obs/trace.py) ----------------------------------------------
    EnvVar("MCIM_TRACE_SAMPLE", None, "obs/trace.py",
           "Arm request-scoped tracing at this sample fraction "
           "(deterministic every-k-th; 1 = every trace)."),
    EnvVar("MCIM_TRACE_TAIL", "256", "obs/trace.py",
           "Deferred tail-keep buffer: sampled-OUT traces buffer up to "
           "this many concurrently-open traces and promote to kept when "
           "the root ends with an error status or a p99-slow duration; 0 "
           "restores pure root sampling."),
    # -- flight recorder (obs/recorder.py) -----------------------------------
    EnvVar("MCIM_RECORDER_DIR", None, "obs/recorder.py",
           "Directory post-mortem flight-recorder dumps are written to "
           "(default artifacts/recorder/)."),
    EnvVar("MCIM_RECORDER_CAP", "2048", "obs/recorder.py",
           "Flight-recorder ring capacity: the newest N entries a dump can "
           "contain."),
    EnvVar("MCIM_RECORDER_MIN_INTERVAL_S", "30", "obs/recorder.py",
           "Per-trigger dump rate limit in seconds."),
    # -- online tuning store (tune/store.py) ---------------------------------
    EnvVar("MCIM_TUNE", "0", "tune/store.py",
           "=1 persists online tuning observations and promotions to the "
           "calibration store."),
    EnvVar("MCIM_TUNE_STALE_S", "900", "tune/store.py",
           "Staleness half-life for online observations (seconds); samples "
           "older than 8 half-lives are dropped."),
    EnvVar("MCIM_TUNE_RESERVOIR", "64", "tune/store.py",
           "Max online samples kept per (device kind, fingerprint, width "
           "window, arm); newest kept."),
    EnvVar("MCIM_TUNE_FLUSH_S", "1.0", "tune/store.py",
           "Min seconds between online-record merges into the calibration "
           "file."),
    # -- calibration store (utils/calibration.py) ---------------------------
    EnvVar("MCIM_CALIB_FILE", None, "utils/calibration.py",
           "Calibration store path (default ./.mcim_calibration.json)."),
    EnvVar("MCIM_NO_CALIB", None, "utils/calibration.py",
           "Any non-empty value disables calibration lookups (A/B tools "
           "must not be steered by a store)."),
    # -- backend routing switches (ops/) ------------------------------------
    EnvVar("MCIM_PREFER_SWAR", None, "ops/swar_kernels.py",
           "=1: route eligible stencil groups through the SWAR kernels "
           "K6-K8 on every auto path (A/B switch, off by default)."),
    EnvVar("MCIM_PREFER_MXU", None, "ops/mxu_kernels.py",
           "=1: route eligible stencil families onto the banded products "
           "on auto paths without a calibration record (CUDA devices "
           "only)."),
    EnvVar("MCIM_MXU_MODE", "banded", "ops/mxu_kernels.py",
           "Banded-product mode: banded (both separable passes as "
           "products) or hybrid (row pass in float ops, column pass as a "
           "product)."),
    EnvVar("MCIM_MXU_COL", "bf16split", "ops/mxu_kernels.py",
           "Column-pass arithmetic: bf16split (the 64a+b split) or f32."),
    EnvVar("MCIM_MXU_STAGE", "auto", "ops/mxu_kernels.py",
           "In-stage arm inside fused-pallas stages: auto (a CUDA device "
           "and a stage_arm record), off, on (K5, int8 where proven), "
           "f32 (K5 bf16), int8 (as on)."),
    # -- fusion planner (plan/) ----------------------------------------------
    EnvVar("MCIM_PLAN", None, "plan/planner.py",
           "Plan mode used where an entry point is called with "
           "plan='auto' (off, pointwise, fused, fused-pallas, "
           "fused-pallas-mxu; 'on' = fused); unset: the calibration "
           "store's plan choice, then the backend default."),
    EnvVar("MCIM_PLAN_COMMUTE", "1", "plan/planner.py",
           "=0 disables hoisting rot180/flips out of pointwise runs "
           "before stage partitioning; byte-identical either way."),
    # -- cost attribution (obs/cost.py) ---------------------------------------
    EnvVar("MCIM_COST_ATTRIB", "1", "obs/cost.py",
           "=0 disables cost attribution: the boundary bytes of each "
           "built function's first call at every cache insertion site, "
           "and the mcim_cost_* families."),
    EnvVar("MCIM_COST_CAP", "64", "obs/cost.py",
           "Cost-ledger LRU capacity: attributions are keyed by (site, "
           "fingerprint, stage), which is unbounded in principle; metric "
           "label sets must not be."),
    EnvVar("MCIM_COST_DRIFT_MIN", "0.8", "obs/cost.py",
           "Lower edge of the acceptable drift band: a measured/modelled "
           "boundary-byte ratio below this trips "
           "mcim_cost_drift_alerts_total."),
    EnvVar("MCIM_COST_DRIFT_MAX", "1.25", "obs/cost.py",
           "Upper edge of the acceptable drift band."),
    # -- streaming tile engine (stream/) -------------------------------------
    EnvVar("MCIM_STREAM_TILE_ROWS", "512", "cli.py",
           "Default row-band height for the `stream` subcommand "
           "(--tile-rows overrides); the constant-memory budget knob."),
    EnvVar("MCIM_STREAM_INFLIGHT", "2", "cli.py",
           "Default in-flight tile dispatches for `stream` and `batch "
           "--stream-rows` (--inflight overrides); >= 2 overlaps the H2D "
           "of tile k+1 with tile k's compute."),
    # -- on-demand profiling (obs/profile.py) --------------------------------
    EnvVar("MCIM_PROFILE_DIR", None, "obs/profile.py",
           "Directory on-demand profile captures write their device trace "
           "and merged artifact under (default artifacts/profile/)."),
    EnvVar("MCIM_PROFILE_MIN_INTERVAL_S", "30", "obs/profile.py",
           "Per-process rate limit between live profile captures: a "
           "control plane cannot stack captures on a serving replica."),
    EnvVar("MCIM_PROFILE_MAX_S", "10", "obs/profile.py",
           "Capture-window ceiling in seconds (the HTTP caller blocks for "
           "the capture)."),
    EnvVar("MCIM_PROFILE_DEFAULT_S", "2", "obs/profile.py",
           "Capture window when POST /control/profile names none."),
    # -- pipeline service (graph/) -------------------------------------------
    EnvVar("MCIM_GRAPH_MAX_NODES", "64", "graph/spec.py",
           "Node-count cap on POSTed pipeline specs (a hostile spec is "
           "refused with the closed `too-large` taxonomy code, never "
           "built)."),
    EnvVar("MCIM_GRAPH_MAX_TENANTS", "64", "graph/tenancy.py",
           "Tenant-registry cap: tenant ids are metric labels, so the "
           "tenant set must be bounded (`tenant-limit` refusal past it)."),
    EnvVar("MCIM_GRAPH_CACHE_CAP", "8", "graph/tenancy.py",
           "Per-tenant function-cache namespace cap (LRU entries): a "
           "tenant registering pipelines without bound recycles its own "
           "slots."),
    EnvVar("MCIM_GRAPH_QOS_SHED_FRAC", "0.5", "graph/tenancy.py",
           "Load fraction past which batch-class traffic sheds (standard "
           "sheds halfway between this and 1; interactive rides to full "
           "capacity): the graph service's and the serving scheduler's "
           "qos= admission."),
    EnvVar("MCIM_GRAPH_QUOTA_WINDOW_S", "1.0", "graph/tenancy.py",
           "Default fixed quota window in seconds for per-tenant "
           "request/byte budgets (tenant config can override per tenant)."),
    EnvVar("MCIM_GRAPH_MAX_INFLIGHT", "8", "graph/service.py",
           "Concurrent graph dispatches per replica; past it even "
           "interactive traffic sheds with 503 + Retry-After."),
    EnvVar("MCIM_GRAPH_COALESCE", "1", "serve/server.py",
           "=0 disables graph micro-batch coalescing (per-request dispatch "
           "instead of the scheduler's (dag_fingerprint, true shape) group "
           "lanes; batched functions are byte-equal to solo ones)."),
    # -- serving fabric (fabric/, federation/control.py, obs/slo.py,
    # tune/controller.py, graph/systolic.py) --------------------------------
    EnvVar("MCIM_FABRIC_HEARTBEAT_S", "0.5", "fabric/control.py",
           "Replica heartbeat period in seconds (replica -> router push "
           "over HTTP)."),
    EnvVar("MCIM_FABRIC_STALE_S", "2.0", "fabric/router.py",
           "Router freshness window: a replica whose last heartbeat is "
           "older than this is routed around until it beats again."),
    EnvVar("MCIM_FABRIC_FORWARD_TIMEOUT_S", "30", "fabric/router.py",
           "Per-attempt router -> replica proxy timeout (connect + full "
           "response read)."),
    EnvVar("MCIM_FABRIC_FORWARD_ATTEMPTS", "3", "fabric/router.py",
           "Forward attempts per request across DISTINCT replicas before "
           "the router answers 503 (attempt 2+ counts as retried)."),
    EnvVar("MCIM_FABRIC_SHED_FRAC", "0.8", "fabric/router.py",
           "Queue-fill fraction (queued/queue_depth from the heartbeat) "
           "past which the sticky target is skipped for the least-loaded "
           "healthy replica."),
    EnvVar("MCIM_FABRIC_MIN_REPLICAS", "1", "fabric/autoscaler.py",
           "Autoscaler floor: the control loop never drains the replica "
           "set below this count."),
    EnvVar("MCIM_FABRIC_MAX_REPLICAS", "8", "fabric/autoscaler.py",
           "Autoscaler ceiling: scale-up stops here regardless of "
           "pressure."),
    EnvVar("MCIM_FABRIC_SCALE_UP_FRAC", "0.75", "fabric/autoscaler.py",
           "Mean queue-fill fraction across routable replicas that, "
           "sustained for MCIM_FABRIC_SCALE_SUSTAIN_S, triggers a "
           "scale-up."),
    EnvVar("MCIM_FABRIC_SCALE_DOWN_FRAC", "0.15", "fabric/autoscaler.py",
           "Mean queue-fill fraction BELOW which (sustained, and with a "
           "majority of replicas idle) the autoscaler drains one "
           "replica."),
    EnvVar("MCIM_FABRIC_SCALE_SUSTAIN_S", "3", "fabric/autoscaler.py",
           "How long a pressure signal must persist before the "
           "autoscaler acts on it (the hysteresis window — a blip "
           "scales nothing)."),
    EnvVar("MCIM_FABRIC_SCALE_COOLDOWN_S", "5", "fabric/autoscaler.py",
           "Quiet period after any scale action before the next one "
           "(lets the new replica set settle before re-evaluating)."),
    EnvVar("MCIM_FABRIC_SCALE_TICK_S", "0.5", "fabric/autoscaler.py",
           "Autoscaler evaluation period in seconds."),
    EnvVar("MCIM_FABRIC_SCALE_P99_TARGET_S", None, "fabric/autoscaler.py",
           "Optional latency up-signal: a federated p99 above this "
           "(sustained) also triggers scale-up, independent of queue "
           "fill."),
    EnvVar("MCIM_FABRIC_SCALE_DRAIN_DEADLINE_S", "30",
           "fabric/autoscaler.py",
           "Drain-before-kill budget: a draining replica whose queue "
           "has not emptied by then is SIGTERMed anyway (the replica's "
           "own drain deadline still flushes in-flight work)."),
    EnvVar("MCIM_FABRIC_CANARY_FRAC", "0.05", "fabric/canary.py",
           "Fraction of front-door traffic routed to the canary replica "
           "while a config flip is under evaluation."),
    EnvVar("MCIM_FABRIC_CANARY_MIN_REQUESTS", "40", "fabric/canary.py",
           "Canary outcomes the rollback gate needs before it may "
           "decide (breach can fire earlier on shadow digest "
           "mismatches, which are individually damning)."),
    EnvVar("MCIM_FABRIC_CANARY_SHADOW_EVERY", "5", "fabric/canary.py",
           "Every k-th canary-routed request is ALSO forwarded to a "
           "stable replica and the response digests compared (the "
           "bit-exactness spot check; the client gets the stable "
           "answer)."),
    EnvVar("MCIM_FABRIC_CANARY_BAD_FRAC", "0.10", "fabric/canary.py",
           "Absolute canary bad-outcome fraction past which the gate "
           "rolls back."),
    EnvVar("MCIM_FABRIC_CANARY_BURN_RATIO", "3", "fabric/canary.py",
           "Relative breach: canary bad rate must stay under this "
           "multiple of the stable lanes' bad rate over the gate "
           "window (the canary-vs-stable burn-rate comparison)."),
    EnvVar("MCIM_FABRIC_CANARY_PROMOTE_REQUESTS", "400",
           "fabric/canary.py",
           "Canary outcomes without a breach after which the gate "
           "reports the flip promotable."),
    EnvVar("MCIM_FABRIC_SESSION_TAIL", "0", "fabric/session.py",
           "Frames of journal tail the router retains per live video "
           "session for failover replay; 0 = sized automatically from "
           "the session pipeline's temporal windows (sum of windows)."),
    EnvVar("MCIM_SLO_SPECS", "avail:99.5,latency:1.0:99", "obs/slo.py",
           "Default SLO spec list for the fabric router's /slo engine: "
           "comma-separated avail:<pct> and latency:<le_seconds>:<pct> "
           "entries (docs/design.md \"Fleet observability\")."),
    EnvVar("MCIM_SLO_FAST_S", "300", "obs/slo.py",
           "Fast burn-rate window in seconds (the 5m page window; an "
           "alert fires only when fast AND slow burn exceed the "
           "threshold)."),
    EnvVar("MCIM_SLO_SLOW_S", "3600", "obs/slo.py",
           "Slow burn-rate window in seconds (the 1h confirmation "
           "window)."),
    EnvVar("MCIM_SLO_TICK_S", "5", "obs/slo.py",
           "SLO engine evaluation period in seconds (each tick samples "
           "the federated counters into the window ring)."),
    EnvVar("MCIM_SLO_BURN_THRESHOLD", "10", "obs/slo.py",
           "Burn-rate alert threshold: error-budget consumption rate "
           "(1 = exactly on budget) both windows must exceed to fire."),
    EnvVar("MCIM_SYSTOLIC", "0", "fabric/replica.py",
           "Default for --systolic: accept stage-sharded graph "
           "dispatches (run a placed step range, forward the live env "
           "to the next stage owner) and advertise it in heartbeats."),
    EnvVar("MCIM_SYSTOLIC_MIN_STEPS", "4", "fabric/router.py",
           "Smallest program (compiled step count) the router will "
           "stage-shard; shorter programs stay on the pinned lane "
           "(counted as fallback reason 'ineligible')."),
    EnvVar("MCIM_FED_HEARTBEAT_S", "1.0", "federation/control.py",
           "Pod -> front-door heartbeat interval (the pod router pushes "
           "aggregate PodHeartbeats; liveness at the federation tier is "
           "the absence of beats)."),
    EnvVar("MCIM_RETRY_BUDGET_FRAC", "0.1", "resilience/deadline.py",
           "Retry-budget deposit per accepted request at the door and "
           "router: retries/reroutes/hedges each withdraw one token, "
           "bounding attempt amplification at 1+frac asymptotically."),
    EnvVar("MCIM_RETRY_BUDGET_RESERVE", "8", "resilience/deadline.py",
           "Retry-budget starting balance (tokens): cold-start failover "
           "headroom before any deposits have banked (the breaker board "
           "trips within ~2 failures, so this covers the first probes)."),
    EnvVar("MCIM_HEDGE_DELAY_FRAC", "0", "fabric/router.py",
           "Hedged requests: a chain forward still pending past this "
           "fraction of the router's federated p99 gets ONE secondary "
           "forward to a different replica, first response wins; 0 "
           "disables hedging."),
    EnvVar("MCIM_HEDGE_MAX_FRAC", "0.05", "fabric/router.py",
           "Cap on hedges as a fraction of accepted requests (on top of "
           "the retry-budget withdrawal each hedge makes)."),
    EnvVar("MCIM_TUNE_TICK_S", "1.0", "tune/controller.py",
           "Tune controller decision-tick period (seconds)."),
    EnvVar("MCIM_TUNE_MIN_SAMPLES", "8", "tune/controller.py",
           "Effective observations an arm needs before the controller "
           "will exploit against it (below this: insufficient_data / "
           "explore)."),
    EnvVar("MCIM_TUNE_EXPLORE_C", "0.35", "tune/controller.py",
           "UCB exploration coefficient — widens the optimistic lower "
           "confidence bound on under-sampled arms; 0 = pure greedy."),
    EnvVar("MCIM_TUNE_MIN_GAIN", "1.05", "tune/controller.py",
           "Measured speedup a candidate must hold over the current arm "
           "to be proposed/promoted (1.05 = 5% — flips below this are "
           "churn, not wins)."),
    EnvVar("MCIM_TUNE_FLIP_TIMEOUT_S", "300", "tune/controller.py",
           "A promoted-by-the-gate flip that has produced no canary "
           "measurements after this long is reverted (rollback decision)."),
    EnvVar("MCIM_TUNE_CANARY_FRAC", None, "tune/controller.py",
           "Traffic fraction routed to a tuner-proposed canary replica "
           "(overrides the pod's CanaryConfig.frac for tuner flips only)."),
    EnvVar("MCIM_TUNE_ARMS", None, "fabric/supervisor.py",
           "Comma-separated candidate arms the controller may propose "
           "(e.g. plan:off,plan:fused); default: every plan mode the "
           "pipeline supports."),
)

REGISTRY: dict[str, EnvVar] = {v.name: v for v in _VARS}


def spec(name: str) -> EnvVar:
    """The declaration of `name`; raises KeyError for an unregistered
    name."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"env var {name!r} is not registered in "
            "mpi_cuda_imagemanipulation_tpu_torch/utils/env.py"
        ) from None


def get(name: str, env=None) -> str | None:
    """The registered variable's value, or its declared default. `env`
    defaults to os.environ; tests pass a mapping."""
    v = spec(name)
    raw = (os.environ if env is None else env).get(name)
    return v.default if raw is None else raw


def get_bool(name: str, env=None) -> bool:
    """Switch semantics of every MCIM_* toggle: unset, empty and "0" are
    off, anything else is on."""
    return get(name, env=env) not in (None, "", "0")


def get_int(name: str, env=None) -> int | None:
    raw = get(name, env=env)
    return None if raw in (None, "") else int(raw)


def get_float(name: str, env=None) -> float | None:
    raw = get(name, env=env)
    return None if raw in (None, "") else float(raw)


def registry_rows() -> tuple[EnvVar, ...]:
    """Every declared variable, sorted by name."""
    return tuple(sorted(_VARS, key=lambda v: v.name))
