"""The fusion planner: op chain -> `Plan`, and the plan-mode resolution
every entry point shares. The counterpart of the JAX package's
``plan/planner.py``.

Build modes, all byte-identical in output; they differ only in execution
structure:

  * ``off``          - one stage per op: the per-op golden execution.
  * ``pointwise``    - each stage carries at most one stencil with its
                       adjacent pointwise run.
  * ``fused``        - maximal pointwise/stencil runs become one stage
                       whose halo is the run's chain_halo.
  * ``fused-pallas`` - partitions like ``fused``; under the ``cuda`` and
                       ``mxu`` backends each eligible stage runs as one
                       launch of the megakernel K4 (plan/cuda_exec.py). A
                       distinct build mode, so the plan fingerprint tells
                       the two executions apart.
  * ``fused-pallas-mxu`` - the same, with every eligible stencil forced onto
                       the tensor-core in-stage arm K5 (ops/mxu_kernels
                       .stage_arm_for, setting 'on'); under ``torch`` the
                       walker runs K5's plain version for those stencils.

``plan='auto'`` resolves as the JAX package resolves it
(`resolve_plan_mode`): ``MCIM_PLAN`` first, then the plan choice for
(device kind, pipeline fingerprint, width) that
tune/store.effective_plan_choice picks, the newer of the offline record
(utils/calibration.py, written by ``autotune --dimension plan``) and an
online ``promoted`` record, counting an override in
``mcim_tune_stale_overrides_total``; then the backend's default:

  * ``torch`` plays the JAX package's ``xla``: ``auto`` -> ``fused``.
  * ``mxu`` is the JAX package's ``mxu``: ``auto`` -> ``fused`` (the walker
    with the whole-op banded products).
  * ``auto`` and ``cuda`` play the JAX package's ``auto``: ``auto`` ->
    ``off``, so the K1/K2 group route stays the default. As in the JAX
    package, ``fused-pallas[-mxu]`` enters only behind a recorded win.
  * ``swar`` is the JAX package's ``swar``, a self-fusing backend: its
    kernels fuse each group in-stream, so every plan resolves to ``off``
    (an explicit one is logged and ignored).

Under ``cuda`` and ``auto``, the stage-walker modes ``pointwise`` and
``fused`` are refused when asked for (by ``plan`` or ``MCIM_PLAN``), and a
recorded one is ignored: the walker is plain PyTorch, which these backends
never run on the card. They run under ``torch`` and ``mxu``.
"""

from __future__ import annotations

from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import op_family
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import Plan, Stage, pipeline_fingerprint
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.tune.store import effective_plan_choice
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

# the user-facing knob ('on' is an alias for 'fused'), as in the JAX package
PLAN_MODES = ("auto", "off", "pointwise", "fused", "fused-pallas",
              "fused-pallas-mxu")
BUILD_MODES = ("off", "pointwise", "fused", "fused-pallas", "fused-pallas-mxu")
BACKENDS = ("torch", "cuda", "mxu", "swar", "auto")
# backends whose kernels fuse their own groups in-stream: the planner must
# not restructure what they already fused (ops/swar_kernels.swar_stencil)
_SELF_FUSING_BACKENDS = ("swar",)
# backends that never run the plain PyTorch walker ('pointwise', 'fused')
_KERNEL_ONLY_BACKENDS = ("cuda", "auto")

# geometric ops that are pure pixel permutations with unchanged (H, W): a
# per-pixel op commutes with them exactly, so fusing modes hoist them left
# past pointwise runs
_COMMUTE_GEOMS = ("rot180", "fliph", "flipv")


def _norm_mode(plan: str) -> str:
    mode = (plan or "auto").strip().lower()
    if mode == "on":
        mode = "fused"
    if mode not in PLAN_MODES:
        raise ValueError(f"unknown plan mode {plan!r}; known: {PLAN_MODES}")
    return mode


def _refuse(mode: str, backend: str, source: str) -> None:
    if backend in _KERNEL_ONLY_BACKENDS and mode in ("pointwise", "fused"):
        raise ValueError(
            f"{source} {mode!r} is a stage-walker mode, which runs in plain "
            "PyTorch; in the port it runs under backends 'torch' "
            f"(--impl torch) and 'mxu'. Under {backend!r} use 'off', "
            "'fused-pallas' or 'fused-pallas-mxu'"
        )


def check_plan(plan: str, backend: str) -> None:
    """Raise for an unknown backend or plan, or a plan the backend refuses:
    what `resolve_plan_mode` raises for, without reading the environment
    or the store (a built function calls it when it is built)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    _refuse(_norm_mode(plan), backend, "plan")


def resolve_plan_mode(
    ops,
    plan: str = "auto",
    *,
    backend: str = "torch",
    width: int | None = None,
    device=None,
) -> str:
    """The build mode for this (pipeline, backend) on an image `width`
    columns wide on `device` (None: the current CUDA device, else the CPU):
    see the module docstring for the order. Raises for a mode the backend
    does not run. Reads the environment and the store: resolve once per
    built function and image shape."""
    check_plan(plan, backend)
    mode = _norm_mode(plan)
    if mode == "auto":
        env_mode = env_registry.get("MCIM_PLAN")
        if env_mode:
            mode = _norm_mode(env_mode)
            _refuse(mode, backend, "MCIM_PLAN")
    if mode != "auto":
        if mode != "off" and backend in _SELF_FUSING_BACKENDS:
            get_logger().info(
                "plan=%s ignored for backend %r (its kernels fuse groups in-stream "
                "already); running per-op", mode, backend,
            )
            return "off"
        return mode
    if backend in _SELF_FUSING_BACKENDS:
        return "off"
    # newest wins between the offline record and the online promotion
    choice = effective_plan_choice(
        pipeline_fingerprint(ops), device_kind=calibration.current_device_kind(device),
        width=width,
    )
    if choice is not None and not (
        backend in _KERNEL_ONLY_BACKENDS and choice in ("pointwise", "fused")
    ):
        return choice
    return "off" if backend in _KERNEL_ONLY_BACKENDS else "fused"


def commute_geometrics(ops) -> tuple:
    """Bubble commuting geometric ops (rot180/flips) left past adjacent
    pointwise ops, so a permutation between pointwise runs stops splitting
    a fusable stage. Each swap is exact: a per-pixel op commutes with a
    pixel permutation. MCIM_PLAN_COMMUTE=0 turns it off."""
    if not env_registry.get_bool("MCIM_PLAN_COMMUTE"):
        return tuple(ops)
    out = list(ops)
    for i in range(1, len(out)):
        if op_family(out[i]) == "geometric" and out[i].name in _COMMUTE_GEOMS:
            j = i
            while j > 0 and op_family(out[j - 1]) == "pointwise":
                out[j - 1], out[j] = out[j], out[j - 1]
                j -= 1
    return tuple(out)


def build_plan(ops, mode: str = "fused") -> Plan:
    """Partition `ops` into execution stages per `mode` (a build mode:
    resolve 'auto' with resolve_plan_mode first). Fusing modes first hoist
    commuting geometric ops; 'off' keeps the user's op order."""
    ops = tuple(ops)
    if mode not in BUILD_MODES:
        raise ValueError(f"unknown build mode {mode!r}; known: {BUILD_MODES}")
    if mode != "off":
        ops = commute_geometrics(ops)
        # an armed `plan.fuse` failpoint fails a fusing build before any
        # executor exists; 'off' never consults it
        failpoints.maybe_fail("plan.fuse", n_ops=len(ops), mode=mode)
    stages: list[Stage] = []
    run: list = []  # current pointwise/stencil run

    def flush_run() -> None:
        if not run:
            return
        if mode == "off":
            for op in run:
                stages.append(Stage("fused", (op,), op.halo))
        elif mode == "pointwise":
            # a stencil closes its stage, absorbing the pointwise run before
            # it; a trailing pointwise run rides the last stage's write
            cur: list = []
            for op in run:
                cur.append(op)
                if op_family(op) == "stencil":
                    stages.append(Stage("fused", tuple(cur), chain_halo(cur)))
                    cur = []
            if cur:
                if stages and stages[-1].kind == "fused" and run[0] is not cur[0]:
                    prev = stages.pop()
                    stages.append(Stage("fused", prev.ops + tuple(cur), prev.halo))
                else:
                    stages.append(Stage("fused", tuple(cur), 0))
        else:  # fused / fused-pallas[-mxu]: the whole run is one stage
            stages.append(Stage("fused", tuple(run), chain_halo(run)))
        run.clear()

    for op in ops:
        fam = op_family(op)
        if fam == "geometric":
            flush_run()
            stages.append(Stage("geometric", (op,), 0))
        elif fam == "global-stat":
            flush_run()
            stages.append(Stage("global", (op,), 0))
        else:
            run.append(op)
    flush_run()
    plan = Plan(stages=tuple(stages), mode=mode)
    plan_metrics.on_build(plan)
    return plan
