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

Backend mapping for ``plan='auto'`` (no calibration store in the port;
it resolves as the JAX package does when nothing was recorded):

  * ``torch`` plays the JAX package's ``xla``: ``auto`` -> ``fused``.
  * ``mxu`` is the JAX package's ``mxu``: ``auto`` -> ``fused`` (the walker
    with the whole-op banded products).
  * ``cuda`` plays the JAX package's ``auto``: ``auto`` -> ``off``, so the
    K1/K2 group route stays the default.
  * ``swar`` is the JAX package's ``swar``, a self-fusing backend: its
    kernels fuse each group in-stream, so every plan resolves to ``off``
    (an explicit one is logged and ignored).

Under ``cuda``, the stage-walker modes ``pointwise`` and ``fused`` are
refused: the walker is plain PyTorch, which the ``cuda`` backend never
runs on the card. They run under ``torch`` and ``mxu``.
"""

from __future__ import annotations

import logging

from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import op_family
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import Plan, Stage
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

# the user-facing knob ('on' is an alias for 'fused'), as in the JAX package
PLAN_MODES = ("auto", "off", "pointwise", "fused", "fused-pallas",
              "fused-pallas-mxu")
BUILD_MODES = ("off", "pointwise", "fused", "fused-pallas", "fused-pallas-mxu")
BACKENDS = ("torch", "cuda", "mxu", "swar")
# backends whose kernels fuse their own groups in-stream: the planner must
# not restructure what they already fused (ops/swar_kernels.swar_stencil)
_SELF_FUSING_BACKENDS = ("swar",)

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


def resolve_plan_mode(ops, plan: str = "auto", *, backend: str = "torch") -> str:
    """The build mode for this (pipeline, backend): see the module
    docstring for the mapping. Raises for a mode the backend does not run."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    mode = _norm_mode(plan)
    if backend in _SELF_FUSING_BACKENDS:
        if mode not in ("auto", "off"):
            logging.getLogger(__name__).info(
                "plan=%s ignored for backend %r (its kernels fuse groups in-stream "
                "already); running per-op", mode, backend,
            )
        return "off"
    if mode == "auto":
        return "off" if backend == "cuda" else "fused"
    if backend == "cuda" and mode in ("pointwise", "fused"):
        raise ValueError(
            f"plan {mode!r} is a stage-walker mode, which runs in plain "
            "PyTorch; in the port it runs under backends 'torch' "
            "(--impl torch) and 'mxu'. Under 'cuda' use 'off', 'fused-pallas' "
            "or 'fused-pallas-mxu'"
        )
    return mode


def commute_geometrics(ops) -> tuple:
    """Bubble commuting geometric ops (rot180/flips) left past adjacent
    pointwise ops, so a permutation between pointwise runs stops splitting
    a fusable stage. Each swap is exact: a per-pixel op commutes with a
    pixel permutation."""
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
