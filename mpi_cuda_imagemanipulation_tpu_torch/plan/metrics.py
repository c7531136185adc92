"""Planner instrumentation: plain integer counters.

The counterpart of the JAX package's ``plan/metrics.py``, with the same
``snapshot()`` keys. One module-level instance (`plan_metrics`) counts
every plan built and every stage the fused-pallas executor routes, from
whichever entry point built it; `--json-metrics` reports its snapshot.
Counters are plain integers and ``collections.Counter``s, where the JAX
package builds them on ``obs.metrics.Registry`` as the
``mcim_plan_*`` families; the port's registry (obs/metrics.py) takes them
over with the first exposition that reads them (ROADMAP queue 1).

Under ``plan='fused-pallas'`` the port's megakernel is the CUDA kernel K4
(plan/cuda_exec.py), so ``pallas_stages`` counts K4 stage launches and
``pallas_fallbacks`` counts the stages K4 rejected, by reason. Under
``plan='fused-pallas-mxu'`` (and the ``mxu_stage`` argument of the K4/K4g
wrappers) each stencil of a stage takes an in-stage arm
(ops/mxu_kernels.stage_arm_for): ``mxu_stage_ops`` counts the stencils put
on a tensor-core arm of K5, by arm, and ``mxu_stage_fallbacks`` the
stencils with a banded formulation that stayed on the VPU arm, by closed
reason. Arms are resolved, and counted, once per stage when a plan
executor is built (plan/exec.plan_callable, plan/cuda_exec.plan_callable_cuda
at a stage's first K4 launch, the sharded runner at a stage's first K4g
launch) and once per call of a K4/K4g wrapper or plain version that is
not handed its arms.
"""

from __future__ import annotations

import collections


class PlanMetrics:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.builds: collections.Counter = collections.Counter()  # by build mode
        self.stages: collections.Counter = collections.Counter()  # by stage kind
        self.fused_ops = 0
        self.passes_saved = 0
        # fused-pallas stages run as one K4 launch, and those rejected to
        # the K1/K2 group runner by closed reason (plan/cuda_exec.py)
        self.pallas_stages = 0
        self.pallas_fallbacks: collections.Counter = collections.Counter()
        # in-stage tensor-core arms (K5), by arm, and the VPU landings of
        # ops that have one, by reason (ops/mxu_kernels.stage_arm_for)
        self.mxu_stage_ops: collections.Counter = collections.Counter()
        self.mxu_stage_fallbacks: collections.Counter = collections.Counter()
        # stencils with no banded form that the whole-op route ran as their
        # golden op, on an image within their halo, by op name
        # (ops/mxu_kernels.pipeline_mxu)
        self.mxu_golden_ops: collections.Counter = collections.Counter()

    def on_build(self, plan) -> None:
        self.builds[plan.mode] += 1
        for s in plan.stages:
            self.stages[s.kind] += 1
        self.fused_ops += plan.n_absorbed_ops
        self.passes_saved += plan.hbm_passes_saved

    def snapshot(self) -> dict:
        return {
            "builds_fused": self.builds["fused"],
            "builds_pointwise": self.builds["pointwise"],
            "builds_off": self.builds["off"],
            "builds_fused_pallas": self.builds["fused-pallas"],
            "builds_fused_pallas_mxu": self.builds["fused-pallas-mxu"],
            "stages_fused": self.stages["fused"],
            "fused_ops": self.fused_ops,
            "hbm_passes_saved": self.passes_saved,
            "pallas_stages": self.pallas_stages,
            "mxu_stage_ops": self.mxu_stage_ops["mxu"] + self.mxu_stage_ops["mxu-int8"],
        }


# the shared instance every build reports into
plan_metrics = PlanMetrics()
