"""Op-graph fusion planner, the counterpart of the JAX package's ``plan/``.

`plan/` compiles an op chain into fused execution stages before any
backend dispatches: pointwise runs are absorbed into their neighbouring
stencil's pass, and consecutive stencils share one stage whose halo is
grown once (`ops.spec.chain_halo`). Executors:

  * ``plan/exec.py``      - the stage walker in PyTorch ops, each stencil's
                            accumulator the golden one, the whole-op banded
                            products (impl 'mxu') or K5's plain version;
  * ``plan/cuda_exec.py`` - one launch of the megakernel K4 per eligible
                            stage (``plan='fused-pallas'`` under ``cuda``
                            and ``mxu``; ``'fused-pallas-mxu'`` with K5).

Every plan is byte-identical to the per-op golden chain (``plan='off'``).
"""

from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import (
    Plan,
    Stage,
    pipeline_fingerprint,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import PlanMetrics, plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import (
    PLAN_MODES,
    build_plan,
    resolve_plan_mode,
)

__all__ = [
    "PLAN_MODES",
    "Plan",
    "PlanMetrics",
    "Stage",
    "build_plan",
    "pipeline_fingerprint",
    "plan_metrics",
    "resolve_plan_mode",
]
