"""The op-graph IR: a pipeline compiled into fused execution stages.

The counterpart of the JAX package's ``plan/ir.py``. A `Plan` is a
partition of the op chain into `Stage`s, in op order:

  * ``fused``     - a run of pointwise/stencil ops executed as one pass;
                    stencils consume context from a stage-level halo grown
                    once (`Stage.halo`, the chain_halo of the stage), and
                    u8 is materialised only at the stage boundary.
  * ``geometric`` - one shape-changing data-movement op; a barrier.
  * ``global``    - one full-image-statistic op; a barrier.

Fingerprints use the same key strings as the JAX package, so both
packages give the same fingerprint for the same spec.
"""

from __future__ import annotations

import dataclasses
import hashlib

from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import op_family
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import Op

STAGE_KINDS = ("fused", "geometric", "global")


def _op_hbm_passes(op: Op) -> int:
    """Whole-image device-memory passes the per-op execution model charges
    for one op: 1, except global-statistics ops (stats pass + apply pass)."""
    return 2 if op_family(op) == "global-stat" else 1


@dataclasses.dataclass(frozen=True)
class Stage:
    """One fused execution region, in global op order."""

    kind: str  # one of STAGE_KINDS
    ops: tuple[Op, ...]
    halo: int  # sum of member stencil halos (the stage's grown halo)

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(f"unknown stage kind {self.kind!r}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(op.name for op in self.ops)

    @property
    def hbm_passes(self) -> int:
        """One pass for a fused region regardless of member count; barriers
        keep their op cost."""
        if self.kind == "fused":
            return 1
        return _op_hbm_passes(self.ops[0])


@dataclasses.dataclass(frozen=True)
class Plan:
    """A compiled stage partition of one op chain."""

    stages: tuple[Stage, ...]
    mode: str  # the build mode it was built with

    @property
    def ops(self) -> tuple[Op, ...]:
        return tuple(op for s in self.stages for op in s.ops)

    @property
    def total_halo(self) -> int:
        """Sum of stage halos; equals chain_halo(ops) by construction."""
        return sum(s.halo for s in self.stages)

    @property
    def fused_stages(self) -> tuple[Stage, ...]:
        return tuple(s for s in self.stages if s.kind == "fused")

    @property
    def n_absorbed_ops(self) -> int:
        """Ops that ride another op's pass instead of paying their own."""
        return sum(len(s.ops) - 1 for s in self.fused_stages)

    @property
    def hbm_passes(self) -> int:
        return sum(s.hbm_passes for s in self.stages)

    @property
    def hbm_passes_unfused(self) -> int:
        return sum(_op_hbm_passes(op) for op in self.ops)

    @property
    def hbm_passes_saved(self) -> int:
        return self.hbm_passes_unfused - self.hbm_passes

    @property
    def fingerprint(self) -> str:
        """Stable identity of the execution structure: pipeline ops plus
        the stage partition and the build mode."""
        key = pipeline_fingerprint(self.ops) + "|" + self.mode + "|" + ";".join(
            f"{s.kind}:{','.join(s.names)}:h{s.halo}" for s in self.stages
        )
        return hashlib.sha256(key.encode()).hexdigest()[:16]


def pipeline_fingerprint(ops) -> str:
    """Stable identity of an op chain (names + families + halos)."""
    key = "|".join(f"{op.name}/{op_family(op)}/h{op.halo}" for op in ops)
    return hashlib.sha256(key.encode()).hexdigest()[:16]
