"""Planner instrumentation: the ``mcim_plan_*`` metric families.

The counterpart of the JAX package's ``plan/metrics.py``, on the port's
``obs.metrics.Registry``, with the same family names and ``snapshot()``
keys. One module-level instance (`plan_metrics`): plans are built from many
entry points (jit, batched, sharded, serving, stream), and a per-call
registry would fragment the counters across them. `--json-metrics`
reports its snapshot, and the serving ``GET /metrics`` renders its
registry beside the app's (serve/server.py).

The port's callers count through plain integer and mapping views over the
registry's counters (``plan_metrics.pallas_stages += 1``,
``plan_metrics.pallas_fallbacks[reason] += 1``, ``dict(...)``): the
registry is the one store, and the views only read and advance it.
``reset()`` zeroes every family (``run`` counts per run).

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

from collections.abc import MutableMapping

from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Counter, Registry


class LabelCounts(MutableMapping):
    """One labelled registry counter read and advanced as a
    ``collections.Counter``: a missing key reads 0, ``view[k] += n``
    increments the family's ``{label=k}`` series, iteration yields the keys
    counted at least once. With no counter it makes its own on a private
    registry (an empty tally, as ``Counter()`` is)."""

    def __init__(self, counter: Counter | None = None):
        if counter is None:
            counter = Registry().counter("mcim_plan_counts_total", "Counts by key.",
                                         labels=("key",))
        self._counter = counter
        self._label = counter.label_names[0]

    def __getitem__(self, key) -> int:
        return int(self._counter.value(**{self._label: key}))

    def __setitem__(self, key, value) -> None:
        # counters only go up: the registry refuses a negative step
        self._counter.inc(value - self[key], **{self._label: key})

    def __delitem__(self, key) -> None:
        raise TypeError(f"{self._counter.name}: counters only go up")

    def _counted(self) -> list[str]:
        return [k[0] for k, v in sorted(self._counter.values().items()) if v]

    def __iter__(self):
        return iter(self._counted())

    def __len__(self) -> int:
        return len(self._counted())

    def __repr__(self) -> str:
        return f"LabelCounts({dict(self)!r})"


class PlanMetrics:
    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        r = self.registry
        self._builds = r.counter(
            "mcim_plan_builds_total",
            "Plans built, by build mode (off/pointwise/fused/fused-pallas/"
            "fused-pallas-mxu).",
            labels=("mode",),
        )
        self._stages = r.counter(
            "mcim_plan_stages_total",
            "Stages emitted across all built plans, by kind.",
            labels=("kind",),
        )
        self._fused_ops = r.counter(
            "mcim_plan_fused_ops_total",
            "Ops absorbed into another op's pass (fused-stage members "
            "beyond the first).",
        )
        self._passes_saved = r.counter(
            "mcim_plan_hbm_passes_saved_total",
            "Modelled whole-image memory passes removed vs per-op "
            "execution, summed over built plans.",
        )
        self._pallas_stages = r.counter(
            "mcim_plan_pallas_stages_total",
            "Fused stages run as one launch of the megakernel K4 "
            "(plan=fused-pallas[-mxu]).",
        )
        self._pallas_fallbacks = r.counter(
            "mcim_plan_pallas_fallbacks_total",
            "Fused-pallas stages K4 rejected to the K1/K2 group runner, by "
            "closed reason (plan/cuda_exec.py).",
            labels=("reason",),
        )
        self._mxu_stage_ops = r.counter(
            "mcim_plan_mxu_in_stage_total",
            "Stencil ops put on a tensor-core arm of K5 inside a fused "
            "stage, by arm (mxu/mxu-int8).",
            labels=("arm",),
        )
        self._mxu_stage_fallbacks = r.counter(
            "mcim_plan_mxu_in_stage_fallback_total",
            "Stencil ops with a banded formulation that stayed on the VPU "
            "arm inside a fused stage, by closed reason (off/family/"
            "not-cuda/no-calibration; ops/mxu_kernels.STAGE_FALLBACK_REASONS).",
            labels=("reason",),
        )
        self._mxu_golden_ops = r.counter(
            "mcim_plan_mxu_golden_ops_total",
            "Stencils with no banded form that the whole-op mxu route ran "
            "as their golden op on an image within their halo, by op "
            "(ops/mxu_kernels.pipeline_mxu).",
            labels=("op",),
        )
        self.builds = LabelCounts(self._builds)
        self.stages = LabelCounts(self._stages)
        self.pallas_fallbacks = LabelCounts(self._pallas_fallbacks)
        self.mxu_stage_ops = LabelCounts(self._mxu_stage_ops)
        self.mxu_stage_fallbacks = LabelCounts(self._mxu_stage_fallbacks)
        self.mxu_golden_ops = LabelCounts(self._mxu_golden_ops)

    # the unlabelled families as integers; `+=` advances the counter
    @property
    def fused_ops(self) -> int:
        return int(self._fused_ops.value())

    @fused_ops.setter
    def fused_ops(self, value: int) -> None:
        self._fused_ops.inc(value - self.fused_ops)

    @property
    def passes_saved(self) -> int:
        return int(self._passes_saved.value())

    @passes_saved.setter
    def passes_saved(self, value: int) -> None:
        self._passes_saved.inc(value - self.passes_saved)

    @property
    def pallas_stages(self) -> int:
        return int(self._pallas_stages.value())

    @pallas_stages.setter
    def pallas_stages(self, value: int) -> None:
        self._pallas_stages.inc(value - self.pallas_stages)

    def reset(self) -> None:
        """Zero every family (a run's counts start from nothing)."""
        for m in self.registry.metrics():
            m.clear()

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
