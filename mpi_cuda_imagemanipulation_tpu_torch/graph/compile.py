"""Graph compilation: topo-sort + stage partition, generalizing `plan/`'s
chain fusion to fan-out/fan-in. The counterpart of the JAX package's
``graph/compile.py``, on torch tensors.

The compiler cuts the DAG at its *materialization boundaries*: the
source, every merge, every fan-out tap (a node with more than one
consumer), and every node a spec output names. Between boundaries each
maximal linear op run becomes one `RunSegment`, compiled by the SAME
`plan/planner.build_plan` stage rules the chain path uses (pointwise
absorption + temporal blocking; the per-segment plan mode resolves
through `resolve_plan_mode`, whose calibration lookup keys on the
segment's `pipeline_fingerprint`, so a DAG branch that equals a
calibrated chain reuses its recorded plan choice unchanged). Merges are
join barriers: both inputs are materialized env values before the
combinator core runs.

Segments run the port's stage walker (``plan/exec.run_stage_full``), as
the JAX package's run its (impl ``xla`` or ``mxu``): the golden torch ops,
or the banded products for eligible stencils. The impls are the port's
``torch`` (the JAX package's ``xla``), ``mxu`` and ``auto`` (the banded
products where ``ops/mxu_kernels.use_mxu_for_stencil`` routes a stencil
on the device, else the golden ops); the walker's plan resolves as under
``torch`` for ``torch`` and ``auto``, as the stream's does.

Shared prefixes are computed ONCE by construction: the executor
evaluates steps in topological order into an environment keyed by node
id, so a tap's value is produced by exactly one step no matter how many
branches read it. The `on_stage` hook fires once per step each time the
executor builds for a new (width, device), the port's counterpart of a
JAX trace, so a test can count the steps a built program holds.

Side outputs ride the same call: `histogram` is the 256-bin int32 count
of the named node's u8 value (`ops/histogram.histogram_stats`), and
`stats` (count/min/max/mean) derives from that histogram, so one call
produces image + histogram + stats with no second pass over the pixels.
The mean's float32 sum of 256 products is written out in the order XLA's
CPU backend sums it under the JAX package's jit (`_sum256_f32`), since
its partial sums pass 2^24 on large images, where the order decides the
bits.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from mpi_cuda_imagemanipulation_tpu_torch.graph.ir import (
    MergeNode,
    OpNode,
    PipelineGraph,
    SourceNode,
    dag_fingerprint,
    merge_core,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.histogram import histogram_stats
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import F32, U8, StencilOp, exact_f32
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import Plan
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import build_plan, resolve_plan_mode

# the executor impls: the JAX package's 'xla' | 'mxu' | 'auto'
GRAPH_IMPLS = ("torch", "mxu", "auto")


@dataclasses.dataclass(frozen=True)
class RunSegment:
    """One maximal linear op run between materialization boundaries,
    compiled into fused stages by the chain planner."""

    dst: str  # node id whose value this segment produces
    src: str  # env key the segment reads
    plan: Plan

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(op.name for op in self.plan.ops)


@dataclasses.dataclass(frozen=True)
class MergeStep:
    """A join barrier: both inputs are materialized env values."""

    dst: str
    node: MergeNode


Step = RunSegment | MergeStep


@dataclasses.dataclass(frozen=True)
class GraphProgram:
    """A compiled graph: executable steps in topological order."""

    graph: PipelineGraph
    steps: tuple[Step, ...]
    mode: str  # the resolved build mode segments were fused with

    @property
    def dag_fp(self) -> str:
        return dag_fingerprint(self.graph)

    @property
    def n_segments(self) -> int:
        return sum(1 for s in self.steps if isinstance(s, RunSegment))

    @property
    def n_merges(self) -> int:
        return sum(1 for s in self.steps if isinstance(s, MergeStep))

    @property
    def hbm_passes(self) -> int:
        return sum(
            s.plan.hbm_passes for s in self.steps if isinstance(s, RunSegment)
        ) + self.n_merges

    @property
    def hbm_passes_unfused(self) -> int:
        return sum(
            s.plan.hbm_passes_unfused for s in self.steps if isinstance(s, RunSegment)
        ) + self.n_merges

    @property
    def fingerprint(self) -> str:
        """Execution-structure identity: the DAG fingerprint plus every
        segment's resolved stage partition, the graph function-cache key
        component (the role plan.Plan.fingerprint plays for the chain
        serve cache)."""
        key = self.dag_fp + "|" + self.mode + "|" + ";".join(
            f"{s.dst}<{s.src}:{s.plan.fingerprint}"
            if isinstance(s, RunSegment)
            else f"{s.dst}<{s.node.inputs[0]},{s.node.inputs[1]}:"
            f"{s.node.combinator}/k{s.node.alpha_k}"
            for s in self.steps
        )
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    def describe(self) -> str:
        rows = [
            f"graph program {self.graph.name or self.dag_fp}: "
            f"{self.n_segments} segments + {self.n_merges} merges "
            f"(mode={self.mode}, hbm passes "
            f"{self.hbm_passes_unfused} -> {self.hbm_passes})"
        ]
        for s in self.steps:
            if isinstance(s, RunSegment):
                rows.append(
                    f"  seg {s.dst} <- {s.src}: {'+'.join(s.names)} "
                    f"({len(s.plan.stages)} stages)"
                )
            else:
                rows.append(
                    f"  merge {s.dst} <- {s.node.inputs[0]} "
                    f"{s.node.combinator} {s.node.inputs[1]}"
                )
        return "\n".join(rows)


def _check_impl(impl: str) -> None:
    if impl not in GRAPH_IMPLS:
        raise ValueError(f"unknown graph impl {impl!r}; known: {GRAPH_IMPLS}")


def compile_graph(
    graph: PipelineGraph,
    *,
    plan: str = "auto",
    backend: str = "torch",
    width: int | None = None,
    device=None,
) -> GraphProgram:
    """Partition the DAG into steps; each linear segment's fusion mode
    resolves through the chain planner's calibration-aware resolution
    (per-segment `pipeline_fingerprint` lookup: chain keys carry over),
    for the walker of impl `backend` (GRAPH_IMPLS) on `device`."""
    _check_impl(backend)
    walker = "mxu" if backend == "mxu" else "torch"
    consumers = graph.consumers
    out_refs = set(graph.outputs.values())

    def is_boundary(nid: str) -> bool:
        """A node whose value must materialize into the env."""
        if consumers[nid] != 1 or nid in out_refs:
            return True
        (consumer,) = (
            n for n in graph.nodes
            if (isinstance(n, OpNode) and n.input == nid)
            or (isinstance(n, MergeNode) and nid in n.inputs)
        )
        return not isinstance(consumer, OpNode)

    steps: list[Step] = []
    # op node id -> (segment source env key, ops so far) while the run is
    # still open (its nodes are interior: single-consumer, op-fed)
    open_seg: dict[str, tuple[str, list]] = {}
    resolved_mode: str | None = None
    for node in graph.nodes:
        if isinstance(node, SourceNode):
            continue
        if isinstance(node, MergeNode):
            steps.append(MergeStep(dst=node.id, node=node))
            continue
        src, ops = open_seg.pop(node.input, (node.input, []))
        ops = ops + [node.op]
        if is_boundary(node.id):
            mode = resolve_plan_mode(tuple(ops), plan, backend=walker, width=width, device=device)
            resolved_mode = resolved_mode or mode
            steps.append(RunSegment(dst=node.id, src=src, plan=build_plan(tuple(ops), mode)))
        else:
            open_seg[node.id] = (src, ops)
    assert not open_seg, f"unterminated segments {sorted(open_seg)}"
    # a graph of only merges/source still needs a mode label
    return GraphProgram(graph=graph, steps=tuple(steps), mode=resolved_mode or "off")


# --------------------------------------------------------------------------
# Stage placement (systolic execution)
# --------------------------------------------------------------------------


def split_for_placement(program: GraphProgram) -> GraphProgram:
    """The program with every multi-stage RunSegment split into one
    segment per plan stage: the canonical systolic step form.

    A linear chain compiles to ONE RunSegment (no interior
    materialization boundary), which would leave the placement pass
    nothing to cut; but the segment's plan stages each materialize u8
    anyway (`_run_step` runs `run_stage_full` per stage), so promoting
    those stage boundaries to step boundaries changes no value: it only
    names the intermediates (`dst~i`; `~` cannot appear in a spec node
    id, so synthesized keys never collide) and makes them placeable.
    Both the placing side and the stage owners derive this form from the
    same spec with `plan='off'`, so step indices agree across processes
    with no shared state."""
    steps: list[Step] = []
    for step in program.steps:
        if not isinstance(step, RunSegment) or len(step.plan.stages) <= 1:
            steps.append(step)
            continue
        src = step.src
        n = len(step.plan.stages)
        for i, stage in enumerate(step.plan.stages):
            dst = step.dst if i == n - 1 else f"{step.dst}~{i}"
            steps.append(
                RunSegment(dst=dst, src=src, plan=Plan(stages=(stage,), mode=step.plan.mode))
            )
            src = dst
    return dataclasses.replace(program, steps=tuple(steps))


@dataclasses.dataclass(frozen=True)
class StagePlacement:
    """Contiguous step-index ranges assigned to stage owners.

    Cuts land exactly at the materialization boundaries the step
    partition already produces (every step's `dst` is an env value), so
    a cut ships only live env tensors (u8, already materialized) and the
    handoff inherits the exact-integer carry contract. Contiguity in
    topological order is also the merge-barrier guarantee: every input of
    a step in range k was produced in range <= k, so a merge never waits
    on a later-placed branch."""

    ranges: tuple[tuple[int, int], ...]  # [lo, hi) step indices, topo order
    weights: tuple[float, ...]  # per-step balancer weight (bytes/pixel)
    source: str  # "measured" when any ledger record fed a weight

    @property
    def n_ranges(self) -> int:
        return len(self.ranges)

    def owner_of(self, step_idx: int) -> int:
        for k, (lo, hi) in enumerate(self.ranges):
            if lo <= step_idx < hi:
                return k
        raise IndexError(f"step {step_idx} is outside every range")

    def range_weight(self, k: int) -> float:
        lo, hi = self.ranges[k]
        return float(sum(self.weights[lo:hi]))


def partition_weights(weights, n: int) -> tuple[tuple[int, int], ...]:
    """Contiguous partition of `weights` into `n` non-empty ranges
    minimizing the maximum range sum: the classic linear-partition DP
    (step and stage counts are tiny, so O(n * k^2) is free). Returns
    [lo, hi) index pairs covering the whole list in order."""
    k = len(weights)
    if not 1 <= n <= k:
        raise ValueError(f"cannot cut {k} weights into {n} non-empty ranges")
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + float(w))

    # best[j][i] = minimal max-range-sum splitting weights[:i] into j ranges
    best = [[float("inf")] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    for i in range(1, k + 1):
        best[1][i] = prefix[i]
    for j in range(2, n + 1):
        for i in range(j, k + 1):
            for m in range(j - 1, i):
                cand = max(best[j - 1][m], prefix[i] - prefix[m])
                if cand < best[j][i]:
                    best[j][i] = cand
                    cut[j][i] = m
    bounds = [k]
    j, i = n, k
    while j > 1:
        i = cut[j][i]
        bounds.append(i)
        j -= 1
    bounds.append(0)
    bounds.reverse()
    return tuple((bounds[t], bounds[t + 1]) for t in range(len(bounds) - 1))


def _segment_weight(seg: RunSegment, c_in: int, ledger) -> tuple[float, int, bool]:
    """One RunSegment's balancer weight in bytes per source pixel: each
    fused stage reads its u8 input once and writes its u8 output once
    (the planner's one-read-one-write model), scaled by the measured
    drift ratio when the cost ledger holds a record for that stage of
    this segment's plan (site 'plan', key = plan fingerprint, stage label
    's<i>/<kind>': obs/cost.attribute_plan's keying), else by the online
    store's persisted ratio. Returns (weight, out_channels, measured_any)."""
    from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import out_channels
    from mpi_cuda_imagemanipulation_tpu_torch.tune.store import persisted_io_scale

    weight = 0.0
    measured = False
    ch = c_in
    for i, stage in enumerate(seg.plan.stages):
        try:
            ch_out = out_channels(stage.ops, ch)
        except ValueError:
            ch_out = ch
        w = float(ch + ch_out)  # u8 in + u8 out, per pixel
        ratio = None
        if ledger is not None:
            ratio = ledger.drift("plan", seg.plan.fingerprint, f"s{i}/{stage.kind}")
        if ratio is None:
            # no live record: the online tuning store may hold one
            # persisted by another process (same keying)
            ratio = persisted_io_scale(seg.plan.fingerprint, f"s{i}/{stage.kind}")
        if ratio is not None and ratio > 0:
            w *= ratio
            measured = True
        weight += w
        ch = ch_out
    return weight, ch, measured


def place_steps(
    program: GraphProgram,
    n_replicas: int,
    *,
    channels: int = 3,
    ledger=None,
) -> StagePlacement | None:
    """The stage-placement pass: assign contiguous step subsets of a
    compiled program to up to `n_replicas` owners, balanced by per-step
    boundary bytes (the measured cost-ledger record when one matches the
    segment plan's stage fingerprint, the one-u8-read-one-u8-write model
    otherwise).

    Returns None when the program cannot be split usefully (fewer than
    two steps, or fewer than two owners): callers fall back to pinned
    execution."""
    if ledger is None:
        from mpi_cuda_imagemanipulation_tpu_torch.obs.cost import cost_ledger

        ledger = cost_ledger
    n_steps = len(program.steps)
    n = min(int(n_replicas), n_steps)
    if n < 2:
        return None
    # channel counts per env key, walked in topo order (merges preserve
    # the channel count of their inputs by the static channel check)
    ch_of: dict[str, int] = {program.graph.source_id: channels}
    weights: list[float] = []
    measured_any = False
    for step in program.steps:
        if isinstance(step, RunSegment):
            w, ch_out, m = _segment_weight(step, ch_of.get(step.src, channels), ledger)
            measured_any = measured_any or m
            ch_of[step.dst] = ch_out
            weights.append(w)
        else:
            ch = ch_of.get(step.node.inputs[0], channels)
            ch_of[step.dst] = ch
            weights.append(float(3 * ch))  # two u8 reads + one u8 write
    return StagePlacement(
        ranges=partition_weights(weights, n),
        weights=tuple(weights),
        source="measured" if measured_any else "modeled",
    )


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------

# the f32 sum of 256 values: 8 blocks of 32 (below)
_SUM_BLOCK = 32


def _sum256_f32(v: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the last axis (256 entries) in one fixed order:
    the order XLA's CPU backend takes for ``jnp.sum`` of a float32[256]
    under jit (found by experiment with jax 0.9.0, and held to it by
    tests/test_torch_graph.py): left to right within 32-element blocks,
    then the 8 block totals left to right. Written out as ordered
    elementwise adds, the same bytes come out on every device; never
    through float64."""
    x = v.reshape(*v.shape[:-1], v.shape[-1] // _SUM_BLOCK, _SUM_BLOCK)
    part = x[..., 0]
    for i in range(1, _SUM_BLOCK):
        part = part + x[..., i]
    s = part[..., 0]
    for b in range(1, part.shape[-1]):
        s = s + part[..., b]
    return s


def _stats_from_hist(hist: torch.Tensor) -> dict[str, torch.Tensor]:
    """count/min/max/mean from the integer histogram: derived, so the
    whole side-output family costs one pixel pass. count, min and max are
    int32, the mean float32 over exact integer products, summed in
    `_sum256_f32`'s order."""
    bins = torch.arange(256, dtype=torch.int32, device=hist.device)
    total = hist.sum(dtype=torch.int32)
    occupied = hist > 0
    lo = torch.where(occupied, bins, 256).min()
    hi = torch.where(occupied, bins, -1).max()
    s = _sum256_f32(hist.to(F32) * bins.to(F32))
    mean = s / torch.clamp(total, min=1).to(F32)
    return {"count": total, "min": lo, "max": hi, "mean": mean}


def _auto_acc(op, width: int | None, device):
    from functools import partial

    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import (
        mxu_valid,
        use_mxu_for_stencil,
    )

    mode = use_mxu_for_stencil(op, width, device)
    return op.valid if mode is None else partial(mxu_valid, op, mode=mode)


def stage_accs(stage, impl: str, width: int | None, device) -> tuple | None:
    """Each stencil's accumulator in a fused stage under `impl`
    (plan/exec.acc_fns_for's tuple), None for a barrier stage. Reads the
    environment and the store under 'auto': resolve once per build."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import acc_fns_for

    if stage.kind != "fused":
        return None
    if impl == "auto":
        return tuple(
            _auto_acc(op, width, device) if isinstance(op, StencilOp) else None
            for op in stage.ops
        )
    return acc_fns_for(stage.ops, impl)


def _step_accs(step: Step, impl: str, width: int | None, device):
    """A step's per-stage accumulators (None for a merge)."""
    if isinstance(step, MergeStep):
        return None
    return tuple(stage_accs(stage, impl, width, device) for stage in step.plan.stages)


def _run_step(step: Step, env: dict, accs) -> None:
    """Execute one step against the env: the single step semantics every
    executor (full program, systolic subrange) shares, so a cut program
    cannot drift from the pinned one. `accs` is `_step_accs(step, ...)`."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import run_stage_full

    if isinstance(step, RunSegment):
        x = env[step.src]
        for stage, acc in zip(step.plan.stages, accs):
            if stage.kind == "global":
                x = stage.ops[0](x)
            else:
                x = run_stage_full(stage, x, acc)
        env[step.dst] = x
    else:
        a, b = (env[i] for i in step.node.inputs)
        env[step.dst] = merge_core(step.node, exact_f32(a), exact_f32(b)).to(U8)


def _side_outputs(graph: PipelineGraph, env: dict, prefix: str = "") -> dict:
    """The declared histogram/stats side outputs from the env (one
    histogram serves both when they name one node)."""
    out: dict = {}
    hist_node = graph.outputs.get("histogram")
    stats_node = graph.outputs.get("stats")
    hists = {nid: histogram_stats(env[nid], None) for nid in {hist_node, stats_node} if nid}
    if hist_node:
        out[prefix + "histogram"] = hists[hist_node]
    if stats_node:
        out[prefix + "stats"] = _stats_from_hist(hists[stats_node])
    return out


class _Builds:
    """The executor's per-(width, device) builds of its steps'
    accumulators, the port's counterpart of a jit trace: `on_stage(step)`
    fires once per step at each build."""

    def __init__(self, steps, impl: str, on_stage=None):
        _check_impl(impl)
        self.steps = tuple(steps)
        self.impl = impl
        self.on_stage = on_stage
        self._built: dict = {}

    def get(self, width: int, device) -> tuple:
        key = (width, str(device))
        accs = self._built.get(key)
        if accs is None:
            built = []
            for step in self.steps:
                if self.on_stage is not None:
                    self.on_stage(step)
                built.append(_step_accs(step, self.impl, width, device))
            accs = self._built[key] = tuple(built)
        return accs


def graph_callable(program: GraphProgram, *, impl: str = "torch", on_stage=None):
    """The full-image executor: a u8 image tensor (H, W[, C]) -> {output
    kind: tensor} function on the image's device: `image` u8 plus any
    declared `histogram` int32[256] and `stats` (int32 count/min/max,
    float32 mean) 0-d tensors.

    `on_stage(step)` fires once per step whenever the executor builds for
    a new (width, device) (`_Builds`): a tap's segment appears exactly
    once in a build, however many branches read it."""
    graph = program.graph
    builds = _Builds(program.steps, impl, on_stage)

    def run(img: torch.Tensor) -> dict:
        accs = builds.get(img.shape[1], img.device)
        env: dict = {graph.source_id: img}
        for step, acc in zip(program.steps, accs):
            _run_step(step, env, acc)
        return {"image": env[graph.outputs["image"]], **_side_outputs(graph, env)}

    return run


def live_keys_at(program: GraphProgram, cut: int) -> tuple[str, ...]:
    """Env keys a cut at step index `cut` must ship downstream: values
    produced at or before the cut (the source included) that a step in
    [cut, n) still reads, or that a declared output names. This is
    exactly the systolic handoff payload: everything else is dead at the
    boundary and never crosses the wire."""
    produced = {program.graph.source_id}
    for step in program.steps[:cut]:
        produced.add(step.dst)
    needed: set[str] = set()
    for step in program.steps[cut:]:
        if isinstance(step, RunSegment):
            needed.add(step.src)
        else:
            needed.update(step.node.inputs)
    needed.update(program.graph.outputs.values())
    return tuple(sorted(needed & produced))


def graph_sub_callable(program: GraphProgram, lo: int, hi: int, *, impl: str = "torch"):
    """Executor for the step subrange [lo, hi): one stage owner's share of
    a placed program. Takes the live env dict at the `lo` boundary (u8
    tensors keyed by node id, on one device), returns the live env at the
    `hi` boundary; when `hi` is the final step the declared outputs ride
    along under the reserved keys the full executor produces (`~image` /
    `~histogram` / `~stats`; node ids cannot collide: the spec id regex
    has no `~`). Step semantics are `_run_step`'s, so a split execution is
    byte-identical to the pinned one at every env materialization point."""
    if not 0 <= lo < hi <= len(program.steps):
        raise ValueError(f"bad step range [{lo}, {hi}) for {len(program.steps)} steps")
    graph = program.graph
    final = hi == len(program.steps)
    builds = _Builds(program.steps[lo:hi], impl)

    def run(env_in: dict) -> dict:
        env = dict(env_in)
        any_leaf = next(iter(env.values()))
        accs = builds.get(any_leaf.shape[1], any_leaf.device)
        for step, acc in zip(program.steps[lo:hi], accs):
            _run_step(step, env, acc)
        if not final:
            return {k: env[k] for k in live_keys_at(program, hi)}
        return {"~image": env[graph.outputs["image"]], **_side_outputs(graph, env, "~")}

    return run
