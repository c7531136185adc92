"""The DAG IR: nodes, merge-combinator golden semantics, fingerprints. The
counterpart of the JAX package's ``graph/ir.py``, on torch tensors.

A `PipelineGraph` is the validated in-memory form of a pipeline spec
(graph/spec.py): one source, op nodes (each consuming one input), and
merge nodes joining exactly two branches. Fan-out taps are implicit:
any node with more than one consumer is materialized once and read by
every consumer (the executor's env is the memo table, so shared prefixes
are computed once by construction; tests/test_torch_graph.py asserts it
via the executor's `on_stage` hook).

**Merge combinators** follow ops/spec.py's golden-semantics discipline:
each core maps exact u8 integer values held in f32 to exact u8 integer
values, using only arithmetic that is deterministic and fma-immune on
every device:

  * ``subtract``        — ``trunc_clip(a - b)``: exact integer difference,
                          clamped. ``subtract(source, blurred)`` IS the
                          classic unsharp mask.
  * ``blend``           — ``rint_clip((a + b) * 0.5)``: the sum (<= 510)
                          and the power-of-two halving are both exact in
                          f32; rint is one correctly-rounded op.
  * ``alpha_composite`` — ``rint_clip((a*k + b*(256-k)) / 256)`` with
                          ``k = round(alpha * 256)``: an integer
                          multiply-accumulate (<= 255*256 < 2^24, exact
                          in f32, immune to fma contraction/reordering:
                          the sepia-matrix trick, ops/registry.py) and a
                          single exact power-of-two scale.

**Fingerprints.** ``dag_fingerprint`` extends ``pipeline_fingerprint``
(plan/ir.py): a graph that is a degenerate linear chain fingerprints as
EXACTLY that chain's ``pipeline_fingerprint``, so the calibration store
and every serve-cache key carry over unchanged between "the chain" and
"the chain written as a DAG"; true DAGs hash their full topology under a
``dag-`` prefix. The key strings are the JAX package's, so a pipeline id
is a wire identity: one spec registered with either package gets one id.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import op_family
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    Op,
    rint_clip_f32,
    trunc_clip_f32,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import pipeline_fingerprint


@dataclasses.dataclass(frozen=True)
class SourceNode:
    id: str


@dataclasses.dataclass(frozen=True)
class OpNode:
    id: str
    op: Op
    input: str


@dataclasses.dataclass(frozen=True)
class MergeNode:
    id: str
    combinator: str
    inputs: tuple[str, str]
    alpha_k: int = 256  # alpha quantized to k/256 (alpha_composite only)


Node = SourceNode | OpNode | MergeNode


def _merge_subtract(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    return trunc_clip_f32(a - b)


def _merge_blend(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    return rint_clip_f32((a + b) * 0.5)


def _merge_alpha(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    # float32 tensors times Python scalars stay float32; every factor here
    # (k <= 256, 1/256) is exact in float32, and each product and the sum
    # is its own rounded tensor op (no fma)
    acc = a * float(k) + b * float(256 - k)
    return rint_clip_f32(acc * (1.0 / 256.0))


# combinator name -> (a_f32, b_f32, alpha_k) -> f32; exact u8 integer
# values in, exact u8 integer values out (the fused-stage carry contract)
MERGE_COMBINATORS: dict[str, Callable] = {
    "subtract": _merge_subtract,
    "blend": _merge_blend,
    "alpha_composite": _merge_alpha,
}


def merge_core(node: MergeNode, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Apply one merge on the f32 exact-integer carry."""
    return MERGE_COMBINATORS[node.combinator](a, b, node.alpha_k)


@dataclasses.dataclass(frozen=True)
class PipelineGraph:
    """One validated pipeline DAG, nodes in a fixed topological order."""

    name: str
    nodes: tuple[Node, ...]  # topological order, source first
    source_id: str
    outputs: dict[str, str]  # output kind -> node id ('image' guaranteed)

    @property
    def by_id(self) -> dict[str, Node]:
        return {n.id: n for n in self.nodes}

    @property
    def consumers(self) -> dict[str, int]:
        """node id -> reference count (edges in + output refs)."""
        count = {n.id: 0 for n in self.nodes}
        for n in self.nodes:
            if isinstance(n, OpNode):
                count[n.input] += 1
            elif isinstance(n, MergeNode):
                for i in n.inputs:
                    count[i] += 1
        for nid in self.outputs.values():
            count[nid] += 1
        return count

    @property
    def ops(self) -> tuple[Op, ...]:
        return tuple(n.op for n in self.nodes if isinstance(n, OpNode))

    @property
    def max_halo(self) -> int:
        return max((op.halo for op in self.ops), default=0)

    @property
    def min_true_dim(self) -> int:
        """Smallest image dimension the graph can take (reflect-101
        border extension needs dim >= halo + 1, serve/padded.py)."""
        return self.max_halo + 1

    def as_linear_chain(self) -> tuple[Op, ...] | None:
        """The op chain when this graph is degenerate (a single
        source -> op -> ... -> op path with image-only output), else
        None. The fingerprint and the serving path use this to make
        "the chain written as a DAG" indistinguishable from the chain."""
        if set(self.outputs) != {"image"}:
            return None
        consumers = self.consumers
        chain: list[Op] = []
        cur = self.source_id
        for _ in range(len(self.nodes) - 1):
            nxt = [
                n for n in self.nodes
                if isinstance(n, OpNode) and n.input == cur
            ]
            if len(nxt) != 1 or consumers[cur] != 1:
                return None
            chain.append(nxt[0].op)
            cur = nxt[0].id
        if cur != self.outputs["image"] or consumers[cur] != 1:
            return None
        return tuple(chain)

    def check_channels(self, channels: int) -> None:
        """Validate that a `channels`-channel source feeds every edge and
        merge (raised as the closed `bad-image` code, so a bad request can
        never become a 500 inside the executor)."""
        from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError

        ch: dict[str, int] = {self.source_id: channels}
        for n in self.nodes:
            if isinstance(n, OpNode):
                got = ch[n.input]
                if n.op.in_channels and got and n.op.in_channels != got:
                    raise SpecError(
                        "bad-image",
                        f"node {n.id!r}: op {n.op.name!r} expects "
                        f"{n.op.in_channels} channels, gets {got}",
                    )
                ch[n.id] = n.op.out_channels or got
            elif isinstance(n, MergeNode):
                a, b = (ch[i] for i in n.inputs)
                if a and b and a != b:
                    raise SpecError(
                        "bad-image",
                        f"merge {n.id!r} joins {a}-channel and {b}-channel "
                        "branches",
                    )
                ch[n.id] = a or b

    def describe(self) -> str:
        rows = [f"graph {self.name or '<unnamed>'}: {len(self.nodes)} nodes"]
        consumers = self.consumers
        for n in self.nodes:
            if isinstance(n, SourceNode):
                desc = "source"
            elif isinstance(n, OpNode):
                desc = f"op {n.op.name} <- {n.input}"
            else:
                desc = f"merge {n.combinator} <- {n.inputs[0]},{n.inputs[1]}"
            tap = f" (tap x{consumers[n.id]})" if consumers[n.id] > 1 else ""
            rows.append(f"  {n.id}: {desc}{tap}")
        rows.append(
            "  outputs: "
            + ", ".join(f"{k}={v}" for k, v in sorted(self.outputs.items()))
        )
        return "\n".join(rows)


def build_graph(
    *, name: str, nodes: dict[str, Node], source_id: str,
    outputs: dict[str, str],
) -> PipelineGraph:
    """Wire + order a parsed node set: resolve references, topo-sort
    (cycle refusal), prune-check dangling nodes, chain channels. All
    refusals are closed-taxonomy SpecErrors (graph/spec.py)."""
    from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError

    def deps(n: Node) -> tuple[str, ...]:
        if isinstance(n, OpNode):
            return (n.input,)
        if isinstance(n, MergeNode):
            return n.inputs
        return ()

    for n in nodes.values():
        for d in deps(n):
            if d not in nodes:
                raise SpecError(
                    "unknown-input",
                    f"node {n.id!r} references unknown node {d!r}",
                )

    # Kahn topo sort; leftovers = a cycle
    indeg = {nid: len(deps(n)) for nid, n in nodes.items()}
    ready = sorted(nid for nid, d in indeg.items() if d == 0)
    rdeps: dict[str, list[str]] = {nid: [] for nid in nodes}
    for n in nodes.values():
        for d in deps(n):
            rdeps[d].append(n.id)
    order: list[str] = []
    while ready:
        nid = ready.pop(0)
        order.append(nid)
        for r in sorted(rdeps[nid]):
            indeg[r] -= 1
            if indeg[r] == 0:
                ready.append(r)
    if len(order) != len(nodes):
        cyclic = sorted(set(nodes) - set(order))
        raise SpecError("graph-cycle", f"cyclic node references {cyclic}")

    # reachability: every node must feed some output
    needed: set[str] = set(outputs.values())
    frontier = list(needed)
    while frontier:
        nid = frontier.pop()
        for d in deps(nodes[nid]):
            if d not in needed:
                needed.add(d)
                frontier.append(d)
    dangling = sorted(set(nodes) - needed)
    if dangling:
        raise SpecError(
            "dangling-node", f"nodes {dangling} feed no output"
        )

    g = PipelineGraph(
        name=name,
        nodes=tuple(nodes[nid] for nid in order),
        source_id=source_id,
        outputs=dict(outputs),
    )
    _check_static_channels(g)
    return g


def _check_static_channels(g: PipelineGraph) -> None:
    """Registration-time channel chaining with the source count unknown:
    propagate the symbolic source count, constraining it at the first op
    that demands a concrete one (make_pipeline_ops' rule, lifted to the
    DAG). A contradiction between two branches is a spec bug, caught
    here with the closed `channel-mismatch` code, not at request time."""
    from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError

    source_ch: list[int] = [0]  # 0 = unconstrained

    def resolve(v: int | str) -> int:
        return source_ch[0] if v == "S" else int(v)

    ch: dict[str, int | str] = {g.source_id: "S"}
    for n in g.nodes:
        if isinstance(n, OpNode):
            want = n.op.in_channels
            got = ch[n.input]
            if want:
                if got == "S" or resolve(got) == 0:
                    if got == "S":
                        if source_ch[0] and source_ch[0] != want:
                            raise SpecError(
                                "channel-mismatch",
                                f"node {n.id!r} needs a {want}-channel "
                                f"source but another branch fixed it at "
                                f"{source_ch[0]}",
                            )
                        source_ch[0] = want
                elif resolve(got) != want:
                    raise SpecError(
                        "channel-mismatch",
                        f"node {n.id!r}: op {n.op.name!r} expects "
                        f"{want} channels but its input produces "
                        f"{resolve(got)}",
                    )
            ch[n.id] = n.op.out_channels or got
        elif isinstance(n, MergeNode):
            a, b = (ch[i] for i in n.inputs)
            ra = source_ch[0] if a == "S" else int(a)
            rb = source_ch[0] if b == "S" else int(b)
            if ra and rb and ra != rb:
                raise SpecError(
                    "channel-mismatch",
                    f"merge {n.id!r} joins a {ra}-channel branch with a "
                    f"{rb}-channel branch",
                )
            ch[n.id] = a if (a == b or not rb) else b


def dag_fingerprint(g: PipelineGraph) -> str:
    """Stable identity of the DAG's execution structure. Degenerate
    linear chains fingerprint as the chain itself (pipeline_fingerprint)
    so every existing calibration/serve-cache key carries over; real
    DAGs hash their topology + combinator params + outputs."""
    chain = g.as_linear_chain()
    if chain is not None:
        return pipeline_fingerprint(chain)
    parts = []
    for n in g.nodes:
        if isinstance(n, SourceNode):
            parts.append(f"src:{n.id}")
        elif isinstance(n, OpNode):
            parts.append(
                f"op:{n.id}<{n.input}:{n.op.name}/{op_family(n.op)}"
                f"/h{n.op.halo}"
            )
        else:
            parts.append(
                f"mg:{n.id}<{n.inputs[0]},{n.inputs[1]}:{n.combinator}"
                f"/k{n.alpha_k}"
            )
    parts.append(
        "out:" + ",".join(f"{k}={v}" for k, v in sorted(g.outputs.items()))
    )
    key = "|".join(parts)
    return "dag-" + hashlib.sha256(key.encode()).hexdigest()[:16]
