"""Versioned JSON pipeline-spec schema + the closed error taxonomy. The
counterpart of the JAX package's ``graph/spec.py`` (no jax in it: the
port keeps its own copy, with the same taxonomy codes, letter for letter,
so that a client switches on the same codes against either package).

A pipeline spec is the wire form of a `PipelineGraph` (graph/ir.py):

    {
      "version": 1,
      "name": "unsharp",                       # optional, display only
      "nodes": [
        {"id": "src",  "kind": "source"},
        {"id": "blur", "kind": "op", "op": "gaussian:5", "input": "src"},
        {"id": "mask", "kind": "merge", "merge": "subtract",
         "inputs": ["src", "blur"]}
      ],
      "outputs": {"image": "mask", "histogram": "mask", "stats": "mask"}
    }

  * exactly one `source` node (the request image);
  * `op` nodes name an `ops/registry` spec string (``name[:arg]``) and one
    input; fan-out taps are implicit (any node with >1 consumer);
  * `merge` nodes join exactly two branches with a combinator from
    `graph/ir.MERGE_COMBINATORS` (``alpha_composite`` takes an ``alpha``
    in [0, 1], quantized to k/256 so the arithmetic stays exact; see
    ir.py);
  * `outputs` maps output names (``image`` required; ``histogram`` /
    ``stats`` optional side outputs computed in the SAME dispatch) to
    node ids.

**The closed error taxonomy.** Every way a spec (or a graph request) can
be refused has a code in `TAXONOMY`, and every rejection path raises
`SpecError(code, message)` with a literal code. The HTTP layer maps
SpecError onto 4xx-class structured JSON ({code, error, trace_id}); a
hostile or malformed spec can therefore never surface as a 500
(tests/test_torch_graph.py fuzzes this).
"""

from __future__ import annotations

import json
import re

from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

SPEC_VERSION = 1

ENV_MAX_NODES = "MCIM_GRAPH_MAX_NODES"

# code -> one-line meaning. CLOSED vocabulary: a rejection path may only
# name a code registered here, so clients can switch on codes without
# chasing free-form text.
TAXONOMY = {
    # -- spec shape ---------------------------------------------------------
    "bad-json": "the body is not valid JSON",
    "bad-root": "the spec root is not a JSON object",
    "bad-version": "missing/unsupported `version` (this server speaks 1)",
    "unknown-field": "an object carries a field the schema does not define",
    "bad-name": "`name` is not a short string",
    "bad-nodes": "`nodes` is not a non-empty list of objects",
    "too-large": "node count exceeds MCIM_GRAPH_MAX_NODES",
    # -- nodes --------------------------------------------------------------
    "bad-node-id": "a node id is not a short [A-Za-z0-9_-] string",
    "duplicate-node": "two nodes share one id",
    "unknown-kind": "node `kind` is not source/op/merge",
    "no-source": "the graph has no source node",
    "multi-source": "the graph has more than one source node",
    "unknown-op": "`op` names nothing in ops/registry",
    "bad-op-arg": "the op factory rejected its argument",
    "unservable-op": "the op cannot run in a graph (shape-changing)",
    "unknown-merge": "`merge` is not a registered combinator",
    "bad-merge-arity": "`inputs` is not a list of exactly two node ids",
    "bad-merge-arg": "the merge parameter (e.g. alpha) is out of range",
    # -- wiring -------------------------------------------------------------
    "unknown-input": "a node/output references an id that does not exist",
    "graph-cycle": "the node references are not acyclic",
    "dangling-node": "a node feeds no output (dead subgraph)",
    "channel-mismatch": "channel counts cannot chain along an edge/merge",
    "no-output": "`outputs` does not map `image` to a node",
    "unknown-output": "`outputs` names an output kind the service lacks",
    # -- registration / request admission (graph/service.py) ---------------
    "unknown-tenant": "the tenant id has never registered here",
    "unknown-pipeline": "the pipeline id is not registered for this tenant",
    "bad-tenant-id": "the tenant id is not a short [A-Za-z0-9_-] string",
    "tenant-limit": "the tenant registry is at MCIM_GRAPH_MAX_TENANTS",
    "bad-qos": "the QoS class is not a registered admission class",
    "bad-quota": "a quota field is not a non-negative number",
    "bad-image": "the request image cannot feed this graph",
    "unknown-route": "no handler at this path",
}

OUTPUT_KINDS = ("image", "histogram", "stats")

_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")

_NODE_FIELDS = {
    "source": {"id", "kind"},
    "op": {"id", "kind", "op", "input"},
    "merge": {"id", "kind", "merge", "inputs", "alpha"},
}


class SpecError(ValueError):
    """A spec/request rejection with a closed-taxonomy code. The HTTP
    layer maps it onto 4xx structured JSON, never a 500."""

    def __init__(self, code: str, message: str):
        if code not in TAXONOMY:  # pragma: no cover - taxonomy bug
            raise KeyError(
                f"SpecError code {code!r} is not in graph.spec.TAXONOMY"
            )
        super().__init__(message)
        self.code = code


def max_nodes() -> int:
    return int(env_registry.get(ENV_MAX_NODES))


def parse_spec(raw):
    """bytes/str/dict -> validated `PipelineGraph` (graph/ir.py). Every
    refusal is a SpecError with a TAXONOMY code; anything else escaping
    this function is a bug (the fuzz test asserts it cannot happen)."""
    from mpi_cuda_imagemanipulation_tpu_torch.graph import ir

    if isinstance(raw, (bytes, bytearray, memoryview)):
        try:
            raw = bytes(raw).decode("utf-8")
        except UnicodeDecodeError as e:
            raise SpecError("bad-json", f"body is not UTF-8: {e}") from None
    if isinstance(raw, str):
        try:
            raw = json.loads(raw)
        except ValueError as e:
            raise SpecError("bad-json", f"body is not JSON: {e}") from None
    if not isinstance(raw, dict):
        raise SpecError(
            "bad-root", f"spec root must be an object, got {type(raw).__name__}"
        )
    unknown = set(raw) - {"version", "name", "nodes", "outputs"}
    if unknown:
        raise SpecError(
            "unknown-field", f"unknown spec fields {sorted(unknown)}"
        )
    if raw.get("version") != SPEC_VERSION:
        raise SpecError(
            "bad-version",
            f"spec version must be {SPEC_VERSION}, got {raw.get('version')!r}",
        )
    name = raw.get("name", "")
    if not isinstance(name, str) or len(name) > 128:
        raise SpecError("bad-name", "`name` must be a short string")

    nodes_raw = raw.get("nodes")
    if not isinstance(nodes_raw, list) or not nodes_raw:
        raise SpecError("bad-nodes", "`nodes` must be a non-empty list")
    cap = max_nodes()
    if len(nodes_raw) > cap:
        raise SpecError(
            "too-large", f"{len(nodes_raw)} nodes exceed the cap of {cap}"
        )

    nodes: dict[str, object] = {}
    for nd in nodes_raw:
        nodes.update(_parse_node(nd, nodes))
    source_ids = [
        nid for nid, n in nodes.items() if isinstance(n, ir.SourceNode)
    ]
    if not source_ids:
        raise SpecError("no-source", "the graph declares no source node")
    if len(source_ids) > 1:
        raise SpecError(
            "multi-source", f"multiple source nodes {sorted(source_ids)}"
        )

    outputs = _parse_outputs(raw.get("outputs"), nodes)
    return ir.build_graph(
        name=name, nodes=nodes, source_id=source_ids[0], outputs=outputs
    )


def _parse_node(nd, seen: dict) -> dict:
    from mpi_cuda_imagemanipulation_tpu_torch.graph import ir
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (
        REGISTRY,
        make_op,
        op_family,
    )

    if not isinstance(nd, dict):
        raise SpecError(
            "bad-nodes", f"node entries must be objects, got {type(nd).__name__}"
        )
    nid = nd.get("id")
    if not isinstance(nid, str) or not _ID_RE.match(nid):
        raise SpecError("bad-node-id", f"bad node id {nid!r}")
    if nid in seen:
        raise SpecError("duplicate-node", f"duplicate node id {nid!r}")
    kind = nd.get("kind")
    if not isinstance(kind, str) or kind not in _NODE_FIELDS:
        raise SpecError(
            "unknown-kind",
            f"node {nid!r}: kind must be source/op/merge, got {kind!r}",
        )
    unknown = set(nd) - _NODE_FIELDS[kind]
    if unknown:
        raise SpecError(
            "unknown-field", f"node {nid!r} has unknown fields {sorted(unknown)}"
        )
    if kind == "source":
        return {nid: ir.SourceNode(id=nid)}
    if kind == "op":
        spec_str = nd.get("op")
        if not isinstance(spec_str, str) or not spec_str:
            raise SpecError(
                "unknown-op", f"node {nid!r}: `op` must be a spec string"
            )
        op_name = spec_str.partition(":")[0].strip().lower()
        if op_name not in REGISTRY:
            raise SpecError(
                "unknown-op", f"node {nid!r}: unknown op {op_name!r}"
            )
        try:
            op = make_op(spec_str)
        except SpecError:
            raise
        except Exception as e:
            # the registry factory refused the argument (ValueError for
            # every documented misuse; anything else is still the same
            # client error class: a bad argument, not a server fault)
            raise SpecError(
                "bad-op-arg", f"node {nid!r}: {type(e).__name__}: {e}"
            ) from None
        if op_family(op) == "geometric":
            raise SpecError(
                "unservable-op",
                f"node {nid!r}: geometric op {op.name!r} changes the image "
                "shape; graphs serve shape-preserving ops only",
            )
        inp = nd.get("input")
        if not isinstance(inp, str) or not inp:
            raise SpecError(
                "unknown-input", f"node {nid!r}: `input` must be a node id"
            )
        return {nid: ir.OpNode(id=nid, op=op, input=inp)}
    # merge
    comb = nd.get("merge")
    if not isinstance(comb, str) or comb not in ir.MERGE_COMBINATORS:
        raise SpecError(
            "unknown-merge",
            f"node {nid!r}: unknown combinator {comb!r} "
            f"(known: {sorted(ir.MERGE_COMBINATORS)})",
        )
    inputs = nd.get("inputs")
    if (
        not isinstance(inputs, list)
        or len(inputs) != 2
        or not all(isinstance(i, str) for i in inputs)
    ):
        raise SpecError(
            "bad-merge-arity",
            f"node {nid!r}: `inputs` must list exactly two node ids",
        )
    alpha_k = 256  # only read by alpha_composite
    if comb == "alpha_composite":
        alpha = nd.get("alpha", 0.5)
        if not isinstance(alpha, (int, float)) or not 0.0 <= alpha <= 1.0:
            raise SpecError(
                "bad-merge-arg",
                f"node {nid!r}: alpha must be a number in [0, 1], "
                f"got {alpha!r}",
            )
        # quantize to k/256 so the merge arithmetic is an exact integer
        # multiply-add + one power-of-two scale (graph/ir.py): deterministic
        # on every device, immune to fma contraction
        alpha_k = int(round(float(alpha) * 256.0))
    elif "alpha" in nd:
        raise SpecError(
            "bad-merge-arg",
            f"node {nid!r}: `alpha` only applies to alpha_composite",
        )
    return {
        nid: ir.MergeNode(
            id=nid, combinator=comb, inputs=(inputs[0], inputs[1]),
            alpha_k=alpha_k,
        )
    }


def _parse_outputs(raw, nodes: dict) -> dict[str, str]:
    if raw is None:
        raise SpecError("no-output", "`outputs` must map `image` to a node")
    if not isinstance(raw, dict):
        raise SpecError("no-output", "`outputs` must be an object")
    out: dict[str, str] = {}
    for kind, nid in raw.items():
        if kind not in OUTPUT_KINDS:
            raise SpecError(
                "unknown-output",
                f"unknown output kind {kind!r} (known: {OUTPUT_KINDS})",
            )
        if not isinstance(nid, str) or nid not in nodes:
            raise SpecError(
                "unknown-input", f"output {kind!r} references unknown node "
                f"{nid!r}"
            )
        out[kind] = nid
    if "image" not in out:
        raise SpecError("no-output", "`outputs` must include `image`")
    return out


def chain_as_spec(ops_spec: str, *, name: str = "") -> dict:
    """Render a CLI chain string (``grayscale,contrast:3.5,...``) as its
    degenerate linear-DAG spec dict: the bridge the byte-equality checks
    and the loadgen lanes use to drive the SAME workload down both paths."""
    nodes = [{"id": "src", "kind": "source"}]
    prev = "src"
    for i, tok in enumerate(s for s in ops_spec.split(",") if s.strip()):
        nid = f"n{i}"
        nodes.append(
            {"id": nid, "kind": "op", "op": tok.strip(), "input": prev}
        )
        prev = nid
    return {
        "version": SPEC_VERSION,
        "name": name or ops_spec,
        "nodes": nodes,
        "outputs": {"image": prev},
    }
