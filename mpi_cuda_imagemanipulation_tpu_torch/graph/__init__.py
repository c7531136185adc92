"""Pipelines as data: the DAG op-graph IR and the pipeline service. The
counterpart of the JAX package's ``graph/``.

`graph/` generalizes the execution model from "one op chain baked into
the CLI" to "a pipeline *service*": clients POST a versioned JSON pipeline
spec (graph/spec.py) describing a DAG of ops (branch taps, merge
combinators blend / alpha_composite / subtract, side outputs image +
histogram + stats in one dispatch), validated against `ops/registry`
under a CLOSED error taxonomy (malformed specs are always 4xx-class,
never 500), compiled into fused linear segments by the same stage rules
`plan/` uses on chains (graph/compile.py), and served per tenant with
quota + QoS admission and bounded function-cache namespaces
(graph/tenancy.py, graph/service.py). graph/systolic.py is the wire
protocol of replica-to-replica stage handoffs.

The byte-exactness contract holds everywhere: a DAG that happens to be a
linear chain produces output byte-identical to the chain path (its
`dag_fingerprint` IS that chain's `pipeline_fingerprint`, so calibration
and cache keys carry over unchanged), every merge combinator has golden
semantics in ops/spec.py's style, and every output equals the JAX
package's on the same spec and image.
"""

from mpi_cuda_imagemanipulation_tpu_torch.graph.compile import (
    GraphProgram,
    compile_graph,
    graph_callable,
)
from mpi_cuda_imagemanipulation_tpu_torch.graph.ir import (
    MERGE_COMBINATORS,
    PipelineGraph,
    dag_fingerprint,
)
from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import (
    SPEC_VERSION,
    TAXONOMY,
    SpecError,
    parse_spec,
)

__all__ = [
    "MERGE_COMBINATORS",
    "SPEC_VERSION",
    "TAXONOMY",
    "GraphProgram",
    "PipelineGraph",
    "SpecError",
    "compile_graph",
    "dag_fingerprint",
    "graph_callable",
    "parse_spec",
]
