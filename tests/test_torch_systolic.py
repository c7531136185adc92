"""Systolic execution in the port on the CPU (graph/compile.py's placement
pass and subrange executors, graph/systolic.py's wire frames,
parallel/systolic.py's stage-mesh runner): the twins of the JAX package's
tests/test_systolic.py, each held to the JAX package's bytes.

The contracts: stage placement cuts only at materialization boundaries,
covers every step contiguously in topological order and so respects merge
barriers; the canonical split form (`plan='off'` + split_for_placement) is
byte-exact against the unsplit program, and the placements equal the JAX
package's; chaining per-range subrange executors over the handoff frame is
byte-exact against the JAX package's graph_callable; the stage-mesh
runner on 2 and 4 CPU slots (and over two gloo ranks) is byte-equal to
the JAX package's `plan_callable`, and its counters, counted from the
copies that ran, show one exchange per stage boundary (the JAX package
counts collective-permutes in its HLO; the port has no HLO).
"""

import hashlib
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu import graph as jgraph
from mpi_cuda_imagemanipulation_tpu.graph import compile as jcompile
from mpi_cuda_imagemanipulation_tpu.ops.registry import make_pipeline_ops as jax_ops
from mpi_cuda_imagemanipulation_tpu.parallel import systolic as jsystolic
from mpi_cuda_imagemanipulation_tpu.plan.exec import plan_callable as jax_plan_callable
from mpi_cuda_imagemanipulation_tpu.plan.planner import build_plan as jax_build_plan
from mpi_cuda_imagemanipulation_tpu_torch.graph import compile_graph, graph_callable, parse_spec
from mpi_cuda_imagemanipulation_tpu_torch.graph.compile import (
    MergeStep,
    graph_sub_callable,
    live_keys_at,
    partition_weights,
    place_steps,
    split_for_placement,
)
from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError
from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import (
    FALLBACK_REASONS,
    count_fallback,
    decode_handoff,
    encode_handoff,
)
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.parallel import systolic
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import build_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")

CHAIN = "invert,gaussian:3,sharpen,box:3,quantize:6,gaussian:5,posterize:4,median"
SYSTOLIC_CHAIN = "invert,gaussian:3,sharpen,box:3,quantize:6,median"


def chain_spec(ops: str, outputs=None):
    names = ops.split(",")
    nodes = [{"id": "src", "kind": "source"}]
    for i, op in enumerate(names):
        nodes.append({"id": f"n{i}", "kind": "op", "op": op,
                      "input": f"n{i - 1}" if i else "src"})
    return {"version": 1, "name": "chain", "nodes": nodes,
            "outputs": outputs or {"image": f"n{len(names) - 1}"}}


# a wide DAG: fan-out 3 from a shared prefix, nested merges, and a side
# (histogram) output hanging off an interior branch
WIDE_SPEC = {
    "version": 1,
    "name": "wide",
    "nodes": [
        {"id": "src", "kind": "source"},
        {"id": "pre", "kind": "op", "op": "gaussian:3", "input": "src"},
        {"id": "a", "kind": "op", "op": "quantize:6", "input": "pre"},
        {"id": "b", "kind": "op", "op": "invert", "input": "pre"},
        {"id": "c", "kind": "op", "op": "sharpen", "input": "pre"},
        {"id": "m1", "kind": "merge", "merge": "blend", "inputs": ["a", "b"]},
        {"id": "m2", "kind": "merge", "merge": "subtract", "inputs": ["m1", "c"]},
        {"id": "post", "kind": "op", "op": "box:3", "input": "m2"},
    ],
    "outputs": {"image": "post", "histogram": "m2"},
}


def canonical(spec):
    return split_for_placement(compile_graph(parse_spec(spec), plan="off", device="cpu"))


def jax_canonical(spec):
    return jcompile.split_for_placement(jgraph.compile_graph(jgraph.parse_spec(spec), plan="off"))


def _jax_graph(spec, img):
    fn = jax.jit(jgraph.graph_callable(jgraph.compile_graph(jgraph.parse_spec(spec))))
    return jax.tree_util.tree_map(np.asarray, fn(img))


def run_placed(program, placement, img):
    """Chain every range's subrange executor through the wire codec: the
    whole cross-replica story minus the sockets."""
    env = {program.graph.source_id: np.asarray(img)}
    for k, (lo, hi) in enumerate(placement.ranges):
        out = graph_sub_callable(program, lo, hi)(
            {key: torch.from_numpy(np.array(v)) for key, v in env.items()})
        if k == len(placement.ranges) - 1:
            return out
        # round-trip the live env through the handoff frame, as the HTTP
        # hop does
        _meta, env = decode_handoff(encode_handoff(
            {"idx": k + 1}, {key: v.numpy() for key, v in out.items()}))
    raise AssertionError("unreachable")


# --------------------------------------------------------------------------
# partition_weights: the balancer DP
# --------------------------------------------------------------------------


def test_partition_weights_contiguous_cover_and_balance():
    assert partition_weights([1.0] * 8, 2) == ((0, 4), (4, 8))
    assert partition_weights([100.0, 1.0, 1.0, 1.0], 2) == ((0, 1), (1, 4))
    rng = np.random.default_rng(3)
    for n in (2, 3, 5):
        w = list(rng.uniform(0.5, 10.0, size=9))
        ranges = partition_weights(w, n)
        assert ranges == jcompile.partition_weights(w, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == len(w)
        for (alo, ahi), (blo, bhi) in zip(ranges, ranges[1:]):
            assert ahi == blo and ahi > alo and bhi > blo
        if n == 2:  # minimax: no single cut beats the DP's bottleneck
            best = min(max(sum(w[:c]), sum(w[c:])) for c in range(1, len(w)))
            assert max(sum(w[lo:hi]) for lo, hi in ranges) == pytest.approx(best)


def test_partition_weights_rejects_bad_counts():
    for n in (3, 0):
        with pytest.raises(ValueError):
            partition_weights([1.0, 2.0], n)


# --------------------------------------------------------------------------
# split_for_placement: the canonical step form
# --------------------------------------------------------------------------


def test_split_makes_chain_placeable_and_stays_bit_exact():
    spec = chain_spec(CHAIN)
    base = compile_graph(parse_spec(spec), plan="off", device="cpu")
    assert len(base.steps) == 1
    assert place_steps(base, 2) is None
    prog = split_for_placement(base)
    assert len(prog.steps) == len(CHAIN.split(","))
    assert all(len(s.plan.stages) == 1 for s in prog.steps)
    assert prog.steps[-1].dst == base.steps[-1].dst
    assert all("~" in s.dst for s in prog.steps[:-1])
    assert [s.dst for s in prog.steps] == [s.dst for s in jax_canonical(spec).steps]
    img = synthetic_image(61, 43, channels=3, seed=5)
    x = torch.from_numpy(img)
    golden = graph_callable(base)(x)["image"]
    assert torch.equal(graph_callable(prog)(x)["image"], golden)
    np.testing.assert_array_equal(golden.numpy(), _jax_graph(spec, img)["image"])


def test_split_is_idempotent():
    prog = canonical(chain_spec("invert,sharpen,median"))
    assert [s.dst for s in split_for_placement(prog).steps] == [s.dst for s in prog.steps]


# --------------------------------------------------------------------------
# place_steps on wide DAGs: cuts, barriers, shared prefixes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_replicas", [2, 3])
def test_wide_dag_placement_contiguous_and_merge_safe(n_replicas):
    from mpi_cuda_imagemanipulation_tpu.obs.cost import CostLedger as JaxLedger
    from mpi_cuda_imagemanipulation_tpu_torch.obs.cost import CostLedger

    prog = canonical(WIDE_SPEC)
    placement = place_steps(prog, n_replicas, ledger=CostLedger())
    jplace = jcompile.place_steps(jax_canonical(WIDE_SPEC), n_replicas, ledger=JaxLedger())
    assert (placement.ranges, placement.weights, placement.source) == \
        (jplace.ranges, jplace.weights, jplace.source)
    ranges = placement.ranges
    assert ranges[0][0] == 0 and ranges[-1][1] == len(prog.steps)
    for (_alo, ahi), (blo, _bhi) in zip(ranges, ranges[1:]):
        assert ahi == blo
    # merge barrier: every merge input was produced at a SMALLER step index
    produced_at = {prog.graph.source_id: -1}
    for i, step in enumerate(prog.steps):
        produced_at[step.dst] = i
        srcs = list(step.node.inputs) if isinstance(step, MergeStep) else [step.src]
        for src in srcs:
            assert produced_at[src] < i
    for i in range(len(prog.steps)):
        lo, hi = ranges[placement.owner_of(i)]
        assert lo <= i < hi


def test_wide_dag_shared_prefix_once_and_split_bit_exact():
    prog = canonical(WIDE_SPEC)
    assert sum(1 for s in prog.steps if s.dst == "pre") == 1
    img = synthetic_image(40, 36, channels=3, seed=7)
    golden = _jax_graph(WIDE_SPEC, img)
    out = run_placed(prog, place_steps(prog, 2), img)
    np.testing.assert_array_equal(out["~image"].numpy(), golden["image"])
    np.testing.assert_array_equal(out["~histogram"].numpy(), golden["histogram"])


def test_chain_placement_bit_exact_across_cuts():
    spec = chain_spec(CHAIN)
    prog = canonical(spec)
    img = synthetic_image(53, 41, channels=3, seed=11)
    golden = _jax_graph(spec, img)["image"]
    for n in (2, 3, 4):
        placement = place_steps(prog, n)
        assert placement is not None and len(placement.ranges) == n
        np.testing.assert_array_equal(run_placed(prog, placement, img)["~image"].numpy(), golden)


def test_live_keys_are_the_minimal_handoff():
    prog = canonical(WIDE_SPEC)
    jprog = jax_canonical(WIDE_SPEC)
    out_ids = set(prog.graph.outputs.values())
    for cut in range(1, len(prog.steps)):
        live = set(live_keys_at(prog, cut))
        assert live == set(jcompile.live_keys_at(jprog, cut))
        produced = {prog.graph.source_id} | {s.dst for s in prog.steps[:cut]}
        needed = set()
        for step in prog.steps[cut:]:
            srcs = list(step.node.inputs) if isinstance(step, MergeStep) else [step.src]
            needed.update(s for s in srcs if s in produced)
        assert live == needed | (out_ids & produced)


def test_subrange_bounds_refused():
    prog = canonical(chain_spec("invert,sharpen"))
    for lo, hi in ((0, 0), (1, 1), (-1, 1), (0, 3)):
        with pytest.raises(ValueError):
            graph_sub_callable(prog, lo, hi)


# --------------------------------------------------------------------------
# the stage-mesh runner: byte-exactness + the copies that ran
# --------------------------------------------------------------------------


def _cpu_mesh(n):
    return systolic.make_stage_mesh(n, devices=["cpu"] * n)


@pytest.mark.parametrize("n,tile_rows", [(2, 32), (4, 24), (2, 24), (4, 32)])
def test_systolic_executor_bit_exact(n, tile_rows):
    h, w = 97, 64
    img = synthetic_image(h, w, channels=3, seed=13)
    golden = np.asarray(jax.jit(jax_plan_callable(
        jax_build_plan(jax_ops(SYSTOLIC_CHAIN), "off")))(img))
    plan = build_plan(make_pipeline_ops(SYSTOLIC_CHAIN), "off")
    build = systolic.systolic_callable(plan, height=h, width=w, tile_rows=tile_rows,
                                       mesh=_cpu_mesh(n))
    out = build.fn(img)
    np.testing.assert_array_equal(out.numpy(), golden)
    # the structure equals the JAX package's build of the same plan
    jbuild = jsystolic.systolic_callable(jax_build_plan(jax_ops(SYSTOLIC_CHAIN), "off"),
                                         height=h, width=w, tile_rows=tile_rows, n_devices=n)
    for field in ("ranges", "n_tiles", "buf_rows", "n_steps", "tiles_forwarded",
                  "exchange_bytes", "n_exchanges"):
        assert getattr(build, field) == getattr(jbuild, field), field
    # the copies that ran: every band crossed every boundary once
    assert build.tiles_forwarded == build.n_tiles * (n - 1)
    assert build.n_steps == build.n_tiles + n - 1
    assert (build.last.tiles_forwarded, build.last.exchange_bytes, build.last.n_exchanges) == \
        (build.tiles_forwarded, build.exchange_bytes, build.n_exchanges)


def test_systolic_one_exchange_per_stage_boundary():
    """With one tile in flight the wavefront runs n_groups - 1 exchange
    rounds, each moving one band: exactly one exchange per stage
    boundary, counted from the copies (a spy on the band copies too)."""
    plan = build_plan(make_pipeline_ops("invert,gaussian:3,sharpen,box:3"), "off")
    n, h, w = 4, 40, 32
    build = systolic.systolic_callable(plan, height=h, width=w, tile_rows=h, mesh=_cpu_mesh(n))
    assert build.n_tiles == 1 and build.n_steps == n
    img = synthetic_image(h, w, channels=3, seed=17)
    copies = []
    real_to = torch.Tensor.to

    def spy(self, *args, **kw):
        if kw.get("copy"):
            copies.append(tuple(self.shape))
        return real_to(self, *args, **kw)

    torch.Tensor.to = spy
    try:
        build.fn(img)
    finally:
        torch.Tensor.to = real_to
    assert copies == [(build.buf_rows, w, 3)] * (n - 1)
    assert build.last.n_exchanges == build.last.tiles_forwarded == n - 1


def test_systolic_eligibility_reasons():
    assert systolic.ELIGIBILITY_REASONS == jsystolic.ELIGIBILITY_REASONS
    cases = [("invert,gaussian:3,sharpen", 32, None),
             ("grayscale,gaussian:3", 32, "channel-changing"),
             ("invert", 32, "too-few-stages"),
             ("gaussian:5,gaussian:5,gaussian:5", 2, "halo-exceeds-tile"),
             ("invert,equalize", 32, "not-streamable")]
    for ops, tile_rows, want in cases:
        assert systolic.systolic_eligible(make_pipeline_ops(ops), tile_rows=tile_rows) == want
        assert jsystolic.systolic_eligible(jax_ops(ops), tile_rows=tile_rows) == want
    assert systolic.systolic_eligible(make_pipeline_ops("invert,gaussian:3"), channels=1,
                                      tile_rows=8) is None


def test_stage_mesh_slots_and_refusals():
    if not torch.cuda.is_available():  # the default is every visible card
        with pytest.raises(RuntimeError, match="cuda"):
            systolic.make_stage_mesh(2)
    mesh = _cpu_mesh(3)
    assert mesh.shape == {"stage": 3} and mesh.axis_names == ("stage",)
    assert mesh.local_slots == (0, 1, 2) and not mesh.distributed
    with pytest.raises(ValueError):
        systolic.make_stage_mesh(1, devices=["cpu"])
    with pytest.raises(ValueError):  # more slots than the devices given
        systolic.make_stage_mesh(3, devices=["cpu"] * 2)
    plan = build_plan(make_pipeline_ops("invert,sharpen"), "off")
    with pytest.raises(ValueError):  # more slots than stages
        systolic.systolic_callable(plan, height=20, width=20, tile_rows=8, mesh=_cpu_mesh(3))


def test_stage_weights_feed_measured_ledger():
    from mpi_cuda_imagemanipulation_tpu_torch.obs.cost import CostLedger, CostRecord

    plan = build_plan(make_pipeline_ops("invert,sharpen"), "off")
    led = CostLedger()
    assert systolic.stage_weights(plan, ledger=led) == [6.0, 6.0]  # u8 read + write, 3 ch
    led.record("plan", plan.fingerprint,
               CostRecord(arg_bytes=3e6, out_bytes=1e6, alias_bytes=0.0, temp_bytes=0.0),
               modeled_bytes=2e6, stage="s1/" + plan.stages[1].kind)
    w = systolic.stage_weights(plan, ledger=led)
    assert w[0] == 6.0 and w[1] == pytest.approx(12.0)  # drift ratio 2x


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_systolic_match_the_jax_package():
    """The runner over a stage mesh of one and of two slots per rank on
    two gloo ranks (tests/_torch_mp_worker.py systolic): bands sent
    between ranks, the counters summed over ranks equal to the build's,
    and the bytes rank 0 ends with equal the JAX package's plan_callable
    (by SHA-256)."""
    sys.path.insert(0, os.path.dirname(WORKER))
    try:
        import _torch_mp_worker as worker
    finally:
        sys.path.pop(0)
    h, w = worker.SYSTOLIC_SHAPE
    img = synthetic_image(h, w, channels=3, seed=13)
    want = np.asarray(jax.jit(jax_plan_callable(
        jax_build_plan(jax_ops(worker.SYSTOLIC_SPEC), "off")))(img))
    want_sha = hashlib.sha256(want.tobytes()).hexdigest()
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", OMP_NUM_THREADS="2")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen([sys.executable, WORKER, "systolic"], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank}: {out}\n{err[-2000:]}"
    shas = [line.split() for line in outs[0][1].splitlines()
            if line.startswith("TORCH_MULTIPROC_SHA")]
    assert [(s[2], s[3]) for s in shas] == [("2", "32"), ("4", "24")]
    assert all(s[4] == want_sha for s in shas)
    assert "TORCH_MULTIPROC_OK systolic" in outs[0][1]
    assert "TORCH_MULTIPROC" not in outs[1][1]


# --------------------------------------------------------------------------
# wire formats + closed fallback vocabulary
# --------------------------------------------------------------------------


def test_handoff_round_trip_bit_exact():
    rng = np.random.default_rng(19)
    env = {"src": rng.integers(0, 256, (31, 17, 3), dtype=np.uint8),
           "n2~1": rng.integers(0, 256, (31, 17), dtype=np.uint8)}
    meta, got = decode_handoff(encode_handoff({"idx": 1, "trace_id": "t"}, env))
    assert meta == {"idx": 1, "trace_id": "t"} and set(got) == set(env)
    for k in env:
        assert got[k].dtype == env[k].dtype and np.array_equal(got[k], env[k])


def test_fallback_vocabulary_is_closed():
    class FakeCounter:
        def __init__(self):
            self.seen = []

        def inc(self, n=1, **labels):
            self.seen.append(labels)

    c = FakeCounter()
    for reason in FALLBACK_REASONS:
        count_fallback(c, reason)
    assert [d["reason"] for d in c.seen] == list(FALLBACK_REASONS)
    with pytest.raises(ValueError):
        count_fallback(c, "cosmic-rays")


def test_run_segment_split_ids_cannot_collide_with_spec_ids():
    bad = chain_spec("invert,sharpen")
    bad["nodes"][1]["id"] = "n0~1"
    bad["nodes"][2]["input"] = "n0~1"
    with pytest.raises(SpecError):
        parse_spec(bad)
