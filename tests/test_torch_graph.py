"""The port's pipeline graphs (graph/spec.py, ir.py, compile.py,
tenancy.py, service.py) on the CPU against the JAX package: the twins of
the JAX package's tests/test_graph.py (its fabric and analysis cases
aside), each held to the JAX package on the same seeded images.

The contracts: hostile or malformed specs refuse with the JAX package's
closed-taxonomy code (never another exception); pipeline ids are the JAX
package's `dag_fingerprint`, and a linear DAG's id is the chain's
`pipeline_fingerprint`; every image, histogram and stats value of the
port's `graph_callable` is byte-equal to the JAX package's under
``jax.jit`` (a stats mean whose sum passes 2^24 included); merges follow
their golden formulas; a shared prefix is one step; the service's quota
windows, QoS ladder, cache namespaces and failpoint behave as the JAX
package's; the stacked group-lane function equals four solo calls.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu import graph as jgraph
from mpi_cuda_imagemanipulation_tpu.graph import spec as jspec
from mpi_cuda_imagemanipulation_tpu.graph import tenancy as jtenancy
from mpi_cuda_imagemanipulation_tpu.graph.service import GraphService as JaxGraphService
from mpi_cuda_imagemanipulation_tpu_torch.graph import (
    TAXONOMY,
    compile_graph,
    dag_fingerprint,
    graph_callable,
    parse_spec,
)
from mpi_cuda_imagemanipulation_tpu_torch.graph import spec as tspec
from mpi_cuda_imagemanipulation_tpu_torch.graph.compile import GRAPH_IMPLS, _sum256_f32
from mpi_cuda_imagemanipulation_tpu_torch.graph.service import GraphService
from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import SpecError, chain_as_spec
from mpi_cuda_imagemanipulation_tpu_torch.graph.tenancy import (
    GraphShed,
    TenantConfig,
    TenantRegistry,
    qos_admit_frac,
)
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import pipeline_fingerprint
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

UNSHARP_SPEC = {
    "version": 1,
    "name": "unsharp",
    "nodes": [
        {"id": "src", "kind": "source"},
        {"id": "g", "kind": "op", "op": "grayscale", "input": "src"},
        {"id": "blur", "kind": "op", "op": "gaussian:5", "input": "g"},
        {"id": "mask", "kind": "merge", "merge": "subtract", "inputs": ["g", "blur"]},
    ],
    "outputs": {"image": "mask", "histogram": "mask", "stats": "mask"},
}

# a bright blend: its outputs sit near 240, so the stats sum of hist * bins
# passes 2^24 from about 70,000 pixels on (the 300x200 and 400x300 cases)
BRIGHT_SPEC = {
    "version": 1,
    "name": "bright",
    "nodes": [
        {"id": "src", "kind": "source"},
        {"id": "hi", "kind": "op", "op": "brightness:200", "input": "src"},
        {"id": "inv", "kind": "op", "op": "invert", "input": "src"},
        {"id": "m", "kind": "merge", "merge": "alpha_composite", "alpha": 0.9,
         "inputs": ["hi", "inv"]},
        {"id": "post", "kind": "op", "op": "gaussian:3", "input": "m"},
    ],
    "outputs": {"image": "post", "histogram": "hi", "stats": "post"},
}

SHARED_PREFIX_SPEC = {
    "version": 1,
    "nodes": [
        {"id": "src", "kind": "source"},
        {"id": "pre", "kind": "op", "op": "gaussian:3", "input": "src"},
        {"id": "a", "kind": "op", "op": "contrast:3.5", "input": "pre"},
        {"id": "b", "kind": "op", "op": "invert", "input": "pre"},
        {"id": "m", "kind": "merge", "merge": "blend", "inputs": ["a", "b"]},
    ],
    "outputs": {"image": "m"},
}

_JIT: dict = {}


def _jax_out(spec, img, **compile_kw):
    """The JAX package's graph_callable under jax.jit, outputs as numpy."""
    prog = jgraph.compile_graph(jgraph.parse_spec(spec), **compile_kw)
    key = (prog.fingerprint, img.shape)
    fn = _JIT.get(key)
    if fn is None:
        fn = _JIT[key] = jax.jit(jgraph.graph_callable(prog))
    return jax.tree_util.tree_map(np.asarray, fn(img))


def _port_out(spec, img, *, impl="torch", **compile_kw):
    prog = compile_graph(parse_spec(spec), backend=impl, device="cpu", **compile_kw)
    return graph_callable(prog, impl=impl)(torch.from_numpy(img))


def _assert_outputs_equal(port: dict, jax_out: dict) -> None:
    """Image, histogram and every stats value byte-equal, dtypes too."""
    assert set(port) == set(jax_out)
    for k in ("image", "histogram"):
        if k in jax_out:
            got = port[k].numpy()
            assert got.dtype == jax_out[k].dtype, k
            np.testing.assert_array_equal(got, jax_out[k], err_msg=k)
    if "stats" in jax_out:
        for k, want in jax_out["stats"].items():
            got = port["stats"][k].numpy()
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (k, got, want)


# --------------------------------------------------------------------------
# spec schema + closed taxonomy
# --------------------------------------------------------------------------


def test_parse_unsharp_spec_structure():
    g = parse_spec(UNSHARP_SPEC)
    assert [n.id for n in g.nodes] == ["src", "g", "blur", "mask"]
    assert g.consumers["g"] == 2  # the implicit fan-out tap
    assert g.outputs == {"image": "mask", "histogram": "mask", "stats": "mask"}
    assert g.as_linear_chain() is None
    prog = compile_graph(g, device="cpu")
    assert prog.n_segments == 2 and prog.n_merges == 1
    assert g.describe() == jgraph.parse_spec(UNSHARP_SPEC).describe()


def test_taxonomy_and_schema_are_the_jax_package_s():
    assert TAXONOMY == jspec.TAXONOMY
    assert tspec.OUTPUT_KINDS == jspec.OUTPUT_KINDS
    assert tspec._ID_RE.pattern == jspec._ID_RE.pattern
    assert tspec._NODE_FIELDS == jspec._NODE_FIELDS
    assert tspec.SPEC_VERSION == jspec.SPEC_VERSION
    assert tspec.max_nodes() == jspec.max_nodes()
    for ops in ("grayscale,contrast:3.5,emboss:3", "invert", " gaussian:5 , sharpen "):
        assert chain_as_spec(ops) == jspec.chain_as_spec(ops)
        assert chain_as_spec(ops, name="n") == jspec.chain_as_spec(ops, name="n")


_MALFORMED = [
    (b"\xff\xfe not json", "bad-json"),
    (b"[1, 2]", "bad-root"),
    ({"version": 99, "nodes": [], "outputs": {}}, "bad-version"),
    ({"version": 1, "nodes": [], "outputs": {}}, "bad-nodes"),
    ({"version": 1, "bogus": 1, "nodes": [], "outputs": {}}, "unknown-field"),
    ({"version": 1, "name": ["x"], "nodes": [], "outputs": {}}, "bad-name"),
    ({"version": 1, "nodes": [{"id": "s!", "kind": "source"}], "outputs": {}}, "bad-node-id"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"}, {"id": "s", "kind": "source"}],
      "outputs": {}}, "duplicate-node"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "wat"}], "outputs": {}}, "unknown-kind"),
    ({"version": 1, "nodes": [{"id": "a", "kind": "op", "op": "invert", "input": "a"}],
      "outputs": {"image": "a"}}, "no-source"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"}, {"id": "t", "kind": "source"}],
      "outputs": {"image": "s"}}, "multi-source"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "x", "kind": "op", "op": "zzz", "input": "s"}],
      "outputs": {"image": "x"}}, "unknown-op"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "x", "kind": "op", "op": "gaussian:999", "input": "s"}],
      "outputs": {"image": "x"}}, "bad-op-arg"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "x", "kind": "op", "op": "rot90", "input": "s"}],
      "outputs": {"image": "x"}}, "unservable-op"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "m", "kind": "merge", "merge": "xor",
                               "inputs": ["s", "s"]}],
      "outputs": {"image": "m"}}, "unknown-merge"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "m", "kind": "merge", "merge": "blend", "inputs": ["s"]}],
      "outputs": {"image": "m"}}, "bad-merge-arity"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "m", "kind": "merge", "merge": "alpha_composite",
                               "inputs": ["s", "s"], "alpha": 7}],
      "outputs": {"image": "m"}}, "bad-merge-arg"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "m", "kind": "merge", "merge": "blend",
                               "inputs": ["s", "s"], "alpha": 0.5}],
      "outputs": {"image": "m"}}, "bad-merge-arg"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "x", "kind": "op", "op": "invert", "input": "ghost"}],
      "outputs": {"image": "x"}}, "unknown-input"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "a", "kind": "op", "op": "invert", "input": "b"},
                              {"id": "b", "kind": "op", "op": "invert", "input": "a"}],
      "outputs": {"image": "b"}}, "graph-cycle"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "a", "kind": "op", "op": "invert", "input": "s"},
                              {"id": "b", "kind": "op", "op": "invert", "input": "s"}],
      "outputs": {"image": "a"}}, "dangling-node"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "g", "kind": "op", "op": "grayscale", "input": "s"},
                              {"id": "g2", "kind": "op", "op": "grayscale", "input": "g"}],
      "outputs": {"image": "g2"}}, "channel-mismatch"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"},
                              {"id": "g", "kind": "op", "op": "grayscale", "input": "s"},
                              {"id": "m", "kind": "merge", "merge": "blend",
                               "inputs": ["s", "g"]}],
      "outputs": {"image": "m"}}, "channel-mismatch"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"}], "outputs": {}}, "no-output"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"}], "outputs": None}, "no-output"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"}], "outputs": {"thumbnail": "s"}},
     "unknown-output"),
    ({"version": 1, "nodes": [{"id": "s", "kind": "source"}] + [
        {"id": f"n{i}", "kind": "op", "op": "invert", "input": "s" if i == 0 else f"n{i - 1}"}
        for i in range(200)
    ], "outputs": {"image": "n199"}}, "too-large"),
]


@pytest.mark.parametrize("spec,code", _MALFORMED)
def test_malformed_specs_refuse_with_taxonomy_code(spec, code):
    with pytest.raises(SpecError) as ei:
        parse_spec(spec)
    assert ei.value.code == code
    with pytest.raises(jspec.SpecError) as ej:
        jspec.parse_spec(spec)
    assert ej.value.code == code


def test_spec_fuzz_never_escapes_the_taxonomy():
    """Seeded structural fuzz: random mutations of a valid spec either
    parse in both packages (to one pipeline id) or refuse in both with one
    SpecError code; never any other exception (the no-500 contract at the
    validation layer)."""
    rng = np.random.default_rng(7)
    junk = [None, 0, -1, 3.5, "", "x", [], {}, True, "src", ["src"], {"a": 1}, "gaussian:5",
            1e308]

    def mutate(obj):
        obj = json.loads(json.dumps(obj))  # deep copy
        for _ in range(int(rng.integers(1, 4))):
            roll = rng.integers(6)
            nodes = obj.get("nodes") if isinstance(obj, dict) else None
            if roll == 0 and isinstance(obj, dict) and obj:
                obj.pop(list(obj)[int(rng.integers(len(obj)))], None)
            elif roll == 1 and isinstance(obj, dict):
                obj[str(rng.integers(100))] = junk[int(rng.integers(len(junk)))]
            elif roll == 2 and isinstance(nodes, list) and nodes:
                nodes[int(rng.integers(len(nodes)))] = junk[int(rng.integers(len(junk)))]
            elif roll == 3 and isinstance(nodes, list) and nodes:
                nd = nodes[int(rng.integers(len(nodes)))]
                if isinstance(nd, dict) and nd:
                    key = list(nd)[int(rng.integers(len(nd)))]
                    nd[key] = junk[int(rng.integers(len(junk)))]
            elif roll == 4 and isinstance(obj, dict):
                obj["outputs"] = junk[int(rng.integers(len(junk)))]
            elif roll == 5 and isinstance(nodes, list):
                nodes.append({"id": "dup", "kind": "op", "op": "invert", "input": "src"})
        return obj

    parsed = refused = 0
    for _ in range(300):
        mutated = mutate(UNSHARP_SPEC)
        try:
            g = parse_spec(mutated)
        except SpecError as e:
            assert e.code in TAXONOMY
            with pytest.raises(jspec.SpecError) as ej:
                jspec.parse_spec(mutated)
            assert ej.value.code == e.code
            refused += 1
            continue
        assert dag_fingerprint(g) == jgraph.dag_fingerprint(jgraph.parse_spec(mutated))
        parsed += 1
    assert refused > 50  # the fuzz actually bites
    assert parsed + refused == 300


def test_spec_error_refuses_unregistered_codes():
    with pytest.raises(KeyError):
        SpecError("not-a-real-code", "x")


# --------------------------------------------------------------------------
# fingerprints: pipeline ids are wire identities
# --------------------------------------------------------------------------


def test_linear_dag_fingerprint_is_the_chain_fingerprint():
    ops = "grayscale,contrast:3.5,emboss:3"
    g = parse_spec(chain_as_spec(ops))
    assert g.as_linear_chain() is not None
    assert dag_fingerprint(g) == pipeline_fingerprint(Pipeline.parse(ops).ops)
    assert dag_fingerprint(g) == jgraph.dag_fingerprint(jgraph.parse_spec(chain_as_spec(ops)))
    # a true DAG gets the dag- namespace, never colliding with chains
    assert dag_fingerprint(parse_spec(UNSHARP_SPEC)).startswith("dag-")


def test_dag_fingerprint_sensitive_to_structure():
    a = parse_spec(UNSHARP_SPEC)
    blended = json.loads(json.dumps(UNSHARP_SPEC))
    blended["nodes"][3]["merge"] = "blend"
    b = parse_spec(blended)
    assert dag_fingerprint(a) != dag_fingerprint(b)


@pytest.mark.parametrize("spec", [
    UNSHARP_SPEC, BRIGHT_SPEC, SHARED_PREFIX_SPEC, chain_as_spec("invert,median:3,box:5"),
    chain_as_spec("grayscale,equalize,gaussian:5"),
    {**BRIGHT_SPEC, "nodes": BRIGHT_SPEC["nodes"][:3] + [
        {"id": "m", "kind": "merge", "merge": "alpha_composite", "alpha": 0.3,
         "inputs": ["hi", "inv"]}] + BRIGHT_SPEC["nodes"][4:]},
], ids=["unsharp", "bright", "shared", "chain", "global", "alpha03"])
def test_pipeline_ids_and_programs_equal_the_jax_package_s(spec):
    g = parse_spec(spec)
    jg = jgraph.parse_spec(spec)
    assert dag_fingerprint(g) == jgraph.dag_fingerprint(jg)
    assert g.describe() == jg.describe()
    for mode in ("off", "fused"):
        p = compile_graph(g, plan=mode, device="cpu")
        jp = jgraph.compile_graph(jg, plan=mode)
        assert p.fingerprint == jp.fingerprint and p.describe() == jp.describe()


# --------------------------------------------------------------------------
# byte-exactness: degenerate DAG == chain, merge goldens, the JAX package
# --------------------------------------------------------------------------

# a pool mixing pointwise runs, stencils of several edge modes, and a
# global-stat barrier
_CHAIN_POOL = ("grayscale", "contrast:3.5", "invert", "gaussian:5", "sharpen", "median:3",
               "quantize:6", "emboss:3", "equalize", "solarize:100")


@pytest.mark.parametrize("seed", range(6))
def test_degenerate_dag_bit_identical_to_chain(seed):
    rng = np.random.default_rng(seed)
    names = list(rng.choice(_CHAIN_POOL, size=int(rng.integers(2, 5)), replace=False))
    if "grayscale" in names:  # 3->1 op must come first to chain channels
        names.remove("grayscale")
        names.insert(0, "grayscale")
    if "equalize" in names and "grayscale" not in names:
        names.insert(0, "grayscale")  # global-stat ops are 1-channel
    ops = ",".join(names)
    spec = chain_as_spec(ops)
    img = synthetic_image(39 + seed, 52 + 3 * seed, channels=3, seed=seed)
    golden = Pipeline.parse(ops).jit("torch", device="cpu", plan="off")(
        torch.from_numpy(img)).numpy()
    want = _jax_out(spec, img, plan="off")
    np.testing.assert_array_equal(want["image"], golden)
    for mode in ("off", "fused"):
        out = _port_out(spec, img, plan=mode)
        np.testing.assert_array_equal(out["image"].numpy(), golden)


def _merge_graph(comb: str, **extra) -> dict:
    return {
        "version": 1,
        "nodes": [
            {"id": "src", "kind": "source"},
            {"id": "b", "kind": "op", "op": "invert", "input": "src"},
            {"id": "m", "kind": "merge", "merge": comb, "inputs": ["src", "b"], **extra},
        ],
        "outputs": {"image": "m"},
    }


@pytest.mark.parametrize("channels", [1, 3])
def test_merge_combinator_goldens(channels):
    """Each combinator against its independent numpy formula (subtract =
    clamp(a-b), blend = round-half-even((a+b)/2), alpha_composite =
    round((a*k + b*(256-k))/256) with k = round(alpha*256)) and against
    the JAX package."""
    img = synthetic_image(24, 31, channels=channels, seed=9)
    a = img.astype(np.int64)
    b = (255 - img).astype(np.int64)  # invert of exact u8 is exact

    def rint(x):
        return np.clip(np.rint(x).astype(np.int64), 0, 255).astype(np.uint8)

    expected = {
        "subtract": np.clip(a - b, 0, 255).astype(np.uint8),
        "blend": rint((a + b) / 2.0),
        "alpha_composite": rint((a * 64 + b * 192) / 256.0),
    }
    for comb, want in expected.items():
        extra = {"alpha": 0.25} if comb == "alpha_composite" else {}
        spec = _merge_graph(comb, **extra)
        out = _port_out(spec, img)
        np.testing.assert_array_equal(out["image"].numpy(), want)
        np.testing.assert_array_equal(_jax_out(spec, img)["image"], want)


def test_unsharp_mask_golden():
    img = synthetic_image(41, 57, channels=3, seed=3)
    x = torch.from_numpy(img)
    gray = Pipeline.parse("grayscale").jit("torch", device="cpu")(x).numpy()
    blur = Pipeline.parse("grayscale,gaussian:5").jit("torch", device="cpu")(x).numpy()
    want = np.clip(gray.astype(np.int64) - blur.astype(np.int64), 0, 255).astype(np.uint8)
    out = _port_out(UNSHARP_SPEC, img)
    np.testing.assert_array_equal(out["image"].numpy(), want)
    _assert_outputs_equal(out, _jax_out(UNSHARP_SPEC, img))


@pytest.mark.parametrize("impl", GRAPH_IMPLS)
@pytest.mark.parametrize("spec,channels", [(UNSHARP_SPEC, 3), (BRIGHT_SPEC, 3),
                                           (SHARED_PREFIX_SPEC, 1)],
                         ids=["unsharp", "bright", "shared"])
def test_graph_callable_equals_the_jax_package_s(spec, channels, impl):
    """Image, histogram and stats byte-equal to the JAX package's
    graph_callable under jax.jit, under every impl of the port (the
    banded products under 'mxu'; 'auto' routes nothing off a card)."""
    img = synthetic_image(97, 64, channels=channels, seed=11)
    _assert_outputs_equal(_port_out(spec, img, impl=impl), _jax_out(spec, img))


@pytest.mark.parametrize("shape", [(300, 200, 3), (400, 300, 1)])
def test_stats_mean_past_2_24_equals_the_jax_package_s(shape):
    """The mean's float32 sum of hist * bins passes 2^24 here, where the
    order of the 256 additions decides the bits: the port writes out
    XLA-CPU's order (`_sum256_f32`) and lands on the JAX package's bytes."""
    img = synthetic_image(*shape[:2], channels=shape[2], seed=5)
    out = _port_out(BRIGHT_SPEC, img)
    hist = out["histogram"].numpy()
    post_hist = np.bincount(out["image"].numpy().ravel(), minlength=256)
    assert float((post_hist * np.arange(256)).sum()) > 2 ** 24
    assert float((hist * np.arange(256)).sum()) > 2 ** 24
    _assert_outputs_equal(out, _jax_out(BRIGHT_SPEC, img))


def test_sum256_order_is_xla_cpu_s():
    """`_sum256_f32` against jnp.sum under jit on 64 random float32[256]
    rows of large integers, where a plain sequential or pairwise sum often
    differs in the last bits."""
    rng = np.random.default_rng(3)
    f = jax.jit(lambda v: v.sum())
    seq_differs = 0
    for _ in range(64):
        v = (rng.integers(0, 400000, 256) * np.arange(256)).astype(np.float32)
        got = _sum256_f32(torch.from_numpy(v)).numpy()
        assert got.tobytes() == np.asarray(f(v)).tobytes()
        s = np.float32(0)
        for x in v:
            s = np.float32(s + x)
        seq_differs += int(s != got)
    assert seq_differs > 0  # the order matters on these sums


# --------------------------------------------------------------------------
# shared prefixes + side outputs
# --------------------------------------------------------------------------


def test_shared_prefix_computed_once(monkeypatch):
    """A fan-out tap's producing segment is ONE step, built once
    (`on_stage`) and run once (a spy on the stage walker) however many
    branches read it."""
    from mpi_cuda_imagemanipulation_tpu_torch.plan import exec as plan_exec

    prog = compile_graph(parse_spec(SHARED_PREFIX_SPEC), device="cpu")
    assert prog.n_segments == 3 and prog.n_merges == 1
    runs: list = []
    fn = graph_callable(prog, on_stage=runs.append)
    calls: list = []
    real = plan_exec.run_stage_full
    monkeypatch.setattr(plan_exec, "run_stage_full",
                        lambda stage, x, acc=None: calls.append(stage.names) or real(stage, x, acc))
    img = synthetic_image(30, 30, channels=1, seed=1)
    fn(torch.from_numpy(img))
    fn(torch.from_numpy(img))  # the same width: no second build
    assert len(runs) == len(prog.steps) == 4
    assert sum(1 for s in runs if getattr(s, "dst", None) == "pre") == 1
    assert calls.count(("gaussian3",)) == 2  # once a call, two calls
    assert len(calls) == 6


def test_side_outputs_one_dispatch():
    img = synthetic_image(33, 47, channels=3, seed=2)
    out = _port_out(UNSHARP_SPEC, img)
    im = out["image"].numpy()
    np.testing.assert_array_equal(out["histogram"].numpy(), np.bincount(im.ravel(), minlength=256))
    stats = out["stats"]
    assert int(stats["count"]) == im.size
    assert int(stats["min"]) == int(im.min()) and int(stats["max"]) == int(im.max())
    assert float(stats["mean"]) == pytest.approx(float(im.mean()), abs=1e-3)
    _assert_outputs_equal(out, _jax_out(UNSHARP_SPEC, img))


def test_channel_validation_static_and_runtime():
    with pytest.raises(SpecError) as ei:
        parse_spec(chain_as_spec("grayscale,grayscale"))
    assert ei.value.code == "channel-mismatch"
    g = parse_spec(chain_as_spec("grayscale,contrast:3.5"))
    with pytest.raises(SpecError) as ei:
        g.check_channels(1)
    assert ei.value.code == "bad-image"
    with pytest.raises(jspec.SpecError) as ej:
        jgraph.parse_spec(chain_as_spec("grayscale,contrast:3.5")).check_channels(1)
    assert ej.value.code == "bad-image"


# --------------------------------------------------------------------------
# tenancy: quotas, QoS ladder, bounded cache namespaces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_quota_window_sheds_and_resets(mod):
    tn = {"port": __import__(
        "mpi_cuda_imagemanipulation_tpu_torch.graph.tenancy", fromlist=["x"]), "jax": jtenancy}[mod]
    clock = [100.0]
    reg = tn.TenantRegistry(clock=lambda: clock[0])
    st = reg.configure(tn.TenantConfig(tenant_id="t", quota_requests=2, quota_bytes=1000,
                                       window_s=10.0))
    reg.admit(st, 100, 0.0)
    reg.admit(st, 100, 0.0)
    with pytest.raises(tn.GraphShed) as ei:
        reg.admit(st, 100, 0.0)
    assert ei.value.reason == "quota"
    assert 0 < ei.value.retry_after_s <= 10.0
    clock[0] += 10.0  # window rolls: budget refreshed
    reg.admit(st, 100, 0.0)
    with pytest.raises(tn.GraphShed) as ei:
        reg.admit(st, 950, 0.0)
    assert ei.value.reason == "quota"
    assert reg.stats()["tenants"]["t"]["shed"] == 2


def test_qos_ladder_sheds_low_first():
    assert (qos_admit_frac("batch", 0.5) < qos_admit_frac("standard", 0.5)
            < qos_admit_frac("interactive", 0.5) == 1.0)
    for q in ("batch", "standard", "interactive"):
        assert qos_admit_frac(q, 0.3) == jtenancy.qos_admit_frac(q, 0.3)
    reg = TenantRegistry(clock=lambda: 0.0)
    batch = reg.configure(TenantConfig(tenant_id="b", qos="batch"))
    inter = reg.configure(TenantConfig(tenant_id="i", qos="interactive"))
    load = (qos_admit_frac("batch", reg.qos_shed_frac) + 1.0) / 2
    with pytest.raises(GraphShed) as ei:
        reg.admit(batch, 10, load)
    assert ei.value.reason == "qos"
    reg.admit(inter, 10, load)  # interactive rides the same load fine
    stats = reg.stats()
    assert set(stats) == set(jtenancy.TenantRegistry(clock=lambda: 0.0).stats())


@pytest.mark.parametrize("kw,code", [
    ({"tenant_id": "bad tenant!"}, "bad-tenant-id"),
    ({"tenant_id": "t", "qos": "platinum"}, "bad-qos"),
    ({"tenant_id": "t", "quota_requests": -1}, "bad-quota"),
    ({"tenant_id": "t", "quota_bytes": "lots"}, "bad-quota"),
])
def test_tenant_config_validation_codes(kw, code):
    with pytest.raises(SpecError) as ei:
        TenantConfig(**kw)
    assert ei.value.code == code
    with pytest.raises(jspec.SpecError) as ej:
        jtenancy.TenantConfig(**kw)
    assert ej.value.code == code


def test_tenant_registry_cap(monkeypatch):
    monkeypatch.setenv("MCIM_GRAPH_MAX_TENANTS", "2")
    reg = TenantRegistry()
    reg.ensure("a")
    reg.ensure("b")
    reg.ensure("a")  # an existing tenant is no new entry
    with pytest.raises(SpecError) as ei:
        reg.ensure("c")
    assert ei.value.code == "tenant-limit"
    with pytest.raises(SpecError) as ei:
        reg.get("nobody")
    assert ei.value.code == "unknown-tenant"


def test_cache_namespace_cardinality_bounded():
    svc = GraphService(device="cpu")
    cap = svc.tenants.cache_cap
    img = synthetic_image(16, 16, channels=1, seed=0)
    pids = [svc.register("hoard", chain_as_spec(f"brightness:{i + 1}"))["pipeline"]
            for i in range(cap + 3)]
    for pid in pids:
        svc.process("hoard", pid, img)
    st = svc.tenants.get("hoard")
    assert len(st.cache) <= cap
    assert st.cache_evictions >= 3
    # the evicted function still serves: a rebuild on a miss, not an error
    out = svc.process("hoard", pids[0], img)
    assert out["image"].shape == (16, 16)
    assert svc._m_compiles.value() == cap + 4


def test_graph_dispatch_failpoint_is_error_not_shed():
    """The one genuine 500 class (a device failure AFTER admission) stays
    distinct from shed/rejected in the accounting."""
    svc = GraphService(device="cpu")
    reg = svc.register("t", chain_as_spec("invert"))
    img = synthetic_image(16, 16, channels=1, seed=0)
    failpoints.configure("graph.dispatch=always")
    try:
        with pytest.raises(failpoints.FailpointError):
            svc.process("t", reg["pipeline"], img)
    finally:
        failpoints.clear()
    assert svc._m_requests.value(status="error") == 1
    assert svc._m_requests.value(status="shed") == 0
    assert svc._inflight == 0
    svc.process("t", reg["pipeline"], img)  # cleared: healthy again
    assert svc._m_requests.value(status="ok") == 1


def test_service_refusals_are_taxonomy_codes():
    svc = GraphService(device="cpu")
    pid = svc.register("t", UNSHARP_SPEC)["pipeline"]
    img = synthetic_image(20, 20, channels=3, seed=1)
    cases = [
        (("nobody", pid, img), "unknown-tenant"),
        (("t", "dag-0000000000000000", img), "unknown-pipeline"),
        (("t", pid, img[..., 0]), "bad-image"),  # one channel into grayscale
        (("t", pid, img[:2]), "bad-image"),  # below the stencil's minimum
        (("t", pid, img.astype(np.int16)), "bad-image"),
    ]
    for args, code in cases:
        with pytest.raises(SpecError) as ei:
            svc.process(*args)
        assert ei.value.code == code
    assert svc._m_requests.value(status="rejected") == len(cases)
    with pytest.raises(SpecError) as ei:
        svc.configure_tenant({"tenant": "t", "qos": "batch", "extra": 1})
    assert ei.value.code == "unknown-field"
    with pytest.raises(SpecError) as ei:
        svc.configure_tenant([1])
    assert ei.value.code == "bad-root"


@pytest.fixture(scope="module")
def jax_service():
    """One JAX GraphService for the module."""
    return JaxGraphService()


def test_service_results_equal_the_jax_service_s(jax_service):
    """register + process in both services: the same pipeline ids and
    registration records, the same process() results (image, histogram,
    stats with the mean rounded to 4 places)."""
    svc = GraphService(device="cpu")
    img = synthetic_image(97, 64, channels=3, seed=4)
    for spec in (UNSHARP_SPEC, BRIGHT_SPEC, chain_as_spec("grayscale,contrast:3.5,emboss:3")):
        reg = svc.register("acme", spec)
        jreg = jax_service.register("acme", spec)
        assert reg == jreg
        got = svc.process("acme", reg["pipeline"], img)
        want = jax_service.process("acme", jreg["pipeline"], img)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got.get("histogram") == want.get("histogram")
        assert got.get("stats") == want.get("stats")
    assert svc.pipeline_ids() == jax_service.pipeline_ids()
    assert svc.configure_tenant({"tenant": "acme", "qos": "batch", "quota_requests": 5}) == \
        jax_service.configure_tenant({"tenant": "acme", "qos": "batch", "quota_requests": 5})
    stats, jstats = svc.stats(), jax_service.stats()
    assert set(stats) - {"device"} == set(jstats)
    assert stats["tenants"]["acme"]["pipelines"] == jstats["tenants"]["acme"]["pipelines"]


def test_batched_fn_stack_of_four_equals_four_solo_calls():
    """The group lane's stacked function on four DIFFERENT images: each
    image's output, histogram and stats equal its solo call (a histogram
    summed over the stack would not), and the solo calls equal the JAX
    package."""
    svc = GraphService(device="cpu")
    pid = svc.register("t", BRIGHT_SPEC)["pipeline"]
    st = svc.tenants.get("t")
    graph = st.pipelines[pid][0]
    imgs = [synthetic_image(97, 64, channels=3, seed=30 + k) for k in range(4)]
    stacked = svc._batched_fn(st, pid, graph, 64, 4)(np.stack(imgs))
    assert stacked["image"].shape == (4, 97, 64, 3)
    assert stacked["histogram"].shape == (4, 256)
    solo = svc._pipeline_fn(st, pid, graph, 64)
    hists = set()
    for k, img in enumerate(imgs):
        one = solo(img)
        np.testing.assert_array_equal(stacked["image"][k].numpy(), one["image"].numpy())
        np.testing.assert_array_equal(stacked["histogram"][k].numpy(), one["histogram"].numpy())
        for key, v in one["stats"].items():
            assert stacked["stats"][key][k].numpy().tobytes() == v.numpy().tobytes(), key
        _assert_outputs_equal(one, _jax_out(BRIGHT_SPEC, img))
        hists.add(one["histogram"].numpy().tobytes())
    assert len(hists) == 4  # the four images differ where it counts
    assert f"{pid}@b4" in st.cache


def test_graph_cost_attribution_models_the_boundary():
    """The service's functions land in the cost ledger at drift 1.0: the
    source in, the declared outputs (image, histogram, stats) out."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs.cost import cost_ledger

    svc = GraphService(device="cpu")
    pid = svc.register("t", UNSHARP_SPEC)["pipeline"]
    svc.process("t", pid, synthetic_image(23, 29, channels=3, seed=2))
    st = svc.tenants.get("t")
    graph = st.pipelines[pid][0]
    svc._batched_fn(st, pid, graph, 29, 2)(np.stack(
        [synthetic_image(23, 29, channels=3, seed=k) for k in range(2)]))
    fp = compile_graph(graph, device="cpu").fingerprint
    assert cost_ledger.drift("graph", fp) == pytest.approx(1.0)
    assert cost_ledger.drift("graph", f"{fp}@b2") == pytest.approx(1.0)


# --------------------------------------------------------------------------
# chain-scheduler QoS admission (serve/scheduler.py)
# --------------------------------------------------------------------------


def test_scheduler_qos_sheds_low_class_first():
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeApp, ServeConfig

    app = ServeApp(ServeConfig(
        ops="grayscale,contrast:3.5", buckets=((32, 32),), channels=(3,), max_batch=64,
        max_delay_ms=10_000.0,  # nothing dispatches during the test
        queue_depth=8, device="cpu",
    )).start()
    try:
        img = synthetic_image(20, 20, channels=3, seed=0)
        # fill to 4 = batch's fraction of depth (0.5 * 8)
        held = [app.scheduler.submit(img) for _ in range(4)]
        shed = app.scheduler.submit(img, qos="batch")
        assert shed.status == "overloaded"
        ok = app.scheduler.submit(img, qos="interactive")
        assert ok.status == "ok"  # still pending, admitted
        assert app.metrics.snapshot()["shed_overloaded"] == 1
        assert app.metrics._qos_shed.value(qos="batch") == 1
        # a known tenant's chain traffic submits under its class
        app.graph_service.configure_tenant({"tenant": "bulk", "qos": "batch"})
        assert app.tenant_qos("bulk") == "batch"
        assert app.tenant_qos("nobody") == "interactive"
        assert app.tenant_qos(None) == "interactive"
        del held
    finally:
        app.stop(drain=False)


# --------------------------------------------------------------------------
# the handoff and placement frames: the JAX package's bytes
# --------------------------------------------------------------------------


def test_systolic_frames_are_the_jax_package_s_bytes():
    from mpi_cuda_imagemanipulation_tpu.graph import systolic as jsys
    from mpi_cuda_imagemanipulation_tpu_torch.graph import systolic as tsys

    rng = np.random.default_rng(19)
    env = {"src": rng.integers(0, 256, (31, 17, 3), dtype=np.uint8),
           "n2~1": rng.integers(0, 256, (31, 17), dtype=np.uint8),
           "~histogram": rng.integers(0, 99, (256,)).astype(np.int32)}
    meta = {"placement": {"tenant": "t", "ranges": [[0, 2], [2, 5]]}, "idx": 1, "trace_id": "x"}
    body = tsys.encode_handoff(meta, env)
    assert body == jsys.encode_handoff(meta, env)
    for decode in (tsys.decode_handoff, jsys.decode_handoff):
        m, got = decode(body)
        assert m == meta and set(got) == set(env)
        for k in env:
            assert got[k].dtype == env[k].dtype and np.array_equal(got[k], env[k])
    kw = dict(tenant="t0", pipeline="pid", ranges=((0, 3), (3, 7)),
              addrs=["127.0.0.1:1", "127.0.0.1:2"], trace_id="abc")
    hdr = tsys.encode_placement(**kw)
    assert hdr == jsys.encode_placement(**kw)
    assert tsys.decode_placement(hdr) == jsys.decode_placement(hdr)
    assert (tsys.FALLBACK_REASONS, tsys.HDR_PLAN, tsys.SYSTOLIC_PATH) == \
        (jsys.FALLBACK_REASONS, jsys.HDR_PLAN, jsys.SYSTOLIC_PATH)
    for bad in (body[:-1], body + b"x", b"no header line"):
        with pytest.raises(ValueError):
            tsys.decode_handoff(bad)


def test_service_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        GraphService()
