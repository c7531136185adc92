"""`auto` routing: the port's decisions against the JAX package's for the
same store and switches, and every routed path byte-equal to the JAX
package's golden output.

Both packages' device checks are monkeypatched to one fake card kind
(the port's utils/platform.is_cuda_device and device_kind, the JAX
package's is_tpu_backend and calibration.current_device_kind), and both
read one tmp_path store. The decisions compared: `resolve_plan_mode`
under MCIM_PLAN and under a plan record, `commute_geometrics` under
MCIM_PLAN_COMMUTE=0, `use_mxu_for_stencil` under a backend record and
MCIM_PREFER_MXU, `stage_arm_for` under a stage-arm record, and which
stencils take SWAR under MCIM_PREFER_SWAR. Then every such route, through
``Pipeline.jit(backend='auto', plan='auto')`` and ``Pipeline.sharded``
over CPU slots, gives the golden bytes; with an empty store and no switch
``auto`` makes exactly the kernel calls ``cuda --plan off`` makes; a built
function reads neither the environment nor the store after its first call
for a shape; and a record taken at one width does not steer another
outside the factor-of-two window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops import mxu_kernels as jmk
from mpi_cuda_imagemanipulation_tpu.ops import pallas_kernels as jpk
from mpi_cuda_imagemanipulation_tpu.ops import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.ops import swar_kernels as jsk
from mpi_cuda_imagemanipulation_tpu.plan import planner as jax_planner
from mpi_cuda_imagemanipulation_tpu.plan.ir import pipeline_fingerprint as jax_fingerprint
from mpi_cuda_imagemanipulation_tpu.plan.metrics import plan_metrics as jax_metrics
from mpi_cuda_imagemanipulation_tpu.utils import calibration as jax_calib
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import mxu_kernels as mk
from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh
from mpi_cuda_imagemanipulation_tpu_torch.plan import planner, plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import pipeline_fingerprint
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration, platform
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

FAKE = "FAKE CARD 80GB"
KNOBS = ("MCIM_NO_CALIB", "MCIM_PLAN", "MCIM_PLAN_COMMUTE", "MCIM_PREFER_SWAR",
         "MCIM_PREFER_MXU", "MCIM_MXU_MODE", "MCIM_MXU_COL", "MCIM_MXU_STAGE")
REFERENCE = "grayscale,contrast:3.5,emboss:3"
MEGAKERNEL = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"
SPECS = [REFERENCE, "gaussian:5", MEGAKERNEL, "grayscale,sobel,erode:3,box:3"]
# (port backend, JAX backend) of the same resolution rules
PAIRS = [("auto", "auto"), ("torch", "xla"), ("mxu", "mxu"), ("swar", "swar")]
W = 128


def _fresh_store(tmp_path, monkeypatch):
    monkeypatch.setenv("MCIM_CALIB_FILE", str(tmp_path / "calib.json"))
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    calibration._cache["key"] = None
    jax_calib._cache["key"] = None


@pytest.fixture()
def store(tmp_path, monkeypatch):
    """An empty store of its own, every knob unset; the real device checks."""
    _fresh_store(tmp_path, monkeypatch)
    yield tmp_path / "calib.json"
    calibration._cache["key"] = None
    jax_calib._cache["key"] = None


@pytest.fixture()
def fake_card(store, monkeypatch):
    """Both packages see one fake card kind and read one store."""
    monkeypatch.setattr(platform, "is_cuda_device", lambda device=None: True)
    monkeypatch.setattr(platform, "device_kind", lambda device=None: FAKE)
    monkeypatch.setattr(jax_calib, "current_device_kind", lambda: FAKE)
    monkeypatch.setattr(jmk, "is_tpu_backend", lambda: True)
    return store


def _img(spec, height=48, width=W, seed=5):
    return synthetic_image(height, width, channels=3 if "grayscale" in spec else 1, seed=seed)


def _golden(spec, img):
    return np.asarray(JaxPipeline.parse(spec)(jnp.asarray(img)))


# --------------------------------------------------------------------------
# Decisions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("value", ["off", "on", "pointwise", "fused", "fused-pallas",
                                   "fused-pallas-mxu"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
def test_mcim_plan_resolves_as_in_jax(fake_card, monkeypatch, value, pair):
    monkeypatch.setenv("MCIM_PLAN", value)
    ops, jops = make_pipeline_ops(MEGAKERNEL), jax_registry.make_pipeline_ops(MEGAKERNEL)
    want = jax_planner.resolve_plan_mode(jops, "auto", backend=pair[1], width=W)
    if pair[0] == "auto" and want in ("pointwise", "fused"):
        # the port's auto never runs the plain PyTorch walker: refused, by name
        with pytest.raises(ValueError, match="MCIM_PLAN"):
            planner.resolve_plan_mode(ops, "auto", backend="auto", width=W)
        return
    assert planner.resolve_plan_mode(ops, "auto", backend=pair[0], width=W) == want
    # an explicit plan is never overridden
    assert planner.resolve_plan_mode(ops, "off", backend=pair[0], width=W) == "off"


@pytest.mark.parametrize("commute", [None, "1", "0"])
def test_mcim_plan_commute_as_in_jax(store, monkeypatch, commute):
    if commute is not None:
        monkeypatch.setenv("MCIM_PLAN_COMMUTE", commute)
    spec = "invert,rot180,contrast:2,gaussian:3,fliph,brightness:5"
    ops, jops = make_pipeline_ops(spec), jax_registry.make_pipeline_ops(spec)
    got = [op.name for op in planner.commute_geometrics(ops)]
    assert got == [op.name for op in jax_planner.commute_geometrics(jops)]
    assert (got == [op.name for op in ops]) == (commute == "0")
    port_stages = [[op.name for op in st.ops] for st in planner.build_plan(ops, "fused").stages]
    jax_stages = [[op.name for op in st.ops] for st in jax_planner.build_plan(jops, "fused").stages]
    assert port_stages == jax_stages
    img = synthetic_image(24, 40, channels=1, seed=3)
    np.testing.assert_array_equal(
        Pipeline(ops).jit("torch", device="cpu", plan="fused")(img).numpy(), _golden(spec, img))


@pytest.mark.parametrize("choice", calibration.PLAN_CHOICES)
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
def test_plan_record_resolves_as_in_jax(fake_card, choice, pair):
    ops, jops = make_pipeline_ops(MEGAKERNEL), jax_registry.make_pipeline_ops(MEGAKERNEL)
    fp = pipeline_fingerprint(ops)
    assert fp == jax_fingerprint(jops)
    jax_calib.record_plan_choice(FAKE, fp, choice, width=W)
    for width in (W, 4 * W):  # 4W lies outside the record's window: the default
        want = jax_planner.resolve_plan_mode(jops, "auto", backend=pair[1], width=width)
        got = planner.resolve_plan_mode(ops, "auto", backend=pair[0], width=width)
        if pair[0] == "auto" and want in ("pointwise", "fused"):
            assert got == "off"  # a walker mode the port's auto ignores
        else:
            assert got == want
    assert planner.resolve_plan_mode(ops, "auto", backend="auto", width=4 * W) == "off"


@pytest.mark.parametrize("spec", ["gaussian:5", "sobel", "emboss:3", "erode:3", "box:5",
                                  "median:3", "invert"])
@pytest.mark.parametrize("choice", [None, "vpu", "mxu", "hybrid"])
def test_backend_record_routes_as_in_jax(fake_card, spec, choice):
    op, jop = make_op(spec), jax_registry.make_op(spec)
    assert mk.mxu_family(op) == jmk.mxu_family(jop)
    if choice is not None and mk.mxu_family(op) is not None:
        calibration.record_backend_choice(FAKE, mk.mxu_family(op), choice, width=W)
    for width in (W, 4 * W):
        assert mk.use_mxu_for_stencil(op, width) == jmk.use_mxu_for_stencil(jop, width)
    want = {None: None, "vpu": None, "mxu": "banded", "hybrid": "hybrid"}[choice]
    assert mk.use_mxu_for_stencil(op, W) == (want if mk.mxu_family(op) else None)


@pytest.mark.parametrize("mode", [None, "banded", "hybrid"])
def test_prefer_mxu_routes_as_in_jax(fake_card, monkeypatch, mode):
    monkeypatch.setenv("MCIM_PREFER_MXU", "1")
    if mode:
        monkeypatch.setenv("MCIM_MXU_MODE", mode)
    for spec in ("gaussian:5", "sobel", "median:3"):
        op, jop = make_op(spec), jax_registry.make_op(spec)
        assert mk.use_mxu_for_stencil(op, W) == jmk.use_mxu_for_stencil(jop, W)
    assert mk.use_mxu_for_stencil(make_op("gaussian:5"), W) == (mode or "banded")


def test_no_promotion_off_the_card(store, monkeypatch):
    """On the real CPU nothing promotes a route, as off a TPU in JAX."""
    monkeypatch.setenv("MCIM_PREFER_MXU", "1")
    calibration.record_backend_choice(calibration.current_device_kind("cpu"), "sep5", "mxu")
    op = make_op("gaussian:5")
    assert mk.use_mxu_for_stencil(op, W, "cpu") is None
    assert jmk.use_mxu_for_stencil(jax_registry.make_op("gaussian:5"), W) is None
    plan_metrics.reset()
    assert mk.stage_arm_for(op, W, "auto", device="cpu") == "vpu"
    assert dict(plan_metrics.mxu_stage_fallbacks) == {"not-cuda": 1}


@pytest.mark.parametrize("spec", ["gaussian:5", "sobel", "emboss:3", "erode:3",
                                  "filter:128/1/0/0/0/0/0/0/0:1.0", "median:3"])
@pytest.mark.parametrize("choice", [None, "vpu", "mxu", "mxu-int8"])
def test_stage_arm_record_resolves_as_in_jax(fake_card, spec, choice):
    op, jop = make_op(spec), jax_registry.make_op(spec)
    fam = mk.mxu_family(op)
    if choice is not None and fam is not None:
        calibration.record_stage_arm(FAKE, fam, choice, width=W)
    def jax_counts():  # the JAX package's counters only grow: compare increments
        return ({r: jax_metrics.mxu_stage_fallbacks.value(reason=r)
                 for r in jmk.STAGE_FALLBACK_REASONS},
                {a: jax_metrics.mxu_stage_ops.value(arm=a) for a in ("mxu", "mxu-int8")})

    plan_metrics.reset()
    before = jax_counts()
    for width in (W, 4 * W):
        assert mk.stage_arm_for(op, width, "auto") == jmk.stage_arm_for(jop, width, "auto")
    after = jax_counts()
    for reason in mk.STAGE_FALLBACK_REASONS:
        jr = "not-tpu" if reason == "not-cuda" else reason
        assert plan_metrics.mxu_stage_fallbacks[reason] == after[0][jr] - before[0][jr]
    for arm in ("mxu", "mxu-int8"):
        assert plan_metrics.mxu_stage_ops[arm] == after[1][arm] - before[1][arm]


def _swar_calls(monkeypatch):
    port, jax_ = [], []
    real_port, real_jax = sk.swar_stencil, jsk.swar_stencil

    def spy_port(op, img, **kw):
        port.append(op.name)
        return real_port(op, img, **kw)

    def spy_jax(op, img, **kw):
        jax_.append(op.name)
        return real_jax(op, img, **kw)

    monkeypatch.setattr(sk, "swar_stencil", spy_port)
    monkeypatch.setattr(jsk, "swar_stencil", spy_jax)
    return port, jax_


@pytest.mark.parametrize("switch", [None, "0", "1"])
@pytest.mark.parametrize("spec", ["gaussian:5", "contrast:3.5,emboss:3", "sobel,invert",
                                  "median:3,box:3", "gaussian:7,gaussian:3"])
def test_prefer_swar_takes_the_stencils_jax_takes(fake_card, monkeypatch, switch, spec):
    if switch is not None:
        monkeypatch.setenv("MCIM_PREFER_SWAR", switch)
    assert sk.prefer_swar() == jpk.prefer_swar() == (switch == "1")
    img = synthetic_image(24, 64, channels=1, seed=9)
    port, jax_ = _swar_calls(monkeypatch)
    got = Pipeline.parse(spec).jit("auto", device="cpu")(img)
    jpk.pipeline_auto(jax_registry.make_pipeline_ops(spec), jnp.asarray(img))
    assert port == jax_
    assert bool(port) == (switch == "1")
    np.testing.assert_array_equal(got.numpy(), _golden(spec, img))


# --------------------------------------------------------------------------
# Every routed path: golden bytes, unsharded and sharded
# --------------------------------------------------------------------------


def _record_scenario(scenario, spec, monkeypatch, width=W):
    ops = make_pipeline_ops(spec)
    fams = {mk.mxu_family(op) for op in ops} - {None}
    kind, what = scenario.split(":")
    if kind == "plan":
        calibration.record_plan_choice(FAKE, pipeline_fingerprint(ops), what, width=width)
    elif kind == "backend":
        for fam in fams:
            calibration.record_backend_choice(FAKE, fam, what, width=width)
    elif kind == "stage":
        calibration.record_plan_choice(FAKE, pipeline_fingerprint(ops), "fused-pallas",
                                       width=width)
        for fam in fams:
            calibration.record_stage_arm(FAKE, fam, what, width=width)
    elif kind == "block":
        calibration.record_block_h(FAKE, int(what), impl="cuda", width=width)
        calibration.record_block_h(FAKE, int(what), impl="swar", width=width)
    elif kind == "env":
        monkeypatch.setenv(what, "1")


SCENARIOS = ["none:", "plan:off", "plan:fused-pallas", "plan:fused-pallas-mxu",
             "backend:mxu", "backend:hybrid", "backend:vpu", "stage:mxu", "stage:mxu-int8",
             "block:8", "env:MCIM_PREFER_SWAR", "env:MCIM_PREFER_MXU"]


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("spec", SPECS)
def test_routed_path_is_golden(fake_card, monkeypatch, scenario, spec):
    _record_scenario(scenario, spec, monkeypatch)
    img = _img(spec)
    want = _golden(spec, img)
    got = Pipeline.parse(spec).jit("auto", device="cpu", plan="auto")(img)
    np.testing.assert_array_equal(got.numpy(), want)
    got = ck.pipeline_auto(make_pipeline_ops(spec), torch.from_numpy(img))  # resolved per call
    np.testing.assert_array_equal(got.numpy(), want)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    got = Pipeline.parse(spec).sharded(mesh, backend="auto", plan="auto")(img)
    np.testing.assert_array_equal(got.numpy(), want)


def _route_counts(monkeypatch):
    counts = {"mxu_stencil": 0, "swar": 0, "mxu_valid": 0}

    def spy(name, real):
        def f(*a, **kw):
            counts[name] += 1
            return real(*a, **kw)
        return f

    monkeypatch.setattr(ck, "mxu_stencil", spy("mxu_stencil", ck.mxu_stencil))
    monkeypatch.setattr(sk, "swar_stencil", spy("swar", sk.swar_stencil))
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    monkeypatch.setattr(api, "mxu_valid", spy("mxu_valid", api.mxu_valid))
    monkeypatch.setattr(api, "swar_stencil", spy("swar", api.swar_stencil))
    return counts


@pytest.mark.parametrize("scenario,expect", [
    ("plan:fused-pallas", {"pallas_stages": 1}),
    ("plan:fused-pallas-mxu", {"pallas_stages": 1, "mxu-int8": 2}),
    ("backend:mxu", {"mxu_stencil": 2, "mxu_valid": 4}),
    ("backend:hybrid", {"mxu_stencil": 2, "mxu_valid": 4}),
    ("stage:mxu", {"pallas_stages": 1, "mxu": 2}),
    ("stage:mxu-int8", {"pallas_stages": 1, "mxu-int8": 2}),
    ("env:MCIM_PREFER_SWAR", {"swar": 3}),
    ("env:MCIM_PREFER_MXU", {"mxu_stencil": 2, "mxu_valid": 4}),
])
def test_auto_takes_the_recorded_route(fake_card, monkeypatch, scenario, expect):
    """The megakernel chain takes the route each record or switch names:
    K4 stages, K5 arms, banded products (per stencil, and per stencil and
    shard of two) or SWAR."""
    spec = MEGAKERNEL
    _record_scenario(scenario, spec, monkeypatch)
    counts = _route_counts(monkeypatch)
    img = _img(spec, width=W)
    plan_metrics.reset()
    Pipeline.parse(spec).jit("auto", device="cpu")(img)
    Pipeline.parse(spec).sharded(make_mesh(2, devices=["cpu"] * 2), backend="auto")(img)
    seen = {**counts, "pallas_stages": plan_metrics.pallas_stages // 2,
            "mxu": plan_metrics.mxu_stage_ops["mxu"] // 2,
            "mxu-int8": plan_metrics.mxu_stage_ops["mxu-int8"] // 2}
    if "swar" in expect:  # one SWAR group unsharded (gaussian:5 + sharpen) and sharded
        assert seen["swar"] >= 2
        expect = {k: v for k, v in expect.items() if k != "swar"}
    assert {k: seen[k] for k in expect} == expect, seen


# --------------------------------------------------------------------------
# The default, the hot path, the width window
# --------------------------------------------------------------------------


CALLS = ("pointwise_group", "stream_stencil", "fused_stage", "stream_stencil_ghost",
         "stencil_tile", "fused_stage_ext")


def _kernel_calls(monkeypatch):
    calls = []

    def spy(name, real):
        def f(*a, **kw):
            names = [getattr(o, "name", "") for o in (a[0] if a and isinstance(a[0], (list, tuple))
                                                       else a[:1])]
            calls.append((name, tuple(names), tuple(sorted(
                (k, v) for k, v in kw.items() if isinstance(v, (int, str, type(None)))))))
            return real(*a, **kw)
        return f

    for name in CALLS:
        monkeypatch.setattr(ck, name, spy(name, getattr(ck, name)))
    return calls


@pytest.mark.parametrize("spec", SPECS + ["rot:90,gaussian:5", "grayscale,equalize,gaussian:5",
                                          "gamma:2.2,gaussian:5,invert"])
def test_empty_store_auto_takes_today_s_cuda_routes(store, monkeypatch, spec):
    calls = _kernel_calls(monkeypatch)
    img = _img(spec)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    runs = {}
    for backend, plan in (("auto", "auto"), ("cuda", "off")):
        calls.clear()
        out = Pipeline.parse(spec).jit(backend, device="cpu", plan=plan)(img)
        sharded = Pipeline.parse(spec).sharded(mesh, backend=backend, plan=plan)(img)
        runs[backend] = list(calls)
        np.testing.assert_array_equal(out.numpy(), sharded.numpy())
    assert runs["auto"] == runs["cuda"] and runs["cuda"]


def test_built_function_reads_nothing_per_call(fake_card, monkeypatch):
    spec = MEGAKERNEL
    _record_scenario("backend:mxu", spec, monkeypatch)
    img = _img(spec)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    fns = [Pipeline.parse(spec).jit(b, device="cpu", plan="auto") for b in ("auto", "cuda")]
    fns.append(Pipeline.parse(spec).sharded(mesh, backend="auto"))
    firsts = [fn(img) for fn in fns]

    def boom(*a, **k):
        raise AssertionError("read on the hot path")

    monkeypatch.setattr(calibration, "_load", boom)
    monkeypatch.setattr(env_registry, "get", boom)
    monkeypatch.setattr(platform, "is_cuda_device", boom)
    for fn, first in zip(fns, firsts):
        assert torch.equal(fn(img), first)
    with pytest.raises(AssertionError, match="hot path"):  # a new shape resolves anew
        fns[0](_img(spec, height=40))


def test_a_record_steers_only_its_width_window(fake_card, monkeypatch):
    spec = "gaussian:5"
    calibration.record_backend_choice(FAKE, "sep5", "mxu", width=W)
    counts = _route_counts(monkeypatch)
    fn = Pipeline.parse(spec).jit("auto", device="cpu")
    for width, routed in ((W, 1), (2 * W, 1), (4 * W, 0), (W // 4, 0)):
        counts["mxu_stencil"] = 0
        img = synthetic_image(16, width, channels=1, seed=2)
        np.testing.assert_array_equal(fn(img).numpy(), _golden(spec, img))
        assert counts["mxu_stencil"] == routed, width
