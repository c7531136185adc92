"""The port's cost ledger (obs/cost.py) against the JAX package's, on the
CPU: the counterpart of tests/test_cost.py's ledger cases.

The port measures a call where the JAX package reads XLA's analyses: the
boundary bytes of the first call of each variant from its live tensors,
and, for ``attribute_plan``'s stages only, the temporary bytes from the
card's allocator (None on the CPU; chip_smoke phase 18 checks that path on
the card). The ledger's arithmetic (drift
band, alerts, the ``cost.model`` failpoint, the LRU bound, the site
vocabulary) is the JAX package's and is held to it on the same inputs; the
stream's tile cache attributes once per variant and the planned
``Pipeline.jit`` once per image shape, each at a unit ratio;
``attribute_plan`` keys its stages as the JAX package's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.obs import cost as jax_cost
from mpi_cuda_imagemanipulation_tpu.obs.metrics import Registry as JaxRegistry
from mpi_cuda_imagemanipulation_tpu.ops.registry import make_pipeline_ops as jax_ops
from mpi_cuda_imagemanipulation_tpu.plan import build_plan as jax_build_plan
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost
from mpi_cuda_imagemanipulation_tpu_torch.obs.cost import CostLedger, CostRecord
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry, parse_exposition
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import TileFnCache, plan_tiles


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


def make_cost(arg=1000.0, out=1000.0, alias=0.0, temp=None):
    return CostRecord(arg_bytes=arg, out_bytes=out, alias_bytes=alias, temp_bytes=temp)


def jax_make_cost(arg=1000.0, out=1000.0, alias=0.0, temp=0.0):
    return jax_cost.CostRecord(flops=5.0, hlo_bytes=4000.0, arg_bytes=arg, out_bytes=out,
                               alias_bytes=alias, temp_bytes=temp, code_bytes=0.0)


def _stream_entries(ledger=obs_cost.cost_ledger) -> dict:
    return {k: v for k, v in ledger.entries().items() if k[0] == "stream"}


# --------------------------------------------------------------------------
# the record and the ledger's arithmetic
# --------------------------------------------------------------------------


def test_cost_record_has_the_jax_fields():
    ours = {f.name for f in dataclasses.fields(CostRecord)}
    assert ours == {f.name for f in dataclasses.fields(jax_cost.CostRecord)}
    c = make_cost(100, 50, alias=10, temp=30)
    assert c.boundary_bytes == 100 + 50 - 10
    assert c.peak_bytes == 100 + 50 + 30
    assert (c.flops, c.hlo_bytes, c.code_bytes) == (None, None, None)
    assert set(c.to_dict()) == set(jax_make_cost().to_dict())
    assert make_cost(100, 50).peak_bytes == 150  # temp not measured (the CPU)


@pytest.mark.parametrize("modeled", [2000.0, 2000.0 / 0.8, 2000.0 / 1.25, 2000.0 / 0.72,
                                     2000.0 / 1.375, 1000.0, None])
@pytest.mark.parametrize("alias", [0.0, 1000.0])
def test_drift_ratio_and_alerts_equal_jax(modeled, alias):
    led, jled = CostLedger(Registry()), jax_cost.CostLedger(JaxRegistry())
    r = led.record("serve", "k", make_cost(alias=alias), modeled_bytes=modeled)
    jr = jled.record("serve", "k", jax_make_cost(alias=alias), modeled_bytes=modeled)
    assert r == jr
    assert led.drift_alerts.value(site="serve") == jled.drift_alerts.value(site="serve")
    assert led.snapshot() == jled.snapshot()


def test_drift_ratio_band_edges_and_alerts():
    led = CostLedger(Registry())
    lo, hi = obs_cost.drift_band()
    assert (lo, hi) == jax_cost.drift_band() == (0.8, 1.25)
    assert led.record("serve", "k1", make_cost(), modeled_bytes=2000.0) == 1.0
    led.record("serve", "k2", make_cost(), modeled_bytes=2000.0 / lo)
    led.record("serve", "k3", make_cost(), modeled_bytes=2000.0 / hi)
    assert led.drift_alerts.value(site="serve") == 0  # the band is inclusive
    led.record("serve", "k4", make_cost(), modeled_bytes=2000.0 / (lo * 0.9))
    led.record("serve", "k5", make_cost(), modeled_bytes=2000.0 / (hi * 1.1))
    assert led.drift_alerts.value(site="serve") == 2
    # an input handed back folds out of the measured boundary
    assert led.record("serve", "k6", make_cost(alias=1000), modeled_bytes=1000.0) == 1.0
    assert led.record("serve", "k7", make_cost()) is None


def test_drift_band_follows_the_environment(monkeypatch):
    monkeypatch.setenv("MCIM_COST_DRIFT_MIN", "0.5")
    monkeypatch.setenv("MCIM_COST_DRIFT_MAX", "2")
    led = CostLedger(Registry())
    led.record("bench", "k", make_cost(), modeled_bytes=2000.0 / 1.9)
    assert led.drift_alerts.value(site="bench") == 0
    assert obs_cost.drift_band() == jax_cost.drift_band() == (0.5, 2.0)


def test_mis_model_failpoint_trips_alert():
    led = CostLedger(Registry())
    failpoints.configure("cost.model=always")
    r = led.record("plan", "kf", make_cost(), modeled_bytes=2000.0)
    assert r == pytest.approx(0.25)
    assert led.drift_alerts.value(site="plan") == 1
    assert led.drift("plan", "kf") == pytest.approx(0.25)


def test_drift_alert_leaves_a_recorder_note():
    from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder

    before = recorder.get_recorder().noted
    CostLedger(Registry()).record("graph", "kn", make_cost(), modeled_bytes=100.0)
    kinds = [k for _t, k, _f in recorder.get_recorder().entries()]
    assert recorder.get_recorder().noted > before and "cost_drift" in kinds


def test_ledger_is_lru_bounded(monkeypatch):
    monkeypatch.setenv("MCIM_COST_CAP", "4")
    led = CostLedger(Registry())
    for i in range(10):
        led.record("bench", f"k{i}", make_cost(), modeled_bytes=2000.0)
    entries = led.entries()
    assert len(entries) == 4
    assert ("bench", "k9", "all") in entries
    assert ("bench", "k0", "all") not in entries
    assert led.snapshot()["entries"] == 4


def test_unknown_site_rejected():
    led = CostLedger(Registry())
    with pytest.raises(ValueError, match="unknown cost site"):
        led.record("nope", "k", make_cost())
    with pytest.raises(ValueError, match="unknown cost site"):
        obs_cost.wrap_cache_fn("nope", "k", lambda x: x)
    assert obs_cost.SITES == jax_cost.SITES


def test_exposition_has_the_jax_families():
    """The families no compiler fills stay registered with no samples."""
    reg, jreg = Registry(), JaxRegistry()
    led = CostLedger(reg)
    jax_cost.CostLedger(jreg)
    assert reg.names() == jreg.names()
    led.record("stream", "k", make_cost(temp=None), modeled_bytes=2000.0)
    fams = parse_exposition(reg.render())
    assert set(fams) == set(reg.names())
    for name in ("mcim_cost_hlo_bytes", "mcim_cost_flops", "mcim_cost_temp_bytes"):
        assert not fams[name]["samples"], name
    assert fams["mcim_cost_model_drift_ratio"]["samples"]
    led.record("stream", "k2", make_cost(temp=123.0))
    assert led.temp_bytes.values() == {("stream", "k2"): 123.0}


# --------------------------------------------------------------------------
# measuring calls
# --------------------------------------------------------------------------


def test_measured_call_on_the_cpu():
    x = torch.zeros(6, 7, 3, dtype=torch.uint8)
    out, cost = obs_cost.measured_call(lambda t: t[..., 0].clone(), (x,))
    assert out.shape == (6, 7)
    assert (cost.arg_bytes, cost.out_bytes, cost.alias_bytes) == (126, 42, 0)
    assert cost.temp_bytes is None  # the allocator is read only on a card
    assert obs_cost.measured_call(lambda t: t + 1, (x,), temp=True)[1].temp_bytes is None
    same, cost = obs_cost.measured_call(lambda t, y0: t, (x, 5))  # handed back; ints are free
    assert same is x and cost.alias_bytes == 126 and cost.boundary_bytes == 126


def test_wrap_cache_fn_attributes_the_first_call_only():
    led = CostLedger(Registry())
    calls = []

    def fn(t):
        calls.append(t.shape)
        return t + 1

    wrapped = obs_cost.LazyAttributedFn("bench", "once", fn,
                                        modeled_fn=lambda args: 2.0 * args[0].nbytes, ledger=led)
    for n in (4, 4, 9):
        assert torch.equal(wrapped(torch.zeros(n, dtype=torch.uint8)),
                           torch.ones(n, dtype=torch.uint8))
    assert len(calls) == 3
    assert led.executables.value(site="bench") == 1
    assert led.drift("bench", "once") == 1.0


def test_a_failing_first_call_is_measured_on_the_next():
    led = CostLedger(Registry())
    state = {"fail": True}

    def fn(t):
        if state.pop("fail", False):
            raise RuntimeError("boom")
        return t

    wrapped = obs_cost.LazyAttributedFn("bench", "retry", fn, ledger=led)
    with pytest.raises(RuntimeError, match="boom"):
        wrapped(torch.zeros(3, dtype=torch.uint8))
    assert led.executables.value(site="bench") == 0
    wrapped(torch.zeros(3, dtype=torch.uint8))
    assert led.executables.value(site="bench") == 1


def test_a_raising_model_records_without_a_ratio():
    led = CostLedger(Registry())
    wrapped = obs_cost.LazyAttributedFn("bench", "nomodel", lambda t: t,
                                        modeled_fn=lambda args: 1 / 0, ledger=led)
    wrapped(torch.zeros(3, dtype=torch.uint8))
    assert ("bench", "nomodel", "all") in led.entries()
    assert led.drift("bench", "nomodel") is None


def test_attrib_disabled_is_passthrough(monkeypatch):
    monkeypatch.setenv("MCIM_COST_ATTRIB", "0")

    def plain(x):
        return x

    assert obs_cost.wrap_cache_fn("bench", "off2", plain) is plain
    assert jax_cost.wrap_cache_fn("bench", "off2", plain) is plain
    before = len(obs_cost.cost_ledger.entries())
    fn = Pipeline.parse("gaussian:3").jit("torch", device="cpu", plan="fused")
    fn(synthetic_image(9, 8, channels=1, seed=0))
    cache = TileFnCache(make_pipeline_ops("gaussian:3"), global_h=9, global_w=8, impl="torch")
    spec = plan_tiles(9, 9, 1)[0]
    assert cache.fn(spec).__class__ is not obs_cost.LazyAttributedFn
    assert len(obs_cost.cost_ledger.entries()) == before


# --------------------------------------------------------------------------
# the sites: stream tiles, planned Pipeline.jit, attribute_plan
# --------------------------------------------------------------------------


def test_stream_tile_cache_attributes_per_variant():
    ops = make_pipeline_ops("grayscale,gaussian:3")
    cache = TileFnCache(ops, global_h=96, global_w=64, impl="torch")
    tiles = plan_tiles(96, 32, 1)
    img = np.random.default_rng(1).integers(0, 255, (96, 64, 3), dtype=np.uint8)
    before = set(_stream_entries())
    for _rep in range(2):
        for spec in tiles:
            ext = torch.from_numpy(img[spec.ext_lo : spec.ext_hi].copy())
            out = cache.fn(spec)(ext, spec.ext_lo)
            assert out.shape[0] == spec.out_rows
    new = {k: v for k, v in _stream_entries().items() if k not in before}
    assert len(new) == cache.variants == 3  # first, middle, last: once each
    lo, hi = obs_cost.drift_band()
    for key, entry in new.items():
        assert key[1].startswith(cache.plan.fingerprint + ":l")
        assert entry["drift_ratio"] == 1.0 and lo <= entry["drift_ratio"] <= hi, key
        assert entry["cost"]["temp_bytes"] is None


@pytest.mark.parametrize("spec,backend,plan,shape", [
    ("grayscale,contrast:3.5,emboss:3", "torch", "fused", (24, 40, 3)),
    ("grayscale,contrast:3.5,emboss:3", "mxu", "fused", (24, 40, 3)),
    ("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", "cuda", "fused-pallas", (30, 33, 3)),
    ("gaussian:5", "torch", "fused-pallas-mxu", (20, 21, 3)),
    ("grayscale,gaussian:3,rot90,sharpen", "torch", "fused", (18, 26, 3)),
    ("crop:2:3:10:12,gaussian:3,gray2rgb", "torch", "pointwise", (20, 20)),
    ("grayscale,equalize,gaussian:5", "cuda", "fused-pallas", (17, 19, 3)),
])
def test_planned_jit_attributes_with_a_unit_ratio(spec, backend, plan, shape):
    fn = Pipeline.parse(spec).jit(backend, device="cpu", plan=plan)
    built = build_plan(make_pipeline_ops(spec), plan)
    img = synthetic_image(*shape[:2], channels=shape[2] if len(shape) == 3 else 1, seed=2)
    out = fn(img)
    assert torch.equal(out, Pipeline.parse(spec)(torch.from_numpy(img)))
    entry = obs_cost.cost_ledger.entries()[("plan", built.fingerprint, "all")]
    assert entry["drift_ratio"] == 1.0
    assert entry["cost"]["arg_bytes"] == img.nbytes
    assert entry["cost"]["out_bytes"] == out.numel()
    assert entry["modeled_bytes"] == img.nbytes + out.numel()


def test_per_op_jit_is_not_a_cost_site():
    before = obs_cost.cost_ledger.snapshot()["attributed"]["plan"]
    for backend in ("torch", "cuda", "mxu", "auto"):
        Pipeline.parse("gaussian:3,invert").jit(backend, device="cpu", plan="off")(
            synthetic_image(8, 9, channels=1, seed=0))
    assert obs_cost.cost_ledger.snapshot()["attributed"]["plan"] == before


def test_plan_site_ratio_feeds_the_online_store(monkeypatch):
    from mpi_cuda_imagemanipulation_tpu_torch.tune import store

    seen = []
    monkeypatch.setattr(store.online_store, "record_io_scale",
                        lambda fp, stage, ratio: seen.append((fp, stage, ratio)))
    CostLedger(Registry()).record("plan", "fp1", make_cost(), modeled_bytes=2000.0,
                                  stage="s0/fused")
    CostLedger(Registry()).record("stream", "fp2", make_cost(), modeled_bytes=2000.0)
    assert seen == [("fp1", "s0/fused", 1.0)]


@pytest.mark.parametrize("spec,mode,shape", [
    ("grayscale,gaussian:3,rot180,sharpen", "fused", (64, 96, 3)),
    ("grayscale,gaussian:3,rot90,sharpen", "off", (40, 56, 3)),
    ("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", "fused-pallas", (32, 48, 3)),
    ("grayscale,equalize,emboss:3,gray2rgb", "pointwise", (30, 20, 3)),
])
def test_attribute_plan_per_stage_keys_and_band(spec, mode, shape):
    plan = build_plan(make_pipeline_ops(spec), mode)
    rows = obs_cost.attribute_plan(plan, shape, device="cpu")
    jrows = jax_cost.attribute_plan(jax_build_plan(jax_ops(spec), mode), shape)
    assert [(r["stage"], r["names"], r["modeled_bytes"]) for r in rows] == \
        [(r["stage"], r["names"], r["modeled_bytes"]) for r in jrows]
    assert plan.fingerprint == jax_build_plan(jax_ops(spec), mode).fingerprint
    for row in rows:
        assert row["drift_ratio"] == 1.0, row
        assert obs_cost.cost_ledger.drift("plan", plan.fingerprint, row["stage"]) == 1.0
        assert row["cost"]["boundary_bytes"] == row["modeled_bytes"]


def test_attribute_plan_impl_mxu_walks_the_banded_products():
    plan = build_plan(make_pipeline_ops("gaussian:5,sharpen"), "fused")
    rows = obs_cost.attribute_plan(plan, (20, 24), impl="mxu", device="cpu")
    assert [r["drift_ratio"] for r in rows] == [1.0]
    with pytest.raises(ValueError, match="unknown plan impl"):
        obs_cost.attribute_plan(plan, (20, 24), impl="xla", device="cpu")


@pytest.mark.parametrize("spec,mode,shape", [
    ("grayscale,contrast:3.5,emboss:3", "fused-pallas", (4320 // 40, 7680 // 40, 3)),
    ("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", "fused-pallas", (33, 70, 3)),
    ("gamma:2.2,gaussian:5,rot90,sharpen", "fused-pallas", (30, 41, 3)),
])
def test_stage_fn_routes_each_stage_as_the_megakernel_would(spec, mode, shape, monkeypatch):
    """The function attribute_plan(pallas=True) runs per stage: one K4 call
    on an image (the wrapper's plain version on the CPU) where K4 takes the
    stage, the walker where it rejects it ('lut-op'), the op for a barrier;
    chained, the golden bytes."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import stage_kernel_reject

    calls = []
    real = ck.fused_stage
    monkeypatch.setattr(ck, "fused_stage", lambda ops, img, **kw: (
        calls.append(tuple(img.shape)), real(ops, img, **kw))[1])
    plan = build_plan(make_pipeline_ops(spec), mode)
    img = torch.from_numpy(synthetic_image(*shape[:2], channels=shape[2], seed=4))
    x, want_k4 = img, []
    for st in plan.stages:
        if st.kind == "fused" and stage_kernel_reject(
                st, x.shape[0], x.shape[1], x.shape[2] if x.ndim == 3 else 1) is None:
            want_k4.append(tuple(x.shape))
        x = obs_cost.stage_fn(st, tuple(x.shape), pallas=True)(x)
    assert torch.equal(x, Pipeline.parse(spec)(img))
    assert calls == want_k4 and (want_k4 or "gamma" in spec)


def test_attribute_plan_on_the_megakernel_needs_the_card():
    plan = build_plan(make_pipeline_ops("grayscale,contrast:3.5,emboss:3"), "fused-pallas")
    with pytest.raises(RuntimeError, match="CUDA device"):
        obs_cost.attribute_plan(plan, (16, 16, 3), pallas=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            obs_cost.attribute_plan(plan, (16, 16, 3))  # the default device is CUDA


@pytest.mark.parametrize("spec", ["rot90", "transpose", "crop:1:2:5:6", "pad:3", "resize:20x30",
                                  "scale:0.5", "rotate:30", "equalize", "grayscale,gray2rgb",
                                  "grayscale,otsu", "sepia,grayscale,gaussian:3"])
def test_modeled_shape_is_the_real_shape(spec):
    ops = make_pipeline_ops(spec)
    for shape in [(40, 50, 3), (40, 50)]:
        try:
            want = tuple(Pipeline(ops)(torch.zeros(shape, dtype=torch.uint8)).shape)
        except ValueError:  # a channel count the chain refuses
            continue
        assert obs_cost.modeled_shape(ops, shape) == want, shape


@pytest.mark.parametrize("site", ["wrap_cache_fn", "attribute_plan"])
def test_only_attribute_plan_asks_for_temp_bytes(monkeypatch, site):
    """The cache wrappers measure boundary bytes only (no reset of the
    card's process-wide peak, no synchronisation); attribute_plan asks for
    each stage's temporary bytes."""
    seen = []
    real = obs_cost.measured_call

    def spy(fn, args, *, temp=False):
        seen.append(temp)
        return real(fn, args, temp=temp)

    monkeypatch.setattr(obs_cost, "measured_call", spy)
    led = CostLedger(Registry())
    if site == "wrap_cache_fn":
        wrapped = obs_cost.LazyAttributedFn("bench", "temp-spy", lambda t: t + 1, ledger=led)
        for _ in range(3):
            wrapped(torch.zeros(5, dtype=torch.uint8))
        assert seen == [False]
    else:
        plan = build_plan(make_pipeline_ops("grayscale,gaussian:3,rot90"), "fused")
        rows = obs_cost.attribute_plan(plan, (12, 10, 3), device="cpu", ledger=led)
        assert seen == [True] * len(plan.stages) == [True] * len(rows)
        assert all(r["cost"]["temp_bytes"] is None for r in rows)  # the CPU has no allocator peak
