"""The port's benchmark suite (bench_suite.py), its clock
(utils/timing.device_throughput) and roofline denominator
(obs/cost.peak_gb_s) on the CPU, against the JAX package.

The configs field for field, the modelled bytes of all twelve, the
headline record on a fixed record list and a small config's record keys
equal the JAX suite's, less the TPU-only fields (``tpu_gen``,
``elem_ceiling_frac``; ``hlo_flops`` and, on the CPU, ``hlo_temp_bytes``,
which no compiler counts here). The sharded A/B record's structure is the
JAX test's (timings stubbed). Each lane runs at its JAX test's small size
through its knobs, with that test's assertions, and the lane's outputs on
the lane's seeded images are byte-equal to the JAX package's golden chain
(to which every JAX lane is gated). The lanes that spawn pods
(``fabric_loadgen``, ``systolic_ab``, ``federation_loadgen``) are marked
``slow``, as the JAX package marks its fabric lane. On the CPU the engine and stream lanes
compute in the submitting thread, which the JAX package's idle definition
(a completion-thread wait with nothing dispatched) counts as idle: their
``overlap_won`` is a card measure and is not asserted here.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu import bench_suite as jbs
from mpi_cuda_imagemanipulation_tpu.io.image import synthetic_image as jax_synthetic
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.serve import loadgen as jax_loadgen
from mpi_cuda_imagemanipulation_tpu_torch import bench_suite as bs
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.federation.frontdoor import REROUTE_REASONS
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost
from mpi_cuda_imagemanipulation_tpu_torch.utils import timing

# fails the module if a process it spawned outlives it
from _torch_fabric_procs import no_children_left  # noqa: F401

CPU = torch.device("cpu")
GATE_SHAPES = ((48, 64, 1), (37, 200, 2), (130, 384, 3))
TPU_ONLY = {"tpu_gen", "elem_ceiling_frac", "ceiling_frac", "ceiling_basis"}


def _jax_golden(ops: str, img: np.ndarray) -> np.ndarray:
    return np.asarray(JaxPipeline.parse(ops).jit()(img))


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------
# configs, the traffic model, records
# --------------------------------------------------------------------------


def test_configs_equal_jax_field_for_field():
    assert list(bs.CONFIGS) == list(jbs.CONFIGS)
    for name, cfg in bs.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jbs.CONFIGS[name])
    assert bs.HEADLINE == jbs.HEADLINE == "gaussian5_8k"
    assert bs.REFERENCE_BASELINE_MP_S_PER_CHIP == jbs.REFERENCE_BASELINE_MP_S_PER_CHIP
    assert not bs.ELEM_G_S_MEASURED  # no kernel-class rate measured on a card
    cfg = bs.CONFIGS["gaussian5_8k_sharded_overlap"]
    assert cfg.sharded and cfg.halo_mode == "overlap"
    assert bs.CONFIGS["gaussian5_8k_sharded"].halo_mode == "serial"


@pytest.mark.parametrize("name", list(jbs.CONFIGS))
def test_modeled_bytes_equal_jax(name):
    assert bs.modeled_hbm_bytes(bs.CONFIGS[name]) == jbs.modeled_hbm_bytes(jbs.CONFIGS[name])


def _records():
    base = {"pipeline": "gaussian:5", "height": 4320, "width": 7680, "platform": "gpu"}
    return [
        {**base, "config": "gaussian5_8k", "impl": "torch", "chips": 1,
         "mp_per_s_per_chip": 4200.5, "roofline_frac": 0.011, "tpu_gen": "v5e",
         "device_kind": "NVIDIA H100 80GB HBM3"},
        {**base, "config": "gaussian5_8k", "impl": "cuda", "chips": 1,
         "mp_per_s_per_chip": 69026.44, "roofline_frac": 0.1234567, "tpu_gen": "v5e",
         "device_kind": "NVIDIA H100 80GB HBM3"},
        {**base, "config": "gaussian5_8k_sharded", "impl": "cuda", "chips": 1,
         "mp_per_s_per_chip": 51000.0},
        {**base, "config": "sobel_4k", "impl": "cuda", "chips": 1,
         "mp_per_s_per_chip": 99999.0},
    ]


@pytest.mark.parametrize("drop", [None, 1])
def test_headline_record_equals_jax(drop):
    recs = [r for i, r in enumerate(_records()) if i != drop]
    ours, theirs = bs.headline_record(recs), jbs.headline_record(recs)
    kind, gen = ours.pop("device_kind", None), theirs.pop("tpu_gen", None)
    assert (kind, gen) == (("NVIDIA H100 80GB HBM3", "v5e") if drop is None else (None, None))
    assert ours == theirs
    assert bs.headline_record(recs[3:]) is None is jbs.headline_record(recs[3:])


def test_run_config_torch_record_keys(monkeypatch):
    """A small config at `torch` on the CPU gives the JAX record's keys
    (its `xla` run, timings stubbed) less the fields no compiler counts
    here, plus the clock's."""
    monkeypatch.setattr(jbs, "device_throughput", lambda fn, args, **kw: 0.01)
    jcfg = jbs.BenchConfig("t", "grayscale,contrast:3.5,emboss:3", 40, 64, 3)
    theirs = jbs.run_config(jcfg, "xla")
    ours = bs.run_config(bs.BenchConfig(**dataclasses.asdict(jcfg)), "torch", device="cpu")
    assert set(theirs) - {"hlo_flops", "hlo_temp_bytes"} - TPU_ONLY <= set(ours)
    assert set(ours) - set(theirs) == {"clock", "host_enqueue_ms", "host_bound"}
    assert ours["clock"] == "host" and ours["platform"] == "cpu" and ours["chips"] == 1
    for key in ("config", "pipeline", "height", "width", "hbm_bytes_model"):
        assert ours[key] == theirs[key]
    # the boundary bytes measured: one RGB image in, one gray plane out
    assert ours["hbm_bytes_hlo"] == 40 * 64 * 3 + 40 * 64
    assert ours["ms_per_iter"] > 0 and ours["mp_per_s"] > 0


def test_bench_halo_ab_record_structure(monkeypatch):
    """The sharded A/B record: serial/overlap timings, a per-group
    comms/compute breakdown and comms_hidden_frac (timings stubbed: this
    asserts structure and arithmetic), on 4 CPU slots."""
    fake = {"n": 0}

    def fake_throughput(fn, args, **kw):
        fake["n"] += 1
        fn(*args)  # the exchange and the sharded functions run
        if kw.get("record") is not None:
            kw["record"].update(clock="host", device_ms=None, host_enqueue_ms=1.0,
                                host_bound=None)
        return 0.010 if fake["n"] % 2 else 0.008

    monkeypatch.setattr(bs, "device_throughput", fake_throughput)
    monkeypatch.setenv("MCIM_HALO_AB", "1")
    cfg = bs.BenchConfig("t", "gaussian:5", 64, 96, 1, sharded=True)
    rec = bs.run_config(cfg, "torch", n_shards=4, device="cpu")
    assert rec["halo_mode"] == "serial" and rec["slots"] == 4 and rec["chips"] == 1
    ab = rec["halo_ab"]
    assert set(ab) >= {"serial_ms", "overlap_ms", "per_group", "comms_ms_total",
                       "compute_ms_est", "comms_hidden_frac"}
    assert len(ab["per_group"]) == 1
    g = ab["per_group"][0]
    assert g["ops"] == ["gaussian5"] and g["halo"] == 2
    assert g["comms_ms"] > 0 and "compute_ms_est" in g
    assert 0.0 <= ab["comms_hidden_frac"] <= 1.0
    monkeypatch.setenv("MCIM_HALO_AB", "0")
    assert "halo_ab" not in bs.run_config(cfg, "cuda", n_shards=4, device="cpu")


def test_sharded_config_output_equals_jax_golden():
    """The sharded config's function on 4 CPU slots gives the JAX golden
    chain's bytes, at both impls."""
    img = synthetic_image(64, 96, channels=1, seed=99)
    want = _jax_golden("gaussian:5", img)
    mesh = bs.bench_mesh(4, CPU)
    cfg = bs.BenchConfig("t", "gaussian:5", 64, 96, 1, sharded=True, halo_mode="overlap")
    for impl in ("torch", "cuda"):
        np.testing.assert_array_equal(_host(bs.config_fn(cfg, impl, CPU, mesh)(img)), want)


# --------------------------------------------------------------------------
# the clock and the roofline denominator
# --------------------------------------------------------------------------


def test_device_throughput_host_clock_on_cpu_tensors():
    x = torch.arange(4096, dtype=torch.float32)
    rec = {}
    sec = timing.device_throughput(lambda t: t * 2 + 1, [x], record=rec)
    assert sec > 0 and rec["clock"] == "host" and rec["host_bound"] is None
    assert rec["host_enqueue_ms"] == pytest.approx(sec * 1e3)


def test_device_throughput_raises_without_a_positive_sample(monkeypatch):
    monkeypatch.setattr(timing.time, "perf_counter", lambda: 5.0)
    with pytest.raises(RuntimeError, match="positive"):
        timing.device_throughput(lambda t: t, [torch.zeros(3)])


def test_benchmark_result_on_cpu():
    res = timing.benchmark(lambda t: t + 1, [torch.zeros(64)], name="b", megapixels=2.0,
                           reps=4)
    d = res.as_dict()
    assert d["name"] == "b" and d["reps"] == 4 and d["mp_per_s"] > 0
    assert d["min_ms"] <= d["median_ms"]


def test_peak_gb_s_env_table_and_unknown_kind(monkeypatch):
    monkeypatch.delenv("MCIM_COST_PEAK_GBS", raising=False)
    assert obs_cost.peak_gb_s("NVIDIA H100 80GB HBM3") == 3350.0
    with pytest.raises(ValueError, match="no data-sheet"):
        obs_cost.peak_gb_s("cpu")
    with pytest.raises(ValueError):
        obs_cost.peak_gb_s("TPU v5 lite")
    monkeypatch.setenv("MCIM_COST_PEAK_GBS", "1000")
    assert obs_cost.peak_gb_s("anything") == 1000.0
    assert obs_cost.measured_roofline_frac(2e9, 1.0, kind="anything") == pytest.approx(0.002)
    assert obs_cost.measured_gb_s(4e9, 2.0, chips=2) == pytest.approx(1.0)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def test_main_prints_one_json_line(capsys):
    assert bs.main(["--config", "grayscale_1080p", "--impl", "torch", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["config"] == "grayscale_1080p" and rec["impl"] == "torch"


@pytest.mark.parametrize("cmd,flags", [
    ("bench", ["--configs", "--device", "--impl", "--halo-mode", "--json-metrics"]),
    ("federation", ["--host", "--port", "--registry", "--stale-s", "--shed-frac",
                    "--failpoints", "--trace-out"]),
])
def test_cli_help_has_the_jax_flags(cmd, flags, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in flags:
        assert flag in out, flag
    if cmd == "bench":
        assert "{torch,cuda,swar,mxu,auto,both}" in out


def test_cli_bench_runs_a_lane_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("MCIM_MXU_AB_HEIGHT", "40")
    monkeypatch.setenv("MCIM_MXU_AB_WIDTH", "64")
    assert cli.main(["bench", "--configs", "mxu_ab", "--device", "cpu"]) == 0
    assert "best lane:" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the lanes, at the JAX tests' sizes
# --------------------------------------------------------------------------


def _lane_outputs_equal_jax(lanes: dict, ops: str, channels: int, bench_hw) -> None:
    """Every lane's output on the gate's seeded images and the bench image
    (seed 99) byte-equal to the JAX golden chain."""
    cases = [(h, w, s) for h, w, s in GATE_SHAPES] + [(*bench_hw, 99)]
    for h, w, seed in cases:
        img = synthetic_image(h, w, channels=channels, seed=seed)
        want = _jax_golden(ops, jax_synthetic(h, w, channels=channels, seed=seed))
        for lane, fn in lanes.items():
            np.testing.assert_array_equal(_host(fn(torch.from_numpy(img))), want,
                                          err_msg=f"{lane} at {h}x{w}")


def test_plan_ab_lane_gates_and_saves(monkeypatch):
    monkeypatch.setenv("MCIM_PLAN_AB_HEIGHT", "256")
    monkeypatch.setenv("MCIM_PLAN_AB_WIDTH", "384")
    rec = bs.run_plan_ab(printer=lambda s: None, device="cpu")
    assert rec["bit_exact_gate"].startswith("passed")
    assert rec["hbm_passes_saved_model"] == 3
    for lane in ("off", "per_op", "pointwise", "fused", "fused_pallas"):
        assert "ms_per_iter" in rec["lanes"][lane], rec["lanes"][lane]
    assert rec["lanes"]["fused"]["stages"] == 1
    assert rec["lanes"]["fused_pallas"]["stages"] == 1
    assert rec["lanes"]["off"]["stages"] == 4
    assert rec["speedup_fused_vs_off"] is not None
    assert rec["fused_stage_breakdown"][0]["halo"] == 2
    p = bs.plan_ab_params(CPU)
    lanes, _ = bs.plan_ab_lanes(Pipeline.parse(p["ops"]), CPU)
    _lane_outputs_equal_jax(lanes, p["ops"], 3, (256, 384))


def test_megakernel_ab_lane_gates_and_reports(monkeypatch):
    monkeypatch.setenv("MCIM_MEGAKERNEL_AB_HEIGHT", "128")
    monkeypatch.setenv("MCIM_MEGAKERNEL_AB_WIDTH", "192")
    rec = bs.run_megakernel_ab(printer=lambda s: None, device="cpu")
    assert rec["bit_exact_gate"].startswith("passed")
    assert rec["megakernel_stages"] == 1  # the two-stencil chain is one K4 stage
    assert rec["stage_eligibility"][0]["halo"] == 3
    for lane in ("off", "fused", "fused_pallas"):
        assert "ms_per_iter" in rec["lanes"][lane], rec["lanes"][lane]
    assert rec["speedup_pallas_vs_fused"] is not None and rec["interpret_mode"]
    p = bs.megakernel_ab_params(CPU)
    lanes, _ = bs.megakernel_ab_lanes(Pipeline.parse(p["ops"]), CPU)
    _lane_outputs_equal_jax(lanes, p["ops"], 3, (128, 192))


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke_lanes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_lane_record(name: str) -> dict:
    """A lane record as the card gives it (per-lane `launches`), well
    formed: the base each case of the test below breaks once."""
    k4 = {"ms_per_iter": 0.3, "launches": {"K4": 16}}
    if name == "plan_ab":
        return {"lanes": {"off": {"ms_per_iter": 5.0, "launches": {}}, "fused_pallas": k4},
                "fused_stage_breakdown": [{"ops": "grayscale+gaussian5", "ms_per_iter": 4.3}]}
    if name == "megakernel_ab":
        return {"lanes": {"fused": {"ms_per_iter": 5.7, "launches": {}}, "fused_pallas": k4},
                "stage_eligibility": [{"ops": "a", "halo": 3, "reject": None}],
                "megakernel_stages": 1}
    if name == "mxu_fused_ab":
        return {"lanes": {"fused_vpu": k4,
                          "fused_mxu": {"ms_per_iter": 0.5, "launches": {"K4": 16, "K5-bf16": 16}},
                          "fused_mxu_int8": {"ms_per_iter": 0.4,
                                             "launches": {"K4": 16, "K5-int8": 16}}}}
    return {"bit_identical": True, "memory_ratio": 2.8, "serial": {"peak_resident_bytes": 37},
            "stream": {"peak_resident_bytes": 13}}


def _break_error(rec):
    rec["lanes"]["fused_pallas"] = {"error": "launch failed"}


def _break_stage(rec):
    rec["fused_stage_breakdown"][0] = {"ops": "grayscale+gaussian5", "error": "boom"}


def _break_k4(rec):
    rec["lanes"]["fused_pallas"]["launches"] = {}


def _break_int8(rec):
    rec["lanes"]["fused_mxu_int8"]["launches"] = {"K4": 16}


def _break_fallback(rec):
    rec["stage_eligibility"].append({"ops": "b", "halo": 1, "reject": "smem-budget"})


def _break_memory(rec):
    rec["memory_ratio"] = 0.87


def _break_bytes(rec):
    rec["bit_identical"] = False


@pytest.mark.parametrize("name,breaker", [
    ("plan_ab", None), ("megakernel_ab", None), ("mxu_fused_ab", None), ("stream_ab", None),
    ("plan_ab", _break_error), ("plan_ab", _break_stage), ("plan_ab", _break_k4),
    ("megakernel_ab", _break_k4), ("megakernel_ab", _break_fallback),
    ("mxu_fused_ab", _break_int8), ("stream_ab", _break_memory), ("stream_ab", _break_bytes),
])
def test_chip_smoke_lane_checks_refuse_failed_lanes(name, breaker):
    """chip_smoke's phase-22 lane check passes a well-formed card record and
    refuses one whose lane or stage failed, whose kernel lane launched no
    kernel, whose megakernel stage fell back, or whose stream held as much
    as the whole frame."""
    cs = _chip_smoke()
    rec = _card_lane_record(name)
    if breaker is None:
        cs.check_lane(name, rec)
        return
    breaker(rec)
    with pytest.raises(AssertionError, match=name):
        cs.check_lane(name, rec)


def test_mxu_ab_lane_runs_and_gates(monkeypatch, tmp_path):
    monkeypatch.setenv("MCIM_MXU_AB_HEIGHT", "96")
    monkeypatch.setenv("MCIM_MXU_AB_WIDTH", "128")
    out = tmp_path / "mxu_ab.json"
    rec = bs.run_mxu_ab(json_path=str(out), printer=lambda s: None, device="cpu")
    assert rec["config"] == "mxu_ab"
    assert set(rec["lanes"]) == {"vpu", "mxu", "hybrid"}
    for lane in rec["lanes"].values():
        assert "mp_per_s_per_chip" in lane
    assert rec["best_lane"] in rec["lanes"]
    assert json.loads(out.read_text())["config"] == "mxu_ab"
    p = bs.mxu_ab_params(CPU)
    _lane_outputs_equal_jax(bs.mxu_ab_lanes(Pipeline.parse(p["ops"])), p["ops"], 1, (96, 128))


def test_mxu_fused_ab_lane_runs_and_gates(monkeypatch, tmp_path):
    monkeypatch.setenv("MCIM_MXU_FUSED_AB_HEIGHT", "72")
    monkeypatch.setenv("MCIM_MXU_FUSED_AB_WIDTH", "128")
    out = tmp_path / "mxu_fused_ab.json"
    rec = bs.run_mxu_fused_ab(json_path=str(out), printer=lambda s: None, device="cpu")
    assert rec["config"] == "mxu_fused_ab"
    assert set(rec["lanes"]) == {"off", "fused_vpu", "fused_mxu", "fused_mxu_int8",
                                 "mxu_whole_op"}
    for lane in rec["lanes"].values():
        assert "mp_per_s_per_chip" in lane
    assert rec["best_mxu_lane"] in ("fused_mxu", "fused_mxu_int8")
    assert rec["speedup_fused_mxu_vs_fused_vpu"] is not None
    assert all(a["arm"] == "mxu-int8" for a in rec["stage_arms"].values())
    assert json.loads(out.read_text())["config"] == "mxu_fused_ab"
    p = bs.mxu_fused_ab_params(CPU)
    _lane_outputs_equal_jax(bs.mxu_fused_ab_lanes(Pipeline.parse(p["ops"]), CPU), p["ops"], 1,
                            (72, 128))


def test_engine_ab_lane_outputs_equal_jax():
    outputs = {}
    rec = bs.run_engine_ab(printer=lambda s: None, inflight=2, device="cpu", outputs=outputs)
    assert rec["bit_identical"]
    assert rec["inflight"] == 2
    assert rec["overlap"]["inflight_peak"] <= 2
    assert rec["speedup"] >= 1.2, rec
    for lane in ("serial", "overlap"):
        assert 0.0 <= rec[lane]["device_idle_frac"] <= 1.0
    p = bs.engine_ab_params(CPU)
    assert len(outputs) == p["n_images"]
    for k in range(p["n_images"]):
        img = jax_synthetic(p["height"], p["width"], channels=3, seed=31 + k)
        np.testing.assert_array_equal(outputs[k], _jax_golden(p["ops"], img))


def test_stream_ab_memory_and_outputs_equal_jax(monkeypatch):
    monkeypatch.setenv("MCIM_STREAM_AB_HEIGHT", "768")
    monkeypatch.setenv("MCIM_STREAM_AB_WIDTH", "192")
    monkeypatch.setenv("MCIM_STREAM_AB_TILE_ROWS", "96")
    outputs = {}
    rec = bs.run_stream_ab(printer=lambda s: None, device="cpu", outputs=outputs)
    assert rec["bit_identical"]
    assert rec["memory_ratio"] > 1.0
    assert rec["stream"]["peak_resident_bytes"] > 0
    assert rec["tile_rows"] == 96 and rec["height"] == 768
    for k, got in outputs.items():
        img = jax_synthetic(768, 192, channels=3, seed=100 + k)
        np.testing.assert_array_equal(got, _jax_golden(rec["pipeline"], img))
    assert len(outputs) == rec["n_images"]


def test_graph_loadgen_lane_gate_columns_and_outputs():
    outputs = {}
    rec = bs.run_graph_loadgen(printer=lambda s: None, tenants=2, device="cpu",
                               outputs=outputs)
    assert rec["bit_exact_gate"].startswith("passed")
    for lane in ("chain", "dag"):
        r = rec["lanes"][lane]
        assert r["submitted"] > 0
        assert r["unavailable"] == 0
    assert set(rec["tenants"]) == {"t0", "t1"}
    for tr in rec["tenants"].values():
        assert "ok_frac" in tr and "shed_frac" in tr
    p = bs.graph_loadgen_params(CPU)
    min_dim = max(op.halo for op in Pipeline.parse(p["ops"]).ops) + 1
    images = jax_loadgen.mixed_shapes(p["buckets"], p["n_images"], channels=3, seed=11,
                                      min_dim=min_dim)
    assert len(outputs) == 3
    for k, got in outputs.items():
        np.testing.assert_array_equal(got, _jax_golden(p["ops"], images[k]))


def test_tune_convergence_lane_converges_and_gates(monkeypatch, tmp_path):
    """The lane's control loop on real dispatch timings. On a shared CPU the
    two arms' own times at this size are within the machine's noise of each
    other, so the `plan:off` arm carries a fixed 4 ms floor, as the CPU
    fabric lane carries one per dispatch: the faster arm is then known and
    the loop must find it, through the canary gate and its shadow checks.
    The online store also merges the calibration file's samples, which
    other tests' pods write in the working directory: the test reads a
    file of its own."""
    from mpi_cuda_imagemanipulation_tpu_torch.serve import padded

    monkeypatch.setenv("MCIM_CALIB_FILE", str(tmp_path / "calibration.json"))
    monkeypatch.setenv("MCIM_TUNE_CONV_HEIGHT", "96")
    monkeypatch.setenv("MCIM_TUNE_CONV_WIDTH", "128")
    real = padded.make_serving_fn

    def floored(*args, plan, **kwargs):
        fn = real(*args, plan=plan, **kwargs)
        if plan != "off":
            return fn

        def off(*xs):
            time.sleep(0.004)
            return fn(*xs)
        return off

    monkeypatch.setattr(padded, "make_serving_fn", floored)
    rec = bs.run_tune_convergence(printer=lambda s: None, device="cpu")
    assert rec["bit_exact_gate"].startswith("passed")
    assert rec["tuned_arm"] == "plan:fused"
    assert rec["iters_to_converge"] >= 1 and rec["shadow_checks"] >= 1


# --------------------------------------------------------------------------
# the lanes that spawn pods
# --------------------------------------------------------------------------


@pytest.mark.slow
def test_fabric_loadgen_lane_scales_and_survives_churn(monkeypatch):
    monkeypatch.setenv("MCIM_FABRIC_DURATION_S", "2.0")
    rec = bs.run_fabric_loadgen(printer=lambda s: None, device="cpu")
    assert rec["bit_exact_gate"].startswith("passed")
    churn = rec["lanes"][f"replicas_{rec['replicas']}_churn"]
    assert churn["during"]["unavailable"] == 0
    assert churn["respawned"]
    assert rec["lanes"]["elastic"]["scaled_up"]


@pytest.mark.slow
def test_systolic_ab_lane_gates_and_counts_forwards():
    rec = bs.run_systolic_ab(printer=lambda s: None, device="cpu")
    assert rec["bit_exact_gate"].startswith("passed")
    assert rec["forwards"] == rec["requests_sent"] * rec["stage_boundaries"]
    assert rec["lanes"]["systolic"]["ok_frac"] == rec["lanes"]["pinned"]["ok_frac"] == 1.0


@pytest.mark.slow
def test_federation_loadgen_lane_survives_whole_pod_kill(monkeypatch):
    monkeypatch.setenv("MCIM_FABRIC_REPLICAS", "1")
    t0 = time.monotonic()
    rec = bs.run_federation_loadgen(printer=lambda s: None, device="cpu")
    assert rec["bit_exact_gate"].startswith("passed")
    during = rec["lanes"]["pod_churn"]["during"]
    assert during["unavailable"] == 0 and during["ok"] == during["accepted"]
    assert rec["reroutes"] and set(rec["reroutes"]) <= set(REROUTE_REASONS)
    assert time.monotonic() - t0 < 600
