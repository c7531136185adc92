"""The port's online tuning store (tune/store.py, tune/metrics.py) against
the JAX package's, and `plan='auto'` following its newest-wins rule.

The same OnlineStore calls, on a fixed clock and device kind, flush the
same JSON into the calibration file in both packages and answer the same
queries. `effective_plan_choice` picks the newer of an offline
``plan_choice`` record and an online ``promoted`` one, as the JAX package's
does, counting an override where they disagree, and
`plan/planner.resolve_plan_mode` follows it (the walker modes stay refused
under the kernel-only backends). `autotune info --online` reports the
online side.

Every test points MCIM_CALIB_FILE at its own tmp_path store and resets
both packages' process-wide online stores.
"""

import json

import pytest

from mpi_cuda_imagemanipulation_tpu.ops.registry import make_pipeline_ops as jax_make_ops
from mpi_cuda_imagemanipulation_tpu.plan.ir import pipeline_fingerprint as jax_fingerprint
from mpi_cuda_imagemanipulation_tpu.plan.planner import resolve_plan_mode as jax_resolve
from mpi_cuda_imagemanipulation_tpu.tune import metrics as jax_tune_metrics
from mpi_cuda_imagemanipulation_tpu.tune import store as jax_store
from mpi_cuda_imagemanipulation_tpu.utils import calibration as jax_calib
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (
    REFERENCE_PIPELINE_SPEC,
    make_pipeline_ops,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan import pipeline_fingerprint
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import resolve_plan_mode
from mpi_cuda_imagemanipulation_tpu_torch.tune import metrics as tune_metrics
from mpi_cuda_imagemanipulation_tpu_torch.tune import store
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

KIND = "NVIDIA H100 80GB HBM3"
FP = "fp-test"


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _reset_caches():
    calibration._cache["key"] = None
    jax_calib._cache["key"] = None


@pytest.fixture()
def calib_file(tmp_path, monkeypatch):
    path = tmp_path / "calib.json"
    monkeypatch.setenv("MCIM_CALIB_FILE", str(path))
    for name in ("MCIM_NO_CALIB", "MCIM_TUNE", "MCIM_PLAN", "MCIM_TUNE_STALE_S",
                 "MCIM_TUNE_RESERVOIR", "MCIM_TUNE_FLUSH_S"):
        monkeypatch.delenv(name, raising=False)
    _reset_caches()
    store.online_store.reset()
    jax_store.online_store.reset()
    yield path
    store.online_store.reset()
    jax_store.online_store.reset()
    _reset_caches()


def test_names_and_metric_family_are_the_jax_package_s():
    for name in ("_ENV_TUNE", "_ENV_STALE_S", "_ENV_RESERVOIR", "_ENV_FLUSH_S", "_ONLINE_KEY",
                 "_AUDIT_KEY", "_AUDIT_CAP"):
        assert getattr(store, name) == getattr(jax_store, name)
    for w in (1, 2, 3, 500, 512, 1023, 1024, 7680):
        assert store.width_window(w) == jax_store.width_window(w)
    port, ref = tune_metrics.TuneMetrics(), jax_tune_metrics.TuneMetrics()
    assert port.registry.render() == ref.registry.render()
    assert port.snapshot() == ref.snapshot()


def _story(mod, path, monkeypatch):
    """One run of OnlineStore calls of `mod` on a fixed clock and kind, flushed
    into `path`; returns the file and every query's answer."""
    monkeypatch.setenv("MCIM_CALIB_FILE", str(path))
    monkeypatch.setenv("MCIM_TUNE", "1")
    monkeypatch.setenv("MCIM_TUNE_RESERVOIR", "5")
    monkeypatch.setenv("MCIM_TUNE_STALE_S", "100")
    monkeypatch.setenv("MCIM_TUNE_FLUSH_S", "10")
    monkeypatch.setattr(mod, "_device_kind", lambda: KIND)
    metrics_mod = mod.tune_metrics
    before = metrics_mod.snapshot()
    clock = FakeClock()
    s = mod.OnlineStore(clock=clock)
    for i in range(8):
        s.record_dispatch(FP, 7680, "plan:off", 0.0004 + i * 1e-6)
        s.record_dispatch(FP, 500, "plan:fused-pallas", 0.0003)  # same t: bumped 1 ms
        clock.t += 0.5
    s.record_io_scale("planfp", "s0/fused", 1.7)
    s.audit("explore", arm="plan:off", gain=None, n=3)
    s.quarantine(FP, "plan:fused", "digest mismatch")
    s.promote(FP, 7680, "fused-pallas-mxu")
    clock.t += 20
    s.record_dispatch(FP, 7680, "plan:fused-pallas-mxu", 0.00025)
    s.audit("promote", arm="plan:fused-pallas-mxu")
    s.flush(force=True)
    with open(path) as f:
        data = json.load(f)
    fresh = mod.OnlineStore(clock=clock)  # reads the file only
    clock.t += 150
    answers = {
        "windows": fresh.windows(FP),
        "arm_stats": {w: fresh.arm_stats(FP, w) for w in ("256", "4096")},
        "promoted": fresh.promoted_entry(FP, width=7680),
        "promoted_far": fresh.promoted_entry(FP, width=100),
        "quarantined": [fresh.is_quarantined(FP, a) for a in ("plan:fused", "plan:off")],
        "io_scale": fresh.io_scale("planfp", "s0/fused"),
        "audit": fresh.audit_trail(),
        "persisted_io": mod.persisted_io_scale("planfp", "s0/fused"),
    }
    after = metrics_mod.snapshot()
    return data, answers, {k: after[k] - before[k] for k in after}


def test_online_store_flushes_the_jax_package_s_json(calib_file, tmp_path, monkeypatch):
    port = _story(store, tmp_path / "port.json", monkeypatch)
    _reset_caches()
    ref = _story(jax_store, tmp_path / "jax.json", monkeypatch)
    assert port == ref
    data, answers, deltas = port
    assert list(data["online"]) == [KIND]
    assert answers["promoted"]["choice"] == "fused-pallas-mxu"
    assert answers["promoted_far"] is None
    assert answers["quarantined"] == [True, False]
    assert deltas["observations_dispatch"] == 17 and deltas["quarantined"] == 1


def test_observations_persist_only_when_armed(calib_file):
    s = store.OnlineStore(clock=FakeClock())
    s._kind = "cpu"
    s.record_dispatch(FP, 512, "plan:off", 0.01)
    assert s.flush() is None and not calib_file.exists()
    with pytest.raises(ValueError, match="unknown plan choice"):
        s.promote(FP, 512, "fused-palas")


def _write_store(path, offline, online, width_off=7680, width_on=7680, fp=FP, kind=KIND):
    data = {}
    if offline is not None:
        ent = {"choice": offline[0], "width": width_off}
        if offline[1] is not None:
            ent["recorded_at"] = offline[1]
        data["device_kinds"] = {kind: {"plan_choice": {fp: ent}}}
    if online is not None:
        data["online"] = {kind: {"promoted": {fp: {"choice": online[0], "width": width_on,
                                                   "at": online[1]}}}}
    path.write_text(json.dumps(data))
    _reset_caches()


# (offline (choice, recorded_at), online (choice, at), query width) -> (choice, override)
NEWEST_WINS = [
    (None, None, 7680, None, 0),
    (("fused-pallas", 10.0), None, 7680, "fused-pallas", 0),
    (None, ("fused-pallas-mxu", 10.0), 7680, "fused-pallas-mxu", 0),
    (("fused-pallas", 10.0), ("fused-pallas", 20.0), 7680, "fused-pallas", 0),
    (("fused-pallas", 10.0), ("fused-pallas-mxu", 20.0), 7680, "fused-pallas-mxu", 1),
    (("fused-pallas", 30.0), ("fused-pallas-mxu", 20.0), 7680, "fused-pallas", 1),
    (("fused-pallas", 20.0), ("off", 20.0), 7680, "off", 1),  # a tie goes online
    (("fused-pallas", None), ("off", 1.0), 7680, "off", 1),  # no stamp sorts oldest
    (("fused-pallas", 10.0), ("fused-pallas-mxu", 20.0), 100, None, 0),  # out of window
    (("fused-pallas", 10.0), ("fused-pallas-mxu", 20.0), 5000, "fused-pallas-mxu", 1),
]


@pytest.mark.parametrize("offline,online,width,want,overrides", NEWEST_WINS)
def test_effective_plan_choice_newest_wins_as_the_jax_package_s(
        calib_file, offline, online, width, want, overrides):
    _write_store(calib_file, offline, online)
    before = (store.tune_metrics.stale_overrides.value(),
              jax_store.tune_metrics.stale_overrides.value())
    got = store.effective_plan_choice(FP, device_kind=KIND, width=width)
    ref = jax_store.effective_plan_choice(FP, device_kind=KIND, width=width)
    assert got == ref == want
    assert store.tune_metrics.stale_overrides.value() - before[0] == overrides
    assert jax_store.tune_metrics.stale_overrides.value() - before[1] == overrides
    # another kind's records never apply, and the kill switch turns both off
    assert store.effective_plan_choice(FP, device_kind="TPU v5 lite", width=width) is None


def test_kill_switch_and_no_fingerprint(calib_file, monkeypatch):
    _write_store(calib_file, ("fused-pallas", 10.0), ("off", 20.0))
    assert store.effective_plan_choice(None, device_kind=KIND) is None
    monkeypatch.setenv("MCIM_NO_CALIB", "1")
    assert store.effective_plan_choice(FP, device_kind=KIND) is None


# (offline, online) choices under the kind 'cpu' -> the mode each backend
# resolves, and what the JAX package's 'auto' backend resolves: it follows a
# walker mode that the port's kernel-only backends refuse on purpose
RESOLVE = [
    (None, None, {"cuda": "off", "auto": "off", "torch": "fused", "mxu": "fused"}, "off"),
    (("fused-pallas", 10.0), ("fused-pallas-mxu", 20.0),
     {"cuda": "fused-pallas-mxu", "auto": "fused-pallas-mxu", "torch": "fused-pallas-mxu"},
     "fused-pallas-mxu"),
    (("fused-pallas-mxu", 30.0), ("off", 20.0), {"cuda": "fused-pallas-mxu"},
     "fused-pallas-mxu"),
    (("off", 10.0), ("fused", 20.0), {"cuda": "off", "auto": "off", "torch": "fused"}, "fused"),
    (("pointwise", 30.0), ("fused-pallas", 20.0), {"cuda": "off", "torch": "pointwise"},
     "pointwise"),
]


@pytest.mark.parametrize("offline,online,want,jax_auto", RESOLVE)
def test_resolve_plan_mode_follows_the_newest_record(calib_file, offline, online, want,
                                                     jax_auto):
    ops = make_pipeline_ops(REFERENCE_PIPELINE_SPEC)
    fp = pipeline_fingerprint(ops)
    assert fp == jax_fingerprint(jax_make_ops(REFERENCE_PIPELINE_SPEC))
    _write_store(calib_file, offline, online, fp=fp, kind="cpu")
    for backend, mode in want.items():
        assert resolve_plan_mode(ops, "auto", backend=backend, width=7680, device="cpu") == mode
    jax_ops = jax_make_ops(REFERENCE_PIPELINE_SPEC)
    assert jax_resolve(jax_ops, "auto", backend="auto", width=7680) == jax_auto


def test_mcim_plan_wins_over_every_record(calib_file, monkeypatch):
    ops = make_pipeline_ops(REFERENCE_PIPELINE_SPEC)
    _write_store(calib_file, ("fused-pallas", 10.0), ("fused-pallas-mxu", 20.0),
                 fp=pipeline_fingerprint(ops), kind="cpu")
    monkeypatch.setenv("MCIM_PLAN", "off")
    assert resolve_plan_mode(ops, "auto", backend="cuda", width=7680, device="cpu") == "off"


def test_autotune_info_online_reports_both_sides(calib_file, capsys):
    ops = make_pipeline_ops("gaussian:5")
    fp = pipeline_fingerprint(ops)
    _write_store(calib_file, ("fused-pallas", 10.0), ("fused-pallas-mxu", 20.0), fp=fp,
                 kind="cpu")
    data = json.loads(calib_file.read_text())
    data["online"]["cpu"]["obs"] = {fp: {"4096": {"plan:off": {"samples": [[15.0, 0.001]]}}}}
    data["tune_audit"] = [{"t": 15.0, "decision": "explore"}]
    calib_file.write_text(json.dumps(data))
    _reset_caches()
    assert cli.main(["autotune", "info", "--ops", "gaussian:5", "--device", "cpu"]) == 0
    plain = json.loads(capsys.readouterr().out)
    assert "online" not in plain and plain["plan_choice"]["choice"] == "fused-pallas"
    assert cli.main(["autotune", "info", "--online", "--ops", "gaussian:5",
                     "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["online"]["promoted"]["choice"] == "fused-pallas-mxu"
    assert set(rep["online"]["observations"]) == {"4096"}
    assert rep["online"]["audit_tail"] == [{"t": 15.0, "decision": "explore"}]
    assert rep["effective"] == {"plan_choice": "fused-pallas-mxu"}
