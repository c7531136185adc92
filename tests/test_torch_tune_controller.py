"""The port's tune controller (tune/controller.py) on the CPU, against the
JAX package.

The controller table of the JAX package's ``tests/test_tune.py`` through
the port, with fake clocks and injected gates and callables (no sockets,
no processes): insufficient data, optimistic exploration, the minimum
gain, promote arithmetic and the fleet hook, a safe-but-slower flip
reverted, the flip timeout, a breach quarantined for good, the
``tune.candidate`` failpoint's corrupting flip, the audit trail and the
status payload. Every scripted sequence also runs through the JAX
package's controller on its own store with the same clock steps: the
decisions, the deployed flips and the audit trails are equal.
"""

from __future__ import annotations

import pytest

from mpi_cuda_imagemanipulation_tpu.fabric import canary as jax_canary
from mpi_cuda_imagemanipulation_tpu.obs import metrics as jax_metrics
from mpi_cuda_imagemanipulation_tpu.resilience import failpoints as jax_failpoints
from mpi_cuda_imagemanipulation_tpu.tune import controller as jax_controller
from mpi_cuda_imagemanipulation_tpu.tune import store as jax_store
from mpi_cuda_imagemanipulation_tpu.utils import calibration as jax_calib
from mpi_cuda_imagemanipulation_tpu_torch.fabric import canary as fabric_canary
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.tune import controller as tune_controller
from mpi_cuda_imagemanipulation_tpu_torch.tune import store as tune_store
from mpi_cuda_imagemanipulation_tpu_torch.tune.controller import (
    DECISIONS,
    TuneConfig,
    TuneController,
    count_decision,
)
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

FP = "cafe0123deadbeef"

_PKGS = {
    "port": dict(canary=fabric_canary, registry=Registry, controller=tune_controller,
                 store=tune_store, failpoints=failpoints),
    "jax": dict(canary=jax_canary, registry=jax_metrics.Registry, controller=jax_controller,
                store=jax_store, failpoints=jax_failpoints),
}


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@pytest.fixture()
def calib_file(tmp_path, monkeypatch):
    path = tmp_path / "calib.json"
    monkeypatch.setenv("MCIM_CALIB_FILE", str(path))
    monkeypatch.delenv("MCIM_NO_CALIB", raising=False)
    monkeypatch.delenv("MCIM_TUNE", raising=False)
    calibration._cache["key"] = None
    jax_calib._cache["key"] = None
    yield path
    calibration._cache["key"] = None
    jax_calib._cache["key"] = None


@pytest.fixture()
def cpu_kind(monkeypatch):
    # no backend is initialised just to name the device
    monkeypatch.setattr(tune_store, "_device_kind", lambda: "cpu")
    monkeypatch.setattr(jax_store, "_device_kind", lambda: "cpu")


def _feed(store, arm, values, width=512, fp=FP):
    for v in values:
        store.record_dispatch(fp, width, arm, v)


def _controller(pkg, store, clock, **cfg_over):
    m = _PKGS[pkg]
    gate = m["canary"].CanaryGate(m["canary"].CanaryConfig(
        frac=0.5, min_requests=2, shadow_every=2, bad_frac=0.5, burn_ratio=2.0,
        promote_requests=4))
    deployed, promoted, reverted = [], [], []

    def deploy(flip):
        deployed.append(flip)
        gate.start("r1", flip)

    cfg = dict(tick_s=0.01, min_samples=3, explore_c=0.35, min_gain=1.05, flip_timeout_s=60)
    cfg.update(cfg_over)
    ctl = m["controller"].TuneController(
        gate=gate, deploy=deploy, pipe_fp=FP, current_arm="plan:off",
        arms=("plan:off", "plan:fused"), registry=m["registry"](),
        on_promote=promoted.append, on_revert=reverted.append, store=store,
        config=m["controller"].TuneConfig(**cfg), clock=clock,
    )
    return ctl, deployed, promoted, reverted


# -- scripted controller histories, each runnable through either package ----


def _script_explore(pkg):
    clock = FakeClock()
    store = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    ctl, deployed, _, _ = _controller(pkg, store, clock)
    out = [ctl.tick()]  # empty store
    _feed(store, "plan:off", [0.010, 0.011, 0.010])
    out += [ctl.tick(), ctl.gate.state, ctl.tick()]
    return out, deployed, store


def _script_min_gain(pkg):
    clock = FakeClock()
    store = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    _feed(store, "plan:off", [0.010] * 4)
    _feed(store, "plan:fused", [0.0099] * 4)  # ~1% faster: churn, not a win
    ctl, deployed, _, _ = _controller(pkg, store, clock, explore_c=0.0)
    out = [ctl.tick(), list(deployed)]
    store2 = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    _feed(store2, "plan:off", [0.015] * 4)
    _feed(store2, "plan:fused", [0.010] * 4)
    ctl2, deployed2, _, _ = _controller(pkg, store2, clock, explore_c=0.0)
    out += [ctl2.tick()]
    return out, deployed2, store2


def _script_promote(pkg):
    clock = FakeClock()
    store = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    _feed(store, "plan:off", [0.015] * 4)
    ctl, deployed, promoted, _ = _controller(pkg, store, clock, explore_c=0.0)
    out = [ctl.tick()]
    for _ in range(4):
        ctl.gate.record("canary", True)
    out.append(ctl.gate.state)
    _feed(store, "plan:fused", [0.010] * 4)
    out += [ctl.tick(), list(promoted), ctl.current_arm, ctl.gate.state]
    ent = store.promoted_entry(FP, device_kind="cpu")
    out += [ent["choice"], ent["width"]]
    return out, deployed, store


def _script_slower(pkg):
    clock = FakeClock()
    store = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    _feed(store, "plan:off", [0.010] * 4)
    ctl, _, promoted, reverted = _controller(pkg, store, clock, explore_c=0.0)
    out = [ctl.tick()]
    for _ in range(4):
        ctl.gate.record("canary", True)
    _feed(store, "plan:fused", [0.011] * 4)  # safe, but a loss
    out += [ctl.tick(), list(promoted), len(reverted),
            store.is_quarantined(FP, "plan:fused"), ctl.current_arm]
    return out, [], store


def _script_timeout(pkg):
    clock = FakeClock()
    store = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    _feed(store, "plan:off", [0.010] * 4)
    ctl, _, _, reverted = _controller(pkg, store, clock, explore_c=0.0, flip_timeout_s=30)
    out = [ctl.tick()]
    for _ in range(4):
        ctl.gate.record("canary", True)  # gate happy, but no measurements
    out.append(ctl.tick())
    clock.advance(31.0)
    out += [ctl.tick(), len(reverted)]
    return out, [], store


def _script_breach(pkg):
    clock = FakeClock()
    store = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    _feed(store, "plan:off", [0.015] * 4)
    _feed(store, "plan:fused", [0.010] * 4)
    ctl, deployed, _, _ = _controller(pkg, store, clock, explore_c=0.0)
    out = [ctl.tick(), ctl.gate.record_shadow(False), ctl.tick(),
           store.is_quarantined(FP, "plan:fused"), ctl.tick(), len(deployed)]
    return out, deployed, store


def _script_poisoned(pkg):
    clock = FakeClock()
    store = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    _feed(store, "plan:off", [0.015] * 4)
    _feed(store, "plan:fused", [0.010] * 4)
    ctl, deployed, _, _ = _controller(pkg, store, clock, explore_c=0.0)
    fp_mod = _PKGS[pkg]["failpoints"]
    fp_mod.configure("tune.candidate=always")
    try:
        out = [ctl.tick()]
    finally:
        fp_mod.clear()
    return out, deployed, store


def _script_audit(pkg):
    clock = FakeClock()
    store = _PKGS[pkg]["store"].OnlineStore(clock=clock)
    ctl, _, _, _ = _controller(pkg, store, clock)
    ctl.tick()
    _feed(store, "plan:off", [0.010] * 4)
    ctl.tick()
    s = ctl.status()
    out = [[e["decision"] for e in store.audit_trail()], s["current_arm"], s["last_decision"],
           s["events"][-1]["decision"]]
    return out, [], store


_SCRIPTS = {
    "explore": _script_explore,
    "min_gain": _script_min_gain,
    "promote": _script_promote,
    "slower": _script_slower,
    "timeout": _script_timeout,
    "breach": _script_breach,
    "poisoned": _script_poisoned,
    "audit": _script_audit,
}


# -- the table, through the port ---------------------------------------------


def test_closed_vocabulary_raises_on_unknown():
    c = Registry().counter("mcim_tune_decisions_total", "t", labels=("decision",))
    for d in DECISIONS:
        count_decision(c, d)
    with pytest.raises(ValueError, match="unknown tune decision"):
        count_decision(c, "yolo-deploy")
    assert DECISIONS == jax_controller.DECISIONS


def test_insufficient_data_then_explore_propose(calib_file, cpu_kind):
    out, deployed, _ = _script_explore("port")
    assert out == ["insufficient_data", "propose", fabric_canary.CANARY, "hold"]
    assert deployed[0] == {"argv": ["--plan", "fused"]}


def test_exploit_requires_min_gain(calib_file, cpu_kind):
    out, deployed2, _ = _script_min_gain("port")
    assert out == ["hold", [], "propose"]
    assert deployed2[0] == {"argv": ["--plan", "fused"]}


def test_promote_arithmetic_and_fleet_hook(calib_file, cpu_kind):
    out, _, _ = _script_promote("port")
    assert out == ["propose", fabric_canary.PROMOTED, "promote",
                   [{"argv": ["--plan", "fused"]}], "plan:fused", fabric_canary.IDLE,
                   "fused", 512]


def test_gate_passed_but_slower_reverts_without_quarantine(calib_file, cpu_kind):
    out, _, _ = _script_slower("port")
    assert out == ["propose", "rollback", [], 1, False, "plan:off"]


def test_flip_timeout_reverts(calib_file, cpu_kind):
    out, _, _ = _script_timeout("port")
    assert out == ["propose", "hold", "rollback", 1]


def test_breach_quarantines_and_never_reproposes(calib_file, cpu_kind):
    out, _, _ = _script_breach("port")
    assert out == ["propose", fabric_canary.ROLLED_BACK, "rollback", True, "hold", 1]


def test_poisoned_candidate_deploys_corrupting_flip(calib_file, cpu_kind):
    out, deployed, _ = _script_poisoned("port")
    assert out == ["propose"]
    assert deployed == [{"argv": ["--ops", "invert"]}]


def test_every_decision_lands_in_audit_trail(calib_file, cpu_kind):
    out, _, _ = _script_audit("port")
    assert out == [["insufficient_data", "propose"], "plan:off", "propose", "propose"]
    assert all(d in DECISIONS for d in out[0])


# -- the same histories through the JAX package's controller -----------------


def _audit(store):
    return [{k: v for k, v in e.items() if k not in ("t", "ts", "unix_s")}
            for e in store.audit_trail()]


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_controller_decisions_equal_jax(name, calib_file, cpu_kind, monkeypatch):
    out, deployed, store = _SCRIPTS[name]("port")
    # the JAX controller on a store file of its own: a quarantine or a
    # promotion the port's run persisted must not steer it
    monkeypatch.setenv("MCIM_CALIB_FILE", str(calib_file.with_name("jax_calib.json")))
    jax_calib._cache["key"] = None
    jout, jdeployed, jstore = _SCRIPTS[name]("jax")
    assert out == jout
    assert deployed == jdeployed
    assert _audit(store) == _audit(jstore)


def test_tune_knobs_read_through_the_registry(monkeypatch):
    monkeypatch.setenv("MCIM_TUNE_MIN_SAMPLES", "11")
    monkeypatch.setenv("MCIM_TUNE_MIN_GAIN", "1.2")
    monkeypatch.setenv("MCIM_TUNE_CANARY_FRAC", "0.25")
    ours = TuneConfig().resolved()
    assert ours == TuneConfig(**vars(jax_controller.TuneConfig().resolved()))
    assert (ours.min_samples, ours.min_gain, ours.canary_frac) == (11.0, 1.2, 0.25)
    ctl = TuneController(gate=fabric_canary.CanaryGate(), deploy=lambda f: None, pipe_fp=FP,
                         current_arm="plan:off", arms=("plan:off",), registry=Registry())
    assert ctl.gate.config.frac == 0.25  # the tuner's own canary slice
