"""The port's randomized differential soak (tools/soak.py) against the JAX
repository's tools/soak.py.

The shared random stream is the JAX soak's: `random_chain`, `random_shape`
and `_crop_for` give the same specs for the same seeds, and a port trial
consumes exactly the draws a JAX trial does (held by comparing the
`random.Random` state after each trial, with the JAX soak's lanes stubbed
so that only its draws run). Port trials on the CPU pass, and each trial's
golden output equals the JAX package's golden ops byte for byte. A
planted fault yields a REPRO line that names its lane, `run_repro` passes
a passing case and fails a failing one, and MCIM_NO_CALIB is set only
while `main` runs.
"""

import importlib
import importlib.util
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.tools import soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_soak():
    """The JAX soak module, loaded under a private name. Its import sets
    MCIM_NO_CALIB; the variable is put back as it was."""
    saved = os.environ.get("MCIM_NO_CALIB")
    spec = importlib.util.spec_from_file_location("_jax_soak", os.path.join(REPO, "tools",
                                                                          "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            os.environ.pop("MCIM_NO_CALIB", None)
        else:
            os.environ["MCIM_NO_CALIB"] = saved
    return mod


@pytest.fixture()
def no_calib(monkeypatch):
    monkeypatch.setenv("MCIM_NO_CALIB", "1")


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2024])
def test_draw_streams_equal_the_jax_soak_s(jax_soak, seed):
    port, ref = random.Random(seed), random.Random(seed)
    for _ in range(25):
        assert soak.random_shape(port) == jax_soak.random_shape(ref)
        assert soak.random_chain(port) == jax_soak.random_chain(ref)
        h, w = port.randint(9, 300), port.randint(9, 300)
        ref.randint(9, 300), ref.randint(9, 300)
        assert soak._crop_for(port, h, w) == jax_soak._crop_for(ref, h, w)
    assert port.getstate() == ref.getstate()
    assert soak._PLANE_SPECS and len(soak._POOL) == len(jax_soak._POOL)


class _StubPipe:
    """Stands for a JAX Pipeline in a draws-only JAX trial: every lane
    returns the same bytes, so the trial makes each of its draws and no
    computation."""

    ONE = np.zeros((1, 1), np.uint8)
    ops = ()

    def __call__(self, img):
        return self.ONE

    def jit(self, *a, **k):
        return self

    def batched(self, *a, **k):
        return lambda imgs: np.stack([self.ONE] * len(imgs))

    def sharded(self, *a, **k):
        return self

    def data_parallel(self, *a, **k):
        return lambda imgs: np.stack([self.ONE] * len(imgs))


def test_a_port_trial_makes_the_jax_trial_s_draws(jax_soak, monkeypatch, no_calib):
    import tools.packed_kernels
    from mpi_cuda_imagemanipulation_tpu.ops import swar_kernels as jax_swar

    stub = _StubPipe()
    monkeypatch.setattr(jax_soak.Pipeline, "parse", classmethod(lambda cls, spec: stub))
    monkeypatch.setattr(jax_soak, "pipeline_pallas", lambda *a, **k: stub.ONE)
    monkeypatch.setattr(jax_soak, "make_mesh", lambda *a, **k: None)
    monkeypatch.setattr(tools.packed_kernels, "pipeline_packed", lambda *a, **k: stub.ONE)
    monkeypatch.setattr(jax_swar, "pipeline_swar", lambda *a, **k: stub.ONE)
    port, ref = random.Random(5), random.Random(5)
    stats: dict = {}
    for _ in range(6):
        seed = port.randint(0, 2**31 - 1)
        assert seed == ref.randint(0, 2**31 - 1)
        assert jax_soak.run_trial(ref, seed, False) is None
        assert soak.run_trial(port, seed, False, stats, device="cpu", slots=8) is None
        assert port.getstate() == ref.getstate()
    assert sum(stats["lanes"].values()) > 0


def test_trials_pass_and_golden_equals_the_jax_golden(no_calib):
    rng = random.Random(3)
    stats: dict = {}
    for _ in range(4):
        seed = rng.randint(0, 2**31 - 1)
        # the trial's own draws, replayed on a copy of the stream
        probe = random.Random()
        probe.setstate(rng.getstate())
        h, w = soak.random_shape(probe)
        spec = soak.random_chain(probe)
        if probe.random() < 0.2:
            spec = soak._crop_for(probe, h, w) + "," + spec
        img = synthetic_image(h, w, channels=3, seed=seed)
        got = Pipeline.parse(spec)(torch.from_numpy(img)).numpy()
        want = np.asarray(JaxPipeline.parse(spec)(jnp.asarray(img)))
        assert got.shape == want.shape and np.array_equal(got, want), spec
        assert soak.run_trial(rng, seed, False, stats, device="cpu", slots=8) is None
    for name in ("xla", "pallas", "plan-fused-pallas", "plan-fused-pallas-mxu", "plan-mxu"):
        assert stats["lanes"][name] == 4


def _flip_one(fn):
    def flipped(*a, **k):
        out = fn(*a, **k).clone()
        out.view(-1)[0] ^= 1
        return out

    return flipped


@pytest.mark.parametrize("lane,attr", [("pallas", "pipeline_cuda"),
                                       ("swar-plane", "pipeline_swar")])
def test_a_planted_fault_names_its_lane(lane, attr, monkeypatch, no_calib, capsys):
    monkeypatch.setattr(soak, attr, _flip_one(getattr(soak, attr)))
    rep = None
    rng = random.Random(11)
    for _ in range(8):  # the swar lane is drawn 40% of trials
        rep = soak.run_trial(rng, rng.randint(0, 2**31 - 1), False, device="cpu", slots=4)
        if rep is not None:
            break
    assert rep is not None and rep["backend"] == lane and "mismatch" in rep["detail"]
    # the REPRO line reproduces on every lane: the planted one fails
    assert soak.run_repro(json.dumps(rep), device="cpu", slots=2) == 1
    assert "MISMATCH" in capsys.readouterr().out


def _spy_swar_ghost(monkeypatch, flip=False):
    """Count the sharded SWAR ghost groups (K6g-K8g) the trials run;
    `flip` plants a one-pixel fault in the first shard's output."""
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    real, calls = api._apply_group_swar, []

    def spy(*a, **k):
        calls.append(a[2])
        out = real(*a, **k)
        if flip:
            out[0] = out[0].clone()
            out[0].view(-1)[0] ^= 1
        return out

    monkeypatch.setattr(api, "_apply_group_swar", spy)
    return calls


@pytest.mark.parametrize("slots", [2, 4])
def test_the_sharded_plane_lane_reaches_the_swar_ghost_path(slots, monkeypatch, no_calib):
    from mpi_cuda_imagemanipulation_tpu_torch.ops.swar_kernels import swar_kind

    calls = _spy_swar_ghost(monkeypatch)
    rng, stats = random.Random(slots), {}
    for _ in range(6):
        assert soak.run_trial(rng, rng.randint(0, 2**31 - 1), False, stats, device="cpu",
                              slots=slots) is None
    assert stats["lanes"]["sharded-swar-plane"] == 6
    # one ghost group a stencil of each trial's plane spec, at least
    assert len(calls) >= 6 and all(swar_kind(op) for op in calls)


@pytest.mark.parametrize("h,w,shards", [(9, 9, 2), (25, 127, 3), (301, 257, 5), (16, 32, 2)])
def test_the_sharded_plane_shape_splits_evenly(h, w, shards):
    gh, gw = soak._sharded_plane_shape(h, w, shards)
    assert gh % shards == 0 and gh // shards >= 8 and gw % 4 == 0 and gw >= 32
    assert gh <= max(h, 8 * shards) and gw <= max(w, 32)


def test_a_planted_swar_ghost_fault_names_the_sharded_plane_lane(monkeypatch, no_calib,
                                                                 capsys):
    _spy_swar_ghost(monkeypatch, flip=True)
    rng = random.Random(11)
    rep = soak.run_trial(rng, rng.randint(0, 2**31 - 1), False, device="cpu", slots=4)
    assert rep is not None and rep["backend"] == "sharded-swar-plane"
    assert rep["sharded_plane_spec"] in soak._SHARDED_PLANE_SPECS
    assert soak.run_repro(json.dumps(rep), device="cpu", slots=2) == 1
    out = capsys.readouterr().out
    assert f"sharded-swar-plane[{rep['sharded_plane_spec']}" in out and "MISMATCH" in out


def test_main_prints_repro_and_leaves_no_calib_unset(monkeypatch, capsys):
    monkeypatch.delenv("MCIM_NO_CALIB", raising=False)
    importlib.reload(soak)  # importing the soak sets nothing
    assert "MCIM_NO_CALIB" not in os.environ
    seen = []
    real = soak.pipeline_cuda

    def spy(*a, **k):
        seen.append(os.environ.get("MCIM_NO_CALIB"))
        return _flip_one(real)(*a, **k)

    monkeypatch.setattr(soak, "pipeline_cuda", spy)
    assert soak.main(["--device", "cpu", "--iters", "1", "--slots", "2", "--seed", "4"]) == 1
    assert seen == ["1"] and "MCIM_NO_CALIB" not in os.environ
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("REPRO "))
    assert json.loads(line[len("REPRO "):])["backend"] == "pallas"
    assert "soak done: 1 trials, 1 failures" in out
    lanes = json.loads(out.split("soak lanes: ", 1)[1].splitlines()[0])
    # every lane is reported, the batched, 2-D and data-parallel ones too,
    # and none is skipped
    assert lanes["lanes"]["xla"] == 1 and set(lanes) == {"lanes"}
    assert set(lanes["lanes"]) == set(soak.LANES) >= {"batched-torch", "batched-cuda",
                                                      "sharded2d", "data-parallel"}


def test_run_repro_passes_a_passing_case(no_calib, capsys):
    line = json.dumps({"spec": "grayscale,gaussian:5,sharpen", "h": 41, "w": 64, "seed": 9,
                       "backend": "pallas", "detail": "", "block_h": 32,
                       "plane_spec": "contrast:3.5,emboss:3", "plane_block_h": 16})
    assert soak.run_repro(line, device="cpu", slots=3) == 0
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and "RAISED" not in out
    for name in ("pallas[bh=32]", "swar-plane", "sharded-3-swar", "plan-fused-pallas-mxu",
                 "plan-sharded-3-fused-pallas-overlap", "batched-torch[2]: ok",
                 "batched-cuda[0]: ok", "dp[2]: ok"):
        assert name in out
    assert "skipped (not in the port yet)" not in out


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        soak.main(["--iters", "1"])
