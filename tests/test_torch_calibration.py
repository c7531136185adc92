"""The port's calibration store (utils/calibration.py) and its `autotune`
command, against the JAX package's store.

The JAX package's test_calibration cases run against the port: round
trip, per-impl entries, missing and corrupt stores, the kill switch and
bounds, the width window. One file serves both packages: a record written
by either package's `record_*` reads back the same through the other's
`lookup_*` for the same device kind. `autotune --allow-cpu` on the CPU
(64x128-class images) writes the store for each dimension, `--dry-run`
writes nothing, bad `--blocks` are refused before any measurement, the
caller's environment is restored, a lane that differs from golden refuses
the record, and a CPU device is refused without `--allow-cpu`. A recorded
tile height that a launch cannot take falls back to the default tile.

Every test points MCIM_CALIB_FILE at its own tmp_path store.
"""

import json

import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.utils import calibration as jax_calib
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

KIND = "NVIDIA H100 80GB HBM3"
SMALL = ["--device", "cpu", "--allow-cpu", "--height", "64", "--width", "128"]


@pytest.fixture()
def calib_file(tmp_path, monkeypatch):
    path = tmp_path / "calib.json"
    monkeypatch.setenv("MCIM_CALIB_FILE", str(path))
    monkeypatch.delenv("MCIM_NO_CALIB", raising=False)
    calibration._cache["key"] = None
    jax_calib._cache["key"] = None
    yield path
    calibration._cache["key"] = None
    jax_calib._cache["key"] = None


# --------------------------------------------------------------------------
# The store: the JAX package's cases against the port
# --------------------------------------------------------------------------


def test_record_lookup_roundtrip(calib_file):
    p = calibration.record_block_h(KIND, 32, mp_per_s=47000.0)
    assert p == str(calib_file)
    assert calibration.lookup_block_h(KIND) == 32
    calibration.record_block_h("cpu", 64)  # other kinds are kept on rewrite
    assert calibration.lookup_block_h(KIND) == 32
    assert calibration.lookup_block_h("cpu") == 64
    data = json.loads(calib_file.read_text())
    assert data["device_kinds"][KIND]["cuda"] == {"block_h": 32, "mp_per_s": 47000.0}


def test_per_impl_entries_are_independent(calib_file):
    calibration.record_block_h(KIND, 48, impl="cuda")
    calibration.record_block_h(KIND, 16, impl="swar")
    assert calibration.lookup_block_h(KIND, impl="cuda") == 48
    assert calibration.lookup_block_h(KIND, impl="swar") == 16
    assert calibration.lookup_block_h(KIND) == 48  # the default impl is K2's


def test_lookup_missing_and_corrupt(calib_file):
    assert calibration.lookup_block_h("cpu") is None  # no file yet
    assert calibration.entries() == {} and calibration.raw_store() == {}
    calib_file.write_text("{not json")
    calibration._cache["key"] = None
    assert calibration.lookup_block_h("cpu") is None
    calibration.record_block_h("cpu", 96)  # a record over a corrupt store rewrites it
    assert calibration.lookup_block_h("cpu") == 96
    calib_file.write_text("[1, 2]")  # valid JSON, not a store
    calibration._cache["key"] = None
    assert calibration.entries() == {}


def test_kill_switch_and_bounds(calib_file, monkeypatch):
    calibration.record_block_h("cpu", 128)
    calibration.record_plan_choice("cpu", "fp", "fused-pallas")
    monkeypatch.setenv("MCIM_NO_CALIB", "1")
    assert calibration.lookup_block_h("cpu") is None
    assert calibration.lookup_plan_choice("fp", "cpu") is None
    assert calibration.plan_entry("fp", "cpu") is None
    monkeypatch.delenv("MCIM_NO_CALIB")
    assert calibration.lookup_block_h("cpu") == 128
    for bad in (4, 5000):  # out-of-range heights are rejected, not clamped
        calibration.record_block_h("cpu", bad)
        assert calibration.lookup_block_h("cpu") is None


def test_lookup_width_window(calib_file):
    calibration.record_block_h(KIND, 48, width=7680)
    for w in (7680, 3840, 15360):
        assert calibration.lookup_block_h(KIND, width=w) == 48
    for w in (1920, 3839, 15361, 40000):  # an 8K record does not steer 1080x1920
        assert calibration.lookup_block_h(KIND, width=w) is None
    assert calibration.lookup_block_h(KIND) == 48  # a caller with no width
    calibration.record_block_h("cpu", 96)  # a record with no width applies to all
    assert calibration.lookup_block_h("cpu", width=1024) == 96
    calibration.record_backend_choice(KIND, "sep5", "mxu", width=7680)
    assert calibration.lookup_backend_choice("sep5", KIND, width=1920) is None
    assert calibration.lookup_backend_choice("sep5", KIND, width=7680) == "mxu"


@pytest.mark.parametrize("table,record,lookup,choices", [
    ("backend_choice", "record_backend_choice", "lookup_backend_choice",
     ("vpu", "mxu", "hybrid")),
    ("stage_arm", "record_stage_arm", "lookup_stage_arm", ("vpu", "mxu", "mxu-int8")),
    ("plan_choice", "record_plan_choice", "lookup_plan_choice",
     ("off", "pointwise", "fused", "fused-pallas", "fused-pallas-mxu")),
])
def test_choice_tables(calib_file, table, record, lookup, choices):
    assert getattr(calibration, lookup)("k", KIND) is None
    assert getattr(calibration, lookup)(None, KIND) is None
    for choice in choices:
        getattr(calibration, record)(KIND, "k", choice, width=7680)
        assert getattr(calibration, lookup)("k", KIND, width=7680) == choice
    with pytest.raises(ValueError, match="unknown"):
        getattr(calibration, record)(KIND, "k", "warp-speed")
    data = calibration.raw_store()
    data["device_kinds"][KIND][table]["k"]["choice"] = "warp-speed"
    calibration.write_raw_store(data)
    assert getattr(calibration, lookup)("k", KIND) is None  # an unknown choice is ignored


def test_plan_entry_stamps_and_raw_store_is_a_copy(calib_file):
    calibration.record_plan_choice(KIND, "fp", "fused-pallas", width=7680)
    ent = calibration.plan_entry("fp", KIND, width=7680)
    assert ent["choice"] == "fused-pallas" and ent["recorded_at"] > 0
    calibration.record_plan_choice(KIND, "fp2", "off", recorded_at=1.0)
    assert calibration.plan_entry("fp2", KIND)["recorded_at"] == 1.0
    raw = calibration.raw_store()
    raw["device_kinds"].clear()
    assert calibration.plan_entry("fp", KIND) is not None
    calibration.record_stage_arm(KIND, "sep5", "mxu-int8")
    assert calibration.stage_arm_entries(KIND) == {"sep5": {"choice": "mxu-int8"}}
    assert calibration.stage_arm_entries("cpu") == {}


def test_current_device_kind_on_the_cpu():
    assert calibration.current_device_kind("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert calibration.current_device_kind() == "cpu"


# --------------------------------------------------------------------------
# One store, two packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("table", ["block_h", "backend_choice", "stage_arm", "plan_choice"])
def test_one_store_reads_alike_in_both_packages(calib_file, writer, table):
    w = calibration if writer == "port" else jax_calib
    cases = {
        "block_h": ("record_block_h", "lookup_block_h", [(KIND, 48), ("cpu", 16)]),
        "backend_choice": ("record_backend_choice", "lookup_backend_choice",
                           [(KIND, "sep5", "hybrid"), (KIND, "corr3x3", "vpu")]),
        "stage_arm": ("record_stage_arm", "lookup_stage_arm",
                      [(KIND, "sep5", "mxu-int8"), (KIND, "grad3x3", "mxu")]),
        "plan_choice": ("record_plan_choice", "lookup_plan_choice",
                        [(KIND, "fp1", "fused-pallas-mxu"), ("cpu", "fp2", "off")]),
    }
    record, lookup, rows = cases[table]
    for row in rows:
        if table == "block_h":
            getattr(w, record)(row[0], row[1], impl="cuda", width=7680)
        else:
            getattr(w, record)(*row, width=7680)
    for width in (None, 7680, 1920):
        for row in rows:
            if table == "block_h":
                got = calibration.lookup_block_h(row[0], impl="cuda", width=width)
                want = jax_calib.lookup_block_h(row[0], impl="cuda", width=width)
            else:
                got = getattr(calibration, lookup)(row[1], row[0], width=width)
                want = getattr(jax_calib, lookup)(row[1], row[0], width=width)
            assert got == want
            assert (got is None) == (width == 1920)
    assert calibration.entries() == jax_calib.entries()


def test_plan_entry_reads_alike(calib_file):
    jax_calib.record_plan_choice(KIND, "fp", "fused-pallas", width=7680)
    assert calibration.plan_entry("fp", KIND, 7680) == jax_calib.plan_entry("fp", KIND, 7680)


# --------------------------------------------------------------------------
# A recorded tile height that does not fit falls back to the default tile
# --------------------------------------------------------------------------


def test_k2_calibrated_height_fits_or_falls_back():
    args = (1080, 1920, 3, 1, 2, 2, 2)  # h, w, c_in, c_out, halo, family, n_ops
    default = ck.stencil_launch_shape(*args, None)
    assert default[0] == ck.DEFAULT_TILE_H
    assert ck.stencil_launch_shape(*args, None, (32, 3))[0] == 32
    assert ck.stencil_launch_shape(*args, None, (32, None))[0] == 32  # no channels: any
    assert ck.stencil_launch_shape(*args, None, (32, 1)) == default  # taken on gray planes
    assert ck.stencil_launch_shape(*args, 24, (32, 3))[0] == 24  # an explicit tile wins
    with pytest.raises(ValueError):
        ck.stencil_launch_shape(*args, 4096)  # too tall for the shared memory
    assert ck.stencil_launch_shape(*args, None, (4096, 3)) == default
    assert ck.stencil_launch_shape(70000, 8, 1, 1, 1, 0, 0, None, (1, 1)) == \
        ck.stencil_launch_shape(70000, 8, 1, 1, 1, 0, 0, None)  # a grid too tall


def test_swar_calibrated_height_fits_or_falls_back():
    group = sk.swar_group(make_op("gaussian:5"))
    default = group.shape(1080, 1920, None)
    assert group.shape(1080, 1920, None, (16, 1))[0] == 16
    assert group.shape(1080, 1920, None, (16, None))[0] == 16
    assert group.shape(1080, 1920, None, (16, 3)) == default  # not taken on a gray plane
    assert group.shape(1080, 1920, None, (100000, 1)) == default
    with pytest.raises(ValueError):
        group.shape(1080, 1920, 100000)


def _spy_launch_shape(monkeypatch) -> list:
    """(tile_h, calibrated) of every K2 launch shape asked for."""
    seen = []
    real = ck.stencil_launch_shape

    def spy(*a):
        seen.append(tuple((a + (None, None))[7:9]))
        return real(*a)

    monkeypatch.setattr(ck, "stencil_launch_shape", spy)
    return seen


def test_run_uses_a_fitting_k2_record_and_never_fails_on_one(calib_file, monkeypatch):
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    seen = _spy_launch_shape(monkeypatch)
    img = synthetic_image(40, 128, channels=1, seed=3)
    want = Pipeline.parse("gaussian:5")(torch.from_numpy(img))
    for rec in (24, 4096):  # 4096 rows do not fit the shared memory: the default tile
        calibration.record_block_h("cpu", rec, impl="cuda", width=128, channels=1)
        for backend in ("cuda", "auto"):
            seen.clear()
            got = Pipeline.parse("gaussian:5").jit(backend, device="cpu")(img)
            assert torch.equal(got, want)
            assert seen[0] == (None, (rec, 1))
    seen.clear()
    Pipeline.parse("gaussian:5").jit("cuda", 8, device="cpu")(img)
    assert seen == [(8, None)]  # --block wins over the record


# --------------------------------------------------------------------------
# autotune
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dimension,impl,ops,table", [
    ("block", "cuda", "gaussian:5", "cuda"),
    ("block", "swar", "gaussian:5", "swar"),
    ("block", "cuda", "grayscale,contrast:3.5,emboss:3", "cuda"),
    ("backend", "cuda", "gaussian:5,emboss:3,sharpen", "backend_choice"),
    ("plan", "cuda", "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", "plan_choice"),
    ("plan", "cuda", "gaussian:5", "plan_choice"),
])
def test_autotune_writes_the_store(calib_file, dimension, impl, ops, table, capsys):
    rc = cli.main(["autotune", "--dimension", dimension, "--impl", impl, "--ops", ops,
                   "--json-metrics", "-", *SMALL])
    assert rc == 0
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["device_kind"] == "cpu" and rec["clock"] == "host" and rec["width"] == 128
    kind_rec = json.loads(calib_file.read_text())["device_kinds"]["cpu"]
    assert table in kind_rec
    if dimension == "block":
        assert kind_rec[impl]["block_h"] == rec["block_h"]
        assert calibration.lookup_block_h("cpu", impl=impl, width=128) == rec["block_h"]
    elif dimension == "backend":
        assert set(kind_rec[table]) == {"sep5", "corr3x3"}  # emboss:3 and sharpen share one
        for fam in rec["families"]:
            assert set(fam["ms"]) == {"vpu", "mxu", "hybrid"}
            assert fam["choice"] == min(fam["ms"], key=fam["ms"].get)
    else:
        assert set(rec["ms"]) == set(cli.AUTOTUNE_PLANS)
        assert calibration.lookup_plan_choice(rec["pipeline_fp"], "cpu", 128) == rec["choice"]


@pytest.mark.parametrize("impl,ops,channels", [
    ("cuda", "gaussian:5", 3), ("cuda", "contrast:3.5,gaussian:5", 1),
    ("cuda", "grayscale,gaussian:5", 3), ("swar", "gaussian:5", 1),
    ("swar", "grayscale,gaussian:5", 1),
])
def test_autotune_block_records_the_channels_it_applies_to(calib_file, impl, ops, channels):
    assert cli.main(["autotune", "--impl", impl, "--ops", ops, "--blocks", "8", *SMALL]) == 0
    rec = calibration.block_entry("cpu", impl=impl, width=128)
    assert rec["channels"] == channels and rec["pipeline"] == ops


def test_a_block_record_steers_only_launches_on_its_channels(calib_file, monkeypatch):
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    calibration.record_block_h("cpu", 32, impl="cuda", width=128, channels=1)
    rows = []  # (channels read, tile rows) of each K2 launch
    real = ck.stencil_launch_shape

    def spy(*a):
        out = real(*a)
        if len(a) == 9:  # the wrapper's call, not the fit check inside
            rows.append((a[2], out[0]))
        return out

    monkeypatch.setattr(ck, "stencil_launch_shape", spy)
    rgb = synthetic_image(40, 128, channels=3, seed=4)
    want = Pipeline.parse("grayscale,gaussian:5,sharpen")(torch.from_numpy(rgb))
    got = Pipeline.parse("grayscale,gaussian:5,sharpen").jit("cuda", device="cpu")(rgb)
    assert torch.equal(got, want)
    # the first K2 reads RGB (the default tile), the second the gray plane
    assert rows == [(3, ck.DEFAULT_TILE_H), (1, 32)]


def test_autotune_records_the_fastest_lane(calib_file, monkeypatch):
    times = iter([5.0, 9.0, 1.0, 7.0])  # default, 8, 16, 32
    monkeypatch.setattr(cli, "_lane_ms", lambda fn, device: next(times))
    assert cli.main(["autotune", "--blocks", "8,16,32", *SMALL]) == 0
    assert calibration.lookup_block_h("cpu", impl="cuda") == 16
    times = iter([0.5, 9.0])  # the default wins: its own height is recorded
    assert cli.main(["autotune", "--blocks", "8", *SMALL]) == 0
    assert calibration.lookup_block_h("cpu", impl="cuda") == ck.DEFAULT_TILE_H


def test_autotune_skips_heights_a_launch_cannot_take(calib_file, capsys):
    assert cli.main(["autotune", "--blocks", "4000,8", *SMALL]) == 0
    out = capsys.readouterr().out
    assert "4000: skipped" in out
    assert "default:" in out  # the default tile is always measured
    assert cli.main(["autotune", "--blocks", "4000", "--dry-run", *SMALL]) == 0
    assert "<- fastest" in capsys.readouterr().out  # the default alone


def test_autotune_dry_run_writes_nothing(calib_file):
    for dim in ("block", "backend", "plan"):
        assert cli.main(["autotune", "--dimension", dim, "--dry-run", *SMALL]) == 0
    assert not calib_file.exists()


@pytest.mark.parametrize("blocks", ["16,x", "16,,1.5", " , ", "0,16"])
def test_autotune_rejects_bad_blocks_before_measuring(calib_file, monkeypatch, capsys, blocks):
    calls = []
    monkeypatch.setattr(cli, "_lane_ms", lambda *a: calls.append(1) or 1.0)
    assert cli.main(["autotune", "--blocks", blocks, *SMALL]) == 2
    assert "--blocks" in capsys.readouterr().err
    assert calls == [] and not calib_file.exists()


def test_autotune_restores_caller_env(calib_file, monkeypatch, tmp_path):
    import os

    monkeypatch.setenv("MCIM_NO_CALIB", "1")
    other = tmp_path / "other.json"
    assert cli.main(["autotune", "--blocks", "8", "--calib-file", str(other), *SMALL]) == 0
    assert other.exists() and not calib_file.exists()
    assert os.environ.get("MCIM_NO_CALIB") == "1"
    assert os.environ.get("MCIM_CALIB_FILE") == str(calib_file)
    monkeypatch.delenv("MCIM_NO_CALIB")
    assert cli.main(["autotune", "--blocks", "8", *SMALL]) == 0
    assert "MCIM_NO_CALIB" not in os.environ


def test_autotune_sweeps_with_lookups_off(calib_file, monkeypatch):
    """An existing record cannot steer the sweep that rewrites it."""
    calibration.record_block_h("cpu", 48, impl="cuda")
    seen = _spy_launch_shape(monkeypatch)
    assert cli.main(["autotune", "--blocks", "8", *SMALL]) == 0
    assert seen and all(cal is None for _, cal in seen)


def test_autotune_refuses_a_lane_that_differs(calib_file, monkeypatch, capsys):
    from mpi_cuda_imagemanipulation_tpu_torch.ops import mxu_kernels

    monkeypatch.setattr(mxu_kernels, "pipeline_mxu", lambda ops, x, **kw: x)
    assert cli.main(["autotune", "--dimension", "backend", *SMALL]) == 1
    assert "differs from the golden output" in capsys.readouterr().err
    assert not calib_file.exists()


def test_autotune_refuses_a_cpu_device_without_allow_cpu(calib_file, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(cli, "_lane_ms", lambda *a: calls.append(1) or 1.0)
    for dim in ("block", "backend", "plan"):
        rc = cli.main(["autotune", "--dimension", dim, "--device", "cpu",
                       "--height", "64", "--width", "128"])
        assert rc == 3
    assert "refusing to autotune" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["autotune", "--height", "64", "--width", "128"]) == 3  # --device cuda
    assert calls == [] and not calib_file.exists()


def test_autotune_refuses_ops_with_nothing_to_tune(calib_file, capsys):
    assert cli.main(["autotune", "--ops", "grayscale,invert", *SMALL]) == 2
    assert cli.main(["autotune", "--impl", "swar", "--ops", "median:3", *SMALL]) == 2
    assert cli.main(["autotune", "--dimension", "backend", "--ops", "median:3", *SMALL]) == 2
    assert not calib_file.exists()


def test_autotune_info_and_info_list_the_records(calib_file, capsys):
    ops = "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6"
    assert cli.main(["autotune", "--dimension", "plan", "--ops", ops, *SMALL]) == 0
    assert cli.main(["autotune", "--dimension", "backend", "--ops", ops, *SMALL]) == 0
    capsys.readouterr()
    assert cli.main(["autotune", "info", "--ops", ops, "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device_kind"] == "cpu" and report["store"] == str(calib_file)
    assert report["plan_choice"]["choice"] in cli.AUTOTUNE_PLANS
    assert set(report["backend_choice"]) == {"sep5", "corr3x3"}
    assert report["block_h"] == {"cuda": None, "swar": None}
    assert set(report["mxu_in_stage"]["fallbacks_by_reason"]) >= {"not-cuda", "no-calibration"}
    assert cli.main(["info", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("calibration (") and "[cpu]" in line
    assert "backend:sep5=" in line and "plan:" in line
