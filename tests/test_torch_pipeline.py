"""The port's slice as a whole on the CPU: the `run` command of both
packages on the same small PNG must write the same bytes, and the
reference pipeline must match the loop-level emulator of kernel.cu."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _c_reference import contrast_c, emboss_c, grayscale_c
from mpi_cuda_imagemanipulation_tpu.models import pipeline as jax_pipeline
from mpi_cuda_imagemanipulation_tpu.utils import timing as jax_timing
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    load_image,
    save_image,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.models import pipeline
from mpi_cuda_imagemanipulation_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_run(*argv):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu", "run", *argv],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize(
    "ops,gray_output",
    [
        ("grayscale,contrast:3.5,emboss:3", False),
        ("sepia,gaussian:5,gamma:1.8,sobel,quantize:5", False),
        ("grayscale,gaussian:5,sobel", True),
    ],
)
def test_cli_run_matches_jax_run(tmp_path, ops, gray_output):
    src = tmp_path / "in.png"
    save_image(src, synthetic_image(33, 47, channels=3, seed=12))
    extra = ["--gray-output"] if gray_output else []
    _jax_run("--input", str(src), "--output", str(tmp_path / "jax.png"),
             "--ops", ops, "--impl", "pallas", *extra)
    want = load_image(tmp_path / "jax.png", grayscale=gray_output)
    for impl in ("torch", "cuda"):
        out = tmp_path / f"{impl}.png"
        rc = cli.main(["run", "--input", str(src), "--output", str(out), "--ops", ops,
                       "--impl", impl, "--device", "cpu", *extra])
        assert rc == 0
        got = load_image(out, grayscale=gray_output)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_cli_run_metrics_and_timing(tmp_path, capsys):
    src = tmp_path / "in.png"
    save_image(src, synthetic_image(20, 30, channels=3, seed=13))
    metrics = tmp_path / "m.jsonl"
    rc = cli.main(["run", "--input", str(src), "--output", str(tmp_path / "o.png"),
                   "--device", "cpu", "--show-timing", "--json-metrics", str(metrics)])
    assert rc == 0
    assert "steady-state" in capsys.readouterr().out
    rec = json.loads(metrics.read_text().strip())
    assert rec["ops"] == "grayscale,contrast3.5,emboss3"
    # the default --impl is auto, which runs what cuda runs
    assert rec["impl"] == "auto" and rec["device"] == "cpu" and rec["clock"] == "host"
    out = load_image(tmp_path / "o.png")
    assert out.shape == (20, 30, 3)
    np.testing.assert_array_equal(out[..., 0], out[..., 2])


def test_cli_run_defaults_to_cuda(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.png"
    save_image(src, synthetic_image(8, 8, channels=3, seed=1))
    rc = cli.main(["run", "--input", str(src), "--output", str(tmp_path / "o.png")])
    assert rc == 2
    assert "is_available" in capsys.readouterr().err
    assert not (tmp_path / "o.png").exists()


def test_cli_info(capsys):
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "torch " in out and "nvcc" in out and "triton" in out


def test_reference_pipeline_matches_c_emulator():
    img = synthetic_image(40, 52, channels=3, seed=14)
    pipe = pipeline.reference_pipeline()
    assert pipe.name == "grayscale,contrast3.5,emboss3" and pipe.max_halo == 1
    for backend in pipeline.BACKENDS:
        out = pipe.jit(backend, device="cpu")(img).numpy()
        gray = pipeline.Pipeline.parse("grayscale").jit(backend, device="cpu")(img).numpy()
        assert np.abs(gray.astype(int) - grayscale_c(img).astype(int)).max() <= 3
        np.testing.assert_array_equal(out, emboss_c(contrast_c(gray, 3.5), 3))


def test_reference_cpu_pipeline_matches_jax():
    img = synthetic_image(30, 44, channels=3, seed=15)
    want = np.asarray(jax_pipeline.reference_cpu_pipeline()(jnp.asarray(img)))
    for backend in pipeline.BACKENDS:
        got = pipeline.reference_cpu_pipeline().jit(backend, device="cpu")(img)
        np.testing.assert_array_equal(got.numpy(), want)


def test_pipeline_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        pipeline.reference_pipeline().jit("xla", device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        pipeline.reference_pipeline().jit("torch", device="cpu")(np.zeros((4, 4, 3)))


@pytest.mark.parametrize("qs", [(50, 95, 99), (0, 100), (12.5,)])
def test_percentiles_match_jax(qs):
    xs = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    assert timing.percentiles(xs, qs) == jax_timing.percentiles(xs, qs)
    with pytest.raises(ValueError):
        timing.percentiles([], qs)


def test_device_timing_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.device_time_ms(lambda: None)


def test_chip_smoke_refuses_without_cuda():
    """The on-card smoke test exits non-zero and prints no result when
    torch.cuda.is_available() is False (as on a CPU-only torch)."""
    code = (
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['chip_smoke.py']\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "is_available() is False" in r.stderr
