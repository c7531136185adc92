"""The port's device-hang guard (utils/guard.py, `run --device-timeout`),
the counterpart of tests/test_guard.py, on the CPU: the watchdog child gets
``--device cpu`` (``device="cpu"``), where it runs the kernels' plain
versions.

A guarded run equals the in-process one (and the JAX package's golden ops)
byte for byte and reports both synchronised windows; an overrun raises
DeviceTimeoutError and `run` exits 4; a failing child raises
RuntimeError; a 2-D run on the kernel backends fails with one line before
any child starts.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image, synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.utils import guard
from mpi_cuda_imagemanipulation_tpu_torch.utils.guard import DeviceTimeoutError, run_guarded
from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import _sync

REFERENCE = "grayscale,contrast:3.5,emboss:3"


@pytest.mark.parametrize("impl,shards,plan", [
    ("cuda", "1", "auto"), ("auto", "1", "fused-pallas"), ("torch", "2x2", "auto"),
    ("cuda", "3", "off"),
])
def test_guarded_run_matches_inprocess(impl, shards, plan):
    img = synthetic_image(40, 56, channels=3, seed=61)
    timings: dict = {}
    out = run_guarded(REFERENCE, img, 120.0, impl=impl, shards=shards, plan=plan,
                      timings=timings, device="cpu")
    inproc = Pipeline.parse(REFERENCE).jit(impl, device="cpu", plan=plan)(img)
    np.testing.assert_array_equal(out, inproc.numpy())
    np.testing.assert_array_equal(out, np.asarray(JaxPipeline.parse(REFERENCE)(jnp.asarray(img))))
    # both synchronised windows, as an unguarded run reports them
    assert timings["compile_and_run_s"] > 0 and timings["steady_s"] > 0


def test_guarded_run_times_out():
    img = synthetic_image(24, 24, channels=1, seed=62)
    with pytest.raises(DeviceTimeoutError, match="exceeded"):
        # a budget far below the interpreter's start-up always trips,
        # without a wedged device
        run_guarded("invert", img, 0.05, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        run_guarded("invert", img, 0.0, device="cpu")


def test_guarded_run_propagates_child_errors():
    img = synthetic_image(24, 24, channels=1, seed=63)
    with pytest.raises(RuntimeError, match="guarded run failed"):
        run_guarded("definitely-not-an-op", img, 120.0, device="cpu")


def test_the_child_imports_only_the_port():
    """The watchdog's worker names the port and never JAX or the JAX
    package, and it runs on the device the parent names."""
    src = guard._WORKER
    assert "mpi_cuda_imagemanipulation_tpu_torch" in src
    assert "jax" not in src.replace("mpi_cuda_imagemanipulation_tpu_torch", "")
    assert "mpi_cuda_imagemanipulation_tpu." not in src
    assert "distributed_init(device)" in src and "mesh_from_shards(shards, dev)" in src


def test_sync_waits_only_for_cuda_tensors():
    _sync(torch.zeros(3))  # a CPU tensor: nothing to wait for
    _sync(None)


def _cli_image(tmp_path, seed=64):
    src = tmp_path / "in.png"
    save_image(src, synthetic_image(32, 48, channels=3, seed=seed))
    return src


def test_cli_device_timeout_flag(tmp_path, capsys):
    src = _cli_image(tmp_path)
    out, direct, metrics = tmp_path / "out.png", tmp_path / "direct.png", tmp_path / "m.json"
    assert cli.main(["run", "--input", str(src), "--output", str(out), "--device", "cpu",
                     "--device-timeout", "120", "--show-timing",
                     "--json-metrics", str(metrics)]) == 0
    stdout = capsys.readouterr().out
    # guarded runs report the steady state, as unguarded ones do
    assert "steady-state" in stdout and "(guarded)" in stdout
    rec = json.loads(metrics.read_text())
    assert rec["guarded"] is True and rec["steady_s"] > 0 and rec["clock"] == "host"
    assert cli.main(["run", "--input", str(src), "--output", str(direct), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(load_image(out), load_image(direct))


def test_cli_returns_4_on_timeout(tmp_path, capsys):
    src = _cli_image(tmp_path)
    trace = tmp_path / "t.json"
    rc = cli.main(["run", "--input", str(src), "--output", str(tmp_path / "o.png"),
                   "--device", "cpu", "--device-timeout", "0.01", "--trace-out", str(trace)])
    assert rc == 4
    assert not (tmp_path / "o.png").exists()
    events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    root = [e for e in events if e.get("name") == "run"]
    assert root and root[0]["args"].get("error") == "DeviceTimeoutError"


def test_cli_guarded_2d_kernel_backend_fails_cleanly(tmp_path, capsys):
    """--device-timeout with --shards RxC and a kernel backend fails with
    one error line before the watchdog child starts."""
    src = _cli_image(tmp_path, seed=5)
    started = []
    real = guard.subprocess.run

    def spy(*a, **k):
        started.append(a)
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(guard.subprocess, "run", spy)
        rc = cli.main(["run", "--input", str(src), "--output", str(tmp_path / "o.png"),
                       "--device", "cpu", "--impl", "cuda", "--shards", "2x4",
                       "--device-timeout", "60"])
    assert rc == 2 and not started
    err = capsys.readouterr().err
    assert "2-D sharding" in err and err.count("\n") == 1


def test_cli_rejects_a_non_positive_budget():
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu_torch", "run", "--input", "x.png",
         "--output", "y.png", "--device-timeout", "0"],
        capture_output=True, text=True, timeout=120, stdin=subprocess.DEVNULL,
    )
    assert proc.returncode == 2 and "--device-timeout must be positive" in proc.stderr
