"""Device-hang guard: run a pipeline in a watchdog subprocess. The
counterpart of the JAX package's ``utils/guard.py``.

The failure-detection posture is fail-fast (the reference instead
`return 1`s mid-collective and deadlocks its peers, kernel.cu:150). One
failure mode fail-fast cannot catch in-process is a wedged device: a
kernel that never finishes, or a CUDA runtime call that blocks, beyond the
reach of Python signal handlers. `run_guarded` executes the pipeline in a child
process with a wall-clock budget, so the parent always regains control and
can report a clean, actionable error. Exposed on the CLI as
``run --device-timeout SECS``.

The child imports only this package, inherits the environment, and runs on
the device the parent names (CUDA by default; it never falls back to the
CPU). Its first call builds the CUDA kernels with ``nvcc`` where
``build/torch_kernels/`` holds no build of the sources yet, which takes
tens of seconds: the budget covers that, as the JAX package's covers the
compile.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np


class DeviceTimeoutError(RuntimeError):
    """The device computation exceeded its wall-clock budget."""


_WORKER = """\
import json
import sys
import time

import numpy as np

inp, outp, spec, impl, block, shards, halo_mode, device, plan = sys.argv[1:10]

from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import (
    distributed_init,
    mesh_from_shards,
    rank_device,
)

distributed_init(device)  # the torchrun environment (inherited) works guarded too

from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import _sync

img = np.load(inp)
pipe = Pipeline.parse(spec)
dev = rank_device(device)
mesh = mesh_from_shards(shards, dev)
if mesh is not None:
    fn = pipe.sharded(mesh, backend=impl, halo_mode=halo_mode, plan=plan)
else:
    fn = pipe.jit(backend=impl, block_h=int(block) or None, device=dev, plan=plan)

# two synchronised windows, so that a guarded run reports its steady-state
# latency as an unguarded one does: the first call builds the kernels
t0 = time.perf_counter()
out = fn(img)
_sync(out)
compile_s = time.perf_counter() - t0
t0 = time.perf_counter()
out = fn(img)
_sync(out)
steady_s = time.perf_counter() - t0
np.save(outp, out.cpu().numpy())
with open(outp + ".timings.json", "w") as f:
    json.dump({"compile_and_run_s": compile_s, "steady_s": steady_s}, f)
"""


def run_guarded(
    spec: str,
    img: np.ndarray,
    timeout_s: float,
    *,
    impl: str = "auto",
    block_h: int | None = None,
    shards: int | str = 1,
    halo_mode: str = "serial",
    timings: dict | None = None,
    device: str = "cuda",
    plan: str = "auto",
) -> np.ndarray:
    """Run `spec` over `img` in a subprocess on `device` with a wall-clock
    budget, as ``Pipeline.jit`` (or ``Pipeline.sharded`` over the mesh of
    `shards`, ``mesh_from_shards``) with `impl` and `plan` runs it; returns
    the output as a numpy array.

    Raises DeviceTimeoutError when the budget is exceeded (a wedged device,
    a runaway build) and RuntimeError on any child failure. The child
    inherits the environment (the checkout's root put first on its
    PYTHONPATH). If `timings` is given, it is filled with the
    child's synchronised windows: "compile_and_run_s" (the first call,
    which builds the kernels where they are not built yet) and "steady_s"
    (the second, warm call). The budget covers both calls plus the
    interpreter's start-up."""
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be positive, got {timeout_s}")
    with tempfile.TemporaryDirectory(prefix="mcim_guard_") as td:
        inp = os.path.join(td, "in.npy")
        outp = os.path.join(td, "out.npy")
        np.save(inp, np.asarray(img))
        cmd = [
            sys.executable, "-c", _WORKER,
            inp, outp, spec, impl, str(block_h or 0), str(shards), halo_mode, str(device),
            plan,
        ]
        # the child imports this package from the checkout that holds it
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        try:
            proc = subprocess.run(cmd, timeout=timeout_s, capture_output=True, text=True,
                                  stdin=subprocess.DEVNULL, env=env)
        except subprocess.TimeoutExpired:
            raise DeviceTimeoutError(
                f"device computation exceeded {timeout_s:g}s: the device may be "
                "wedged, or the kernels' first build ran long; retry, raise "
                "--device-timeout, or run with --device cpu"
            ) from None
        if proc.returncode != 0:
            tail = (proc.stderr or proc.stdout or "").strip()[-800:]
            raise RuntimeError(f"guarded run failed (rc={proc.returncode}): {tail}")
        if timings is not None:
            try:
                with open(outp + ".timings.json") as f:
                    timings.update(json.load(f))
            except (OSError, ValueError):
                pass  # the result is still good; the timings are best-effort
        return np.load(outp)
