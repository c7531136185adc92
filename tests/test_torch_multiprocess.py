"""The port's sharded runner across OS processes: two ranks of a
``torch.distributed`` group on ``gloo`` (tests/_torch_mp_worker.py), one
shard per rank and two slots per rank, the 2-D runner and the
data-parallel stack over two slots per rank, and the CLI under the torchrun
environment. The rank that holds slot 0 must end with the golden bytes.

Each subprocess has its own time limit; the rendezvous port is chosen at
run time.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    load_image,
    save_image,
    synthetic_image,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")
TIMEOUT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_group(argv, world=2):
    """Start `world` ranks of `argv` with the torchrun environment and wait
    for them, each under its own time limit. Returns their outputs."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("slots_per_rank", [1, 2])
def test_two_gloo_processes_match_golden(slots_per_rank):
    outs = _run_group([WORKER, str(slots_per_rank)])
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank}: {out}\n{err[-2000:]}"
    assert f"TORCH_MULTIPROC_OK slots={2 * slots_per_rank}" in outs[0][1]
    assert "TORCH_MULTIPROC" not in outs[1][1]  # only slot 0's rank reports


@pytest.mark.parametrize("form", ["2d", "dp"])
def test_two_gloo_processes_2d_and_data_parallel(form):
    """The 2-D tile-sharded runner over a 2 x 2 mesh and the data-parallel
    stack over 4 slots, two slots on each of two ranks."""
    outs = _run_group([WORKER, form])
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank}: {out}\n{err[-2000:]}"
    assert f"TORCH_MULTIPROC_OK {form} slots=4" in outs[0][1]
    assert "TORCH_MULTIPROC" not in outs[1][1]


@pytest.mark.parametrize("plan", ["off", "fused-pallas"])
def test_cli_under_the_torchrun_environment(tmp_path, plan):
    """`run --shards 4 --device cpu` on two ranks: the rank that holds slot 0
    writes the whole image, equal to the single-process run."""
    src, plain, out = tmp_path / "in.png", tmp_path / "plain.png", tmp_path / "out.png"
    save_image(src, synthetic_image(128, 96, channels=3, seed=22))
    assert cli.main(["run", "--input", str(src), "--output", str(plain), "--device", "cpu"]) == 0
    outs = _run_group(["-m", "mpi_cuda_imagemanipulation_tpu_torch", "run", "--input", str(src),
                       "--output", str(out), "--device", "cpu", "--shards", "4", "--plan", plan,
                       "--show-timing"])
    for rank, (rc, stdout, err) in enumerate(outs):
        assert rc == 0, f"rank {rank}: {stdout}\n{err[-2000:]}"
    assert "shards=4" in outs[0][1] and outs[1][1] == ""
    np.testing.assert_array_equal(load_image(out), load_image(plain))
