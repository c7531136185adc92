"""The port's packed A/B tool (``tools/packed_ab.py``) on the CPU: with
``--device cpu`` it holds the K1 route, the golden ops, the archived packed
runner (T1's plain version) and T2's plain version equal on the pointwise
group, and T1's plain version on gaussian:5, and times nothing, as the JAX
tool's CPU branch does. On a card (``cuda`` marker) it times its eight
cases, each after its equality check.
"""

import pytest
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_ab

CASES = ["prod_cuda", "prod_torch", "archived_packed", "packed_u32", "g5_8k_cuda_r1",
         "g5_8k_packed_r1", "g5_8k_cuda_r2", "g5_8k_packed_r2"]


def test_cpu_run_checks_and_times_nothing(capsys):
    ck.reset_launch_counts()
    assert packed_ab.main(["--device", "cpu", "--hw", "40,128"]) == 0
    out = capsys.readouterr().out
    assert "cpu validation ok" in out and '"ms"' not in out
    assert not any(ck.launch_counts().values())


def test_cpu_run_at_a_ragged_width():
    assert packed_ab.run(37, 132, torch.device("cpu")) == []


def test_width_must_pack():
    with pytest.raises(ValueError, match="multiple of 4"):
        packed_ab.main(["--device", "cpu", "--hw", "40,130"])


def test_a_wrong_case_fails_before_timing(monkeypatch):
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels

    real = packed_kernels.pipeline_packed
    monkeypatch.setattr(packed_kernels, "pipeline_packed", lambda ops, x: real(ops, x) ^ 1)
    with pytest.raises(AssertionError, match="archived_packed differs"):
        packed_ab.run(40, 128, torch.device("cpu"))


def test_cuda_device_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        packed_ab.main(["--hw", "40,128"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_records_on_card(cuda_device):
    ck.reset_launch_counts()
    records = []
    packed_ab.run(64, 256, cuda_device, out=records.append)
    assert [r["case"] for r in records] == CASES
    assert all(r["clock"] == "cuda events" and r["ms"] > 0 for r in records)
    counts = ck.launch_counts()
    assert all(counts[k] for k in ("T1-pw", "T1", "T2", "K1", "K2"))
