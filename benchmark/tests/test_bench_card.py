"""On the card only (marked ``cuda``; each test skips, with its reason,
where torch sees no CUDA device): every cell run as the benchmark runs it,
short, untraced and traced, and the control at the cell's own size on
three seeds, which must come out as not correct.

    python -m pytest benchmark/tests/test_bench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

import harness  # noqa: E402

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cell, trace):
    need_card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 101),
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0 and set(result["breakdown"]) == {
            "device_ops", "idle_gaps"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    need_card()
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell, "--control-seeds",
         ",".join(str(2**31 + s) for s in (201, 202, 203)), "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 3 and not any(r["correct"] for r in rows)
