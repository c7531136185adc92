"""In a fresh interpreter: the harness, every cell's entry built and called
on the CPU at a small size, and the run's own exit without a card leave no
module of JAX or of the JAX package loaded (top-level names compared
whole: the port's name begins with the JAX package's)."""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

PROBE = r"""
import dataclasses, sys
sys.path.insert(0, {bench!r})
import run
run.prepare_environment()
import torch, harness
bench = harness.load_benchmark()
for w in bench["workloads"]:
    cell = harness.load_cell(w["name"], bench)
    cell = dataclasses.replace(cell, config=dict(cell.config, height=9, width=12))
    fn = harness.make_entry(cell, [torch.device("cpu")])
    pool = harness.make_pool(cell, 2**31 + 5, torch.device("cpu"))
    fn(pool[0])
assert "mpi_cuda_imagemanipulation_tpu_torch" in sys.modules
print("FOUND", harness.forbidden_modules())
"""


def clean_env():
    env = dict(os.environ)
    for k in [k for k in env if k.startswith(("JAX", "XLA", "MCIM_"))]:
        del env[k]
    return env


def test_no_jax_module_after_resolving_every_cell():
    out = subprocess.run([sys.executable, "-c", PROBE.format(bench=BENCH)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=clean_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_forbidden_names_compared_whole():
    sys.path.insert(0, BENCH)
    import harness

    saved = dict(sys.modules)
    try:
        sys.modules["mpi_cuda_imagemanipulation_tpu_torch_extra"] = sys
        sys.modules["jaxtyping"] = sys
        assert "jax" not in harness.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert harness.forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_without_a_card_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "reference_8k.frame", "--seed",
         str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(clean_env(), CUDA_VISIBLE_DEVICES=""),
    )
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr
