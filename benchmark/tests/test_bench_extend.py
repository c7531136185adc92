"""A new loop kind, entry form, traffic mix and cell are files added under
the benchmark's directory and a line in BENCHMARK.json, with no edit to a
file that is there: in a copy of the benchmark, a paced loop, an entry
that takes its inputs as a list, a mix and a cell are added, and the cell
runs on the CPU at a small size, correct, with its metrics. The entry
takes its inputs in a form of its own, which only its ``inputs`` makes."""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

PACED = '''
import time


def drive(fn, pool, *, wait, reservoir, mix, seconds=None, calls=None, first=0):
    clock = time.perf_counter
    times, i, start = [], first, clock()
    while True:
        k = i % len(pool)
        t0 = clock()
        out = fn(pool[k])
        t1 = clock()
        wait()
        times.append((t0, t1, clock()))
        reservoir.offer(k, out)
        i += 1
        while clock() - t0 < mix["interval_s"]:
            pass
        if (seconds is not None and clock() - start >= seconds) or len(times) == calls:
            return start, times, i
'''

LISTED = '''
def inputs(pool, cell, devices):
    return [("frame", frame.clone()) for frame in pool]


def make(cell, devices):
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    fn = Pipeline.parse(cell.config["pipeline"]).jit(backend="torch", device=devices[0])
    return lambda item: fn(item[1])
'''

PROBE = r'''
import dataclasses, json, sys, time
sys.path.insert(0, sys.argv[1])
import run
run.prepare_environment()
import torch, harness
bench = harness.load_benchmark()
cell = harness.load_cell("reference_8k.paced", bench)
cell = dataclasses.replace(cell, config=dict(cell.config, height=16, width=24))
r = harness.run_cell(cell, bench, 2**33 + 1, 0.2, False, [torch.device("cpu")],
                     time.perf_counter(), log=lambda m: None)
print(json.dumps({"correct": r["correct"], "metrics": sorted(r["metrics"]),
                  "attempted": r["attempted"]}))
'''


def test_a_cell_with_a_new_loop_and_entry_is_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (tmp_path / "benchmark" / p).read_bytes()
              for p in os.listdir(tmp_path / "benchmark") if p.endswith(".py")}
    (tmp_path / "benchmark" / "loops" / "paced.py").write_text(PACED)
    (tmp_path / "benchmark" / "entries" / "listed.py").write_text(LISTED)
    (tmp_path / "benchmark" / "traffic" / "paced.json").write_text(json.dumps(
        {"loop": "paced", "entry": "listed", "backend": "torch", "plan": "off", "stack": 1,
         "pool": 3, "warm_calls": 1, "interval_s": 0.01}))
    (tmp_path / "benchmark" / "workloads" / "reference_8k.paced.json").write_text(json.dumps(
        {"config": "reference_8k", "traffic": "paced", "check_calls": 2, "trace_calls": 10,
         "why": "paced"}))
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "reference_8k.paced", "config": "reference_8k",
                               "traffic": "paced", "chips": 1, "why": "paced"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path / "benchmark")],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and 5 <= r["attempted"] <= 40
    assert r["metrics"] == ["latency_p95_ms", "setup_s", "throughput_mp_s"]
    # no file the benchmark had was edited
    assert before == {p: (tmp_path / "benchmark" / p).read_bytes() for p in before}
