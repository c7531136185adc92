"""One run of one cell of the benchmark of the PyTorch port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. With ``--trace 0`` it measures the cell's end-to-end
metrics over a window of `--seconds`; with ``--trace 1`` it reads the
per-layer metrics from one profiled slice. Either way it checks the
outputs of the timed path against the plain reference. Its last line on
standard output is the result, one JSON object; its last lines on
standard error are the numbers compared, each beside its limit. It exits
2, with no result, without the cards, and 3 if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()  # the set-up time counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the calibration store of a fresh install: a path that does not exist
EMPTY_STORE = ("mcim_bench", "calibration.json")


def prepare_environment() -> None:
    """Leave the program no switch but the ones set here: every ``MCIM_*``
    variable goes; the calibration store is a path under the temporary
    directory that does not exist, so ``auto`` routes the same way in every
    run, whatever an earlier run left in the checkout. The kernels are
    built by the program into ``build/torch_kernels`` inside the checkout,
    a fixed path: only a checkout's first run builds them, and later runs
    load them from there. So with Python's bytecode: where the interpreter
    is set not to write it, the installed torch would compile its sources
    again in every run's import; it is kept in ``build/pycache``, so that
    only a checkout's first run compiles it."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    for key in [k for k in os.environ if k.startswith("MCIM_")]:
        del os.environ[key]
    store = os.path.join(tempfile.gettempdir(), *EMPTY_STORE)
    if os.path.exists(store):
        os.remove(store)
    os.environ["MCIM_CALIB_FILE"] = store


def card_line(count: int) -> str:
    """The card's name, the device count and the power limit nvidia-smi
    reads, for a line before the result."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=False,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"nvidia-smi: {e}"]
    return json.dumps({"cards": smi, "device_count": count})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    prepare_environment()
    import torch

    import harness

    bench = harness.load_benchmark()
    cell = harness.load_cell(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    result = harness.run_cell(cell, bench, args.seed, args.seconds, bool(args.trace), devices,
                              T_START)
    print(card_line(torch.cuda.device_count()), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
