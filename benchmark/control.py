"""The readings the check's limits are set from, at a cell's own size, in
one process (the benchmark's own runs never run this):

* the program over many seeds: the lower readings, from sound runs;
* the control over a few seeds: the plain reference put in the program's
  place and computed in bfloat16, the precision below the float32 the
  configuration states. Its outputs must come out as not correct.

    python3 benchmark/control.py --workload <cell> --program-seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2

Each run prints one JSON line: side, seed, correct, the numbers compared
and the calls sampled and attempted.
"""

import argparse
import json
import sys
import time

import run


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run.prepare_environment()
    import torch

    import check
    import harness

    bench = harness.load_benchmark()
    cell = harness.load_cell(args.workload, bench)
    device = torch.device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    devices = ([torch.device("cuda", i) for i in range(cell.chips)]
               if device.type == "cuda" else [device])
    control = check.reference_entry(cell.config["pipeline"], cell.stack, torch.bfloat16)
    for side, group, entry in (("program", args.program_seeds, None),
                               ("control", args.control_seeds, control)):
        for seed in group:
            r = harness.run_cell(cell, bench, seed, args.seconds, False, devices,
                                 time.perf_counter(), entry=entry)
            print(json.dumps({"side": side, "seed": seed, "correct": r["correct"],
                              "checks": r["checks"], "failed": r["failed"],
                              "attempted": r["attempted"]}), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
