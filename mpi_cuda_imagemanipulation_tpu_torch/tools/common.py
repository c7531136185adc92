"""What the tools share: the card's label, timing, and round-robin rounds
with per-case bests, as the JAX repository's probes report them."""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from typing import Callable

import torch

from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms


def card_label(device: torch.device) -> dict:
    """The device's name and power limit, for every record: on a card,
    ``torch.cuda.get_device_name`` and ``nvidia-smi``'s power.limit; on the
    CPU, 'cpu' and None."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        r = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        limit = r.stdout.strip() if r.returncode == 0 else "unavailable"
    except (OSError, subprocess.TimeoutExpired):
        limit = "unavailable"
    return {"device": torch.cuda.get_device_name(index), "power_limit": limit}


def time_ms(fn: Callable[[], object], device: torch.device) -> tuple[float, str]:
    """(milliseconds per call, clock): CUDA events on a card
    (``device_time_ms``); on the CPU the host clock, the median of three
    calls after one, which is no device number."""
    if device.type == "cuda":
        return device_time_ms(fn), "cuda events"
    fn()
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples), "host"


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def run_rounds(cases, n_rounds: int, device: torch.device, label: dict,
               out: Callable[[dict], None] = emit) -> list[dict]:
    """Time every case `n_rounds` times in round-robin order, so that each
    samples the card across the whole run, and report each case's best.

    `cases` holds (base, fn): `base` is the record's fields, with
    '_nbytes' (bytes one call moves, for gb_s) and '_mp' (pixels, for
    mp_s) as measurement parameters. Emits one record per case and round,
    then one per case with its best time and ``stat: best_of_N_rounds``;
    returns those. A failing case raises: there is no transient fault to
    ride out on a local card."""
    best: dict[tuple, dict] = {}
    for rnd in range(1, max(1, n_rounds) + 1):
        for base, fn in cases:
            pub = {k: v for k, v in base.items() if not k.startswith("_")}
            ms, clock = time_ms(fn, device)
            rec = {**pub, "round": rnd, "ms": ms, **label, "clock": clock}
            if "_nbytes" in base:
                rec["gb_s"] = base["_nbytes"] / (ms / 1e3) / 1e9
            if "_mp" in base:
                rec["mp_s"] = base["_mp"] / 1e6 / (ms / 1e3)
            out(rec)
            key = (base["case"], base.get("block_h"))
            if key not in best or ms < best[key]["ms"]:
                best[key] = rec
    summaries = []
    for rec in best.values():
        summary = {k: v for k, v in rec.items() if k != "round"}
        summary["stat"] = f"best_of_{max(1, n_rounds)}_rounds"
        out(summary)
        summaries.append(summary)
    return summaries
