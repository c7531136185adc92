"""The benchmark's machinery: a cell found by its name, its pool of frames
made from the seed, the entry under test, the measured window or the
traced slice, the metrics read from them, and the check.

Everything that belongs to one cell, configuration, traffic mix or
metric sits in a file of its own under this directory, found by name:

    workloads/<cell>.json   config, traffic, sampled calls, traced calls, why
    configs/<config>.json   pipeline, frame shape, arithmetic, source
    traffic/<mix>.json      loop kind, entry form, backend and plan, stack,
                            pool, warm calls, and whatever the loop reads
    loops/<kind>.py         drive(fn, pool, ...): the loop (generator.py)
    entries/<form>.py       make(cell, devices) -> fn, the entry under test;
                            optionally inputs(pool, cell, devices), the pool
                            put where the entry takes its inputs
    metrics/<metric>.py     read(record) -> number or None
    reference/<op>.py       make(arg, dtype) -> the plain op

From the program (the PyTorch port) this takes only the entry an
``entries/<form>.py`` builds and the kernels it launches.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import check  # noqa: E402
import generator  # noqa: E402
import roofline  # noqa: E402
import tracing  # noqa: E402

# top-level module names that may not be loaded in a run: JAX, its
# libraries and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mpi_cuda_imagemanipulation_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    traffic: dict

    @property
    def stack(self) -> int:
        return self.traffic["stack"]

    @property
    def frame_shape(self) -> tuple[int, ...]:
        c = self.config
        return (c["height"], c["width"]) + ((c["channels"],) if c["channels"] > 1 else ())

    @property
    def megapixels_per_frame(self) -> float:
        return self.config["height"] * self.config["width"] / 1e6


def load_cell(name: str, bench: dict) -> Cell:
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise ValueError(f"no cell {name!r} in BENCHMARK.json")
    workload = load_json(HERE, "workloads", f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entries[0][key]:
            raise ValueError(f"workloads/{name}.json and BENCHMARK.json differ on {key!r}")
    traffic = load_json(HERE, "traffic", f"{workload['traffic']}.json")
    if traffic["loop"] not in generator.loop_kinds():
        raise ValueError(f"unknown loop kind {traffic['loop']!r}")
    if traffic["entry"] not in entry_forms():
        raise ValueError(f"unknown entry form {traffic['entry']!r}")
    return Cell(name=name, chips=entries[0]["chips"], workload=workload,
                config=load_json(HERE, "configs", f"{workload['config']}.json"), traffic=traffic)


def metric_names(bench: dict, cell: str, per_layer: bool) -> list[str]:
    key = "per_layer" if per_layer else "end_to_end"
    return [m["name"] for m in bench[key] if cell in m.get("workloads", [cell])]


def load_module(sub: str, name: str):
    """``<sub>/<name>.py`` of this directory, as a module of its own."""
    path = os.path.join(HERE, sub, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{sub}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    return load_module("metrics", name)


def entry_forms() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "entries")) if f.endswith(".py"))


@dataclasses.dataclass
class Record:
    """What the metric readers (metrics/<name>.py) read."""

    setup_s: float
    frames_per_call: int
    megapixels_per_frame: float
    least_seconds_per_frame: float
    window: tuple[float, float] | None  # host seconds of the measured window
    calls: list  # (t_call, t_return, t_done), host seconds
    trace: tracing.TraceSlice | None = None


def make_entry(cell: Cell, devices: list[torch.device]):
    """The entry under test, as the program's users call it
    (``entries/<form>.py``)."""
    return load_module("entries", cell.traffic["entry"]).make(cell, devices)


def place_inputs(cell: Cell, pool: torch.Tensor, devices: list[torch.device]):
    """The pool where the cell's entry takes its inputs: the entry form's
    ``inputs(pool, cell, devices)`` where it has one, else the pool as made
    on the first card."""
    form = load_module("entries", cell.traffic["entry"])
    return form.inputs(pool, cell, devices) if hasattr(form, "inputs") else pool


def make_pool(cell: Cell, seed: int, device: torch.device) -> torch.Tensor:
    """The cell's pool of distinct u8 frames, made on `device` from `seed`
    in one call: (pool, H, W[, C]), or (pool, stack, H, W[, C])."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lead = (cell.traffic["pool"],) + ((cell.stack,) if cell.stack > 1 else ())
    return torch.randint(0, 256, lead + cell.frame_shape, generator=g, device=device,
                         dtype=torch.uint8)


def make_wait(devices: list[torch.device]):
    """wait(): block until the work enqueued so far on each card's current
    stream is done (an event recorded there and waited on). On the CPU work
    is done when a call returns."""
    cards = [d for d in devices if d.type == "cuda"]
    if not cards:
        return lambda: None
    events = [(d, torch.cuda.Event()) for d in cards]

    def wait():
        for d, ev in events:
            ev.record(torch.cuda.current_stream(d))
        for _d, ev in events:
            ev.synchronize()

    return wait


def run_cell(cell: Cell, bench: dict, seed: int, seconds: float, trace: bool,
             devices: list[torch.device], t_start: float, *, entry=None, log=None) -> dict:
    """One run of `cell` on `devices` (as many as it asks for): set-up,
    then the window (`trace` False) or the traced run, then the check.
    Returns the result's fields (the caller prints them). `entry` replaces
    the program's entry (the control and the fault tests); `t_start` is
    the process's start on ``time.perf_counter``'s clock."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    clock = time.perf_counter
    cards = [d for d in devices if d.type == "cuda"]
    t_import = clock()
    fn = entry if entry is not None else make_entry(cell, devices)
    pool = place_inputs(cell, make_pool(cell, seed, devices[0]), devices)
    wait = make_wait(devices)
    wait()
    t_pool = clock()
    drive = generator.driver(cell.traffic)
    k = cell.workload["check_calls"]
    # the warm calls build the kernels (the checkout's first run) and fill
    # the allocator's cache with as many output blocks as the window holds
    drive(fn, pool, wait=wait, reservoir=generator.Reservoir(k, seed),
          calls=cell.traffic["warm_calls"] + k)
    gc.collect()
    t_warm = clock()
    setup_s = t_warm - t_start
    log(f"setup: {setup_s:.4f} s (to the harness's imports {t_import - t_start:.4f}, "
        f"entry and pool {t_pool - t_import:.4f}, warm calls {t_warm - t_pool:.4f})")

    sample = generator.Reservoir(k, seed)
    tr = None
    gc.disable()  # the harness's own garbage is collected after the window
    try:
        if not trace:
            start, calls, _ = drive(fn, pool, wait=wait, reservoir=sample, seconds=seconds)
        else:
            # an untraced slice for the host clock, then as many calls traced
            n = cell.workload["trace_calls"]
            start, calls, nxt = drive(fn, pool, wait=wait, reservoir=sample, calls=n)
            with tracing.profile(devices) as prof:
                # the profiler's first calls pay its own start: outside the slice
                _, _, nxt = drive(fn, pool, wait=wait, reservoir=sample,
                                  calls=tracing.WARM_CALLS, first=nxt)
                t_open = clock()
                with tracing.span(tracing.SLICE_SPAN):
                    t_in = clock()
                    _, traced, _ = drive(fn, pool, wait=wait, reservoir=sample, calls=n,
                                         first=nxt)
                    t_out = clock()
            # the span opened between t_open and t_in: its start is the steps' zero
            anchor = 0.5 * (t_open + t_in)
            tr = tracing.read_session(prof, n, len(cards) or 1,
                                      tracing.host_steps(anchor, traced, t_out))
    finally:
        gc.enable()
    window = (start, calls[-1][2])
    lat = sorted(1e3 * (done - t0) for t0, _ret, done in calls)
    log(f"window: {len(calls)} calls in {window[1] - window[0]:.4f} s, latency ms median "
        f"{lat[len(lat) // 2]:.5f} p99 {lat[int(0.99 * len(lat))]:.5f} max {lat[-1]:.5f}")
    if tr is not None and tr.device:
        cycle = (window[1] - window[0]) / len(calls)
        log(f"traced slice: {tr.calls} calls in {tr.length:.6f} s (host clock "
            f"{t_out - anchor:.6f} s), busy {tr.busy:.6f} s, idle {1 - tr.busy / tr.length:.5f}; "
            f"the untraced slice's {cycle * 1e3:.5f} ms a call would idle "
            f"{1 - tr.busy / tr.calls / cycle:.5f}")
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)

    rec = Record(setup_s=setup_s, frames_per_call=cell.stack,
                 megapixels_per_frame=cell.megapixels_per_frame,
                 least_seconds_per_frame=roofline.least_seconds(cell.config),
                 window=window, calls=calls, trace=tr)
    units = {m["name"]: m["unit"] for key in ("end_to_end", "per_layer") for m in bench[key]}
    metrics = {}
    for name in metric_names(bench, cell.name, per_layer=trace):
        value = load_metric(name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    # the check: the program's state and the pool go first; the reference
    # makes its inputs again from the seed
    attempted = sample.seen
    samples = sample.items
    del fn, pool, sample
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    t_check = clock()
    inputs = make_pool(cell, seed, devices[0])
    result = check.compare(samples, inputs, cell.config["pipeline"], cell.stack)
    del inputs, samples
    log(f"check: {result['compared']} sampled calls of {attempted} compared in "
        f"{clock() - t_check:.4f} s")

    dev = {"platform": "gpu" if cards else devices[0].type,
           "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if tr is not None:
        dev["busy_s"] = tr.busy
        dev["window_s"] = tr.length
    out = {
        "correct": check.verdict(result["numbers"], result["compared"]),
        "attempted": attempted,
        "failed": result["wrong_outputs"],
        "metrics": metrics,
        "device": dev,
    }
    if tr is not None:
        out["breakdown"] = tracing.breakdown(tr)
    out["checks"] = {name: {"value": v, "limit": check.LIMITS[name]}
                     for name, v in result["numbers"].items()}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))
