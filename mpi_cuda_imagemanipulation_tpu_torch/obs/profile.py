"""Chrome trace parsing, host-span/device-trace merging, and the live
profiler capture. The counterpart of the JAX package's ``obs/profile.py``.

Parse a device trace, summarize per-track time with a DMA-vs-compute split,
and merge an `obs.trace` host-span file onto the SAME timeline, so host
stalls, copies and device compute are one picture. Everything but
`capture_live` is the JAX package's code; `capture_live` records with
``torch.profiler`` (CUPTI on a card) instead of ``jax.profiler``.

The two traces have different time bases (the profiler stamps its own
epoch; obs spans are relative to the tracer's start), so `merge_traces`
re-bases both to zero and keeps them on distinct pids: alignment is
structural (both cover the same run window), which is what the per-stage
overlap question needs ("was the device idle while the host coalesced or
encoded" is a within-track question on each side, answered side by side).
Event-level cross-clock sync is out of scope.

The DMA/compute split keeps the JAX package's rule for traces without
PyTorch's event categories (a JAX-shaped trace gives the JAX package's
summary): on a device track, an event whose name is copy-shaped
(`DMA_MARKERS`) is DMA, any other compute. A ``torch.profiler`` trace
names its categories instead: ``gpu_memcpy`` and ``gpu_memset`` events
are DMA, ``kernel`` events compute, and its host-side categories
(`TORCH_HOST_CATS`: operators, runtime calls, the profiler's own span,
annotations) count as neither.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import threading
import time
from collections import defaultdict

# event names that are DMA/copy-shaped on device tracks (the JAX package's
# classifier)
DMA_MARKERS = ("dma", "copy", "memcpy", "transfer", "infeed", "outfeed")

# torch.profiler event categories: on the device (older builds spell them
# Memcpy, Memset, Kernel), and host-side
TORCH_DMA_CATS = ("gpu_memcpy", "gpu_memset", "Memcpy", "Memset")
TORCH_COMPUTE_CATS = ("kernel", "Kernel")
TORCH_HOST_CATS = (
    "cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation",
    "gpu_user_annotation", "Trace", "ac2g", "cpu_instant_event", "overhead",
    "fwdbwd", "Runtime", "gpu_instant_event",
)

HOST_PID = 1_000_001  # merged-trace pid for the obs host spans
# a capture directory's files: the profiler's own trace, the merged one
DEVICE_TRACE_FILE = "device_trace.json"
MERGED_FILE = "merged_trace.json"


def load_device_trace(path: str) -> list[dict]:
    """Trace events from a profiler output directory (the newest
    `*.json.gz` or `*.json` trace under it, merged artifacts aside) or from
    a plain `.json` / `.json.gz` trace file. Returns [] when nothing is
    found."""
    if os.path.isdir(path):
        paths = sorted(
            (p for pat in ("*.json.gz", "*.json")
             for p in glob.glob(os.path.join(path, "**", pat), recursive=True)
             if os.path.basename(p) != MERGED_FILE),
            key=os.path.getmtime,
        )
        if not paths:
            return []
        path = paths[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data) if isinstance(data, dict) else data


def load_host_trace(path: str) -> list[dict]:
    """Trace events from an `obs.trace` export (`--trace-out` JSON)."""
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", data) if isinstance(data, dict) else data


def _ts_base(events: list[dict]) -> float:
    stamps = [float(e["ts"]) for e in events if "ts" in e and e.get("ph") != "M"]
    return min(stamps) if stamps else 0.0


def merge_traces(host_events: list[dict], device_events: list[dict]) -> list[dict]:
    """One Chrome trace-event list with the obs host spans and the device
    trace side by side: both re-based to ts=0, host events forced onto
    the reserved `HOST_PID` process (named "mcim-host") so the tracks
    never collide with the profiler's pids."""
    out: list[dict] = []
    hbase = _ts_base(host_events)
    for e in host_events:
        e = dict(e)
        e["pid"] = HOST_PID
        if "ts" in e and e.get("ph") != "M":
            e["ts"] = float(e["ts"]) - hbase
        out.append(e)
    if not any(
        e.get("ph") == "M" and e.get("name") == "process_name" and e.get("pid") == HOST_PID
        for e in out
    ):
        out.insert(0, {
            "ph": "M", "name": "process_name", "pid": HOST_PID, "tid": 0,
            "args": {"name": "mcim-host"},
        })
    dbase = _ts_base(device_events)
    for e in device_events:
        e = dict(e)
        if "ts" in e and e.get("ph") != "M":
            e["ts"] = float(e["ts"]) - dbase
        out.append(e)
    return out


def _torch_class(cat) -> str | None:
    """'dma' / 'compute' / 'host' for a torch.profiler category, None for
    an event without one (the JAX package's name rule decides)."""
    if cat in TORCH_DMA_CATS:
        return "dma"
    if cat in TORCH_COMPUTE_CATS:
        return "compute"
    if cat in TORCH_HOST_CATS:
        return "host"
    return None


def summarize(events: list[dict], *, top_n: int = 40) -> dict:
    """Per-process top events by total duration + the device-side
    DMA-vs-compute split (module docstring)."""
    pid_name: dict = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_name[e.get("pid")] = e.get("args", {}).get("name", "")
    agg: dict = defaultdict(lambda: [0.0, 0])  # (proc, name) -> [us, count]
    proc_total: dict = defaultdict(float)
    # (proc, name) -> the torch category class of its events, when they
    # carry one (the first event's decides)
    cls: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        dur = float(e.get("dur", 0.0))
        proc = pid_name.get(e.get("pid"), str(e.get("pid")))
        key = (proc, e.get("name", "?"))
        agg[key][0] += dur
        agg[key][1] += 1
        proc_total[proc] += dur
        if key not in cls:
            cls[key] = _torch_class(e.get("cat"))
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top_n]
    # device tracks under the name rule: the processes that are neither the
    # python host process nor the merged-in host-span track
    device_procs = {
        p for p in proc_total
        if not p.lower().startswith(("python", "/host", "mcim-host"))
    }
    dma_us = comp_us = 0.0
    for (proc, name), (us, _n) in agg.items():
        c = cls.get((proc, name))
        if c is None:
            if proc not in device_procs:
                continue
            c = "dma" if any(m in name.lower() for m in DMA_MARKERS) else "compute"
        if c == "dma":
            dma_us += us
        elif c == "compute":
            comp_us += us
    return {
        "processes": {p: round(v, 1) for p, v in sorted(proc_total.items())},
        "device_dma_us": round(dma_us, 1),
        "device_compute_us": round(comp_us, 1),
        "top_events": [
            {"process": proc, "name": name, "total_us": round(us, 1), "count": n}
            for (proc, name), (us, n) in top
        ],
    }


def summary_table(summary: dict) -> list[str]:
    """The markdown top-events table for a summary dict."""
    lines = ["| process | event | total us | count |", "|---|---|---|---|"]
    for t in summary.get("top_events", []):
        lines.append(f"| {t['process']} | {t['name'][:60]} | {t['total_us']} | {t['count']} |")
    return lines


# --------------------------------------------------------------------------
# on-demand live capture (the `POST /control/profile` unit)
# --------------------------------------------------------------------------

ENV_PROFILE_DIR = "MCIM_PROFILE_DIR"
ENV_PROFILE_MIN_INTERVAL_S = "MCIM_PROFILE_MIN_INTERVAL_S"
ENV_PROFILE_MAX_S = "MCIM_PROFILE_MAX_S"
ENV_PROFILE_DEFAULT_S = "MCIM_PROFILE_DEFAULT_S"


class ProfileUnavailable(RuntimeError):
    """A capture cannot run NOW: one is already in flight, or the
    per-process rate limit has not elapsed. Maps to HTTP 429: live
    profiling is expensive and a control plane must not be able to stack
    captures on a serving replica."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = max(retry_after_s, 1.0)


_capture_lock = threading.Lock()  # one capture per process, ever
_last_capture_ts = 0.0
_capture_seq = 0
_kineto_ready = False  # init_profiler ran in this process


def profiler(device=None):
    """A ``torch.profiler.profile`` recording every thread of the process:
    CPU operators, and on a CUDA `device` (the default; raising without
    one, utils/device.resolve_device) the card's kernels and copies
    through CUPTI. Kernel records cover the whole process whatever thread
    launched them; CPU operators on other threads need
    ``profile_all_threads``, which older PyTorch builds lack (then only the
    calling thread's operators are recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

    cuda = resolve_device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        cfg = None
    return profile(activities=acts, experimental_config=cfg)


def init_profiler(device=None) -> None:
    """Run one empty profiler session on the calling thread, once per
    process, so that the profiler's one-time set-up (CUPTI on a card)
    happens on this thread. That set-up must run on the thread that
    imported torch: a first session started on another thread, as an HTTP
    handler's `POST /control/profile` starts one, recorded no device
    activity on an H100 (Kineto logs "External init callback must run in
    same thread as registerClient"), while every session after one on the
    main thread recorded the card's kernels and copies. ServeApp.start()
    calls it on a CUDA device."""
    global _kineto_ready
    if _kineto_ready:
        return
    prof = profiler(device)
    prof.start()
    prof.stop()
    _kineto_ready = True


def capture_live(
    seconds: float | None = None,
    *,
    out_dir: str | None = None,
    device=None,
    sleep=time.sleep,
) -> dict:
    """One rate-limited ``torch.profiler`` capture UNDER LIVE TRAFFIC: start
    the profiler (`profiler(device)`), keep serving for `seconds` (capped
    at MCIM_PROFILE_MAX_S; the HTTP caller blocks for it), stop, export the
    Chrome trace into the capture directory, merge the process's obs host
    spans onto the device timeline, write the merged artifact, and file a
    `profile_capture` flight-recorder dump naming it.

    Returns {artifact, device_trace_dir, seconds, host_events,
    device_events, summary}. Raises ProfileUnavailable (HTTP 429) when a
    capture is in flight or the MCIM_PROFILE_MIN_INTERVAL_S limit has not
    elapsed; never leaves the profiler running."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
    from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

    global _last_capture_ts, _capture_seq
    max_s = float(env_registry.get(ENV_PROFILE_MAX_S))
    default_s = float(env_registry.get(ENV_PROFILE_DEFAULT_S))
    min_interval = float(env_registry.get(ENV_PROFILE_MIN_INTERVAL_S))
    seconds = min(max(float(seconds or default_s), 0.1), max_s)
    if not _capture_lock.acquire(blocking=False):
        raise ProfileUnavailable("capture already in flight", seconds)
    try:
        now = time.time()
        since = now - _last_capture_ts
        if _last_capture_ts and since < min_interval:
            raise ProfileUnavailable(
                f"rate limited ({since:.1f}s since last capture, min {min_interval:.0f}s)",
                min_interval - since,
            )
        prof = profiler(device)  # raises for a device this process lacks
        _last_capture_ts = now
        _capture_seq += 1
        seq = _capture_seq
        base = out_dir or env_registry.get(ENV_PROFILE_DIR) or os.path.join(
            "artifacts", "profile"
        )
        run_dir = os.path.join(base, f"capture_{os.getpid()}_{seq}")
        os.makedirs(run_dir, exist_ok=True)
        prof.start()
        try:
            # the capture window: traffic keeps flowing on the serving
            # threads while the profiler records them
            sleep(seconds)
        finally:
            prof.stop()
        device_path = os.path.join(run_dir, DEVICE_TRACE_FILE)
        prof.export_chrome_trace(device_path)
        tracer = obs_trace.get_tracer()
        host_events = tracer.chrome_events() if tracer is not None else []
        device_events = load_device_trace(device_path)
        merged = merge_traces(host_events, device_events)
        artifact = os.path.join(run_dir, MERGED_FILE)
        with open(artifact, "w") as f:
            json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
        summary = summarize(merged)
        result = {
            "artifact": artifact,
            "device_trace_dir": run_dir,
            "seconds": seconds,
            "host_events": sum(1 for e in host_events if e.get("ph") != "M"),
            "device_events": sum(1 for e in device_events if e.get("ph") != "M"),
            "summary": summary,
        }
        recorder.dump(
            "profile_capture",
            extra={"artifact": artifact, "seconds": seconds,
                   "device_events": result["device_events"]},
        )
        return result
    finally:
        _capture_lock.release()


def merge_and_summarize(host_path: str, device_path: str,
                        merged_out: str | None = None) -> dict:
    """Load both traces, merge them onto one timeline (optionally writing
    the combined Chrome JSON), and return one summary whose table
    interleaves host spans with device tracks."""
    host = load_host_trace(host_path)
    device = load_device_trace(device_path)
    merged = merge_traces(host, device)
    if merged_out:
        with open(merged_out, "w") as f:
            json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    summary = summarize(merged)
    summary["host_events"] = sum(1 for e in host if e.get("ph") != "M")
    summary["device_events"] = sum(1 for e in device if e.get("ph") != "M")
    if merged_out:
        summary["merged_trace"] = merged_out
    return summary
