"""One ``torch.profiler`` session over a short slice of calls, read back
into the records the per-layer metrics take.

The session records the host's operators, one harness span,
``bench.slice``, around the whole slice, and, on the cards, every kernel,
copy and fill through CUPTI. There is no span around each step: a span a
step costs the host as much as the program's own entry does, and would
make the card look idler than it is. The host's steps come from the
loop's own clock instead (the call's start, return and end), put on the
trace's clock at the slice span's start. Its Chrome trace goes to one
file under the temporary directory, is read and is deleted. Kineto puts
host and device events on one clock, in microseconds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

# device activity in a torch.profiler trace (older builds spell them
# Kernel, Memcpy, Memset)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "Kernel", "Memcpy", "Memset")
KERNEL_CATS = ("kernel", "Kernel")
SPAN_CAT = "user_annotation"
SLICE_SPAN = "bench.slice"
# calls made under the profiler before the slice opens
WARM_CALLS = 10


@dataclasses.dataclass
class TraceSlice:
    """The traced slice, in seconds from its start."""

    start: float
    end: float
    calls: int
    chips: int
    device: list  # (name, category, card, start, end), clipped to the slice
    steps: list  # (name, start, end): the host's steps, from the loop's clock

    @property
    def length(self) -> float:
        return self.end - self.start

    @property
    def busy_total(self) -> float:
        """Seconds of the slice in which some kernel, copy or fill ran,
        summed over the cards."""
        cards = {d[2] for d in self.device}
        return sum(b - a for c in cards
                   for a, b in union((d[3], d[4]) for d in self.device if d[2] == c))

    @property
    def busy(self) -> float:
        """`busy_total` averaged over the cards the cell uses."""
        return self.busy_total / self.chips


def profile(devices):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    return _profile(activities=acts)


def span(name: str):
    from torch.profiler import record_function

    return record_function(name)


def host_steps(anchor: float, calls: list, end: float) -> list[tuple[str, float, float]]:
    """The host's steps from a loop's ``(t_call, t_return, t_done)`` times,
    in seconds from `anchor`: taking the next input (from the last call's
    end), the call, the wait on its result, and closing the slice after
    the last call (to `end`)."""
    steps, prev = [], anchor
    for t0, t1, t2 in calls:
        steps += [("bench.next_input", prev - anchor, t0 - anchor),
                  ("bench.call", t0 - anchor, t1 - anchor),
                  ("bench.wait", t1 - anchor, t2 - anchor)]
        prev = t2
    steps.append(("bench.close", prev - anchor, end - anchor))
    return steps


def read_session(prof, calls: int, chips: int, steps) -> TraceSlice:
    """Export `prof`'s trace to a temporary file, read it and delete it."""
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    return slice_from_events(events, calls, chips, steps)


def slice_from_events(events: list[dict], calls: int, chips: int = 1, steps=()) -> TraceSlice:
    """The slice's records from Chrome trace events (complete events,
    ``ph`` 'X'; times in microseconds). `steps` are the host's steps in
    seconds from the slice's start (`host_steps`)."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    slices = [e for e in complete if e.get("cat") == SPAN_CAT and e.get("name") == SLICE_SPAN]
    if len(slices) != 1:
        raise RuntimeError(f"expected one {SLICE_SPAN} span in the trace, found {len(slices)}")
    # seconds from the slice's start: the trace's epoch microseconds would
    # lose digits as seconds in a double
    base = float(slices[0]["ts"])
    s0, s1 = 0.0, float(slices[0].get("dur", 0.0)) * 1e-6
    device = []
    for e in complete:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0 = (float(e["ts"]) - base) * 1e-6
        a, b = max(t0, s0), min(t0 + float(e.get("dur", 0.0)) * 1e-6, s1)
        if b > a:
            card = int((e.get("args") or {}).get("device", 0))
            device.append((e.get("name", "?"), e["cat"], card, a, b))
    device.sort(key=lambda d: d[3])
    return TraceSlice(start=s0, end=s1, calls=calls, chips=chips, device=device,
                      steps=sorted(steps, key=lambda s: s[1]))


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(tr: TraceSlice) -> list[tuple[float, float]]:
    """The stretches of the slice in which nothing ran on any card."""
    gaps, t = [], tr.start
    for a, b in union((d[3], d[4]) for d in tr.device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if tr.end > t:
        gaps.append((t, tr.end))
    return gaps


def breakdown(tr: TraceSlice, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by the host step that overlaps it most."""
    by_name: dict[str, float] = {}
    for name, _cat, _card, a, b in tr.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, j, steps = [], 0, tr.steps
    for a, b in idle_gaps(tr):
        # the steps follow one another, so their ends rise with their starts
        while j < len(steps) and steps[j][2] <= a:
            j += 1
        best, label = 0.0, "none"
        for name, s0, s1 in steps[j:]:
            if s0 >= b:
                break
            overlap = min(b, s1) - max(a, s0)
            if overlap > best:
                best, label = overlap, name
        gaps.append((label, b - a))
    gaps.sort(key=lambda g: -g[1])
    return {
        "device_ops": [[name[:160], secs] for name, secs in ops],
        "idle_gaps": [[label, secs] for label, secs in gaps[:top]],
    }
