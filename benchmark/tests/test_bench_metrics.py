"""The metric arithmetic on made-up records: the roofline's bytes, the
union of device intervals and the idle share, launches a frame, the 95th
percentile over every call, throughput, and the breakdown's labels."""

import json
import math
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)

import harness  # noqa: E402
import roofline  # noqa: E402
import tracing  # noqa: E402


def cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def test_least_bytes_of_the_configs():
    assert roofline.least_bytes(cfg("reference_8k")) == 4320 * 7680 * 6 == 199_065_600
    assert roofline.least_bytes(cfg("gaussian5_8k")) == 4320 * 7680 * 2 == 66_355_200
    assert roofline.least_seconds(cfg("reference_8k")) == pytest.approx(59.42e-6, rel=1e-3)
    assert roofline.least_seconds(cfg("gaussian5_8k")) == pytest.approx(19.81e-6, rel=1e-3)


def ev(cat, name, ts, dur, card=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": 1.7e15 + ts, "dur": dur,
            "args": {"device": card}}


def made_up_trace():
    """A 1000 us slice: two overlapping kernels, a copy, a kernel that
    starts before the slice and one after it."""
    return [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
        ev("kernel", "before", -50, 100),  # 50 us inside
        ev("user_annotation", "bench.slice", 0, 1000),
        ev("kernel", "k2", 100, 200),
        ev("kernel", "k1", 250, 150),
        ev("gpu_memcpy", "Memcpy DtoD", 600, 100),
        ev("kernel", "after", 1100, 100),
        ev("cpu_op", "aten::empty", 20, 5),
        ev("gpu_user_annotation", "bench.call", 100, 300),
    ]


# two calls on the loop's clock, the slice span opened at 5.0 s: the first
# called at 10 us, returned at 100 us, done at 400 us; the second called
# at 400 us, returned at 600 us, done at 1000 us
ANCHOR = 5.0
CALLS = [(5.0 + 10e-6, 5.0 + 100e-6, 5.0 + 400e-6), (5.0 + 400e-6, 5.0 + 600e-6, 5.0 + 1000e-6)]


def made_up_slice():
    return tracing.slice_from_events(made_up_trace(), calls=2,
                                     steps=tracing.host_steps(ANCHOR, CALLS, 5.0 + 1000e-6))


def test_host_steps_from_the_loops_clock():
    steps = [(n, round(a * 1e6), round(b * 1e6)) for n, a, b in
             tracing.host_steps(ANCHOR, CALLS, 5.0 + 1010e-6)]
    assert steps == [("bench.next_input", 0, 10), ("bench.call", 10, 100),
                     ("bench.wait", 100, 400), ("bench.next_input", 400, 400),
                     ("bench.call", 400, 600), ("bench.wait", 600, 1000),
                     ("bench.close", 1000, 1010)]


def test_slice_union_and_idle():
    tr = made_up_slice()
    assert tr.length == pytest.approx(1e-3)
    # [0, 50] + [100, 400] + [600, 700]
    assert tr.busy == pytest.approx(450e-6) == tr.busy_total
    gaps = [t for gap in tracing.idle_gaps(tr) for t in gap]
    assert gaps == pytest.approx([50e-6, 100e-6, 400e-6, 600e-6, 700e-6, 1000e-6])
    rec = harness.Record(setup_s=1.0, frames_per_call=8,
                         megapixels_per_frame=33.1776, least_seconds_per_frame=19.8e-6,
                         window=None, calls=[], trace=tr)
    assert harness.load_metric("device_idle_frac").read(rec) == pytest.approx(0.55)
    # three kernels (the copy is no launch) over 2 calls of 8 frames
    assert harness.load_metric("launches_per_frame").read(rec) == pytest.approx(3 / 16)
    assert harness.load_metric("kernels_roofline").read(rec) == pytest.approx(
        100 * 16 * 19.8e-6 / 450e-6)


def test_busy_over_several_cards():
    # card 0 busy [0, 300], card 1 [0, 100] and [500, 600] of a 1000 us slice
    events = [ev("user_annotation", "bench.slice", 0, 1000), ev("kernel", "a", 0, 300, 0),
              ev("kernel", "b", 0, 100, 1), ev("kernel", "c", 500, 100, 1)]
    tr = tracing.slice_from_events(events, calls=1, chips=2)
    assert tr.busy_total == pytest.approx(500e-6) and tr.busy == pytest.approx(250e-6)
    rec = harness.Record(setup_s=1.0, frames_per_call=1, megapixels_per_frame=33.1776,
                         least_seconds_per_frame=100e-6, window=None, calls=[], trace=tr)
    assert harness.load_metric("device_idle_frac").read(rec) == pytest.approx(0.75)
    # the least bytes take 100 us on one card, 50 us a card on two: of 500 card-us
    assert harness.load_metric("kernels_roofline").read(rec) == pytest.approx(20.0)
    # the idle gaps are where no card is busy
    assert [round(b * 1e6) for gap in tracing.idle_gaps(tr) for b in gap] == [300, 500, 600, 1000]


def test_breakdown_labels_gaps_by_the_host_step():
    b = tracing.breakdown(made_up_slice())
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "k2" and set(names) == {"k2", "k1", "Memcpy DtoD", "before"}
    gaps = {(label, round(secs * 1e6)) for label, secs in b["idle_gaps"]}
    assert gaps == {("bench.wait", 300), ("bench.call", 200), ("bench.call", 50)}
    assert [s for _, s in b["idle_gaps"]] == sorted((s for _, s in b["idle_gaps"]), reverse=True)


def test_a_step_span_in_the_trace_is_not_read():
    # only bench.slice is read from the trace; step names come from the loop
    events = made_up_trace() + [ev("user_annotation", "bench.call", 0, 1000)]
    tr = tracing.slice_from_events(events, calls=2)
    assert tr.steps == [] and tracing.breakdown(tr)["idle_gaps"][0][0] == "none"


def test_no_device_activity_reads_nothing():
    events = [e for e in made_up_trace() if e.get("cat") not in ("kernel", "gpu_memcpy")]
    tr = tracing.slice_from_events(events, calls=2, steps=tracing.host_steps(0.0, CALLS, 0.0))
    rec = harness.Record(setup_s=1.0, frames_per_call=1,
                         megapixels_per_frame=33.1776, least_seconds_per_frame=59.4e-6,
                         window=None, calls=[], trace=tr)
    for name in ("device_idle_frac", "launches_per_frame", "kernels_roofline"):
        assert harness.load_metric(name).read(rec) is None


def test_window_metrics_over_every_call():
    # 100 calls: latencies 1..100 ms, host returns after a tenth of each
    calls, t = [], 0.0
    for i in range(1, 101):
        calls.append((t, t + i * 1e-4, t + i * 1e-3))
        t += i * 1e-3
    rec = harness.Record(setup_s=3.5, frames_per_call=1,
                         megapixels_per_frame=33.1776, least_seconds_per_frame=59.4e-6,
                         window=(0.0, t), calls=calls)
    assert harness.load_metric("latency_p95_ms").read(rec) == pytest.approx(95.0)
    assert harness.load_metric("pipeline_host_ms").read(rec) == pytest.approx(5.05)
    assert harness.load_metric("throughput_mp_s").read(rec) == pytest.approx(
        100 * 33.1776 / t)
    assert harness.load_metric("setup_s").read(rec) == 3.5
    assert math.isclose(t, 5.05)


@pytest.mark.parametrize("n,want", [(1, 1), (19, 19), (20, 19), (21, 20), (1000, 950)])
def test_p95_nearest_rank(n, want):
    p95 = harness.load_metric("latency_p95_ms").p95
    assert p95(list(range(n, 0, -1))) == want
