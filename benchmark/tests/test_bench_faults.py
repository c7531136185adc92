"""The check has to fail what it is there to catch. Each cell is driven on
the CPU at a small size past the look for a card (``harness.run_cell``),
with the timed path sound, with the control in the program's place (the
plain reference in bfloat16), and with a fault underneath the entry: the
input returned unprocessed, each call answered with the previous call's
answer, half of a stack left unprocessed, one byte altered in every
output. Only the sound path may come out correct; the
traced run checks the same way."""

import dataclasses
import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)

import check  # noqa: E402
import harness  # noqa: E402
import run  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**32 + 123


@pytest.fixture(scope="module")
def bench():
    run.prepare_environment()
    return harness.load_benchmark()


def small(bench, name):
    cell = harness.load_cell(name, bench)
    return dataclasses.replace(cell, config=dict(cell.config, height=24, width=40))


def drive(bench, cell, entry=None, trace=False):
    return harness.run_cell(cell, bench, SEED, 0.2, trace, [CPU], time.perf_counter(), entry=entry,
                            log=lambda msg: None)


def unchanged(fn):
    """A step that returns its state unchanged: the input, unprocessed."""
    return lambda x: x.clone()


def stale(fn):
    """Each call answered with the previous call's answer."""
    last = []

    def run_(x):
        out = fn(x)
        last.append(out)
        return last.pop(0) if len(last) > 1 else out

    return run_


def half_stack(fn):
    """Half of the stack processed, the rest passed through."""
    def run_(x):
        h = x.shape[0] // 2
        return torch.cat([fn(x[:h]), x[h:]])

    return run_


def altered(fn):
    """One byte of every output changed where it is produced."""
    def run_(x):
        out = fn(x).clone()
        flat = out.view(-1)
        flat[flat.numel() // 3] ^= 0x10
        return out

    return run_


CELLS = ["reference_8k.frame", "gaussian5_8k.stack8"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_sound_path_is_correct(bench, name, trace):
    r = drive(bench, small(bench, name), trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "throughput_mp_s", "latency_p95_ms"}
    else:
        # no device on the CPU: only the host-clock metric reads anything
        assert set(r["metrics"]) == {"pipeline_host_ms"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench, name):
    cell = small(bench, name)
    entry = check.reference_entry(cell.config["pipeline"], cell.stack, torch.bfloat16)
    r = drive(bench, cell, entry=entry)
    assert not r["correct"] and r["checks"]["wrong_bytes"]["value"] > 0


@pytest.mark.parametrize("name,fault", [
    ("reference_8k.frame", unchanged), ("reference_8k.frame", stale),
    ("reference_8k.frame", altered),
    ("gaussian5_8k.stack8", unchanged), ("gaussian5_8k.stack8", stale),
    ("gaussian5_8k.stack8", altered), ("gaussian5_8k.stack8", half_stack),
], ids=lambda v: getattr(v, "__name__", v))
@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_fault_is_not_correct(bench, name, fault, trace):
    cell = small(bench, name)
    r = drive(bench, cell, entry=fault(harness.make_entry(cell, [CPU])), trace=trace)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["wrong_bytes"]["value"] > 0


def test_wrong_shape_is_not_correct(bench):
    cell = small(bench, "gaussian5_8k.stack8")
    fn = harness.make_entry(cell, [CPU])
    r = drive(bench, cell, entry=lambda x: fn(x)[: x.shape[0] // 2])
    # the half that is missing counts whole, in every sampled call
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["wrong_bytes"]["value"] == r["failed"] * 4 * 24 * 40


def test_extra_frames_are_not_correct(bench):
    cell = small(bench, "gaussian5_8k.stack8")
    fn = harness.make_entry(cell, [CPU])
    r = drive(bench, cell, entry=lambda x: torch.cat([fn(x), fn(x)[:1]]))
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["wrong_bytes"]["value"] == r["failed"] * 24 * 40


def test_same_seed_same_pool_other_seed_other_pool():
    run.prepare_environment()
    cell = small(harness.load_benchmark(), "reference_8k.frame")
    a = harness.make_pool(cell, SEED, CPU)
    assert a.shape == (cell.traffic["pool"], 24, 40, 3)
    assert torch.equal(a, harness.make_pool(cell, SEED, CPU))
    assert not torch.equal(a, harness.make_pool(cell, SEED + 1, CPU))
    # the frames of a pool differ from one another
    assert all(not torch.equal(a[0], a[i]) for i in range(1, len(a)))
