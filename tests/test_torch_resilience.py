"""The port's resilience modules (breaker, health, retry, journal, deadline,
chaos) against the JAX package's: the same calls on the same injected
clocks, seeds and files give the same states, delays, headers, counters,
journal lines and chaos schedules in both packages.
"""

import json
import random
import threading
import time

import pytest

from mpi_cuda_imagemanipulation_tpu.obs import metrics as jax_metrics
from mpi_cuda_imagemanipulation_tpu.resilience import breaker as jax_breaker
from mpi_cuda_imagemanipulation_tpu.resilience import chaos as jax_chaos
from mpi_cuda_imagemanipulation_tpu.resilience import deadline as jax_deadline
from mpi_cuda_imagemanipulation_tpu.resilience import health as jax_health
from mpi_cuda_imagemanipulation_tpu.resilience import journal as jax_journal
from mpi_cuda_imagemanipulation_tpu.resilience import retry as jax_retry
from mpi_cuda_imagemanipulation_tpu_torch import resilience
from mpi_cuda_imagemanipulation_tpu_torch.obs import metrics, recorder
from mpi_cuda_imagemanipulation_tpu_torch.resilience import (
    breaker,
    chaos,
    deadline,
    failpoints,
    health,
    journal,
    retry,
)


class _Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# --------------------------------------------------------------------------
# breaker
# --------------------------------------------------------------------------


def _breaker_story(mod):
    """States after each step of a closed -> open -> half-open -> open ->
    half-open -> closed story on an injected clock, and the board's view."""
    clock = _Clock()
    b = mod.CircuitBreaker(failure_threshold=3, reset_timeout_s=10.0, clock=clock, key="b0")
    seen = []
    for step in ("f", "f", "s", "f", "f", "f", "allow", "t+5", "allow", "t+6", "allow",
                 "allow", "f", "t+10", "allow", "s", "allow"):
        if step == "f":
            b.on_failure()
        elif step == "s":
            b.on_success()
        elif step == "allow":
            seen.append(("allow", b.allow()))
        else:
            clock.t += float(step[2:])
        seen.append((step, b.state, b.snapshot()["open_events"]))
    board = mod.BreakerBoard(failure_threshold=1, reset_timeout_s=5.0, clock=clock)
    board.get("x").on_failure()
    board.get(("y", 2)).on_success()
    seen.append(("board", board.any_open(), board.open_keys(), board.snapshot()))
    board.reset("x")
    seen.append(("reset", board.any_open(), board.snapshot()))
    return seen


def test_breaker_transitions_equal_the_jax_package_s():
    rec = recorder.configure(cap=64)
    try:
        assert _breaker_story(breaker) == _breaker_story(jax_breaker)
        states = [f["state"] for _ts, k, f in rec.entries() if k == "breaker"]
        # the port's breaker notes every transition in the port's recorder
        assert states == ["open", "half_open", "open", "half_open", "closed", "open"]
    finally:
        recorder.configure(cap=None)
    with pytest.raises(ValueError):
        breaker.CircuitBreaker(failure_threshold=0)


# --------------------------------------------------------------------------
# health, retry
# --------------------------------------------------------------------------


def _health_story(mod):
    h = mod.HealthState(clock=_Clock(5.0))
    out = [(h.state, h.is_admitting(), h.http_code())]
    for new in ("serving", "degraded", "degraded", "serving", "draining", "serving", "stopped"):
        try:
            h.to(new)
            out.append((new, h.state, h.is_admitting(), h.http_code()))
        except ValueError as e:
            out.append((new, "refused", str(e)))
    out.append(h.to_dict())
    out.append(list(h.transitions))
    return out


def test_health_machine_equals_the_jax_package_s():
    assert _health_story(health) == _health_story(jax_health)
    assert health.STATES == jax_health.STATES
    assert health.HTTP_OK == jax_health.HTTP_OK


@pytest.mark.parametrize("policy", [{}, {"max_attempts": 6, "base_delay_s": 0.01,
                                         "multiplier": 3.0, "max_delay_s": 0.2,
                                         "jitter_frac": 0.5},
                                    {"jitter_frac": 0.0}])
def test_retry_delays_equal_the_jax_package_s(policy):
    port, ref = retry.RetryPolicy(**policy), jax_retry.RetryPolicy(**policy)
    pr, jr = random.Random(11), random.Random(11)
    assert [port.delay_s(a, pr) for a in range(1, 9)] == [ref.delay_s(a, jr) for a in range(1, 9)]

    def story(mod, pol):
        calls, sleeps, retries = [], [], []

        def fn():
            calls.append(len(calls))
            if len(calls) < 3:
                raise KeyError(len(calls))
            return "done"

        try:
            got = mod.call_with_retry(fn, policy=pol, rng=random.Random(5), sleep=sleeps.append,
                                      retryable=(KeyError,),
                                      on_retry=lambda a, e, d: retries.append((a, repr(e), d)))
        except KeyError as e:
            got = f"raised {e!r}"
        return got, calls, sleeps, retries

    assert story(retry, port) == story(jax_retry, ref)


def test_retry_propagates_non_retryable_and_validates():
    def boom():
        raise TypeError("no")

    with pytest.raises(TypeError):
        retry.call_with_retry(boom, non_retryable=(TypeError,), sleep=lambda s: None)
    for bad in ({"max_attempts": 0}, {"jitter_frac": 1.0}):
        with pytest.raises(ValueError):
            retry.RetryPolicy(**bad)


# --------------------------------------------------------------------------
# journal
# --------------------------------------------------------------------------


def _journal_story(mod, path, inp):
    j = mod.BatchJournal(path)
    d = mod.content_digest(inp)
    j.record_ok("a.png", d, "out/a.png")
    j.record_failed("b.png", None, "decode failed")
    # a torn trailing line from a mid-append kill
    with open(path, "a") as f:
        f.write('{"input": "c.png", "sta')
    j.record_ok("b.png", d, "out/b.png")
    with open(path) as f:
        text = f.read()
    return text, j.load(), j.completed("a.png", inp), j.completed("b.png", inp)


def test_journal_file_contents_equal_the_jax_package_s(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000123.5)
    inp = tmp_path / "a.png"
    inp.write_bytes(bytes(range(256)) * 9)
    port = _journal_story(journal, str(tmp_path / "p" / "j.jsonl"), inp)
    ref = _journal_story(jax_journal, str(tmp_path / "j" / "j.jsonl"), inp)
    assert port == ref
    text, records, a_ok, b_ok = port
    assert a_ok and b_ok and set(records) == {"a.png", "b.png"}
    assert records["b.png"]["status"] == "ok"
    # an input edited after its record is not complete
    inp.write_bytes(b"changed")
    assert not journal.BatchJournal(str(tmp_path / "p" / "j.jsonl")).completed("a.png", inp)
    assert journal.DEFAULT_NAME == jax_journal.DEFAULT_NAME
    assert journal.BatchJournal(str(tmp_path / "none.jsonl")).load() == {}


def test_journal_appends_from_threads_stay_whole(tmp_path):
    j = journal.BatchJournal(str(tmp_path / "j.jsonl"))

    def worker(k):
        for i in range(20):
            j.record_ok(f"{k}-{i}.png", "d", "o")

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(j.load()) == 160


# --------------------------------------------------------------------------
# deadline
# --------------------------------------------------------------------------


def test_deadline_vocabularies_and_names_are_the_jax_package_s():
    assert deadline.TIERS == jax_deadline.TIERS
    assert deadline.HEDGE_OUTCOMES == jax_deadline.HEDGE_OUTCOMES
    assert deadline.HEADER == jax_deadline.HEADER
    assert deadline.expired_response_body() == jax_deadline.expired_response_body()


@pytest.mark.parametrize("header", ["250", "0", "-3", "12.75", "abc", None, ""])
def test_deadline_header_round_trip_equals_the_jax_package_s(header):
    def story(mod):
        clock = _Clock(50.0)
        headers = {} if header is None else {mod.HEADER: header}
        d = mod.from_headers(headers, clock=clock)
        if d is None:
            return None
        out = [(d.header_value(), d.expired(), d.remaining_ms())]
        clock.t += 0.1
        out.append((d.header_value(), d.expired(slack_ms=5.0), d.remaining_ms()))
        # the next hop re-anchors the remainder on its own clock
        nxt = mod.from_headers({mod.HEADER: d.header_value()}, clock=_Clock(7.0))
        out.append(nxt.header_value())
        return out

    assert story(deadline) == story(jax_deadline)


def test_deadline_counters_and_budget_equal_the_jax_package_s():
    def story(dl, mmod):
        r = mmod.Registry()
        exp, den, hed = dl.expired_counter(r), dl.budget_denied_counter(r), dl.hedge_counter(r)
        dl.count_expired(exp, "router")
        dl.count_expired(exp, "router")
        dl.count_expired(exp, "scheduler")
        dl.count_budget_denied(den, "door")
        dl.count_hedge(hed, "won")
        dl.count_hedge(hed, "suppressed_budget")
        raised = []
        for fn, bad in ((dl.count_expired, "nowhere"), (dl.count_budget_denied, "x"),
                        (dl.count_hedge, "tied")):
            try:
                fn(exp, bad)
            except ValueError:
                raised.append(bad)
        b = dl.RetryBudget(frac=0.25, reserve=2.0)
        draws = []
        for i in range(12):
            if i % 3 == 0:
                b.deposit()
            draws.append(b.try_withdraw())
        delays = [dl.hedge_delay_s(p, f) for p in (None, 0.0, 0.2) for f in (0.0, 0.5)]
        return r.render(), raised, draws, b.stats(), b.deposits, delays

    rec = recorder.configure(cap=16)
    try:
        assert story(deadline, metrics) == story(jax_deadline, jax_metrics)
        assert [f["tier"] for _ts, k, f in rec.entries() if k == "deadline_expired"] == [
            "router", "router", "scheduler"]
    finally:
        recorder.configure(cap=None)


# --------------------------------------------------------------------------
# chaos
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("kw", [{}, {"brownout_ms": 40, "kill_pod": False},
                                {"replicas_per_pod": 3}])
def test_chaos_schedule_compiles_as_the_jax_package_s(seed, kw):
    pods = ("p0", "p1", "p2")
    port = chaos.ChaosSchedule.compile(seed, pods=pods, duration_s=20.0, **kw)
    ref = jax_chaos.ChaosSchedule.compile(seed, pods=pods, duration_s=20.0, **kw)
    assert port.trace() == ref.trace()
    assert (port.failpoints, port.failpoint_seed, port.killed_pod()) == (
        ref.failpoints, ref.failpoint_seed, ref.killed_pod())
    # every compiled spec arms the port's failpoints
    for spec in port.failpoints.values():
        if spec:
            failpoints.configure(spec, seed=port.failpoint_seed)
    failpoints.clear()


def test_chaos_vocabularies_and_runner():
    assert chaos.FAULT_SITES == jax_chaos.FAULT_SITES
    assert set(chaos.FAULT_SITES) <= set(failpoints.KNOWN_SITES)
    assert chaos.EVENT_KINDS == jax_chaos.EVENT_KINDS
    with pytest.raises(ValueError):
        chaos.ChaosEvent(1.0, "explode", "p0")
    with pytest.raises(ValueError):
        chaos.ChaosSchedule.compile(0, pods=(), duration_s=1.0)
    sched = chaos.ChaosSchedule.compile(3, pods=("p0", "p1"), duration_s=1.0)
    with pytest.raises(ValueError, match="missing actions"):
        chaos.ChaosRunner(sched, {})
    clock = _Clock(0.0)

    def sleep(s):
        clock.t += s

    hits = []

    def fail(ev):
        raise RuntimeError("harness fault")

    actions = {k: hits.append for k in chaos.EVENT_KINDS}
    actions["kill_pod"] = fail
    runner = chaos.ChaosRunner(sched, actions, clock=clock, sleep=sleep).start()
    runner.join(timeout=30)
    assert runner._thread is not None and not runner._thread.is_alive()
    assert runner.applied == [e for e in sched.events if e.kind != "kill_pod"]
    assert [e for e, _msg in runner.errors] == [e for e in sched.events if e.kind == "kill_pod"]
    assert hits == runner.applied


def test_package_exports_equal_the_jax_package_s():
    from mpi_cuda_imagemanipulation_tpu import resilience as jax_resilience

    names = ("BreakerBoard", "CircuitBreaker", "FailpointError", "maybe_fail", "HealthState",
             "BatchJournal", "RetryPolicy", "call_with_retry")
    for name in names:
        assert hasattr(resilience, name) and hasattr(jax_resilience, name), name
