"""The port's engine (engine/core.py, engine/metrics.py) against the JAX
package's, on the CPU: the counterpart of tests/test_engine.py without its
serving cases.

The engine changes when work happens, never what runs: outputs equal the
JAX pipeline's byte for byte under mixed shapes and are forced in
submission order; the in-flight bound holds; failures are per item (the
``engine.complete`` failpoint at force, an exception at encode); the
metrics snapshot and ``device_idle_frac`` follow the JAX definition. On
the CPU ``device_stager`` and the D2H are plain copies. Every wait on an
engine thread has a timeout, so that a hang fails its test and not the
run. ``Pipeline.jit(donate=True)`` / ``batched(donate=True)`` give the
undonated forms' bytes.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu_torch.engine import (
    DEFAULT_INFLIGHT,
    DEFAULT_IO_THREADS,
    Engine,
    EngineMetrics,
    device_stager,
)
from mpi_cuda_imagemanipulation_tpu_torch.engine import core as engine_core
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

REFERENCE_OPS = "grayscale,contrast:3.5,emboss:3"
WAIT_S = 60  # the longest any test waits on an engine thread


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


def _jax(spec: str, img: np.ndarray) -> np.ndarray:
    return np.asarray(jax.block_until_ready(JaxPipeline.parse(spec).jit()(img)))


def _drain(eng: Engine) -> None:
    assert eng.flush(timeout=WAIT_S), "engine did not drain"
    eng.close(timeout=WAIT_S)


def test_exports_match_the_jax_package():
    assert (DEFAULT_INFLIGHT, DEFAULT_IO_THREADS) == (2, 4)
    assert {"Engine", "EngineMetrics", "DEFAULT_INFLIGHT", "DEFAULT_IO_THREADS"} <= set(
        __import__("mpi_cuda_imagemanipulation_tpu_torch.engine", fromlist=["x"]).__all__)


def test_bit_exact_mixed_shapes_forced_in_order():
    """Mixed shapes through the port's cuda route (plain versions here):
    each output equals the JAX pipeline's, forced and delivered in
    submission order (io_threads=1 observes the completion FIFO)."""
    spec = "gaussian:3,sobel"
    fn = Pipeline.parse(spec).jit("cuda", device="cpu", plan="off")
    shapes = [(24, 32), (17, 41), (24, 32), (9, 33), (17, 41)]
    imgs = [synthetic_image(h, w, channels=1, seed=k) for k, (h, w) in enumerate(shapes * 2)]
    results, order, errors = {}, [], []

    def on_done(k, out, info):
        assert isinstance(out, np.ndarray) and info["force_s"] >= 0.0
        results[k] = out
        order.append(k)

    eng = Engine(inflight=3, io_threads=1, stage=device_stager("cpu"), name="t-order")
    for k, img in enumerate(imgs):
        eng.submit(k, lambda img=img: img, fn, on_done=on_done,
                   on_error=lambda k, e: errors.append((k, e)))
    _drain(eng)
    assert not errors, errors
    assert order == list(range(len(imgs)))
    for k, img in enumerate(imgs):
        np.testing.assert_array_equal(results[k], _jax(spec, img), err_msg=f"image {k}")


def test_inflight_bound_and_backpressure():
    """At most `inflight` dispatches are outstanding: the producer blocks in
    submit while two are unforced."""
    x = np.ones((64, 64), np.float32)
    done, live, peak = [], [0], [0]
    lock = threading.Lock()

    def run(v):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        return torch.tanh(torch.as_tensor(v) @ torch.as_tensor(v))

    def on_done(k, out, info):
        with lock:
            live[0] -= 1
        done.append(k)

    eng = Engine(inflight=2, io_threads=2, name="t-bound")
    for k in range(10):
        eng.submit(k, lambda: x, run, on_done=on_done, on_error=lambda k, e: pytest.fail(str(e)))
    _drain(eng)
    snap = eng.metrics.snapshot()
    assert (snap["submitted"], snap["completed"], snap["failed"], snap["inflight"]) == (10, 10, 0, 0)
    assert 1 <= snap["inflight_peak"] <= 2
    assert sorted(done) == list(range(10))


def test_submit_blocks_while_every_slot_is_taken():
    """With inflight=1 and the first item's force held, a second submit
    waits for the slot."""
    gate = threading.Event()
    real = engine_core.Engine._force

    def held_force(out):
        assert gate.wait(WAIT_S)
        return real(out)

    eng = Engine(inflight=1, io_threads=1, name="t-block")
    eng._force = held_force
    eng.submit(0, lambda: np.zeros(2), lambda v: v, on_done=lambda *a: None,
               on_error=lambda *a: None)
    t = threading.Thread(target=eng.submit, args=(1, lambda: np.zeros(2), lambda v: v),
                         kwargs={"on_done": lambda *a: None, "on_error": lambda *a: None})
    t.start()
    time.sleep(0.05)
    assert t.is_alive()  # blocked on the slot
    gate.set()
    t.join(WAIT_S)
    assert not t.is_alive()
    _drain(eng)
    assert eng.metrics.snapshot()["completed"] == 2


def test_submit_after_close_raises_and_close_is_idempotent():
    eng = Engine(inflight=1, io_threads=1, name="t-closed")
    eng.close()
    eng.close()
    assert eng.closed
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(0, lambda: 1, lambda x: x, on_done=lambda *a: None, on_error=lambda *a: None)


def test_error_routing_at_force_and_at_encode():
    """An armed engine.complete fails one item's force and the rest drain;
    an on_done failure goes to that item's on_error."""
    x = np.zeros((4, 4), np.uint8)
    fn = lambda v: torch.as_tensor(v) + 1  # noqa: E731
    oks, errs = [], []
    failpoints.configure("engine.complete=first:1")
    eng = Engine(inflight=2, io_threads=1, name="t-err")
    for k in range(4):
        eng.submit(k, lambda: x, fn, on_done=lambda k, out, info: oks.append(k),
                   on_error=lambda k, e: errs.append((k, type(e).__name__)))
    _drain(eng)
    assert errs == [(0, "FailpointError")] and sorted(oks) == [1, 2, 3]
    failpoints.clear()
    oks, errs = [], []

    def bad_then_good(k, out, info):
        if k == 0:
            raise IOError("disk full")
        oks.append(k)

    eng = Engine(inflight=2, io_threads=1, name="t-err2")
    for k in range(3):
        eng.submit(k, lambda: x, fn, on_done=bad_then_good,
                   on_error=lambda k, e: errs.append((k, type(e).__name__)))
    _drain(eng)
    assert errs == [(0, "OSError")] and sorted(oks) == [1, 2]
    assert eng.metrics.snapshot()["failed"] == 1


def test_ordered_delivery_when_an_item_fails():
    """ordered_done: on_done runs strictly in submission order, and an item
    that fails at force (the third) advances the gate instead of wedging
    it."""
    order, errs = [], []
    real = engine_core.Engine._force

    def force(out):
        if int(out[0]) == 2:
            raise RuntimeError("transfer failed")
        return real(out)

    def on_done(k, out, info):
        time.sleep(0.002 * (5 - k))  # later items would finish first
        order.append(k)

    eng = Engine(inflight=3, io_threads=4, name="t-ordered", ordered_done=True)
    eng._force = force
    for k in range(6):
        eng.submit(k, lambda k=k: np.full(3, k), lambda v: v, on_done=on_done,
                   on_error=lambda k, e: errs.append(k))
    _drain(eng)
    assert errs == [2] and order == [0, 1, 3, 4, 5]


def test_run_failure_at_submit_releases_the_slot():
    """A dispatch that raises in `run` propagates to the caller and gives
    its slot back: the next submit does not block."""
    eng = Engine(inflight=1, io_threads=1, name="t-run")

    def boom(v):
        raise ValueError("enqueue failed")

    with pytest.raises(ValueError, match="enqueue failed"):
        eng.submit(0, lambda: 1, boom, on_done=lambda *a: None, on_error=lambda *a: None)
    got = []
    eng.submit(1, lambda: np.ones(2), lambda v: v, on_done=lambda k, o, i: got.append(k),
               on_error=lambda *a: None)
    _drain(eng)
    assert got == [1]


def test_metrics_snapshot_and_summary_line():
    m = EngineMetrics()
    assert m.device_idle_frac() is None and m.active_window_s() is None
    fn = Pipeline.parse(REFERENCE_OPS).jit("cuda", device="cpu", plan="off")
    img = synthetic_image(12, 16, seed=3)
    eng = Engine(inflight=2, io_threads=1, metrics=m, stage=device_stager("cpu"), name="t-m")
    for k in range(5):
        eng.submit(k, lambda: img, fn, on_done=lambda *a: None,
                   on_error=lambda k, e: pytest.fail(str(e)))
    _drain(eng)
    s = m.snapshot()
    for stage in ("build", "h2d", "enqueue", "force", "encode"):
        assert set(s["stages"][stage]) == {"p50_ms", "p95_ms", "p99_ms"}
    assert (s["submitted"], s["completed"], s["failed"]) == (5, 5, 0)
    assert 0.0 <= s["device_idle_frac"] <= 1.0
    line = m.summary_line()
    assert line.startswith("engine: 5/5 batches (0 failed), inflight peak ")
    assert "device idle" in line and "force p50" in line
    text = m.registry.render()
    for family in ("mcim_engine_submitted_total", "mcim_engine_completed_total",
                   "mcim_engine_failed_total", "mcim_engine_inflight_peak",
                   "mcim_engine_device_idle_seconds_total", "mcim_engine_stage_seconds"):
        assert family in text


def _idle(serial: bool) -> float:
    """device_idle_frac of 6 items of tiny device work and a 40 ms encode:
    a serial loop (each item drained before the next) or the pipelined
    engine at inflight 2."""
    fn = Pipeline.parse(REFERENCE_OPS).jit("cuda", device="cpu", plan="off")
    img = synthetic_image(8, 16, seed=4)
    m = EngineMetrics()
    eng = Engine(inflight=1 if serial else 2, io_threads=1, metrics=m, name="t-idle")
    for k in range(6):
        eng.submit(k, lambda: img, fn, on_done=lambda *a: time.sleep(0.04),
                   on_error=lambda k, e: pytest.fail(str(e)))
        if serial:
            assert eng.flush(timeout=WAIT_S)
    _drain(eng)
    return m.device_idle_frac()


def test_device_idle_frac_serial_near_one_pipelined_lower():
    """JAX's definition (engine/metrics.py): a completion-thread wait that
    starts with nothing dispatched is device idle. A serial loop around a
    slow encode leaves the device idle almost the whole window; the
    pipelined engine keeps dispatches outstanding through it."""
    serial, pipelined = _idle(True), _idle(False)
    assert serial > 0.7, serial
    assert pipelined < serial - 0.2, (pipelined, serial)


def test_force_walks_tuples_and_passes_host_values():
    """_force keeps jax.device_get's contract: tuples and lists walked,
    numpy passed through, CPU tensors as their numpy arrays."""
    a = np.arange(6, dtype=np.uint8).reshape(2, 3)
    t = torch.arange(4, dtype=torch.uint8)
    got = Engine._force((a, [t, 7], {"k": 1}))
    assert isinstance(got, tuple) and got[0] is a
    assert isinstance(got[1], list) and isinstance(got[1][0], np.ndarray)
    np.testing.assert_array_equal(got[1][0], t.numpy())
    assert got[1][1] == 7 and got[2] == {"k": 1}
    assert Engine._force(a) is a


def test_cpu_stager_copies():
    """On the CPU the stager is a plain copy: the staged tensor holds the
    bytes and shares no memory with the host array."""
    stage = device_stager("cpu")
    x = synthetic_image(5, 7, seed=1)
    staged = stage(x)
    assert isinstance(staged, torch.Tensor) and staged.device.type == "cpu"
    np.testing.assert_array_equal(staged.numpy(), x)
    x[0, 0, 0] ^= 0xFF
    assert staged[0, 0, 0].item() != x[0, 0, 0]


@pytest.mark.parametrize("spec", [REFERENCE_OPS, "gaussian:5", "sepia,median:3"])
def test_jit_donate_equals_undonated_and_jax(spec):
    img = synthetic_image(21, 34, seed=11)
    want = _jax(spec, img)
    plain = Pipeline.parse(spec).jit("cuda", device="cpu", plan="off")(img)
    x = torch.from_numpy(img.copy())
    got = Pipeline.parse(spec).jit("cuda", device="cpu", plan="off", donate=True)(x)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert x.numel() == 0  # the donated input was dropped


@pytest.mark.parametrize("backend,plan", [("cuda", "off"), ("cuda", "fused-pallas"),
                                          ("torch", "off")])
def test_batched_donate_equals_undonated_and_jax(backend, plan):
    spec = REFERENCE_OPS
    stack = np.stack([synthetic_image(19, 24, seed=20 + k) for k in range(3)])
    want = np.asarray(JaxPipeline.parse(spec).batched()(stack))
    plain = Pipeline.parse(spec).batched(backend, device="cpu", plan=plan)(stack)
    x = torch.from_numpy(stack.copy())
    got = Pipeline.parse(spec).batched(backend, device="cpu", plan=plan, donate=True)(x)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert x.numel() == 0


def test_donate_keeps_an_output_that_is_the_input():
    """A pipeline with no ops returns its input: donation drops the tensor
    object, never the bytes the output holds."""
    img = synthetic_image(6, 8, seed=2)
    x = torch.from_numpy(img.copy())
    out = Pipeline(ops=()).jit("torch", device="cpu", donate=True)(x)
    np.testing.assert_array_equal(out.numpy(), img)


@pytest.mark.cuda
def test_pinned_stager_and_d2h_on_the_card():
    """On the card: the stager's pinned copy on its own stream, the D2H on a
    side stream, many dispatches in flight; every output equal to the
    plain run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    fn = Pipeline.parse(REFERENCE_OPS).jit("cuda", device=dev, plan="off", donate=True)
    imgs = [synthetic_image(64, 96, seed=k) for k in range(12)]
    got = {}
    eng = Engine(inflight=3, stage=device_stager(dev, inflight=3), name="t-card")
    for k, img in enumerate(imgs):
        eng.submit(k, lambda img=img: img, fn,
                   on_done=lambda k, out, info: got.__setitem__(k, out.copy()),
                   on_error=lambda k, e: pytest.fail(str(e)))
    _drain(eng)
    for k, img in enumerate(imgs):
        want = Pipeline.parse(REFERENCE_OPS)(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got[k], want)


def test_idle_parts_bracket_the_idle_time_between_two_reads():
    """The idle wait in progress shows in `idle_parts()`, so that the idle
    seconds between two reads (the sums of the parts) lie between 0 and
    the time between them, also when a wait began before the first; the
    snapshot keeps the JAX package's keys."""
    eng = Engine(inflight=2, io_threads=1, name="t-idle")
    x = torch.zeros(4)

    def idle_now():
        return sum(eng.metrics.idle_parts())

    try:
        eng.submit(0, lambda: x, lambda v: v + 1, on_done=lambda k, out, info: None,
                   on_error=lambda k, e: pytest.fail(str(e)))
        assert eng.flush(timeout=WAIT_S)
        time.sleep(0.05)  # the completion thread waits idle from here on
        t0 = time.perf_counter()
        first = idle_now()
        assert eng.metrics.idle_parts()[1] > 0.0
        time.sleep(0.1)
        second = idle_now()
        window = time.perf_counter() - t0
        assert 0.1 <= second - first <= window
        eng.submit(1, lambda: x, lambda v: v + 1, on_done=lambda k, out, info: None,
                   on_error=lambda k, e: pytest.fail(str(e)))
        assert eng.flush(timeout=WAIT_S)
        # the wait closed into the counted seconds, none of it lost or
        # counted twice
        assert eng.metrics.idle_parts()[0] >= second - 1e-9
        assert "idle_open_s" not in eng.metrics.snapshot()
    finally:
        eng.close(timeout=WAIT_S)


# --------------------------------------------------------------------------
# the runtime lock-order recorder (analysis/lockcheck.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("donate", [False, True])
def test_engine_lock_order_recorder_acyclic(donate):
    """The engine's completion thread and encode pool under the port's
    lock-order recorder (the counterpart of the JAX package's
    test_engine_lock_order_recorder_acyclic): every output equals the JAX
    pipeline's, and the observed acquisition graph (engine _cond, metrics
    locks, queue internals) is cycle-free."""
    from mpi_cuda_imagemanipulation_tpu_torch.analysis import lockcheck

    fn = Pipeline.parse(REFERENCE_OPS).jit("cuda", device="cpu", plan="off", donate=donate)
    imgs = [synthetic_image(40 + (k % 3), 40, channels=3, seed=k) for k in range(10)]
    with lockcheck.recording():
        outs: dict[int, np.ndarray] = {}
        errs: list[BaseException] = []
        done_lock = threading.Lock()

        def on_done(key, out, info):
            with done_lock:
                outs[key] = np.asarray(out)

        def on_error(key, exc):
            with done_lock:
                errs.append(exc)

        eng = Engine(inflight=2, io_threads=2, stage=device_stager("cpu"), name="t-lockcheck")
        for k, img in enumerate(imgs):
            eng.submit(k, lambda img=img: img, fn, on_done=on_done, on_error=on_error)
        _drain(eng)
        assert not errs, errs
        assert sorted(outs) == list(range(10))
        for k, img in enumerate(imgs):
            np.testing.assert_array_equal(outs[k], _jax(REFERENCE_OPS, img), err_msg=f"image {k}")
    # recording().__exit__ asserted the observed graph acyclic
