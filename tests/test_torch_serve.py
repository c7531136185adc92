"""The port's online serving path (serve/scheduler.py, serve/server.py,
serve/cache.py, serve/metrics.py, serve/loadgen.py, obs/devmem.py,
graph/tenancy.py, plan/metrics.py on the registry) on the CPU: the twins
of the JAX package's tests/test_serve.py:151-300 and of its serving cases
in tests/test_resilience.py.

Every served response is held to the JAX package's ``Pipeline.jit()`` on
the same seeded image (`_jax_golden`, one JAX function per shape). The
contracts: concurrent mixed shapes coalesce (mean occupancy > 1) and the
warmed grid absorbs every shape (``traces_since_warmup == 0``, no miss);
admission sheds past the queue depth and rejects what no bucket serves;
deadlines expire queued requests; stop drains; the ``serve.dispatch``
failpoint drives retry, bisect and quarantine, and an open breaker
degrades to the golden path; a ``submit_group`` lane coalesces; the
exposition carries the planner's and the device-memory families. One JAX
ServeApp is built for the module (`jax_app`), for the stats schema and the
metric families.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.graph import tenancy as jax_tenancy
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.obs import devmem as jax_devmem
from mpi_cuda_imagemanipulation_tpu.obs.metrics import Registry as JaxRegistry
from mpi_cuda_imagemanipulation_tpu.plan.metrics import plan_metrics as jax_plan_metrics
from mpi_cuda_imagemanipulation_tpu.serve import loadgen as jax_loadgen
from mpi_cuda_imagemanipulation_tpu.serve import server as jax_server
from mpi_cuda_imagemanipulation_tpu.serve.metrics import ServeMetrics as JaxServeMetrics
from mpi_cuda_imagemanipulation_tpu_torch.graph import tenancy
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.obs import devmem
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry, parse_exposition
from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import LabelCounts, PlanMetrics, plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.resilience.health import DEGRADED, SERVING
from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
from mpi_cuda_imagemanipulation_tpu_torch.serve.metrics import ServeMetrics
from mpi_cuda_imagemanipulation_tpu_torch.serve.scheduler import (
    STATUS_OK,
    STATUS_OVERLOADED,
    STATUS_QUARANTINED,
    DeadlineExceeded,
    GroupSpec,
    Overloaded,
    Quarantined,
    RequestRejected,
)
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import Client, ServeApp, ServeConfig

REFERENCE_OPS = "grayscale,contrast:3.5,emboss:3"
WAIT_S = 120


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


def _app(**over) -> ServeApp:
    cfg = ServeConfig(**{
        "ops": REFERENCE_OPS,
        "buckets": ((48, 48), (64, 64)),
        "max_batch": 4,
        "max_delay_ms": 10.0,
        "queue_depth": 64,
        "channels": (1, 3),
        "device": "cpu",
        **over,
    })
    return ServeApp(cfg).start()


_JAX_FNS: dict = {}


def _jax_golden(spec: str, img: np.ndarray) -> np.ndarray:
    fn = _JAX_FNS.setdefault(spec, JaxPipeline.parse(spec).jit())
    return np.asarray(jax.block_until_ready(fn(img)))


@pytest.fixture(scope="module")
def jax_app():
    app = jax_server.ServeApp(jax_server.ServeConfig(
        buckets=((32, 32),), max_batch=2, channels=(3,))).start()
    yield app
    app.stop()


# --------------------------------------------------------------------------
# concurrent mixed shapes == golden, coalesced, warm
# --------------------------------------------------------------------------


def test_serve_concurrent_mixed_shapes_byte_equal_and_warm():
    app = _app()
    try:
        client = Client(app)
        shapes = [(33, 47), (48, 48), (17, 60), (64, 64), (40, 40), (5, 60)]
        results, errs = [], []
        lock = threading.Lock()

        def worker(seed: int):
            try:
                h, w = shapes[seed % len(shapes)]
                img = synthetic_image(h, w, channels=3, seed=seed)
                out = client.process(img, timeout=WAIT_S)
                with lock:
                    results.append((img, out))
            except Exception as e:  # pragma: no cover - failure reporting
                with lock:
                    errs.append(e)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not errs, errs
        assert len(results) == 24
        for img, out in results:
            np.testing.assert_array_equal(out, _jax_golden(REFERENCE_OPS, img))
        m = app.metrics.snapshot()
        assert m["completed"] == 24
        assert m["mean_batch_occupancy"] > 1
        assert app.cache.traces_since_warmup == 0
        assert app.cache.misses == 0
        assert app.cache.hits == m["dispatches"]
        # the engine staged every dispatch through its H2D hook
        assert app.scheduler.engine.stage is not None
    finally:
        app.stop()


def test_serve_data_parallel_over_cpu_slots():
    """Dispatch stacks split over a 2-slot CPU mesh; batch buckets are
    multiples of the slots."""
    spec = "gaussian:5,sobel"
    app = _app(ops=spec, buckets=((64, 64),), shards=2, max_batch=4)
    try:
        assert app.cache.batch_buckets == (2, 4)
        client = Client(app)
        reqs = []
        for k in range(6):
            img = synthetic_image(40 + k % 7, 50 + k % 5, channels=3 if k % 2 else 1, seed=k)
            reqs.append((img, client.submit(img)))
        for img, r in reqs:
            np.testing.assert_array_equal(r.wait(WAIT_S), _jax_golden(spec, img))
        assert app.cache.traces_since_warmup == 0
    finally:
        app.stop()


# --------------------------------------------------------------------------
# admission control
# --------------------------------------------------------------------------


def test_overload_sheds_with_distinct_status_never_blocks():
    app = _app(queue_depth=4, max_batch=4, max_delay_ms=250.0, buckets=((32, 32),),
               channels=(3,))
    try:
        client = Client(app)
        img = synthetic_image(20, 20, channels=3, seed=0)
        # the batch bucket is 4: a full bucket dispatches at once, so hold
        # the dispatch loop on the condition while the burst arrives
        with app.scheduler._cond:
            reqs = [client.submit(img) for _ in range(12)]
        shed = [r for r in reqs if r.status == STATUS_OVERLOADED]
        assert len(shed) == 8
        for r in shed:
            assert r.done.is_set()
            with pytest.raises(Overloaded):
                r.wait(0)
        done = [r.wait(WAIT_S) for r in reqs if r.status != STATUS_OVERLOADED]
        assert len(done) == 4
        m = app.metrics.snapshot()
        assert m["shed_overloaded"] == 8 and m["completed"] == 4
        assert m["queued"] == 0
    finally:
        app.stop()


def test_reject_out_of_range_requests():
    app = _app(buckets=((48, 48),))
    try:
        client = Client(app)
        with pytest.raises(RequestRejected):  # larger than every bucket
            client.process(synthetic_image(100, 100, channels=3, seed=1))
        with pytest.raises(RequestRejected):  # below the stencil bound
            client.process(synthetic_image(1, 30, channels=3, seed=1))
        with pytest.raises(RequestRejected):  # wrong dtype
            client.process(np.zeros((20, 20, 3), np.float32))
        with pytest.raises(RequestRejected):  # a channel count grayscale cannot take
            client.process(synthetic_image(20, 20, channels=1, seed=1))
        assert app.metrics.snapshot()["rejected"] == 4
    finally:
        app.stop()


def test_deadline_expired_while_queued():
    app = _app(max_batch=4, max_delay_ms=150.0, queue_depth=8, buckets=((32, 32),),
               channels=(3,))
    try:
        r = Client(app).submit(synthetic_image(20, 20, channels=3, seed=3), deadline_ms=1.0)
        with pytest.raises(DeadlineExceeded):
            r.wait(WAIT_S)
        assert app.metrics.snapshot()["deadline_expired"] == 1
    finally:
        app.stop()


def test_stop_drains_admitted_requests():
    app = _app(max_batch=4, max_delay_ms=10_000.0, queue_depth=8, buckets=((32, 32),),
               channels=(3,))
    client = Client(app)
    img = synthetic_image(20, 20, channels=3, seed=4)
    reqs = [client.submit(img) for _ in range(3)]
    app.stop(drain=True)  # the delay never fired; the drain ships them
    for r in reqs:
        assert r.status == STATUS_OK
        np.testing.assert_array_equal(r.result, _jax_golden(REFERENCE_OPS, img))


def test_qos_ladder_sheds_low_classes_first():
    assert tenancy.QOS_CLASSES == jax_tenancy.QOS_CLASSES
    for qos in tenancy.QOS_CLASSES:
        for frac in (None, 0.25, 0.5, 0.9):
            assert tenancy.qos_admit_frac(qos, frac) == jax_tenancy.qos_admit_frac(qos, frac)
    app = _app(queue_depth=8, max_batch=4, max_delay_ms=10_000.0, buckets=((32, 32),),
               channels=(3,))
    try:
        img = synthetic_image(20, 20, channels=3, seed=5)
        s = app.scheduler
        with s._cond:  # nothing dispatches while the ladder fills
            # batch admits below half the depth (4 of 8), standard below
            # three quarters (6), interactive to the full depth
            got = {qos: [s.submit(img, qos=qos).status for _ in range(n)]
                   for qos, n in (("batch", 5), ("standard", 3), ("interactive", 3))}
        assert got["batch"] == [STATUS_OK] * 4 + [STATUS_OVERLOADED]
        assert got["standard"] == [STATUS_OK] * 2 + [STATUS_OVERLOADED]
        assert got["interactive"] == [STATUS_OK] * 2 + [STATUS_OVERLOADED]
        shed = app.registry.get("mcim_serve_qos_shed_total")
        assert (shed.value(qos="batch"), shed.value(qos="standard")) == (1, 1)
    finally:
        app.stop(drain=True)
    assert app.metrics.snapshot()["completed"] == 8


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------


def test_transient_faults_retry_and_stay_byte_equal():
    failpoints.configure("serve.dispatch=0.3", seed=7)
    app = _app(max_batch=4, max_delay_ms=5.0, retry_attempts=4, retry_base_delay_ms=1.0)
    try:
        client = Client(app)
        imgs = [synthetic_image(20 + k % 9, 30 + k % 7, channels=3, seed=k) for k in range(16)]
        reqs = [client.submit(img) for img in imgs]
        for r in reqs:
            assert r.done.wait(WAIT_S)
        n_ok = 0
        for img, r in zip(imgs, reqs):
            assert r.status in (STATUS_OK, STATUS_QUARANTINED)
            if r.status == STATUS_OK:
                n_ok += 1
                np.testing.assert_array_equal(r.result, _jax_golden(REFERENCE_OPS, img))
        assert n_ok > 0
        m = app.metrics.snapshot()
        assert m["retries"] >= 1
        assert (m["completed"] + m["quarantined"] + m["errors"] + m["shed_overloaded"]
                + m["rejected"] + m["deadline_expired"]) == m["submitted"]
        assert m["queued"] == 0
    finally:
        app.stop()


def test_poison_request_quarantined_alone_batchmates_succeed():
    poison_h = 13
    failpoints.install(
        "serve.dispatch", lambda ctx: any(r.true_h == poison_h for r in ctx["requests"]))
    app = _app(max_batch=4, max_delay_ms=40.0)
    try:
        client = Client(app)
        imgs = [
            synthetic_image(20, 30, channels=3, seed=1),
            synthetic_image(poison_h, 30, channels=3, seed=2),
            synthetic_image(21, 31, channels=3, seed=3),
            synthetic_image(22, 32, channels=3, seed=4),
        ]
        with app.scheduler._cond:  # one bucket: the four coalesce
            reqs = [client.submit(im) for im in imgs]
        for r in reqs:
            assert r.done.wait(WAIT_S)
        assert reqs[1].status == STATUS_QUARANTINED
        with pytest.raises(Quarantined):
            reqs[1].wait(0)
        for k in (0, 2, 3):
            assert reqs[k].status == STATUS_OK, reqs[k].error
            np.testing.assert_array_equal(reqs[k].result, _jax_golden(REFERENCE_OPS, imgs[k]))
        m = app.metrics.snapshot()
        assert m["quarantined"] == 1 and m["completed"] == 3
    finally:
        app.stop()


def test_breaker_opens_degrades_to_golden_then_recovers():
    failpoints.configure("serve.dispatch=always")
    app = _app(max_batch=2, max_delay_ms=2.0, retry_attempts=2, breaker_threshold=1,
               breaker_reset_s=0.5, retry_base_delay_ms=1.0)
    try:
        client = Client(app)
        img = synthetic_image(20, 30, channels=3, seed=5)
        with pytest.raises(Quarantined):
            client.process(img, timeout=WAIT_S)
        assert app.breakers.any_open()
        assert app.health.state == DEGRADED
        out = client.process(img, timeout=WAIT_S)  # the golden fallback
        np.testing.assert_array_equal(out, _jax_golden(REFERENCE_OPS, img))
        assert app.metrics.snapshot()["degraded"] >= 1
        assert app.breakers.snapshot()["open_events"] >= 1
        failpoints.clear()
        time.sleep(0.6)
        out = client.process(img, timeout=WAIT_S)  # the half-open probe
        np.testing.assert_array_equal(out, _jax_golden(REFERENCE_OPS, img))
        assert not app.breakers.any_open()
        assert app.health.state == SERVING
    finally:
        app.stop()


def test_submit_group_lane_coalesces_and_degrades():
    """A group lane: same-shape images stack as they are (no spatial pad),
    one batched dispatch, sliced per member; its own breaker and fallback."""
    spec = "gaussian:5,sobel"
    pipe = Pipeline.parse(spec)
    batched = pipe.batched("torch", device="cpu")
    built = []

    def get_fn(nb):
        built.append(nb)
        return lambda imgs: {"out": batched(imgs), "n": torch.full((imgs.shape[0],), nb)}

    group = GroupSpec(key=("lane", 24, 36), get_fn=get_fn,
                      fallback=lambda img: {"out": pipe.jit("torch", device="cpu")(img)})
    app = _app(max_batch=4, max_delay_ms=20.0)
    try:
        imgs = [synthetic_image(24, 36, channels=3, seed=k) for k in range(3)]
        with app.scheduler._cond:
            reqs = [app.scheduler.submit_group(img, group) for img in imgs]
        for img, r in zip(imgs, reqs):
            res = r.wait(WAIT_S)
            np.testing.assert_array_equal(res["out"], _jax_golden(spec, img))
            assert int(res["n"]) == 4
        assert built == [4]  # three members padded to the batch bucket 4, once
        app.breakers.get(group.key).on_failure()
        for _ in range(5):
            app.breakers.get(group.key).on_failure()
        r = app.scheduler.submit_group(imgs[0], group)
        np.testing.assert_array_equal(r.wait(WAIT_S)["out"], _jax_golden(spec, imgs[0]))
        assert app.metrics.snapshot()["degraded"] == 1
    finally:
        app.stop()


# --------------------------------------------------------------------------
# loadgen
# --------------------------------------------------------------------------


def test_loadgen_open_loop_sweep_smoke():
    app = _app(buckets=((32, 32), (64, 64)), max_delay_ms=3.0, channels=(3,))
    try:
        (rec,) = loadgen.sweep(app, offered_rps=(150.0,), duration_s=0.5, n_images=16)
        assert rec["submitted"] > 0
        assert rec["completed"] + rec["shed"] <= rec["submitted"]
        if rec["completed"]:
            assert rec["e2e_p50_ms"] <= rec["e2e_p99_ms"]
        assert app.cache.traces_since_warmup == 0
    finally:
        app.stop()


def test_loadgen_mixed_shapes_and_summaries_match_jax():
    kw = dict(channels=3, seed=7, min_dim=2)
    mine = loadgen.mixed_shapes(((32, 32), (64, 64)), 12, **kw)
    theirs = jax_loadgen.mixed_shapes(((32, 32), (64, 64)), 12, **kw)
    assert len(mine) == len(theirs) == 12
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    results = [(0, {"code": 200, "attempts": 1, "e2e_s": 0.01}),
               (1, {"code": 429, "attempts": 1, "e2e_s": 0.0}),
               (2, {"code": 503, "attempts": 2, "retry_after": "1", "e2e_s": 0.0}),
               (3, {"code": 504, "attempts": 1, "e2e_s": 0.0}),
               (4, {"code": 599, "attempts": 1, "e2e_s": 0.0}),
               (5, {"code": 200, "attempts": 1, "e2e_s": 0.03})]
    for dl in (None, 20.0):
        assert (loadgen.summarize_http_results(results, 2.0, 3.0, deadline_ms=dl)
                == jax_loadgen.summarize_http_results(results, 2.0, 3.0, deadline_ms=dl))
    img = synthetic_image(9, 11, channels=3, seed=1)
    assert bytes(loadgen.encode_blob(img)) == bytes(jax_loadgen.encode_blob(img))


# --------------------------------------------------------------------------
# metrics: the registry families, the stats schema
# --------------------------------------------------------------------------


def _families(text: str) -> set:
    return set(parse_exposition(text))


def test_metrics_exposition_carries_plan_and_devmem_families(jax_app):
    app = _app(buckets=((32, 32),), channels=(3,), max_batch=2, plan="fused")
    try:
        Client(app).process(synthetic_image(20, 20, channels=3, seed=1), timeout=WAIT_S)
        fams = _families(app.render_metrics())
        assert {"mcim_plan_builds_total", "mcim_plan_stages_total",
                "mcim_devmem_bytes_in_use", "mcim_devmem_devices",
                "mcim_serve_requests_total", "mcim_cache_traces_since_warmup"} <= fams
        # every family of the JAX app's exposition, and of the JAX planner's
        assert _families(jax_app.render_metrics()) <= fams
        assert _families(jax_plan_metrics.registry.render()) <= fams
        parsed = parse_exposition(app.render_metrics())
        assert parsed["mcim_devmem_devices"]["samples"][("mcim_devmem_devices", "")] == 0.0
        # the stats schema: JAX's keys (the live sessions' block too),
        # plus the device
        assert set(app.stats()) == set(jax_app.stats()) | {"device"}
    finally:
        app.stop()


def test_devmem_gauges_match_jax_and_never_raise():
    stats = {"cuda:0": {"bytes_in_use": 3 << 20, "peak_bytes_in_use": 5 << 20,
                        "bytes_limit": 80 << 30}}
    r, jr = Registry(), JaxRegistry()
    mine = devmem.DevMemGauges(r, stats_fn=lambda: stats)
    jax_devmem.DevMemGauges(jr, stats_fn=lambda: stats)
    def samples(text):
        return {k: v["samples"] for k, v in parse_exposition(text).items()}

    assert samples(r.render()) == samples(jr.render())
    assert mine.snapshot()["cuda:0"]["headroom_frac"] == pytest.approx(1 - (3 << 20) / (80 << 30))

    def broken():
        raise RuntimeError("no CUDA")

    r2 = Registry()
    g = devmem.DevMemGauges(r2, stats_fn=broken)
    assert "mcim_devmem_devices 0" in r2.render()
    assert g.snapshot() == {}
    if not torch.cuda.is_available():
        assert devmem.device_memory_stats() == {}


def test_plan_metrics_on_the_registry():
    ours = PlanMetrics()
    for mode in ("off", "fused", "fused-pallas"):
        ours.on_build(build_plan(make_pipeline_ops("grayscale,gaussian:5,sharpen"), mode))
    parsed = parse_exposition(ours.registry.render())
    builds = parsed["mcim_plan_builds_total"]["samples"]
    assert builds[("mcim_plan_builds_total", 'mode="fused"')] == ours.snapshot()["builds_fused"]
    assert set(parsed) >= {n for n in jax_plan_metrics.registry.names()}
    ours.pallas_stages += 2
    ours.pallas_fallbacks["lut-op"] += 1
    assert ours.pallas_stages == 2 and dict(ours.pallas_fallbacks) == {"lut-op": 1}
    with pytest.raises(ValueError, match="only go up"):
        ours.pallas_fallbacks["lut-op"] = 0
    ours.reset()
    assert set(ours.snapshot().values()) == {0} and not ours.pallas_fallbacks
    assert LabelCounts() == {} and isinstance(plan_metrics.builds, LabelCounts)


def test_serve_metrics_snapshot_matches_jax():
    mine, theirs = ServeMetrics(), JaxServeMetrics()
    for m in (mine, theirs):
        for _ in range(3):
            m.on_submit()
            m.on_admit()
        m.on_dispatch(2, 4, 0.01, "t1")
        m.on_complete(0.001, 0.02, "t1")
        m.on_complete(0.002, 0.03, "")
        m.on_deadline(0.5)
        m.on_submit()
        m.on_shed(qos="batch")
        m.on_retry()
        m.on_degraded()
    assert mine.snapshot() == theirs.snapshot()
    assert mine.summary_line() == theirs.summary_line()


def test_serving_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeApp(ServeConfig(buckets=((32, 32),)))


# --------------------------------------------------------------------------
# the runtime lock-order recorder (analysis/lockcheck.py)
# --------------------------------------------------------------------------


def test_serve_lock_order_recorder_acyclic():
    """Concurrent mixed-shape load with every scheduler, engine, cache,
    breaker and metrics lock instrumented by the port's recorder (the
    counterpart of the JAX package's test_serve_lock_order_recorder_acyclic):
    responses equal the JAX golden, the observed graph has nesting and is
    acyclic, and so is its merge with the port's static lock graph."""
    import os

    from mpi_cuda_imagemanipulation_tpu_torch.analysis import lockcheck
    from mpi_cuda_imagemanipulation_tpu_torch.analysis.rules_concurrency import lock_graph

    with lockcheck.recording() as rec:
        app = _app()
        try:
            client = Client(app)
            errs: list[Exception] = []
            results = []
            lock = threading.Lock()

            def worker(seed: int):
                try:
                    h, w = [(33, 47), (48, 48), (60, 64)][seed % 3]
                    img = synthetic_image(h, w, channels=3, seed=seed)
                    out = client.process(img, timeout=WAIT_S)
                    with lock:
                        results.append((img, out))
                except Exception as e:  # pragma: no cover - reporting
                    with lock:
                        errs.append(e)

            threads = [threading.Thread(target=worker, args=(k,)) for k in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT_S)
            assert not errs, errs
            assert len(results) == 12
            for img, out in results:
                np.testing.assert_array_equal(out, _jax_golden(REFERENCE_OPS, img))
        finally:
            app.stop()
        # the instrumented app really nested locks (scheduler._cond over the
        # metrics and cache locks at least)
        edges = rec.snapshot_edges()
        assert edges, "no lock nesting observed"
        assert any(a == "serve/scheduler.py:_cond" for a, _b in edges), sorted(edges)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        static = lock_graph(root)

        def site(node):
            return "/".join(node[0].split("/")[-2:]) + ":" + node[1]

        rec.assert_acyclic(extra_edges=[(site(a), site(b)) for (a, b) in static])
