"""The port's fabric router lanes on the CPU, against the JAX package.

The router and supervisor cases of the JAX package's
``tests/test_deadline.py`` (the retry budget, 504 relayed as final, the
deadline checked before each attempt, hedging won/lost/suppressed, the
Fabric's waits on an injected clock), the graph lane of
``tests/test_graph.py`` (a registration broadcast through the router, the
byte-transparent proxy, the spec re-pushed after a replica restart), the
systolic lane through the router (the placement over two in-process
replicas, the answer equal to the JAX package's graph), and the CLI:
``fabric`` and ``serve --replicas N`` build the pod's config (a stand-in
Fabric, so no process is spawned) and refuse the CUDA device where there
is none.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu import graph as jgraph
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.fabric import supervisor as fabric_supervisor
from mpi_cuda_imagemanipulation_tpu_torch.fabric.control import Heartbeat
from mpi_cuda_imagemanipulation_tpu_torch.fabric.replica import ReplicaRuntime
from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import Router, RouterConfig
from mpi_cuda_imagemanipulation_tpu_torch.fabric.supervisor import Fabric, FabricConfig
from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import chain_as_spec
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    decode_image_bytes,
    encode_image_bytes,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.resilience import deadline as dl
from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig

BUCKETS = parse_buckets("48")
OPS = "grayscale,contrast:3.5"


class _Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _mk_router(**over) -> Router:
    r = Router(RouterConfig(buckets=BUCKETS, **over))
    now = r._clock()
    for i, rid in enumerate(("r0", "r1")):
        r.table.observe(Heartbeat(
            replica_id=rid, addr="127.0.0.1", port=i + 1, pid=0, incarnation="i1",
            state="serving", queued=0, queue_depth=64, breaker_open=[],
            warm_buckets=["48x48"], seq=1, sent_unix_s=0.0), now)
    return r


def _root():
    t = obs_trace.start_trace("test.request")
    t.end()
    return t


def _two(r):
    views = r.table.views()
    return (next(v for v in views if v.replica_id == "r0"),
            next(v for v in views if v.replica_id == "r1"))


# --------------------------------------------------------------------------
# the router's request lifecycle: retry budget, deadlines, hedging
# --------------------------------------------------------------------------


def test_router_gives_up_when_budget_denied():
    r = _mk_router()
    try:
        r.retry_budget = dl.RetryBudget(frac=0.0, reserve=0.0)
        r._forward_once = lambda *a, **k: (503, "application/json", b'{"status":"x"}', [])
        code, *_ = r._forward_with_retries(_root(), "48x48", b"img", r.table.views())
        assert code == 503
        assert r._m_budget_denied.value(tier="router") == 1.0
        assert r.retry_budget.stats()["denied"] == 1
    finally:
        r.close()


def test_router_relays_504_as_final():
    r = _mk_router()
    try:
        calls = []

        def once(view, body, tid, extra_headers=()):
            calls.append(view.replica_id)
            return 504, "application/json", b'{"status":"x"}', []

        r._forward_once = once
        code, *_ = r._forward_with_retries(_root(), "48x48", b"img", r.table.views())
        assert code == 504 and len(calls) == 1  # never burns a second replica
    finally:
        r.close()


def test_router_checks_deadline_before_each_attempt():
    r = _mk_router()
    try:
        clk = _Clock()
        r._clock = clk
        d = dl.Deadline(50.0, clock=clk)
        clk.t += 1.0  # dead before the first forward
        called = []
        r._forward_once = lambda *a, **k: called.append(1)
        code, _ct, out, _h = r._forward_with_retries(_root(), "48x48", b"img",
                                                     r.table.views(), deadline=d)
        assert code == 504 and b"deadline_expired" in out and not called
        assert r._m_deadline.value(tier="router") == 1.0
    finally:
        r.close()


def test_router_budget_knobs_read_through_the_registry(monkeypatch):
    monkeypatch.setenv("MCIM_RETRY_BUDGET_FRAC", "0.25")
    monkeypatch.setenv("MCIM_RETRY_BUDGET_RESERVE", "3")
    monkeypatch.setenv("MCIM_HEDGE_MAX_FRAC", "0.5")
    r = _mk_router()
    try:
        st = r.retry_budget.stats()
        assert st["frac"] == 0.25 and st["reserve"] == 3.0
        assert r.hedge_max_frac == 0.5
    finally:
        r.close()


def test_hedge_secondary_wins_and_withdraws_budget():
    r = _mk_router(hedge_delay_frac=0.5, hedge_max_frac=1.0)
    release = threading.Event()
    try:
        def once(view, body, tid, extra_headers=()):
            if view.replica_id == "r0":
                release.wait(5.0)  # the slow primary
                return 200, "image/png", b"slow", []
            return 200, "image/png", b"fast", []

        r._forward_once = once
        v0, v1 = _two(r)
        before = r.retry_budget.stats()["withdrawn"]
        code, _ct, out, _h, rid, extra = r._forward_maybe_hedged(v0, [v1], b"img", "t", (), 0.05)
        release.set()
        assert (code, out, rid, extra) == (200, b"fast", "r1", 1)
        assert r._m_hedges.value(outcome="won") == 1.0
        assert r.retry_budget.stats()["withdrawn"] == before + 1
    finally:
        release.set()
        r.close()


def test_hedge_fast_primary_never_fires_secondary():
    r = _mk_router(hedge_delay_frac=0.5, hedge_max_frac=1.0)
    try:
        r._forward_once = (lambda view, body, tid, extra_headers=():
                           (200, "image/png", b"p:" + view.replica_id.encode(), []))
        v0, v1 = _two(r)
        code, _ct, out, _h, rid, extra = r._forward_maybe_hedged(v0, [v1], b"img", "t", (), 1.0)
        assert (code, out, rid, extra) == (200, b"p:r0", "r0", 0)
        for outcome in dl.HEDGE_OUTCOMES:
            assert r._m_hedges.value(outcome=outcome) == 0.0
    finally:
        r.close()


@pytest.mark.parametrize("cap,budget_frac,outcome", [
    (0.0, None, "suppressed_cap"),
    (1.0, 0.0, "suppressed_budget"),
])
def test_hedge_suppressed_by_cap_and_budget(cap, budget_frac, outcome):
    r = _mk_router(hedge_delay_frac=0.5, hedge_max_frac=cap)
    try:
        if budget_frac is not None:
            r.retry_budget = dl.RetryBudget(frac=budget_frac, reserve=0.0)

        def once(view, body, tid, extra_headers=()):
            threading.Event().wait(0.12)  # past the hedge delay, then answer
            return 200, "image/png", b"p", []

        r._forward_once = once
        v0, v1 = _two(r)
        code, _ct, _o, _h, rid, extra = r._forward_maybe_hedged(v0, [v1], b"img", "t", (), 0.02)
        assert (code, rid, extra) == (200, "r0", 0)
        assert r._m_hedges.value(outcome=outcome) == 1.0
    finally:
        r.close()


def _fake_fabric_clock(fab: Fabric) -> _Clock:
    clk = _Clock(0.0)
    fab._clock = clk
    fab._sleep = lambda dt: setattr(clk, "t", clk.t + dt)
    return clk


def test_fabric_wait_ready_times_out_on_fake_clock():
    fab = Fabric(FabricConfig(replicas=1, buckets="48", device="cpu"))
    try:
        clk = _fake_fabric_clock(fab)
        with pytest.raises(TimeoutError, match="not serving within"):
            fab.wait_ready(1, timeout_s=30.0)
        assert clk.t >= 30.0
    finally:
        fab.router.close()


def test_fabric_wait_incarnation_change_times_out_on_fake_clock():
    fab = Fabric(FabricConfig(replicas=1, buckets="48", device="cpu"))
    try:
        clk = _fake_fabric_clock(fab)
        with pytest.raises(TimeoutError, match="did not re-register"):
            fab._wait_incarnation_change("r0", "i0", timeout_s=45.0)
        assert clk.t >= 45.0
    finally:
        fab.router.close()


# --------------------------------------------------------------------------
# the graph lane and the systolic lane through the router
# --------------------------------------------------------------------------


def _post(base, path, data, headers=None):
    req = urllib.request.Request(base + path, data=data, headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _wait_routable(router, n, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while len(router._routable()) < n:
        assert time.monotonic() < deadline, "replicas never registered"
        time.sleep(0.05)


def _jax_graph(spec, img):
    fn = jax.jit(jgraph.graph_callable(jgraph.compile_graph(jgraph.parse_spec(spec))))
    return jax.tree_util.tree_map(np.asarray, fn(img))


def test_router_graph_lane_affinity_and_repush():
    """Registration broadcasts through the router, the graph lane forwards
    tenant + pipeline headers byte-transparently, and after a replica
    restart the router re-pushes the stored spec before forwarding (the
    convergence window answers 503 + Retry-After, never an error)."""
    router = Router(RouterConfig(buckets=BUCKETS, stale_s=2.0)).start()
    cfg = ServeConfig(ops=OPS, buckets=((48, 48),), channels=(3,), max_batch=2, device="cpu")
    rt = ReplicaRuntime("r0", router.url, cfg, heartbeat_s=0.1).start()
    try:
        _wait_routable(router, 1)
        code, _, out = _post(router.url, "/v1/pipelines",
                             json.dumps({"tenant": "acme", "spec": chain_as_spec(OPS)}).encode())
        assert code == 200
        reg = json.loads(out)
        assert reg["replicas"] == {"r0": 200}
        pid = reg["pipeline"]
        img = synthetic_image(33, 40, channels=3, seed=5)
        blob = encode_image_bytes(img)
        hdrs = {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid}
        c1, _h1, direct = _post(f"http://127.0.0.1:{rt.server.address[1]}", "/v1/process",
                                blob, hdrs)
        c2, h2, via_router = _post(router.url, "/v1/process", blob, hdrs)
        assert (c1, c2) == (200, 200)
        assert direct == via_router  # the proxy is byte-transparent
        assert h2.get("X-Fabric-Replica") == "r0"
        np.testing.assert_array_equal(decode_image_bytes(direct),
                                      _jax_graph(chain_as_spec(OPS), img)["image"])
        rt.close()  # restart: a fresh runtime with an empty graph registry
        rt = ReplicaRuntime("r0", router.url, cfg, heartbeat_s=0.1).start()
        deadline = time.monotonic() + 30
        while True:
            c3, h3, out3 = _post(router.url, "/v1/process", blob, hdrs)
            if c3 == 200:
                break
            assert c3 == 503 and h3.get("Retry-After"), (c3, out3[:200])
            assert time.monotonic() < deadline, "never reconverged"
            time.sleep(0.2)
        assert out3 == direct
        assert router._m_graph_pushes.value() >= 1
    finally:
        rt.close()
        router.close()


SYSTOLIC_SPEC = {
    "version": 1,
    "name": "unsharp5",
    "nodes": [
        {"id": "src", "kind": "source"},
        {"id": "g", "kind": "op", "op": "grayscale", "input": "src"},
        {"id": "blur", "kind": "op", "op": "gaussian:5", "input": "g"},
        {"id": "sharp", "kind": "op", "op": "sharpen", "input": "blur"},
        {"id": "c", "kind": "op", "op": "contrast:2", "input": "sharp"},
        {"id": "mask", "kind": "merge", "merge": "subtract", "inputs": ["g", "c"]},
    ],
    "outputs": {"image": "mask", "histogram": "mask"},
}


def test_router_systolic_lane_places_two_owners_equal_to_jax(monkeypatch):
    """systolic=True: the router stage-shards a registered DAG over two
    systolic replicas (graph.compile.place_steps), the entry owner relays
    the chain's answer, and the bytes and histogram equal the JAX
    package's graph; with one systolic replica the lane falls back
    (reason 'replicas') to the pinned lane with the same bytes."""
    monkeypatch.setenv("MCIM_SYSTOLIC_MIN_STEPS", "2")
    router = Router(RouterConfig(buckets=BUCKETS, stale_s=2.0, systolic=True)).start()
    cfg = ServeConfig(ops=OPS, buckets=((48, 48),), channels=(3,), max_batch=2, device="cpu",
                      systolic=True)
    reps = [ReplicaRuntime(f"r{i}", router.url, cfg, heartbeat_s=0.1).start() for i in range(2)]
    try:
        _wait_routable(router, 2)
        code, _, out = _post(router.url, "/v1/pipelines",
                             json.dumps({"tenant": "acme", "spec": SYSTOLIC_SPEC}).encode())
        assert code == 200, out
        pid = json.loads(out)["pipeline"]
        assert pid == jgraph.dag_fingerprint(jgraph.parse_spec(SYSTOLIC_SPEC))
        img = synthetic_image(40, 36, channels=3, seed=7)
        want = _jax_graph(SYSTOLIC_SPEC, img)
        hdrs = {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid}
        c, h, body = _post(router.url, "/v1/process", encode_image_bytes(img), hdrs)
        assert c == 200, body
        np.testing.assert_array_equal(decode_image_bytes(body), want["image"])
        assert json.loads(h["X-MCIM-Histogram"]) == want["histogram"].tolist()
        last = router._systolic_last[pid]
        assert sorted(last["owners"]) == ["r0", "r1"] and len(last["ranges"]) == 2
        assert router._m_sys_placed.value() == 2
        reps[1].close()  # one systolic owner left: the pinned lane answers
        deadline = time.monotonic() + 10.0
        while len(router._routable()) > 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        c, _h, body = _post(router.url, "/v1/process", encode_image_bytes(img), hdrs)
        assert c == 200
        np.testing.assert_array_equal(decode_image_bytes(body), want["image"])
        assert router._m_sys_fallbacks.value(reason="replicas") >= 1
    finally:
        for rt in reps:
            rt.close()
        router.close()


# --------------------------------------------------------------------------
# the CLI: fabric and serve --replicas N
# --------------------------------------------------------------------------


class _StandInFabric:
    """Records the FabricConfig cmd_fabric builds; start() returns at
    once as an interrupt would, so no replica process is spawned."""

    configs: list = []

    def __init__(self, config):
        self.config = config
        self.supervisor = None
        _StandInFabric.configs.append(config)

    def start(self, host="", port=0):
        raise KeyboardInterrupt

    def close(self, drain=True):
        pass


def test_fabric_arms_the_mesh_lane_on_the_kernels_backend():
    """The pod's mesh lane runs Pipeline.sharded at backend 'cuda': the
    ghost-mode kernels on the card, their plain versions on CPU slots,
    equal to the JAX golden for an image larger than every bucket."""
    fab = Fabric(FabricConfig(replicas=1, ops="grayscale,contrast:3.5,emboss:3", buckets="48",
                              device="cpu", mesh_shards=4))
    lane = fab.router.mesh_lane
    assert (lane.backend, [d.type for d in lane.mesh.devices]) == ("cuda", ["cpu"] * 4)
    from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline

    img = synthetic_image(131, 60, channels=3, seed=12)
    want = np.asarray(JaxPipeline.parse(fab.config.ops).jit()(img))
    np.testing.assert_array_equal(lane.process(img), want)


@pytest.mark.parametrize("argv,want", [
    (["fabric", "--device", "cpu", "--replicas", "2", "--mesh-shards", "4",
      "--impl", "auto", "--slo", "avail:99"],
     dict(replicas=2, device="cpu", impl="torch", mesh_shards=4)),
    (["serve", "--device", "cpu", "--replicas", "3", "--buckets", "48", "--impl", "mxu",
      "--plan", "fused"],
     dict(replicas=3, device="cpu", impl="mxu", buckets="48", plan="fused", mesh_shards=0)),
])
def test_cli_builds_the_pod_config(argv, want, monkeypatch):
    monkeypatch.setattr(fabric_supervisor, "Fabric", _StandInFabric)
    _StandInFabric.configs.clear()
    assert cli.main(argv) == 0
    (cfg,) = _StandInFabric.configs
    for k, v in want.items():
        assert getattr(cfg, k) == v, k


@pytest.mark.parametrize("argv", [
    ["fabric", "--port", "0"],
    ["serve", "--port", "0", "--replicas", "2"],
])
def test_cli_pod_refuses_cuda_without_a_card(argv, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(fabric_supervisor, "Fabric", _StandInFabric)
    _StandInFabric.configs.clear()
    assert cli.main(argv) == 2
    assert "cuda" in capsys.readouterr().err
    assert _StandInFabric.configs == []  # refused before any pod was built
