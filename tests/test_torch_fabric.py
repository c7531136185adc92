"""The port's serving fabric (fabric/) on the CPU, against the JAX package.

The cases of the JAX package's ``tests/test_fabric.py``, through the port:
the heartbeat wire (byte-equal JSON to the JAX package's for the same
fields, and each package parses the other's), the replica table, the
routing policy over injected heartbeats (the rendezvous scores and the
route chosen for the same table equal the JAX router's), the in-process
fabric (the router and two ``ReplicaRuntime``s on ``device='cpu'``) whose
responses are byte-equal to the JAX package's ``Pipeline.jit`` golden, the
mesh lane on 4 CPU slots for an oversize image, and the churn acceptance:
three spawned replica processes (``--device cpu``), one SIGKILLed mid-load,
every accepted request ok and byte-equal, the restart rejoining, and the
``replica_death`` recorder dump.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

from mpi_cuda_imagemanipulation_tpu.fabric import control as jax_control
from mpi_cuda_imagemanipulation_tpu.fabric import router as jax_router
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.serve.bucketing import parse_buckets as jax_parse_buckets
from mpi_cuda_imagemanipulation_tpu_torch.fabric.control import Heartbeat
from mpi_cuda_imagemanipulation_tpu_torch.fabric.replica import ReplicaRuntime
from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import (
    Router,
    RouterConfig,
    _rendezvous_score,
)
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    decode_image_bytes,
    encode_image_bytes,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig

# fails the module if a replica or worker process it spawned outlives it
from _torch_fabric_procs import no_children_left  # noqa: F401

OPS = "grayscale,contrast:3.5"
BUCKETS = "48,96"


def _golden(img: np.ndarray) -> np.ndarray:
    """The JAX package's per-request golden path."""
    return np.asarray(JaxPipeline.parse(OPS).jit()(img))


# --------------------------------------------------------------------------
# control plane: heartbeat protocol + replica table
# --------------------------------------------------------------------------


def _fields(rid: str, *, state: str = "serving", queued: int = 0, queue_depth: int = 64,
            breaker_open=(), warm=(), incarnation: str = "i1", port: int = 1,
            seq: int = 1) -> dict:
    return dict(
        replica_id=rid, addr="127.0.0.1", port=port, pid=0, incarnation=incarnation,
        state=state, queued=queued, queue_depth=queue_depth,
        breaker_open=list(breaker_open), warm_buckets=list(warm), seq=seq,
        sent_unix_s=0.0,
    )


def _hb(rid: str, **kw) -> Heartbeat:
    return Heartbeat(**_fields(rid, **kw))


def test_heartbeat_json_roundtrip():
    hb = _hb("r0", warm=["48x48"], breaker_open=["96x96"])
    assert Heartbeat.from_json(hb.to_json()) == hb


@pytest.mark.parametrize("extra", [
    {},
    {"pipelines": ["dag-abc"], "systolic": True},
    {"metrics": {"seq": 3, "baseline_seq": 2, "full": False, "metrics": {}}},
])
def test_heartbeat_wire_equals_jax(extra):
    fields = {**_fields("r3", warm=["48x48", "96x96"], queued=5, seq=9), **extra}
    ours = Heartbeat(**fields).to_json()
    theirs = jax_control.Heartbeat(**fields).to_json()
    assert ours == theirs
    assert jax_control.Heartbeat.from_json(ours) == jax_control.Heartbeat(**fields)
    assert Heartbeat.from_json(theirs) == Heartbeat(**fields)


def test_heartbeat_rejects_version_skew():
    raw = json.loads(_hb("r0").to_json())
    raw["bogus_field"] = 1
    with pytest.raises(ValueError, match="unknown fields"):
        Heartbeat.from_json(json.dumps(raw).encode())
    del raw["bogus_field"]
    del raw["state"]
    with pytest.raises(ValueError, match="missing fields"):
        Heartbeat.from_json(json.dumps(raw).encode())


def test_heartbeat_carries_pipelines():
    hb = _hb("r0")
    hb.pipelines = ["dag-abc"]
    assert Heartbeat.from_json(hb.to_json()).pipelines == ["dag-abc"]
    # a beat without the optional field still parses (defaulted)
    legacy = json.loads(hb.to_json())
    legacy.pop("pipelines")
    assert Heartbeat.from_json(json.dumps(legacy).encode()).pipelines is None


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _router(**cfg_over) -> tuple[Router, _Clock]:
    clock = _Clock()
    cfg = RouterConfig(buckets=parse_buckets(BUCKETS), stale_s=1.0, forward_attempts=3,
                       shed_frac=0.8, **cfg_over)
    return Router(cfg, clock=clock), clock


def test_table_detects_restart_incarnation():
    router, clock = _router()
    assert router.table.observe(_hb("r0"), clock()) is True
    assert router.table.observe(_hb("r0"), clock()) is False
    assert router.table.observe(_hb("r0", incarnation="i2"), clock()) is True


# --------------------------------------------------------------------------
# routing policy (pure, over injected heartbeats), against the JAX router
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", ["48x48", "96x96", "1024x1024", "other"])
@pytest.mark.parametrize("rid", ["r0", "r1", "r7", "replica-12"])
def test_rendezvous_score_equals_jax(bucket, rid):
    assert _rendezvous_score(bucket, rid) == jax_router._rendezvous_score(bucket, rid)


_TABLES = {
    "cold": [dict(rid="r0"), dict(rid="r1"), dict(rid="r2")],
    "warm": [dict(rid="r0"), dict(rid="r1", warm=["48x48"]), dict(rid="r2", warm=["96x96"])],
    "degraded": [dict(rid="r0", warm=["48x48"], state="degraded"), dict(rid="r1")],
    "loaded": [dict(rid="r0", warm=["48x48"], queued=60), dict(rid="r1", queued=3),
               dict(rid="r2", queued=1)],
    "breaker": [dict(rid="r0", warm=["48x48"], breaker_open=["48x48"]), dict(rid="r1")],
    "draining": [dict(rid="r0", state="draining"), dict(rid="r1", warm=["96x96"])],
}


@pytest.mark.parametrize("bucket", ["48x48", "96x96"])
@pytest.mark.parametrize("table", sorted(_TABLES))
def test_route_equals_jax_for_the_same_table(table, bucket):
    clock = _Clock()
    ours = Router(RouterConfig(buckets=parse_buckets(BUCKETS), stale_s=1.0, shed_frac=0.8),
                  clock=clock)
    theirs = jax_router.Router(
        jax_router.RouterConfig(buckets=jax_parse_buckets(BUCKETS), stale_s=1.0,
                                shed_frac=0.8),
        clock=clock)
    try:
        for row in _TABLES[table]:
            kw = dict(row)
            fields = _fields(kw.pop("rid"), **kw)
            ours.table.observe(Heartbeat(**fields), clock())
            theirs.table.observe(jax_control.Heartbeat(**fields), clock())
        cands, policy = ours.route(bucket)
        jcands, jpolicy = theirs.route(bucket)
        assert policy == jpolicy
        assert [c.replica_id for c in cands] == [c.replica_id for c in jcands]
    finally:
        ours.close()
        theirs.close()


def test_route_prefers_warm_replica():
    router, clock = _router()
    router.table.observe(_hb("r0"), clock())
    router.table.observe(_hb("r1", warm=["48x48"]), clock())
    cands, policy = router.route("48x48")
    assert policy == "sticky"
    assert cands[0].replica_id == "r1"  # warm beats rendezvous
    assert [c.replica_id for c in cands[1:]] == ["r0"]


def test_route_consistent_hash_fallback_is_deterministic():
    router, clock = _router()
    router.table.observe(_hb("r0"), clock())
    router.table.observe(_hb("r1"), clock())
    first = router.route("96x96")[0][0].replica_id
    for _ in range(5):
        assert router.route("96x96")[0][0].replica_id == first
    want = max(("r0", "r1"), key=lambda rid: _rendezvous_score("96x96", rid))
    assert first == want


def test_route_sheds_off_degraded_and_loaded_sticky():
    router, clock = _router()
    router.table.observe(_hb("r0", warm=["48x48"], state="degraded"), clock())
    router.table.observe(_hb("r1"), clock())
    cands, policy = router.route("48x48")
    assert (policy, cands[0].replica_id) == ("least_loaded", "r1")
    router.table.observe(_hb("r0", warm=["48x48"], queued=60, queue_depth=64), clock())
    cands, policy = router.route("48x48")
    assert (policy, cands[0].replica_id) == ("least_loaded", "r1")
    router.table.observe(_hb("r0", warm=["48x48"], breaker_open=["48x48"]), clock())
    cands, policy = router.route("48x48")
    assert (policy, cands[0].replica_id) == ("least_loaded", "r1")


def test_route_excludes_stale_and_reports_none():
    router, clock = _router()
    router.table.observe(_hb("r0"), clock())
    clock.t += 0.5
    assert router.route("48x48")[0]  # fresh
    clock.t += 1.0  # past stale_s
    cands, policy = router.route("48x48")
    assert cands == [] and policy == "none"


def test_restart_resets_router_breaker():
    router, _clock = _router()
    router.handle_heartbeat(_hb("r0").to_json())
    b = router.breakers.get("r0")
    b.on_failure()
    b.on_failure()
    assert b.state != "closed"
    router.handle_heartbeat(_hb("r0", incarnation="i2").to_json())
    assert router.breakers.get("r0").state == "closed"


def test_sniff_dims_png_header_only():
    img = synthetic_image(37, 53, channels=3, seed=1)
    assert Router._sniff_dims(encode_image_bytes(img)) == (37, 53)


# --------------------------------------------------------------------------
# in-process fabric: router + 2 replica runtimes on the CPU, real HTTP
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_fabric():
    """Router + two in-process replicas (threads, not processes) on
    device='cpu'. Process-level churn gets its own test below."""
    cfg = ServeConfig(ops=OPS, buckets=parse_buckets(BUCKETS), max_batch=4, max_delay_ms=5.0,
                      queue_depth=64, channels=(3,), device="cpu")
    router = Router(RouterConfig(buckets=parse_buckets(BUCKETS), stale_s=2.0,
                                 forward_attempts=3, breaker_threshold=2,
                                 breaker_reset_s=0.5)).start()
    reps = [ReplicaRuntime(f"r{i}", router.url, cfg, heartbeat_s=0.15).start()
            for i in range(2)]
    deadline = time.monotonic() + 60.0
    while len(router._routable()) < 2:
        assert time.monotonic() < deadline, "replicas never registered"
        time.sleep(0.05)
    yield router
    for rt in reps:
        rt.close()
    router.close()


def _post(router: Router, img: np.ndarray) -> dict:
    return loadgen.http_post_image(router.url, encode_image_bytes(img))


def test_fabric_roundtrip_equals_jax_golden(small_fabric):
    for shape, seed in (((40, 44), 3), ((48, 48), 4), ((90, 66), 5)):
        img = synthetic_image(*shape, channels=3, seed=seed)
        r = _post(small_fabric, img)
        assert r["code"] == 200
        assert r["replica"] in ("r0", "r1")
        np.testing.assert_array_equal(decode_image_bytes(r["body"]), _golden(img))


def test_replica_stats_bracket_the_engine_idle_time(small_fabric):
    """A replica's /stats carries its engine's idle wait in progress beside
    the seconds counted, so that two reads bracket the idle time between
    them (what the throughput lane reads by replica)."""
    views = {v.replica_id: v for v in small_fabric._routable()}
    url = f"http://127.0.0.1:{views['r0'].hb.port}/stats"
    _post(small_fabric, synthetic_image(40, 44, channels=3, seed=3))

    def idle_now() -> float:
        with urllib.request.urlopen(url, timeout=10) as r:
            eng = json.loads(r.read())["engine"]
        assert eng["idle_open_s"] >= 0.0
        return eng["idle_s"] + eng["idle_open_s"]

    t0 = time.monotonic()
    first = idle_now()
    time.sleep(0.2)
    second = idle_now()
    assert 0.0 <= second - first <= time.monotonic() - t0


def test_fabric_oversize_rejected_without_mesh(small_fabric):
    img = synthetic_image(120, 120, channels=3, seed=6)  # > 96x96
    assert _post(small_fabric, img)["code"] == 400


def test_fabric_healthz_stats_metrics(small_fabric):
    code, payload = small_fabric.healthz()
    assert code == 200 and len(payload["routable"]) == 2
    st = small_fabric.stats()
    assert set(st["replicas"]) == {"r0", "r1"}
    for rep in st["replicas"].values():
        assert rep["state"] == "serving" and rep["fresh"]
        assert rep["queue_depth"] == 64
    with urllib.request.urlopen(small_fabric.url + "/metrics", timeout=10) as resp:
        fams = parse_exposition(resp.read().decode())
    for fam in ("mcim_fabric_requests_total", "mcim_fabric_forwards_total",
                "mcim_fabric_replicas_routable", "mcim_fabric_heartbeats_total"):
        assert fam in fams, f"{fam} missing from /metrics"
    # the replicas' device-memory families federate (their series, labelled
    # by replica, exist where a card is: the CPU reports none)
    assert "mcim_devmem_bytes_in_use" in fams


def test_fabric_heartbeat_loss_reroutes(small_fabric):
    """Injected heartbeat loss on ONE replica (which keeps serving) routes
    its traffic to the sibling within the staleness window."""
    img = synthetic_image(40, 40, channels=3, seed=7)
    target = _post(small_fabric, img)["replica"]
    other = {"r0": "r1", "r1": "r0"}[target]
    failpoints.install("replica.heartbeat", lambda ctx: ctx["replica"] == target)
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if [v.replica_id for v in small_fabric._routable()] == [other]:
                break
            time.sleep(0.05)
        assert [v.replica_id for v in small_fabric._routable()] == [other]
        for _ in range(3):
            assert _post(small_fabric, img)["replica"] == other
    finally:
        failpoints.clear()
    deadline = time.monotonic() + 10.0
    while len(small_fabric._routable()) < 2:
        assert time.monotonic() < deadline, "silenced replica never rejoined"
        time.sleep(0.05)


def test_fabric_forward_failpoint_reroutes_and_counts(small_fabric):
    failpoints.configure("router.forward=once")
    try:
        before = small_fabric._m_retries.value()
        img = synthetic_image(88, 88, channels=3, seed=8)
        r = _post(small_fabric, img)
        assert r["code"] == 200
        assert r["attempts"] == 2  # first attempt injected dead, rerouted
        assert small_fabric._m_retries.value() == before + 1
        np.testing.assert_array_equal(decode_image_bytes(r["body"]), _golden(img))
    finally:
        failpoints.clear()


def test_fabric_trace_spans_cover_router_and_replica(small_fabric):
    """One trace id covers the full hop: the router roots fabric.request,
    propagates the id via X-Trace-Id, and the replica's serve.request root
    adopts it (in-process replicas share the tracer)."""
    tracer = obs_trace.configure(sample=1.0)
    try:
        r = _post(small_fabric, synthetic_image(44, 44, channels=3, seed=9))
        assert r["code"] == 200 and r["trace_id"]
        by_name = {}
        for e in tracer.drain():
            if e["args"].get("trace_id") == r["trace_id"]:
                by_name.setdefault(e["name"], []).append(e)
        for name in ("fabric.request", "fabric.forward", "serve.request", "serve.dispatch"):
            assert name in by_name, f"span {name!r} missing: {sorted(by_name)}"
    finally:
        obs_trace.disable()


def test_fabric_profile_relays_to_one_replica(small_fabric):
    """POST /control/profile through the router: one replica's capture on
    the CPU (obs/profile.capture_live), relayed back."""
    req = urllib.request.Request(small_fabric.url + "/control/profile",
                                 data=json.dumps({"seconds": 0.2}).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            code, payload = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        code, payload = e.code, json.loads(e.read())
    assert code in (200, 429), payload
    assert payload.get("replica") in ("r0", "r1")


# --------------------------------------------------------------------------
# the mesh lane: 4 CPU slots, an oversize image, the JAX golden
# --------------------------------------------------------------------------


@pytest.mark.parametrize("halo_mode", ["serial", "overlap"])
def test_mesh_lane_serves_oversize_equal_to_jax(halo_mode):
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.mesh import MeshLane

    lane = MeshLane(OPS, 4, halo_mode=halo_mode, device="cpu")
    assert [d.type for d in lane.mesh.devices] == ["cpu"] * 4
    router = Router(RouterConfig(buckets=parse_buckets(BUCKETS), stale_s=1.0),
                    mesh_lane=lane).start()
    try:
        img = synthetic_image(130, 140, channels=3, seed=10)  # > 96x96
        r = loadgen.http_post_image(router.url, encode_image_bytes(img))
        assert r["code"] == 200
        assert r["replica"] == "mesh"
        np.testing.assert_array_equal(decode_image_bytes(r["body"]), _golden(img))
        assert lane.stats()["dispatches"] == 1
    finally:
        router.close()


def test_mesh_lane_cuda_backend_on_cpu_slots_equals_jax():
    """backend='cuda' on CPU slots runs the ghost-mode kernels' plain
    versions: the same bytes."""
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.mesh import MeshLane

    ops = "grayscale,contrast:3.5,emboss:3"
    lane = MeshLane(ops, 4, backend="cuda", device="cpu")
    img = synthetic_image(133, 70, channels=3, seed=11)
    want = np.asarray(JaxPipeline.parse(ops).jit()(img))
    np.testing.assert_array_equal(lane.process(img), want)
    with pytest.raises(ValueError, match="backend"):
        MeshLane(ops, 4, backend="swar", device="cpu")


# --------------------------------------------------------------------------
# ACCEPTANCE: three replica PROCESSES on the CPU, SIGKILL mid-load, rejoin
# --------------------------------------------------------------------------


def test_churn_acceptance_kill_one_of_three_mid_loadgen(tmp_path, monkeypatch):
    """A 3-replica fabric takes a SIGKILL of a serving replica mid-sweep
    with every accepted request resolving ok and byte-equal to the JAX
    golden, the router breaker opens for the dead replica, the restarted
    replica rejoins and receives traffic, and the death leaves a
    flight-recorder dump naming the dead replica's warm buckets."""
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.supervisor import Fabric, FabricConfig

    rec_dir = str(tmp_path / "recorder")
    monkeypatch.setenv("MCIM_RECORDER_DIR", rec_dir)
    monkeypatch.setenv("MCIM_RECORDER_MIN_INTERVAL_S", "0")
    images = [synthetic_image(40 + 7 * i, 44 + 5 * i, channels=3, seed=20 + i)
              for i in range(6)]
    blobs = [encode_image_bytes(im) for im in images]
    golden = [_golden(im) for im in images]
    cfg = FabricConfig(
        replicas=3, ops=OPS, buckets=BUCKETS, channels="3", max_batch=4, queue_depth=64,
        heartbeat_s=0.2, device="cpu",
        router=RouterConfig(buckets=parse_buckets(BUCKETS), stale_s=2.0, forward_attempts=3,
                            breaker_threshold=2, breaker_reset_s=0.5),
        supervisor_backoff_s=0.25,
    )
    with Fabric(cfg).start(ready_timeout_s=120.0) as fab:
        probe = loadgen.http_post_image(fab.url, blobs[0])
        assert probe["code"] == 200
        victim = probe["replica"]
        killed: list[int] = []
        phases = loadgen.churn_run(
            fab.url, blobs, offered_rps=40.0, phase_s=1.5,
            kill=lambda: killed.append(fab.kill_replica(victim)),
            before_after=lambda: fab.wait_ready(3, timeout_s=120.0),
        )
        for name, ph in phases.items():
            assert ph["ok_frac"] == 1.0, (
                f"phase {name}: {ph['submitted'] - ph['ok']} of {ph['submitted']} not ok")
            for k, r in ph["results"]:
                np.testing.assert_array_equal(decode_image_bytes(r["body"]), golden[k])
        assert killed, "churn kill never fired"
        assert phases["during"]["retried"] >= 1
        assert fab.router.breakers.snapshot()["open_events"] >= 1
        assert fab.supervisor.restarts(victim) >= 1
        deadline = time.monotonic() + 20.0
        while True:  # serving, and its last beat inside the stale window
            st = fab.router.stats()["replicas"][victim]
            if st["state"] == "serving" and st["fresh"]:
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.05)
        deadline = time.monotonic() + 20.0
        seen = set()
        while time.monotonic() < deadline and victim not in seen:
            for b in blobs:
                seen.add(loadgen.http_post_image(fab.url, b)["replica"])
        assert victim in seen, f"restarted {victim} never served again (saw {seen})"
        dumps = sorted(p for p in (os.listdir(rec_dir) if os.path.isdir(rec_dir) else [])
                       if p.startswith("recorder_replica_death"))
        assert dumps, f"no replica_death dump in {rec_dir}"
        with open(os.path.join(rec_dir, dumps[0])) as f:
            dump = json.load(f)
        assert dump["extra"]["replica"] == victim
        assert dump["extra"].get("warm_buckets"), dump["extra"]
        assert dump["summary"]["last_heartbeat"].get(victim)
