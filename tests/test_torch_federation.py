"""The port's federation front door (federation/) on the CPU, against the
JAX package.

The cases of the JAX package's ``tests/test_federation.py`` through the
port (its two graph-coalescing cases are the port's since the pipeline
service landed): the durable registry (restart round trip, tombstones, a
torn tail, a corrupt interior line, idempotent re-push), quota leases
(shares never above one global budget across joins, reconnects and pod
deaths), the closed reroute vocabulary and the strict pod-heartbeat wire.
Then a differential: one seeded sequence of registry writes and lease
grants through both packages gives equal state and equal journal lines.
Then an in-process front door over two in-process port routers, each with
one replica on ``device='cpu'``: a spec registered once serves from both
pods byte-equal to the JAX package's ``Pipeline.parse(spec)``; a pod
silent past ``MCIM_FED_STALE_S`` is rerouted around as ``pod_down``; a
front-door restart on the same registry rehydrates it and re-pushes the
tenant state before its first forward.
"""

import json
import random
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mpi_cuda_imagemanipulation_tpu.federation import quota as jax_quota
from mpi_cuda_imagemanipulation_tpu.federation import registry as jax_registry
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu_torch.fabric.replica import ReplicaRuntime
from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import Router, RouterConfig
from mpi_cuda_imagemanipulation_tpu_torch.federation import quota as port_quota
from mpi_cuda_imagemanipulation_tpu_torch.federation import registry as port_registry
from mpi_cuda_imagemanipulation_tpu_torch.federation.control import PodHeartbeat
from mpi_cuda_imagemanipulation_tpu_torch.federation.frontdoor import (
    REROUTE_REASONS,
    FrontDoor,
    FrontDoorConfig,
    count_reroute,
)
from mpi_cuda_imagemanipulation_tpu_torch.federation.quota import LeaseLedger
from mpi_cuda_imagemanipulation_tpu_torch.federation.registry import KINDS, DurableRegistry
from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import chain_as_spec
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    decode_image_bytes,
    encode_image_bytes,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig

# fails the module if a process it spawned outlives it
from _torch_fabric_procs import no_children_left  # noqa: F401

# --------------------------------------------------------------------------
# durable registry: restart round trip, torn tail, idempotent re-push
# --------------------------------------------------------------------------


def test_registry_restart_round_trip(tmp_path):
    path = tmp_path / "fed.jsonl"
    reg = DurableRegistry(path).load()
    reg.put("tenant", "acme", {"tenant": "acme", "quota_requests": 10})
    reg.put("pipeline", "acme/dag-1", {"tenant": "acme", "spec": {"v": 1}})
    reg.put("session", "s-1", {"pod": "pod-a", "ops": "grayscale"})
    reg2 = DurableRegistry(path).load()  # a fresh instance on the same path
    assert reg2.loaded_records == 3
    assert reg2.skipped_lines == 0
    assert reg2.get("tenant", "acme")["quota_requests"] == 10
    assert reg2.get("pipeline", "acme/dag-1")["spec"] == {"v": 1}
    assert reg2.get("session", "s-1")["pod"] == "pod-a"
    assert reg2.counts() == {"tenant": 1, "pipeline": 1, "session": 1}


def test_registry_later_lines_win_and_tombstones(tmp_path):
    path = tmp_path / "fed.jsonl"
    reg = DurableRegistry(path).load()
    reg.put("tenant", "acme", {"tenant": "acme", "quota_requests": 10})
    reg.put("tenant", "acme", {"tenant": "acme", "quota_requests": 99})
    reg.put("session", "s-1", {"pod": "pod-a"})
    reg.delete("session", "s-1")
    reg2 = DurableRegistry(path).load()
    assert reg2.get("tenant", "acme")["quota_requests"] == 99
    assert reg2.get("session", "s-1") is None
    assert reg2.counts()["session"] == 0


def test_registry_corrupt_tail_truncation_recovery(tmp_path):
    path = tmp_path / "fed.jsonl"
    reg = DurableRegistry(path).load()
    reg.put("tenant", "acme", {"tenant": "acme"})
    with open(path, "a", encoding="utf-8") as f:  # a mid-write kill
        f.write('{"kind": "tenant", "key": "half')
    reg2 = DurableRegistry(path).load()
    assert reg2.loaded_records == 1
    assert reg2.skipped_lines == 1
    assert reg2.get("tenant", "acme") == {"tenant": "acme"}
    reg2.put("tenant", "bravo", {"tenant": "bravo"})  # terminates the torn line
    reg3 = DurableRegistry(path).load()
    assert reg3.get("tenant", "acme") is not None
    assert reg3.get("tenant", "bravo") is not None
    assert reg3.skipped_lines == 1


def test_registry_corrupt_interior_line_skipped(tmp_path):
    path = tmp_path / "fed.jsonl"
    with open(path, "w", encoding="utf-8") as f:
        f.write('{"kind": "tenant", "key": "a", "payload": {"x": 1}}\n')
        f.write("not json at all\n")
        f.write('{"kind": "bogus-kind", "key": "b", "payload": {}}\n')
        f.write('{"kind": "tenant", "key": "c", "payload": {"x": 3}}\n')
    reg = DurableRegistry(path).load()
    assert reg.loaded_records == 2
    assert reg.skipped_lines == 2
    assert reg.get("tenant", "a") == {"x": 1}
    assert reg.get("tenant", "c") == {"x": 3}


def test_registry_idempotent_repush_and_kind_guard(tmp_path):
    path = tmp_path / "fed.jsonl"
    reg = DurableRegistry(path).load()
    rec = {"tenant": "acme", "spec": {"v": 1}}
    reg.put("pipeline", "acme/p", rec)
    reg.put("pipeline", "acme/p", rec)  # re-push: harmless
    reg2 = DurableRegistry(path).load()
    assert reg2.items("pipeline") == {"acme/p": rec}
    with pytest.raises(ValueError):
        reg.put("nonsense", "k", {})
    assert set(KINDS) == {"tenant", "pipeline", "session"}


# --------------------------------------------------------------------------
# quota leases: shares sum <= budget, always
# --------------------------------------------------------------------------

CFG = {"quota_requests": 10, "quota_bytes": None, "window_s": 100.0}


def _ledger(t=0.0):
    holder = {"t": t}
    return LeaseLedger(clock=lambda: holder["t"]), holder


def test_lease_single_pod_gets_whole_budget():
    led, _ = _ledger()
    share = led.lease("acme", CFG, "pod-a", ["pod-a"], now=5.0)
    assert share["quota_requests"] == 10
    assert share["quota_bytes"] is None


def test_lease_shares_sum_to_budget_across_joins():
    led, _ = _ledger()
    s1 = led.lease("acme", CFG, "pod-a", ["pod-a", "pod-b"], now=5.0)
    s2 = led.lease("acme", CFG, "pod-b", ["pod-a", "pod-b"], now=6.0)
    assert s1["quota_requests"] == 5
    assert s1["quota_requests"] + s2["quota_requests"] <= 10
    s3 = led.lease("acme", CFG, "pod-c", ["pod-a", "pod-b", "pod-c"], now=7.0)
    assert s1["quota_requests"] + s2["quota_requests"] + s3["quota_requests"] <= 10


def test_lease_reconnect_is_idempotent():
    led, _ = _ledger()
    s1 = led.lease("acme", CFG, "pod-a", ["pod-a"], now=5.0)
    issued = led.grants_issued
    s2 = led.lease("acme", CFG, "pod-a", ["pod-a"], now=50.0)  # same window
    assert s2 == s1
    assert led.grants_issued == issued


def test_lease_dead_pod_grant_stays_booked_until_window_rolls():
    led, _ = _ledger()
    s1 = led.lease("acme", CFG, "pod-a", ["pod-a", "pod-b"], now=5.0)
    led.lease("acme", CFG, "pod-b", ["pod-a", "pod-b"], now=5.0)
    s3 = led.lease("acme", CFG, "pod-c", ["pod-b", "pod-c"], now=50.0)
    assert s3["quota_requests"] == 0
    s4 = led.lease("acme", CFG, "pod-c", ["pod-b", "pod-c"], now=150.0)
    assert s4["quota_requests"] == 5
    assert s4["window_id"] != s1["window_id"]


@pytest.mark.parametrize("n_pods", [1, 2, 3, 7])
def test_lease_no_budget_multiplication_by_pod_count(n_pods):
    led, _ = _ledger()
    pods = [f"pod-{i}" for i in range(n_pods)]
    shares = [led.lease("acme", CFG, p, pods, now=5.0)["quota_requests"] for p in pods]
    assert sum(shares) <= 10, (n_pods, shares)


def test_leases_for_pod_skips_quota_less_tenants():
    led, _ = _ledger(t=5.0)
    tenants = {"acme": CFG, "free": {"quota_requests": None, "quota_bytes": None}}
    out = led.leases_for_pod("pod-a", tenants, ["pod-a"])
    assert set(out) == {"acme"}
    assert out["acme"]["quota_requests"] == 10


# --------------------------------------------------------------------------
# closed reroute vocabulary + strict heartbeat wire format
# --------------------------------------------------------------------------


class _Counter:
    def __init__(self):
        self.by_reason = {}

    def inc(self, n=1, **labels):
        self.by_reason[labels["reason"]] = self.by_reason.get(labels["reason"], 0) + n


def test_count_reroute_rejects_unknown_reason():
    c = _Counter()
    for reason in REROUTE_REASONS:
        count_reroute(c, reason)
    assert set(c.by_reason) == set(REROUTE_REASONS)
    with pytest.raises(ValueError):
        count_reroute(c, "cosmic-rays")


def test_pod_heartbeat_wire_is_strict():
    hb = PodHeartbeat(
        pod_id="pod-a", addr="127.0.0.1", port=8090, pid=42, incarnation="abc", routable=3,
        queued=1, queue_depth=64, warm_buckets=["48x48x3"], pipelines=["dag-1"], seq=7,
        sent_unix_s=123.0,
    )
    wire = json.loads(hb.to_json())
    back = PodHeartbeat.from_json(hb.to_json())
    assert back.pod_id == "pod-a" and back.seq == 7
    with pytest.raises(ValueError):
        PodHeartbeat.from_json(json.dumps({**wire, "surprise": 1}).encode())
    missing = dict(wire)
    del missing["incarnation"]
    with pytest.raises(ValueError):
        PodHeartbeat.from_json(json.dumps(missing).encode())


# --------------------------------------------------------------------------
# differential: one seeded sequence through both packages
# --------------------------------------------------------------------------


def _script(seed: int):
    """A seeded sequence of registry writes (put/delete of every kind) and
    lease grants (pods joining, reconnecting and dying across windows)."""
    rng = random.Random(seed)
    steps = []
    for i in range(60):
        r = rng.random()
        if r < 0.45:
            kind = rng.choice(("tenant", "pipeline", "session"))
            payload = {"v": rng.randrange(100), "tenant": rng.choice("abc"),
                       "quota_requests": rng.choice((None, 6, 10, 25))}
            steps.append(("put", kind, f"k{rng.randrange(6)}", payload))
        elif r < 0.55:
            steps.append(("delete", rng.choice(("tenant", "pipeline", "session")),
                          f"k{rng.randrange(6)}"))
        else:
            live = sorted(rng.sample([f"pod-{j}" for j in range(5)], rng.randint(1, 4)))
            cfg = {"quota_requests": rng.choice((4, 10, 17)),
                   "quota_bytes": rng.choice((None, 10_000)), "window_s": 30.0}
            steps.append(("lease", rng.choice("xyz"), cfg, rng.choice(live), live,
                          i * 2.5))
    return steps


def _replay(registry_mod, quota_mod, path, steps, monkeypatch):
    monkeypatch.setattr(registry_mod.time, "time", lambda: 1_700_000_000.0)
    reg = registry_mod.DurableRegistry(path).load()
    led = quota_mod.LeaseLedger(clock=lambda: 0.0)
    grants = []
    for step in steps:
        if step[0] == "put":
            reg.put(*step[1:])
        elif step[0] == "delete":
            reg.delete(*step[1:])
        else:
            _, tenant, cfg, pod, live, now = step
            grants.append(led.lease(tenant, cfg, pod, live, now=now))
    reloaded = registry_mod.DurableRegistry(path).load()
    state = {k: reloaded.items(k) for k in registry_mod.KINDS}
    return state, grants, led.grants_issued, path.read_text().splitlines()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_and_leases_equal_jax(tmp_path, monkeypatch, seed):
    steps = _script(seed)
    ours = _replay(port_registry, port_quota, tmp_path / "port.jsonl", steps, monkeypatch)
    theirs = _replay(jax_registry, jax_quota, tmp_path / "jax.jsonl", steps, monkeypatch)
    assert ours == theirs
    assert ours[3], "the script wrote journal lines"


# --------------------------------------------------------------------------
# an in-process front door over two in-process pods (device='cpu')
# --------------------------------------------------------------------------

OPS = "grayscale,contrast:3.5"
BUCKETS = "48,96"
STALE_S = 0.8


def _post(url: str, path: str, data: bytes, headers=None):
    req = urllib.request.Request(url + path, data=data, headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post_retry(url, path, data, headers=None, deadline_s=20.0):
    """Retry explicit sheds (503 + Retry-After): a pod converging is not a
    failure."""
    t_end = time.monotonic() + deadline_s
    while True:
        code, hdrs, body = _post(url, path, data, headers)
        if code != 503 or not hdrs.get("Retry-After") or time.monotonic() > t_end:
            return code, hdrs, body
        time.sleep(0.1)


def _wait_pods(door, want: set, deadline_s: float = 30.0) -> None:
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        now = door._clock()
        fresh = {v.pod_id for v in door.table.views()
                 if v.fresh(now, door.stale_s) and v.hb.routable >= 1}
        if fresh == want:
            return
        time.sleep(0.05)
    raise AssertionError(f"pods {sorted(want)} never fresh at the front door")


def _fed(door, family: str) -> dict:
    fam = parse_exposition(door.registry.render()).get(family)
    return dict(fam["samples"]) if fam else {}


@pytest.fixture(scope="module")
def federation(tmp_path_factory):
    """A front door on a free port and two pods (a router + one in-process
    replica each, device='cpu') heartbeating to it."""
    registry = str(tmp_path_factory.mktemp("fed") / "fed_registry.jsonl")
    cfg = FrontDoorConfig(registry_path=registry, buckets=tuple(parse_buckets(BUCKETS)),
                          stale_s=STALE_S, forward_timeout_s=20.0, forward_attempts=3)
    door = FrontDoor(cfg).start(host="127.0.0.1", port=0)
    scfg = ServeConfig(ops=OPS, buckets=parse_buckets(BUCKETS), max_batch=4, max_delay_ms=5.0,
                       queue_depth=64, channels=(3,), device="cpu")
    pods = {}
    for i in range(2):
        router = Router(RouterConfig(buckets=parse_buckets(BUCKETS), stale_s=2.0,
                                     forward_attempts=3)).start()
        rep = ReplicaRuntime(f"p{i}r0", router.url, scfg, heartbeat_s=0.1).start()
        router.federate(door.url, f"pod{i}", interval_s=0.1)
        pods[f"pod{i}"] = (router, rep)
    state = {"door": door, "cfg": cfg, "pods": pods}
    try:
        _wait_pods(door, {"pod0", "pod1"})
        yield state
    finally:
        state["door"].close()
        for router, rep in pods.values():
            rep.close()
            router.close()


def _register(door_url: str) -> str:
    code, _h, out = _post(door_url, "/v1/tenants",
                          json.dumps({"tenant": "acme", "qos": "interactive"}).encode())
    assert code == 200, out[:200]
    code, _h, out = _post(door_url, "/v1/pipelines",
                          json.dumps({"tenant": "acme", "spec": chain_as_spec(OPS)}).encode())
    assert code == 200, out[:300]
    reg = json.loads(out)
    assert reg["persisted"] and set(reg["pods"]) == {"pod0", "pod1"}, reg
    return reg["pipeline"]


def test_spec_registered_once_serves_from_both_pods_equal_to_jax(federation):
    door = federation["door"]
    pid = federation.setdefault("pid", _register(door.url))
    hdrs = {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid}
    for shape, seed in (((40, 44), 50), ((80, 72), 51)):
        img = synthetic_image(*shape, channels=3, seed=seed)
        want = np.asarray(JaxPipeline.parse(OPS)(img))
        blob = encode_image_bytes(img)
        code, h, out = _post_retry(door.url, "/v1/process", blob, hdrs)
        assert code == 200, out[:200]
        assert h.get("X-Fed-Pod") in ("pod0", "pod1"), h
        np.testing.assert_array_equal(decode_image_bytes(out), want)
        # straight at each pod's router: the broadcast put the spec there
        for router, _rep in federation["pods"].values():
            code, _h, out = _post_retry(router.url, "/v1/process", blob, hdrs)
            assert code == 200, out[:200]
            np.testing.assert_array_equal(decode_image_bytes(out), want)


def test_silent_pod_reroutes_as_pod_down(federation, monkeypatch):
    door = federation["door"]
    pid = federation.setdefault("pid", _register(door.url))
    hdrs = {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid}
    blob = encode_image_bytes(synthetic_image(40, 44, channels=3, seed=52))
    code, h, _out = _post_retry(door.url, "/v1/process", blob, hdrs)
    assert code == 200
    victim = h["X-Fed-Pod"]
    survivor = {"pod0": "pod1", "pod1": "pod0"}[victim]
    before = sum(v for k, v in _fed(door, "mcim_fed_reroutes_total").items()
                 if 'reason="pod_down"' in k[1])
    failpoints.install("pod.heartbeat", lambda ctx: ctx["pod"] == victim)
    try:
        _wait_pods(door, {survivor}, deadline_s=10.0)
        for _ in range(3):
            code, h, out = _post(door.url, "/v1/process", blob, hdrs)
            assert code == 200 and h["X-Fed-Pod"] == survivor, (code, h)
    finally:
        failpoints.clear()
    reroutes = _fed(door, "mcim_fed_reroutes_total")
    assert {k[1].split('reason="')[1].split('"')[0] for k in reroutes} <= set(REROUTE_REASONS)
    after = sum(v for k, v in reroutes.items() if 'reason="pod_down"' in k[1])
    assert after >= before + 3
    _wait_pods(door, {"pod0", "pod1"}, deadline_s=10.0)


def test_frontdoor_restart_rehydrates_and_repushes(federation):
    door = federation["door"]
    pid = federation.setdefault("pid", _register(door.url))
    port = door.address[1]
    door.close()
    door = federation["door"] = FrontDoor(federation["cfg"]).start(host="127.0.0.1",
                                                                    port=port)
    assert door.durable.loaded_records >= 2 and door.durable.skipped_lines == 0
    with urllib.request.urlopen(door.url + "/stats", timeout=10) as r:
        st = json.loads(r.read())
    assert "acme" in st["tenants"] and f"acme/{pid}" in st["specs"], st
    _wait_pods(door, {"pod0", "pod1"})
    img = synthetic_image(40, 44, channels=3, seed=53)
    code, _h, out = _post_retry(door.url, "/v1/process", encode_image_bytes(img),
                                {"X-MCIM-Tenant": "acme", "X-MCIM-Pipeline": pid})
    assert code == 200, out[:200]
    np.testing.assert_array_equal(decode_image_bytes(out),
                                  np.asarray(JaxPipeline.parse(OPS)(img)))
    assert sum(_fed(door, "mcim_fed_pushes_total").values()) >= 1
