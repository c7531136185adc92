"""The port's fleet observability on the CPU, against the JAX package:
metrics federation (obs/fleet.py), the SLO burn-rate engine (obs/slo.py)
and the pod heartbeat of the federation tier (federation/control.py).

The fleet and SLO cases of the JAX package's ``tests/test_fleet.py``
through the port: merged histograms equal the pooled observations, counter
sums survive restarts and preemption storms, deltas carry only changed
series, stale replicas age out; the ``FleetAggregator`` render after the
same delta sequence equals the JAX aggregator's text, and each package
folds the other's wire payloads; the ``SLOEngine`` on a fake clock fires
and clears where the JAX engine does, with the same status. End to end
(the router and two ``ReplicaRuntime``s on ``device='cpu'``): the /slo
alert fires under injected dispatch faults and clears, its p99 exemplar
resolves to a router -> replica span chain, and the federated /metrics
equals the sum of the replicas' ``/fleet/snapshot``. The pod heartbeat's
JSON equals the JAX package's, and the router's federation uplink pushes
it to a stand-in front door and applies its quota leases as the JAX
router does.
"""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from mpi_cuda_imagemanipulation_tpu.fabric import router as jax_router
from mpi_cuda_imagemanipulation_tpu.federation import control as jax_fed
from mpi_cuda_imagemanipulation_tpu.obs import fleet as jax_fleet
from mpi_cuda_imagemanipulation_tpu.obs import metrics as jax_metrics
from mpi_cuda_imagemanipulation_tpu.obs import slo as jax_slo
from mpi_cuda_imagemanipulation_tpu.serve.bucketing import parse_buckets as jax_parse_buckets
from mpi_cuda_imagemanipulation_tpu_torch.federation import control as fed_control
from mpi_cuda_imagemanipulation_tpu_torch.obs import fleet, slo
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import (
    Registry,
    parse_exposition,
    parse_labels,
)


class _Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# --------------------------------------------------------------------------
# federation math
# --------------------------------------------------------------------------


def _replica_registry(seed: int, n: int, registry_cls=Registry):
    r = registry_cls()
    c = r.counter("mcim_serve_requests_total", "req", labels=("status",))
    h = r.histogram("mcim_serve_e2e_latency_seconds", "lat")
    g = r.gauge("mcim_serve_queue_depth", "queue")
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        v = float(rng.uniform(0.0, 3.0))
        samples.append(v)
        h.observe(v, exemplar=f"t{seed}-{i}")
        c.inc(status="ok")
    g.set(float(seed))
    return r, samples


def _federate(regs, *, clock=None):
    clock = clock or _Clock()
    agg = fleet.FleetAggregator(stale_s=5.0, clock=clock)
    for i, reg in enumerate(regs):
        payload = json.loads(json.dumps(fleet.DeltaSource([reg]).delta()))  # the wire hop
        assert agg.apply(f"r{i}", "i1", payload)
    return agg


@pytest.mark.parametrize("seeds_and_sizes", [
    [(1, 40), (2, 70), (3, 25)],
    [(7, 1)],
    [(11, 13), (12, 40), (13, 2), (14, 39)],
])
def test_merged_histogram_equals_pooled_observations(seeds_and_sizes):
    regs, all_samples = [], []
    for seed, n in seeds_and_sizes:
        reg, samples = _replica_registry(seed, n)
        regs.append(reg)
        all_samples.extend(samples)
    merged = _federate(regs).merged()
    entry = merged["mcim_serve_e2e_latency_seconds"]
    data = entry["series"][()]
    ref_h = Registry().histogram("mcim_serve_ref_seconds", "ref")
    for v in all_samples:
        ref_h.observe(v)
    ref = ref_h.data()[()]
    assert data["buckets"] == ref["buckets"]
    assert data["count"] == ref["count"]
    assert data["sum"] == pytest.approx(ref["sum"])
    for q in (50, 95, 99):
        got = fleet.quantile_from_buckets(entry["bounds"], data["buckets"], data["count"], q)
        want = fleet.quantile_from_buckets(entry["bounds"], ref["buckets"], ref["count"], q)
        assert got == want
        assert got == jax_fleet.quantile_from_buckets(
            entry["bounds"], data["buckets"], data["count"], q)
    assert merged["mcim_serve_requests_total"]["series"][("ok",)] == float(len(all_samples))


def test_counter_sums_survive_replica_restart():
    agg = fleet.FleetAggregator(stale_s=5.0, clock=_Clock())
    reg1, _ = _replica_registry(1, 30)
    assert agg.apply("r0", "inc-a", fleet.DeltaSource([reg1]).delta())
    assert agg.merged()["mcim_serve_requests_total"]["series"][("ok",)] == 30.0
    reg2, _ = _replica_registry(1, 7)  # restart: fresh counters, new incarnation
    assert agg.apply("r0", "inc-b", fleet.DeltaSource([reg2]).delta())
    assert agg.merged()["mcim_serve_requests_total"]["series"][("ok",)] == 37.0
    assert agg.merged()["mcim_serve_e2e_latency_seconds"]["series"][()]["count"] == 37


def test_preemption_replacement_incarnations_never_double_count():
    agg = fleet.FleetAggregator(stale_s=5.0, clock=_Clock())
    reg1, _ = _replica_registry(1, 30)
    src1 = fleet.DeltaSource([reg1])
    first = src1.delta()
    assert agg.apply("r0", "inc-a", first)
    src1.ack(first["seq"])
    reg2, _ = _replica_registry(2, 7)
    src2 = fleet.DeltaSource([reg2])
    d = src2.delta()
    src2.ack(d["seq"])
    reg2.get("mcim_serve_requests_total").inc(status="ok")
    stale_delta = src2.delta()  # not full: baseline unknown to the router
    assert not stale_delta["full"]
    assert agg.apply("r0", "inc-b", stale_delta) is False
    assert "mcim_serve_requests_total" not in agg.merged()
    src2.force_full()
    assert agg.apply("r0", "inc-b", src2.delta())
    assert agg.merged()["mcim_serve_requests_total"]["series"][("ok",)] == 38.0
    reg3, _ = _replica_registry(3, 2)
    assert agg.apply("r0", "inc-c", fleet.DeltaSource([reg3]).delta())
    assert agg.merged()["mcim_serve_requests_total"]["series"][("ok",)] == 40.0
    assert agg.merged()["mcim_serve_e2e_latency_seconds"]["series"][()]["count"] == 39


def test_delta_carries_only_changed_series_and_resync_recovers():
    reg, _ = _replica_registry(5, 10)
    src = fleet.DeltaSource([reg])
    clock = _Clock()
    agg = fleet.FleetAggregator(stale_s=5.0, clock=clock)
    first = src.delta()
    assert first["full"]
    assert agg.apply("r0", "i1", first)
    src.ack(first["seq"])
    reg.get("mcim_serve_requests_total").inc(status="error")
    d = src.delta()
    assert not d["full"]
    assert set(d["metrics"]) == {"mcim_serve_requests_total"}
    assert len(d["metrics"]["mcim_serve_requests_total"]["series"]) == 1
    fresh = fleet.FleetAggregator(stale_s=5.0, clock=clock)
    assert fresh.apply("r0", "i1", d) is False
    src.force_full()
    full = src.delta()
    assert full["full"] and fresh.apply("r0", "i1", full)
    got = fresh.merged()["mcim_serve_requests_total"]["series"]
    assert got[("error",)] == 1.0 and got[("ok",)] == 10.0


def test_stale_replicas_age_out_of_fleet_view():
    clock = _Clock()
    agg = fleet.FleetAggregator(stale_s=2.0, clock=clock)
    s1 = fleet.DeltaSource([_replica_registry(1, 10)[0]])
    s2 = fleet.DeltaSource([_replica_registry(2, 20)[0]])
    assert agg.apply("r0", "i1", s1.delta())
    assert agg.apply("r1", "i1", s2.delta())
    assert agg.merged()["mcim_serve_requests_total"]["series"][("ok",)] == 30
    clock.t += 3.0  # both stale; refresh only r1
    assert agg.apply("r1", "i1", s2.delta())
    assert agg.fresh_ids() == ["r1"]
    merged = agg.merged()
    assert merged["mcim_serve_requests_total"]["series"][("ok",)] == 20.0
    assert set(merged["mcim_serve_queue_depth"]["series"]) == {("r1",)}


def test_fleet_render_parses_and_gauges_carry_replica_label():
    fams = parse_exposition(_federate([_replica_registry(i, 5)[0] for i in (1, 2)]).render())
    assert fams["mcim_serve_requests_total"]["type"] == "counter"
    labels = {parse_labels(lb).get("replica")
              for (_n, lb) in fams["mcim_serve_queue_depth"]["samples"]}
    assert labels == {"r0", "r1"}
    assert fams["mcim_serve_e2e_latency_seconds"]["exemplars"]


def _delta_script(registry_cls, fleet_mod, clock):
    """One scripted federation history (two replicas, a restart, a
    stale refusal and resync, an ageing-out) through one package; returns
    the aggregator's render and stats after every step, and the wire
    payloads it folded."""
    agg = fleet_mod.FleetAggregator(stale_s=2.0, clock=clock)
    regs = {rid: _replica_registry(seed, n, registry_cls)[0]
            for rid, seed, n in (("r0", 1, 12), ("r1", 2, 30))}
    srcs = {rid: fleet_mod.DeltaSource([reg]) for rid, reg in regs.items()}
    out, wires = [], []

    def step(rid, inc):
        d = json.loads(json.dumps(srcs[rid].delta()))
        wires.append((rid, inc, d))
        ok = agg.apply(rid, inc, d)
        if ok:
            srcs[rid].ack(d["seq"])
        out.append((ok, agg.render(), agg.fresh_ids()))

    step("r0", "a")
    step("r1", "a")
    regs["r0"].get("mcim_serve_requests_total").inc(3, status="error")
    regs["r0"].get("mcim_serve_e2e_latency_seconds").observe(0.7, exemplar="late")
    step("r0", "a")
    regs["r1"] = _replica_registry(9, 4, registry_cls)[0]  # restart
    srcs["r1"] = fleet_mod.DeltaSource([regs["r1"]])
    step("r1", "b")
    clock.t += 2.5
    step("r1", "b")
    return out, wires


def _fold(fleet_mod, wires, clock_ticks):
    clock = _Clock()
    agg = fleet_mod.FleetAggregator(stale_s=2.0, clock=clock)
    out = []
    for k, (rid, inc, d) in enumerate(wires):
        clock.t += clock_ticks[k]
        out.append((agg.apply(rid, inc, d), agg.render(), agg.fresh_ids(), agg.stats()))
    return out


def test_fleet_aggregator_render_equals_jax_after_the_same_deltas():
    """The same delta sequence (each package's own, scripted alike) folds
    into the same render, fresh set and stats in both aggregators."""
    ours, our_wires = _delta_script(Registry, fleet, _Clock())
    _theirs, their_wires = _delta_script(jax_metrics.Registry, jax_fleet, _Clock())
    assert [ok for ok, *_x in ours] == [True, True, True, True, True]
    ticks = [0.0, 0.0, 0.0, 0.0, 2.5]
    for wires in (our_wires, their_wires):
        assert _fold(fleet, wires, ticks) == _fold(jax_fleet, wires, ticks)
    assert _fold(fleet, our_wires, ticks)[-1][1] == ours[-1][1]


def test_merged_exemplar_for_quantile_equals_jax():
    agg = _federate([_replica_registry(i, 25)[0] for i in (4, 5, 6)])
    entry = agg.merged()["mcim_serve_e2e_latency_seconds"]
    for q in (50, 90, 99):
        assert fleet.merged_exemplar_for_quantile(entry, q) == \
            jax_fleet.merged_exemplar_for_quantile(entry, q)


# --------------------------------------------------------------------------
# the SLO engine
# --------------------------------------------------------------------------


def test_parse_slo_specs_grammar():
    specs = slo.parse_slo_specs("avail:99.5, latency:0.25:99")
    assert [s.kind for s in specs] == ["availability", "latency"]
    assert specs[0].target == pytest.approx(0.995)
    assert specs[1].le == 0.25
    assert [s.to_dict() for s in specs] == \
        [s.to_dict() for s in jax_slo.parse_slo_specs("avail:99.5, latency:0.25:99")]
    for bad in ("avail", "avail:0", "avail:100", "latency:0.25", "latency:-1:99",
                "p99<250ms"):
        with pytest.raises(ValueError, match="bad SLO spec"):
            slo.parse_slo_specs(bad)


def _slo_drive(slo_mod, registry_cls):
    state = {"good": 0.0, "total": 0.0}

    def source(sp):
        return {s.name: (state["good"], state["total"]) for s in sp}

    clock = _Clock(0.0)
    reg = registry_cls()
    eng = slo_mod.SLOEngine(
        slo_mod.parse_slo_specs("avail:99,latency:0.5:95"), source,
        fast_s=2.0, slow_s=8.0, tick_s=0.5, burn_threshold=5.0, registry=reg, clock=clock,
    )
    trail = []

    def drive(n, good, total):
        for _ in range(n):
            clock.t += 0.5
            state["good"] += good
            state["total"] += total
            eng.tick()
            trail.append(eng.status())

    drive(20, 50, 50)  # healthy
    drive(8, 25, 50)  # 50% failures: burn 50 >> 5 in both windows
    drive(20, 50, 50)  # recovery
    return trail, reg.render()


def test_slo_burn_alert_fires_and_clears_with_fake_clock():
    trail, text = _slo_drive(slo, Registry)
    a = trail[19]["slos"]["availability_99"]
    assert a["alert"] == "ok" and a["burn_fast"] == 0.0
    a = trail[27]["slos"]["availability_99"]
    assert a["alert"] == "firing"
    assert a["burn_fast"] > 5.0 and a["burn_slow"] > 5.0
    a = trail[-1]["slos"]["availability_99"]
    assert a["alert"] == "ok" and a["transitions"] == 2
    assert 'mcim_slo_transitions_total{slo="availability_99",to="firing"} 1' in text
    assert 'mcim_slo_transitions_total{slo="availability_99",to="ok"} 1' in text


def test_slo_engine_alerts_equal_jax_on_a_fake_clock():
    ours, our_text = _slo_drive(slo, Registry)
    theirs, their_text = _slo_drive(jax_slo, jax_metrics.Registry)
    assert ours == theirs
    assert our_text == their_text


def test_slo_latency_kind_reads_histogram_buckets():
    reg, _ = _replica_registry(3, 0)
    h = reg.get("mcim_serve_e2e_latency_seconds")
    for _ in range(90):
        h.observe(0.01)
    for _ in range(10):
        h.observe(2.0)
    source = slo.fleet_slo_source(_federate([reg]).merged)
    specs = slo.parse_slo_specs("latency:0.25:99")
    assert source(specs)[specs[0].name] == (90.0, 100.0)


# --------------------------------------------------------------------------
# the pod heartbeat and the router's federation uplink
# --------------------------------------------------------------------------

_POD = dict(pod_id="pod-a", addr="127.0.0.1", port=8000, pid=7, incarnation="x-1",
            routable=2, queued=3, queue_depth=128, warm_buckets=["48x48"],
            pipelines=["dag-1"], seq=4, sent_unix_s=12.5)


@pytest.mark.parametrize("metrics", [None, {"seq": 1, "baseline_seq": 0, "full": True,
                                            "metrics": {}}])
def test_pod_heartbeat_wire_equals_jax(metrics):
    ours = fed_control.PodHeartbeat(**_POD, metrics=metrics)
    theirs = jax_fed.PodHeartbeat(**_POD, metrics=metrics)
    assert ours.to_json() == theirs.to_json()
    assert fed_control.PodHeartbeat.from_json(theirs.to_json()) == ours
    raw = json.loads(ours.to_json())
    raw["extra"] = 1
    with pytest.raises(ValueError, match="unknown fields"):
        fed_control.PodHeartbeat.from_json(json.dumps(raw).encode())
    assert fed_control.POD_HEARTBEAT_PATH == jax_fed.POD_HEARTBEAT_PATH


_LEASES = {
    "acme": {"quota_requests": 40, "quota_bytes": None},
    "beta": {"quota_requests": 5, "quota_bytes": 1 << 20},
    "junk": "not-a-lease",
}


def test_router_applies_leases_as_jax_does():
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import Router, RouterConfig
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets

    ours = Router(RouterConfig(buckets=parse_buckets("48")))
    theirs = jax_router.Router(jax_router.RouterConfig(buckets=jax_parse_buckets("48")))
    for r in (ours, theirs):
        r.graph_tenants["acme"] = {"tenant": "acme", "qos": "batch", "quota_requests": 100}
        r._tenant_pushed[("r0", "i1")] = {"acme", "beta", "gamma"}
        r._apply_leases(_LEASES)
    assert ours.graph_tenants == theirs.graph_tenants
    assert ours._tenant_pushed == theirs._tenant_pushed == {("r0", "i1"): {"gamma"}}
    ours.close()
    theirs.close()


def test_router_federate_pushes_pod_heartbeats_and_applies_leases():
    """The uplink against a stand-in front door: the pushed body parses as
    a pod heartbeat in both packages, and the ack's leases land."""
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import Router, RouterConfig
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets

    got = []

    class Door(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            got.append((self.path, body))
            ack = json.dumps({"ok": True, "leases": {"acme": {"quota_requests": 9}}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(ack)))
            self.end_headers()
            self.wfile.write(ack)

    door = ThreadingHTTPServer(("127.0.0.1", 0), Door)
    threading.Thread(target=door.serve_forever, daemon=True).start()
    router = Router(RouterConfig(buckets=parse_buckets("48"))).start()
    try:
        router.federate(f"http://127.0.0.1:{door.server_address[1]}", "pod-t", interval_s=0.05)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(got) < 2:
            time.sleep(0.02)
        assert len(got) >= 2
        path, body = got[-1]
        assert path == fed_control.POD_HEARTBEAT_PATH
        hb = fed_control.PodHeartbeat.from_json(body)
        jhb = jax_fed.PodHeartbeat.from_json(body)
        assert hb.pod_id == jhb.pod_id == "pod-t"
        assert hb.port == router.address[1] and hb.routable == 0
        assert hb.metrics is not None and not hb.metrics["full"]  # acked: deltas now
        assert router.graph_tenants["acme"]["quota_requests"] == 9
    finally:
        router.close()
        door.shutdown()
        door.server_close()


# --------------------------------------------------------------------------
# end to end: router + two in-process replicas on the CPU
# --------------------------------------------------------------------------


@pytest.fixture()
def slo_fabric():
    """Router (fast SLO windows) + two in-process replicas with
    max_batch=1 and retry_attempts=1, so an injected dispatch fault fails
    exactly its own request: a 10% failpoint is a 10% error rate."""
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.replica import ReplicaRuntime
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import Router, RouterConfig
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig

    cfg = ServeConfig(ops="grayscale,contrast:3.5", buckets=parse_buckets("48"), max_batch=1,
                      max_delay_ms=1.0, queue_depth=64, channels=(3,), retry_attempts=1,
                      breaker_threshold=1000, device="cpu")
    router = Router(RouterConfig(
        buckets=parse_buckets("48"), stale_s=3.0, forward_attempts=1, slo_specs="avail:99",
        slo_fast_s=1.2, slo_slow_s=6.0, slo_tick_s=0.1, slo_burn_threshold=2.0,
    )).start()
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


def _slo_view(router) -> dict:
    with urllib.request.urlopen(router.url + "/slo", timeout=10.0) as resp:
        return json.loads(resp.read())


def test_slo_alert_fires_and_clears_end_to_end(slo_fabric):
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import encode_image_bytes, synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen

    router = slo_fabric
    tracer = obs_trace.configure(sample=1.0)
    blob = encode_image_bytes(synthetic_image(44, 44, channels=3, seed=3))

    def pump(n, sleep_s=0.01):
        for _ in range(n):
            loadgen.http_post_image(router.url, blob)
            time.sleep(sleep_s)

    try:
        pump(20)
        failpoints.configure("serve.dispatch=0.1", seed=11)
        fired = False
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not fired:
            pump(10, sleep_s=0.005)
            fired = _slo_view(router)["slos"]["availability_99"]["alert"] == "firing"
        assert fired, f"availability alert never fired: {_slo_view(router)}"
        failpoints.clear()
        cleared = False
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not cleared:
            pump(10, sleep_s=0.005)
            view = _slo_view(router)
            cleared = view["slos"]["availability_99"]["alert"] == "ok"
        assert cleared, f"alert never cleared: {_slo_view(router)}"
        assert view["slos"]["availability_99"]["transitions"] >= 2
        p99 = view["p99"]
        assert p99["p99_s"] is not None
        tid = p99["exemplar_trace_id"]
        assert tid, p99
        by_name: dict[str, list] = {}
        for e in tracer.drain():
            if e.get("args", {}).get("trace_id") == tid:
                by_name.setdefault(e["name"], []).append(e)
        for name in ("fabric.request", "fabric.forward", "serve.request", "serve.dispatch"):
            assert name in by_name, f"exemplar trace {tid}: {name!r} missing ({sorted(by_name)})"
        root_id = by_name["fabric.request"][0]["args"]["span_id"]
        assert by_name["fabric.forward"][0]["args"].get("parent_id") == root_id
    finally:
        failpoints.clear()
        obs_trace.disable()


def test_federated_metrics_equal_sum_of_replica_registries(slo_fabric):
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import encode_image_bytes, synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen

    router = slo_fabric
    blob = encode_image_bytes(synthetic_image(40, 40, channels=3, seed=4))
    for _ in range(12):
        assert loadgen.http_post_image(router.url, blob)["code"] == 200

    def replica_sum() -> float:
        total = 0.0
        for v in router.table.views():
            with urllib.request.urlopen(f"http://127.0.0.1:{v.hb.port}/fleet/snapshot",
                                        timeout=10.0) as resp:
                snap = json.loads(resp.read())
            for key, val in snap["metrics"]["mcim_serve_requests_total"]["series"]:
                if key == ["ok"]:
                    total += val
        return total

    deadline = time.monotonic() + 20.0
    while True:
        want = replica_sum()
        fams = parse_exposition(router.render_metrics())
        got = sum(v for (_n, labels), v in fams["mcim_serve_requests_total"]["samples"].items()
                  if 'status="ok"' in labels)
        if got == want and want >= 12:
            break
        assert time.monotonic() < deadline, (got, want)
        time.sleep(0.1)
    assert fams["mcim_fleet_replicas"]["samples"][("mcim_fleet_replicas", "")] == 2.0
