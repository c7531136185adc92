"""The port's elastic fabric on the CPU, against the JAX package.

The cases of the JAX package's ``tests/test_elastic.py`` through the port:
the autoscaler's hysteresis, bounds and drain-before-kill machine (fake
clock, injected heartbeats), the canary gate's slice and breach arithmetic
(its decisions equal the JAX gate's on the same outcome sequences), the
session table, the replica-side ring protocol (byte-equal to the JAX
package's ``VideoSessionHost`` frame for frame), the loadgen's shed
accounting and the supervisor's restart semantics (tiny scripts). The
canary rollback runs in process: the router with two ``ReplicaRuntime``s on
``device='cpu'``, the canary replica's forwards failing. The one spawned
pod: a live video session whose replica is SIGKILLed mid-stream resumes on
the survivor, frame for frame equal to the JAX package's offline
``stream_video``.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from mpi_cuda_imagemanipulation_tpu.fabric import canary as jax_canary
from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.ops.temporal import split_temporal as jax_split_temporal
from mpi_cuda_imagemanipulation_tpu.stream import video as jax_video
from mpi_cuda_imagemanipulation_tpu_torch.fabric import canary as fabric_canary
from mpi_cuda_imagemanipulation_tpu_torch.fabric import session as fabric_session
from mpi_cuda_imagemanipulation_tpu_torch.fabric.autoscaler import Autoscaler, AutoscalerConfig
from mpi_cuda_imagemanipulation_tpu_torch.fabric.control import PREEMPT_EXIT_CODE, Heartbeat
from mpi_cuda_imagemanipulation_tpu_torch.fabric.replica import ReplicaRuntime
from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import Router, RouterConfig
from mpi_cuda_imagemanipulation_tpu_torch.fabric.supervisor import (
    Fabric,
    FabricConfig,
    ReplicaSpec,
    Supervisor,
)
from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
    decode_image_bytes,
    encode_image_bytes,
    save_image,
    synthetic_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig
from mpi_cuda_imagemanipulation_tpu_torch.stream import video as svideo

# fails the module if a replica or worker process it spawned outlives it
from _torch_fabric_procs import no_children_left  # noqa: F401

BUCKETS = "48,96"
OPS = "grayscale,contrast:3.5"


class _Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _hb(rid: str, *, state: str = "serving", queued: int = 0, queue_depth: int = 64,
        warm=(), incarnation: str = "i1", port: int = 1) -> Heartbeat:
    return Heartbeat(
        replica_id=rid, addr="127.0.0.1", port=port, pid=0, incarnation=incarnation,
        state=state, queued=queued, queue_depth=queue_depth, breaker_open=[],
        warm_buckets=list(warm), seq=1, sent_unix_s=0.0,
    )


def _router(clock: _Clock) -> Router:
    return Router(RouterConfig(buckets=parse_buckets(BUCKETS), stale_s=5.0,
                               forward_attempts=3), clock=clock)


# --------------------------------------------------------------------------
# autoscaler: hysteresis, bounds, drain-before-kill (pure, fake clock)
# --------------------------------------------------------------------------


def _autoscaler(router, clock, live, ups, downs, **over):
    cfg = AutoscalerConfig(
        min_replicas=over.pop("min_replicas", 1), max_replicas=over.pop("max_replicas", 3),
        up_frac=0.5, down_frac=0.2, sustain_s=1.0, cooldown_s=2.0, tick_s=0.1,
        drain_deadline_s=5.0, **over,
    )
    return Autoscaler(
        router,
        scale_up=lambda: (ups.append("up"), live.__setitem__(0, live[0] + 1)) and "rX",
        scale_down=lambda rid: (downs.append(rid), live.__setitem__(0, live[0] - 1)),
        live_count=lambda: live[0],
        config=cfg,
        clock=clock,
    )


def test_autoscaler_scales_up_on_sustained_pressure_only():
    clock = _Clock()
    router = _router(clock)
    live, ups, downs = [1], [], []
    auto = _autoscaler(router, clock, live, ups, downs)
    router.table.observe(_hb("r0", queued=60), clock())
    auto.tick()  # pressure seen, sustain window opens
    assert ups == []
    clock.t += 0.5
    router.table.observe(_hb("r0", queued=0), clock())
    auto.tick()  # blip over: window resets
    clock.t += 0.1
    router.table.observe(_hb("r0", queued=60), clock())
    auto.tick()
    clock.t += 0.5
    auto.tick()  # only 0.5 s sustained
    assert ups == []
    clock.t += 0.6
    auto.tick()  # 1.1 s sustained -> scale up
    assert ups == ["up"] and live[0] == 2
    clock.t += 0.5
    auto.tick()  # cooldown
    assert ups == ["up"]


def test_autoscaler_respects_max_and_min_bounds():
    clock = _Clock()
    router = _router(clock)
    live, ups, downs = [3], [], []
    auto = _autoscaler(router, clock, live, ups, downs, max_replicas=3)
    router.table.observe(_hb("r0", queued=64), clock())
    clock.t += 1.5
    auto.tick()
    clock.t += 1.5
    auto.tick()
    assert ups == []  # at the ceiling
    live[0] = 0
    auto2 = _autoscaler(router, clock, live, ups, downs, min_replicas=1)
    auto2.tick()  # below the floor: immediate corrective scale-up
    assert ups == ["up"] and live[0] == 1


def test_autoscaler_drain_before_kill_sequence():
    clock = _Clock()
    router = _router(clock)
    live, ups, downs = [2], [], []
    auto = _autoscaler(router, clock, live, ups, downs)
    router.table.observe(_hb("r0", queued=0), clock())
    router.table.observe(_hb("r1", queued=0), clock())
    auto.tick()
    clock.t += 1.1
    auto.tick()  # idle sustained -> pick victim, mark draining
    assert auto.draining is not None
    assert auto.draining[0] == "r1"  # fewest-warm tie -> highest id goes first
    assert router.draining_ids() == ["r1"]
    assert [v.replica_id for v in router._routable()] == ["r0"]
    _code, ack = router.handle_heartbeat(_hb("r1").to_json())
    assert ack["drain"] is True
    _code, ack0 = router.handle_heartbeat(_hb("r0").to_json())
    assert ack0["drain"] is False
    router.table.observe(_hb("r1", state="draining", queued=3), clock())
    clock.t += 0.2
    auto.tick()
    assert downs == []  # still serving queued work: not killed
    router.table.observe(_hb("r1", state="draining", queued=0), clock())
    clock.t += 0.2
    auto.tick()
    assert downs == ["r1"] and live[0] == 1
    assert auto.draining is None and router.draining_ids() == []


def test_autoscaler_drain_deadline_forces_removal():
    clock = _Clock()
    router = _router(clock)
    live, ups, downs = [2], [], []
    auto = _autoscaler(router, clock, live, ups, downs)
    router.table.observe(_hb("r0", queued=0), clock())
    router.table.observe(_hb("r1", queued=0), clock())
    auto.tick()
    clock.t += 1.1
    auto.tick()
    assert auto.draining is not None
    router.table.observe(_hb("r1", queued=5), clock())  # wedged queue
    clock.t += 5.1
    auto.tick()
    assert downs == ["r1"]
    assert auto.events[-1]["reason"] == "drain deadline"


# --------------------------------------------------------------------------
# canary gate (pure), against the JAX gate
# --------------------------------------------------------------------------

_GATE = dict(frac=0.05, min_requests=10, shadow_every=4, bad_frac=0.10, burn_ratio=3.0,
             promote_requests=100)


def _gate(**over) -> fabric_canary.CanaryGate:
    return fabric_canary.CanaryGate(fabric_canary.CanaryConfig(**{**_GATE, **over}))


def test_canary_slice_is_deterministic_fraction():
    g = _gate(frac=0.05)
    g.start("r1", {})
    takes = [g.take_canary() for _ in range(400)]
    assert sum(takes) == 20
    assert takes[19] and not takes[0]


@pytest.mark.parametrize("frac,shadow_every", [(0.05, 4), (0.3, 3), (0.5, 2), (0.07, 1000)])
def test_canary_slice_and_shadow_equal_jax(frac, shadow_every):
    cfg = {**_GATE, "frac": frac, "shadow_every": shadow_every}
    ours = fabric_canary.CanaryGate(fabric_canary.CanaryConfig(**cfg))
    theirs = jax_canary.CanaryGate(jax_canary.CanaryConfig(**cfg))
    ours.start("r1", {})
    theirs.start("r1", {})
    seq = [(ours.take_canary(), ours.take_shadow()) for _ in range(300)]
    jseq = [(theirs.take_canary(), theirs.take_shadow()) for _ in range(300)]
    assert seq == jseq


def _outcomes(seed: int, n: int):
    rng = np.random.default_rng(seed)
    lanes = rng.choice(["canary", "stable", "shadow"], size=n, p=[0.3, 0.6, 0.1])
    oks = rng.random(n) > rng.uniform(0.0, 0.4)
    return list(zip(lanes.tolist(), oks.tolist()))


@pytest.mark.parametrize("seed", range(6))
def test_canary_decisions_equal_jax(seed):
    """The same outcome sequence through both gates: the same state after
    every step, the same reason and the same status counts."""
    cfg = dict(frac=0.2, min_requests=8, shadow_every=3, bad_frac=0.15, burn_ratio=2.0,
               promote_requests=60)
    ours = fabric_canary.CanaryGate(fabric_canary.CanaryConfig(**cfg))
    theirs = jax_canary.CanaryGate(jax_canary.CanaryConfig(**cfg))
    ours.start("r1", {"argv": ["--plan", "fused"]})
    theirs.start("r1", {"argv": ["--plan", "fused"]})
    for lane, ok in _outcomes(seed, 200):
        if lane == "shadow":
            assert ours.record_shadow(ok) == theirs.record_shadow(ok)
        else:
            assert ours.record(lane, ok) == theirs.record(lane, ok)
        assert ours.state == theirs.state
    assert ours.reason == theirs.reason
    ours_status = {k: v for k, v in ours.status().items() if not k.endswith("_s")}
    theirs_status = {k: v for k, v in theirs.status().items() if not k.endswith("_s")}
    assert ours_status == theirs_status


def test_canary_rate_breach_needs_min_requests_and_ratio():
    g = _gate(min_requests=10)
    g.start("r1", {})
    for _ in range(200):
        g.record("stable", True)
    for _ in range(9):
        g.record("canary", False)
    assert g.state == fabric_canary.CANARY  # below min_requests
    g.record("canary", False)
    assert g.state == fabric_canary.ROLLED_BACK
    assert "bad rate" in g.reason


def test_canary_tolerates_shared_badness():
    g = _gate(min_requests=10, bad_frac=0.05, burn_ratio=3.0)
    g.start("r1", {})
    for _ in range(100):
        g.record("stable", False)  # everything is on fire
    for _ in range(5):
        g.record("canary", False)
    for _ in range(5):
        g.record("canary", True)
    assert g.state == fabric_canary.CANARY


def test_canary_shadow_mismatch_breaches_immediately():
    g = _gate()
    g.start("r1", {})
    g.record("canary", True)
    assert g.record_shadow(False) == fabric_canary.ROLLED_BACK
    assert "digest" in g.reason


def test_canary_promotes_after_quiet_window():
    g = _gate(min_requests=5, promote_requests=30)
    g.start("r1", {})
    for _ in range(30):
        g.record("canary", True)
    assert g.state == fabric_canary.PROMOTED


# --------------------------------------------------------------------------
# session table + replica-side ring protocol (pure), against the JAX host
# --------------------------------------------------------------------------


def test_session_tail_capacity_covers_temporal_windows():
    assert fabric_session.tail_capacity("grayscale") == 1
    assert fabric_session.tail_capacity("tdenoise:3,grayscale") == 3
    assert fabric_session.tail_capacity("tdenoise:4,framediff,invert") == 6


def test_session_table_evicts_oldest_idle_only():
    table = fabric_session.SessionTable(cap=2)
    s0 = table.get_or_create("s0", "grayscale")
    time.sleep(0.01)
    table.get_or_create("s1", "grayscale")
    s0.remember(0, b"x")  # s0 now active more recently than s1
    table.get_or_create("s2", "grayscale")
    assert table.get("s1") is None and table.get("s0") is not None
    assert table.evicted == 1


def test_parse_session_path():
    assert fabric_session.parse_session_path("/v1/session/abc/frame") == ("abc", "frame")
    assert fabric_session.parse_session_path("/v1/session//frame") is None
    assert fabric_session.parse_session_path("/v1/session/abc") is None
    assert fabric_session.parse_session_path("/v1/process") is None


def _jax_session_golden(ops: str, frames) -> list:
    temporal, rest = jax_split_temporal(ops)
    rings = jax_video.FrameRings(temporal)
    fn = JaxPipeline.parse(rest).jit()
    return [np.asarray(fn(rings.push(f))) for f in frames]


@pytest.mark.parametrize("ops", ["tdenoise:3,grayscale,contrast:3.5", "framediff,invert"])
def test_session_host_replay_rebuilds_rings_equal_to_jax(ops):
    """The failover arithmetic: reset + tail replay + live == the
    uninterrupted stream, frame for frame, and == the JAX host's frames."""
    frames = [synthetic_image(24, 28, channels=3, seed=40 + i) for i in range(10)]
    golden = _jax_session_golden(ops, frames)
    jax_host = jax_video.VideoSessionHost()
    host_a = svideo.VideoSessionHost(device="cpu")
    for seq in range(6):
        out = host_a.process_frame("s", ops, seq, frames[seq])
        np.testing.assert_array_equal(out, golden[seq])
        np.testing.assert_array_equal(out, jax_host.process_frame("s", ops, seq, frames[seq]))
    # replica A dies; B rebuilds from the router's journal tail
    host_b = svideo.VideoSessionHost(device="cpu")
    tail = list(range(6 - fabric_session.tail_capacity(ops), 6))
    for i, seq in enumerate(tail):
        assert host_b.process_frame("s", ops, seq, frames[seq], replay=True,
                                    reset=(i == 0)) is None
    for seq in range(6, 10):
        out = host_b.process_frame("s", ops, seq, frames[seq])
        np.testing.assert_array_equal(out, golden[seq])
    assert host_b.stats()["by_id"]["s"]["last_seq"] == 9


def test_session_host_is_strict_about_sequence():
    ops = "framediff,grayscale"
    host = svideo.VideoSessionHost(device="cpu")
    f = synthetic_image(16, 16, channels=3, seed=1)
    host.process_frame("s", ops, 0, f)
    host.process_frame("s", ops, 1, f)
    assert host.process_frame("s", ops, 1, f) is None  # duplicate: no-op
    with pytest.raises(svideo.SessionGapError):
        host.process_frame("s", ops, 3, f)  # gap: never silently pushed


def test_session_host_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        svideo.VideoSessionHost()


# --------------------------------------------------------------------------
# loadgen shed accounting (503 + Retry-After != unavailability)
# --------------------------------------------------------------------------


def _mini_server(code: int, headers: list):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", "0")))
            body = b"{}"
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.parametrize("retry_after", [True, False])
def test_loadgen_separates_shed_from_unavailable(retry_after):
    srv = _mini_server(503, [("Retry-After", "1")] if retry_after else [])
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        rec = loadgen.http_run_offered_load(url, [b"x"], 200.0, 0.05)
        assert rec["submitted"] > 0
        if retry_after:
            assert rec["shed"] == rec["submitted"] and rec["unavailable"] == 0
            assert rec["accepted"] == 0 and rec["ok_accepted_frac"] == 1.0
        else:
            assert rec["unavailable"] == rec["submitted"] and rec["shed"] == 0
    finally:
        srv.shutdown()
        srv.server_close()


# --------------------------------------------------------------------------
# supervisor restart semantics (real processes, tiny scripts)
# --------------------------------------------------------------------------


def _crasher(rc: int, sleep_s: float = 0.0) -> list:
    return [sys.executable, "-c", f"import time; time.sleep({sleep_s}); raise SystemExit({rc})"]


def _wait(cond, timeout_s: float = 15.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)


def test_supervisor_backs_off_on_crash_loop():
    sup = Supervisor([ReplicaSpec("c0", _crasher(1))], backoff_base_s=0.2,
                     backoff_max_s=2.0, stable_s=10.0).start()
    try:
        _wait(lambda: sup.restarts("c0") >= 2)
        assert sup.restarts("c0") >= 2
        assert sup._managed["c0"].attempts >= 2
        assert sup.preemptions("c0") == 0
    finally:
        sup.stop(drain=False)


def test_supervisor_skips_backoff_on_preemption():
    sup = Supervisor([ReplicaSpec("p0", _crasher(PREEMPT_EXIT_CODE))],
                     backoff_base_s=5.0, stable_s=10.0).start()
    try:
        _wait(lambda: sup.preemptions("p0") >= 3)
        assert sup.preemptions("p0") >= 3  # never waited a crash backoff
        assert sup._managed["p0"].attempts == 0
    finally:
        sup.stop(drain=False)


def test_supervisor_forgives_attempts_after_stable_run():
    sup = Supervisor([ReplicaSpec("s0", _crasher(1, sleep_s=0.5))], backoff_base_s=0.1,
                     stable_s=0.2).start()
    try:
        _wait(lambda: sup.restarts("s0") >= 2)
        assert sup.restarts("s0") >= 2
        assert sup._managed["s0"].attempts <= 1
    finally:
        sup.stop(drain=False)


def test_supervisor_remove_forgets_replica():
    sup = Supervisor([ReplicaSpec("d0", _crasher(0, sleep_s=60.0))], backoff_base_s=0.1).start()
    try:
        assert sup.replica_ids() == ["d0"]
        sup.remove("d0", deadline_s=10.0)
        assert sup.replica_ids() == []
        time.sleep(0.3)  # the monitor must NOT resurrect it
        assert sup.pids() == {}
    finally:
        sup.stop(drain=False)


def test_replica_argv_names_the_port_module_and_device():
    fab = Fabric(FabricConfig(replicas=1, buckets="48", device="cpu", impl="mxu"))
    fab.router.start()
    try:
        argv = fab._replica_argv("r0")
        assert argv[1:3] == ["-m", "mpi_cuda_imagemanipulation_tpu_torch.fabric.replica"]
        assert argv[argv.index("--device") + 1] == "cpu"
        assert argv[argv.index("--impl") + 1] == "mxu"
    finally:
        fab.router.close()


# --------------------------------------------------------------------------
# canary rollback in process: the canary replica's forwards fail
# --------------------------------------------------------------------------


def test_canary_broken_flip_rolls_back_within_slice(tmp_path, monkeypatch):
    """A broken canary (every forward to it fails) is reverted by the gate
    while its share stays within the slice; clients never see it (canary
    requests fall back to stable) and every answer equals the JAX golden;
    the canary_rollback dump names the breach."""
    rec_dir = str(tmp_path / "recorder")
    monkeypatch.setenv("MCIM_RECORDER_DIR", rec_dir)
    monkeypatch.setenv("MCIM_RECORDER_MIN_INTERVAL_S", "0")
    imgs = [synthetic_image(40 + 3 * i, 42 + 2 * i, channels=3, seed=60 + i) for i in range(3)]
    blobs = [encode_image_bytes(im) for im in imgs]
    golden = [np.asarray(JaxPipeline.parse(OPS).jit()(im)) for im in imgs]
    cfg = ServeConfig(ops=OPS, buckets=parse_buckets("48"), max_batch=4, queue_depth=64,
                      channels=(3,), device="cpu")
    router = Router(RouterConfig(
        buckets=parse_buckets("48"), stale_s=2.0, forward_attempts=3, breaker_threshold=1000,
        canary=fabric_canary.CanaryConfig(frac=0.05, min_requests=5, shadow_every=1000),
    )).start()
    reps = [ReplicaRuntime(f"r{i}", router.url, cfg, heartbeat_s=0.15).start() for i in range(2)]
    reverted = []
    router.on_canary_deploy = lambda flip: "r1"
    router.on_canary_rollback = reverted.append
    try:
        _wait(lambda: len(router._routable()) == 2, 30.0)
        status = router.canary_deploy({"env": {"MCIM_FAILPOINTS": "engine.complete=always"}})
        assert status["state"] == fabric_canary.CANARY and status["replica"] == "r1"
        failpoints.install("router.forward", lambda ctx: ctx["replica"] == "r1")
        for i in range(600):
            r = loadgen.http_post_image(router.url, blobs[i % len(blobs)])
            assert r["code"] == 200, (i, r["code"], r["body"][:120])
            np.testing.assert_array_equal(decode_image_bytes(r["body"]), golden[i % len(golden)])
            if router.canary.state == fabric_canary.ROLLED_BACK:
                break
        assert router.canary.state == fabric_canary.ROLLED_BACK, router.canary.status()
        dumps = [p for p in os.listdir(rec_dir) if p.startswith("recorder_canary_rollback")]
        assert dumps, f"no canary_rollback dump in {rec_dir}"
        with open(os.path.join(rec_dir, dumps[0])) as f:
            dump = json.load(f)
        canary_n = dump["extra"]["canary"]["ok"] + dump["extra"]["canary"]["bad"]
        stable_n = dump["extra"]["stable"]["ok"] + dump["extra"]["stable"]["bad"]
        assert canary_n / (canary_n + stable_n) <= 0.08
        assert dump["extra"]["canary"]["bad"] >= 5
        _wait(lambda: bool(reverted), 5.0)
        assert reverted and reverted[0]["replica"] == "r1"
    finally:
        failpoints.clear()
        for rt in reps:
            rt.close()
        router.close()


# --------------------------------------------------------------------------
# ACCEPTANCE: a live video session across a SIGKILL, two replica processes
# --------------------------------------------------------------------------


def test_video_session_survives_sigkill_equal_to_offline_stream(tmp_path, monkeypatch):
    """SIGKILL the replica holding a live video session mid-stream: the
    router rebinds the session to the survivor and replays the journal
    tail, and every frame of the resumed stream equals the JAX package's
    offline ``stream_video`` over the same frames."""
    monkeypatch.setenv("MCIM_RECORDER_DIR", str(tmp_path / "recorder"))
    monkeypatch.setenv("MCIM_RECORDER_MIN_INTERVAL_S", "0")
    session_ops = "tdenoise:3,grayscale,contrast:3.5"
    frames = [synthetic_image(40, 44, channels=3, seed=130 + i) for i in range(12)]
    paths = []
    for i, f in enumerate(frames):
        p = tmp_path / "in" / f"f{i:02d}.png"
        p.parent.mkdir(exist_ok=True)
        save_image(p, f)
        paths.append(str(p))
    jax_video.stream_video(paths, tmp_path / "offline", session_ops)
    offline = [np.asarray(decode_image_bytes(open(tmp_path / "offline" / f"f{i:02d}.png",
                                                  "rb").read())) for i in range(12)]
    cfg = FabricConfig(
        replicas=2, ops=OPS, buckets="48", channels="3", max_batch=4, queue_depth=64,
        heartbeat_s=0.2, device="cpu",
        router=RouterConfig(buckets=parse_buckets("48"), stale_s=2.0, forward_attempts=3,
                            breaker_threshold=2, breaker_reset_s=0.5),
        supervisor_backoff_s=0.25,
    )
    with Fabric(cfg).start(ready_timeout_s=120.0) as fab:
        first = svideo.stream_video_session(frames[:6], fab.url, session_ops,
                                            session_id="live-1")
        for k in range(6):
            np.testing.assert_array_equal(first["outputs"][k], offline[k])
        bound = fab.router.sessions.get("live-1").replica_id
        assert bound in first["replicas"]
        fab.kill_replica(bound)  # SIGKILL: no drain, no goodbye
        rest = svideo.stream_video_session(frames[6:], fab.url, session_ops,
                                           session_id="live-1", start_seq=6)
        for k in range(6):
            np.testing.assert_array_equal(rest["outputs"][k], offline[6 + k])
        sess = fab.router.sessions.stats()["by_id"]["live-1"]
        assert sess["failovers"] >= 1
        assert sess["replica"] != bound
        fab.wait_ready(2, timeout_s=120.0)  # the restarted replica rejoins
