"""One replica worker: the serve stack as a supervised process. The
counterpart of the JAX package's ``fabric/replica.py``.

`python -m mpi_cuda_imagemanipulation_tpu_torch.fabric.replica --replica-id r0
--router http://host:port --device cuda ...` stands up the serving stack
(ServeApp: scheduler + engine + shape-bucket function cache warmed on the
device + HTTP Server) on `--port 0` (kernel-assigned, race-free) and
pushes heartbeats to the router, which learns the bound port from the
first beat — the supervisor never has to guess ports.

The device travels on the argv (`--device`, default cuda): the JAX
package's replicas inherit their platform through the environment, and a
PyTorch process names its device. A replica asked for cuda on a host
without CUDA raises at start, as every entry point of the port does.

The heartbeat payload is assembled here from the stack's own state:
health machine state, admission-queue fill, "HxW" buckets whose dispatch
breaker is open (BreakerBoard.open_keys), and the warm-affinity signal
(the function cache's warmed bucket set, serve/cache.warm_buckets).

SIGTERM drains gracefully: admission stops, queued + in-flight work
flushes under `--drain-deadline-s`, the trace buffer exports (so a
drained replica's spans still join the router's on trace id), then exit
0. A SIGKILL (the churn test / a real OOM) skips all of that — which is
precisely what the router's staleness window, per-replica breaker and
rerouting retries exist to absorb.

Two more ways out, both graceful:

  * **drain ack** — the router's heartbeat ack carries `drain: true`
    when the autoscaler marked this replica for scale-down: the health
    machine flips to `draining` (admission refused, /v1/process answers
    503 + Retry-After), in-flight work flushes, and the beats keep
    flowing so the autoscaler can watch the queue empty before SIGTERM.
  * **preemption notice** — SIGUSR1 (the spot/maintenance eviction
    stand-in) or a `replica.preempt` failpoint hit: drain as above, dump
    the `preempt` flight-recorder artifact (the ring still holds the
    serving-time facts the post-mortem needs), exit `PREEMPT_EXIT_CODE`
    so the supervisor replaces immediately instead of backing off.

This module is also importable: `ReplicaRuntime` runs the same wiring
in-process for tests that don't need process isolation.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time

from mpi_cuda_imagemanipulation_tpu_torch.fabric.control import (
    PREEMPT_EXIT_CODE,
    Heartbeat,
    HeartbeatSender,
)
from mpi_cuda_imagemanipulation_tpu_torch.graph.systolic import ENV_SYSTOLIC
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger


class ReplicaRuntime:
    """Server + HeartbeatSender for one replica id, embeddable in-process
    (tests) or driven by main() as a worker process."""

    def __init__(
        self,
        replica_id: str,
        router_url: str,
        serve_config,
        *,
        host: str = "",
        port: int = 0,
        heartbeat_s: float | None = None,
    ):
        from mpi_cuda_imagemanipulation_tpu_torch.obs.fleet import DeltaSource
        from mpi_cuda_imagemanipulation_tpu_torch.serve.server import Server

        self.replica_id = replica_id
        self.router_url = router_url
        # incarnation: unique per construction, so the router can tell a
        # restart from a continuation and reset the replica's breaker
        self.incarnation = f"{os.getpid():x}-{time.time_ns():x}"
        # set by a preemption notice (SIGUSR1 / replica.preempt
        # failpoint); main() watches it next to the SIGTERM event
        self.preempted = threading.Event()
        self.server = Server(serve_config, host, port)
        # metrics federation (obs/fleet.py): every heartbeat carries the
        # compact delta of this replica's registries; the router's ack
        # advances the baseline (or asks for a full resync)
        self.delta_source = DeltaSource(self.server.app.fleet_registries())
        self.sender = HeartbeatSender(
            router_url,
            self._collect,
            interval_s=heartbeat_s,
            on_ack=self._on_heartbeat_ack,
        )

    def _collect(self, seq: int) -> Heartbeat:
        app = self.server.app
        try:
            # a hit is a PREEMPTION NOTICE, not a dropped beat: the beat
            # still goes out (the router should see the drain coming)
            failpoints.maybe_fail(
                "replica.preempt", replica=self.replica_id, seq=seq
            )
        except failpoints.FailpointError:
            self.preempted.set()
        return Heartbeat(
            replica_id=self.replica_id,
            addr="127.0.0.1",
            port=self.server.address[1] if self.server.httpd else 0,
            pid=os.getpid(),
            incarnation=self.incarnation,
            state=app.health.state,
            queued=app.metrics.queued,
            queue_depth=app.config.queue_depth,
            breaker_open=[
                f"{k[0]}x{k[1]}" for k in app.breakers.open_keys()
            ],
            warm_buckets=app.cache.warm_buckets(),
            seq=seq,
            sent_unix_s=time.time(),
            metrics=self.delta_source.delta(),
            pipelines=app.graph_pipeline_ids(),
            systolic=app.config.systolic,
        )

    def _on_heartbeat_ack(self, hb: Heartbeat, ack: dict) -> None:
        if ack.get("drain"):
            # the autoscaler marked us for scale-down: stop admitting,
            # keep serving what's queued, keep beating so the router can
            # watch the queue empty before the SIGTERM arrives
            self.begin_drain()
        if ack.get("resync"):
            # router baseline mismatch (restart / missed epoch): next
            # beat carries a full snapshot
            self.delta_source.force_full()
        elif hb.metrics is not None:
            self.delta_source.ack(hb.metrics["seq"])

    def begin_drain(self) -> None:
        """Drain-before-kill step on the replica: health -> draining
        (admission refused by the HTTP front end), dispatch keeps
        running so in-flight + queued work flushes. Idempotent — every
        subsequent ack carries the flag again."""
        from mpi_cuda_imagemanipulation_tpu_torch.resilience.health import (
            DEGRADED,
            DRAINING,
            SERVING,
        )

        health = self.server.app.health
        if health.state in (SERVING, DEGRADED):
            health.to(DRAINING)
            get_logger().info(
                "replica %s: drain requested by router; admission stopped",
                self.replica_id,
            )

    def start(self) -> "ReplicaRuntime":
        # warmup + socket first: the first heartbeat must carry the real
        # port and a state the router can act on
        self.server.start()
        self.sender.start()
        return self

    def close(self, *, drain: bool = True, deadline_s: float = 30.0) -> None:
        self.sender.stop()
        self.server.close(drain=drain, deadline_s=deadline_s)

    def __enter__(self) -> "ReplicaRuntime":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mcim-fabric-replica",
        description="one fabric replica worker (spawned by the supervisor)",
    )
    p.add_argument("--replica-id", required=True)
    p.add_argument("--router", required=True, help="router base URL")
    p.add_argument("--ops", default="grayscale,contrast:3.5,emboss:3")
    p.add_argument("--buckets", default="512,1024,2048,4096")
    p.add_argument("--channels", default="1,3")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--queue-depth", type=int, default=64)
    # the padded executor's accumulation: torch (the golden ops; the JAX
    # package's xla), mxu (banded products) or auto (= torch)
    p.add_argument("--impl", default="torch", choices=("auto", "torch", "mxu"))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    # the canary deploy path flips this per replica (plan-mode config
    # flips are the gate's canonical workload)
    p.add_argument("--plan", default="auto")
    # pod-level systolic execution (graph/systolic.py): accept placed
    # stage ranges + /v1/systolic hops; advertised in every heartbeat
    p.add_argument(
        "--systolic",
        action="store_true",
        default=env_registry.get_bool(ENV_SYSTOLIC),
    )
    p.add_argument("--host", default="")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--heartbeat-s", type=float, default=None)
    p.add_argument("--drain-deadline-s", type=float, default=30.0)
    p.add_argument("--trace-out", default=None)
    p.add_argument("--trace-sample", type=float, default=None)
    return p


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    # the worker inherits MCIM_FAILPOINTS / MCIM_TRACE_* from the
    # supervisor's env (per-replica overrides ride extra_env); the device
    # rides the argv
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig

    log = get_logger()
    if args.trace_out or args.trace_sample is not None:
        obs_trace.configure(
            sample=1.0 if args.trace_sample is None else args.trace_sample
        )
    else:
        obs_trace.configure_from_env()
    channels = tuple(
        sorted({int(c) for c in args.channels.split(",") if c.strip()})
    )
    cfg = ServeConfig(
        ops=args.ops,
        buckets=parse_buckets(args.buckets),
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        queue_depth=args.queue_depth,
        channels=channels,
        backend="torch" if args.impl == "auto" else args.impl,
        plan=args.plan,
        systolic=args.systolic,
        device=args.device,
    )
    rt = ReplicaRuntime(
        args.replica_id,
        args.router,
        cfg,
        host=args.host,
        port=args.port,
        heartbeat_s=args.heartbeat_s,
    )
    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        log.info(
            "replica %s: signal %s, draining (deadline %.0fs)",
            args.replica_id, signal.Signals(signum).name,
            args.drain_deadline_s,
        )
        stop_evt.set()

    def _on_preempt(signum, frame):
        log.warning(
            "replica %s: SIGUSR1 preemption notice — draining for "
            "replacement", args.replica_id,
        )
        rt.preempted.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    # the spot/maintenance eviction stand-in: a real deployment's
    # preemption watcher delivers exactly this kind of early notice
    signal.signal(signal.SIGUSR1, _on_preempt)
    rt.start()
    log.info(
        "replica %s serving on port %d (router %s, heartbeat %.2fs)",
        args.replica_id, rt.server.address[1], args.router,
        rt.sender.interval_s,
    )
    while not stop_evt.wait(0.1):
        if rt.preempted.is_set():
            break
    preempted = rt.preempted.is_set() and not stop_evt.is_set()
    rt.close(drain=True, deadline_s=args.drain_deadline_s)
    # flight recorder (obs/recorder.py): both exits are dump triggers —
    # the ring still holds the serving-time facts (hot buckets, breaker
    # transitions, failpoint hits) plus the drain itself. A preemption
    # writes its OWN trigger so the post-mortem names the eviction.
    from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder

    if preempted:
        dump_path = recorder.dump(
            "preempt", extra={"replica_id": args.replica_id}
        )
    else:
        dump_path = recorder.dump(
            "sigterm_drain", extra={"replica_id": args.replica_id}
        )
    if dump_path:
        log.info("replica %s recorder dump -> %s", args.replica_id, dump_path)
    if args.trace_out:
        n = obs_trace.export(args.trace_out)
        log.info(
            "replica %s trace: %d events -> %s",
            args.replica_id, n, args.trace_out,
        )
    return PREEMPT_EXIT_CODE if preempted else 0


if __name__ == "__main__":
    sys.exit(main())
