"""Replica supervision — spawn, monitor, restart-with-backoff — and the
`Fabric` facade that runs router + supervised replicas as one unit. The
counterpart of the JAX package's ``fabric/supervisor.py``.

Every replica is a `subprocess.Popen` of a fresh interpreter with its own
device context (on the card: its own CUDA context), never a fork: the
router process may hold a CUDA context itself (the mesh lane's), and a
forked child of such a process cannot use CUDA. The device each replica
serves on rides its argv (`FabricConfig.device` -> `--device`).

The supervisor is deliberately dumb: it owns PROCESS lifecycle only.
Liveness, routing and breakers are the router's job (heartbeats), so the
supervisor never talks to replicas beyond signals — the same separation
that lets a real deployment swap this module for systemd/k8s while the
router stays unchanged.

Restart policy: a replica that exits (crash, OOM kill, the churn test's
SIGKILL) is respawned after an exponential backoff (base * 2^attempt,
capped), and the attempt counter resets once an incarnation survives
`stable_s` — so a crash loop backs off instead of spinning, while a
one-off kill rejoins after one base delay. Each restart increments
`mcim_fabric_replica_restarts_total{replica=...}` on the shared fabric
registry.

PREEMPTION is not a crash: a replica that exits `PREEMPT_EXIT_CODE`
(fabric/control.py) drained gracefully after an eviction notice — it is
replaced IMMEDIATELY, with no backoff and no attempt-counter increment
(backing off on the platform's scheduling decision would compound the
capacity loss), and counted separately in
`mcim_fabric_replica_preemptions_total`. The replica already wrote the
`preempt` post-mortem dump; the supervisor only logs.

The membership is DYNAMIC for the autoscaler (fabric/autoscaler.py):
`add()` grows the set, `remove()` SIGTERMs a (drained) replica and
forgets it — the monitor will not resurrect a removed replica — and
`respawn()` is the canary deploy path: replace one replica's process
with a (possibly different) spec, gracefully.

`Fabric` is the assembly the CLI (`serve --replicas N` / `fabric`) and
the tests use:

    with Fabric(FabricConfig(replicas=3, ...)).start() as fab:
        ... fab.url ...            # the front door
        fab.kill_replica("r1")     # churn: SIGKILL; supervisor restarts it
    # replicas SIGTERMed (graceful drain), router closed, on every path
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from mpi_cuda_imagemanipulation_tpu_torch.fabric.control import PREEMPT_EXIT_CODE
from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import (
    Router,
    RouterConfig,
)
from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import Registry
from mpi_cuda_imagemanipulation_tpu_torch.serve import bucketing
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


@dataclasses.dataclass
class ReplicaSpec:
    """How to (re)spawn one replica: its stable id, argv and env extras."""

    replica_id: str
    argv: list[str]
    extra_env: dict[str, str] = dataclasses.field(default_factory=dict)


class _Managed:
    """Supervisor-internal per-replica state (monitor thread only)."""

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.proc: subprocess.Popen | None = None
        self.spawned_at = 0.0
        self.attempts = 0  # consecutive restarts without a stable run
        self.restart_due: float | None = None
        self.removed = False  # hands-off flag: remove()/respawn() owns it


class Supervisor:
    def __init__(
        self,
        specs: list[ReplicaSpec],
        *,
        registry: Registry | None = None,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 10.0,
        stable_s: float = 5.0,
        clock=time.monotonic,
        death_info=None,
    ):
        self.specs = list(specs)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.stable_s = stable_s
        self._clock = clock
        # death_info(replica_id) -> dict: extra context for the
        # replica_death flight-recorder dump (Fabric passes the router's
        # last heartbeat view, so the dump names the dead replica's warm
        # buckets even though its own ring died with it)
        self._death_info = death_info
        self._managed = {s.replica_id: _Managed(s) for s in specs}
        self._lock = threading.Lock()  # guards _managed.proc handles
        self._running = False
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._log = get_logger()
        reg = registry or Registry()
        self._m_restarts = reg.counter(
            "mcim_fabric_replica_restarts_total",
            "Replica processes respawned by the supervisor, per replica.",
            labels=("replica",),
        )
        self._m_preemptions = reg.counter(
            "mcim_fabric_replica_preemptions_total",
            "Graceful preemption exits replaced WITHOUT backoff, per "
            "replica.",
            labels=("replica",),
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Supervisor":
        self._running = True
        for m in self._managed.values():
            self._spawn(m)
        self._thread = threading.Thread(
            target=self._monitor, name="mcim-fabric-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def _spawn(self, m: _Managed) -> None:
        env = dict(os.environ)
        # the worker must import THIS checkout even without an installed
        # package (tests); prepending is harmless when one is installed
        env["PYTHONPATH"] = _REPO_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        env.update(m.spec.extra_env)
        m.proc = subprocess.Popen(m.spec.argv, env=env)
        m.spawned_at = self._clock()
        m.restart_due = None
        self._log.info(
            "spawned replica %s (pid %d)", m.spec.replica_id, m.proc.pid
        )

    def _monitor(self) -> None:
        while self._running:
            now = self._clock()
            with self._lock:
                managed = list(self._managed.values())
            for m in managed:
                proc = m.proc
                if proc is None or m.removed:
                    continue
                if proc.poll() is None:
                    # alive; a long stable run forgives past crashes
                    if m.attempts and now - m.spawned_at >= self.stable_s:
                        m.attempts = 0
                    continue
                if not self._running:
                    break
                if proc.returncode == PREEMPT_EXIT_CODE:
                    # preemption: the replica drained and dumped its own
                    # post-mortem; replace NOW — backoff is for crash
                    # loops, not for the platform evicting a slice
                    self._m_preemptions.inc(replica=m.spec.replica_id)
                    self._m_restarts.inc(replica=m.spec.replica_id)
                    self._log.warning(
                        "replica %s preempted (rc %d); immediate "
                        "replacement, no backoff",
                        m.spec.replica_id, proc.returncode,
                    )
                    self._spawn(m)
                    continue
                if m.restart_due is None:
                    if now - m.spawned_at >= self.stable_s:
                        m.attempts = 0
                    delay = min(
                        self.backoff_base_s * (2**m.attempts),
                        self.backoff_max_s,
                    )
                    m.restart_due = now + delay
                    self._log.warning(
                        "replica %s exited (rc %s); restart in %.2fs "
                        "(attempt %d)",
                        m.spec.replica_id, proc.returncode, delay,
                        m.attempts + 1,
                    )
                    self._dump_death(m.spec.replica_id, proc)
                elif now >= m.restart_due:
                    m.attempts += 1
                    self._m_restarts.inc(replica=m.spec.replica_id)
                    self._spawn(m)
            self._wake.wait(0.05)

    def _dump_death(self, replica_id: str, proc) -> None:
        """A replica died while the pod was supposed to be up: write the
        replica_death flight-recorder post-mortem. The SUPERVISOR process
        ring (shared with the router in a `Fabric`) holds the dead
        replica's last heartbeats — `death_info` lifts its warm buckets
        and state into the dump header. Never raises (runs on the
        monitor thread)."""
        from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder

        extra = {"replica": replica_id, "returncode": proc.returncode}
        if self._death_info is not None:
            try:
                extra.update(self._death_info(replica_id) or {})
            except Exception:  # a racing table read must not kill monitor
                pass
        path = recorder.dump("replica_death", extra=extra)
        if path:
            self._log.warning(
                "replica %s death post-mortem -> %s", replica_id, path
            )

    def stop(self, *, drain: bool = True, deadline_s: float = 30.0) -> None:
        """SIGTERM every replica (graceful drain in the worker), wait out
        the deadline, SIGKILL stragglers. Idempotent."""
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        procs = [
            m.proc for m in self._managed.values() if m.proc is not None
        ]
        sig = signal.SIGTERM if drain else signal.SIGKILL
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass
        deadline = self._clock() + deadline_s
        for p in procs:
            left = max(0.1, deadline - self._clock())
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                self._log.warning(
                    "replica pid %d ignored the drain deadline; killing",
                    p.pid,
                )
                p.kill()
                p.wait(timeout=10.0)

    # -- dynamic membership (autoscaler + canary) --------------------------

    def add(self, spec: ReplicaSpec) -> None:
        """Grow the set by one replica (autoscaler scale-up). The new
        process registers itself with the router by heartbeat like any
        other."""
        with self._lock:
            if spec.replica_id in self._managed:
                raise ValueError(
                    f"replica {spec.replica_id!r} is already managed"
                )
            m = self._managed[spec.replica_id] = _Managed(spec)
        self._spawn(m)

    def remove(self, replica_id: str, *, deadline_s: float = 30.0) -> None:
        """Shrink the set: SIGTERM (the replica drains what it still
        holds) and FORGET — the monitor will not resurrect it. The
        autoscaler only calls this after the router-side drain emptied
        the replica's queue (drain-before-kill)."""
        with self._lock:
            m = self._managed.get(replica_id)
            if m is None:
                return
            m.removed = True
            del self._managed[replica_id]
        proc = m.proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.send_signal(signal.SIGTERM)
        except OSError:
            return
        try:
            proc.wait(timeout=deadline_s)
        except subprocess.TimeoutExpired:
            self._log.warning(
                "removed replica %s ignored the drain deadline; killing",
                replica_id,
            )
            proc.kill()
            proc.wait(timeout=10.0)
        self._log.info(
            "replica %s removed (rc %s)", replica_id, proc.returncode
        )

    def respawn(
        self,
        replica_id: str,
        *,
        spec: ReplicaSpec | None = None,
        deadline_s: float = 30.0,
    ) -> None:
        """Replace one replica's PROCESS, gracefully, optionally with a
        new spec — the canary deploy/revert path (a config flip is a
        respawn with different argv/env, nothing more)."""
        with self._lock:
            m = self._managed[replica_id]
            m.removed = True  # monitor hands off while we swap
            proc = m.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=deadline_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
            except OSError:
                pass
        with self._lock:
            if spec is not None:
                m.spec = spec
            m.attempts = 0
            m.removed = False
        self._m_restarts.inc(replica=replica_id)
        self._spawn(m)

    def spec_of(self, replica_id: str) -> ReplicaSpec:
        with self._lock:
            return self._managed[replica_id].spec

    def replica_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._managed)

    # -- churn / introspection --------------------------------------------

    def kill(self, replica_id: str) -> int:
        """SIGKILL one replica (no drain, no warning — the churn test's
        simulated hard failure). The monitor restarts it with backoff.
        Returns the killed pid."""
        with self._lock:
            m = self._managed[replica_id]
            proc = m.proc
        assert proc is not None, f"{replica_id} was never spawned"
        proc.kill()
        proc.wait(timeout=10.0)
        return proc.pid

    def pids(self) -> dict[str, int | None]:
        with self._lock:
            return {
                rid: (m.proc.pid if m.proc is not None else None)
                for rid, m in self._managed.items()
            }

    def restarts(self, replica_id: str) -> int:
        return int(self._m_restarts.value(replica=replica_id))

    def preemptions(self, replica_id: str) -> int:
        return int(self._m_preemptions.value(replica=replica_id))


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """The whole pod in one value: replica count + the serve knobs each
    replica runs with + router policy overrides."""

    replicas: int = 3
    ops: str = "grayscale,contrast:3.5,emboss:3"
    buckets: str = "512,1024,2048,4096"  # CLI spec; parsed for the router
    channels: str = "1,3"
    max_batch: int = 8
    max_delay_ms: float = 5.0
    queue_depth: int = 64
    # the padded executor's accumulation on every replica: 'torch' (the
    # golden ops; the JAX package's 'xla') or 'mxu'
    impl: str = "torch"
    # the torch device every replica serves on and the mesh lane's slots
    # live on (default CUDA; 'cpu' for the tests)
    device: str = "cuda"
    heartbeat_s: float | None = None  # None: MCIM_FABRIC_HEARTBEAT_S
    router: RouterConfig | None = None  # None: RouterConfig(buckets=...)
    mesh_shards: int = 0  # >0: arm the oversize mesh lane in the router
    mesh_halo_mode: str = "serial"
    # fusion-plan mode every replica serves with (the canary deploy path
    # flips it per replica via `--plan` in the flip argv)
    plan: str = "auto"
    # continuous autotuning (tune/): tune=True arms MCIM_TUNE=1 on every
    # replica (observations persist to the shared calibration store) and
    # starts a TuneController on the router that proposes config flips
    # from those observations and promotes/rolls them back through the
    # canary gate with no human in the loop
    tune: bool = False
    tune_arms: str | None = None  # comma list; None: MCIM_TUNE_ARMS/default
    tune_config: object | None = None  # tune.controller.TuneConfig; None: env
    # pod-level systolic execution: arm the router's stage-sharding lane
    # AND start every replica with --systolic so heartbeats advertise
    # stage ownership (graph/systolic.py)
    systolic: bool = False
    # per-replica env overrides (failpoint injection on one worker, trace
    # export paths, ...) and extra replica argv (e.g. --trace-out)
    replica_env: dict[str, dict[str, str]] = dataclasses.field(
        default_factory=dict
    )
    replica_argv_extra: dict[str, list[str]] = dataclasses.field(
        default_factory=dict
    )
    # env applied to EVERY replica, including ones the autoscaler adds
    # later (per-replica replica_env wins on clashes)
    all_replica_env: dict[str, str] = dataclasses.field(
        default_factory=dict
    )
    supervisor_backoff_s: float = 0.5
    supervisor_stable_s: float = 5.0
    # -- elastic control loop (fabric/autoscaler.py) ------------------------
    # autoscale=True arms the loop; `replicas` is the STARTING count and
    # the loop then steers within [min_replicas, max_replicas] (None
    # fields fall back to MCIM_FABRIC_MIN/MAX_REPLICAS / SCALE_* env)
    autoscale: bool = False
    min_replicas: int | None = None
    max_replicas: int | None = None
    scale_up_frac: float | None = None
    scale_down_frac: float | None = None
    scale_sustain_s: float | None = None
    scale_cooldown_s: float | None = None
    scale_tick_s: float | None = None
    scale_drain_deadline_s: float | None = None
    # -- multi-pod federation (federation/) ---------------------------------
    # federate=<front-door URL> arms the router's pod-level uplink: this
    # pod pushes aggregate heartbeats there and applies quota leases
    # from the acks; pod_id is the pod's stable identity across restarts
    federate: str | None = None
    pod_id: str | None = None
    fed_heartbeat_s: float | None = None  # None: MCIM_FED_HEARTBEAT_S


class Fabric:
    """Router + supervised replicas, one lifecycle."""

    def __init__(self, config: FabricConfig):
        self.config = config
        self.registry = Registry()
        mesh_lane = None
        if config.mesh_shards > 0:
            from mpi_cuda_imagemanipulation_tpu_torch.fabric.mesh import MeshLane

            mesh_lane = MeshLane(
                config.ops,
                config.mesh_shards,
                halo_mode=config.mesh_halo_mode,
                # the ghost-mode kernels on the card, their plain versions
                # on CPU slots (Pipeline.sharded picks by the tensors' device)
                backend="cuda",
                device=config.device,
            )
        router_cfg = config.router or RouterConfig(
            buckets=bucketing.parse_buckets(config.buckets)
        )
        if config.systolic:
            router_cfg = dataclasses.replace(router_cfg, systolic=True)
        self.router = Router(
            router_cfg,
            registry=self.registry,
            mesh_lane=mesh_lane,
        )
        # canary control plane: the router gates + decides, the Fabric
        # owns the process swaps (deploy = respawn with the flip config,
        # rollback = respawn with the stable one)
        self.router.on_canary_deploy = self._canary_deploy
        self.router.on_canary_rollback = self._canary_rollback
        self._canary_stable_spec: ReplicaSpec | None = None
        # tune controller state: a promoted flip's argv/env delta joins
        # every FUTURE replica spec too (autoscaler scale-ups, supervisor
        # restarts), so the fleet stays converged across churn
        self.tuner = None
        self._tune_argv: list[str] = []
        self._tune_env: dict[str, str] = {}
        self.supervisor: Supervisor | None = None
        self.autoscaler = None
        # injectable like the Supervisor's (line ~245): the _wait_*
        # helpers poll through these, so fake-clock tests can exercise
        # their timeout paths without real 180s waits
        self._clock = time.monotonic
        self._sleep = time.sleep
        self._log = get_logger()

    def replica_ids(self) -> list[str]:
        return [f"r{i}" for i in range(self.config.replicas)]

    def _death_info(self, replica_id: str) -> dict:
        """Context for the replica_death post-mortem dump: the dead
        replica's last heartbeat as the router saw it — state, queue
        fill and (the churn question) which buckets it was serving warm."""
        view = self.router.table.get(replica_id)
        if view is None:
            return {}
        return {
            "last_state": view.hb.state,
            "last_queued": view.hb.queued,
            "warm_buckets": list(view.hb.warm_buckets),
            "breaker_open": list(view.hb.breaker_open),
            "incarnation": view.hb.incarnation,
        }

    def _replica_argv(self, rid: str) -> list[str]:
        c = self.config
        argv = [
            sys.executable, "-m",
            "mpi_cuda_imagemanipulation_tpu_torch.fabric.replica",
            "--replica-id", rid,
            "--router", self.router.url,
            "--ops", c.ops,
            "--buckets", c.buckets,
            "--channels", c.channels,
            "--max-batch", str(c.max_batch),
            "--max-delay-ms", str(c.max_delay_ms),
            "--queue-depth", str(c.queue_depth),
            "--impl", c.impl,
            "--plan", c.plan,
            "--device", c.device,
        ]
        if c.systolic:
            argv += ["--systolic"]
        if c.heartbeat_s is not None:
            argv += ["--heartbeat-s", str(c.heartbeat_s)]
        argv += c.replica_argv_extra.get(rid, [])
        # a tuner-promoted flip outranks the pinned config (argparse
        # last-wins — the same mechanism as the canary flip argv)
        argv += self._tune_argv
        return argv

    def _replica_spec(self, rid: str) -> ReplicaSpec:
        tune_env = {}
        if self.config.tune:
            # every replica ingests + persists online observations; the
            # configured env (user/all_replica_env) still wins on clash
            tune_env["MCIM_TUNE"] = "1"
        return ReplicaSpec(
            replica_id=rid,
            argv=self._replica_argv(rid),
            extra_env={
                **tune_env,
                **self._tune_env,
                **self.config.all_replica_env,
                **self.config.replica_env.get(rid, {}),
            },
        )

    def start(
        self,
        host: str = "",
        port: int = 0,
        *,
        ready_timeout_s: float = 180.0,
    ) -> "Fabric":
        try:
            self.router.start(host, port)
            if self.config.federate:
                # pod-level uplink AFTER the listener is bound (the pod
                # heartbeat advertises the router's real address) and
                # BEFORE the replicas: the front door learns of this
                # pod within one beat of it being reachable
                self.router.federate(
                    self.config.federate,
                    self.config.pod_id or f"pod-{os.getpid()}",
                    interval_s=self.config.fed_heartbeat_s,
                )
            specs = [
                self._replica_spec(rid) for rid in self.replica_ids()
            ]
            self.supervisor = Supervisor(
                specs,
                registry=self.registry,
                backoff_base_s=self.config.supervisor_backoff_s,
                stable_s=self.config.supervisor_stable_s,
                death_info=self._death_info,
            ).start()
            if self.config.autoscale:
                from mpi_cuda_imagemanipulation_tpu_torch.fabric.autoscaler import (
                    Autoscaler,
                    AutoscalerConfig,
                )

                c = self.config
                self.autoscaler = Autoscaler(
                    self.router,
                    scale_up=self._scale_up_replica,
                    scale_down=self._scale_down_replica,
                    live_count=lambda: len(self.supervisor.replica_ids()),
                    config=AutoscalerConfig(
                        min_replicas=c.min_replicas,
                        max_replicas=c.max_replicas,
                        up_frac=c.scale_up_frac,
                        down_frac=c.scale_down_frac,
                        sustain_s=c.scale_sustain_s,
                        cooldown_s=c.scale_cooldown_s,
                        tick_s=c.scale_tick_s,
                        drain_deadline_s=c.scale_drain_deadline_s,
                    ),
                    registry=self.registry,
                )
                self.router.autoscaler = self.autoscaler
            self.wait_ready(
                self.config.replicas, timeout_s=ready_timeout_s
            )
            if self.autoscaler is not None:
                # only after the seed set is serving: the loop must not
                # misread warmup as an outage and over-spawn
                self.autoscaler.start()
            if self.config.tune:
                # after the seed set is serving, like the autoscaler:
                # the first tick must see a routable pod, not warmup
                self._start_tuner()
        except BaseException:
            self.close(drain=False)
            raise
        return self

    def _start_tuner(self) -> None:
        from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (
            make_pipeline_ops,
        )
        from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import (
            pipeline_fingerprint,
        )
        from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import (
            resolve_plan_mode,
        )
        from mpi_cuda_imagemanipulation_tpu_torch.tune.controller import (
            TuneController,
        )
        from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

        c = self.config
        ops = make_pipeline_ops(c.ops)
        width = max(w for (_h, w) in bucketing.parse_buckets(c.buckets))
        # the arm the fleet is serving RIGHT NOW: the same resolution the
        # replicas ran (env/calibration-aware), so the controller's
        # incumbent matches reality even under plan='auto'
        mode = resolve_plan_mode(ops, c.plan, backend=c.impl, width=width,
                                 device=c.device)
        current_arm = f"plan:{mode}"
        raw = c.tune_arms or env_registry.get("MCIM_TUNE_ARMS")
        if raw:
            arms = tuple(a.strip() for a in raw.split(",") if a.strip())
        else:
            # the JAX package adds its megakernel modes on a TPU, where
            # they are real. On the card they are not arms: the padded
            # executor serves 'fused-pallas[-mxu]' through the 'fused'
            # walker (a kernel stage extends edges at the bucket border,
            # serve/padded.resolve_serving_plan), so they would duplicate
            # 'plan:fused' on every device
            arms = ("plan:off", "plan:fused")
        if current_arm not in arms:
            arms = (current_arm,) + arms
        self.tuner = TuneController(
            gate=self.router.canary,
            deploy=self.router.canary_deploy,
            pipe_fp=pipeline_fingerprint(ops),
            current_arm=current_arm,
            arms=arms,
            registry=self.registry,
            on_promote=self._tune_promote,
            on_revert=self._canary_rollback,
            config=c.tune_config,
        )
        self.router.tuner = self.tuner
        self.tuner.start()

    def _tune_promote(self, flip: dict) -> None:
        """Tuner promote hook: the canary replica already runs the flip
        and proved it — roll the REST of the fleet onto it, one replica
        at a time so the pod keeps serving throughout, and fold the
        delta into the base spec so scale-ups and restarts inherit it."""
        assert self.supervisor is not None
        argv_extra = [str(a) for a in flip.get("argv", [])]
        env_extra = {
            str(k): str(v) for k, v in flip.get("env", {}).items()
        }
        canary_rid = self.router.canary.replica_id
        self._tune_argv = self._tune_argv + argv_extra
        self._tune_env = {**self._tune_env, **env_extra}
        for rid in sorted(self.supervisor.replica_ids()):
            if rid == canary_rid:
                continue
            view = self.router.table.get(rid)
            old_inc = view.hb.incarnation if view is not None else None
            self._log.info(
                "tune promote: respawning %s with argv+=%s", rid, argv_extra
            )
            self.supervisor.respawn(rid, spec=self._replica_spec(rid))
            self._wait_incarnation_change(rid, old_inc)
        # the canary's one-off spec is now the fleet's config; its next
        # respawn (supervisor restart, scale churn) rebuilds from the
        # updated base, so the stale stable snapshot must not revive
        self._canary_stable_spec = None

    # -- elastic membership (autoscaler callbacks) -------------------------

    def _next_replica_id(self) -> str:
        """Lowest free index, so drained ids are REUSED: metric label
        sets and rendezvous layouts stay bounded over any number of
        scale cycles."""
        assert self.supervisor is not None
        taken = set(self.supervisor.replica_ids())
        i = 0
        while f"r{i}" in taken:
            i += 1
        return f"r{i}"

    def _scale_up_replica(self) -> str:
        assert self.supervisor is not None
        rid = self._next_replica_id()
        self.supervisor.add(self._replica_spec(rid))
        return rid

    def _scale_down_replica(self, rid: str) -> None:
        assert self.supervisor is not None
        self.supervisor.remove(
            rid,
            deadline_s=self.config.scale_drain_deadline_s or 30.0,
        )

    # -- canary control plane (router callbacks) ---------------------------

    def _wait_incarnation_change(
        self, rid: str, old_incarnation: str | None, timeout_s: float = 180.0
    ) -> None:
        deadline = self._clock() + timeout_s
        while self._clock() < deadline:
            view = self.router.table.get(rid)
            if (
                view is not None
                and view.hb.incarnation != old_incarnation
                and view.hb.state == "serving"
            ):
                return
            self._sleep(0.1)
        raise TimeoutError(
            f"replica {rid} did not re-register serving within "
            f"{timeout_s:.0f}s"
        )

    def _canary_pick(self) -> str:
        """The flip's guinea pig: the highest-index routable replica —
        deterministic, and r0 (the rendezvous-heaviest seed) keeps
        serving stable traffic."""
        live = sorted(v.replica_id for v in self.router._routable())
        if not live:
            raise RuntimeError("no routable replica to canary")
        return live[-1]

    def _canary_deploy(self, flip: dict) -> str:
        """Router deploy hook: respawn one replica with the flip's
        argv/env delta, block until its new incarnation is serving, and
        hand the id back for the gate to open the traffic slice."""
        assert self.supervisor is not None
        rid = flip.get("replica") or self._canary_pick()
        stable = self.supervisor.spec_of(rid)
        self._canary_stable_spec = stable
        view = self.router.table.get(rid)
        old_inc = view.hb.incarnation if view is not None else None
        canary_spec = ReplicaSpec(
            replica_id=rid,
            argv=list(stable.argv) + [str(a) for a in flip.get("argv", [])],
            extra_env={
                **stable.extra_env,
                **{str(k): str(v) for k, v in flip.get("env", {}).items()},
            },
        )
        self._log.info(
            "canary deploy on %s: argv+=%s env+=%s",
            rid, flip.get("argv", []), sorted(flip.get("env", {})),
        )
        self.supervisor.respawn(rid, spec=canary_spec)
        self._wait_incarnation_change(rid, old_inc)
        return rid

    def _canary_rollback(self, status: dict) -> None:
        """Router rollback hook (off the request thread): put the stable
        spec back, wait for it to serve, then return the gate to idle."""
        assert self.supervisor is not None
        rid = status.get("replica")
        stable = self._canary_stable_spec
        if rid is None or stable is None:
            return
        view = self.router.table.get(rid)
        old_inc = view.hb.incarnation if view is not None else None
        self._log.warning(
            "canary rollback on %s: reverting to the stable spec", rid
        )
        try:
            self.supervisor.respawn(rid, spec=stable)
            self._wait_incarnation_change(rid, old_inc)
        finally:
            self.router.canary.reset()

    def wait_ready(self, n: int, *, timeout_s: float = 180.0) -> None:
        """Block until `n` replicas are fresh + routable (each has warmed
        its function cache and heartbeated `serving`)."""
        deadline = self._clock() + timeout_s
        while self._clock() < deadline:
            if len(self.router._routable()) >= n:
                return
            self._sleep(0.1)
        pids = self.supervisor.pids() if self.supervisor else {}
        raise TimeoutError(
            f"{n} replicas not serving within {timeout_s:.0f}s "
            f"(routable: {sorted(v.replica_id for v in self.router._routable())}, "
            f"pids: {pids})"
        )

    @property
    def url(self) -> str:
        return self.router.url

    def kill_replica(self, replica_id: str) -> int:
        assert self.supervisor is not None
        return self.supervisor.kill(replica_id)

    def stats(self) -> dict:
        return {
            "router": self.router.stats(),
            "pids": self.supervisor.pids() if self.supervisor else {},
        }

    def scrape(self) -> str:
        """The router's /metrics body over HTTP (what a Prometheus scrape
        sees — exercised, not simulated)."""
        with urllib.request.urlopen(
            self.url + "/metrics", timeout=10.0
        ) as resp:
            return resp.read().decode()

    def http_stats(self) -> dict:
        with urllib.request.urlopen(
            self.url + "/stats", timeout=10.0
        ) as resp:
            return json.loads(resp.read())

    def close(self, *, drain: bool = True, deadline_s: float = 30.0) -> None:
        if self.tuner is not None:
            # before the supervisor: a mid-close promote must not respawn
            # replicas the supervisor is tearing down
            self.tuner.stop()
            self.tuner = None
        if self.autoscaler is not None:
            self.autoscaler.stop()
            self.autoscaler = None
        if self.supervisor is not None:
            self.supervisor.stop(drain=drain, deadline_s=deadline_s)
            self.supervisor = None
        self.router.close()

    def __enter__(self) -> "Fabric":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
