"""Seeded chaos schedules over the closed failure vocabulary. The
counterpart of the JAX package's ``resilience/chaos.py``: the same seed
compiles to the same schedule in both packages.

This module composes scripted faults *randomly but reproducibly*:
`ChaosSchedule.compile(seed)` expands a seed into

  * per-pod failpoint env specs over the CLOSED site vocabulary
    (resilience/failpoints.KNOWN_SITES) — probabilistic forward/dispatch
    faults, dropped replica/pod heartbeats, and `sleep:MS` brownouts —
    baked into each pod's environment at spawn (failpoints arm from
    `MCIM_FAILPOINTS` at import, and `configure()` only affects the
    calling process, so subprocess pods MUST get their spec via env);
  * timed process faults (`kill_replica` SIGKILL, `preempt_replica`
    SIGUSR1, one whole-pod `kill_pod`) applied mid-run by a
    `ChaosRunner` thread through caller-supplied action callbacks.

Determinism is the contract: the same (seed, pods, duration) always
compiles to the identical event trace and failpoint specs — a failing
chaos run is re-runnable bit-for-bit from its seed (`trace()` is the
canonical comparison form; tests/test_torch_resilience.py holds it
equal to the JAX package's). The schedule deliberately has no clock and
no randomness at RUN time; `ChaosRunner` only replays precomputed
offsets.

The JAX package's harness that drives this against a real door -> pods
-> replicas stack is its tools/chaos_smoke.py; the port's comes with its
fabric and federation layers.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

# Timed process-fault kinds a runner can apply (the action callbacks a
# harness must supply). Closed so a schedule can never ask a harness for
# an action it does not implement.
EVENT_KINDS = (
    "kill_replica",    # SIGKILL one replica; the supervisor restarts it
    "preempt_replica", # SIGUSR1 preemption notice; graceful drain +
                       # PREEMPT_EXIT_CODE + immediate respawn
    "kill_pod",        # SIGKILL the whole pod (supervisor + replicas),
                       # no restart — the pod is gone, not degraded
)

# The failpoint sites a compiled schedule may arm — a subset of
# failpoints.KNOWN_SITES (checked at import below): the cross-tier
# faults the deadline/budget/hedge machinery must survive.
FAULT_SITES = (
    "router.forward",     # one proxy attempt fails -> reroute + breaker
    "serve.dispatch",     # replica dispatch fails -> scheduler retry
    "replica.heartbeat",  # replica beat dropped -> router staleness
    "pod.heartbeat",      # pod beat dropped -> front-door staleness
)

assert all(s in failpoints.KNOWN_SITES for s in FAULT_SITES), (
    "chaos FAULT_SITES must stay within failpoints.KNOWN_SITES"
)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One timed process fault: at `t_s` seconds after run start, apply
    `kind` to `pod` (detail = replica index for replica-scoped kinds)."""

    t_s: float
    kind: str
    pod: str
    detail: str = ""

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown chaos event kind {self.kind!r} "
                f"(known: {EVENT_KINDS})"
            )


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A compiled, fully deterministic chaos plan for one run."""

    seed: int
    duration_s: float
    pods: tuple[str, ...]
    events: tuple[ChaosEvent, ...]
    # pod id -> MCIM_FAILPOINTS spec to bake into that pod's env at
    # spawn (empty string = no injected faults for that pod)
    failpoints: dict[str, str]
    failpoint_seed: int

    @classmethod
    def compile(
        cls,
        seed: int,
        *,
        pods: tuple[str, ...] | list[str],
        duration_s: float,
        replicas_per_pod: int = 2,
        kill_pod: bool = True,
        brownout_ms: int = 0,
    ) -> "ChaosSchedule":
        """Expand a seed into a deterministic fault mix. All randomness
        happens HERE, through one seeded PRNG consumed in a fixed order
        — never at run time.

        `brownout_ms > 0` arms a `serve.dispatch=sleep:MS` latency
        brownout on exactly one pod (the slow-replica schedule the
        hedging A/B measures against); 0 leaves serve.dispatch free for
        a probabilistic fault instead."""
        pods = tuple(pods)
        if not pods:
            raise ValueError("chaos schedule needs at least one pod")
        rng = random.Random(seed)
        specs: dict[str, str] = {}
        brown_pod = rng.choice(pods) if brownout_ms > 0 else None
        for pod in pods:
            toks: list[str] = []
            if rng.random() < 0.8:
                toks.append(
                    f"router.forward={round(rng.uniform(0.01, 0.06), 3)}"
                )
            if pod == brown_pod:
                # unconditional latency on the pod's replicas: the
                # brownout the deadline chain + hedging must absorb
                toks.append(f"serve.dispatch=sleep:{int(brownout_ms)}")
            elif rng.random() < 0.6:
                toks.append(
                    f"serve.dispatch={round(rng.uniform(0.01, 0.05), 3)}"
                )
            if rng.random() < 0.5:
                toks.append(
                    f"replica.heartbeat={round(rng.uniform(0.02, 0.1), 3)}"
                )
            if rng.random() < 0.35:
                toks.append(
                    f"pod.heartbeat={round(rng.uniform(0.02, 0.08), 3)}"
                )
            specs[pod] = ",".join(toks)
        events: list[ChaosEvent] = []
        # a couple of replica-scoped faults, anywhere in the middle band
        for _ in range(rng.randrange(1, 3)):
            events.append(ChaosEvent(
                t_s=round(rng.uniform(0.15, 0.6) * duration_s, 3),
                kind="kill_replica",
                pod=rng.choice(pods),
                detail=str(rng.randrange(replicas_per_pod)),
            ))
        if rng.random() < 0.7:
            events.append(ChaosEvent(
                t_s=round(rng.uniform(0.2, 0.7) * duration_s, 3),
                kind="preempt_replica",
                pod=rng.choice(pods),
                detail=str(rng.randrange(replicas_per_pod)),
            ))
        if kill_pod and len(pods) > 1:
            # exactly ONE whole-pod loss, late enough that the other
            # faults have already run, early enough that the survivors
            # carry real load afterwards; never the last live pod
            events.append(ChaosEvent(
                t_s=round(rng.uniform(0.45, 0.7) * duration_s, 3),
                kind="kill_pod",
                pod=rng.choice(pods),
            ))
        events.sort(key=lambda e: (e.t_s, e.kind, e.pod, e.detail))
        return cls(
            seed=seed,
            duration_s=float(duration_s),
            pods=pods,
            events=tuple(events),
            failpoints=specs,
            failpoint_seed=seed,
        )

    def trace(self) -> tuple[str, ...]:
        """The canonical textual form — what the determinism test (and a
        failure report) compares: same seed -> identical trace."""
        lines = [
            f"failpoints {pod}: {self.failpoints[pod] or '-'}"
            for pod in self.pods
        ]
        lines += [
            f"t={e.t_s:.3f} {e.kind} pod={e.pod}"
            + (f" replica={e.detail}" if e.detail else "")
            for e in self.events
        ]
        return tuple(lines)

    def killed_pod(self) -> str | None:
        for e in self.events:
            if e.kind == "kill_pod":
                return e.pod
        return None


class ChaosRunner:
    """Replays a schedule's timed events against a live stack.

    `actions` maps event kind -> callable(event); a missing kind is an
    error at START (the closed-vocabulary posture: a harness either
    implements a fault or must not be handed a schedule containing it).
    Events whose action raises are recorded in `errors` and the run
    continues — a chaos harness must never die of its own fault
    injection. `applied` holds the events actually fired, in order."""

    def __init__(
        self,
        schedule: ChaosSchedule,
        actions: dict,
        *,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        missing = [
            e.kind for e in schedule.events if e.kind not in actions
        ]
        if missing:
            raise ValueError(
                f"chaos runner missing actions for {sorted(set(missing))}"
            )
        self.schedule = schedule
        self.actions = actions
        self.applied: list[ChaosEvent] = []
        self.errors: list[tuple[ChaosEvent, str]] = []
        self._clock = clock
        self._sleep = sleep
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ChaosRunner":
        self._thread = threading.Thread(
            target=self._run, name="mcim-chaos", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = self._clock()
        for ev in self.schedule.events:
            while not self._stop.is_set():
                wait = t0 + ev.t_s - self._clock()
                if wait <= 0:
                    break
                self._sleep(min(wait, 0.05))
            if self._stop.is_set():
                return
            try:
                self.actions[ev.kind](ev)
                self.applied.append(ev)
            except Exception as e:
                self.errors.append(
                    (ev, f"{type(e).__name__}: {str(e)[:200]}")
                )

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
