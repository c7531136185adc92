"""Tune controller — UCB candidate ranking + canary-gated actuation. The
counterpart of the JAX package's ``tune/controller.py``.

Runs in the ROUTER process on its own tick (SLOEngine's ticker shape):
each tick reads the online store's decayed arm statistics for the pod's
pipeline at its hottest width window and emits exactly one decision from
a closed vocabulary:

    insufficient_data   not enough effective samples to rank anything
    hold                ranked, but no candidate clears the gain bar
                        (or a flip is mid-canary — the gate decides)
    propose             deploy a candidate to the canary replica
    promote             gate passed AND the canary measured faster —
                        respawn the whole fleet onto the flip
    rollback            the flip lost: gate breach (quarantine), slower
                        than the incumbent, or produced no measurements
                        before MCIM_TUNE_FLIP_TIMEOUT_S

Every decision flows through `count_decision` (the systolic
count_fallback idiom — unknown members raise, mcim-check enforces the
literal at every call site) and lands in the calibration store's audit
trail. Exploration is optimistic-under-uncertainty for a MINIMIZATION
objective: an arm's score is its decayed mean scaled DOWN by a UCB
bonus, so under-sampled arms look temptingly fast until measured;
unmeasured arms are proposed outright once the incumbent has
MCIM_TUNE_MIN_SAMPLES effective observations.

Actuation is delegated: `deploy(flip)` is the router's canary_deploy,
`on_promote(flip)` / `on_revert(status)` are Fabric hooks that respawn
processes. The controller holds NO sockets or process handles — with a
fake clock, gate and callables it is a pure decision table
(tests/test_tune.py drives every row).

Safety: bit-exactness stays the contract. The canary gate rolls back on
the FIRST shadow-digest mismatch; the router's rollback hook respawns
the stable config before this controller even ticks again, and the tick
then quarantines the arm in the store so it is never proposed again.
The `tune.candidate` failpoint poisons a proposed flip into a
pixel-corrupting one so CI can prove that chain end to end.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

from mpi_cuda_imagemanipulation_tpu_torch.fabric import canary as canary_mod
from mpi_cuda_imagemanipulation_tpu_torch.resilience.failpoints import (
    FailpointError,
    maybe_fail,
)
from mpi_cuda_imagemanipulation_tpu_torch.tune.store import online_store
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

ENV_TICK_S = "MCIM_TUNE_TICK_S"
ENV_MIN_SAMPLES = "MCIM_TUNE_MIN_SAMPLES"
ENV_EXPLORE_C = "MCIM_TUNE_EXPLORE_C"
ENV_MIN_GAIN = "MCIM_TUNE_MIN_GAIN"
ENV_FLIP_TIMEOUT_S = "MCIM_TUNE_FLIP_TIMEOUT_S"
ENV_CANARY_FRAC = "MCIM_TUNE_CANARY_FRAC"

DECISIONS = ("propose", "hold", "promote", "rollback", "insufficient_data")

# arm vocabulary: "plan:<mode>" — the plan dimension is the one with a
# measured CPU-visible spread (BENCH_HISTORY plan_ab: off 1.5x slower
# than fused at 512^2), so it is the first dimension the controller
# actuates; backend/block_h arms reuse the same machinery when their
# flip argv is wired
_ARM_PREFIX = "plan:"


def count_decision(counter, decision: str) -> None:
    """The one choke point for decision accounting — raises on a member
    outside the closed vocabulary so a typo becomes a loud failure, not
    an unbounded label set (mcim-check: obs-tune-decision-*)."""
    if decision not in DECISIONS:
        raise ValueError(
            f"unknown tune decision {decision!r}; known: {DECISIONS}"
        )
    counter.inc(decision=decision)


def arm_flip(arm: str) -> dict:
    """The deploy payload for an arm: replica argv overriding the pinned
    config (argparse last-wins, the canary_deploy contract)."""
    if arm.startswith(_ARM_PREFIX):
        return {"argv": ["--plan", arm[len(_ARM_PREFIX):]]}
    raise ValueError(f"unknown tune arm {arm!r}")


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    tick_s: float | None = None
    min_samples: float | None = None
    explore_c: float | None = None
    min_gain: float | None = None
    flip_timeout_s: float | None = None
    canary_frac: float | None = None

    def resolved(self) -> "TuneConfig":
        def _f(v, name):
            return float(env_registry.get(name)) if v is None else float(v)

        frac = self.canary_frac
        if frac is None:
            raw = env_registry.get(ENV_CANARY_FRAC)
            frac = float(raw) if raw else None
        return TuneConfig(
            tick_s=_f(self.tick_s, ENV_TICK_S),
            min_samples=_f(self.min_samples, ENV_MIN_SAMPLES),
            explore_c=_f(self.explore_c, ENV_EXPLORE_C),
            min_gain=_f(self.min_gain, ENV_MIN_GAIN),
            flip_timeout_s=_f(self.flip_timeout_s, ENV_FLIP_TIMEOUT_S),
            canary_frac=frac,
        )


class TuneController:
    """One pod's closed-loop tuner. Pure decision logic over an injected
    gate, store and actuation callables — the Fabric wires the real
    ones; tests wire fakes."""

    def __init__(
        self,
        *,
        gate,
        deploy,
        pipe_fp: str,
        current_arm: str,
        arms: tuple[str, ...] | list[str],
        registry,
        on_promote=None,
        on_revert=None,
        store=None,
        config: TuneConfig | None = None,
        clock=time.time,
    ):
        self.gate = gate
        self.deploy = deploy
        self.pipe_fp = pipe_fp
        self.current_arm = current_arm
        self.arms = tuple(arms)
        self.on_promote = on_promote
        self.on_revert = on_revert
        self.store = store or online_store
        self.config = (config or TuneConfig()).resolved()
        self._clock = clock
        self._log = get_logger("tune")
        self.decisions = registry.counter(
            "mcim_tune_decisions_total",
            "Tune controller decisions, by closed-vocabulary member "
            "(propose/hold/promote/rollback/insufficient_data).",
            labels=("decision",),
        )
        self.proposals = registry.counter(
            "mcim_tune_proposals_total",
            "Candidate flips deployed to the canary replica, by arm.",
            labels=("arm",),
        )
        # a tuner flip is lower-stakes than an operator flip (it can
        # always retry), so the pod may scope it to a thinner slice
        if self.config.canary_frac is not None:
            self.gate.config = dataclasses.replace(
                self.gate.config, frac=self.config.canary_frac
            )
        # in-flight proposal state (one at a time; the gate enforces it)
        self.inflight_arm: str | None = None
        self.inflight_flip: dict | None = None
        self.proposed_at: float | None = None
        self.last_decision: str | None = None
        self.last_reason: str | None = None
        self.events: list[dict] = []  # bounded recent-decision ring
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- ticker (SLOEngine shape) ----------------------------------------

    def start(self) -> "TuneController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="mcim-tune-controller", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                self._log.exception("tune tick failed")
            self._stop.wait(self.config.tick_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- the decision tick ------------------------------------------------

    def tick(self) -> str:
        """One control-loop step; returns the decision made (a DECISIONS
        member — the return value is for tests/status, the counter and
        audit trail are the products)."""
        if self.inflight_arm is not None:
            decision, reason = self._tick_inflight()
        else:
            decision, reason = self._tick_idle()
        self._note(decision, reason)
        return decision

    def _tick_idle(self) -> tuple[str, str]:
        window = self._hottest_window()
        if window is None:
            count_decision(self.decisions, "insufficient_data")
            return "insufficient_data", "no observations yet"
        stats = self.store.arm_stats(self.pipe_fp, window)
        cur = stats.get(self.current_arm)
        cfg = self.config
        if cur is None or cur["n_eff"] < cfg.min_samples:
            count_decision(self.decisions, "insufficient_data")
            return (
                "insufficient_data",
                f"current arm {self.current_arm} has "
                f"{0 if cur is None else cur['n_eff']:.1f}/"
                f"{cfg.min_samples:g} effective samples in window "
                f"{window}",
            )
        candidate, why = self._pick(stats, window)
        if candidate is None:
            count_decision(self.decisions, "hold")
            return "hold", why
        return self._propose(candidate, window, why)

    def _pick(self, stats: dict, window: str) -> tuple[str | None, str]:
        """Rank candidate arms against the incumbent. Unmeasured arms
        explore first; measured ones exploit through an optimistic
        (UCB-style) lower bound on their decayed mean."""
        cfg = self.config
        cur_mean = stats[self.current_arm]["mean"]
        total = 1.0 + sum(s["n_eff"] for s in stats.values())
        best_arm, best_score = None, None
        for arm in self.arms:
            if arm == self.current_arm:
                continue
            if self.store.is_quarantined(self.pipe_fp, arm):
                continue
            s = stats.get(arm)
            if s is None or s["n_eff"] < cfg.min_samples:
                return arm, f"explore: arm {arm} unmeasured in window {window}"
            bonus = cfg.explore_c * math.sqrt(
                math.log(total) / max(s["n_eff"], 1e-9)
            )
            score = s["mean"] * max(0.0, 1.0 - bonus)
            if best_score is None or score < best_score:
                best_arm, best_score = arm, score
        if best_arm is not None and best_score * cfg.min_gain <= cur_mean:
            return (
                best_arm,
                f"exploit: {best_arm} optimistic mean {best_score:.4g}s "
                f"beats {self.current_arm} {cur_mean:.4g}s by >="
                f" {cfg.min_gain:g}x",
            )
        return None, (
            "no candidate clears the gain bar vs "
            f"{self.current_arm} ({cur_mean:.4g}s) in window {window}"
        )

    def _propose(self, arm: str, window: str, why: str) -> tuple[str, str]:
        flip = arm_flip(arm)
        try:
            maybe_fail("tune.candidate", arm=arm, pipe_fp=self.pipe_fp)
        except FailpointError:
            # the poisoned-candidate drill: swap the flip for one that
            # CHANGES PIXELS (ops override), proving the shadow-digest
            # gate catches a wrong-pixels flip before any client sees it
            flip = {"argv": ["--ops", "invert"]}
        try:
            self.deploy(flip)
        except Exception as e:
            count_decision(self.decisions, "hold")
            return "hold", f"deploy of {arm} refused: {e}"
        self.inflight_arm = arm
        self.inflight_flip = flip
        self.proposed_at = self._clock()
        self.proposals.inc(arm=arm)
        count_decision(self.decisions, "propose")
        return "propose", why

    def _tick_inflight(self) -> tuple[str, str]:
        arm = self.inflight_arm
        state = self.gate.state
        if state == canary_mod.CANARY:
            count_decision(self.decisions, "hold")
            return "hold", f"canary of {arm} in flight (gate deciding)"
        if state == canary_mod.PROMOTED:
            return self._tick_promoted(arm)
        # IDLE / ROLLED_BACK: the gate breached (shadow mismatch or burn)
        # and the router's rollback hook already respawned stable — our
        # job is the quarantine + the books
        reason = self.gate.reason or "canary rolled back"
        self.store.quarantine(self.pipe_fp, arm, reason)
        self._clear_inflight()
        count_decision(self.decisions, "rollback")
        return "rollback", f"{arm} breached the gate: {reason}"

    def _tick_promoted(self, arm: str) -> tuple[str, str]:
        """The gate passed (bit-exact, burn under control) — but safe is
        not the same as FASTER. Promote fleet-wide only when the canary's
        own measurements beat the incumbent by min_gain; otherwise revert
        the canary replica to stable (no quarantine: the arm is safe,
        just not a win here — decay may change that)."""
        cfg = self.config
        window = self._hottest_window()
        stats = (
            self.store.arm_stats(self.pipe_fp, window) if window else {}
        )
        cand = stats.get(arm)
        cur = stats.get(self.current_arm)
        if cand is None or cand["n_eff"] < cfg.min_samples:
            age = self._clock() - (self.proposed_at or 0.0)
            if age <= cfg.flip_timeout_s:
                count_decision(self.decisions, "hold")
                return "hold", (
                    f"gate passed {arm}; waiting for canary measurements "
                    f"({0 if cand is None else cand['n_eff']:.1f}/"
                    f"{cfg.min_samples:g})"
                )
            self._revert()
            self._clear_inflight()
            count_decision(self.decisions, "rollback")
            return "rollback", (
                f"{arm} produced no canary measurements within "
                f"{cfg.flip_timeout_s:g}s"
            )
        if cur is None or cand["mean"] * cfg.min_gain <= cur["mean"]:
            flip = dict(self.inflight_flip or {})
            if self.on_promote is not None:
                self.on_promote(flip)
            if arm.startswith(_ARM_PREFIX):
                # the store records the CHOICE (a PLAN_CHOICES member) so
                # effective_plan_choice can compare it with offline records
                self.store.promote(
                    self.pipe_fp, int(window), arm[len(_ARM_PREFIX):]
                )
            old = self.current_arm
            self.current_arm = arm
            self._clear_inflight(reset_gate=True)
            count_decision(self.decisions, "promote")
            return "promote", (
                f"{arm} measured {cand['mean']:.4g}s vs {old} "
                f"{'n/a' if cur is None else format(cur['mean'], '.4g')}s "
                "— fleet respawned onto the flip"
            )
        self._revert()
        self._clear_inflight()
        count_decision(self.decisions, "rollback")
        return "rollback", (
            f"{arm} passed the gate but measured {cand['mean']:.4g}s vs "
            f"{self.current_arm} {cur['mean']:.4g}s (< {cfg.min_gain:g}x "
            "gain) — canary reverted, no quarantine"
        )

    def _revert(self) -> None:
        """Put the canary replica back on the stable config after a
        promote-window loss (the gate never breached, so the router's
        rollback hook never fired — we drive the Fabric's directly)."""
        if self.on_revert is not None:
            try:
                self.on_revert(self.gate.status())
            except Exception:
                self._log.exception("tune revert failed")

    def _clear_inflight(self, reset_gate: bool = False) -> None:
        self.inflight_arm = None
        self.inflight_flip = None
        self.proposed_at = None
        if reset_gate:
            self.gate.reset()

    # -- helpers -----------------------------------------------------------

    def _hottest_window(self) -> str | None:
        windows = self.store.windows(self.pipe_fp)
        if not windows:
            return None
        return max(windows.items(), key=lambda kv: (kv[1], kv[0]))[0]

    def _note(self, decision: str, reason: str) -> None:
        # the mcim_tune_decisions_total count already happened at the
        # decision site (count_decision with the literal member — the
        # closed-vocab rule needs the literal there); this is the books
        self.last_decision = decision
        self.last_reason = reason
        changed = not self.events or (
            self.events[-1]["decision"] != decision
            or self.events[-1].get("arm") != self.inflight_arm
        )
        self.events.append(
            {
                "t": round(self._clock(), 3),
                "decision": decision,
                "reason": reason,
                "arm": self.inflight_arm or self.current_arm,
            }
        )
        del self.events[:-64]
        # every decision lands in the store's audit trail; repeats of the
        # same steady-state decision coalesce in the file via the flush
        # merge cap, but transitions always persist immediately
        self.store.audit(
            decision,
            arm=self.inflight_arm,
            current=self.current_arm,
            reason=reason if changed else None,
            fp=self.pipe_fp,
        )

    def status(self) -> dict:
        """The `/control/tune` and `router.stats()["tune"]` payload."""
        return {
            "current_arm": self.current_arm,
            "arms": list(self.arms),
            "inflight": self.inflight_arm,
            "last_decision": self.last_decision,
            "last_reason": self.last_reason,
            "pipe_fp": self.pipe_fp,
            "events": self.events[-8:],
        }
