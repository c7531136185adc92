"""Canary rollback gate — a config flip earns the pod, it is not handed it.
The counterpart of the JAX package's ``fabric/canary.py``.

A "config flip" (plan mode, backend choice, calibration update) used to
deploy to 100% of traffic the moment the replicas restarted with it. The
gate inverts that: the flip goes to ONE canary replica first, the router
steers a small deterministic slice of front-door traffic (~5%,
`MCIM_FABRIC_CANARY_FRAC`) at it, and every outcome lands in one of two
lanes — canary or stable. Two checks guard the flip:

  * **burn-rate comparison** — the canary lane's bad-outcome rate must
    stay under `MCIM_FABRIC_CANARY_BURN_RATIO` x the stable lanes' rate
    over the gate window (and under the absolute
    `MCIM_FABRIC_CANARY_BAD_FRAC` floor for the quiet-pod case where
    stable has no errors to compare against). This is the same
    error-budget arithmetic the SLO engine runs, scoped to the flip.
  * **bit-exactness spot checks** — every k-th canary-routed request is
    SHADOWED: the router forwards a duplicate to a stable replica,
    compares response digests, and answers the client from STABLE (a
    shadowed request can never be hurt by the canary). One digest
    mismatch is a breach on its own — a flip that changes pixels is
    wrong regardless of its error rate (the serving contract is
    bit-exact across plan/backend flips).

Breach -> the gate flips to `rolled_back`, the router dumps the
`canary_rollback` flight-recorder artifact with the lane counts, and the
`on_rollback` callback (the Fabric) respawns the canary replica with the
stable config. The gate is pure decision logic over injected outcomes —
no sockets, no clocks it does not receive — so the hysteresis and breach
arithmetic are unit-testable; the router owns the routing side.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

ENV_FRAC = "MCIM_FABRIC_CANARY_FRAC"
ENV_MIN_REQUESTS = "MCIM_FABRIC_CANARY_MIN_REQUESTS"
ENV_SHADOW_EVERY = "MCIM_FABRIC_CANARY_SHADOW_EVERY"
ENV_BAD_FRAC = "MCIM_FABRIC_CANARY_BAD_FRAC"
ENV_BURN_RATIO = "MCIM_FABRIC_CANARY_BURN_RATIO"
ENV_PROMOTE_REQUESTS = "MCIM_FABRIC_CANARY_PROMOTE_REQUESTS"

# gate lifecycle: idle -> canary -> (rolled_back | promoted) -> idle
IDLE = "idle"
CANARY = "canary"
ROLLED_BACK = "rolled_back"
PROMOTED = "promoted"


@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    frac: float | None = None  # None: MCIM_FABRIC_CANARY_FRAC
    min_requests: int | None = None
    shadow_every: int | None = None
    bad_frac: float | None = None
    burn_ratio: float | None = None
    promote_requests: int | None = None

    def resolved(self) -> "CanaryConfig":
        def _f(v, name):
            return float(env_registry.get(name)) if v is None else float(v)

        def _i(v, name):
            return int(env_registry.get(name)) if v is None else int(v)

        return CanaryConfig(
            frac=_f(self.frac, ENV_FRAC),
            min_requests=_i(self.min_requests, ENV_MIN_REQUESTS),
            shadow_every=_i(self.shadow_every, ENV_SHADOW_EVERY),
            bad_frac=_f(self.bad_frac, ENV_BAD_FRAC),
            burn_ratio=_f(self.burn_ratio, ENV_BURN_RATIO),
            promote_requests=_i(self.promote_requests, ENV_PROMOTE_REQUESTS),
        )


class CanaryGate:
    """One flip's lifecycle + the rollback decision. Thread-safe: the
    router records outcomes from handler threads; `start`/`finish` come
    from the control plane."""

    def __init__(self, config: CanaryConfig | None = None, *,
                 clock=time.monotonic):
        self.config = (config or CanaryConfig()).resolved()
        self._clock = clock
        self._lock = threading.Lock()
        self.state = IDLE
        self.replica_id: str | None = None
        self.flip: dict = {}
        self.started_at: float | None = None
        self.decided_at: float | None = None
        self.reason: str | None = None
        # lane counts for THIS flip (reset per start)
        self.canary_ok = 0
        self.canary_bad = 0
        self.stable_ok = 0
        self.stable_bad = 0
        self.shadow_match = 0
        self.shadow_mismatch = 0
        self._route_counter = 0
        self._shadow_counter = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self, replica_id: str, flip: dict) -> None:
        with self._lock:
            if self.state == CANARY:
                raise RuntimeError(
                    f"canary already in flight on {self.replica_id!r}"
                )
            self.state = CANARY
            self.replica_id = replica_id
            self.flip = dict(flip)
            self.started_at = self._clock()
            self.decided_at = None
            self.reason = None
            self.canary_ok = self.canary_bad = 0
            self.stable_ok = self.stable_bad = 0
            self.shadow_match = self.shadow_mismatch = 0
            self._route_counter = 0
            self._shadow_counter = 0

    def abort(self, reason: str = "aborted") -> None:
        with self._lock:
            if self.state == CANARY:
                self._decide(ROLLED_BACK, reason)

    def reset(self) -> None:
        """Back to idle after the rollback/promotion has been ACTED on
        (the Fabric respawned the replica); the decided stats survive in
        `last` until the next start."""
        with self._lock:
            if self.state != CANARY:
                self.state = IDLE

    # -- routing decisions (router hot path) ---------------------------------

    def take_canary(self) -> bool:
        """Deterministic traffic slice: every round(1/frac)-th front-door
        request routes to the canary (counter-based, so the slice holds
        under any request rate and is reproducible in tests)."""
        with self._lock:
            if self.state != CANARY:
                return False
            period = max(1, round(1.0 / max(self.config.frac, 1e-6)))
            self._route_counter += 1
            return self._route_counter % period == 0

    def take_shadow(self) -> bool:
        """Among canary-routed requests, every k-th also shadows to
        stable for the digest spot check."""
        with self._lock:
            if self.state != CANARY:
                return False
            self._shadow_counter += 1
            return self._shadow_counter % max(1, self.config.shadow_every) == 0

    # -- outcome recording + the gate ----------------------------------------

    def record(self, lane: str, ok: bool) -> str:
        """Fold one request outcome in; returns the (possibly new) gate
        state so the router can act on a breach in the same call."""
        with self._lock:
            if self.state != CANARY:
                return self.state
            if lane == "canary":
                if ok:
                    self.canary_ok += 1
                else:
                    self.canary_bad += 1
            else:
                if ok:
                    self.stable_ok += 1
                else:
                    self.stable_bad += 1
            self._evaluate()
            return self.state

    def record_shadow(self, match: bool) -> str:
        with self._lock:
            if self.state != CANARY:
                return self.state
            if match:
                self.shadow_match += 1
            else:
                self.shadow_mismatch += 1
            self._evaluate()
            return self.state

    def _evaluate(self) -> None:
        """The rollback gate (lock held). A digest mismatch breaches
        immediately; rate breaches wait for min_requests canary outcomes
        so one unlucky request cannot roll a healthy flip back."""
        cfg = self.config
        if self.shadow_mismatch > 0:
            self._decide(ROLLED_BACK, "shadow digest mismatch")
            return
        n_canary = self.canary_ok + self.canary_bad
        if n_canary < cfg.min_requests:
            return
        canary_rate = self.canary_bad / n_canary
        n_stable = self.stable_ok + self.stable_bad
        stable_rate = (self.stable_bad / n_stable) if n_stable else 0.0
        if canary_rate > cfg.bad_frac and (
            n_stable == 0 or canary_rate > cfg.burn_ratio * stable_rate
        ):
            self._decide(
                ROLLED_BACK,
                f"canary bad rate {canary_rate:.3f} vs stable "
                f"{stable_rate:.3f} (ratio limit {cfg.burn_ratio:g}, "
                f"abs limit {cfg.bad_frac:g})",
            )
            return
        if n_canary >= cfg.promote_requests:
            self._decide(PROMOTED, "no breach over the promote window")

    def _decide(self, state: str, reason: str) -> None:
        self.state = state
        self.reason = reason
        self.decided_at = self._clock()

    # -- introspection --------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "replica": self.replica_id,
                "flip": dict(self.flip),
                "frac": self.config.frac,
                "reason": self.reason,
                "canary": {"ok": self.canary_ok, "bad": self.canary_bad},
                "stable": {"ok": self.stable_ok, "bad": self.stable_bad},
                "shadow": {
                    "match": self.shadow_match,
                    "mismatch": self.shadow_mismatch,
                },
                "age_s": (
                    None
                    if self.started_at is None
                    else self._clock() - self.started_at
                ),
            }
