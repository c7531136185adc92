"""End-to-end request lifecycle: deadlines, retry budgets, hedging. The
counterpart of the JAX package's ``resilience/deadline.py``, with the
same header, vocabularies and counters.

The three-tier stack (federation front door -> fabric router -> replica)
retries independently at every tier, which is exactly the amplification
bug Google's SRE literature warns about: a brownout triggers
door x router x scheduler retries, multiplying load on the survivors at
the moment they can least afford it. This module is the shared
vocabulary all tiers use to stay deadline-honest and retry-bounded:

  * **Deadline propagation** — the client (or the front door's
    `MCIM_FED_DEADLINE_MS` default) sets a budget; every hop forwards
    the *remaining* milliseconds as `X-MCIM-Deadline-Ms`. The wire form
    is remaining-budget, NOT an absolute timestamp, so clock skew
    between processes cannot corrupt it: each hop re-anchors the
    remainder on its own monotonic clock and decrements by its own
    measured time. Each tier checks before forwarding / rerouting /
    dispatching and answers 504 `deadline_expired` locally instead of
    doing doomed work; the serving scheduler's queue-pop expiry
    (serve/scheduler.py) is the LAST link of a chain that now starts at
    the edge. Expiry is counted per tier in
    `mcim_deadline_expired_total{tier}` through the `count_expired`
    choke point over the CLOSED `TIERS` vocabulary.

  * **Retry budgets** — a token-bucket `RetryBudget` at the door and
    the router: every accepted request deposits `frac` tokens
    (`MCIM_RETRY_BUDGET_FRAC`, default 0.1); every retry, reroute or
    hedge withdraws one. Under a brownout, retries degrade to
    <= 1 + frac attempts fleet-wide instead of multiplying across
    tiers. The bucket starts with `reserve` tokens
    (`MCIM_RETRY_BUDGET_RESERVE`) so cold-start failover — the first
    few seconds after a replica death, before any deposits banked —
    still reroutes; the exact invariant is
    `withdrawals <= frac * deposits + reserve`, which the chaos harness
    (resilience/chaos.py, tools/chaos_smoke.py) asserts end to end.

  * **Hedged requests** — for idempotent chain requests still pending
    past `MCIM_HEDGE_DELAY_FRAC` of the router's federated p99, one
    secondary forward to a different routable replica; first response
    wins. Hedges withdraw from the retry budget and are additionally
    capped at `MCIM_HEDGE_MAX_FRAC` of accepted requests, counted by
    outcome in `mcim_hedge_requests_total{outcome}` over the CLOSED
    `HEDGE_OUTCOMES` vocabulary — tail-latency robustness that is
    *also* bounded.

Both vocabularies follow the systolic-fallback discipline
(graph/systolic.py): the `count_*` functions are the only increment
sites, callers must pass literal members, and mcim-check
(analysis/rules_obs.py) statically rejects unknown reasons, dynamic
reason expressions, and vocabulary entries nothing uses.

The fabric router (fabric/router.py) reads the retry-budget and hedge
knobs through the ``ENV_*`` names below, the federation front door
(federation/frontdoor.py) ``MCIM_FED_DEADLINE_MS``.
"""

from __future__ import annotations

import threading
import time

# The wire header: REMAINING milliseconds of budget (float text). Each
# hop re-anchors on its own monotonic clock, so skew never corrupts it.
HEADER = "X-MCIM-Deadline-Ms"

ENV_DEADLINE_MS = "MCIM_FED_DEADLINE_MS"
ENV_BUDGET_FRAC = "MCIM_RETRY_BUDGET_FRAC"
ENV_BUDGET_RESERVE = "MCIM_RETRY_BUDGET_RESERVE"
ENV_HEDGE_DELAY_FRAC = "MCIM_HEDGE_DELAY_FRAC"
ENV_HEDGE_MAX_FRAC = "MCIM_HEDGE_MAX_FRAC"

# The CLOSED vocabulary of places a deadline can be found already dead.
# Every 504-answered-locally increments mcim_deadline_expired_total with
# exactly one of these via count_expired — mcim-check rejects unknown
# tiers, dynamic tier expressions, and tiers nothing uses.
#
#   door       federation front door, before/between pod forwards
#   router     pod fabric router, before/between replica forwards
#   replica    serve/server.py HTTP edge, on arrival (chain lane)
#   scheduler  serve/scheduler.py queue-pop expiry (the original link)
#   graph      graph/service.py, before an admitted DAG dispatch
TIERS = (
    "door",
    "router",
    "replica",
    "scheduler",
    "graph",
)

# The CLOSED vocabulary of hedge outcomes (mcim_hedge_requests_total):
#
#   won                the secondary answered first — the hedge paid off
#   lost               the primary answered first; the hedge was burned
#   suppressed_cap     a hedge was due but MCIM_HEDGE_MAX_FRAC denied it
#   suppressed_budget  a hedge was due but the retry budget denied it
HEDGE_OUTCOMES = (
    "won",
    "lost",
    "suppressed_cap",
    "suppressed_budget",
)


class DeadlineExpired(RuntimeError):
    """Raised by deadline-aware dispatch paths (graph/service.py) when
    the request's budget is exhausted before the work would start; HTTP
    edges map it to 504 `deadline_expired`."""


class Deadline:
    """One request's remaining time budget, anchored on the local
    monotonic clock. Constructed once per process from the incoming
    header (or the edge default) and consulted before every forward,
    reroute and dispatch on this hop."""

    __slots__ = ("_expiry", "_clock")

    def __init__(self, budget_ms: float, *, clock=time.monotonic):
        self._clock = clock
        self._expiry = clock() + budget_ms / 1e3

    def remaining_ms(self) -> float:
        return (self._expiry - self._clock()) * 1e3

    def expired(self, *, slack_ms: float = 0.0) -> bool:
        return self.remaining_ms() <= slack_ms

    def header_value(self) -> str:
        """The on-wire remainder for the NEXT hop, floored at 0 so a
        just-expired budget propagates as dead rather than vanishing."""
        return f"{max(0.0, self.remaining_ms()):.1f}"


def from_headers(headers, *, clock=time.monotonic) -> Deadline | None:
    """Parse `X-MCIM-Deadline-Ms` from an HTTP header mapping. Absent or
    malformed -> None (a garbled budget must degrade to "no deadline",
    never to a 500 or an accidental instant expiry)."""
    raw = headers.get(HEADER)
    if raw is None:
        return None
    try:
        budget_ms = float(raw)
    except (TypeError, ValueError):
        return None
    return Deadline(budget_ms, clock=clock)


def expired_response_body() -> dict:
    """The canonical 504 body every tier answers locally."""
    return {
        "status": "deadline_expired",
        "error": "deadline exhausted before useful work could start",
    }


def count_expired(counter, tier: str) -> None:
    """The single choke point for per-tier deadline-expiry accounting:
    an unknown tier is a bug in THIS tree, not a metric label. Also
    files the flight-recorder note the post-mortem timeline needs next
    to breaker/failpoint entries."""
    if tier not in TIERS:
        raise ValueError(
            f"unknown deadline tier {tier!r} (known: {TIERS})"
        )
    counter.inc(tier=tier)
    from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder

    recorder.note("deadline_expired", tier=tier)


def count_budget_denied(counter, tier: str) -> None:
    """The single choke point for retry-budget give-up accounting —
    same closed TIERS vocabulary as count_expired (only the door and
    router hold budgets today, but the label space is shared)."""
    if tier not in TIERS:
        raise ValueError(
            f"unknown deadline tier {tier!r} (known: {TIERS})"
        )
    counter.inc(tier=tier)


def count_hedge(counter, outcome: str) -> None:
    """The single choke point for hedge accounting — the closed
    HEDGE_OUTCOMES vocabulary, enforced like count_expired."""
    if outcome not in HEDGE_OUTCOMES:
        raise ValueError(
            f"unknown hedge outcome {outcome!r} (known: {HEDGE_OUTCOMES})"
        )
    counter.inc(outcome=outcome)


def expired_counter(registry):
    """Register (or fetch) this process's per-tier expiry counter."""
    return registry.counter(
        "mcim_deadline_expired_total",
        "Requests answered 504 deadline_expired locally instead of "
        "doing doomed work, by tier (deadline.TIERS — a closed "
        "vocabulary enforced at the count_expired choke point).",
        labels=("tier",),
    )


def budget_denied_counter(registry):
    """Register the retry-budget give-up counter: a retry/reroute this
    tier WANTED but the token bucket refused (the amplification bound
    doing its job, not a failure)."""
    return registry.counter(
        "mcim_deadline_budget_denied_total",
        "Retries/reroutes denied by the retry budget, by tier "
        "(deadline.TIERS). Each denial is a request that gave up with "
        "its best answer so far instead of amplifying a brownout.",
        labels=("tier",),
    )


def hedge_counter(registry):
    return registry.counter(
        "mcim_hedge_requests_total",
        "Hedged-forward decisions by outcome (deadline.HEDGE_OUTCOMES "
        "— a closed vocabulary enforced at the count_hedge choke "
        "point).",
        labels=("outcome",),
    )


def hedge_delay_s(p99_s: float | None, frac: float) -> float | None:
    """The hedge trigger delay: `frac` of the observed federated p99.
    None (no data yet, or hedging disabled) means DON'T hedge — a cold
    router must not hedge on a guess."""
    if p99_s is None or p99_s <= 0.0 or frac <= 0.0:
        return None
    return p99_s * frac


class RetryBudget:
    """A token-bucket retry budget (deposit per accepted request,
    withdraw per retry/reroute/hedge).

    Thread-safe. Exact invariant, asserted by the chaos harness:

        withdrawals <= frac * deposits + reserve

    so total forward attempts at a tier are bounded by
    `(1 + frac) * accepted + reserve` — asymptotically 1 + frac. The
    `reserve` floor exists for cold-start failover: the first seconds
    after a replica death must be able to reroute before any deposits
    have banked (the breaker board trips within ~2 failures, so the
    reserve only ever covers that handful of probes)."""

    def __init__(self, frac: float = 0.1, reserve: float = 8.0):
        self.frac = float(frac)
        self.reserve = float(reserve)
        self._lock = threading.Lock()
        self._balance = self.reserve
        self._deposits = 0
        self._withdrawn = 0
        self._denied = 0

    def deposit(self) -> None:
        """One accepted request banks `frac` tokens."""
        with self._lock:
            self._deposits += 1
            self._balance += self.frac

    def try_withdraw(self) -> bool:
        """Spend one token for a retry/reroute/hedge; False = give up
        with the best answer so far (the caller books the closed-reason
        give-up, never silently)."""
        with self._lock:
            if self._balance >= 1.0:
                self._balance -= 1.0
                self._withdrawn += 1
                return True
            self._denied += 1
            return False

    @property
    def deposits(self) -> int:
        with self._lock:
            return self._deposits

    def stats(self) -> dict:
        with self._lock:
            return {
                "frac": self.frac,
                "reserve": self.reserve,
                "balance": self._balance,
                "deposits": self._deposits,
                "withdrawn": self._withdrawn,
                "denied": self._denied,
            }
