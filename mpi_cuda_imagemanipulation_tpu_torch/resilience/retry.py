"""Bounded retry with exponential backoff and deterministic jitter. The
counterpart of the JAX package's ``resilience/retry.py``.

The JAX package wraps its scheduler dispatch and compile-cache warmup in
it; the port's serving layer will. Policy and clock are injected so
tests run with a fake sleep and a fixed seed — the delay sequence for a
given (policy, seed) is deterministic.

Jitter exists because synchronized retries from many callers re-spike the
very resource that just failed (thundering herd); full determinism under a
seed exists because the tests must be able to assert the exact schedule.
"""

from __future__ import annotations

import dataclasses
import random
import time


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """`max_attempts` counts the first try: 3 means 1 try + 2 retries."""

    max_attempts: int = 3
    base_delay_s: float = 0.005
    multiplier: float = 2.0
    max_delay_s: float = 0.25
    jitter_frac: float = 0.2  # each delay drawn from [d*(1-j), d*(1+j)]

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError(f"jitter_frac must be in [0, 1), got {self.jitter_frac}")

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number `attempt` (1-based)."""
        d = min(
            self.base_delay_s * self.multiplier ** (attempt - 1),
            self.max_delay_s,
        )
        if self.jitter_frac:
            d *= 1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0)
        return d


def call_with_retry(
    fn,
    *,
    policy: RetryPolicy = RetryPolicy(),
    retryable: tuple[type[BaseException], ...] = (Exception,),
    non_retryable: tuple[type[BaseException], ...] = (),
    rng: random.Random | None = None,
    sleep=time.sleep,
    on_retry=None,
):
    """Call `fn()` up to `policy.max_attempts` times.

    Exceptions matching `non_retryable` (checked first) or falling outside
    `retryable` propagate immediately; the last attempt's exception always
    propagates. `on_retry(attempt, exc, delay_s)` fires before each sleep —
    the metrics hook."""
    rng = rng or random.Random()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except non_retryable:
            raise
        except retryable as e:
            if attempt >= policy.max_attempts:
                raise
            delay = policy.delay_s(attempt, rng)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            if delay > 0:
                sleep(delay)
