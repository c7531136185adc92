"""Deterministic failpoint injection at named sites. The counterpart of
the JAX package's ``resilience/failpoints.py``.

A failpoint is a named place in the code (``maybe_fail("io.decode")``)
that normally does nothing. Armed through ``MCIM_FAILPOINTS``, the
``run --failpoints`` flag or `configure` in a test, the site raises
`FailpointError` according to its spec, so that the callers' error paths
can be exercised on the CPU.

Spec grammar (comma-separated ``site=mode`` pairs):

    io.decode=0.1             10% of calls fail (seeded PRNG: a given
                              (seed, site) gives one fail/pass sequence)
    io.decode=once            only the first call fails
    io.decode=first:3         the first 3 calls fail, later ones pass
    plan.fuse=after:5         every call after the 5th fails
    halo.exchange=always      every call fails
    halo.exchange=sleep:40    every call sleeps 40 ms instead of failing

Tests can also `install(site, decider)` a predicate over the call's
keyword context.

Determinism: each armed site owns a ``random.Random(seed ^
crc32(site))`` and a call counter behind one lock, so the Nth call to a
site gets the same decision for a given seed in both packages. Disarmed,
`maybe_fail` is one flag check.

`KNOWN_SITES` is the JAX package's catalog, so that one spec arms both
packages alike. The port calls three of them: ``io.decode``
(io/image.load_image), ``plan.fuse`` (plan/planner.build_plan, fusing
builds only) and ``halo.exchange`` (the entry of ``Pipeline.sharded``'s
function). Each hit is noted in the flight recorder (obs/recorder.py)
before it raises, as the JAX package notes it.
"""

from __future__ import annotations

import random
import threading
import time
import zlib

# the JAX package's catalog of sites; `configure` rejects names outside it
KNOWN_SITES = (
    "io.decode",        # io/image.py: load_image
    "cache.warm",       # serving: per-cell warmup compile
    "serve.dispatch",   # serving: padded executor dispatch
    "halo.exchange",    # models/pipeline.py: sharded pipeline entry
    "batch.interrupt",  # cli batch: per-input loop head
    "engine.complete",  # engine completion stage
    "router.forward",   # fabric router: one proxy attempt to a replica
    "replica.heartbeat",  # fabric: a hit drops that heartbeat
    "stream.tile",      # stream runner: per-tile submission
    "stream.stitch",    # stream runner: seam assembly
    "replica.preempt",  # fabric: a hit is a preemption notice
    "cost.model",       # cost ledger: a deliberate mis-model
    "plan.fuse",        # plan/planner.py build_plan: fusing builds only
                        # ('off' never consults it: the golden per-op
                        # reference stays reachable)
    "graph.dispatch",   # graph service: one admitted graph dispatch
    "pod.heartbeat",    # federation: a hit drops that pod-level beat
    "tune.candidate",   # tune controller: a hit poisons the proposed flip
)

ENV_SPEC = "MCIM_FAILPOINTS"
ENV_SEED = "MCIM_FAILPOINT_SEED"


class FailpointError(RuntimeError):
    """An injected fault."""

    def __init__(self, site: str, n_call: int):
        super().__init__(f"injected failpoint {site!r} (call #{n_call})")
        self.site = site
        self.n_call = n_call


class _Site:
    """One armed site: decider, deterministic PRNG, call counter."""

    def __init__(self, name: str, decider, seed: int, delay_s: float = 0.0):
        self.name = name
        self.decider = decider
        self.rng = random.Random(seed ^ zlib.crc32(name.encode()))
        self.delay_s = delay_s  # sleep:MS latency injection (never raises)
        self.calls = 0
        self.fired = 0


_lock = threading.Lock()
_sites: dict[str, _Site] = {}
_active = False  # lock-free fast-path flag; only flipped under _lock


def _parse_mode(site: str, mode: str):
    """Mode string -> (decider(site_state, ctx) -> bool, delay_s)."""
    mode = mode.strip().lower()
    if mode.startswith("sleep:"):
        ms = float(mode.split(":", 1)[1])
        if ms < 0:
            raise ValueError(f"failpoint {site!r}: negative sleep {ms}ms")
        return (lambda s, ctx: False), ms / 1e3
    return _parse_fail_mode(site, mode), 0.0


def _parse_fail_mode(site: str, mode: str):
    if mode == "always":
        return lambda s, ctx: True
    if mode == "once":
        return lambda s, ctx: s.calls == 1
    if mode.startswith("first:"):
        n = int(mode.split(":", 1)[1])
        return lambda s, ctx: s.calls <= n
    if mode.startswith("after:"):
        n = int(mode.split(":", 1)[1])
        return lambda s, ctx: s.calls > n
    try:
        p = float(mode)
    except ValueError:
        raise ValueError(
            f"failpoint {site!r}: unknown mode {mode!r} (want a probability, "
            "'always', 'once', 'first:N' or 'after:N')"
        ) from None
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"failpoint {site!r}: probability {p} outside [0, 1]")
    return lambda s, ctx: s.rng.random() < p


def configure(spec: str | None, *, seed: int = 0) -> None:
    """Arm failpoints from a spec string; None or empty clears them all."""
    new: dict[str, _Site] = {}
    if spec:
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            site, sep, mode = tok.partition("=")
            site = site.strip()
            if not sep:
                raise ValueError(f"failpoint token {tok!r}: expected site=mode")
            if site not in KNOWN_SITES:
                raise ValueError(f"unknown failpoint site {site!r}; known: {KNOWN_SITES}")
            decider, delay_s = _parse_mode(site, mode)
            new[site] = _Site(site, decider, seed, delay_s=delay_s)
    global _active
    with _lock:
        _sites.clear()
        _sites.update(new)
        _active = bool(_sites)


def configure_from_env(env=None) -> None:
    """Arm from MCIM_FAILPOINTS / MCIM_FAILPOINT_SEED (no-op when unset: an
    armed in-process configuration is left alone)."""
    from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

    spec = env_registry.get(ENV_SPEC, env=env)
    if spec:
        configure(spec, seed=int(env_registry.get(ENV_SEED, env=env) or "0"))


def install(site: str, decider) -> None:
    """Arm one site with a predicate over the call's keyword context,
    ``decider(ctx: dict) -> bool``."""
    if site not in KNOWN_SITES:
        raise ValueError(f"unknown failpoint site {site!r}; known: {KNOWN_SITES}")
    global _active
    with _lock:
        _sites[site] = _Site(site, lambda s, ctx, d=decider: d(ctx), seed=0)
        _active = True


def clear() -> None:
    configure(None)


def is_active() -> bool:
    return _active


def maybe_fail(site: str, **ctx) -> None:
    """The injection point. Disarmed: one flag check. Armed: count the
    call, ask the site's decider, raise FailpointError on a hit (or, for
    ``sleep:MS``, delay the caller outside the lock)."""
    if not _active:
        return
    with _lock:
        s = _sites.get(site)
        if s is None:
            return
        s.calls += 1
        hit = s.decider(s, ctx)
        delay_s = s.delay_s
        if hit:
            s.fired += 1
            n = s.calls
    if delay_s:
        time.sleep(delay_s)
    if hit:
        # an injected fault is what a post-mortem dump needs beside the
        # span and breaker entries
        from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder

        recorder.note("failpoint", site=site, n_call=n)
        raise FailpointError(site, n)


def counts() -> dict[str, dict[str, int]]:
    """Per-site call and fire counters."""
    with _lock:
        return {name: {"calls": s.calls, "fired": s.fired} for name, s in _sites.items()}


# Armed from the environment at import: every module that calls a site
# imports this one first, so MCIM_FAILPOINTS on any entry point works.
configure_from_env()
