"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and drives the entry by the loop the mix names,
found by its name as ``loops/<kind>.py``.

A loop module has one function,

    drive(fn, pool, *, wait, reservoir, mix, seconds=None, calls=None, first=0)
        -> (start, [(t_call, t_return, t_done), ...], next pool index)

that calls `fn` on inputs of `pool` (indexable, ``len`` items, taken in
order round the pool from `first`) until `seconds` have passed (the call
that passes the mark is the last) or `calls` calls are done. `wait()`
blocks until the work enqueued so far is done on every card. Times are
``time.perf_counter`` seconds: a call's start, its return (the host's
enqueue) and the moment its result was ready. Each output is offered to
`reservoir` with its pool index; nothing else is kept.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import random

HERE = os.path.dirname(os.path.abspath(__file__))
LOOP_DIR = os.path.join(HERE, "loops")


class Reservoir:
    """A uniform sample of `k` calls' outputs over however many calls come
    (Vitter's algorithm R), its draws from the run's seed. Holding a
    reference is all it costs the card: no copy is made."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: list[tuple[int, int, object]] = []  # (call, pool index, output)

    def offer(self, pool_index: int, out) -> None:
        if len(self.items) < self.k:
            self.items.append((self.seen, pool_index, out))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = (self.seen, pool_index, out)
        self.seen += 1


def loop_kinds() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(LOOP_DIR) if f.endswith(".py"))


def load_loop(kind: str):
    path = os.path.join(LOOP_DIR, f"{kind}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no loop kind {kind!r} (expected {path})")
    spec = importlib.util.spec_from_file_location(f"bench_loop_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mix: dict):
    """The mix's loop, its parameters bound: ``drive(fn, pool, *, wait,
    reservoir, seconds=None, calls=None, first=0)``."""
    return functools.partial(load_loop(mix["loop"]).drive, mix=mix)
