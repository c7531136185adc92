"""Runtime lock-order recorder — the dynamic half of the concurrency
gate.

The counterpart of the JAX package's ``analysis/lockcheck.py``: the same
shims, recorder and :class:`recording`. Two things differ, both so that
this recorder nests inside the JAX package's (the repository's test
harness may install that one for a whole session) and unwinds cleanly:
the constructors it restores are the ones in place at the outermost
:func:`install`, not the ones at import time, and the recorder's own
mutexes are raw ``_thread`` locks, which no shim instruments.

The static analyzer (rules_concurrency.py) derives a lock-order graph
from the AST; this module observes the *actual* acquisition orders at
runtime and asserts the combined picture stays acyclic, so the static
model is validated against reality instead of trusted.

Armed (:func:`recording` for one test or one phase of a run;
:func:`enabled` reads ``MCIM_LOCK_CHECK``), it monkeypatches ``threading.Lock``,
``threading.RLock`` and ``threading.Condition`` with thin shims: every
lock object created after install carries its creation site
(``file:line`` plus the ``self._name = threading.Lock()`` attribute when
the source line shows one), each thread keeps a held-stack, and every
acquisition while other locks are held records a ``(held → acquired)``
edge keyed by creation site. ``assert_acyclic()`` DFS-checks the edge
set and raises with the full cycle path on failure.

Design constraints:

  * **No behavior change.** The shim delegates to a real lock;
    ``Condition`` keeps the stdlib implementation and only the lock
    inside it is instrumented (its ``wait()`` releases through the
    shim's ``__getattr__`` passthrough, so the per-thread stack stays
    truthful across waits).
  * **Recorder state is leaf-locked.** The recorder's own mutex is a
    raw ``_thread`` lock acquired only after/before user locks, so
    instrumentation cannot introduce the deadlocks it hunts.
  * **Sites, not objects.** Edges are keyed by creation site so the
    graph is stable across runs and joinable with the static graph's
    ``(file, attr)`` nodes (tests/test_torch_analysis.py merges the two
    and asserts the union is still acyclic).
"""

from __future__ import annotations

import _thread
import linecache
import os
import re
import sys
import threading

ENV_FLAG = "MCIM_LOCK_CHECK"

# the constructors install() replaced, taken at the outermost install();
# None while nothing is installed
_saved: tuple | None = None

_ATTR_RE = re.compile(r"(?:self\.(\w+)|^\s*(\w+))\s*=")


def enabled(env=None) -> bool:
    """True when the session-wide recorder is requested (MCIM_LOCK_CHECK
    set to anything but ''/'0')."""
    from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

    return env_registry.get_bool(ENV_FLAG, env=env)


def _site(depth: int = 2) -> str:
    """Creation-site key for a lock: file:line, refined to file:attr when
    the source line is a `self.X = threading.Lock()`-style assignment
    (joins with the static graph's (file, attr) nodes)."""
    frame = sys._getframe(depth)
    fname = frame.f_code.co_filename
    line = frame.f_lineno
    rel = os.path.basename(os.path.dirname(fname)) + "/" + os.path.basename(
        fname
    )
    text = linecache.getline(fname, line)
    m = _ATTR_RE.search(text)
    if m:
        attr = m.group(1) or m.group(2)
        return f"{rel}:{attr}"
    return f"{rel}:{line}"


class LockRecorder:
    def __init__(self):
        self._mutex = _thread.allocate_lock()
        self._tls = threading.local()
        # (site_held, site_acquired) -> count
        self.edges: dict[tuple[str, str], int] = {}
        self.sites: set[str] = set()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_create(self, site: str) -> None:
        with self._mutex:
            self.sites.add(site)

    def on_acquire(self, site: str) -> None:
        st = self._stack()
        if st:
            held = [s for s, _n in st if s != site]
            if held:
                with self._mutex:
                    for h in held:
                        key = (h, site)
                        self.edges[key] = self.edges.get(key, 0) + 1
        for ent in st:
            if ent[0] == site:
                ent[1] += 1
                return
        st.append([site, 1])

    def on_release(self, site: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == site:
                st[i][1] -= 1
                if st[i][1] == 0:
                    del st[i]
                return

    def snapshot_edges(self) -> dict[tuple[str, str], int]:
        with self._mutex:
            return dict(self.edges)

    def find_cycle(self) -> list[str] | None:
        graph: dict[str, set[str]] = {}
        for a, b in self.snapshot_edges():
            graph.setdefault(a, set()).add(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        path: list[str] = []

        def dfs(n: str) -> list[str] | None:
            color[n] = GRAY
            path.append(n)
            for m in graph.get(n, ()):
                if color.get(m, WHITE) == GRAY:
                    return path[path.index(m):] + [m]
                if color.get(m, WHITE) == WHITE:
                    got = dfs(m)
                    if got:
                        return got
            path.pop()
            color[n] = BLACK
            return None

        for n in list(graph):
            if color.get(n, WHITE) == WHITE:
                got = dfs(n)
                if got:
                    return got
        return None

    def assert_acyclic(self, extra_edges=()) -> None:
        """Raise AssertionError with the cycle path if the observed (plus
        any `extra_edges` from the static graph) order graph has a
        cycle."""
        saved = self.snapshot_edges()
        try:
            with self._mutex:
                for a, b in extra_edges:
                    self.edges.setdefault((a, b), 0)
            cyc = self.find_cycle()
        finally:
            with self._mutex:
                self.edges = saved
        if cyc:
            raise AssertionError(
                "lock-order cycle observed: " + " -> ".join(cyc)
            )


_recorder = LockRecorder()
_install_count = 0
_install_mutex = _thread.allocate_lock()


def recorder() -> LockRecorder:
    return _recorder


class _RecordingLock:
    """Wraps a real Lock/RLock; records ordered acquisitions by creation
    site. Attribute passthrough keeps stdlib Condition integration
    (_is_owned/_release_save/_acquire_restore) working unchanged."""

    def __init__(self, site: str, factory, rec: "LockRecorder" = None):
        self._mcim_inner = factory()
        self._mcim_site = site
        self._mcim_rec = rec if rec is not None else _recorder
        self._mcim_rec.on_create(site)

    def acquire(self, blocking=True, timeout=-1):
        ok = self._mcim_inner.acquire(blocking, timeout)
        if ok:
            self._mcim_rec.on_acquire(self._mcim_site)
        return ok

    def release(self):
        self._mcim_inner.release()
        self._mcim_rec.on_release(self._mcim_site)

    def locked(self):
        return self._mcim_inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._mcim_inner, name)

    def __repr__(self):
        return f"<mcim recording lock {self._mcim_site}>"


def _originals() -> tuple:
    """(Lock, RLock, Condition) as they stand outside this recorder: the
    saved constructors while it is installed, else threading's own (which
    may be another recorder's shims)."""
    saved = _saved
    if saved is not None:
        return saved
    return (threading.Lock, threading.RLock, threading.Condition)


def _make_lock():
    return _RecordingLock(_site(), _originals()[0])


def _make_rlock():
    return _RecordingLock(_site(), _originals()[1])


def _make_condition(lock=None):
    _lock, rlock, condition = _originals()
    if lock is None:
        lock = _RecordingLock(_site(), rlock)
    return condition(lock)


def install() -> LockRecorder:
    """Patch threading lock constructors (refcounted; nestable). The
    constructors in place at the outermost install are kept, and restored
    by the matching uninstall."""
    global _install_count, _saved
    with _install_mutex:
        if _install_count == 0:
            _saved = (threading.Lock, threading.RLock, threading.Condition)
            threading.Lock = _make_lock
            threading.RLock = _make_rlock
            threading.Condition = _make_condition
        _install_count += 1
    return _recorder


def uninstall() -> None:
    global _install_count, _saved
    with _install_mutex:
        if _install_count > 0:
            _install_count -= 1
            if _install_count == 0:
                (threading.Lock, threading.RLock,
                 threading.Condition) = _saved
                _saved = None


class recording:
    """Context manager for one test: install, run, assert the edges
    gathered so far stay acyclic (the whole-session edge set — edges are
    cumulative on purpose: cross-test orders must agree too)."""

    def __enter__(self) -> LockRecorder:
        install()
        return _recorder

    def __exit__(self, exc_type, exc, tb) -> bool:
        uninstall()
        if exc_type is None:
            _recorder.assert_acyclic()
        return False
