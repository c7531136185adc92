"""The port's static-analysis gate (analysis/, tools/mcim_check.py in the
port's package) and its runtime lock-order recorder, on the CPU, held to
the JAX package's analyzer.

Every rule the port keeps is pinned by fixture snippets, as in the JAX
package's tests/test_analysis.py: a bad fragment that must produce the
finding and a good twin that must pass. Each shared fixture is written
twice, once under each package's name in a tree of its own, and the two
analyzers must report the same (rule, line, message) with the package
name normalised. On top of that: the torch forms of a device sync under a
lock, the port's ``mcim-torch:`` marker (which neither gate confuses with
the other's), the port's scope (JAX files in the tree are never read),
the self-check on this checkout, and the recorder's mechanics, nested
inside the JAX package's recorder as the repository's test harness may
install it.

Pragmas are spelled through ``@PRAGMA@`` and every ``MCIM_*`` name stays
inside a fixture's source text, so that neither gate reads this file's
own lines as a waiver or an unregistered variable.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from mpi_cuda_imagemanipulation_tpu.analysis import core as jax_core
from mpi_cuda_imagemanipulation_tpu.analysis import lockcheck as jax_lockcheck
from mpi_cuda_imagemanipulation_tpu_torch.analysis import core, lockcheck
from mpi_cuda_imagemanipulation_tpu_torch.analysis.rules_concurrency import lock_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = core.PACKAGE
JAX_PKG = jax_core.PACKAGE
MARKERS = {PKG: "mcim-torch:", JAX_PKG: "mcim:"}
# the JAX rules the port leaves out (ROADMAP "Not ported, by design")
NOT_PORTED = {
    "tracer-host-cast", "tracer-host-np", "tracer-control-flow", "tracer-recompile-closure",
}
# deliberate wording differences of a finding's message (the port names
# its own cost-layer entry points)
MESSAGE_SWAPS = (("attribute_jit/wrap_cache_fn", "wrap_cache_fn/LazyAttributedFn"),)


def write_tree(root, files: dict[str, str], pkg: str) -> None:
    """`files` under `root`, with {PKG} spelled as `pkg` and @PRAGMA@ as
    that package's suppression marker."""
    for rel, src in files.items():
        p = root / rel.replace("{PKG}", pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        text = textwrap.dedent(src).replace("{PKG}", pkg).replace("@PRAGMA@", MARKERS[pkg])
        p.write_text(text)


def run_on(tmp_path, files: dict[str, str], families=None):
    write_tree(tmp_path, files, PKG)
    findings, _repo = core.run(str(tmp_path), families=families)
    return findings


def rules_of(findings) -> set[str]:
    return {f.rule for f in findings}


# --------------------------------------------------------------------------
# fixtures shared with the JAX package's analyzer
# --------------------------------------------------------------------------

_CYCLE = """
import threading

class C:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()

    def one(self):
        with self.a:
            with self.b:
                pass

    def two(self):
        with self.b:
            with self.a:
                pass
"""

_DRIFT = """
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        self.n += 1

    def read(self):
        with self._lock:
            return self.n
"""

_MINI_ENV = """
from dataclasses import dataclass


@dataclass(frozen=True)
class EnvVar:
    name: str
    default: object
    consumer: str
    doc: str


_VARS = (
    EnvVar("MCIM_GOOD", None, "m.py", "documented knob"),
    EnvVar("MCIM_ORPHAN", None, "nobody", "never read"),
)
REGISTRY = {v.name: v for v in _VARS}
"""


def _vocab_fixture(anchor: str, var: str, func: str, members=("a", "b"), argpos=1) -> dict:
    """A closed vocabulary `var` in `anchor` with members a (used), b
    (never used); a caller file with a used, an unknown and a computed
    member passed to `func` at argument `argpos`."""
    args = lambda m: ", ".join(["c"] * argpos + [m])  # noqa: E731
    return {
        "{PKG}/" + anchor: f"""
        {var} = {tuple(members)!r}

        def {func}(c, m):
            pass
        """,
        "{PKG}/user.py": f"""
        def work(c, m):
            {func}({args('"a"')})
            {func}({args('"typo"')})
            {func}({args('m')})
        """,
    }


FIXTURES = {
    # -- concurrency --------------------------------------------------------
    "lock-order-cycle": ({"{PKG}/m.py": _CYCLE}, {"concurrency"}),
    "lock-order-consistent": ({"{PKG}/m.py": _CYCLE.replace(
        "with self.b:\n            with self.a:", "with self.a:\n            with self.b:"
    )}, {"concurrency"}),
    "blocking-only-under-lock": ({"{PKG}/m.py": """
        import threading
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def bad(self):
                with self._lock:
                    time.sleep(1)

            def good(self):
                time.sleep(1)
                with self._lock:
                    pass
        """}, {"concurrency"}),
    "blocking-interprocedural": ({"{PKG}/m.py": """
        import threading
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def api(self):
                with self._lock:
                    self._helper()

            def _helper(self):
                time.sleep(0.5)
        """}, {"concurrency"}),
    "condition-wait-exempt": ({"{PKG}/m.py": """
        import threading

        class C:
            def __init__(self):
                self._cond = threading.Condition()

            def waiter(self):
                with self._cond:
                    self._cond.wait()
        """}, {"concurrency"}),
    "guard-drift": ({"{PKG}/m.py": _DRIFT}, {"concurrency"}),
    "guard-locked-writer": ({"{PKG}/m.py": _DRIFT.replace(
        "    def bump(self):\n        self.n += 1",
        "    def bump(self):\n        with self._lock:\n            self.n += 1",
    )}, {"concurrency"}),
    "private-inherits-lock": ({"{PKG}/m.py": """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def api(self):
                with self._lock:
                    self._bump()

            def _bump(self):
                self.n += 1

            def read(self):
                with self._lock:
                    return self.n
        """}, {"concurrency"}),
    # -- tracer: use after donation ------------------------------------------
    "donate-read-after": ({"{PKG}/m.py": """
        def run(pipe, buf):
            fn = pipe.jit(donate=True)
            out = fn(buf)
            return out + buf.mean()
        """}, {"tracer"}),
    "donate-loop-fresh": ({"{PKG}/m.py": """
        def run(pipe, bufs):
            fn = pipe.jit(donate=True)
            outs = []
            for buf in bufs:
                outs.append(fn(buf))
            return outs
        """}, {"tracer"}),
    # -- obs ------------------------------------------------------------------
    "span-leak": ({"{PKG}/m.py": """
        from {PKG}.obs import trace as obs_trace

        def bad():
            s = obs_trace.span("x")
            return 1

        def dropped():
            obs_trace.span("y")
        """}, {"obs"}),
    "span-closed-or-handed-off": ({"{PKG}/m.py": """
        from {PKG}.obs import trace as obs_trace

        def with_block():
            with obs_trace.span("x"):
                return 1

        def ended(flag):
            s = obs_trace.span("x")
            if flag:
                s.end()
                return 0
            s.end()
            return 1

        def handoff(req):
            req.trace = obs_trace.start_trace("x")
            return req
        """}, {"obs"}),
    "metric-names-and-kinds": ({
        "{PKG}/m.py": """
        def reg(r):
            r.counter("mcim_serve_foo", "no _total suffix")
            r.histogram("mcim_serve_lat", "no _seconds suffix")
            r.gauge("mcim_bogus_thing", "unknown subsystem")
            r.counter("mcim_engine_ok_total", "fine")
            r.histogram("mcim_engine_t_seconds", "fine")
        """,
        "{PKG}/n.py": """
        def reg2(r):
            r.counter("mcim_serve_both_total", "kind A")

        def reg3(r):
            r.gauge("mcim_serve_both_total", "kind B")
        """,
    }, {"obs"}),
    "failpoint-registry": ({
        "{PKG}/resilience/failpoints.py": """
        KNOWN_SITES = (
            "a.used",
            "b.dead",
        )

        def maybe_fail(site, **ctx):
            pass
        """,
        "{PKG}/m.py": """
        from {PKG}.resilience.failpoints import maybe_fail

        def work():
            maybe_fail("a.used")
            maybe_fail("z.typo")
        """,
    }, {"obs"}),
    "cost-attribution-missing": ({
        "{PKG}/serve/somecache.py": """
        class Cache:
            def __init__(self):
                self._fns = {}

            def get(self, key, build):
                fn = build(key)
                self._fns[key] = fn
                return fn
        """,
        "{PKG}/graph/someservice.py": """
        def dispatch(st, pid, fn):
            st.cache_put(pid, fn)
        """,
    }, {"obs"}),
    "cost-attribution-present": ({
        "{PKG}/serve/somecache.py": """
        from {PKG}.obs import cost as obs_cost

        class Cache:
            def __init__(self):
                self._fns = {}

            def get(self, key, build):
                fn = obs_cost.wrap_cache_fn("serve", key, build(key))
                self._fns[key] = fn
                return fn
        """,
        "{PKG}/graph/someservice.py": """
        def dispatch(st, pid, build):
            from {PKG}.obs import cost as obs_cost

            fn = obs_cost.wrap_cache_fn("graph", pid, build())
            st.cache_put(pid, fn)
        """,
    }, {"obs"}),
    "exemplar-missing": ({"{PKG}/serve/lat.py": """
        class M:
            def __init__(self, r):
                self.lat = r.histogram("mcim_serve_lat_seconds", "latency")
                self.ok = r.histogram("mcim_serve_ok_seconds", "latency")

            def on_done(self, s, tid):
                self.lat.observe(s)
                self.ok.observe(s, exemplar=tid)
        """}, {"obs"}),
    "recorder-triggers": ({
        "{PKG}/obs/recorder.py": """
        KNOWN_TRIGGERS = ("breaker_open", "never_dumped")

        def dump(trigger):
            pass
        """,
        "{PKG}/serve/x.py": """
        from {PKG}.obs import recorder

        def fail(t):
            recorder.dump("breaker_open")
            recorder.dump("typo_trigger")
            recorder.dump(t)
        """,
    }, {"obs"}),
    "systolic-fallbacks": (_vocab_fixture("graph/systolic.py", "FALLBACK_REASONS",
                                          "count_fallback"), {"obs"}),
    "mxu-stage-fallbacks": (_vocab_fixture("ops/mxu_kernels.py", "STAGE_FALLBACK_REASONS",
                                           "count_stage_fallback"), {"obs"}),
    "fed-reroutes": (_vocab_fixture("federation/frontdoor.py", "REROUTE_REASONS",
                                    "count_reroute"), {"obs"}),
    "tune-decisions": (_vocab_fixture("tune/controller.py", "DECISIONS", "count_decision"),
                       {"obs"}),
    "deadline-tiers": (_vocab_fixture("resilience/deadline.py", "TIERS", "count_expired"),
                       {"obs"}),
    "hedge-outcomes": (_vocab_fixture("resilience/deadline.py", "HEDGE_OUTCOMES",
                                      "count_hedge"), {"obs"}),
    "graph-taxonomy": ({
        "{PKG}/graph/spec.py": """
        TAXONOMY = {"bad-json": "x", "never-raised": "y"}
        class SpecError(ValueError):
            def __init__(self, code, message):
                super().__init__(message)
                self.code = code
        """,
        "{PKG}/graph/other.py": """
        from {PKG}.graph.spec import SpecError
        def a():
            raise SpecError("bad-json", "fine")
        def b():
            raise SpecError("not-registered", "unknown code")
        def c(code):
            raise SpecError(code, "dynamic code")
        """,
    }, {"obs"}),
    # -- surface --------------------------------------------------------------
    "env-drift": ({
        "{PKG}/utils/env.py": _MINI_ENV,
        "{PKG}/m.py": """
        import os

        def read():
            direct = os.environ.get("MCIM_GOOD")   # must use registry
            typo = os.environ.get("MCIM_TYPO")     # unregistered
            return direct, typo
        """,
        "README.md": "Only MCIM_GOOD is documented here.\n",
    }, {"surface"}),
    "cli-flags": ({
        "{PKG}/utils/env.py": _MINI_ENV,
        "{PKG}/cli.py": """
        import argparse

        def build(p: argparse.ArgumentParser):
            p.add_argument("--documented")
            p.add_argument("--mystery")
            p.add_argument("--window", help=argparse.SUPPRESS)
        """,
        "README.md": "Use `--documented` and MCIM_GOOD.\n",
    }, {"surface"}),
    # -- core ------------------------------------------------------------------
    "parse-error": ({"{PKG}/broken.py": "def f(:\n    pass\n"}, {"concurrency"}),
    # -- suppressions ---------------------------------------------------------
    "suppression-waives-and-stale-flags": ({"{PKG}/m.py": """
        import threading
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    time.sleep(1)  # @PRAGMA@ allow(lock-blocking-call: fixture)

        # @PRAGMA@ allow(lock-guard-drift: suppresses nothing)
        UNRELATED = 1
        """}, {"concurrency"}),
    "suppression-line-above-and-unknown": ({"{PKG}/m.py": """
        import threading
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    # @PRAGMA@ allow(lock-blocking-call: fixture, line above)
                    time.sleep(1)

        # @PRAGMA@ allow(no-such-rule: typo)
        UNRELATED = 1
        """}, {"concurrency"}),
}

# what each fixture must report (a subset of rules; the differential test
# checks every finding against the JAX analyzer's)
EXPECTED = {
    "lock-order-cycle": {"lock-order-cycle"},
    "lock-order-consistent": set(),
    "blocking-only-under-lock": {"lock-blocking-call"},
    "blocking-interprocedural": {"lock-blocking-call"},
    "condition-wait-exempt": set(),
    "guard-drift": {"lock-guard-drift"},
    "guard-locked-writer": set(),
    "private-inherits-lock": set(),
    "donate-read-after": {"tracer-use-after-donate"},
    "donate-loop-fresh": set(),
    "span-leak": {"obs-span-leak"},
    "span-closed-or-handed-off": set(),
    "metric-names-and-kinds": {"obs-metric-name", "obs-metric-kind-drift"},
    "failpoint-registry": {"obs-failpoint-unknown", "obs-failpoint-unused"},
    "cost-attribution-missing": {"obs-cost-attribution-missing"},
    "cost-attribution-present": set(),
    "exemplar-missing": {"obs-exemplar-missing"},
    "recorder-triggers": {"obs-recorder-trigger-unknown", "obs-recorder-trigger-unused",
                          "obs-recorder-trigger-dynamic"},
    "systolic-fallbacks": {"obs-systolic-fallback-unknown", "obs-systolic-fallback-unused",
                           "obs-systolic-fallback-dynamic"},
    "mxu-stage-fallbacks": {"obs-mxu-stage-fallback-unknown",
                            "obs-mxu-stage-fallback-unused",
                            "obs-mxu-stage-fallback-dynamic"},
    "fed-reroutes": {"obs-fed-reroute-unknown", "obs-fed-reroute-unused",
                     "obs-fed-reroute-dynamic"},
    "tune-decisions": {"obs-tune-decision-unknown", "obs-tune-decision-unused",
                       "obs-tune-decision-dynamic"},
    "deadline-tiers": {"obs-deadline-tier-unknown", "obs-deadline-tier-unused",
                       "obs-deadline-tier-dynamic"},
    "hedge-outcomes": {"obs-hedge-outcome-unknown", "obs-hedge-outcome-unused",
                       "obs-hedge-outcome-dynamic"},
    "graph-taxonomy": {"graph-taxonomy-unknown", "graph-taxonomy-dynamic",
                       "graph-taxonomy-unused"},
    "env-drift": {"env-direct-read", "env-unregistered", "env-undocumented", "env-unused"},
    "cli-flags": {"surface-flag-undocumented", "env-undocumented", "env-unused"},
    "parse-error": {"parse-error"},
    "suppression-waives-and-stale-flags": {"unused-suppression"},
    "suppression-line-above-and-unknown": {"unknown-suppression"},
}


def _normalised(findings, pkg: str) -> list[tuple]:
    out = []
    for f in findings:
        msg = f.message.replace(pkg, "<PKG>")
        for jax_words, port_words in MESSAGE_SWAPS:
            msg = msg.replace(jax_words, port_words)
        out.append((f.rule, f.file.replace(pkg, "<PKG>"), f.line, msg, f.severity))
    return out


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_findings_equal_the_jax_analyzer_s(tmp_path, name):
    files, families = FIXTURES[name]
    write_tree(tmp_path / "jax", files, JAX_PKG)
    write_tree(tmp_path / "port", files, PKG)
    want, _ = jax_core.run(str(tmp_path / "jax"), families=set(families))
    got, _ = core.run(str(tmp_path / "port"), families=set(families))
    assert _normalised(got, PKG) == _normalised(want, JAX_PKG)
    assert rules_of(got) == EXPECTED[name], [(f.rule, f.line, f.message) for f in got]


def test_every_fixture_has_its_expectation_and_every_kept_rule_fires():
    assert set(FIXTURES) == set(EXPECTED)
    fired = set().union(*EXPECTED.values())
    assert fired == set(core.RULES)


def test_shapes_of_the_shared_fixtures(tmp_path):
    """The counts the JAX package's tests pin, on the port's analyzer."""
    fs = run_on(tmp_path / "a", FIXTURES["blocking-only-under-lock"][0], {"concurrency"})
    hits = [f for f in fs if f.rule == "lock-blocking-call"]
    assert len(hits) == 1 and "sleep" in hits[0].message
    fs = run_on(tmp_path / "b", FIXTURES["blocking-interprocedural"][0], {"concurrency"})
    assert any("_helper" in f.message for f in fs if f.rule == "lock-blocking-call")
    fs = run_on(tmp_path / "c", FIXTURES["metric-names-and-kinds"][0], {"obs"})
    assert len([f for f in fs if f.rule == "obs-metric-name"]) == 4
    fs = run_on(tmp_path / "d", FIXTURES["failpoint-registry"][0], {"obs"})
    unused = [f for f in fs if f.rule == "obs-failpoint-unused"]
    assert len(unused) == 1 and "b.dead" in unused[0].message
    fs = run_on(tmp_path / "e", FIXTURES["cost-attribution-missing"][0], {"obs"})
    assert {f.file for f in fs if f.rule == "obs-cost-attribution-missing"} == {
        f"{PKG}/serve/somecache.py", f"{PKG}/graph/someservice.py"}
    fs = run_on(tmp_path / "f", FIXTURES["env-drift"][0], {"surface"})
    undoc = [f.message for f in fs if f.rule == "env-undocumented"]
    assert any("ORPHAN" in m for m in undoc) and not any("GOOD" in m for m in undoc)
    fs = run_on(tmp_path / "g", FIXTURES["cli-flags"][0], {"surface"})
    flags = [f for f in fs if f.rule == "surface-flag-undocumented"]
    assert len(flags) == 1 and "--mystery" in flags[0].message
    fs = run_on(tmp_path / "h", FIXTURES["suppression-waives-and-stale-flags"][0],
                {"concurrency"})
    assert rules_of(fs) == {"unused-suppression"}  # the sleep's finding is waived


# --------------------------------------------------------------------------
# what only the port has: torch syncs, its marker, its scope
# --------------------------------------------------------------------------

_SYNC_UNDER_LOCK = """
import threading

import torch

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def bad(self, t, ev):
        with self._lock:
            CALL

    def good(self, t, ev):
        CALL
        with self._lock:
            pass
"""


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()", "ev.synchronize()", "torch.cuda.current_stream().synchronize()",
    "t.cpu()", "t.item()", "t.tolist()",
])
def test_torch_device_sync_under_a_lock_fires_only_there(tmp_path, call):
    fs = run_on(tmp_path, {"{PKG}/m.py": _SYNC_UNDER_LOCK.replace("CALL", call)},
                {"concurrency"})
    hits = [f for f in fs if f.rule == "lock-blocking-call"]
    assert [f.line for f in hits] == [12], [(f.line, f.message) for f in fs]
    # the JAX analyzer's blocking set has no torch sync
    write_tree(tmp_path / "jax", {"{PKG}/m.py": _SYNC_UNDER_LOCK.replace("CALL", call)},
               JAX_PKG)
    assert jax_core.run(str(tmp_path / "jax"), families={"concurrency"})[0] == []


def test_torch_sync_reached_through_a_helper(tmp_path):
    fs = run_on(tmp_path, {"{PKG}/m.py": """
        import threading

        import torch

        def drain(dev):
            torch.cuda.synchronize(dev)

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def api(self, dev):
                with self._lock:
                    drain(dev)
        """}, {"concurrency"})
    msgs = [f.message for f in fs if f.rule == "lock-blocking-call"]
    assert len(msgs) == 1 and "call drain() may block (.synchronize())" in msgs[0]


def test_markers_of_the_two_gates_do_not_cross(tmp_path):
    """The port reads `mcim-torch:` and not `mcim:`; the JAX gate reads
    `mcim:` and not `mcim-torch:`, so a port waiver is no stale JAX
    suppression."""
    src = """
        import threading
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    time.sleep(1)  # @PRAGMA@ allow(lock-blocking-call: fixture)
        """
    # the port's marker waives in the port's tree
    assert run_on(tmp_path / "own", {"{PKG}/m.py": src}, {"concurrency"}) == []
    # a JAX-spelled waiver is not read by the port ...
    write_tree(tmp_path / "jaxmark", {"{PKG}/m.py": src}, JAX_PKG)
    moved = tmp_path / "jaxmark" / JAX_PKG
    moved.rename(tmp_path / "jaxmark" / PKG)
    fs, _ = core.run(str(tmp_path / "jaxmark"), families={"concurrency"})
    assert rules_of(fs) == {"lock-blocking-call"}
    # ... and the JAX gate reads nothing in a port waiver (no stale suppression)
    fs, _ = jax_core.run(str(tmp_path / "own"), families={"concurrency"})
    assert fs == []


def test_scope_is_the_port_s_own_files(tmp_path):
    bad = """
        import threading
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    time.sleep(1)
        """
    files = {
        f"{JAX_PKG}/m.py": bad, "tools/t.py": bad, "tests/test_other.py": bad,
        "bench.py": bad, "build/x.py": bad, "chiprun_out/y.py": bad,
        "tests/test_torch_x.py": "X = 1\n", "tests/_torch_helper.py": "Y = 2\n",
        "chip_smoke.py": "Z = 3\n", "{PKG}/ok.py": "W = 4\n",
    }
    write_tree(tmp_path, files, PKG)
    fs, repo = core.run(str(tmp_path), families={"concurrency"})
    assert fs == []
    assert sorted(f.rel for f in repo.files) == [
        "chip_smoke.py", f"{PKG}/ok.py", "tests/_torch_helper.py", "tests/test_torch_x.py"]
    # a fixture tree walked whole
    whole = core.Repo(str(tmp_path), include=None)
    assert len(whole.files) == len(files)


def test_package_tools_meet_the_rules_of_jax_root_tools(tmp_path):
    """The package's tools/ is the JAX package's root tools/: an
    os.environ read is allowed there, its spans are checked, and its
    metrics are not package metrics."""
    tool = """
        import os

        from {PKG}.obs import trace as obs_trace

        def main(r):
            saved = os.environ.get("MCIM_GOOD")
            s = obs_trace.span("tool")
            r.counter("not_mcim", "x")
            r.gauge("mcim_bogus_thing", "not a package metric")
            return saved
        """
    files = {"{PKG}/utils/env.py": _MINI_ENV, "README.md": "MCIM_GOOD MCIM_ORPHAN\n"}
    fs = run_on(tmp_path / "port", {**files, "{PKG}/tools/t.py": tool})
    write_tree(tmp_path / "jax", {**files, "tools/t.py": tool}, JAX_PKG)
    want, _ = jax_core.run(str(tmp_path / "jax"), families={"obs", "surface"})
    got = [f for f in fs if f.rule != "env-unused"]
    assert [(f.rule, f.line) for f in got] == [(f.rule, f.line) for f in want
                                               if f.rule != "env-unused"]
    assert rules_of(got) == {"obs-span-leak"}


# --------------------------------------------------------------------------
# the catalog and the self-check
# --------------------------------------------------------------------------


def test_rule_catalog_is_the_jax_one_without_the_tracing_rules(capsys):
    from mpi_cuda_imagemanipulation_tpu.analysis import (  # noqa: F401
        rules_concurrency,
        rules_obs,
        rules_surface,
        rules_tracer,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.tools import mcim_check

    assert mcim_check.main(["--list-rules"]) == 0
    listed = {line.split()[1] for line in capsys.readouterr().out.splitlines()}
    assert listed == set(jax_core.RULES) - NOT_PORTED
    for rid in listed:
        assert core.RULES[rid].family == jax_core.RULES[rid].family
        assert core.RULES[rid].severity == jax_core.RULES[rid].severity


@pytest.fixture(scope="module")
def self_check(tmp_path_factory):
    """The gate on this checkout, once: the module run as `python -m
    ...tools.mcim_check --format json` does, in a fresh interpreter that
    must not import JAX."""
    out = tmp_path_factory.mktemp("gate") / "report.json"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['mcim_check', '--format', 'json', '--out', {str(out)!r}]\n"
        "try:\n"
        "    runpy.run_module('mpi_cuda_imagemanipulation_tpu_torch.tools.mcim_check',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'mpi_cuda_imagemanipulation_tpu')\n"
        "print('IMPORTED', bad, file=sys.stderr)\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    return proc, json.loads(out.read_text())


def test_mcim_check_exits_zero_on_repo_tree(self_check):
    proc, report = self_check
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert report["counts"] == {"errors": 0, "total": 0}
    assert "IMPORTED []" in proc.stderr, proc.stderr[-2000:]


def test_self_check_reads_only_the_port_s_files(self_check):
    _proc, report = self_check
    n_port = sum(
        1 for d, _, fs in os.walk(os.path.join(ROOT, PKG)) if "__pycache__" not in d
        for f in fs if f.endswith(".py")
    )
    n_tests = sum(1 for f in os.listdir(os.path.join(ROOT, "tests"))
                  if f.endswith(".py") and f.startswith(("test_torch_", "_torch_")))
    assert report["files_analyzed"] == n_port + n_tests + 1  # + chip_smoke.py


# --------------------------------------------------------------------------
# runtime lock-order recorder (analysis/lockcheck.py)
# --------------------------------------------------------------------------


def test_lockcheck_records_edges_and_detects_cycle():
    rec = lockcheck.LockRecorder()
    a = lockcheck._RecordingLock("m.py:a", threading.Lock, rec)
    b = lockcheck._RecordingLock("m.py:b", threading.Lock, rec)
    with a:
        with b:
            pass
    assert rec.snapshot_edges() == {("m.py:a", "m.py:b"): 1}
    rec.assert_acyclic()  # consistent order: fine
    with b:
        with a:
            pass
    with pytest.raises(AssertionError, match="lock-order cycle"):
        rec.assert_acyclic()


def test_lockcheck_same_site_reentrance_no_self_edge():
    rec = lockcheck.LockRecorder()
    a1 = lockcheck._RecordingLock("m.py:_lock", threading.Lock, rec)
    a2 = lockcheck._RecordingLock("m.py:_lock", threading.Lock, rec)
    with a1:
        with a2:  # same creation site: no self-edge, no false cycle
            pass
    assert rec.snapshot_edges() == {}
    rec.assert_acyclic()


def test_lockcheck_extra_edges_merge():
    rec = lockcheck.LockRecorder()
    a = lockcheck._RecordingLock("m.py:a", threading.Lock, rec)
    b = lockcheck._RecordingLock("m.py:b", threading.Lock, rec)
    with a:
        with b:
            pass
    # a static edge b->a contradicts the observed a->b: merged graph cycles
    with pytest.raises(AssertionError):
        rec.assert_acyclic(extra_edges=[("m.py:b", "m.py:a")])
    # and the recorder's own edges are restored afterwards
    assert rec.snapshot_edges() == {("m.py:a", "m.py:b"): 1}


def test_lockcheck_install_shims_threading_and_condition_wait():
    before = (threading.Lock, threading.RLock, threading.Condition)
    lockcheck.install()
    try:
        lk = threading.Lock()
        assert isinstance(lk, lockcheck._RecordingLock)
        assert isinstance(threading.RLock(), lockcheck._RecordingLock)
        cond = threading.Condition()
        got: list[int] = []

        def waiter():
            with cond:
                while not got:
                    cond.wait(timeout=5)
                got.append(2)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            got.append(1)
            cond.notify_all()
        t.join(10)
        assert got == [1, 2]
    finally:
        lockcheck.uninstall()
    assert (threading.Lock, threading.RLock, threading.Condition) == before


def test_lockcheck_nests_inside_the_jax_recorder_and_unwinds():
    """The JAX recorder may be installed for the whole session (the test
    harness under its env switch): the port's installs on top of it, its
    locks wrap the JAX shims, and each uninstall restores what it found."""
    real = (threading.Lock, threading.RLock, threading.Condition)
    jax_lockcheck.install()
    try:
        jax_shims = (threading.Lock, threading.RLock, threading.Condition)
        with lockcheck.recording() as rec:
            a = threading.Lock()
            b = threading.RLock()
            assert isinstance(a, lockcheck._RecordingLock)
            assert isinstance(a._mcim_inner, jax_lockcheck._RecordingLock)
            with a:
                with b:
                    pass
            edges = rec.snapshot_edges()
            assert any(x.endswith(":a") and y.endswith(":b") for x, y in edges), edges
            cond = threading.Condition()
            with cond:
                assert not cond.wait(timeout=0.01)
        assert (threading.Lock, threading.RLock, threading.Condition) == jax_shims
    finally:
        jax_lockcheck.uninstall()
    if jax_lockcheck._install_count == 0:
        assert (threading.Lock, threading.RLock, threading.Condition) == real


def test_lockcheck_enabled_reads_the_port_registry():
    assert lockcheck.enabled(env={}) is False
    assert lockcheck.enabled(env={lockcheck.ENV_FLAG: "1"}) is True
    assert lockcheck.enabled(env={lockcheck.ENV_FLAG: "0"}) is False


def test_static_lock_graph_exists_and_is_acyclic():
    """The port's static lock-order graph over this checkout: it sees the
    scheduler/metrics nesting, and the whole graph is acyclic."""
    edges = lock_graph(ROOT)
    assert edges, "expected at least one static lock-order edge"
    assert all(a[0].startswith(PKG + "/") and b[0].startswith(PKG + "/") for a, b in edges)
    assert any(a[1] == "_cond" and b[1] == "_lock" for (a, b) in edges), sorted(edges)
    rec = lockcheck.LockRecorder()
    rec.assert_acyclic(extra_edges=[(f"{a[0]}:{a[1]}", f"{b[0]}:{b[1]}") for (a, b) in edges])
