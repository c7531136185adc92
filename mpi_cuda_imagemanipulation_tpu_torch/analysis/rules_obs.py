"""Observability-contract rules — span lifecycle, metric naming,
failpoint site registry, closed vocabularies, cost attribution.

The counterpart of the JAX package's ``analysis/rules_obs.py``: the same
rules, anchored on the port's files (``obs/recorder.py``,
``resilience/failpoints.py``, ``graph/spec.py``, ``graph/systolic.py``,
``ops/mxu_kernels.py``, ``federation/frontdoor.py``,
``resilience/deadline.py``, ``tune/controller.py``, ``obs/cost.py``).
Where a JAX rule names the root ``tools/`` it reads the package's
``tools/`` (core.is_tools).

The obs/ fabric only yields one joined timeline if every subsystem keeps
three contracts, all mechanical enough to machine-check:

  * **obs-span-leak** — every ``obs_trace.span(...)``/``start_trace(...)``
    handle must be closed: used as a context manager, ``.end()``-ed in
    the same function, or handed off (stored on an object/dict, returned,
    or passed on) to whoever closes it. A dropped handle is a span that
    never lands in the export — the trace shows a hole exactly where the
    interesting latency went.
  * **obs-metric-name** / **obs-metric-kind-drift** — metric families
    follow ``mcim_<subsystem>_<what>[_total|_seconds]`` (docs/design.md
    "Observability"): counters end ``_total``, duration histograms end
    ``_seconds``, subsystems come from the known set. One name must keep
    one kind across every registration site (the Registry dedups by
    name, so a kind clash would raise at runtime — in whichever process
    happens to register both).
  * **obs-failpoint-unknown** / **obs-failpoint-unused** — every
    ``failpoints.maybe_fail("site")``/``install("site")`` literal must
    exist in ``resilience/failpoints.py``'s ``KNOWN_SITES`` (the typo'd
    site would never fire), and every registered site must be called
    somewhere (a dead registry entry is a recovery path no test can
    reach).
"""

from __future__ import annotations

import ast
import re

from mpi_cuda_imagemanipulation_tpu_torch.analysis.core import (
    PACKAGE,
    Repo,
    checker,
    is_package,
    is_tools,
    make_finding,
    rule,
)

rule(
    "obs-span-leak", "obs",
    "A span handle from obs_trace.span()/start_trace() is neither "
    "closed (with/.end()) nor handed off — the span never reaches the "
    "export.",
)
rule(
    "obs-metric-name", "obs",
    "Metric name violates the mcim_<subsystem>_<what>[_total|_seconds] "
    "scheme (counters end _total, duration histograms _seconds).",
)
rule(
    "obs-metric-kind-drift", "obs",
    "The same metric name registered as different kinds "
    "(counter/gauge/histogram) at different sites.",
)
rule(
    "obs-failpoint-unknown", "obs",
    "failpoints.maybe_fail()/install() names a site missing from "
    "KNOWN_SITES in resilience/failpoints.py.",
)
rule(
    "obs-failpoint-unused", "obs",
    "A KNOWN_SITES entry is never exercised by any maybe_fail() call.",
)
rule(
    "obs-exemplar-missing", "obs",
    "A *_seconds histogram in serve/ or fabric/ is observed without ever "
    "attaching an exemplar trace id — its p99 in the exposition would be "
    "an anonymous count instead of linking to a trace.",
)
rule(
    "obs-recorder-trigger-unknown", "obs",
    "recorder.dump() names a trigger missing from KNOWN_TRIGGERS in "
    "obs/recorder.py (the typo'd trigger would raise at dump time — on "
    "a failure path).",
)
rule(
    "obs-recorder-trigger-unused", "obs",
    "A KNOWN_TRIGGERS entry has no recorder.dump() caller anywhere — a "
    "post-mortem trigger no failure path can reach.",
)
rule(
    "obs-recorder-trigger-dynamic", "obs",
    "recorder.dump() called with a non-literal trigger in package code — "
    "the closed KNOWN_TRIGGERS vocabulary is only machine-checkable when "
    "every production dump site names its trigger as a string literal.",
)
rule(
    "obs-systolic-fallback-unknown", "obs",
    "count_fallback() names a reason missing from FALLBACK_REASONS in "
    "graph/systolic.py (the typo'd reason would raise at count time — "
    "on the fallback path that exists to never wrong an answer).",
)
rule(
    "obs-systolic-fallback-unused", "obs",
    "A FALLBACK_REASONS entry has no count_fallback() caller anywhere — "
    "a fallback lane no dispatch path can attribute to.",
)
rule(
    "obs-systolic-fallback-dynamic", "obs",
    "count_fallback() called with a non-literal reason in package code — "
    "the closed FALLBACK_REASONS vocabulary is only machine-checkable "
    "when every fallback site names its reason as a string literal.",
)
rule(
    "obs-mxu-stage-fallback-unknown", "obs",
    "count_stage_fallback() names a reason missing from "
    "STAGE_FALLBACK_REASONS in ops/mxu_kernels.py (the typo'd reason "
    "would raise at count time — on the VPU landing that exists to "
    "never wrong a pixel).",
)
rule(
    "obs-mxu-stage-fallback-unused", "obs",
    "A STAGE_FALLBACK_REASONS entry has no count_stage_fallback() "
    "caller anywhere — an in-stage ineligibility lane the metrics "
    "cannot see (the silent-ineligibility gap this vocabulary closes).",
)
rule(
    "obs-mxu-stage-fallback-dynamic", "obs",
    "count_stage_fallback() called with a non-literal reason in package "
    "code — the closed STAGE_FALLBACK_REASONS vocabulary is only "
    "machine-checkable when every fallback site names its reason as a "
    "string literal.",
)
rule(
    "obs-fed-reroute-unknown", "obs",
    "count_reroute() names a reason missing from REROUTE_REASONS in "
    "federation/frontdoor.py (the typo'd reason would raise at count "
    "time — on the failover path that exists to never lose a request).",
)
rule(
    "obs-fed-reroute-unused", "obs",
    "A REROUTE_REASONS entry has no count_reroute() caller anywhere — a "
    "failover lane no forwarding path can attribute to.",
)
rule(
    "obs-fed-reroute-dynamic", "obs",
    "count_reroute() called with a non-literal reason in package code — "
    "the closed REROUTE_REASONS vocabulary is only machine-checkable "
    "when every reroute site names its reason as a string literal.",
)
rule(
    "obs-deadline-tier-unknown", "obs",
    "count_expired()/count_budget_denied() names a tier missing from "
    "TIERS in resilience/deadline.py (the typo'd tier would raise at "
    "count time — on the 504-answer path that exists to refuse doomed "
    "work cleanly).",
)
rule(
    "obs-deadline-tier-unused", "obs",
    "A deadline TIERS entry has no count_expired() caller anywhere — a "
    "tier that claims to check deadlines but can never account an "
    "expiry.",
)
rule(
    "obs-deadline-tier-dynamic", "obs",
    "count_expired()/count_budget_denied() called with a non-literal "
    "tier in package code — the closed TIERS vocabulary is only "
    "machine-checkable when every expiry site names its tier as a "
    "string literal.",
)
rule(
    "obs-hedge-outcome-unknown", "obs",
    "count_hedge() names an outcome missing from HEDGE_OUTCOMES in "
    "resilience/deadline.py (the typo'd outcome would raise at count "
    "time, inside the hedged-forward race).",
)
rule(
    "obs-hedge-outcome-unused", "obs",
    "A HEDGE_OUTCOMES entry has no count_hedge() caller anywhere — a "
    "hedge decision the accounting can never attribute.",
)
rule(
    "obs-hedge-outcome-dynamic", "obs",
    "count_hedge() called with a non-literal outcome in package code — "
    "the closed HEDGE_OUTCOMES vocabulary is only machine-checkable "
    "when every hedge site names its outcome as a string literal.",
)
rule(
    "obs-cost-attribution-missing", "obs",
    "A compile-cache insertion site (a store into a `_fns` cache dict or "
    "a cache_put() call) in package code never touches the cost-"
    "attribution layer (obs/cost.wrap_cache_fn / LazyAttributedFn / "
    "attribute_plan / measured_call) — the "
    "executable would serve traffic with no measured cost record, and "
    "the plan-model drift gate goes blind at that site.",
)
rule(
    "graph-taxonomy-unknown", "obs",
    "A SpecError() construction names a rejection code missing from "
    "graph/spec.py's TAXONOMY — the pipeline service's closed error "
    "vocabulary (every spec-validation rejection path must map to a "
    "registered code; an unknown code would KeyError on the rejection "
    "path itself).",
)
rule(
    "graph-taxonomy-dynamic", "obs",
    "SpecError() constructed with a non-literal code in package code — "
    "the closed taxonomy is only machine-checkable when every rejection "
    "site names its code as a string literal.",
)
rule(
    "graph-taxonomy-unused", "obs",
    "A TAXONOMY entry has no SpecError() constructor anywhere — a "
    "rejection code no path can produce (clients cannot rely on it).",
)
rule(
    "obs-tune-decision-unknown", "obs",
    "count_decision() names a decision missing from DECISIONS in "
    "tune/controller.py (the typo'd member would raise at count time, "
    "inside the control loop's tick).",
)
rule(
    "obs-tune-decision-unused", "obs",
    "A tune DECISIONS entry has no count_decision() caller anywhere — a "
    "decision the control loop claims to make but can never account.",
)
rule(
    "obs-tune-decision-dynamic", "obs",
    "count_decision() called with a non-literal decision in package "
    "code — the closed DECISIONS vocabulary is only machine-checkable "
    "when every decision site names its member as a string literal.",
)

_METRIC_RE = re.compile(
    r"^mcim_(serve|engine|cache|breaker|health|batch|analysis|fabric|stream"
    r"|plan|fleet|slo|graph|cost|devmem|systolic|fed|deadline|hedge|tune)"
    r"_[a-z0-9_]+$"
)


def _span_funcs(aliases: dict[str, str]) -> set[str]:
    """Local names that resolve to obs.trace span constructors."""
    out = set()
    for alias, target in aliases.items():
        if target.endswith((".span", ".start_trace")) and ".obs" in target:
            out.add(alias)
    return out


@checker("obs")
def check_obs(repo: Repo):
    findings: list = []
    findings.extend(_check_spans(repo))
    findings.extend(_check_metrics(repo))
    findings.extend(_check_failpoints(repo))
    findings.extend(_check_exemplars(repo))
    findings.extend(_check_recorder_triggers(repo))
    findings.extend(_check_systolic_fallbacks(repo))
    findings.extend(_check_mxu_stage_fallbacks(repo))
    findings.extend(_check_fed_reroutes(repo))
    findings.extend(_check_deadline_vocab(repo))
    findings.extend(_check_graph_taxonomy(repo))
    findings.extend(_check_cost_attribution(repo))
    findings.extend(_check_tune_decisions(repo))
    return findings


# -- span lifecycle ----------------------------------------------------------


def _is_span_call(node: ast.Call, aliases: dict[str, str],
                  local_span_funcs: set[str]) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in ("span", "start_trace"):
        if isinstance(fn.value, ast.Name):
            base = aliases.get(fn.value.id, fn.value.id)
            return "trace" in base or "obs" in base or fn.value.id in (
                "obs_trace", "tracer",
            )
        return False
    if isinstance(fn, ast.Name):
        return fn.id in local_span_funcs
    return False


def _check_spans(repo: Repo) -> list:
    findings = []
    for sf in repo.package_files() + [
        f for f in repo.files if is_tools(f.rel)
    ]:
        if sf.rel == f"{PACKAGE}/obs/trace.py":
            continue  # the implementation itself
        if "span" not in sf.source and "start_trace" not in sf.source:
            continue  # no span constructor named or imported
        aliases = repo.alias_targets(sf.modname)
        span_funcs = _span_funcs(aliases)
        for fn in sf.nodes():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # direct statements only — nested functions get their own turn
            findings.extend(
                _check_spans_in_function(sf, fn, aliases, span_funcs)
            )
    return findings


def _check_spans_in_function(sf, fn, aliases, span_funcs) -> list:
    findings = []
    with_exprs: set[int] = set()  # id() of calls used as context managers
    assigned: dict[str, int] = {}  # name -> line of span assignment
    handed_off: set[str] = set()
    ended: set[str] = set()
    discarded: list[tuple[int, str]] = []

    own_nodes = []
    skip: set[int] = set()
    for node in ast.walk(fn):
        if node is not fn and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            for sub in ast.walk(node):
                skip.add(id(sub))
    for node in ast.walk(fn):
        if id(node) not in skip or node is fn:
            own_nodes.append(node)

    for node in own_nodes:
        if isinstance(node, ast.With):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    with_exprs.add(id(item.context_expr))
    for node in own_nodes:
        if not isinstance(node, ast.Call):
            continue
        if not _is_span_call(node, aliases, span_funcs):
            continue
        if id(node) in with_exprs:
            continue
        # find how the result is used: walk statements
        # (classified below via parent scan)
        node._mcim_span = True  # type: ignore[attr-defined]
    for node in own_nodes:
        if isinstance(node, ast.Assign) and getattr(
            node.value, "_mcim_span", False
        ):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    assigned[tgt.id] = node.lineno
                else:
                    # req.trace = span(...) — handed off to the object
                    pass
            node.value._mcim_span = False
        elif isinstance(node, ast.Expr) and getattr(
            node.value, "_mcim_span", False
        ):
            discarded.append((node.lineno, "result discarded"))
            node.value._mcim_span = False
        elif isinstance(node, ast.Return) and getattr(
            node.value, "_mcim_span", False
        ):
            node.value._mcim_span = False  # returned: caller owns it
    # any still-marked span call is an argument / nested use: handed off
    for node in own_nodes:
        if isinstance(node, ast.Call) and getattr(
            node, "_mcim_span", False
        ):
            node._mcim_span = False

    if not assigned and not discarded:
        return findings

    for node in own_nodes:
        if not isinstance(node, ast.Call):
            continue
        f2 = node.func
        if (
            isinstance(f2, ast.Attribute)
            and f2.attr == "end"
            and isinstance(f2.value, ast.Name)
        ):
            ended.add(f2.value.id)
        else:
            for a in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(a, ast.Name):
                    handed_off.add(a.id)
    for node in own_nodes:
        if isinstance(node, ast.Assign):
            # name stored onto an attribute/dict/other name: handed off
            for tgt in node.targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    if isinstance(node.value, ast.Name):
                        handed_off.add(node.value.id)
        elif isinstance(node, ast.Return) and isinstance(
            node.value, ast.Name
        ):
            handed_off.add(node.value.id)
        elif isinstance(node, ast.With):
            for item in node.items:
                if isinstance(item.context_expr, ast.Name):
                    ended.add(item.context_expr.id)

    for name, line in assigned.items():
        if name not in ended and name not in handed_off:
            findings.append(
                make_finding(
                    "obs-span-leak", sf.rel, line,
                    f"span handle {name!r} (in {fn.name}) is never "
                    "ended or handed off",
                )
            )
    for line, why in discarded:
        findings.append(
            make_finding(
                "obs-span-leak", sf.rel, line,
                f"span call {why} (in {fn.name}) — use `with` or keep "
                "the handle and .end() it",
            )
        )
    return findings


# -- metric naming -----------------------------------------------------------

_REG_METHODS = {"counter", "gauge", "histogram"}


def _check_metrics(repo: Repo) -> list:
    findings = []
    sites: dict[str, list[tuple[str, str, int]]] = {}  # name -> (kind, file, line)
    for sf in repo.package_files():
        if sf.rel == f"{PACKAGE}/obs/metrics.py":
            continue
        for node in sf.nodes():
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _REG_METHODS
            ):
                continue
            if not node.args or not (
                isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            name = node.args[0].value
            if not name.startswith("mcim"):
                continue  # some other .counter() API
            kind = node.func.attr
            sites.setdefault(name, []).append((kind, sf.rel, node.lineno))
            msg = None
            if not _METRIC_RE.match(name):
                msg = (
                    f"metric {name!r} violates the "
                    "mcim_<subsystem>_<what> scheme "
                    "(subsystems: serve/engine/cache/breaker/health/"
                    "batch/analysis/fabric/stream/plan/fleet/slo/graph/"
                    "systolic/fed/deadline/hedge/tune)"
                )
            elif kind == "counter" and not name.endswith("_total"):
                msg = f"counter {name!r} must end in _total"
            elif kind == "histogram" and not name.endswith("_seconds"):
                msg = (
                    f"histogram {name!r} must end in _seconds "
                    "(durations are seconds; consumers rescale)"
                )
            elif kind == "gauge" and name.endswith("_total"):
                msg = (
                    f"gauge {name!r} must not end in _total (reserved "
                    "for counters)"
                )
            if msg:
                findings.append(
                    make_finding(
                        "obs-metric-name", sf.rel, node.lineno, msg
                    )
                )
    for name, regs in sites.items():
        kinds = {k for k, _f, _l in regs}
        if len(kinds) > 1:
            k, f, l = regs[1]
            findings.append(
                make_finding(
                    "obs-metric-kind-drift", f, l,
                    f"metric {name!r} registered as {sorted(kinds)} at "
                    "different sites: "
                    + ", ".join(f"{ff}:{ll}({kk})" for kk, ff, ll in regs),
                )
            )
    return findings


# -- exemplar contract (serve/ + fabric/ latency histograms) ------------------


def _check_exemplars(repo: Repo) -> list:
    """Every `*_seconds` histogram registered in serve/ or fabric/ must
    have at least one `.observe(..., exemplar=...)` call on the same
    attribute in the same file — the latency exposition's trace-id link
    is a contract, not a nicety."""
    findings = []
    prefixes = (f"{PACKAGE}/serve/", f"{PACKAGE}/fabric/")
    for sf in repo.package_files():
        if not sf.rel.startswith(prefixes):
            continue
        # attr name -> (metric name, line) for *_seconds histogram regs
        regs: dict[str, tuple[str, int]] = {}
        # attr name -> True if ANY observe carries exemplar=
        observed: dict[str, bool] = {}
        for node in sf.nodes():
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                fn = node.value.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "histogram"
                    and node.value.args
                    and isinstance(node.value.args[0], ast.Constant)
                    and isinstance(node.value.args[0].value, str)
                    and node.value.args[0].value.endswith("_seconds")
                ):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute):
                            regs[tgt.attr] = (
                                node.value.args[0].value, node.lineno
                            )
                        elif isinstance(tgt, ast.Name):
                            regs[tgt.id] = (
                                node.value.args[0].value, node.lineno
                            )
            elif isinstance(node, ast.Call):
                fn = node.func
                if not (
                    isinstance(fn, ast.Attribute) and fn.attr == "observe"
                ):
                    continue
                recv = None
                if isinstance(fn.value, ast.Attribute):
                    recv = fn.value.attr
                elif isinstance(fn.value, ast.Name):
                    recv = fn.value.id
                if recv is None:
                    continue
                has_ex = any(k.arg == "exemplar" for k in node.keywords)
                observed[recv] = observed.get(recv, False) or has_ex
        for attr, (metric, line) in regs.items():
            if attr in observed and not observed[attr]:
                findings.append(
                    make_finding(
                        "obs-exemplar-missing", sf.rel, line,
                        f"histogram {metric!r} (self.{attr}) is observed "
                        "in this file but no observe() call attaches an "
                        "exemplar trace id",
                    )
                )
    return findings


# -- flight-recorder trigger registry -----------------------------------------


def _known_triggers(repo: Repo) -> tuple[set[str], int]:
    sf = repo.by_rel.get(f"{PACKAGE}/obs/recorder.py")
    if sf is None:
        return set(), 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "KNOWN_TRIGGERS":
                    vals = {
                        e.value
                        for e in ast.walk(node.value)
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    }
                    return vals, node.lineno
    return set(), 0


def _is_recorder_dump(node: ast.Call, aliases: dict[str, str]) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "dump":
        if isinstance(fn.value, ast.Name):
            base = aliases.get(fn.value.id, fn.value.id)
            return "recorder" in base or "recorder" in fn.value.id
        return False
    if isinstance(fn, ast.Name) and fn.id == "dump":
        return "recorder" in aliases.get("dump", "")
    return False


def _check_recorder_triggers(repo: Repo) -> list:
    findings = []
    known, reg_line = _known_triggers(repo)
    if not known:
        return findings
    used: set[str] = set()
    for sf in repo.files:
        if sf.rel == f"{PACKAGE}/obs/recorder.py":
            continue
        aliases = repo.alias_targets(sf.modname)
        for node in sf.nodes():
            if not (isinstance(node, ast.Call) and node.args):
                continue
            if not _is_recorder_dump(node, aliases):
                continue
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                trigger = a0.value
                used.add(trigger)
                if trigger not in known:
                    findings.append(
                        make_finding(
                            "obs-recorder-trigger-unknown", sf.rel,
                            node.lineno,
                            f"recorder trigger {trigger!r} is not in "
                            "KNOWN_TRIGGERS (obs/recorder.py)",
                        )
                    )
            elif is_package(sf.rel):
                # a computed trigger in production code would dodge the
                # unknown/unused checks entirely — the vocabulary is only
                # closed if every package dump site is a literal (tests
                # and tools may parameterize; they are not failure paths)
                findings.append(
                    make_finding(
                        "obs-recorder-trigger-dynamic", sf.rel,
                        node.lineno,
                        "recorder.dump() trigger is not a string literal "
                        "— name one of KNOWN_TRIGGERS directly",
                    )
                )
    for trigger in sorted(known - used):
        findings.append(
            make_finding(
                "obs-recorder-trigger-unused",
                f"{PACKAGE}/obs/recorder.py", reg_line,
                f"KNOWN_TRIGGERS entry {trigger!r} has no recorder.dump() "
                "caller anywhere in the repo",
            )
        )
    return findings


# -- systolic fallback reasons (graph/systolic.py) ----------------------------


def _known_fallback_reasons(repo: Repo) -> tuple[set[str], int]:
    sf = repo.by_rel.get(f"{PACKAGE}/graph/systolic.py")
    if sf is None:
        return set(), 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Name)
                    and tgt.id == "FALLBACK_REASONS"
                ):
                    vals = {
                        e.value
                        for e in ast.walk(node.value)
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    }
                    return vals, node.lineno
    return set(), 0


def _is_count_fallback(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr == "count_fallback"
    return isinstance(fn, ast.Name) and fn.id == "count_fallback"


def _check_systolic_fallbacks(repo: Repo) -> list:
    """The systolic fallback vocabulary is closed exactly like recorder
    triggers: every count_fallback(counter, reason) site must name a
    FALLBACK_REASONS literal, and every entry must have a caller — a
    reason nobody can count is a fallback lane the metrics cannot see."""
    findings = []
    known, reg_line = _known_fallback_reasons(repo)
    if not known:
        return findings
    used: set[str] = set()
    for sf in repo.files:
        if sf.rel == f"{PACKAGE}/graph/systolic.py":
            continue
        for node in sf.nodes():
            if not (isinstance(node, ast.Call) and len(node.args) >= 2):
                continue
            if not _is_count_fallback(node):
                continue
            a1 = node.args[1]
            if isinstance(a1, ast.Constant) and isinstance(a1.value, str):
                reason = a1.value
                used.add(reason)
                if reason not in known and sf.rel.startswith(
                    PACKAGE + "/"
                ):
                    # tests may pass an out-of-vocabulary reason on
                    # purpose — asserting the ValueError guard fires
                    findings.append(
                        make_finding(
                            "obs-systolic-fallback-unknown", sf.rel,
                            node.lineno,
                            f"systolic fallback reason {reason!r} is not "
                            "in FALLBACK_REASONS (graph/systolic.py)",
                        )
                    )
            elif is_package(sf.rel):
                findings.append(
                    make_finding(
                        "obs-systolic-fallback-dynamic", sf.rel,
                        node.lineno,
                        "count_fallback() reason is not a string literal "
                        "— name one of FALLBACK_REASONS directly",
                    )
                )
    for reason in sorted(known - used):
        findings.append(
            make_finding(
                "obs-systolic-fallback-unused",
                f"{PACKAGE}/graph/systolic.py", reg_line,
                f"FALLBACK_REASONS entry {reason!r} has no "
                "count_fallback() caller anywhere in the repo",
            )
        )
    return findings


# -- mxu in-stage fallback reasons (ops/mxu_kernels.py) -----------------------


def _known_stage_fallback_reasons(repo: Repo) -> tuple[set[str], int]:
    sf = repo.by_rel.get(f"{PACKAGE}/ops/mxu_kernels.py")
    if sf is None:
        return set(), 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Name)
                    and tgt.id == "STAGE_FALLBACK_REASONS"
                ):
                    vals = {
                        e.value
                        for e in ast.walk(node.value)
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    }
                    return vals, node.lineno
    return set(), 0


def _is_count_stage_fallback(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr == "count_stage_fallback"
    return isinstance(fn, ast.Name) and fn.id == "count_stage_fallback"


def _check_mxu_stage_fallbacks(repo: Repo) -> list:
    """The mxu-in-stage fallback vocabulary is closed exactly like the
    systolic one: every count_stage_fallback(counter, reason) site must
    name a STAGE_FALLBACK_REASONS literal, and every entry must have a
    caller. Unlike the systolic checker, the DEFINING file is scanned
    too — the arm resolver (stage_arm_for) lives next to the vocabulary,
    so its count sites are the primary callers."""
    findings = []
    known, reg_line = _known_stage_fallback_reasons(repo)
    if not known:
        return findings
    used: set[str] = set()
    for sf in repo.files:
        for node in sf.nodes():
            if not (isinstance(node, ast.Call) and len(node.args) >= 2):
                continue
            if not _is_count_stage_fallback(node):
                continue
            a1 = node.args[1]
            if isinstance(a1, ast.Constant) and isinstance(a1.value, str):
                reason = a1.value
                used.add(reason)
                if reason not in known and sf.rel.startswith(
                    PACKAGE + "/"
                ):
                    # tests may pass an out-of-vocabulary reason on
                    # purpose — asserting the ValueError guard fires
                    findings.append(
                        make_finding(
                            "obs-mxu-stage-fallback-unknown", sf.rel,
                            node.lineno,
                            f"mxu-in-stage fallback reason {reason!r} is "
                            "not in STAGE_FALLBACK_REASONS "
                            "(ops/mxu_kernels.py)",
                        )
                    )
            elif is_package(sf.rel):
                findings.append(
                    make_finding(
                        "obs-mxu-stage-fallback-dynamic", sf.rel,
                        node.lineno,
                        "count_stage_fallback() reason is not a string "
                        "literal — name one of STAGE_FALLBACK_REASONS "
                        "directly",
                    )
                )
    for reason in sorted(known - used):
        findings.append(
            make_finding(
                "obs-mxu-stage-fallback-unused",
                f"{PACKAGE}/ops/mxu_kernels.py", reg_line,
                f"STAGE_FALLBACK_REASONS entry {reason!r} has no "
                "count_stage_fallback() caller anywhere in the repo",
            )
        )
    return findings


# -- federation reroute reasons (federation/frontdoor.py) ---------------------


def _known_reroute_reasons(repo: Repo) -> tuple[set[str], int]:
    sf = repo.by_rel.get(f"{PACKAGE}/federation/frontdoor.py")
    if sf is None:
        return set(), 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Name)
                    and tgt.id == "REROUTE_REASONS"
                ):
                    vals = {
                        e.value
                        for e in ast.walk(node.value)
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    }
                    return vals, node.lineno
    return set(), 0


def _is_count_reroute(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr == "count_reroute"
    return isinstance(fn, ast.Name) and fn.id == "count_reroute"


def _check_fed_reroutes(repo: Repo) -> list:
    """The federation reroute vocabulary is closed exactly like systolic
    fallback reasons: every count_reroute(counter, reason) site must name
    a REROUTE_REASONS literal, and every entry must have a caller — a
    reason nobody can count is a failover lane the metrics cannot see."""
    findings = []
    known, reg_line = _known_reroute_reasons(repo)
    if not known:
        return findings
    used: set[str] = set()
    for sf in repo.files:
        for node in sf.nodes():
            if not (isinstance(node, ast.Call) and len(node.args) >= 2):
                continue
            if not _is_count_reroute(node):
                continue
            a1 = node.args[1]
            if isinstance(a1, ast.Constant) and isinstance(a1.value, str):
                reason = a1.value
                used.add(reason)
                if reason not in known and sf.rel.startswith(
                    PACKAGE + "/"
                ):
                    # tests may pass an out-of-vocabulary reason on
                    # purpose — asserting the ValueError guard fires
                    findings.append(
                        make_finding(
                            "obs-fed-reroute-unknown", sf.rel,
                            node.lineno,
                            f"federation reroute reason {reason!r} is not "
                            "in REROUTE_REASONS (federation/frontdoor.py)",
                        )
                    )
            elif is_package(sf.rel):
                findings.append(
                    make_finding(
                        "obs-fed-reroute-dynamic", sf.rel,
                        node.lineno,
                        "count_reroute() reason is not a string literal "
                        "— name one of REROUTE_REASONS directly",
                    )
                )
    for reason in sorted(known - used):
        findings.append(
            make_finding(
                "obs-fed-reroute-unused",
                f"{PACKAGE}/federation/frontdoor.py", reg_line,
                f"REROUTE_REASONS entry {reason!r} has no "
                "count_reroute() caller anywhere in the repo",
            )
        )
    return findings


# -- tune decisions (tune/controller.py) ---------------------------------------


def _known_tune_decisions(repo: Repo) -> tuple[set[str], int]:
    sf = repo.by_rel.get(f"{PACKAGE}/tune/controller.py")
    if sf is None:
        return set(), 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "DECISIONS":
                    vals = {
                        e.value
                        for e in ast.walk(node.value)
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    }
                    return vals, node.lineno
    return set(), 0


def _is_count_decision(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr == "count_decision"
    return isinstance(fn, ast.Name) and fn.id == "count_decision"


def _check_tune_decisions(repo: Repo) -> list:
    """The tune decision vocabulary is closed exactly like systolic
    fallback reasons and federation reroutes: every
    count_decision(counter, decision) site must name a DECISIONS
    literal, and every entry must have a caller — a decision the
    autonomous control loop cannot account is a flip nobody audited."""
    findings = []
    known, reg_line = _known_tune_decisions(repo)
    if not known:
        return findings
    used: set[str] = set()
    for sf in repo.files:
        for node in sf.nodes():
            if not (isinstance(node, ast.Call) and len(node.args) >= 2):
                continue
            if not _is_count_decision(node):
                continue
            a1 = node.args[1]
            if isinstance(a1, ast.Constant) and isinstance(a1.value, str):
                decision = a1.value
                used.add(decision)
                if decision not in known and sf.rel.startswith(
                    PACKAGE + "/"
                ):
                    # tests may pass an out-of-vocabulary member on
                    # purpose — asserting the ValueError guard fires
                    findings.append(
                        make_finding(
                            "obs-tune-decision-unknown", sf.rel,
                            node.lineno,
                            f"tune decision {decision!r} is not in "
                            "DECISIONS (tune/controller.py)",
                        )
                    )
            elif is_package(sf.rel):
                findings.append(
                    make_finding(
                        "obs-tune-decision-dynamic", sf.rel,
                        node.lineno,
                        "count_decision() decision is not a string "
                        "literal — name one of DECISIONS directly",
                    )
                )
    for decision in sorted(known - used):
        findings.append(
            make_finding(
                "obs-tune-decision-unused",
                f"{PACKAGE}/tune/controller.py", reg_line,
                f"DECISIONS entry {decision!r} has no count_decision() "
                "caller anywhere in the repo",
            )
        )
    return findings


# -- deadline tiers & hedge outcomes (resilience/deadline.py) ------------------


def _known_vocab(repo: Repo, varname: str) -> tuple[set[str], int]:
    """A closed string-tuple vocabulary assigned at module level in
    resilience/deadline.py (TIERS / HEDGE_OUTCOMES)."""
    sf = repo.by_rel.get(f"{PACKAGE}/resilience/deadline.py")
    if sf is None:
        return set(), 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == varname:
                    vals = {
                        e.value
                        for e in ast.walk(node.value)
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    }
                    return vals, node.lineno
    return set(), 0


def _is_call_named(node: ast.Call, name: str) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr == name
    return isinstance(fn, ast.Name) and fn.id == name


def _check_closed_vocab_calls(
    repo: Repo,
    *,
    funcs: tuple[str, ...],
    known: set[str],
    vocab_name: str,
    reg_line: int,
    rule_prefix: str,
    require_used: tuple[str, ...],
) -> list:
    """Shared closed-vocabulary discipline (mirrors _check_fed_reroutes):
    every call to any of `funcs` must pass a literal member of `known`;
    members must additionally have a caller of the functions named in
    `require_used` (functions outside that set — e.g. count_budget_denied
    over TIERS — validate membership but don't establish coverage, since
    only a subset of tiers hold a retry budget)."""
    findings = []
    if not known:
        return findings
    used: set[str] = set()
    for sf in repo.files:
        for node in sf.nodes():
            if not (isinstance(node, ast.Call) and len(node.args) >= 2):
                continue
            fname = next(
                (f for f in funcs if _is_call_named(node, f)), None
            )
            if fname is None:
                continue
            a1 = node.args[1]
            if isinstance(a1, ast.Constant) and isinstance(a1.value, str):
                member = a1.value
                if fname in require_used:
                    used.add(member)
                if member not in known and sf.rel.startswith(
                    PACKAGE + "/"
                ):
                    # tests may pass an out-of-vocabulary member on
                    # purpose — asserting the ValueError guard fires
                    findings.append(
                        make_finding(
                            f"{rule_prefix}-unknown", sf.rel,
                            node.lineno,
                            f"{fname}() names {member!r}, not in "
                            f"{vocab_name} (resilience/deadline.py)",
                        )
                    )
            elif is_package(sf.rel):
                findings.append(
                    make_finding(
                        f"{rule_prefix}-dynamic", sf.rel,
                        node.lineno,
                        f"{fname}() member is not a string literal — "
                        f"name one of {vocab_name} directly",
                    )
                )
    for member in sorted(known - used):
        findings.append(
            make_finding(
                f"{rule_prefix}-unused",
                f"{PACKAGE}/resilience/deadline.py", reg_line,
                f"{vocab_name} entry {member!r} has no "
                f"{'/'.join(require_used)}() caller anywhere in the repo",
            )
        )
    return findings


def _check_deadline_vocab(repo: Repo) -> list:
    """The request-lifecycle vocabularies are closed exactly like
    federation reroute reasons: per-tier deadline expiry (TIERS, counted
    by count_expired — count_budget_denied validates against the same
    tuple but only budget-holding tiers call it) and hedge outcomes
    (HEDGE_OUTCOMES, counted by count_hedge)."""
    tiers, tiers_line = _known_vocab(repo, "TIERS")
    outcomes, outcomes_line = _known_vocab(repo, "HEDGE_OUTCOMES")
    return _check_closed_vocab_calls(
        repo,
        funcs=("count_expired", "count_budget_denied"),
        known=tiers,
        vocab_name="TIERS",
        reg_line=tiers_line,
        rule_prefix="obs-deadline-tier",
        require_used=("count_expired",),
    ) + _check_closed_vocab_calls(
        repo,
        funcs=("count_hedge",),
        known=outcomes,
        vocab_name="HEDGE_OUTCOMES",
        reg_line=outcomes_line,
        rule_prefix="obs-hedge-outcome",
        require_used=("count_hedge",),
    )


# -- cost-attribution contract (obs/cost.py) ----------------------------------

# the cost-layer entry points a compile-cache file must reach (the port's
# obs/cost.py; the JAX package's attribute_jit has no counterpart there)
_COST_HOOKS = {"wrap_cache_fn", "LazyAttributedFn", "attribute_plan",
               "measured_call"}


def _file_touches_cost_layer(sf) -> bool:
    """Whether the file imports obs.cost (module- or function-level) or
    calls one of its attribution hooks by name."""
    for node in sf.nodes():
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.endswith("obs.cost"):
                return True
            if mod.endswith(".obs") or mod == "obs":
                if any(a.name == "cost" for a in node.names):
                    return True
        elif isinstance(node, ast.Call):
            fn = node.func
            name = (
                fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else None
            )
            if name in _COST_HOOKS:
                return True
    return False


def _cache_insertions(sf) -> list[tuple[int, str]]:
    """(line, description) for every compile-cache insertion in the
    file: a store/setdefault into a `_fns`-named attribute (the
    compile-cache idiom serve/cache and stream/tiles share) or a
    `cache_put()` call (the graph tenancy namespaces)."""
    out: list[tuple[int, str]] = []
    for node in sf.nodes():
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Attribute)
                    and tgt.value.attr == "_fns"
                ):
                    out.append((node.lineno, "store into _fns"))
        elif isinstance(node, ast.Call):
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr == "setdefault" and (
                isinstance(fn.value, ast.Attribute)
                and fn.value.attr == "_fns"
            ):
                out.append((node.lineno, "_fns.setdefault"))
            elif fn.attr == "cache_put":
                out.append((node.lineno, "cache_put call"))
    return out


def _check_cost_attribution(repo: Repo) -> list:
    """Every compile-cache insertion site must record cost attribution:
    an executable that enters a cache without touching obs/cost serves
    traffic the drift gate never sees."""
    findings = []
    for sf in repo.package_files():
        if sf.rel in (
            f"{PACKAGE}/obs/cost.py",  # the layer itself
            f"{PACKAGE}/graph/tenancy.py",  # cache_put DEFINITION, not a site
        ):
            continue
        insertions = _cache_insertions(sf)
        if not insertions:
            continue
        if _file_touches_cost_layer(sf):
            continue
        for line, what in insertions:
            findings.append(
                make_finding(
                    "obs-cost-attribution-missing", sf.rel, line,
                    f"compile-cache insertion ({what}) in a file that "
                    "never reaches obs/cost — wrap the callable with "
                    "wrap_cache_fn/LazyAttributedFn so the executable's "
                    "measured cost lands in the ledger",
                )
            )
    return findings


# -- pipeline-service error taxonomy (graph/spec.py) --------------------------


def _taxonomy_codes(repo: Repo) -> tuple[set[str], int, set[int]]:
    """The closed rejection-code vocabulary: the keys of graph/spec.py's
    TAXONOMY dict literal (the graph analogue of KNOWN_SITES). The third
    element is the id() set of the registry's own AST nodes, so the
    usage scan can exclude the declaration from counting as a use."""
    sf = repo.by_rel.get(f"{PACKAGE}/graph/spec.py")
    if sf is None:
        return set(), 0, set()
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "TAXONOMY":
                    if isinstance(node.value, ast.Dict):
                        keys = {
                            k.value
                            for k in node.value.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                        }
                        own = {id(n) for n in ast.walk(node)}
                        return keys, node.lineno, own
    return set(), 0, set()


def _check_graph_taxonomy(repo: Repo) -> list:
    """Every spec-validation rejection path must map to a registered
    taxonomy code: a `SpecError("<code>", ...)` construction anywhere
    must name a TAXONOMY key (unknown = blocking — the rejection path
    itself would KeyError), package-code constructions must use literal
    codes (a computed code dodges the closed vocabulary), and every
    registered code must be reachable by some literal use."""
    findings = []
    codes, reg_line, own_nodes = _taxonomy_codes(repo)
    if not codes:
        return findings
    used: set[str] = set()
    for sf in repo.files:
        in_package = is_package(sf.rel)
        for node in sf.nodes():
            # any literal occurrence of a code counts toward 'used' —
            # rejection codes also appear in structured-response dicts
            # (e.g. the HTTP 404 shapes), which are production paths too.
            # The TAXONOMY declaration itself is excluded: registering a
            # code is not producing it.
            if (
                in_package
                and isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and node.value in codes
                and id(node) not in own_nodes
            ):
                used.add(node.value)
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            fname = (
                fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else None
            )
            if fname != "SpecError":
                continue
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                # package rejection paths only: tests deliberately
                # construct unregistered codes to exercise the runtime
                # KeyError guard (the dynamic rule scopes the same way)
                if a0.value not in codes and in_package:
                    findings.append(
                        make_finding(
                            "graph-taxonomy-unknown", sf.rel, node.lineno,
                            f"rejection code {a0.value!r} is not in "
                            "TAXONOMY (graph/spec.py)",
                        )
                    )
            elif in_package and sf.rel != f"{PACKAGE}/graph/spec.py":
                # spec.py itself holds the (guarded) class definition;
                # everywhere else a computed code dodges the vocabulary
                findings.append(
                    make_finding(
                        "graph-taxonomy-dynamic", sf.rel, node.lineno,
                        "SpecError code is not a string literal — name "
                        "one of graph/spec.TAXONOMY directly",
                    )
                )
    for code in sorted(codes - used):
        findings.append(
            make_finding(
                "graph-taxonomy-unused",
                f"{PACKAGE}/graph/spec.py", reg_line,
                f"TAXONOMY entry {code!r} is produced by no rejection "
                "path anywhere in the package",
            )
        )
    return findings


# -- failpoint registry -------------------------------------------------------


def _known_sites(repo: Repo) -> tuple[set[str], int]:
    sf = repo.by_rel.get(f"{PACKAGE}/resilience/failpoints.py")
    if sf is None:
        return set(), 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "KNOWN_SITES":
                    vals = set()
                    for e in ast.walk(node.value):
                        if isinstance(e, ast.Constant) and isinstance(
                            e.value, str
                        ):
                            vals.add(e.value)
                    return vals, node.lineno
    return set(), 0


def _check_failpoints(repo: Repo) -> list:
    findings = []
    known, reg_line = _known_sites(repo)
    if not known:
        return findings
    used: set[str] = set()
    for sf in repo.files:
        if sf.rel == f"{PACKAGE}/resilience/failpoints.py":
            continue
        for node in sf.nodes():
            if not (
                isinstance(node, ast.Call) and node.args
            ):
                continue
            fname = None
            if isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            elif isinstance(node.func, ast.Name):
                fname = node.func.id
            if fname not in ("maybe_fail", "install"):
                continue
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                site = a0.value
                if fname == "maybe_fail":
                    used.add(site)
                if site not in known:
                    findings.append(
                        make_finding(
                            "obs-failpoint-unknown", sf.rel, node.lineno,
                            f"failpoint site {site!r} is not in "
                            "KNOWN_SITES (resilience/failpoints.py)",
                        )
                    )
    for site in sorted(known - used):
        findings.append(
            make_finding(
                "obs-failpoint-unused",
                f"{PACKAGE}/resilience/failpoints.py", reg_line,
                f"KNOWN_SITES entry {site!r} has no maybe_fail() caller "
                "anywhere in the repo",
            )
        )
    return findings
