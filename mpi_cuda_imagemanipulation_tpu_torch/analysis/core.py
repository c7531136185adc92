"""mcim-check core for the port — repo model, rule registry, suppressions,
reporters.

The counterpart of the JAX package's ``analysis/core.py``, with the same
rules on the port's files. The analyzer is AST-based and repo-native:
rules are written against this codebase's real conventions (the
``self._lock``/``self._cond`` guard idiom, ``obs_trace.span`` handles,
``failpoints.maybe_fail`` sites, the ``MCIM_*`` env registry) rather than
generic lint abstractions, which is what lets them run as a *blocking*
gate with near-zero noise. Three pieces live here:

  * :class:`Repo` — every ``.py`` file in scope parsed once, plus the
    cross-module indexes rules share: module→functions, module→classes,
    and per-module import-alias maps. The scope (:func:`in_scope`) is the
    port's own files: the package, ``chip_smoke.py`` and the port's tests
    (``tests/test_torch_*.py``, ``tests/_torch_*.py``). The JAX package,
    the root ``tools/``, the JAX tests and ``bench.py`` belong to the JAX
    package's own gate and are never read here. The package's ``tools/``
    holds the port's counterparts of the root ``tools/`` scripts, so the
    rules treat it as the JAX rules treat the root ``tools/``
    (:func:`is_tools`, :func:`is_package`): each file meets the rules its
    JAX counterpart meets.
  * the rule registry — a rule is a function ``(Repo) -> list[Finding]``
    registered with :func:`rule`; families group related rules for
    ``--rules`` selection.
  * suppressions — ``# mcim-torch: allow(<rule>: <reason>)`` on the
    offending line (or alone on the line above) waives exactly one rule
    there; a reason is mandatory. ``# mcim-torch: allow-file(<rule>:
    <reason>)`` near the top of a file waives the rule file-wide. A
    suppression that no longer suppresses anything is itself a finding
    (``unused-suppression``), so stale waivers can't accumulate. The
    marker is not the JAX package's ``# mcim:``: the JAX gate reads every
    file of the checkout, the port's included, and would report each of
    the port's waivers as an unused suppression of its own (its rules
    never fire on the port's files); neither gate's pattern matches the
    other's marker.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

PACKAGE = "mpi_cuda_imagemanipulation_tpu_torch"
TOOLS = PACKAGE + "/tools/"

_PORT_TESTS_RE = re.compile(r"tests/(test_torch_|_torch_)[^/]*\.py$")

# directories never analyzed (vendored/derived/VCS)
_SKIP_DIRS = {
    ".git", "__pycache__", ".jax_cache", "artifacts", ".pytest_cache",
    ".claude", "node_modules",
}

SEVERITIES = ("error", "warning")


def in_scope(rel: str) -> bool:
    """Whether the repo-relative path is one of the port's own files: the
    package, ``chip_smoke.py`` and the port's tests."""
    return (
        rel.startswith(PACKAGE + "/")
        or rel == "chip_smoke.py"
        or _PORT_TESTS_RE.match(rel) is not None
    )


def is_tools(rel: str) -> bool:
    """The package's ``tools/``: what the JAX rules call the root
    ``tools/``."""
    return rel.startswith(TOOLS)


def is_package(rel: str) -> bool:
    """Package code in the JAX rules' sense: the package without its
    ``tools/``."""
    return rel.startswith(PACKAGE + "/") and not is_tools(rel)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str  # repo-relative posix path
    line: int
    message: str
    severity: str = "error"

    def key(self) -> tuple:
        return (self.file, self.line, self.rule, self.message)


@dataclasses.dataclass(frozen=True)
class RuleInfo:
    id: str
    family: str  # concurrency | tracer | obs | surface
    severity: str
    doc: str


RULES: dict[str, RuleInfo] = {}
_RULE_FNS: dict[str, object] = {}
# rule implementations are registered per CHECKER function (one checker
# may emit several rule ids — e.g. the concurrency pass builds one lock
# graph and reports order cycles, blocking calls and guard drift from it)
_CHECKERS: list[tuple[str, object]] = []  # (family, fn)


def rule(id: str, family: str, doc: str, severity: str = "error") -> RuleInfo:
    """Declare a rule id (metadata only; emit findings from a checker)."""
    info = RuleInfo(id, family, severity, doc)
    RULES[id] = info
    return info


def checker(family: str):
    """Register a checker function ``(Repo) -> list[Finding]``."""

    def deco(fn):
        _CHECKERS.append((family, fn))
        return fn

    return deco


def make_finding(rule_id: str, file: str, line: int, message: str) -> Finding:
    info = RULES[rule_id]
    return Finding(rule_id, file, line, message, info.severity)


# -- repo model -------------------------------------------------------------


@dataclasses.dataclass
class SourceFile:
    rel: str  # repo-relative posix path
    path: str  # absolute
    modname: str  # dotted pseudo-module name ("tools.soak", "bench")
    source: str
    lines: list[str]
    tree: ast.Module
    _nodes: list | None = dataclasses.field(default=None, repr=False)

    def nodes(self) -> list:
        """Every node of the tree in ``ast.walk`` order, listed once for
        all the rules that scan the whole file."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes


class Repo:
    """The parsed files under `root` that `include` (a repo-relative path
    -> bool; default :func:`in_scope`) keeps; ``include=None`` keeps every
    ``.py`` file (a fixture tree walked whole)."""

    def __init__(self, root: str, include=in_scope):
        self.root = os.path.abspath(root)
        self.include = include
        self.files: list[SourceFile] = []
        self.by_rel: dict[str, SourceFile] = {}
        self.parse_errors: list[Finding] = []
        self._load()
        self._index()

    # -- loading -----------------------------------------------------------

    def _load(self) -> None:
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _SKIP_DIRS
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, self.root).replace(os.sep, "/")
                if self.include is not None and not self.include(rel):
                    continue
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                try:
                    tree = ast.parse(source, filename=rel)
                except SyntaxError as e:
                    self.parse_errors.append(
                        Finding(
                            "parse-error", rel, e.lineno or 1,
                            f"syntax error: {e.msg}",
                        )
                    )
                    continue
                modname = rel[:-3].replace("/", ".")
                if modname.endswith(".__init__"):
                    modname = modname[: -len(".__init__")]
                sf = SourceFile(
                    rel, path, modname, source, source.splitlines(), tree
                )
                self.files.append(sf)
                self.by_rel[rel] = sf

    def package_files(self) -> list[SourceFile]:
        return [f for f in self.files if is_package(f.rel)]

    # -- indexes -----------------------------------------------------------

    def _index(self) -> None:
        # module -> {name: FunctionDef/AsyncFunctionDef} (module scope only)
        self.functions: dict[str, dict[str, ast.FunctionDef]] = {}
        # module -> {name: ClassDef}
        self.classes: dict[str, dict[str, ast.ClassDef]] = {}
        # module -> {local alias: dotted target}
        self.imports: dict[str, dict[str, str]] = {}
        for sf in self.files:
            fns: dict[str, ast.FunctionDef] = {}
            classes: dict[str, ast.ClassDef] = {}
            imports: dict[str, str] = {}
            for node in sf.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fns[node.name] = node
                elif isinstance(node, ast.ClassDef):
                    classes[node.name] = node
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        imports[a.asname or a.name.split(".")[0]] = a.name
                elif isinstance(node, ast.ImportFrom) and node.module:
                    for a in node.names:
                        imports[a.asname or a.name] = (
                            f"{node.module}.{a.name}"
                        )
            self.functions[sf.modname] = fns
            self.classes[sf.modname] = classes
            self.imports[sf.modname] = imports

    def module_file(self, modname: str) -> SourceFile | None:
        for sf in self.files:
            if sf.modname == modname:
                return sf
        return None

    def resolve_function(
        self, modname: str, name: str
    ) -> tuple[str, ast.FunctionDef] | None:
        """A name used in `modname` -> (defining module, FunctionDef),
        following one level of from-imports inside the repo."""
        fn = self.functions.get(modname, {}).get(name)
        if fn is not None:
            return (modname, fn)
        target = self.imports.get(modname, {}).get(name)
        if target and "." in target:
            src_mod, _, src_name = target.rpartition(".")
            fn = self.functions.get(src_mod, {}).get(src_name)
            if fn is not None:
                return (src_mod, fn)
        return None

    def resolve_class(self, modname: str, name: str) -> tuple[str, ast.ClassDef] | None:
        cd = self.classes.get(modname, {}).get(name)
        if cd is not None:
            return (modname, cd)
        target = self.imports.get(modname, {}).get(name)
        if target and "." in target:
            src_mod, _, src_name = target.rpartition(".")
            cd = self.classes.get(src_mod, {}).get(src_name)
            if cd is not None:
                return (src_mod, cd)
        return None

    def alias_targets(self, modname: str) -> dict[str, str]:
        return self.imports.get(modname, {})


# -- suppressions -----------------------------------------------------------

_ALLOW_RE = re.compile(
    r"#\s*mcim-torch:\s*allow\(\s*([a-z0-9_-]+)\s*:\s*([^)]+?)\s*\)"
)
_ALLOW_FILE_RE = re.compile(
    r"#\s*mcim-torch:\s*allow-file\(\s*([a-z0-9_-]+)\s*:\s*([^)]+?)\s*\)"
)


@dataclasses.dataclass
class Suppression:
    file: str
    line: int  # line the comment sits on
    rule: str
    reason: str
    file_wide: bool = False
    used: bool = False


def collect_suppressions(repo: Repo) -> list[Suppression]:
    out: list[Suppression] = []
    for sf in repo.files:
        for i, text in enumerate(sf.lines, 1):
            for m in _ALLOW_FILE_RE.finditer(text):
                out.append(Suppression(sf.rel, i, m.group(1), m.group(2), True))
            for m in _ALLOW_RE.finditer(text):
                out.append(Suppression(sf.rel, i, m.group(1), m.group(2)))
    return out


def _suppresses(s: Suppression, f: Finding, repo: Repo) -> bool:
    if s.file != f.file or s.rule != f.rule:
        return False
    if s.file_wide:
        return True
    if s.line == f.line:
        return True
    # a standalone comment line suppresses the next source line
    if s.line == f.line - 1:
        text = repo.by_rel[s.file].lines[s.line - 1].strip()
        return text.startswith("#")
    return False


# -- driver -----------------------------------------------------------------

rule(
    "parse-error", "core",
    "A .py file in scope does not parse; nothing downstream can be "
    "trusted.",
)
rule(
    "unused-suppression", "core",
    "An `# mcim-torch: allow(...)` pragma no longer suppresses any "
    "finding — delete it (stale waivers hide future regressions).",
)
rule(
    "unknown-suppression", "core",
    "An `# mcim-torch: allow(...)` pragma names a rule id that does not "
    "exist.",
)


def run(
    root: str, families=None, include=in_scope
) -> tuple[list[Finding], Repo]:
    """Run every registered checker over the files `include` keeps (see
    :class:`Repo`); returns unsuppressed findings sorted by (file, line).
    `families` filters which rule families run (core housekeeping always
    runs)."""
    # import the rule modules for their registration side effects
    from mpi_cuda_imagemanipulation_tpu_torch.analysis import (  # noqa: F401
        rules_concurrency,
        rules_obs,
        rules_surface,
        rules_tracer,
    )

    families = set(families) if families else None
    repo = Repo(root, include=include)
    raw: list[Finding] = list(repo.parse_errors)
    for family, fn in _CHECKERS:
        if families and family not in families:
            continue
        raw.extend(fn(repo))

    sups = collect_suppressions(repo)
    kept: list[Finding] = []
    for f in raw:
        hit = None
        for s in sups:
            if _suppresses(s, f, repo):
                hit = s
                break
        if hit is None:
            kept.append(f)
        else:
            hit.used = True
    for s in sups:
        if s.rule not in RULES:
            kept.append(
                make_finding(
                    "unknown-suppression", s.file, s.line,
                    f"suppression names unknown rule {s.rule!r}",
                )
            )
        elif not s.used and (families is None or RULES[s.rule].family in
                             (families | {"core"})):
            kept.append(
                make_finding(
                    "unused-suppression", s.file, s.line,
                    f"allow({s.rule}: {s.reason}) suppresses nothing — "
                    "delete it",
                )
            )
    kept.sort(key=lambda f: (f.file, f.line, f.rule))
    # one finding per (file, line, rule, message)
    seen: set[tuple] = set()
    out = []
    for f in kept:
        if f.key() not in seen:
            seen.add(f.key())
            out.append(f)
    return out, repo


# -- reporters --------------------------------------------------------------


def render_text(findings: list[Finding]) -> str:
    if not findings:
        return "mcim-check: clean (0 findings)\n"
    lines = [
        f"{f.file}:{f.line}: [{f.severity}] {f.rule}: {f.message}"
        for f in findings
    ]
    n_err = sum(1 for f in findings if f.severity == "error")
    lines.append(
        f"mcim-check: {len(findings)} finding(s), {n_err} error(s)"
    )
    return "\n".join(lines) + "\n"


def render_json(findings: list[Finding], repo: Repo) -> str:
    return json.dumps(
        {
            "tool": "mcim-check",
            "root": repo.root,
            "files_analyzed": len(repo.files),
            "rules": {
                r.id: {
                    "family": r.family,
                    "severity": r.severity,
                    "doc": r.doc,
                }
                for r in RULES.values()
            },
            "findings": [dataclasses.asdict(f) for f in findings],
            "counts": {
                "total": len(findings),
                "errors": sum(
                    1 for f in findings if f.severity == "error"
                ),
            },
        },
        indent=2,
        sort_keys=True,
    )
