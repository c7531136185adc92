"""Surface-drift rules — CLI flags and MCIM_* env vars vs docs/registry.

The counterpart of the JAX package's ``analysis/rules_surface.py``, over
the port's ``cli.py`` and the port's ``utils/env.py`` registry, against
README.md and docs/*.md (the port's flags are documented in the README's
port section).

The user-visible surface (argparse flags, ``MCIM_*`` environment
variables) historically drifted from the docs: a flag would land with a
help string but no README mention, or an env knob would exist only in
the module that read it. These rules pin the surface to two sources of
truth:

  * **surface-flag-undocumented** — every ``--flag`` registered in
    ``cli.py`` must appear in README.md or docs/*.md (suppressed
    argparse.SUPPRESS flags — deprecated aliases — are exempt).
  * **env-unregistered** — every ``MCIM_*`` string literal in the repo
    must name a variable declared in ``utils/env.py``'s registry; a typo
    or an undeclared knob fails here.
  * **env-direct-read** — package modules must read env state through
    ``utils.env.get*`` (the registry), not ``os.environ`` directly, so
    defaults and docs cannot fork per reader. (The package's tools/,
    the port's tests and chip_smoke.py may read os.environ but still only
    registered names.)
  * **env-undocumented** — every registered variable must appear in
    README.md or docs/ (the design.md table is generated from
    ``utils.env.doc_table()``).
  * **env-unused** — a registered variable no source file mentions is
    dead registry weight.
"""

from __future__ import annotations

import ast
import glob
import os
import re

from mpi_cuda_imagemanipulation_tpu_torch.analysis.core import (
    PACKAGE,
    Repo,
    checker,
    is_package,
    make_finding,
    rule,
)

rule(
    "surface-flag-undocumented", "surface",
    "A cli.py --flag is not mentioned in README.md or docs/*.md.",
)
rule(
    "env-unregistered", "surface",
    "An MCIM_* literal is not declared in utils/env.py's registry.",
)
rule(
    "env-direct-read", "surface",
    "A package module reads an MCIM_* var via os.environ instead of "
    "the utils.env registry.",
)
rule(
    "env-undocumented", "surface",
    "A registered MCIM_* variable is not mentioned in README.md or "
    "docs/*.md.",
)
rule(
    "env-unused", "surface",
    "A registered MCIM_* variable is never referenced by any source "
    "file.",
)

_ENV_RE = re.compile(r"^MCIM_[A-Z0-9_]+$")
_ENV_FILE_REL = f"{PACKAGE}/utils/env.py"


def _docs_corpus(root: str) -> str:
    texts = []
    for path in [os.path.join(root, "README.md")] + sorted(
        glob.glob(os.path.join(root, "docs", "*.md"))
    ):
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                texts.append(f.read())
    return "\n".join(texts)


def _registered_vars(repo: Repo) -> set[str]:
    sf = repo.by_rel.get(_ENV_FILE_REL)
    if sf is None:
        return set()
    out: set[str] = set()
    for node in sf.nodes():
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "EnvVar"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            out.add(node.args[0].value)
    return out


@checker("surface")
def check_surface(repo: Repo):
    findings: list = []
    docs = _docs_corpus(repo.root)
    findings.extend(_check_flags(repo, docs))
    findings.extend(_check_env(repo, docs))
    return findings


# -- CLI flags ---------------------------------------------------------------


def _check_flags(repo: Repo, docs: str) -> list:
    findings = []
    sf = repo.by_rel.get(f"{PACKAGE}/cli.py")
    if sf is None:
        return findings
    for node in sf.nodes():
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            and node.args
        ):
            continue
        a0 = node.args[0]
        if not (
            isinstance(a0, ast.Constant)
            and isinstance(a0.value, str)
            and a0.value.startswith("--")
        ):
            continue
        # deprecated/hidden flags (help=argparse.SUPPRESS) are exempt
        hidden = any(
            k.arg == "help"
            and isinstance(k.value, ast.Attribute)
            and k.value.attr == "SUPPRESS"
            for k in node.keywords
        )
        if hidden:
            continue
        flag = a0.value
        if flag not in docs:
            findings.append(
                make_finding(
                    "surface-flag-undocumented", sf.rel, node.lineno,
                    f"flag {flag} is not documented in README.md or "
                    "docs/*.md",
                )
            )
    return findings


# -- env vars ----------------------------------------------------------------


def _env_literals(sf) -> list[tuple[str, int]]:
    out = []
    for node in sf.nodes():
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if _ENV_RE.match(node.value):
                out.append((node.value, node.lineno))
    return out


def _is_environ_read(node: ast.Call, aliases: dict[str, str]) -> bool:
    """os.environ.get(...) / os.getenv(...) with a literal first arg."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr == "get" and isinstance(fn.value, ast.Attribute):
            inner = fn.value
            if inner.attr == "environ" and isinstance(
                inner.value, ast.Name
            ):
                return aliases.get(inner.value.id, inner.value.id) == "os"
        if fn.attr == "getenv" and isinstance(fn.value, ast.Name):
            return aliases.get(fn.value.id, fn.value.id) == "os"
    return False


def _check_env(repo: Repo, docs: str) -> list:
    findings = []
    registered = _registered_vars(repo)
    if not registered:
        findings.append(
            make_finding(
                "env-unregistered", _ENV_FILE_REL, 1,
                "could not parse the EnvVar registry out of "
                "utils/env.py",
            )
        )
        return findings

    mentioned: set[str] = set()
    for sf in repo.files:
        lits = _env_literals(sf)
        for name, line in lits:
            if sf.rel != _ENV_FILE_REL:
                mentioned.add(name)
            if name not in registered and sf.rel != _ENV_FILE_REL:
                findings.append(
                    make_finding(
                        "env-unregistered", sf.rel, line,
                        f"{name} is not declared in utils/env.py — "
                        "register it (name, default, consumer, doc)",
                    )
                )
        # direct os.environ reads of MCIM literals inside the package
        if is_package(sf.rel) and sf.rel != _ENV_FILE_REL:
            aliases = repo.alias_targets(sf.modname)
            for node in sf.nodes():
                if (
                    isinstance(node, ast.Call)
                    and _is_environ_read(node, aliases)
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _ENV_RE.match(node.args[0].value)
                ):
                    findings.append(
                        make_finding(
                            "env-direct-read", sf.rel, node.lineno,
                            f"read {node.args[0].value} via utils.env "
                            "(the registry carries its default and doc), "
                            "not os.environ",
                        )
                    )
                elif (
                    isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "environ"
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)
                    and _ENV_RE.match(node.slice.value)
                ):
                    findings.append(
                        make_finding(
                            "env-direct-read", sf.rel, node.lineno,
                            f"read {node.slice.value} via utils.env, "
                            "not os.environ[...]",
                        )
                    )

    # non-python mentions in the package count for usage (shell lanes)
    extra_mention = set()
    for pattern in ("*.yml", "*.yaml", "*.sh"):
        for path in glob.glob(
            os.path.join(repo.root, PACKAGE, "**", pattern), recursive=True
        ):
            if any(
                part in path
                for part in (".git", "__pycache__", "artifacts")
            ):
                continue
            try:
                with open(path, encoding="utf-8") as f:
                    text = f.read()
            except OSError:
                continue
            extra_mention.update(re.findall(r"MCIM_[A-Z0-9_]+", text))

    env_sf = repo.by_rel[_ENV_FILE_REL]
    reg_lines = {
        name: line for name, line in _env_literals(env_sf)
    }
    for name in sorted(registered):
        if name not in docs:
            findings.append(
                make_finding(
                    "env-undocumented", _ENV_FILE_REL,
                    reg_lines.get(name, 1),
                    f"{name} is registered but not mentioned in "
                    "README.md or docs/*.md (regenerate the design.md "
                    "table from utils.env.doc_table())",
                )
            )
        if name not in mentioned and name not in extra_mention:
            findings.append(
                make_finding(
                    "env-unused", _ENV_FILE_REL, reg_lines.get(name, 1),
                    f"{name} is registered but never referenced by any "
                    "source file",
                )
            )
    return findings
