"""Tracer rules for the port — use-after-donation.

The counterpart of the JAX package's ``analysis/rules_tracer.py``, of
which only **tracer-use-after-donate** carries over, with the same id and
family. The port donates too: ``Pipeline.jit(donate=True)`` and
``Pipeline.batched(donate=True)`` empty their input with ``x.set_()``
(models/pipeline.py) so that its memory goes back to the allocator, and
reading that tensor again reads an empty tensor, the same bug as a read
of a donated JAX buffer.

The JAX package's other four tracer rules (host casts, ``np.*`` on traced
values, Python control flow on traced values, jit closures that re-key a
compile cache) guard JAX tracing. Eager PyTorch traces nothing: a Python
``if`` on a tensor or ``float(t)`` is legal there (it waits for the card,
which the concurrency rules watch under a lock), so they have no
counterpart here.
"""

from __future__ import annotations

import ast

from mpi_cuda_imagemanipulation_tpu_torch.analysis.core import (
    Repo,
    checker,
    is_package,
    make_finding,
    rule,
)

rule(
    "tracer-use-after-donate", "tracer",
    "A buffer passed to a donate=True callable is read again afterwards "
    "— donation recycles the input's device memory into the output.",
)


@checker("tracer")
def check_tracer(repo: Repo):
    return _check_use_after_donate(repo)


def _check_use_after_donate(repo: Repo) -> list:
    findings = []
    for sf in repo.files:
        # a donating callable is built with a literal donate= keyword
        if not is_package(sf.rel) or "donate" not in sf.source:
            continue
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            donating: set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    call = node.value
                    donates = any(
                        k.arg in ("donate", "donate_argnums")
                        and not (
                            isinstance(k.value, ast.Constant)
                            and k.value.value in (False, None)
                        )
                        for k in call.keywords
                    )
                    if donates:
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                donating.add(tgt.id)
            if not donating:
                continue
            # linear scan: a Name arg passed to a donating callable must
            # not be loaded again later without reassignment
            events: list[tuple[int, str, str]] = []
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in donating
                ):
                    for a in node.args:
                        if isinstance(a, ast.Name):
                            events.append((node.lineno, "donate", a.id))
                elif isinstance(node, ast.Name):
                    kind = (
                        "store"
                        if isinstance(node.ctx, (ast.Store, ast.Del))
                        else "load"
                    )
                    events.append((node.lineno, kind, node.id))
            events.sort()
            for line, kind, name in [e for e in events if e[1] == "donate"]:
                for l2, k2, n2 in events:
                    if n2 != name or l2 <= line:
                        continue
                    if k2 == "store":
                        break
                    if k2 == "load":
                        findings.append(
                            make_finding(
                                "tracer-use-after-donate", sf.rel, l2,
                                f"{name!r} read after being passed to a "
                                f"donate=True callable at line {line} — "
                                "its device buffer was recycled",
                            )
                        )
                        break
    return findings
