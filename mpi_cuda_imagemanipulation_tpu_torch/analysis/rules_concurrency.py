"""Concurrency rules — static lock-order graph, blocking-under-lock,
guard-consistency.

The counterpart of the JAX package's ``analysis/rules_concurrency.py``,
with the same three rules over the port's package. The blocking set keeps
the JAX names and adds the torch forms of a device sync: ``synchronize``
(``torch.cuda.synchronize``, ``Event.synchronize``,
``Stream.synchronize``) and the reads that wait for the card, ``.cpu()``,
``.item()`` and ``.tolist()``.

The serving stack is multi-threaded by design (HTTP handler threads →
scheduler thread → engine completion thread → encode pool), and its
invariants were previously enforced only by tests that happened to hit
the right interleaving. This checker builds a conservative static model
of every ``threading.Lock``/``RLock``/``Condition`` in the package:

  * **lock-order-cycle** — a cycle in the "A held while acquiring B"
    graph is a deadlock waiting for the right schedule. Edges are
    collected lexically (nested ``with`` blocks) and interprocedurally
    (lock held at a call site × locks the callee's closure acquires).
  * **lock-blocking-call** — joins, unbounded ``Queue.get``/``.wait``/
    semaphore acquires, ``time.sleep``, device syncs
    (``jax.block_until_ready``/``device_get``, ``torch.cuda.synchronize``,
    ``.cpu()``/``.item()``/``.tolist()``) and network/subprocess
    waits reached while a lock is held stall every other thread that
    needs the lock (the classic way a "fast path" lock becomes a global
    convoy). ``Condition.wait`` on the *held* lock is exempt (it
    releases), as is any wait with a timeout bound.
  * **lock-guard-drift** — an attribute written with no lock held in one
    method while other methods access it under the class's lock is an
    inconsistently-guarded field: either the lock is unnecessary there
    or the lockless write races it.

Model notes (kept deliberately conservative to hold the zero-noise CI
bar): lambdas and nested defs are analyzed *inline* at the point they
appear (right for the ``call_with_retry(lambda: ...)`` idiom; callbacks
deferred to other threads simply inherit an empty held-set from their
enqueue site). Private methods inherit the intersection of their
callers' held locks (``_pop_bucket`` is "called under the lock" without
annotations); public methods and thread targets are entry points with
nothing held. The runtime recorder (analysis/lockcheck.py, armed by
``lockcheck.recording()``) validates this static graph against observed
acquisition orders in the threaded tests.
"""

from __future__ import annotations

import ast
import dataclasses

from mpi_cuda_imagemanipulation_tpu_torch.analysis.core import (
    Repo,
    SourceFile,
    checker,
    make_finding,
    rule,
)

rule(
    "lock-order-cycle", "concurrency",
    "Cycle in the static lock-order graph (lock A held while acquiring "
    "B and vice versa on some path) — a deadlock under the right "
    "interleaving.",
)
rule(
    "lock-blocking-call", "concurrency",
    "A blocking call (join / unbounded Queue.get / .wait / semaphore "
    "acquire / sleep / device sync (synchronize, .cpu(), .item(), "
    ".tolist()) / subprocess) reached while holding a lock — every "
    "thread needing that lock convoys behind it.",
)
rule(
    "lock-guard-drift", "concurrency",
    "Attribute written with no lock held while other methods access it "
    "under the class lock — inconsistently guarded shared state.",
)

_LOCK_TYPES = {"threading.Lock", "threading.RLock", "threading.Condition"}
_SEM_TYPES = {"threading.Semaphore", "threading.BoundedSemaphore"}
_QUEUE_TYPES = {"queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
                "queue.PriorityQueue"}

# attribute-call names that block regardless of receiver type: the JAX
# package's set, then the torch forms of a device sync
_ALWAYS_BLOCKING_ATTRS = {
    "block_until_ready", "device_get", "serve_forever", "communicate",
    "urlopen", "accept", "sleep",
    "synchronize", "cpu", "item", "tolist",
}
_BLOCKING_FUNCS = {"sleep", "urlopen"}  # time.sleep / urllib urlopen


# -- small helpers ----------------------------------------------------------


def _dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """`threading.Lock` / `q.Queue` -> canonical dotted path, resolving
    the module alias through the import map."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(aliases.get(cur.id, cur.id))
        return ".".join(reversed(parts))
    return None


def _kw(call: ast.Call, name: str) -> ast.expr | None:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


LockId = tuple  # ("attr", mod, cls, name) | ("global", mod, name)


def _lock_str(lid: LockId) -> str:
    if lid[0] == "attr":
        return f"{lid[1]}.{lid[2]}.{lid[3]}"
    return f"{lid[1]}.{lid[2]}"


@dataclasses.dataclass
class MethodFacts:
    key: tuple  # ("method", mod, cls, name) | ("func", mod, name)
    sf: SourceFile
    acquisitions: list = dataclasses.field(default_factory=list)  # (lock, held, line)
    blocking: list = dataclasses.field(default_factory=list)  # (desc, held, line)
    writes: list = dataclasses.field(default_factory=list)  # (attr, held, line)
    accesses: list = dataclasses.field(default_factory=list)  # (attr, held, line)
    calls: list = dataclasses.field(default_factory=list)  # (callee_key, held, line, label)
    is_entry: bool = False


class _ClassInfo:
    def __init__(self, mod: str, name: str, node: ast.ClassDef):
        self.mod = mod
        self.name = name
        self.node = node
        self.attr_types: dict[str, object] = {}  # attr -> dotted str | ("class", mod, name)
        self.lock_attrs: set[str] = set()
        self.sem_attrs: set[str] = set()


def _infer_value_type(
    value: ast.expr, sf: SourceFile, repo: Repo, params: dict[str, str]
):
    """Type token for `self.X = <value>`: a dotted external path, a
    ("class", mod, name) repo class, or None."""
    if isinstance(value, ast.BoolOp):  # `metrics or ServeMetrics()`
        for v in value.values:
            t = _infer_value_type(v, sf, repo, params)
            if t is not None:
                return t
        return None
    if isinstance(value, ast.Call):
        dotted = _dotted(value.func, repo.alias_targets(sf.modname))
        if dotted is None:
            return None
        head = dotted.split(".")[-1]
        resolved = repo.resolve_class(sf.modname, head)
        if resolved is not None and (
            dotted == head or dotted.endswith("." + head)
        ):
            return ("class", resolved[0], resolved[1].name)
        return dotted
    if isinstance(value, ast.Name):
        ann = params.get(value.id)
        if ann:
            resolved = repo.resolve_class(sf.modname, ann)
            if resolved is not None:
                return ("class", resolved[0], resolved[1].name)
            return ann
    return None


def _collect_class_info(repo: Repo) -> dict[tuple, _ClassInfo]:
    infos: dict[tuple, _ClassInfo] = {}
    for sf in repo.package_files():
        for cname, cnode in repo.classes.get(sf.modname, {}).items():
            ci = _ClassInfo(sf.modname, cname, cnode)
            for meth in cnode.body:
                if not isinstance(meth, ast.FunctionDef):
                    continue
                params: dict[str, str] = {}
                for a in meth.args.args + meth.args.kwonlyargs:
                    if a.annotation is not None:
                        ann = a.annotation
                        if isinstance(ann, ast.BinOp):  # `X | None`
                            ann = ann.left
                        if isinstance(ann, ast.Name):
                            params[a.arg] = ann.id
                for node in ast.walk(meth):
                    if not isinstance(node, ast.Assign):
                        continue
                    for tgt in node.targets:
                        if (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                        ):
                            t = _infer_value_type(
                                node.value, sf, repo, params
                            )
                            if t is not None:
                                ci.attr_types.setdefault(tgt.attr, t)
                            if t in _LOCK_TYPES:
                                ci.lock_attrs.add(tgt.attr)
                            elif t in _SEM_TYPES:
                                ci.sem_attrs.add(tgt.attr)
            infos[(sf.modname, cname)] = ci
    return infos


def _module_locks(repo: Repo) -> dict[tuple, set[str]]:
    """(mod,) -> names of module-level lock globals."""
    out: dict[tuple, set[str]] = {}
    for sf in repo.package_files():
        names: set[str] = set()
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                dotted = _dotted(
                    node.value.func, repo.alias_targets(sf.modname)
                )
                if dotted in _LOCK_TYPES:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            names.add(tgt.id)
        out[(sf.modname,)] = names
    return out


# -- per-function fact collection -------------------------------------------


class _Walker:
    def __init__(
        self,
        repo: Repo,
        sf: SourceFile,
        facts: MethodFacts,
        cls: _ClassInfo | None,
        mod_locks: set[str],
        infos: dict[tuple, _ClassInfo],
    ):
        self.repo = repo
        self.sf = sf
        self.facts = facts
        self.cls = cls
        self.mod_locks = mod_locks
        self.infos = infos
        self.aliases = repo.alias_targets(sf.modname)

    # lock identity of a with-item / receiver expression, or None
    def lock_of(self, expr: ast.expr) -> LockId | None:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self.cls is not None
            and expr.attr in self.cls.lock_attrs
        ):
            return ("attr", self.cls.mod, self.cls.name, expr.attr)
        if isinstance(expr, ast.Name) and expr.id in self.mod_locks:
            return ("global", self.sf.modname, expr.id)
        return None

    def _attr_type(self, expr: ast.expr):
        """Type token of `self.X` receivers."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self.cls is not None
        ):
            return self.cls.attr_types.get(expr.attr)
        return None

    def walk(self, body: list[ast.stmt], held: tuple) -> None:
        for stmt in body:
            self.stmt(stmt, held)

    def stmt(self, node: ast.stmt, held: tuple) -> None:
        if isinstance(node, ast.With):
            inner = list(held)
            for item in node.items:
                lid = self.lock_of(item.context_expr)
                if lid is not None:
                    self.facts.acquisitions.append(
                        (lid, tuple(inner), item.context_expr.lineno)
                    )
                    inner.append(lid)
                else:
                    self.expr(item.context_expr, tuple(inner))
            self.walk(node.body, tuple(inner))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs analyzed inline (call_with_retry-style helpers)
            self.walk(node.body, held)
            return
        if isinstance(node, ast.ClassDef):
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            for tgt in targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    self.facts.writes.append((tgt.attr, held, tgt.lineno))
                    self.facts.accesses.append((tgt.attr, held, tgt.lineno))
            if isinstance(node, ast.AugAssign) or node.value is not None:
                self.expr(node.value, held)
            return
        # generic statement: visit child statements with the same held
        # set, expressions through expr()
        for field in ast.iter_fields(node):
            val = field[1]
            items = val if isinstance(val, list) else [val]
            for it in items:
                if isinstance(it, ast.stmt):
                    self.stmt(it, held)
                elif isinstance(it, ast.expr):
                    self.expr(it, held)

    def expr(self, node: ast.expr | None, held: tuple) -> None:
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Lambda):
                # inline heuristic: the lambda body runs where it appears
                self.expr(sub.body, held)
            elif isinstance(sub, ast.Call):
                self.call(sub, held)
            elif (
                isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "self"
                and isinstance(sub.ctx, ast.Load)
            ):
                self.facts.accesses.append((sub.attr, held, sub.lineno))

    # -- call classification ------------------------------------------------

    def call(self, node: ast.Call, held: tuple) -> None:
        fn = node.func
        line = node.lineno
        # entry marking: `self.M` passed as an argument (thread target,
        # pool submit, callback) — handled in the pass driver via accesses
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            name = fn.attr
            rtype = self._attr_type(recv)
            rlock = self.lock_of(recv)
            timeout_bounded = bool(node.args) or any(
                k.arg in ("timeout",) for k in node.keywords
            )
            if name in _ALWAYS_BLOCKING_ATTRS:
                self.facts.blocking.append((f".{name}()", held, line))
            elif name == "join" and self._threadlike(recv, rtype):
                if not timeout_bounded:
                    self.facts.blocking.append((".join()", held, line))
            elif name in ("get", "put") and (
                rtype in _QUEUE_TYPES
            ):
                if not timeout_bounded and not any(
                    k.arg == "block" for k in node.keywords
                ):
                    self.facts.blocking.append(
                        (f"Queue.{name}() without timeout", held, line)
                    )
            elif name == "acquire" and (
                rtype in _SEM_TYPES or rlock is not None
            ):
                nonblocking = any(
                    isinstance(a, ast.Constant) and a.value is False
                    for a in node.args
                ) or any(
                    k.arg in ("blocking", "timeout") for k in node.keywords
                )
                if not nonblocking:
                    if rlock is not None:
                        self.facts.acquisitions.append((rlock, held, line))
                    else:
                        self.facts.blocking.append(
                            ("semaphore .acquire()", held, line)
                        )
            elif name == "wait":
                # Condition.wait on the HELD lock releases it: exempt.
                if rlock is not None and rlock in held:
                    pass
                elif not timeout_bounded and not isinstance(
                    recv, ast.Constant
                ):
                    self.facts.blocking.append(
                        (".wait() without timeout", held, line)
                    )
            elif name == "result" and not timeout_bounded:
                self.facts.blocking.append((".result()", held, line))
            # method-call resolution for interprocedural propagation
            if isinstance(recv, ast.Name) and recv.id == "self" and self.cls:
                self.facts.calls.append(
                    (
                        ("method", self.cls.mod, self.cls.name, name),
                        held, line, f"self.{name}",
                    )
                )
            elif isinstance(rtype, tuple) and rtype[0] == "class":
                self.facts.calls.append(
                    (
                        ("method", rtype[1], rtype[2], name),
                        held, line,
                        f"{rtype[2]}.{name}",
                    )
                )
            else:
                dotted = _dotted(fn, self.aliases)
                if dotted and "." in dotted:
                    mod, _, fname = dotted.rpartition(".")
                    resolved = self.repo.resolve_function(mod, fname)
                    if resolved is None and mod in self.repo.functions:
                        resolved = (
                            (mod, self.repo.functions[mod][fname])
                            if fname in self.repo.functions[mod]
                            else None
                        )
                    if resolved is not None:
                        self.facts.calls.append(
                            (
                                ("func", resolved[0], resolved[1].name),
                                held, line, dotted,
                            )
                        )
        elif isinstance(fn, ast.Name):
            if fn.id in _BLOCKING_FUNCS:
                self.facts.blocking.append((f"{fn.id}()", held, line))
            resolved = self.repo.resolve_function(self.sf.modname, fn.id)
            if resolved is not None:
                self.facts.calls.append(
                    (("func", resolved[0], resolved[1].name), held, line,
                     fn.id)
                )

    @staticmethod
    def _threadlike(recv: ast.expr, rtype) -> bool:
        if rtype in ("threading.Thread",):
            return True
        text = ""
        if isinstance(recv, ast.Attribute):
            text = recv.attr
        elif isinstance(recv, ast.Name):
            text = recv.id
        text = text.lower()
        return any(t in text for t in ("thread", "proc", "worker"))


# -- the pass ---------------------------------------------------------------


def build_model(repo: Repo):
    """Collect facts + run the interprocedural fixpoints; returns
    (facts_by_key, edges) where edges is
    {(lock_a, lock_b): (file, line, via)}."""
    infos = _collect_class_info(repo)
    mod_locks = _module_locks(repo)
    facts: dict[tuple, MethodFacts] = {}
    referenced_methods: set[tuple] = set()

    for sf in repo.package_files():
        locks_here = mod_locks.get((sf.modname,), set())
        # module-level functions
        for fname, fnode in repo.functions.get(sf.modname, {}).items():
            key = ("func", sf.modname, fname)
            mf = MethodFacts(key, sf, is_entry=True)
            _Walker(repo, sf, mf, None, locks_here, infos).walk(
                fnode.body, ()
            )
            facts[key] = mf
        # methods
        for cname, cnode in repo.classes.get(sf.modname, {}).items():
            ci = infos[(sf.modname, cname)]
            for meth in cnode.body:
                if not isinstance(meth, ast.FunctionDef):
                    continue
                key = ("method", sf.modname, cname, meth.name)
                is_entry = (
                    not meth.name.startswith("_")
                    or meth.name.startswith("__")
                )
                mf = MethodFacts(key, sf, is_entry=is_entry)
                _Walker(repo, sf, mf, ci, locks_here, infos).walk(
                    meth.body, ()
                )
                facts[key] = mf

    # `self.M` referenced without a call (thread target, pool submit,
    # callback argument) => treat M as an entry point (nothing held)
    for sf in repo.package_files():
        for cname, cnode in repo.classes.get(sf.modname, {}).items():
            for node in ast.walk(cnode):
                if (
                    isinstance(node, ast.Call)
                ):
                    for a in list(node.args) + [
                        k.value for k in node.keywords
                    ]:
                        if (
                            isinstance(a, ast.Attribute)
                            and isinstance(a.value, ast.Name)
                            and a.value.id == "self"
                        ):
                            referenced_methods.add(
                                ("method", sf.modname, cname, a.attr)
                            )
    for key in referenced_methods:
        if key in facts:
            facts[key].is_entry = True

    # ---- fixpoint: body-context (locks held around the whole body) -------
    body_held: dict[tuple, tuple | None] = {}
    for key, mf in facts.items():
        body_held[key] = () if mf.is_entry else None
    for _ in range(4):
        changed = False
        incoming: dict[tuple, list[frozenset]] = {}
        for key, mf in facts.items():
            base = body_held[key]
            base_set = set(base) if base else set()
            for callee, held, _line, _lbl in mf.calls:
                if callee in facts:
                    incoming.setdefault(callee, []).append(
                        frozenset(base_set | set(held))
                    )
        for key, mf in facts.items():
            if mf.is_entry:
                continue
            sites = incoming.get(key)
            if not sites:
                continue
            inter = frozenset.intersection(*sites)
            new = tuple(sorted(inter, key=str))
            if body_held[key] is None or set(new) != set(body_held[key]):
                body_held[key] = new
                changed = True
        if not changed:
            break

    def eff(key: tuple, held: tuple) -> tuple:
        base = body_held.get(key)
        return tuple(sorted(set(held) | set(base or ()), key=str))

    # ---- closure: locks a callee may acquire, blocking witnesses ----------
    acq_closure: dict[tuple, set] = {}
    block_witness: dict[tuple, str | None] = {}
    for key, mf in facts.items():
        acq_closure[key] = {lid for lid, _h, _l in mf.acquisitions}
        block_witness[key] = mf.blocking[0][0] if mf.blocking else None
    for _ in range(6):
        changed = False
        for key, mf in facts.items():
            for callee, _held, _line, lbl in mf.calls:
                if callee not in facts:
                    continue
                if not acq_closure[callee] <= acq_closure[key]:
                    acq_closure[key] |= acq_closure[callee]
                    changed = True
                if block_witness[key] is None and block_witness[callee]:
                    block_witness[key] = (
                        f"{lbl}() -> {block_witness[callee]}"
                    )
                    changed = True
        if not changed:
            break

    # ---- edges ------------------------------------------------------------
    edges: dict[tuple, tuple] = {}
    for key, mf in facts.items():
        for lid, held, line in mf.acquisitions:
            for h in eff(key, held):
                if h != lid:
                    edges.setdefault(
                        (h, lid), (mf.sf.rel, line, _key_str(key))
                    )
        for callee, held, line, lbl in mf.calls:
            if callee not in facts:
                continue
            H = eff(key, held)
            if not H:
                continue
            for b in acq_closure[callee]:
                for h in H:
                    if h != b:
                        edges.setdefault(
                            (h, b),
                            (mf.sf.rel, line, f"{_key_str(key)} -> {lbl}"),
                        )
    return facts, body_held, eff, block_witness, edges


def _key_str(key: tuple) -> str:
    return ".".join(key[1:])


def lock_graph(root: str):
    """Public helper for the runtime-validation tests: the port's static
    edge set as {((file_hint, lock_name), (file_hint, lock_name)): via}.
    file_hint is the defining module path."""
    repo = Repo(root)
    _f, _bh, _eff, _bw, edges = build_model(repo)

    def node(lid: LockId):
        mod = lid[1]
        return (mod.replace(".", "/") + ".py", lid[-1])

    return {
        (node(a), node(b)): via for (a, b), via in edges.items()
    }


@checker("concurrency")
def check_concurrency(repo: Repo):
    findings = []
    facts, body_held, eff, block_witness, edges = build_model(repo)

    # -- blocking while a lock is held --------------------------------------
    for key, mf in facts.items():
        for desc, held, line in mf.blocking:
            H = eff(key, held)
            if H:
                findings.append(
                    make_finding(
                        "lock-blocking-call", mf.sf.rel, line,
                        f"{desc} while holding "
                        f"{', '.join(_lock_str(h) for h in H)} "
                        f"(in {_key_str(key)})",
                    )
                )
        for callee, held, line, lbl in mf.calls:
            if callee not in facts:
                continue
            H = eff(key, held)
            w = block_witness.get(callee)
            if H and w:
                findings.append(
                    make_finding(
                        "lock-blocking-call", mf.sf.rel, line,
                        f"call {lbl}() may block ({w}) while holding "
                        f"{', '.join(_lock_str(h) for h in H)}",
                    )
                )

    # -- lock-order cycles ---------------------------------------------------
    graph: dict[LockId, set[LockId]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    seen_cycles: set[frozenset] = set()
    for start in list(graph):
        stack = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            for nxt in graph.get(cur, ()):
                if nxt == start and len(path) > 1:
                    cyc = frozenset(path)
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    file, line, via = edges[(cur, start)]
                    findings.append(
                        make_finding(
                            "lock-order-cycle", file, line,
                            "lock-order cycle: "
                            + " -> ".join(
                                _lock_str(p) for p in path + [start]
                            )
                            + f" (edge via {via})",
                        )
                    )
                elif nxt not in path and len(path) < 6:
                    stack.append((nxt, path + [nxt]))

    # -- guard drift ---------------------------------------------------------
    by_class: dict[tuple, list[tuple]] = {}
    for key, mf in facts.items():
        if key[0] != "method":
            continue
        by_class.setdefault((key[1], key[2]), []).append((key, mf))
    for (mod, cls), members in by_class.items():
        # locked accesses per attr (under a lock of THIS class)
        locked_access: dict[str, tuple] = {}
        for key, mf in members:
            for attr, held, line in mf.accesses:
                for h in eff(key, held):
                    if h[0] == "attr" and h[1] == mod and h[2] == cls:
                        locked_access.setdefault(
                            attr, (key[3], line, h)
                        )
        for key, mf in members:
            if key[3] in ("__init__", "__post_init__"):
                continue
            if body_held.get(key) is None:
                continue  # context unknown: don't guess
            for attr, held, line in mf.writes:
                if eff(key, held):
                    continue
                hit = locked_access.get(attr)
                if hit is not None and hit[0] != key[3]:
                    findings.append(
                        make_finding(
                            "lock-guard-drift", mf.sf.rel, line,
                            f"{cls}.{attr} written with no lock held in "
                            f"{key[3]}() but accessed under "
                            f"{_lock_str(hit[2])} in {hit[0]}()",
                        )
                    )
    return findings
