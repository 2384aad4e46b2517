"""lock-discipline pass: what may NOT happen while a lock is held.

The serving/telemetry threads (DynamicBatcher dispatcher, client
submit threads, the /metrics scrape threads, GC finalizers) share a
handful of ``threading.Lock``/``RLock`` objects.  The repo's working
convention — earned through review fixes, see serving/batcher.py's
"emit/raise OUTSIDE the lock" comments — is:

* **no telemetry emission under a lock** (``emit-under-lock``): an
  EventLog emit is a schema sweep plus a flushed sink write; doing it
  under ``_intake_lock`` would serialize the dispatcher behind disk
  I/O exactly when shedding peaks;
* **no future completion under a lock** (``future-under-lock``):
  ``set_result``/``set_exception`` wakes a waiter that may immediately
  call back into the subsystem (resubmit, close) and deadlock or
  contend on the very lock still held;
* **consistent pairwise acquisition order** (``lock-order``): if one
  code path takes A then B and another takes B then A, two threads can
  deadlock; the pass builds the acquired-while-holding graph (direct
  nesting AND resolved calls) and flags inverted pairs.

Effects propagate through the engine's interprocedural
:class:`~..engine.CallGraph` fixed point (bounded depth, cycle-safe):
holding a lock while calling a helper whose helper's helper emits is
the same bug as emitting inline, and is flagged at the outermost call
site where the lock is held.  Blocking calls under a lock (sleep,
device syncs, queue waits, file/socket I/O) moved to the dedicated
``blocking-under-lock`` pass (``blocking.py``) in v4 — it reports at
the blocking SITE with the caller's held set carried in, instead of at
the outer call site.

Lock identity: module-level locks are ``<module>.<name>``, instance
locks are ``<Class>.<attr>`` (resolved via the enclosing class, or by
project-wide attribute-name uniqueness); an attribute that matches a
known lock name on several classes degrades to the wildcard ``?.attr``
— wildcard locks still make "a lock is held" true, but are excluded
from order-inversion findings (two ``?._lock``\\ s may be different
objects).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import (PACKAGE, AnalysisPass, Finding, FunctionIndex,
                      Module, get_callgraph)

#: call names that mean "telemetry is being emitted"
EMIT_NAMES = frozenset({"emit", "emit_summary", "sample_memory",
                        "record_span"})
#: attribute calls that complete a future / wake a waiter
FUTURE_NAMES = frozenset({"set_result", "set_exception", "_set",
                          "_set_exception"})


def _short(modname: str) -> str:
    return modname[len(PACKAGE) + 1:] \
        if modname.startswith(PACKAGE + ".") else modname


def _is_lock_ctor(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in ("Lock", "RLock")
    if isinstance(fn, ast.Name):
        return fn.id in ("Lock", "RLock")
    return False


def get_lock_table(modules: List[Module], index: FunctionIndex
                   ) -> "_LockTable":
    """The run's one lock table, cached on the index — lock-discipline
    and shared-state share the discovery walk."""
    table = getattr(index, "_lock_table_cache", None)
    if table is None:
        table = _LockTable(modules)
        index._lock_table_cache = table
    return table


class _LockTable:
    """Every lock the project constructs, by identity scheme."""

    def __init__(self, modules: List[Module]):
        # (module name, var name) -> lock id, for module-level locks
        self.module_locks: Dict[Tuple[str, str], str] = {}
        # attr name -> {(module name, class name)}
        self.attr_classes: Dict[str, Set[Tuple[str, str]]] = {}
        for m in modules:
            for node in ast.iter_child_nodes(m.tree):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call) \
                        and _is_lock_ctor(node.value):
                    name = node.targets[0].id
                    self.module_locks[(m.name, name)] = \
                        f"{_short(m.name)}.{name}"
            for cls in ast.walk(m.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                for node in ast.walk(cls):
                    if isinstance(node, ast.Assign) \
                            and isinstance(node.value, ast.Call) \
                            and _is_lock_ctor(node.value):
                        for t in node.targets:
                            if isinstance(t, ast.Attribute) \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self":
                                self.attr_classes.setdefault(
                                    t.attr, set()).add((m.name, cls.name))

    def resolve(self, expr: ast.expr, module: Module,
                classname: Optional[str]) -> Optional[str]:
        """Lock id for a ``with EXPR:`` item, or None when EXPR is not
        a known lock."""
        if isinstance(expr, ast.Name):
            return self.module_locks.get((module.name, expr.id))
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            owners = self.attr_classes.get(attr)
            if not owners:
                return None
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and classname is not None \
                    and (module.name, classname) in owners:
                return f"{classname}.{attr}"
            if len(owners) == 1:
                (_m, cls), = owners
                return f"{cls}.{attr}"
            return f"?.{attr}"
        return None


class _Effects:
    """What one function does, lock-wise: events recorded with the
    locally-held lock set at that point, locks acquired, resolved
    outgoing calls."""

    def __init__(self):
        # (kind, what, line, held-frozenset)
        self.events: List[Tuple[str, str, int, frozenset]] = []
        # lock id -> first acquisition line
        self.acquires: Dict[str, int] = {}
        # (callee node, display name, line, held-frozenset)
        self.calls: List[Tuple[ast.AST, str, int, frozenset]] = []
        # (outer, inner, line) from directly nested withs
        self.order: List[Tuple[str, str, int]] = []


def _classify_call(call: ast.Call) -> Optional[Tuple[str, str]]:
    """(kind, what) when this call is an emit / future completion,
    else None (blocking calls are the blocking-under-lock pass's
    domain now)."""
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id in EMIT_NAMES:
            return "emit", f"{fn.id}()"
    elif isinstance(fn, ast.Attribute):
        if fn.attr in EMIT_NAMES:
            return "emit", f".{fn.attr}()"
        if fn.attr in FUTURE_NAMES:
            return "future", f".{fn.attr}()"
    return None


class LockDisciplinePass(AnalysisPass):
    name = "lock-discipline"
    description = ("no telemetry emit / future completion while a "
                   "lock is held; consistent pairwise lock order")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        locks = get_lock_table(modules, index)
        effects: Dict[ast.AST, _Effects] = {}
        for node in index.owner:
            effects[node] = self._analyze(node, index, locks)

        findings: List[Finding] = []
        # (outer, inner) -> [(path, line)]
        order: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}

        # interprocedural summaries via the engine's bounded fixed
        # point: each function's events (kind, what) and acquired locks
        # union over everything it can reach, cycle-safe — replacing
        # the old hand-rolled depth-3 recursion so deep helper stacks
        # (and recursion) resolve like any other call
        local: Dict[ast.AST, set] = {}
        for node, eff in effects.items():
            facts = {("evt", k, w) for k, w, _ln, _held in eff.events}
            facts |= {("acq", lid) for lid in eff.acquires}
            local[node] = facts
        summary = get_callgraph(modules, index).propagate(local)

        def transitive(node: ast.AST) -> Tuple[List[Tuple[str, str]],
                                               Set[str]]:
            """(events, acquired locks) of ``node`` and everything it
            reaches; events as (kind, what)."""
            facts = summary.get(node, set())
            evs = sorted((f[1], f[2]) for f in facts if f[0] == "evt")
            acq = {f[1] for f in facts if f[0] == "acq"}
            return evs, acq

        for node, (mod, qual, _cls, _scope) in sorted(
                index.owner.items(),
                key=lambda kv: (kv[1][0].relpath,
                                getattr(kv[0], "lineno", 0))):
            eff = effects[node]
            for outer, inner, line in eff.order:
                order.setdefault((outer, inner), []).append(
                    (mod.relpath, line))
            for kind, what, line, held in eff.events:
                if not held:
                    continue
                lock = sorted(held)[0]
                findings.append(self.finding(
                    mod.relpath, line, f"{kind}-under-lock",
                    f"{what} while {lock} is held in {qual}",
                    detail=qual))
            for callee, cname, line, held in eff.calls:
                sub_evs, sub_acq = transitive(callee)
                for a in sub_acq:
                    for h in held:
                        if h != a:
                            order.setdefault((h, a), []).append(
                                (mod.relpath, line))
                if not held:
                    continue
                lock = sorted(held)[0]
                seen_kinds: Set[str] = set()
                for kind, what in sub_evs:
                    if kind in seen_kinds:
                        continue
                    seen_kinds.add(kind)
                    verb = {"emit": "emits telemetry",
                            "future": "completes a future"}[kind]
                    findings.append(self.finding(
                        mod.relpath, line, f"{kind}-under-lock",
                        f"call to {cname}() {verb} ({what}) while "
                        f"{lock} is held in {qual}",
                        detail=qual))

        # pairwise order inversions (exact-identity locks only)
        reported: Set[Tuple[str, str]] = set()
        for (a, b), sites in sorted(order.items()):
            if a.startswith("?.") or b.startswith("?."):
                continue
            key = (min(a, b), max(a, b))
            if key in reported or (b, a) not in order:
                continue
            reported.add(key)
            rsites = order[(b, a)]
            path, line = sites[0]
            findings.append(Finding(
                self.name, path, line, "lock-order",
                f"inconsistent lock order: {a} -> {b} here but "
                f"{b} -> {a} at {rsites[0][0]}:{rsites[0][1]} — "
                f"two threads taking these in opposite order deadlock",
                detail=f"{key[0]}<->{key[1]}"))
        return findings

    # ------------------------------------------------------------ per-fn
    def _analyze(self, fn_node: ast.AST, index: FunctionIndex,
                 locks: _LockTable) -> _Effects:
        mod, qual, classname, def_scope = index.owner[fn_node]
        scope = def_scope + (qual.split(".")[-1],)
        eff = _Effects()

        def visit(node, held: frozenset):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return  # a def under a lock only binds a name; its
                # body runs later, lock released
            if isinstance(node, ast.With):
                # the held set grows PER ITEM: `with a, b:` acquires a
                # then b, so the a->b order edge must be recorded just
                # like the nested-with spelling
                cur = held
                for item in node.items:
                    lid = locks.resolve(item.context_expr, mod,
                                        classname)
                    if lid is not None:
                        eff.acquires.setdefault(lid, node.lineno)
                        for h in cur:
                            if h != lid:
                                eff.order.append((h, lid, node.lineno))
                        cur = cur | {lid}
                    else:
                        visit(item.context_expr, cur)
                for stmt in node.body:
                    visit(stmt, cur)
                return
            if isinstance(node, ast.Call):
                cls = _classify_call(node)
                if cls is not None:
                    eff.events.append(
                        (cls[0], cls[1], node.lineno, held))
                else:
                    target = index.resolve_call(node, mod, scope,
                                                classname)
                    if target is not None and target is not fn_node:
                        fn = node.func
                        cname = fn.id if isinstance(fn, ast.Name) \
                            else fn.attr
                        eff.calls.append(
                            (target, cname, node.lineno, held))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for child in ast.iter_child_nodes(fn_node):
            visit(child, frozenset())
        return eff
