"""bounded-growth pass: state on long-lived loops must be capped.

Serve/train/monitor loops run for the life of the process; an instance
attribute they append to without a cap is a slow memory leak that no
unit test runs long enough to see (the SLO monitor's flight-record
list was exactly this before v4 capped it).  The pass flags
``self.X.append/extend/add`` and list-typed ``self.X += [...]`` in
methods reachable from the long-lived entry points — thread targets
(the shared ``_threads.py`` inventory), HTTP handler ``do_*`` methods,
and the serve/train surface (``predict``/``submit``/``fit``/
``train_epoch``/...) — unless the class shows bounding evidence for
that attribute.

The sanctioned bounded shapes (and what counts as evidence):

* **ring buffer**   — ``self.X = deque(maxlen=...)`` anywhere in the
  class (the EventLog ring);
* **prune on write** — ``.pop``/``.popleft``/``.popitem``/
  ``.remove``/``.discard``/``.clear`` or ``del self.X[...]`` anywhere
  in the class (drained queues, keep_n retention sweeps);
* **rotate**        — ``self.X = ...`` reassigned OUTSIDE
  ``__init__`` (slice-rebind ``self.X = self.X[-n:]``, swap-out);
* **guarded append** — the growth site sits under an ``if`` whose
  test reads ``len(self.X)`` (the LatencyStats reservoir/top-K
  shape: append below the cap, replace above it).

Numeric counters (``self.n += 1``) never fire: augmented assignment
only counts as growth when the right side is a list literal or
comprehension.  Dict-subscript writes are shared-state's concern, not
growth (a keyed map is usually keyed by a bounded domain; flagging
every ``self._cache[k] =`` would bury the real leaks).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..engine import (AnalysisPass, Finding, FunctionIndex, Module,
                      get_callgraph)
from ._threads import thread_entry_notes

#: growth mutators on self.X
GROW_CALLS = frozenset({"append", "appendleft", "extend", "add"})
#: prune mutators: evidence the class bounds the container
PRUNE_CALLS = frozenset({"pop", "popleft", "popitem", "remove",
                         "discard", "clear"})
#: long-lived entry points by bare method/function name
SERVE_ENTRIES = frozenset({"predict", "submit", "render", "scrape",
                           "handle_request"})
TRAIN_ENTRIES = frozenset({"fit", "resilient_fit", "train_epoch",
                           "train_epochs"})

REACH_DEPTH = 10


def _is_self_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) \
        and isinstance(node.value, ast.Name) and node.value.id == "self"


def _is_handler_class(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else "")
        if "RequestHandler" in name:
            return True
    return False


class _Evidence:
    """Per (module, class): which attrs the class provably bounds."""

    def __init__(self):
        self.ring: Set[str] = set()       # deque(maxlen=...) init
        self.pruned: Set[str] = set()     # pop/del/clear anywhere
        self.rotated: Set[str] = set()    # reassigned outside __init__


def _class_evidence(cls: ast.ClassDef) -> _Evidence:
    ev = _Evidence()
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        in_init = meth.name in ("__init__", "__new__")
        for node in ast.walk(meth):
            value = tgts = None
            if isinstance(node, ast.Assign):
                value, tgts = node.value, node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, tgts = node.value, [node.target]
            if tgts is not None:
                # unpack tuple targets: the drain-swap
                # ``cbs, self._cbs = self._cbs, []`` rebinds the attr
                # and is rotate evidence like any other reassignment
                flat: List[ast.expr] = []
                for t in tgts:
                    flat.extend(t.elts if isinstance(
                        t, (ast.Tuple, ast.List)) else [t])
                for t in flat:
                    if not _is_self_attr(t):
                        continue
                    if isinstance(value, ast.Call):
                        fn = value.func
                        ctor = fn.id if isinstance(fn, ast.Name) else (
                            fn.attr if isinstance(fn, ast.Attribute)
                            else None)
                        has_maxlen = any(kw.arg == "maxlen"
                                         for kw in value.keywords)
                        if ctor == "deque" and has_maxlen:
                            ev.ring.add(t.attr)
                    if not in_init:
                        ev.rotated.add(t.attr)
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) \
                            and _is_self_attr(t.value):
                        ev.pruned.add(t.value.attr)
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Del) \
                    and _is_self_attr(node.value):
                ev.pruned.add(node.value.attr)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in PRUNE_CALLS \
                    and _is_self_attr(node.func.value):
                ev.pruned.add(node.func.value.attr)
    return ev


def _len_guard_attrs(test: ast.expr) -> Set[str]:
    """Attrs X for which ``test`` reads ``len(self.X)`` — the
    reservoir/top-K cap check."""
    out: Set[str] = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "len" and node.args \
                and _is_self_attr(node.args[0]):
            out.add(node.args[0].attr)
    return out


class BoundedGrowthPass(AnalysisPass):
    name = "bounded-growth"
    description = ("self.X.append/+= on serve/train/monitor loops "
                   "needs a cap/prune/rotate on the class (ring, "
                   "top-K, keep_n are the sanctioned shapes)")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        cg = get_callgraph(modules, index)

        entries: Dict[ast.AST, str] = dict(
            thread_entry_notes(modules, index))
        handler_classes: Set[Tuple[str, str]] = set()
        for m in modules:
            for cls in ast.walk(m.tree):
                if isinstance(cls, ast.ClassDef) \
                        and _is_handler_class(cls):
                    handler_classes.add((m.name, cls.name))
        for node, (mod, qual, cls, _s) in index.owner.items():
            name = qual.split(".")[-1]
            if name in SERVE_ENTRIES:
                entries.setdefault(node, f"serve entry {qual}")
            elif name in TRAIN_ENTRIES:
                entries.setdefault(node, f"train entry {qual}")
            elif name.startswith("do_") and cls is not None \
                    and (mod.name, cls) in handler_classes:
                entries.setdefault(node, f"HTTP handler {qual}")
        reach = cg.reachable(entries, depth=REACH_DEPTH)

        evidence: Dict[Tuple[str, str], _Evidence] = {}
        for m in modules:
            for cls in ast.walk(m.tree):
                if isinstance(cls, ast.ClassDef):
                    evidence[(m.name, cls.name)] = _class_evidence(cls)

        findings: List[Finding] = []
        seen: Set[Tuple[str, str, str]] = set()
        for node, note in sorted(
                reach.items(),
                key=lambda kv: (index.owner.get(
                    kv[0], (None, "", None, ()))[1])):
            if node not in index.owner:
                continue
            mod, qual, cls, _s = index.owner[node]
            if cls is None or qual.split(".")[-1] in ("__init__",
                                                      "__new__"):
                continue
            ev = evidence.get((mod.name, cls), _Evidence())
            for site_line, attr in self._growth_sites(node):
                if attr in ev.ring or attr in ev.pruned \
                        or attr in ev.rotated:
                    continue
                key = (mod.relpath, cls, attr)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(self.finding(
                    mod.relpath, site_line, "unbounded-growth",
                    f"self.{attr} grows in {qual} (reached: {note}) "
                    f"with no cap/prune/rotate anywhere on "
                    f"{cls}.{attr} — a long-lived loop leaks it; "
                    f"ring/top-K/keep_n are the sanctioned shapes",
                    detail=f"{cls}.{attr}"))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    @staticmethod
    def _growth_sites(fn_node: ast.AST) -> List[Tuple[int, str]]:
        """(line, attr) of every unguarded growth mutation in this
        function — sites under a ``len(self.X)`` if-test are the
        sanctioned reservoir shape and stay silent."""
        out: List[Tuple[int, str]] = []

        def visit(node, guarded: frozenset):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, ast.If):
                g = guarded | _len_guard_attrs(node.test)
                for child in node.body + node.orelse:
                    visit(child, g)
                return
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in GROW_CALLS \
                    and _is_self_attr(node.func.value) \
                    and node.func.value.attr not in guarded:
                out.append((node.lineno, node.func.value.attr))
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.op, ast.Add) \
                    and _is_self_attr(node.target) \
                    and isinstance(node.value, (ast.List, ast.ListComp)) \
                    and node.target.attr not in guarded:
                out.append((node.lineno, node.target.attr))
            for child in ast.iter_child_nodes(node):
                visit(child, guarded)

        for child in ast.iter_child_nodes(fn_node):
            visit(child, frozenset())
        return out
