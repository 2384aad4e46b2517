"""Thread/server construction-site discovery shared by the
concurrency passes (docs/analysis.md).

``shared-state``, ``thread-lifecycle``, and ``bounded-growth`` all need
the same inventory: every ``threading.Thread(...)`` and
``ThreadingHTTPServer(...)`` constructor call in the project, who owns
it (enclosing function/class), what it was assigned to (a ``self``
attribute, a local name, or nothing — the inline ``.start()`` idiom),
whether it is a daemon, and — for threads — the resolved ``target=``
function.  This module is that inventory, walked once and cached on
the :class:`~..engine.FunctionIndex` like the call graph and the lock
table, so the three passes agree on what a "background thread" is
instead of re-deriving it three slightly different ways.

Assignment shapes recognized (the ones this codebase actually uses):

* ``self._thread = threading.Thread(...)``        (batcher, watchdog)
* ``self._threads = [Thread(...) for _ in ...]``  (keras enqueuer)
* ``self._srv = ThreadingHTTPServer(...)``        (metrics exporter)
* ``t = threading.Thread(...)``                   (prefetch, router)
* ``threading.Thread(...).start()``               (inline, unnamed)
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..engine import FunctionIndex, Module, iter_calls

#: constructor names that make a background thread / a threaded server.
THREAD_CTORS = frozenset({"Thread"})
SERVER_CTORS = frozenset({"ThreadingHTTPServer", "HTTPServer"})


def _ctor_kind(call: ast.Call) -> Optional[str]:
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    if name in THREAD_CTORS:
        return "thread"
    if name in SERVER_CTORS:
        return "server"
    return None


def _ctor_calls(value: ast.expr) -> List[Tuple[str, ast.Call]]:
    """``(kind, call)`` for every thread/server ctor inside an assigned
    value: the call itself, elements of a List/Tuple literal, or a
    ListComp element (``[Thread(...) for _ in range(n)]``)."""
    cands: List[ast.Call] = []
    if isinstance(value, ast.Call):
        cands = [value]
    elif isinstance(value, (ast.List, ast.Tuple)):
        cands = [e for e in value.elts if isinstance(e, ast.Call)]
    elif isinstance(value, ast.ListComp) \
            and isinstance(value.elt, ast.Call):
        cands = [value.elt]
    out = []
    for c in cands:
        kind = _ctor_kind(c)
        if kind is not None:
            out.append((kind, c))
    return out


def _is_daemon(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


def own_nodes(root: ast.AST):
    """Every AST node belonging to THIS function/module body — nested
    function and lambda bodies excluded (they are owned by their own
    index entry), mirroring :func:`~..engine.iter_calls`."""
    for child in ast.iter_child_nodes(root):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from own_nodes(child)


class ThreadSite:
    """One thread/server constructor call and everything the passes
    need to reason about its lifecycle."""

    __slots__ = ("kind", "call", "line", "module", "qual", "classname",
                 "target", "daemon", "self_attr", "local")

    def __init__(self, kind: str, call: ast.Call, module: Module,
                 qual: str, classname: Optional[str],
                 target: Optional[ast.AST], daemon: bool,
                 self_attr: Optional[str], local: Optional[str]):
        self.kind = kind              # "thread" | "server"
        self.call = call
        self.line = call.lineno
        self.module = module
        self.qual = qual              # enclosing function qualname
        self.classname = classname    # enclosing class, if any
        self.target = target          # resolved target= def node
        self.daemon = daemon
        self.self_attr = self_attr    # "X" for self.X = Thread(...)
        self.local = local            # "t" for t = Thread(...)


def _resolve_target(call: ast.Call, module: Module,
                    index: FunctionIndex, scope: Tuple[str, ...],
                    classname: Optional[str]) -> Optional[ast.AST]:
    """The ``target=`` function of a Thread ctor, resolved the way
    shared-state always has: lexically for bare names, via the
    enclosing class for ``self.m``, by project-wide uniqueness
    otherwise."""
    target = None
    for kw in call.keywords:
        if kw.arg == "target":
            target = kw.value
    if target is None and call.args:
        target = call.args[0]
    if target is None:
        return None
    if isinstance(target, ast.Name):
        return index.resolve_name(module, scope, target.id)
    if isinstance(target, ast.Attribute):
        t = None
        if isinstance(target.value, ast.Name) \
                and target.value.id == "self" and classname is not None:
            t = index.resolve_self_method(module, classname, target.attr)
        if t is None:
            t = index.resolve_unique_method(target.attr)
        return t
    return None


def _sites_in(root: ast.AST, module: Module, index: FunctionIndex,
              qual: str, classname: Optional[str],
              scope: Tuple[str, ...]) -> List[ThreadSite]:
    sites: List[ThreadSite] = []
    claimed: set = set()
    for node in own_nodes(root):
        value = None
        tgt: Optional[ast.expr] = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            value, tgt = node.value, node.targets[0]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            value, tgt = node.value, node.target
        if value is None:
            continue
        self_attr = local = None
        if isinstance(tgt, ast.Attribute) \
                and isinstance(tgt.value, ast.Name) \
                and tgt.value.id == "self":
            self_attr = tgt.attr
        elif isinstance(tgt, ast.Name):
            local = tgt.id
        else:
            continue
        for kind, call in _ctor_calls(value):
            claimed.add(id(call))
            target = _resolve_target(call, module, index, scope,
                                     classname) if kind == "thread" \
                else None
            sites.append(ThreadSite(kind, call, module, qual, classname,
                                    target, _is_daemon(call), self_attr,
                                    local))
    # constructor calls not captured by an assignment (inline
    # `Thread(...).start()`, ctors passed straight to another call)
    for call in iter_calls(root):
        kind = _ctor_kind(call)
        if kind is None or id(call) in claimed:
            continue
        target = _resolve_target(call, module, index, scope,
                                 classname) if kind == "thread" else None
        sites.append(ThreadSite(kind, call, module, qual, classname,
                                target, _is_daemon(call), None, None))
    return sites


def get_thread_sites(modules: List[Module],
                     index: FunctionIndex) -> List[ThreadSite]:
    """Every thread/server ctor site in the project, cached on the
    index — the concurrency passes share one discovery walk."""
    cached = getattr(index, "_thread_sites_cache", None)
    if cached is not None:
        return list(cached)
    sites: List[ThreadSite] = []
    for node, (mod, qual, cls, def_scope) in sorted(
            index.owner.items(),
            key=lambda kv: (kv[1][0].relpath,
                            getattr(kv[0], "lineno", 0))):
        scope = def_scope + (qual.split(".")[-1],)
        sites.extend(_sites_in(node, mod, index, qual, cls, scope))
    for m in modules:
        sites.extend(_sites_in(m.tree, m, index, "<module>", None, ()))
    index._thread_sites_cache = sites
    return list(sites)


def thread_entry_notes(modules: List[Module],
                       index: FunctionIndex) -> Dict[ast.AST, str]:
    """Resolved Thread targets -> a "who starts this" note, the entry
    map the reachability-based passes seed from."""
    entries: Dict[ast.AST, str] = {}
    for s in get_thread_sites(modules, index):
        if s.kind == "thread" and s.target is not None:
            entries.setdefault(
                s.target,
                f"thread target (started in {s.qual} at "
                f"{s.module.relpath}:{s.line})")
    return entries
