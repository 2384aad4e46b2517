"""thread-lifecycle pass: background threads must die cleanly on close.

Every subsystem that starts a thread hand-writes the same contract —
``stop()`` signals, swaps the handle, joins with a timeout (watchdog,
SLO monitor, exporter, batcher, enqueuer) — and the last four PRs each
re-asserted it in prose.  This pass machine-checks it on the shared
ctor-site inventory (``_threads.py``):

* ``thread-no-join``   — a class-owned thread (``self.X =
  Thread(...)``, list/comprehension forms included) that the class
  starts but has NO reachable ``.join`` on ``self.X`` (or a local
  alias of it — ``t = self._thread``, the ``t, self._thread =
  self._thread, None`` swap, ``for t in self._threads:``) anywhere on
  the class's close path (methods whose name contains
  close/stop/shutdown/… plus everything they reach);
* ``server-no-close``  — a class-owned ``ThreadingHTTPServer`` whose
  close path lacks ``shutdown()`` + ``server_close()`` (both: shutdown
  stops ``serve_forever``, ``server_close`` releases the socket);
* ``non-daemon-thread`` — a non-daemon thread NOT stored on ``self``
  (a local or inline ctor) in a function with no ``.join`` at all: it
  outlives the function and keeps the interpreter alive with no owner
  to stop it;
* ``blocking-finalizer`` — a ``weakref.finalize`` callback that
  transitively blocks (sleep/wait/IO/device sync, the
  blocking-under-lock classification): finalizers run inside GC at
  arbitrary points, often with arbitrary locks up the stack.

Known limits (docs/analysis.md): threads stashed in tuples/dicts
(``self._epoch = (q, stop, t)``) are invisible to the attr-ownership
check — the non-daemon rule still covers them when they outlive their
function un-joined; module-level singletons (``_global_server``) have
no close path to check; and a join found on ANY reached function
sanctions the attr even if that frame belongs to another class with
the same attribute name (over-approximation on the quiet side).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..engine import (AnalysisPass, Finding, FunctionIndex, Module,
                      get_callgraph, get_value_taint)
from ._threads import ThreadSite, get_thread_sites, own_nodes
from .blocking import BLOCKING_ATTRS, BLOCKING_NAMES, _join_exempt

#: a method whose (underscore-stripped, lowercased) name contains one
#: of these is a close-path entry — the surface `with`/`atexit`/owners
#: call to tear the object down.
CLOSE_TOKENS = ("close", "stop", "shutdown", "terminate", "cancel",
                "drain", "retire", "del", "exit", "join", "finish")

#: how far the close path may delegate before a join stops counting.
CLOSE_DEPTH = 8


def _is_close_name(name: str) -> bool:
    n = name.lower().strip("_")
    return any(tok in n for tok in CLOSE_TOKENS)


def _is_self_attr(node: ast.AST, attr: str) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == attr \
        and isinstance(node.value, ast.Name) and node.value.id == "self"


def _calls_on_attr(fn_node: ast.AST, attr: str) -> Set[str]:
    """Method names invoked on ``self.<attr>`` or a local alias of it
    in this function.  Aliases recognized: ``t = self.attr``, the
    tuple swap ``t, self.attr = self.attr, None``, and ``for t in
    self.attr:`` (the list-of-threads join loop)."""
    aliases: Set[str] = set()
    for node in own_nodes(fn_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, val = node.targets[0], node.value
            if isinstance(tgt, ast.Name) and _is_self_attr(val, attr):
                aliases.add(tgt.id)
            elif isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple):
                for t, v in zip(tgt.elts, val.elts):
                    if isinstance(t, ast.Name) and _is_self_attr(v, attr):
                        aliases.add(t.id)
        elif isinstance(node, ast.For) \
                and isinstance(node.target, ast.Name) \
                and _is_self_attr(node.iter, attr):
            aliases.add(node.target.id)
    called: Set[str] = set()
    for node in own_nodes(fn_node):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            v = node.func.value
            if _is_self_attr(v, attr) \
                    or (isinstance(v, ast.Name) and v.id in aliases):
                called.add(node.func.attr)
    return called


def _blocking_seed(fn_node: ast.AST, _module: Module) -> Set[str]:
    """The blocking calls a function's own body makes — the local
    facts the finalizer check propagates (lock ACQUISITION is not
    blocking here: finalizers may take leaf locks; they must not park
    on I/O or sleeps)."""
    facts: Set[str] = set()
    for call in own_nodes(fn_node):
        if not isinstance(call, ast.Call):
            continue
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id in BLOCKING_NAMES:
            facts.add(f"{fn.id}()")
        elif isinstance(fn, ast.Attribute) and fn.attr in BLOCKING_ATTRS:
            if fn.attr == "join" and _join_exempt(fn):
                continue
            facts.add(f".{fn.attr}()")
    return facts


class ThreadLifecyclePass(AnalysisPass):
    name = "thread-lifecycle"
    description = ("class-owned threads/servers need a reachable "
                   "join/shutdown on the close path; non-daemon "
                   "threads need a join; finalizers must not block")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        sites = get_thread_sites(modules, index)
        cg = get_callgraph(modules, index)
        findings: List[Finding] = []

        # class methods by (module name, class name)
        methods: Dict[tuple, List[ast.AST]] = {}
        for node, (mod, qual, cls, _s) in index.owner.items():
            if cls is not None:
                methods.setdefault((mod.name, cls), []).append(node)

        def close_reach(mod: Module, cls: str) -> List[ast.AST]:
            entries = {
                n: index.owner[n][1]
                for n in methods.get((mod.name, cls), ())
                if _is_close_name(index.owner[n][1].split(".")[-1])}
            reach = cg.reachable(entries, depth=CLOSE_DEPTH)
            return list(reach)

        def class_calls_on(mod: Module, cls: str, attr: str,
                           fns: List[ast.AST]) -> Set[str]:
            called: Set[str] = set()
            for fn in fns:
                called |= _calls_on_attr(fn, attr)
            return called

        for s in sites:
            if s.self_attr is None or s.classname is None:
                continue
            all_methods = methods.get((s.module.name, s.classname), [])
            reach = close_reach(s.module, s.classname)
            on_close = class_calls_on(s.module, s.classname,
                                      s.self_attr, reach)
            detail = f"{s.classname}.{s.self_attr}"
            if s.kind == "server":
                missing = {"shutdown", "server_close"} - on_close
                if missing:
                    findings.append(self.finding(
                        s.module.relpath, s.line, "server-no-close",
                        f"self.{s.self_attr} holds a threaded server "
                        f"but {s.classname}'s close path never calls "
                        f"{'/'.join(sorted(missing))} on it — the "
                        f"socket and its handler threads outlive the "
                        f"owner", detail=detail))
                continue
            started = "start" in class_calls_on(
                s.module, s.classname, s.self_attr, all_methods)
            if not started:
                continue  # never started -> nothing to join
            if "join" not in on_close:
                findings.append(self.finding(
                    s.module.relpath, s.line, "thread-no-join",
                    f"self.{s.self_attr} starts a thread but "
                    f"{s.classname} has no reachable .join on it from "
                    f"any close/stop method — the thread outlives (or "
                    f"races) its owner's teardown", detail=detail))

        # local / inline non-daemon threads with no join in scope
        for s in sites:
            if s.kind != "thread" or s.self_attr is not None \
                    or s.daemon:
                continue
            encl = self._enclosing(index, s)
            if encl is not None and self._has_any_join(encl):
                continue
            findings.append(self.finding(
                s.module.relpath, s.line, "non-daemon-thread",
                f"non-daemon thread constructed in {s.qual} with no "
                f".join in the function — it outlives the call and "
                f"keeps the process alive with no owner to stop it",
                detail=s.qual))

        findings.extend(self._finalizers(modules, index))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    @staticmethod
    def _enclosing(index: FunctionIndex,
                   site: ThreadSite) -> Optional[ast.AST]:
        for node, (mod, qual, _cls, _s) in index.owner.items():
            if mod is site.module and qual == site.qual:
                return node
        return None

    @staticmethod
    def _has_any_join(fn_node: ast.AST) -> bool:
        """Coarse sanction: any non-str ``.join(`` in the function —
        joined via a loop variable, a list, or the handle itself."""
        for node in own_nodes(fn_node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" \
                    and not _join_exempt(node.func):
                return True
        return False

    # ---------------------------------------------------------- finalizers
    def _finalizers(self, modules: List[Module],
                    index: FunctionIndex) -> List[Finding]:
        blocks = get_value_taint(modules, index, "blocking-calls",
                                 _blocking_seed)
        out: List[Finding] = []
        for node, (mod, qual, cls, def_scope) in index.owner.items():
            scope = def_scope + (qual.split(".")[-1],)
            for call in own_nodes(node):
                if not isinstance(call, ast.Call):
                    continue
                fn = call.func
                is_fin = (isinstance(fn, ast.Attribute)
                          and fn.attr == "finalize") \
                    or (isinstance(fn, ast.Name) and fn.id == "finalize")
                if not is_fin or len(call.args) < 2:
                    continue
                cb = call.args[1]
                target = None
                if isinstance(cb, ast.Name):
                    target = index.resolve_name(mod, scope, cb.id)
                elif isinstance(cb, ast.Attribute):
                    if isinstance(cb.value, ast.Name) \
                            and cb.value.id == "self" and cls is not None:
                        target = index.resolve_self_method(mod, cls,
                                                           cb.attr)
                    if target is None:
                        target = index.resolve_unique_method(cb.attr)
                if target is None or target not in index.owner:
                    continue
                facts = blocks.get(target, set())
                if not facts:
                    continue
                tqual = index.owner[target][1]
                out.append(self.finding(
                    mod.relpath, call.lineno, "blocking-finalizer",
                    f"weakref.finalize callback {tqual} may block "
                    f"({', '.join(sorted(facts))}) — finalizers run "
                    f"inside GC at arbitrary points; they must stay "
                    f"non-blocking", detail=tqual))
        return out
