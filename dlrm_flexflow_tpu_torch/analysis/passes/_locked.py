"""The shared lock-held-set walker (docs/analysis.md).

``shared-state`` needed "every ``self.X`` access with the lock set held
at that point"; ``blocking-under-lock`` needs "every call with the lock
set held at that point".  Both are the same walk: carry the set of
resolved lock ids (``locks._LockTable``) through ``with`` items and
INTO resolved callees — the caller's held locks are still held inside
the helper it calls — while skipping deferred bodies (a function/lambda
defined under a lock only binds a name; its body runs later, lock
released).  This module is that walk written once; the passes differ
only in the callback they hand it.

Termination: depth-bounded and cycle-safe via a seen set keyed
``(function, held-frozenset)`` — re-entering a function under a lock
set it was already walked with cannot add facts.  The ``where`` map
carries, per held lock id, a human-readable acquisition site
("``Class.method (path:line)``") so a finding three helper frames below
the ``with`` can still name where the lock came from.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Optional, Set, Tuple

from ..engine import FunctionIndex, Module

#: recursion bound: helper layers, not whole-program (same intent as
#: CallGraph.DEFAULT_DEPTH; shared-state has shipped with 8 since v1).
MAX_DEPTH = 8

#: on_node(node, held, where, (module, qual, classname)) — called for
#: every non-deferred AST node reached, lock context attached.
OnNode = Callable[[ast.AST, frozenset, Dict[str, str],
                   Tuple[Module, str, Optional[str]]], None]


def walk_under_locks(root: ast.AST, index: FunctionIndex, locks,
                     on_node: OnNode, *,
                     inherited: frozenset = frozenset(),
                     where: Optional[Dict[str, str]] = None,
                     seen: Optional[Set[Tuple[ast.AST, frozenset]]] = None,
                     skip_init: bool = False,
                     max_depth: int = MAX_DEPTH) -> None:
    """Walk ``root``'s body (and every resolved callee, held set
    carried) calling ``on_node`` at each node with the locks held
    there.  ``skip_init`` skips ``__init__``/``__new__`` bodies — the
    shared-state contract that construction runs before any thread
    exists; blocking detection keeps them in scope (a constructor can
    take a lock and stall like any other code)."""
    seen = set() if seen is None else seen

    def walk(fn_node: ast.AST, entry_held: frozenset,
             entry_where: Dict[str, str], depth: int) -> None:
        if depth > max_depth or (fn_node, entry_held) in seen \
                or fn_node not in index.owner:
            return
        seen.add((fn_node, entry_held))
        mod, qual, cls, def_scope = index.owner[fn_node]
        if skip_init and qual.split(".")[-1] in ("__init__", "__new__"):
            return
        scope = def_scope + (qual.split(".")[-1],)
        ctx = (mod, qual, cls)

        def visit(node, held: frozenset, where: Dict[str, str]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return  # deferred body: runs later, locks released
            if isinstance(node, ast.With):
                # held set grows PER ITEM (`with a, b:` acquires a
                # then b), exactly like locks.py's order tracking
                cur, cur_where = held, where
                for item in node.items:
                    lid = locks.resolve(item.context_expr, mod, cls)
                    if lid is not None:
                        if lid not in cur:
                            cur_where = dict(cur_where)
                            cur_where[lid] = (
                                f"{qual} ({mod.relpath}:{node.lineno})")
                        cur = cur | {lid}
                    else:
                        visit(item.context_expr, cur, cur_where)
                for stmt in node.body:
                    visit(stmt, cur, cur_where)
                return
            on_node(node, held, where, ctx)
            if isinstance(node, ast.Call):
                target = index.resolve_call(node, mod, scope, cls)
                if target is not None and target is not fn_node:
                    walk(target, held, where, depth + 1)
            for child in ast.iter_child_nodes(node):
                visit(child, held, where)

        for child in ast.iter_child_nodes(fn_node):
            visit(child, entry_held, entry_where)

    walk(root, inherited, dict(where or {}), 0)
