"""trace-staleness pass: mutable state read under a capture is frozen.

The port bakes decisions in at capture time as the JAX package bakes
them in at trace time: the donated train step and each serving bucket's
forward are captured once into a CUDA graph and replayed, and a replay
runs no Python.  Any MUTABLE Python state read on such a path — an
instance attribute, a rebindable module global, an ``os.environ``
lookup — is frozen into the graph as it was at the capture: mutating it
later silently does nothing.  ``graphs.GraphRunner`` raises
``StaleGraphError`` on a state TENSOR that moved, but it cannot see a
Python value; this pass covers that half.  It is the JAX package's
``op._interpret`` bug class, and the reason ``optim.py`` keeps ``lr``
and ``step`` as tensors on the device.

Entry points (``passes/_entries.py``): functions handed to
``GraphRunner``/``run_eager``, ``with torch.cuda.graph(...)`` bodies,
every op-class ``forward`` and the autograd Functions they apply.
Reachability is the engine's interprocedural
:class:`~..engine.CallGraph` closure.

Codes:

* ``stale-attr-read`` — ``self.X`` is read inside captured code AND
  some code *outside* the captured region, other than the setup phase,
  assigns ``.X``: the writer believes it is reconfiguring the op; the
  replay disagrees.  The setup phase is the construction/compile
  methods (:data:`SETUP_METHODS`) and every helper that only they call
  (``FFModel.compile`` -> ``_resolve_mesh``): ``compile`` drops every
  captured step, so what it writes is the value the next capture
  reads.
* ``stale-global-read`` — a module global read inside captured code is
  rebound somewhere after import time (a function assigns it through
  ``global``): the rebinding no-ops for every already-captured graph.
* ``env-read-in-trace`` — captured code reads ``os.environ``
  (directly, or through a module-level constant whose initializer
  did).  Deliberate per-process A/B knobs get a waiver saying exactly
  that.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import (AnalysisPass, Finding, FunctionIndex, Module,
                      get_callgraph)
from ._entries import capture_blocks, capture_reach

#: writer methods that are construction/compile phase by convention —
#: they run before the first trace, so their assignments are the
#: INITIAL value a trace is supposed to capture, not a later mutation.
SETUP_METHODS = frozenset({
    "__init__", "__post_init__", "__init_subclass__", "__set_name__",
    "setup", "build", "compile", "_build", "_compile", "reset",
    "init_params"})


def _is_env_read(node: ast.AST) -> bool:
    """``os.environ.get(...)`` / ``os.getenv(...)`` / ``environ[...]``
    anywhere inside ``node`` (including the ``__import__("os")``
    spelling — the attribute chain still ends in ``environ``)."""
    for child in ast.walk(node):
        if isinstance(child, ast.Attribute) \
                and child.attr in ("environ", "getenv"):
            return True
        if isinstance(child, ast.Name) and child.id == "getenv":
            return True
    return False


class TraceStalenessPass(AnalysisPass):
    name = "trace-staleness"
    description = ("mutable state (self attrs, rebindable globals, "
                   "os.environ) must not be read inside CUDA-graph-"
                   "captured code — a mutation after the capture "
                   "silently no-ops")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        cg = get_callgraph(modules, index)
        reach = capture_reach(modules, index)
        blocks = capture_blocks(modules, index)
        if not reach and not blocks:
            return []
        setup = self._setup_phase(cg, index)

        # ---- mutation tables over the WHOLE project ------------------
        # attr -> [(classname-or-None wildcard, "path:line")] for every
        # `<expr>.attr = ...` outside setup methods and outside the
        # traced region (a write inside the trace is a different bug)
        attr_writers: Dict[str, List[Tuple[Optional[str], str]]] = {}
        # (module name, global name) -> "path:line" for `global X` +
        # assignment rebinds
        global_rebinds: Dict[Tuple[str, str], str] = {}
        for node, (mod, qual, cls, _scope) in index.owner.items():
            in_setup = node in setup
            declared_global: Set[str] = {
                n for g in ast.walk(node) if isinstance(g, ast.Global)
                for n in g.names}
            for child in ast.walk(node):
                targets: List[ast.expr] = []
                if isinstance(child, ast.Assign):
                    targets = child.targets
                elif isinstance(child, (ast.AugAssign, ast.AnnAssign)):
                    targets = [child.target]
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        if in_setup or node in reach:
                            continue
                        base_self = isinstance(t.value, ast.Name) \
                            and t.value.id == "self"
                        if not base_self and not t.attr.startswith("_"):
                            # a write through an arbitrary expression
                            # only taints a PRIVATE attr: `op._interpret
                            # = True` is reconfiguring internals (the
                            # PR-6 idiom); `cfg.batch_size = v` through
                            # some other object would otherwise taint
                            # every same-named public field project-wide
                            continue
                        owner = cls if base_self else None
                        attr_writers.setdefault(t.attr, []).append(
                            (owner, f"{mod.relpath}:{t.lineno}"))
                    elif isinstance(t, ast.Name) \
                            and t.id in declared_global:
                        global_rebinds.setdefault(
                            (mod.name, t.id),
                            f"{mod.relpath}:{t.lineno}")

        # module-level globals: which names exist, which are env-derived
        module_globals: Dict[str, Set[str]] = {}
        env_globals: Dict[str, Set[str]] = {}
        for m in modules:
            names: Set[str] = set()
            envs: Set[str] = set()
            for stmt in m.tree.body:
                tgts: List[ast.expr] = []
                value = None
                if isinstance(stmt, ast.Assign):
                    tgts, value = stmt.targets, stmt.value
                elif isinstance(stmt, ast.AnnAssign) \
                        and stmt.value is not None:
                    tgts, value = [stmt.target], stmt.value
                for t in tgts:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                        if value is not None and _is_env_read(value):
                            envs.add(t.id)
            module_globals[m.name] = names
            env_globals[m.name] = envs

        # ---- flag reads inside the captured region -------------------
        regions = [(node, self._own_nodes(node), note)
                   for node, note in reach.items()]
        regions += [(b.fn, b.own_nodes(),
                     f"torch.cuda.graph at line {b.node.lineno}")
                    for b in blocks if b.fn not in reach]
        findings: List[Finding] = []
        for node, nodes, note in regions:
            mod, qual, cls, _scope = index.owner[node]
            local_names = self._locally_bound(node)
            reported: Set[Tuple[str, str]] = set()

            def flag(code: str, line: int, msg: str, key: str,
                     *, _m=mod, _q=qual, _r=reported):
                if (code, key) in _r:
                    return  # one finding per name per function
                _r.add((code, key))
                findings.append(self.finding(_m.relpath, line, code,
                                             msg, detail=_q))

            for expr in nodes:
                if isinstance(expr, ast.Attribute) \
                        and isinstance(expr.ctx, ast.Load) \
                        and isinstance(expr.value, ast.Name) \
                        and expr.value.id == "self":
                    writers = attr_writers.get(expr.attr, ())
                    sites = [s for owner, s in writers
                             if owner is None or owner == cls]
                    if sites:
                        flag("stale-attr-read", expr.lineno,
                             f"self.{expr.attr} is read inside captured "
                             f"{qual} ({note}) but assigned outside the "
                             f"capture at {sites[0]} — the mutation "
                             f"silently no-ops after the capture (a "
                             f"replay runs no Python; the value is "
                             f"frozen into the graph)",
                             expr.attr)
                elif isinstance(expr, ast.Name) \
                        and isinstance(expr.ctx, ast.Load) \
                        and expr.id not in local_names:
                    site = global_rebinds.get((mod.name, expr.id))
                    if site is not None \
                            and expr.id in module_globals.get(mod.name,
                                                              ()):
                        flag("stale-global-read", expr.lineno,
                             f"module global {expr.id} is read inside "
                             f"captured {qual} ({note}) but rebound at "
                             f"{site} — already-captured graphs keep "
                             f"the old value",
                             expr.id)
                    elif expr.id in env_globals.get(mod.name, ()):
                        flag("env-read-in-trace", expr.lineno,
                             f"module constant {expr.id} (env-derived) "
                             f"is read inside captured {qual} ({note}) "
                             f"— flipping the variable after the "
                             f"capture has no effect",
                             expr.id)
                elif (isinstance(expr, ast.Call)
                      and _is_env_read(expr.func)) \
                        or (isinstance(expr, ast.Subscript)
                            and isinstance(expr.ctx, ast.Load)
                            and _is_env_read(expr.value)):
                    flag("env-read-in-trace", expr.lineno,
                         f"os.environ is read inside captured {qual} "
                         f"({note}) — the value is frozen at the "
                         f"capture, env changes after that are ignored",
                         f"environ@{expr.lineno}")
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    @staticmethod
    def _setup_phase(cg, index: FunctionIndex) -> Set[ast.AST]:
        """Functions that run only in the setup phase: the
        :data:`SETUP_METHODS`, and (to a fixed point) every function
        with at least one resolved caller whose callers are all setup
        functions."""
        setup = {n for n, (_m, q, _c, _s) in index.owner.items()
                 if q.split(".")[-1] in SETUP_METHODS}
        callers: Dict[ast.AST, Set[ast.AST]] = {}
        for caller, edges in cg.edges.items():
            for callee, _ln, _nm in edges:
                callers.setdefault(callee, set()).add(caller)
        changed = True
        while changed:
            changed = False
            for n, cs in callers.items():
                if n not in setup and cs <= setup:
                    setup.add(n)
                    changed = True
        return setup

    @staticmethod
    def _own_nodes(fn_node: ast.AST):
        """Descendant nodes excluding nested function/class bodies —
        nested defs are trace-reached (and flagged) in their own
        right, and a class body under a def is another scope."""
        stack = [fn_node]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda,
                                      ast.ClassDef)):
                    continue
                yield child
                stack.append(child)

    @staticmethod
    def _locally_bound(node: ast.AST) -> Set[str]:
        """Names bound inside this function (params, assignments, loop
        targets, withitems, comprehensions) — they shadow globals."""
        out: Set[str] = set()
        args = getattr(node, "args", None)
        if args is not None:
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)):
                out.add(a.arg)
            if args.vararg is not None:
                out.add(args.vararg.arg)
            if args.kwarg is not None:
                out.add(args.kwarg.arg)
        for child in ast.walk(node):
            if isinstance(child, ast.Name) \
                    and isinstance(child.ctx, (ast.Store, ast.Del)):
                out.add(child.id)
            elif isinstance(child, ast.Global):
                out.difference_update(child.names)
        return out
