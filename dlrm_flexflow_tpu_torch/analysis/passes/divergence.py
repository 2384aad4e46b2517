"""collective-divergence pass: collectives must not hide behind
rank-divergent control flow.

A ``torch.distributed`` collective (``all_reduce``, ``broadcast``,
``gather``/``scatter``, ``barrier``, ``batch_isend_irecv``, ...), a
call into a function that makes one (the ``parallel/collectives.py``
wrappers, ``HostComm.gather/scatter``), or an entry into the podshard
file-barrier protocol is a RENDEZVOUS: every rank of the group must
reach it, in the same order, or the ones that did wait until the
process group's deadline (gloo) or NCCL's watchdog ends them.  The
divergence that causes it is always the same shape: control flow keyed
on a RANK-LOCAL value guarding code that (transitively) performs a
collective.

What is rank-local:

* a "divergent" value comes from ``dist.get_rank()`` (and its
  ``get_local_rank``/``get_global_rank`` kin, ``host_local_batch()``,
  ``os.environ["RANK"]``/``["LOCAL_RANK"]`` reads, and parameters
  conventionally named ``rank``/``pidx``/``process_index``);
* a function whose RETURN value is divergent taints its calls (a fixed
  point over the call graph, so ``is_leader`` -> ``dist.get_rank() ==
  0`` taints every caller).  Unlike the JAX pass, which taints every
  function that merely reaches a source, the port's pass follows the
  value: ``distributed._identity()`` returns ``(rank, world)``, so
  ``rank, world = _identity()`` and ``_identity()[1]`` taint the rank
  only, and ``world > 1`` stays uniform;
* attributes that hold a rank-local value: ``self.rank =
  dist.get_rank()``, ``self.is_owner = mesh.rank == owner``, and
  ``@property`` methods returning one (``is_leader``) — read through
  any object, to a fixed point;
* ``len(...)`` of anything is read as uniform: the size of a rank's
  group is the same on every rank of it.

A collective is a raw ``torch.distributed`` call or a call into a
function that performs one (the engine's shared value-taint machinery,
``engine.get_value_taint``, seeded by ``_spmd.collective_seed``).

Codes:

* ``collective-in-divergent-branch`` — a collective lexically under an
  ``if``/``while``/``for`` whose condition (or iterable) is
  rank-divergent: only some ranks reach the rendezvous.
* ``collective-after-divergent-return`` — a divergent branch returns or
  raises, and a collective follows later in the same function: the
  early-exiting ranks never arrive.

Recognized patterns (silent by design):

* ``dist.get_world_size()`` and a mesh's ``axis_size`` are UNIFORM:
  gating on them gates every rank alike.
* a collective that every rank reaches with rank-dependent ARGUMENTS
  (``dist.scatter(out, parts if self.is_owner else None, ...)``) is
  not divergence: the guard is in an argument, not around the call.
* rank-0 work AFTER the rendezvous (the podshard commit idiom) performs
  no collective under its guard, so nothing fires.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..engine import (AnalysisPass, CallGraph, Finding, FunctionIndex,
                      Module, get_value_taint)
from ._spmd import (cached_own, call_name, collective_seed,
                    get_dist_aliases, own_statements, process_local_names,
                    raw_collective)

#: calls whose RESULT differs across the ranks of one job.
DIVERGENT_SOURCES = frozenset({"get_rank", "get_local_rank",
                               "get_global_rank", "get_node_local_rank",
                               "host_local_batch"})
#: calls whose result is identical on every rank — gating on them is
#: never a divergence.
UNIFORM_SOURCES = frozenset({"get_world_size", "axis_size",
                             "device_count"})
#: environment variables a launcher sets per rank
RANK_ENV = frozenset({"RANK", "LOCAL_RANK", "GROUP_RANK", "NODE_RANK"})
TAINT_KEY = "process-dependent"
COLLECTIVE_KEY = "performs-collective"


def _env_key(node: ast.AST) -> Optional[str]:
    """The constant key of an ``os.environ[...]``/``.get(...)``/
    ``os.getenv(...)`` read, else None."""
    if isinstance(node, ast.Subscript) \
            and isinstance(node.value, ast.Attribute) \
            and node.value.attr == "environ":
        k = node.slice
    elif isinstance(node, ast.Call) and node.args and (
            (isinstance(node.func, ast.Attribute)
             and (node.func.attr == "getenv"
                  or (node.func.attr == "get"
                      and isinstance(node.func.value, ast.Attribute)
                      and node.func.value.attr == "environ")))
            or (isinstance(node.func, ast.Name)
                and node.func.id == "getenv")):
        k = node.args[0]
    else:
        return None
    if isinstance(k, ast.Constant) and isinstance(k.value, str):
        return k.value
    return None


def source_kinds(node: ast.AST) -> Set[str]:
    """"divergent"/"uniform" when this one node is a source."""
    if isinstance(node, ast.Call):
        nm = call_name(node)
        if nm in DIVERGENT_SOURCES:
            return {"divergent"}
        if nm in UNIFORM_SOURCES:
            return {"uniform"}
    if _env_key(node) in RANK_ENV:
        return {"divergent"}
    return set()


def _is_property(fn: ast.AST) -> bool:
    return any((isinstance(d, ast.Name) and d.id == "property")
               or (isinstance(d, ast.Attribute) and d.attr == "property")
               for d in getattr(fn, "decorator_list", ()))


class _RankTaint:
    """Which expressions hold a rank-local value: the per-function
    return verdicts (``True``/``False``, or one per element for a
    function returning an n-tuple literal everywhere) and the divergent
    attribute names, each computed to a fixed point."""

    def __init__(self, index: FunctionIndex, reaches: Dict):
        self.index = index
        self.ret: Dict[ast.AST, object] = {}
        self.attrs: Set[str] = set()
        self._resolved: Dict[int, object] = {}
        # only functions that reach a source can return a divergent
        # value
        cands = [n for n in index.owner
                 if "divergent" in reaches.get(n, ())]
        writers = [n for n in index.owner
                   if any(isinstance(st, ast.Assign)
                          and any(isinstance(t, ast.Attribute)
                                  for t in st.targets)
                          for st in cached_own(index, n))]
        for _ in range(CallGraph.DEFAULT_DEPTH):
            changed = False
            for n in cands:
                v = self._returns(n)
                if v != self.ret.get(n, False):
                    self.ret[n] = v
                    changed = True
            props = {index.owner[n][1].split(".")[-1]
                     for n, v in self.ret.items()
                     if _is_property(n) and self._any(v)}
            for n in writers:
                names = self.names(n)
                for st in cached_own(index, n):
                    if isinstance(st, ast.Assign) and any(
                            isinstance(t, ast.Attribute)
                            for t in st.targets) \
                            and self.expr(st.value, names, n):
                        props.update(t.attr for t in st.targets
                                     if isinstance(t, ast.Attribute))
            if not props <= self.attrs:
                self.attrs |= props
                changed = True
            if not changed:
                break

    @staticmethod
    def _any(v) -> bool:
        return any(v) if isinstance(v, list) else bool(v)

    def _ctx(self, fn: ast.AST):
        mod, qual, cls, scope = self.index.owner[fn]
        return mod, scope + (qual.split(".")[-1],), cls

    def _returns(self, fn: ast.AST):
        rets = [r.value for r in cached_own(self.index, fn)
                if isinstance(r, ast.Return) and r.value is not None]
        if not rets:
            return False
        names = self.names(fn)
        n = len(rets[0].elts) if isinstance(rets[0], ast.Tuple) else 0
        if n and all(isinstance(r, ast.Tuple) and len(r.elts) == n
                     for r in rets):
            return [any(self.expr(r.elts[i], names, fn) for r in rets)
                    for i in range(n)]
        return any(self.expr(r, names, fn) for r in rets)

    def call(self, call: ast.Call, fn: ast.AST):
        """The verdict of a call's return value (bool or per-element
        list), None when unresolved."""
        key = id(call)
        if key in self._resolved:
            t = self._resolved[key]
        else:
            mod, scope, cls = self._ctx(fn)
            t = self._resolved[key] = self.index.resolve_call(
                call, mod, scope, cls)
        return None if t is None else self.ret.get(t, False)

    def expr(self, expr: ast.AST, names: Set[str], fn: ast.AST) -> bool:
        """The expression reads a rank-local value."""
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id == "len":
                return False
            if "divergent" in source_kinds(expr):
                return True
            v = self.call(expr, fn)
            if v is not None and self._any(v):
                return True
        elif isinstance(expr, ast.Subscript) \
                and isinstance(expr.value, ast.Call) \
                and isinstance(expr.slice, ast.Constant) \
                and isinstance(expr.slice.value, int):
            v = self.call(expr.value, fn)
            if isinstance(v, list) and -len(v) <= expr.slice.value < len(v):
                if v[expr.slice.value]:
                    return True
                return any(self.expr(a, names, fn)
                           for a in list(expr.value.args)
                           + [k.value for k in expr.value.keywords])
        elif isinstance(expr, ast.Name):
            return expr.id in names
        elif isinstance(expr, ast.Attribute) and expr.attr in self.attrs \
                and isinstance(expr.ctx, ast.Load):
            return True
        elif "divergent" in source_kinds(expr):
            return True
        if isinstance(expr, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return False
        return any(self.expr(c, names, fn)
                   for c in ast.iter_child_nodes(expr))

    def names(self, fn: ast.AST) -> Set[str]:
        """Local names carrying a rank-local value (the shared
        ``_spmd.process_local_names`` rule with this pass's predicate).
        No kill analysis: a rebind to something uniform keeps the
        taint (conservative)."""

        def split_call(call: ast.Call, n: int):
            v = self.call(call, fn)
            return v if isinstance(v, list) and len(v) == n else None

        return process_local_names(
            fn, lambda e, names: self.expr(e, names, fn),
            split_call=split_call, nodes=cached_own(self.index, fn))


class CollectiveDivergencePass(AnalysisPass):
    name = "collective-divergence"
    description = ("collectives (torch.distributed, their wrappers, the "
                   "podshard fence) must not be reachable only under "
                   "rank-divergent control flow — the multi-rank "
                   "deadlock shape")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        reaches = get_value_taint(
            modules, index, TAINT_KEY,
            lambda n, _m: {k for c in cached_own(index, n)
                           for k in source_kinds(c)})
        collective = get_value_taint(
            modules, index, COLLECTIVE_KEY,
            collective_seed(modules, index))
        aliases = get_dist_aliases(modules, index)
        rank = _RankTaint(index, reaches)

        findings: List[Finding] = []
        for node, (mod, qual, cls, scope) in index.owner.items():
            findings.extend(self._check_function(
                node, mod, qual, cls, scope, index, rank, collective,
                aliases.get(mod.name, set())))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    # ------------------------------------------------------------ per-fn
    def _check_function(self, node, mod: Module, qual: str,
                        cls: Optional[str], scope, index: FunctionIndex,
                        rank: _RankTaint, collective: Dict,
                        aliases: Set[str]) -> List[Finding]:
        call_scope = scope + (qual.split(".")[-1],)
        divergent_names = rank.names(node)

        def expr_divergent(expr: ast.AST) -> bool:
            return rank.expr(expr, divergent_names, node)

        def is_collective(n: ast.Call) -> Optional[str]:
            nm = raw_collective(n, aliases)
            if nm is not None:
                return f"{nm}()"
            target = index.resolve_call(n, mod, call_scope, cls)
            if target is not None \
                    and "collective" in collective.get(target, ()):
                return f"{call_name(n)}() (performs a collective)"
            return None

        def collectives_in(body) -> List:
            """(call, display) for every collective the statements
            perform, directly or through a resolved call.  Nested defs
            excluded (a callback bound under the branch runs later)."""
            out = []
            for stmt in body:
                for n in [stmt] + list(self._own_nodes(stmt)):
                    if isinstance(n, ast.Call):
                        what = is_collective(n)
                        if what is not None:
                            out.append((n, what))
            return out

        findings: List[Finding] = []
        flagged: Set = set()
        flagged_lines: Set[int] = set()
        returning_divergent: List[ast.stmt] = []
        for stmt in cached_own(index, node):
            if isinstance(stmt, (ast.If, ast.While)):
                guard_expr = stmt.test
            elif isinstance(stmt, ast.For):
                guard_expr = stmt.iter
            else:
                continue
            if not expr_divergent(guard_expr):
                continue
            kind = ("loop" if isinstance(stmt, (ast.While, ast.For))
                    else "branch")
            arms = [stmt.body] + ([stmt.orelse] if stmt.orelse else [])
            for arm in arms:
                for call, what in collectives_in(arm):
                    if (call.lineno, call.col_offset) in flagged:
                        continue
                    flagged.add((call.lineno, call.col_offset))
                    flagged_lines.add(call.lineno)
                    findings.append(self.finding(
                        mod.relpath, call.lineno,
                        "collective-in-divergent-branch",
                        f"{what} under a rank-divergent {kind} "
                        f"(line {stmt.lineno}) in {qual} — only some "
                        f"ranks reach this rendezvous; the others wait "
                        f"for them until the group's deadline",
                        detail=qual))
            if isinstance(stmt, ast.If) and any(
                    isinstance(s, (ast.Return, ast.Raise))
                    for s in stmt.body):
                returning_divergent.append(stmt)
        if returning_divergent:
            first = min(returning_divergent, key=lambda s: s.lineno)
            for stmt in cached_own(index, node):
                if getattr(stmt, "lineno", 0) <= first.lineno \
                        or getattr(stmt, "lineno", 0) in flagged_lines:
                    continue
                if not isinstance(stmt, ast.Call):
                    continue
                if is_collective(stmt) is not None:
                    findings.append(self.finding(
                        mod.relpath, stmt.lineno,
                        "collective-after-divergent-return",
                        f"{call_name(stmt)}() runs after the "
                        f"rank-divergent early exit at line "
                        f"{first.lineno} in {qual} — the ranks that "
                        f"left never reach this rendezvous",
                        detail=qual))
        return findings

    # the shared own-body walk (_spmd.own_statements): nested defs are
    # checked in their own right; whether they RUN here is unknowable
    _own_nodes = staticmethod(own_statements)
