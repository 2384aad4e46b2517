"""mesh-axis pass: axis names and raw collectives stay disciplined.

Mesh axes are stringly-typed, and the port's mesh forgives a misspelled
one silently: ``Mesh.axes_key`` drops every axis it does not hold at a
size above one, so ``collectives.psum(x, mesh, ("modell",))`` is the
identity — no error, a wrong sum, on every rank alike.  The discipline
is checkable statically:

* every axis literal handed to a ``parallel/collectives.py`` wrapper
  (its ``axes`` parameter) or to ``Mesh.group/axis_size/axis_index/
  axes_key`` must be an axis the port's meshes declare
  (``_spmd.declared_axes``: the ``*_AXIS`` constants of the parallel
  unit — ``DATA_AXIS``, ``MODEL_AXIS``, ``SEQ_AXIS``, ``PIPE_AXIS`` —
  and ``make_mesh({...})`` literal keys).  Dynamic axes resolve to
  nothing and are skipped — silence over guessing;
* a raw ``torch.distributed`` collective belongs in
  ``parallel/collectives.py`` (the wrappers that give each collective
  its gradient and its mesh group) or ``distributed.py`` (the process
  group's owner): the counterpart of the JAX package's rule that
  ``shard_map`` is spelled only in its ``parallel/mesh.py`` compat
  wrapper.  A raw collective elsewhere bypasses the mesh's groups and
  orders; each one that must exist (a leader's broadcast protocol, the
  host tables' owner gather) is waived with its reason.

The JAX pass's ``collective-outside-spmd`` has no counterpart: a torch
collective takes its group as an argument, so there is no axis
environment for it to be outside of.

Codes: ``undeclared-axis``, ``direct-collective``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..engine import (PACKAGE, AnalysisPass, Finding, FunctionIndex,
                      Module, iter_calls)
from ._spmd import (AXIS_METHODS, WRAPPER_MODULES, declared_axes,
                    get_dist_aliases, get_str_consts, iter_raw_collectives,
                    resolve_str)

#: where the collectives wrappers live (their ``axes`` parameter is the
#: axis set)
COLLECTIVES_MODULE = f"{PACKAGE}.parallel.collectives"


def _axes_arg(call: ast.Call, pos: int) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == "axes":
            return k.value
    return call.args[pos] if len(call.args) > pos else None


def _axis_names(expr: ast.AST, module: Module, per, uniq) -> Set[str]:
    """Axis names an axes expression spells: a resolvable string, or a
    tuple/list of them."""
    parts = (expr.elts if isinstance(expr, (ast.Tuple, ast.List))
             else [expr])
    out: Set[str] = set()
    for p in parts:
        s = resolve_str(p, module, per, uniq)
        if s is not None:
            out.add(s)
    return out


class MeshAxisPass(AnalysisPass):
    name = "mesh-axis"
    description = ("axis names handed to the collectives and the mesh "
                   "are axes the mesh declares; raw torch.distributed "
                   "collectives only in parallel/collectives.py and "
                   "distributed.py")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        findings: List[Finding] = []
        findings.extend(self._direct(modules, index))
        findings.extend(self._axis_discipline(modules, index))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    # --------------------------------------------------- raw collectives
    def _direct(self, modules: List[Module],
                index: FunctionIndex) -> List[Finding]:
        aliases = get_dist_aliases(modules, index)
        out: List[Finding] = []
        for fn, (mod, qual, _cls, _scope) in index.owner.items():
            if mod.relpath in WRAPPER_MODULES:
                continue
            for call, nm in iter_raw_collectives(
                    fn, aliases.get(mod.name, set())):
                out.append(self.finding(
                    mod.relpath, call.lineno, "direct-collective",
                    f"torch.distributed.{nm}() in {qual}, outside "
                    f"parallel/collectives.py and distributed.py — a raw "
                    f"collective bypasses the mesh's groups and the "
                    f"wrappers' gradients; route it through "
                    f"parallel/collectives.py or waive it with the "
                    f"protocol that needs it", detail=qual))
        return out

    # ------------------------------------------------- axis declaration
    def _axis_discipline(self, modules: List[Module],
                         index: FunctionIndex) -> List[Finding]:
        per, uniq = get_str_consts(modules, index)
        declared = declared_axes(modules, index)
        if not declared:
            return []
        out: List[Finding] = []
        for fn, (mod, qual, cls, def_scope) in index.owner.items():
            scope = def_scope + (qual.split(".")[-1],)
            for call in iter_calls(fn):
                expr = self._axes_expr(call, mod, scope, cls, index)
                if expr is None:
                    continue
                for axis in sorted(_axis_names(expr, mod, per, uniq)):
                    if axis in declared:
                        continue
                    what = (call.func.attr
                            if isinstance(call.func, ast.Attribute)
                            else getattr(call.func, "id", "<call>"))
                    out.append(self.finding(
                        mod.relpath, call.lineno, "undeclared-axis",
                        f"{what}() is given axis {axis!r} in {qual}, but "
                        f"the mesh declares only {sorted(declared)} — "
                        f"Mesh.axes_key drops an axis it does not hold, "
                        f"so the collective silently runs over fewer "
                        f"ranks (or none)", detail=qual))
        return out

    @staticmethod
    def _axes_expr(call: ast.Call, mod: Module, scope, cls,
                   index: FunctionIndex) -> Optional[ast.AST]:
        """The axes argument of a wrapper or mesh-method call, else
        None."""
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in AXIS_METHODS:
            # the mesh methods take a sequence of axes; a tuple/list
            # literal is the only spelling that cannot be another API's
            # (a regex ``match.group("name")``)
            expr = _axes_arg(call, 0)
            return expr if isinstance(expr, (ast.Tuple, ast.List)) \
                else None
        target = index.resolve_call(call, mod, scope, cls)
        if target is None:
            return None
        tmod = index.owner[target][0]
        if tmod.name != COLLECTIVES_MODULE:
            return None
        params = [a.arg for a in target.args.args]
        if "axes" not in params:
            return None
        return _axes_arg(call, params.index("axes"))
