"""recompile-hazard pass: a captured graph must be built once and kept.

The port's counterpart of the JAX package's retrace storm is a
RE-CAPTURE storm: every ``graphs.GraphRunner`` captures its function
into a new CUDA graph when it is built (a capture, an instantiation, a
graph pool's memory), so a runner that is not kept, or that is kept
under a key that changes with the data, captures again and again.  The
port's real sites key by shape — ``FFModel._step`` by the batch
signature, ``InferenceEngine._ensure`` by the bucket — and stay silent.
The ways the contract dies are visible in the source; the JAX codes are
kept where the hazard is the same:

* ``jit-per-call`` — ``GraphRunner(f, ...)`` whose runner is kept
  under no signature: invoked at once (``GraphRunner(...).run(x)``),
  or bound to a local name and never stored in a keyed cache or an
  attribute.  Every call captures a new graph.
* ``jit-in-loop`` — a runner built inside a ``for``/``while`` body and
  bound to a plain name that no keyed store keeps: a new capture per
  iteration.  Storing per-key runners into a dict
  (``graphs[b] = GraphRunner(...)``) is the warm-up idiom and stays
  silent.
* ``data-derived-static`` — the key a runner is stored under depends on
  tensor VALUES (``.item()``, ``.tolist()``, a count of ``unique``/
  ``nonzero`` ids, resolved through the function's local assignments):
  each distinct value is a new capture — a storm keyed on traffic.
  Shapes, dtypes and buckets are configuration, not data.
* ``unhashable-static`` — the key is a list/dict/set literal: the store
  raises ``TypeError: unhashable type`` at the first call.
* ``varying-shape-arg`` — a runner's ``run``/``run_locked`` invoked in
  a loop with an input sliced with data-derived bounds
  (``x[lo:min(lo + b, n)]``): the final partial chunk has another
  shape, which the runner refuses (``ValueError``) — pad to a bucket,
  serving's zero-pad contract.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..engine import AnalysisPass, Finding, FunctionIndex, Module

#: the capture owner's constructor
RUNNER_CTORS = frozenset({"GraphRunner"})
#: calls that read tensor values back to the host
VALUE_READS = frozenset({"item", "tolist", "unique", "nonzero",
                         "unique_consecutive", "numpy", "cpu"})
#: a runner's replay entry points
RUN_METHODS = frozenset({"run", "run_locked"})


def _is_runner_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    return name in RUNNER_CTORS


def _value_read(expr: ast.AST) -> Optional[str]:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in VALUE_READS:
            return f".{node.func.attr}()"
    return None


def _unhashable(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(expr, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return "set"
    return None


def _varying_slice(expr: ast.expr) -> bool:
    """A subscript slice whose bounds are data-derived."""
    if not (isinstance(expr, ast.Subscript)
            and isinstance(expr.slice, ast.Slice)):
        return False
    for bound in (expr.slice.lower, expr.slice.upper):
        if bound is None:
            continue
        for node in ast.walk(bound):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name) and f.id in ("min", "max",
                                                        "len"):
                    return True
            if isinstance(node, ast.Attribute) and node.attr == "shape":
                return True
    return False


def _own_walk(fn_node: ast.AST, in_loop: bool = False):
    """``(node, in_loop)`` for this function's own nodes (nested defs
    excluded)."""
    for child in ast.iter_child_nodes(fn_node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        loop = in_loop or isinstance(fn_node, (ast.For, ast.While))
        yield child, loop
        yield from _own_walk(child, loop)


class RecompileHazardPass(AnalysisPass):
    name = "recompile-hazard"
    description = ("CUDA-graph runners must be kept under a shape "
                   "signature: built per call, per loop iteration, or "
                   "keyed on tensor values, each call re-captures")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        findings: List[Finding] = []
        for node, (mod, qual, _cls, _scope) in sorted(
                index.owner.items(),
                key=lambda kv: (kv[1][0].relpath,
                                getattr(kv[0], "lineno", 0))):
            findings.extend(self._check_function(node, mod, qual))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    # ------------------------------------------------------------ per-fn
    def _check_function(self, fn_node: ast.AST, module: Module,
                        qual: str) -> List[Finding]:
        nodes = list(_own_walk(fn_node))
        # local name -> the expressions assigned to it (for key tracing)
        assigned: Dict[str, List[ast.expr]] = {}
        for n, _loop in nodes:
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        assigned.setdefault(t.id, []).append(n.value)
        # names a keyed store or an attribute keeps: `d[k] = name`,
        # `self.x = name`, `d.setdefault(k, name)`
        kept: Set[str] = set()
        # runner-valued local names (built here, or read from a store)
        runners: Set[str] = set()
        stores: List[ast.Assign] = []
        for n, _loop in nodes:
            if isinstance(n, ast.Assign):
                if any(isinstance(t, (ast.Subscript, ast.Attribute))
                       for t in n.targets):
                    if isinstance(n.value, ast.Name):
                        kept.add(n.value.id)
                    if _is_runner_ctor(n.value) or (
                            isinstance(n.value, ast.Name)
                            and any(_is_runner_ctor(v) for v in
                                    assigned.get(n.value.id, ()))):
                        stores.append(n)
                for t in n.targets:
                    if isinstance(t, ast.Name) and (
                            _is_runner_ctor(n.value)
                            or (isinstance(n.value, (ast.Subscript,
                                                     ast.Call))
                                and self._reads_store(n.value))):
                        runners.add(t.id)
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "setdefault" \
                    and len(n.args) == 2 \
                    and isinstance(n.args[1], ast.Name):
                kept.add(n.args[1].id)

        findings: List[Finding] = []
        parents = {id(c): p for p, _l in nodes
                   for c in ast.iter_child_nodes(p)}
        for n, in_loop in nodes:
            if _is_runner_ctor(n):
                parent = parents.get(id(n))
                if isinstance(parent, ast.Attribute) \
                        and parent.attr in RUN_METHODS:
                    findings.append(self.finding(
                        module.relpath, n.lineno, "jit-per-call",
                        f"GraphRunner(...).{parent.attr}() in {qual} — "
                        f"a runner used once and dropped captures a new "
                        f"graph per call; build it once and keep it "
                        f"under its shape signature", detail=qual))
                elif isinstance(parent, ast.Assign) and all(
                        isinstance(t, ast.Name) for t in parent.targets):
                    names = {t.id for t in parent.targets}
                    if names & kept:
                        continue
                    code = "jit-in-loop" if in_loop else "jit-per-call"
                    where = ("every iteration" if in_loop
                             else "every call")
                    findings.append(self.finding(
                        module.relpath, n.lineno, code,
                        f"GraphRunner(...) bound to "
                        f"{sorted(names)[0]!r} in {qual} is kept under "
                        f"no signature — {where} captures a new graph; "
                        f"store it in a cache keyed by shape",
                        detail=qual))
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in RUN_METHODS and in_loop \
                    and self._is_runner(n.func.value, runners):
                for arg in n.args:
                    if any(_varying_slice(e) for e in ast.walk(arg)):
                        findings.append(self.finding(
                            module.relpath, n.lineno,
                            "varying-shape-arg",
                            f"captured runner invoked in a loop in "
                            f"{qual} with a data-derived slice — the "
                            f"final partial chunk has another shape, "
                            f"which the graph refuses; pad to a bucket "
                            f"instead (serving's zero-pad contract)",
                            detail=qual))
        for st in stores:
            for t in st.targets:
                if not isinstance(t, ast.Subscript):
                    continue
                key = t.slice
                uh = _unhashable(key)
                if uh is not None:
                    findings.append(self.finding(
                        module.relpath, st.lineno, "unhashable-static",
                        f"a runner is stored under a {uh} key in {qual} "
                        f"— TypeError at the first call", detail=qual))
                    continue
                why = self._key_reads_values(key, assigned)
                if why is not None:
                    findings.append(self.finding(
                        module.relpath, st.lineno, "data-derived-static",
                        f"a runner is stored under a key derived from "
                        f"{why} in {qual} — every distinct value is a "
                        f"new capture (a re-capture storm keyed on "
                        f"data); key by shape, dtype and bucket",
                        detail=qual))
        return findings

    @staticmethod
    def _reads_store(expr: ast.AST) -> bool:
        """``self._graphs[k]`` / ``self._graphs.get(k)``: a runner read
        from an attribute-held cache."""
        if isinstance(expr, ast.Subscript):
            return isinstance(expr.value, ast.Attribute)
        return isinstance(expr, ast.Call) \
            and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "get" \
            and isinstance(expr.func.value, ast.Attribute)

    @staticmethod
    def _is_runner(expr: ast.AST, runners: Set[str]) -> bool:
        return (isinstance(expr, ast.Name) and expr.id in runners) \
            or _is_runner_ctor(expr)

    @staticmethod
    def _key_reads_values(key: ast.AST,
                          assigned: Dict[str, List[ast.expr]]
                          ) -> Optional[str]:
        """Why the key's value follows tensor values, through local
        assignments (a few hops), or None."""
        seen: Set[str] = set()
        todo = [key]
        while todo:
            e = todo.pop()
            why = _value_read(e)
            if why is not None:
                return why
            for n in ast.walk(e):
                if isinstance(n, ast.Name) and n.id not in seen:
                    seen.add(n.id)
                    todo.extend(assigned.get(n.id, ()))
        return None
