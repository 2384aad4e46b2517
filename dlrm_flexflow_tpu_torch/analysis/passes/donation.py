"""donation-safety pass: a donated state is dead after the call.

``FFModel.train_step(state, inputs, labels, donate=True)`` is the port's
counterpart of the JAX package's ``jax.jit(train_step,
donate_argnums=...)``: it updates ``state``'s tensors IN PLACE (the
dense parameters, the tables, the optimizer state, the step) and
returns a state that holds the same tensors.  Where JAX raises on a
donated buffer read after the call, the port reads it silently: the
old ``state`` name now shows the NEW values — a rollback to it restores
nothing, a comparison against it compares the step to itself.  The
serving engine is deliberately donation-free (its captured forward
only reads the parameters) — this pass both proves that (no findings
on ``serving/``) and guards the train path: any call through a
donating callable whose donated argument is a variable that is READ
again afterwards is flagged.

What counts as a donating call:

* ``<x>.train_step(state, ...)`` / ``<x>._train_step(state, ...)`` —
  the state (argument 0) is donated unless ``donate`` (the fourth
  positional argument, or the keyword) is literally ``False``;
* except on a receiver compiled in the same function with
  ``<x>.compile(..., donate_state=False)``, which turns donation off
  for every step of that model.

The "read after the call" check is linear in source order within the
enclosing function: the safe pattern ``state, m = model.train_step(
state, ...)`` (the call's own assignment rebinds the donated name) is
recognized; a later rebinding of the name ends the taint.
Cross-function escapes and reads on earlier lines of a loop body are
out of scope, as in the JAX pass.

Code: ``donated-arg-reuse``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..engine import AnalysisPass, Finding, FunctionIndex, Module

#: the donating step methods, and the position of their ``donate`` flag
DONATING = {"train_step": 3, "_train_step": 3}


def _receiver(call: ast.Call) -> Optional[str]:
    """A dotted spelling of a method call's receiver (``model``,
    ``card.ffmodel``), or None."""
    parts: List[str] = []
    cur = call.func.value if isinstance(call.func, ast.Attribute) else None
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def _is_false(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def _step_donation(call: ast.Call,
                   non_donating: Set[str]) -> Set[int]:
    """``{0}`` when ``call`` is a donating step, else empty."""
    fn = call.func
    if not isinstance(fn, ast.Attribute) or fn.attr not in DONATING:
        return set()
    pos = DONATING[fn.attr]
    flag = call.args[pos] if len(call.args) > pos else None
    for k in call.keywords:
        if k.arg == "donate":
            flag = k.value
    if _is_false(flag):
        return set()
    if _receiver(call) in non_donating:
        return set()
    return {0}


class DonationSafetyPass(AnalysisPass):
    name = "donation-safety"
    description = ("the state donated to train_step (updated in "
                   "place) must not be referenced after the call")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        findings: List[Finding] = []
        for node, (mod, qual, _cls, _scope) in index.owner.items():
            findings.extend(self._check_function(node, mod, qual))
        return findings

    # ------------------------------------------------------------ per-fn
    def _check_function(self, fn_node: ast.AST, module: Module,
                        qual: str) -> List[Finding]:
        # receivers compiled here with donate_state=False
        non_donating: Set[str] = set()
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "compile" \
                    and any(k.arg == "donate_state" and _is_false(k.value)
                            for k in node.keywords):
                r = _receiver(node)
                if r is not None:
                    non_donating.add(r)

        stmts = self._linear_statements(fn_node)
        findings: List[Finding] = []
        for si, (stmt, _branches) in enumerate(stmts):
            for call in self._own_calls_of_stmt(stmt):
                nums = _step_donation(call, non_donating)
                if not nums:
                    continue
                rebound = self._stmt_binds(stmt)
                for i in sorted(nums):
                    if i >= len(call.args):
                        continue
                    arg = call.args[i]
                    if not isinstance(arg, ast.Name):
                        continue
                    if arg.id in rebound:
                        continue  # state = step(state, ...) — safe
                    use = self._read_after(stmts, si, arg.id)
                    if use is not None:
                        cname = self._call_name(call)
                        findings.append(self.finding(
                            module.relpath, use,
                            "donated-arg-reuse",
                            f"`{arg.id}` was donated (argnum {i}) to "
                            f"{cname} at line {call.lineno} and is "
                            f"read again here — the step updated its "
                            f"tensors in place, so it now holds the "
                            f"new values",
                            detail=f"{qual}.{arg.id}"))
        return findings

    @staticmethod
    def _own_calls_of_stmt(stmt: ast.stmt):
        """Calls belonging DIRECTLY to this statement (not to nested
        statements, which get their own linear slot)."""

        def visit(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.stmt, ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda,
                                      ast.ClassDef)):
                    continue
                if isinstance(child, ast.Call):
                    yield child
                yield from visit(child)

        yield from visit(stmt)

    @staticmethod
    def _call_name(call: ast.Call) -> str:
        fn = call.func
        if isinstance(fn, ast.Attribute):
            return f".{fn.attr}()"
        if isinstance(fn, ast.Name):
            return f"{fn.id}()"
        return "<call>()"

    @staticmethod
    def _linear_statements(fn_node: ast.AST
                           ) -> List[Tuple[ast.stmt, tuple]]:
        """``(statement, branch-chain)`` in source order, nested defs
        excluded.  The branch chain records which arm of each enclosing
        ``if`` the statement sits in, so a "read after the call" in the
        MUTUALLY EXCLUSIVE arm is not a finding."""
        out: List[Tuple[ast.stmt, tuple]] = []

        def visit(node, branches: tuple):
            if isinstance(node, ast.If):
                for child in node.body:
                    record(child, branches + ((id(node), "body"),))
                for child in node.orelse:
                    record(child, branches + ((id(node), "orelse"),))
                return
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    record(child, branches)
                elif not isinstance(child, (ast.FunctionDef,
                                            ast.AsyncFunctionDef,
                                            ast.Lambda, ast.ClassDef)):
                    visit(child, branches)

        def record(stmt: ast.stmt, branches: tuple):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            out.append((stmt, branches))
            visit(stmt, branches)

        for child in ast.iter_child_nodes(fn_node):
            if isinstance(child, ast.stmt):
                record(child, ())
            elif not isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.Lambda, ast.ClassDef)):
                visit(child, ())
        out.sort(key=lambda se: (se[0].lineno, se[0].col_offset))
        return out

    @staticmethod
    def _excluded(a: tuple, b: tuple) -> bool:
        """True when the two branch chains sit in different arms of
        the same ``if`` — control flow can reach one or the other,
        never both."""
        da = dict(a)
        return any(da.get(nid) not in (None, arm) for nid, arm in b)

    @staticmethod
    def _stmt_binds(stmt: ast.stmt) -> Set[str]:
        """Names (re)bound by this statement's assignment targets,
        tuple elements included."""
        out: Set[str] = set()
        targets: List[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.For):
            targets = [stmt.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
        return out

    def _read_after(self, stmts: List[Tuple[ast.stmt, tuple]],
                    call_si: int, name: str) -> Optional[int]:
        """Line of the first Load of ``name`` after statement
        ``call_si`` (skipping arms mutually exclusive with the call's),
        stopping at a statement that rebinds it."""
        call_branches = stmts[call_si][1]
        for stmt, branches in stmts[call_si + 1:]:
            if self._excluded(call_branches, branches):
                continue
            # a rebinding statement may also READ the name in its value
            # (x = f(x)) — reads in the value side still count, so scan
            # loads first, then stop if rebound
            for n in self._own_exprs_of_stmt(stmt):
                if isinstance(n, ast.Name) and n.id == name \
                        and isinstance(n.ctx, ast.Load):
                    return n.lineno
            if name in self._stmt_binds(stmt):
                return None
        return None

    @staticmethod
    def _own_exprs_of_stmt(stmt: ast.stmt):
        """Expression nodes directly in this statement (nested
        statements have their own linear slot; nested defs are other
        scopes)."""
        stack = [stmt]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.stmt, ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda,
                                      ast.ClassDef)):
                    continue
                yield child
                stack.append(child)
