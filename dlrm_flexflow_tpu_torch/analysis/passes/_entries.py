"""Capture-entry discovery shared by the capture-facing passes.

``trace-purity`` and ``trace-staleness`` agree on what runs under a CUDA
graph capture in the port, the counterpart of the JAX package's "runs
under a tracer":

* a function handed to ``graphs.GraphRunner(fn, ...)`` — the donated
  train step (``FFModel._step_body``) and the serving bucket's forward
  (``InferenceEngine._forward``) — and the same function through
  ``graphs.run_eager(fn, ...)``, the warm-up that runs it once before
  the capture;
* the body of a ``with torch.cuda.graph(...)`` block
  (:func:`capture_blocks`; the block is part of its function, so the
  passes scan its statements and seed the functions it calls);
* every ``forward`` method of an op class (``ops/`` unit): the model
  composes op forwards into its captured step by iterating
  ``self.layers``, an edge no static resolver can see;
* the ``forward``/``backward`` of a ``torch.autograd.Function`` that any
  of those applies — the engine's call graph carries ``Cls.apply(...)``
  edges to both.

A function argument resolves as a bare name (lexically, or through an
import), ``self.method`` in the enclosing class, or a project-unique
``obj.method``.

Two paths the capture walks do not enter (:data:`NOT_CAPTURED`), each
for a reason the code states where it decides:

* the kernels' build: a kernel's first launch builds it (``_cuda.load``
  runs ``nvcc`` and loads the library), and ``GraphRunner``'s contract
  is that its caller ran the function eagerly before the capture
  (``run_eager``), so a capture never reaches the build;
* the host-placed tables (``ops/hetero.py::host_embedding_bag`` and the
  autograd Functions it applies): a model with host tables is never
  captured — ``FFModel._train_step`` steps it eagerly and
  ``InferenceEngine`` turns capture off for it (``_aot``) — because its
  lookup is a host round trip by design.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import PACKAGE, FunctionIndex, Module, iter_calls

#: call names whose first argument is captured (or warmed for a capture)
CAPTURE_CTORS = frozenset({"GraphRunner", "run_eager"})

#: (path, qualname) of functions no capture runs (module docstring):
#: the capture walks do not descend into them
NOT_CAPTURED = frozenset({(f"{PACKAGE}/_cuda.py", "load"),
                          (f"{PACKAGE}/ops/hetero.py",
                           "host_embedding_bag")})


def _callee_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def resolve_fn_arg(arg: ast.AST, module: Module, index: FunctionIndex,
                   scope: Tuple[str, ...],
                   cls: Optional[str]) -> Optional[ast.AST]:
    """The def a function-valued argument names: ``f``, ``self.m`` or a
    project-unique ``obj.m``; None for anything else."""
    if isinstance(arg, ast.Name):
        return index.resolve_name(module, scope, arg.id)
    if isinstance(arg, ast.Attribute):
        if isinstance(arg.value, ast.Name) and arg.value.id == "self" \
                and cls is not None:
            found = index.resolve_self_method(module, cls, arg.attr)
            if found is not None:
                return found
        found = index.resolve_module_attr(module, arg)
        if found is not None:
            return found
        return index.resolve_unique_method(arg.attr)
    return None


def is_capture_with(item: ast.withitem) -> bool:
    """``torch.cuda.graph(...)`` / ``cuda.graph(...)`` as a with item."""
    e = item.context_expr
    return isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
        and e.func.attr == "graph" \
        and isinstance(e.func.value, ast.Attribute) \
        and e.func.value.attr == "cuda"


class CaptureBlock:
    """One ``with torch.cuda.graph(...)`` statement and the function (or
    ``<module>``) it sits in."""

    __slots__ = ("module", "fn", "qual", "cls", "scope", "node")

    def __init__(self, module, fn, qual, cls, scope, node):
        self.module = module
        self.fn = fn
        self.qual = qual
        self.cls = cls
        self.scope = scope
        self.node = node

    def own_nodes(self):
        """Nodes of the block's body, nested defs excluded."""
        stack: List[ast.AST] = list(self.node.body)
        while stack:
            n = stack.pop()
            yield n
            for child in ast.iter_child_nodes(n):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda, ast.ClassDef)):
                    stack.append(child)


def capture_blocks(modules, index: FunctionIndex) -> List[CaptureBlock]:
    """Every ``with torch.cuda.graph(...)`` block, cached on the index."""
    cached = getattr(index, "_capture_blocks_cache", None)
    if cached is not None:
        return list(cached)
    out: List[CaptureBlock] = []
    for node, (mod, qual, cls, def_scope) in index.owner.items():
        scope = def_scope + (qual.split(".")[-1],)
        stack = list(ast.iter_child_nodes(node))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(n, ast.With) and any(is_capture_with(i)
                                               for i in n.items):
                out.append(CaptureBlock(mod, node, qual, cls, scope, n))
            stack.extend(ast.iter_child_nodes(n))
    out.sort(key=lambda b: (b.module.relpath, b.node.lineno))
    index._capture_blocks_cache = out
    return list(out)


def all_capture_entries(modules, index: FunctionIndex
                        ) -> Dict[ast.AST, str]:
    """Every function handed to ``GraphRunner``/``run_eager`` and every
    function a capture block calls, annotated with the site.  One pass
    over the index, cached on it — trace-purity and trace-staleness
    share the discovery."""
    cached = getattr(index, "_capture_entries_cache", None)
    if cached is not None:
        return dict(cached)
    entries: Dict[ast.AST, str] = {}
    for node, (mod, qual, cls, def_scope) in index.owner.items():
        scope = def_scope + (qual.split(".")[-1],)
        for call in iter_calls(node):
            name = _callee_name(call)
            if name not in CAPTURE_CTORS or not call.args:
                continue
            t = resolve_fn_arg(call.args[0], mod, index, scope, cls)
            if t is not None:
                entries.setdefault(
                    t, f"{name} at line {call.lineno} in {mod.relpath}")
    for b in capture_blocks(modules, index):
        for n in b.own_nodes():
            if not isinstance(n, ast.Call):
                continue
            t = index.resolve_call(n, b.module, b.scope, b.cls)
            if t is not None:
                entries.setdefault(
                    t, f"torch.cuda.graph at line {b.node.lineno} in "
                       f"{b.module.relpath}")
    index._capture_entries_cache = entries
    return dict(entries)


def ops_forward_entries(modules, index: FunctionIndex
                        ) -> Dict[ast.AST, str]:
    """Every ``forward`` method of an op class (``ops/`` unit) as a
    capture entry: the model composes op forwards into its captured
    step by iterating ``self.layers``.  An autograd Function's
    ``forward`` is not an op's: it runs where something applies it."""
    entries: Dict[ast.AST, str] = {}
    for node, (mod, qual, cls, _scope) in index.owner.items():
        if cls is not None and qual.endswith(".forward") \
                and mod.top == "ops" and not index.is_autograd(mod, cls):
            entries.setdefault(
                node, f"op forward ({qual}, captured in the model's step)")
    return entries


def not_captured(index: FunctionIndex) -> Set[ast.AST]:
    """The :data:`NOT_CAPTURED` def nodes present in this tree."""
    return {n for n, (m, q, _c, _s) in index.owner.items()
            if (m.relpath, q) in NOT_CAPTURED}


def capture_reach(modules, index: FunctionIndex) -> Dict[ast.AST, str]:
    """Everything the capture entries (op forwards included) reach, the
    :data:`NOT_CAPTURED` functions not entered; cached on the index."""
    cached = getattr(index, "_capture_reach_cache", None)
    if cached is not None:
        return dict(cached)
    from ..engine import get_callgraph
    entries = all_capture_entries(modules, index)
    for n, note in ops_forward_entries(modules, index).items():
        entries.setdefault(n, note)
    reach = get_callgraph(modules, index).reachable(
        entries, follow_nested=True, stop=not_captured(index))
    index._capture_reach_cache = reach
    return dict(reach)
