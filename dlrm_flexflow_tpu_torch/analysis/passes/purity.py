"""trace-purity pass: captured code must stay on the device.

The port compiles its steps as the JAX package jits them: the donated
train step (``FFModel._step_body``) and each serving bucket's forward
(``InferenceEngine._forward``) are captured once into a CUDA graph by
``graphs.GraphRunner`` and replayed.  Anything reachable from those
entry points runs under a capture.  A host sync there (``.item()``,
``.cpu()``, ``torch.cuda.synchronize()``, a data-dependent
``.nonzero()``) makes the capture raise on the card — the capture is
refused, and the port has no eager fallback; a Python side effect
(``print``, ``open``, a telemetry ``emit``, a Python counter bumped)
fires at CAPTURE time only — once per graph, never per replay; a host
clock read bakes capture-time wall time into the graph as a constant.
``chip_smoke.py`` phase 36 holds this vocabulary against the card:
every sync spelling listed here is refused by a capture on the H100,
every clock read is frozen by it.

Entry points are discovered, not configured (``passes/_entries.py``):
functions handed to ``GraphRunner``/``run_eager``, the bodies of
``with torch.cuda.graph(...)`` blocks, op-class ``forward`` methods and
the autograd Functions they apply.  Reachability is the engine's
interprocedural :class:`~..engine.CallGraph` closure.

The kernel wrappers' launch counters (``fused_interact_cuda.launches
+= 1``) are such a side effect, and a sanctioned one:
``graphs.GraphRunner`` takes back what the wrappers counted while it
captured and adds it again on every replay (``graphs.COUNTED``).  A
counter bump on a function named in the graphs module's ``COUNTED`` is
therefore not a finding; any other Python state bumped under a capture
is.

Codes: ``host-sync-in-trace``, ``side-effect-in-trace``,
``emit-in-trace``, ``host-clock-in-trace``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import (PACKAGE, AnalysisPass, Finding, FunctionIndex,
                      Module, iter_calls)
from ._entries import capture_blocks, capture_reach

#: attribute calls that force a device->host sync (a capture refuses
#: each: chip_smoke.py phase 36)
SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
#: calls whose output size depends on the data: the host must read the
#: count back before it can allocate the result
DATA_SIZED = frozenset({"nonzero", "unique", "unique_consecutive",
                        "masked_select"})
#: numpy-module calls that materialize on host (flagged only through a
#: name actually bound to the ``numpy`` module)
NUMPY_SYNCS = frozenset({"asarray", "array", "frombuffer", "copyto"})
#: side effects at capture time
SIDE_EFFECT_NAMES = frozenset({"print", "open"})
#: telemetry producers
EMIT_NAMES = frozenset({"emit", "emit_summary", "sample_memory",
                        "record_span", "start_span", "active_log"})
#: host clock reads (through a name bound to the ``time`` module)
CLOCK_ATTRS = frozenset({"time", "perf_counter", "monotonic",
                         "process_time", "time_ns", "perf_counter_ns"})
#: the module whose ``COUNTED`` tuple names the counted kernel wrappers
GRAPHS_MODULE = f"{PACKAGE}.graphs"


def module_aliases(module: Module) -> Tuple[Set[str], Set[str]]:
    """Names bound in the module to numpy / time."""
    np_names: Set[str] = set()
    time_names: Set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                bound = a.asname or a.name.split(".")[0]
                if a.name == "numpy":
                    np_names.add(bound)
                elif a.name == "time":
                    time_names.add(bound)
    return np_names, time_names


def counted_wrappers(modules: List[Module]) -> Set[str]:
    """Names in the graphs module's ``COUNTED = (...)`` tuple."""
    for m in modules:
        if m.name != GRAPHS_MODULE:
            continue
        for stmt in m.tree.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "COUNTED"
                    for t in stmt.targets) \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)):
                return {e.id for e in stmt.value.elts
                        if isinstance(e, ast.Name)}
    return set()


def numpy_names(fn_node: ast.AST, np_names: Set[str]) -> Set[str]:
    """Local names that hold numpy values: assigned (to a fixed point)
    from a call on the numpy module, or from an expression over such
    names (``uniq[~resident]``, ``idx - 1``, tuple targets of
    ``np.unique(...)``).  ``.tolist()``/``.item()``/``.numpy()`` on one
    is host work, not a device sync."""
    assigns = [n for n in ast.walk(fn_node) if isinstance(n, ast.Assign)]
    out: Set[str] = set()
    while True:
        before = len(out)
        for st in assigns:
            if numpy_valued(st.value, np_names, out):
                for t in st.targets:
                    for el in (t.elts if isinstance(t, (ast.Tuple,
                                                        ast.List))
                               else [t]):
                        if isinstance(el, ast.Name):
                            out.add(el.id)
        if len(out) == before:
            return out


def numpy_valued(expr: ast.AST, np_names: Set[str],
                 names: Set[str]) -> bool:
    """Whether ``expr`` evaluates to a numpy value (see
    :func:`numpy_names`)."""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Call):
        root = expr.func
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id in np_names:
            return True
        f = expr.func
        return isinstance(f, ast.Attribute) \
            and numpy_valued(f.value, np_names, names) \
            and f.attr not in ("tolist", "item")
    if isinstance(expr, (ast.Subscript, ast.Attribute)):
        return numpy_valued(expr.value, np_names, names)
    if isinstance(expr, ast.BinOp):
        return numpy_valued(expr.left, np_names, names) \
            or numpy_valued(expr.right, np_names, names)
    if isinstance(expr, ast.UnaryOp):
        return numpy_valued(expr.operand, np_names, names)
    return False


def to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``: a copy the host waits for."""
    args = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                and a.value.startswith("cpu"):
            return True
    return False


def classify_sync(call: ast.Call, np_names: Set[str]
                  ) -> Optional[str]:
    """A display string when ``call`` syncs the host with the device."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr in SYNC_ATTRS:
        return f".{fn.attr}()"
    if fn.attr == "to" and to_cpu(call):
        return ".to('cpu')"
    if fn.attr in DATA_SIZED:
        return f".{fn.attr}() (data-dependent size)"
    if fn.attr == "where" and len(call.args) == 1 and not call.keywords:
        return ".where(cond) (data-dependent size)"
    if isinstance(fn.value, ast.Name) and fn.value.id in np_names \
            and fn.attr in NUMPY_SYNCS:
        return f"{fn.value.id}.{fn.attr}() (host numpy)"
    return None


class TracePurityPass(AnalysisPass):
    name = "trace-purity"
    description = ("no host syncs, side effects, telemetry emits, or "
                   "host clock reads inside CUDA-graph-captured "
                   "functions")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        reach = capture_reach(modules, index)
        counted = counted_wrappers(modules)
        alias_cache: Dict[str, Tuple[Set[str], Set[str]]] = {}
        findings: List[Finding] = []

        def check(nodes, mod: Module, qual: str, note: str) -> None:
            aliases = alias_cache.get(mod.name)
            if aliases is None:
                aliases = alias_cache[mod.name] = module_aliases(mod)
            np_names, time_names = aliases
            for n in nodes:
                hit = None
                if isinstance(n, ast.Call):
                    hit = self._classify(n, np_names, time_names)
                elif isinstance(n, ast.AugAssign):
                    hit = self._python_state(n.target, mod, index,
                                             counted)
                if hit is None:
                    continue
                code, what = hit
                findings.append(self.finding(
                    mod.relpath, n.lineno, code,
                    f"{what} inside captured {qual} ({note})",
                    detail=qual))

        for node, note in reach.items():
            mod, qual, _cls, _scope = index.owner[node]
            own = list(iter_calls(node)) + [
                n for n in self._own_nodes(node)
                if isinstance(n, ast.AugAssign)]
            check(own, mod, qual, note)
        for b in capture_blocks(modules, index):
            if b.fn in reach:
                continue  # its whole body is already checked
            check(list(b.own_nodes()), b.module, b.qual,
                  f"torch.cuda.graph at line {b.node.lineno}")
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    @staticmethod
    def _own_nodes(fn_node: ast.AST):
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
    def _python_state(target: ast.AST, mod: Module, index: FunctionIndex,
                      counted: Set[str]) -> Optional[Tuple[str, str]]:
        """``f.count += n`` on an attribute of a function (a def the
        name resolves to, at module level or through an import): Python
        state that a replay never updates.  The wrappers in
        ``graphs.COUNTED`` are compensated by the runner."""
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id not in counted \
                and index.resolve_name(mod, (), target.value.id) \
                is not None:
            return ("side-effect-in-trace",
                    f"{target.value.id}.{target.attr} += ... (Python "
                    f"state: runs at capture, never on replay)")
        return None

    @staticmethod
    def _classify(call: ast.Call, np_names: Set[str],
                  time_names: Set[str]) -> Optional[Tuple[str, str]]:
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id in SIDE_EFFECT_NAMES:
                return "side-effect-in-trace", f"{fn.id}()"
            if fn.id in EMIT_NAMES:
                return "emit-in-trace", f"{fn.id}()"
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        sync = classify_sync(call, np_names)
        if sync is not None:
            return "host-sync-in-trace", sync
        base = fn.value
        if isinstance(base, ast.Name) and base.id in time_names \
                and fn.attr in CLOCK_ATTRS:
            return ("host-clock-in-trace",
                    f"{base.id}.{fn.attr}() (capture-time constant)")
        if fn.attr in EMIT_NAMES:
            return "emit-in-trace", f".{fn.attr}()"
        return None
