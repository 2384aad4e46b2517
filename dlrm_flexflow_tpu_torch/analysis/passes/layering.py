"""import-layering pass: subsystems import downward only.

The port grew as a layered stack, as the JAX package did, and stays
maintainable only while the layers hold: foundations (tensor/config/
optim/...) know nothing of the model; the kernels' build (``_cuda``)
knows only telemetry; the ops know nothing of the captured step
(``graphs``) that composes them; the model knows nothing of the
subsystems riding it (resilience/serving); apps and frontends sit on
top, the tools above them, and ``chip_smoke.py`` may import anything.
The explicit DAG (:data:`LAYERS`, lowest first — placed by the
module-level import graph the port actually has) is the single source
of truth.

Only MODULE-LEVEL imports are edges: a function-level (deferred)
import is the sanctioned cycle-break idiom (model.fit importing the
resilient loop, checkpoint restore importing model helpers) — it
executes after both modules exist and cannot create an import cycle,
so the pass ignores it.  Top-level ``if``/``try`` bodies count as
module level (conditional imports still execute at import time).

Codes: ``upward-import`` (edge to a higher or same-rank foreign
layer), ``unmapped-module`` (a new top-level unit nobody placed in
:data:`LAYERS` — the map must not rot as the tree grows).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..engine import PACKAGE as ENGINE_PACKAGE
from ..engine import AnalysisPass, Finding, FunctionIndex, Module

PACKAGE = ENGINE_PACKAGE

#: the layer DAG, lowest (most fundamental) first.  A module may
#: import module-level only from STRICTLY lower layers (same top-level
#: unit is always free).  ``analysis`` is stdlib-only by design and
#: sits at the bottom; the package root ``__init__`` re-exports the
#: public API and so ranks above every subsystem; ``chip_smoke.py`` is
#: the entry point and may import anything.
LAYERS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    # stdlib-only thread primitives sit below everything: foundation
    # modules (data/prefetch) and subsystems (serving) both reuse them
    ("primitives", ("concurrency",)),
    ("foundation", ("tensor", "config", "initializers", "losses",
                    "metrics", "optim", "native_lib", "distributed",
                    "device", "analysis")),
    # the loaders read the native library and the tensor types
    ("data", ("data",)),
    ("telemetry", ("telemetry",)),
    # the kernels' nvcc build records its compile events
    ("kernel-build", ("_cuda",)),
    ("ops", ("ops",)),
    # the captured-step runner counts the kernel wrappers' launches
    # (graphs.COUNTED) and the epoch row cache drives the row-set
    # kernel: both sit on the ops
    ("capture", ("graphs", "epoch_cache")),
    # tiered embedding storage reads the ops cost gates and telemetry,
    # and is itself consumed by serving/checkpoint
    ("storage", ("storage",)),
    ("parallel", ("parallel",)),
    ("sim", ("sim", "profiling")),
    ("model", ("model",)),
    # the weight bridge to and from the JAX package's layout reads the
    # model's layers, as a checkpoint does
    ("checkpoint", ("checkpoint", "bridge")),
    ("subsystems", ("resilience", "serving")),
    # elastic integrates BOTH subsystems, so it sits strictly above them
    ("elastic", ("elastic",)),
    ("apps", ("apps", "frontends")),
    # the reference-compatible API re-exports the frontends and drives
    # the model through its imperative verbs
    ("compat", ("flexflow",)),
    # the example scripts drive the apps, the frontends, the SOAP search
    # and the mesh through their public entry points
    ("examples", ("examples",)),
    # the A/B and tuning tools build the apps' models
    ("tools", ("tools",)),
    ("package-root", ("__init__",)),
    ("entry", ("chip_smoke",)),
)


def layer_rank() -> Dict[str, int]:
    return {top: i for i, (_name, tops) in enumerate(LAYERS)
            for top in tops}


def _module_level_imports(module: Module):
    """(node, dotted-target) for imports executed at import time —
    direct module statements plus top-level if/try bodies; anything
    inside a function is a deferred import and exempt."""

    def stmts(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            if isinstance(child, (ast.If, ast.Try, ast.With)):
                yield from stmts(child)
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                yield child

    is_pkg = module.relpath.endswith("/__init__.py")
    parts = module.name.split(".")
    for node in stmts(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name, None
        else:
            if node.level == 0:
                base = node.module or ""
            else:
                # relative: anchor at the containing package, climb
                anchor = parts if is_pkg else parts[:-1]
                anchor = anchor[:len(anchor) - (node.level - 1)]
                base = ".".join(anchor)
                if node.module:
                    base = f"{base}.{node.module}" if base \
                        else node.module
            if not base:
                continue
            # resolve the BOUND names too: `from .. import telemetry`
            # inside serving/ is a serving->telemetry edge, not an
            # import of the package root — but only when the bound
            # name IS a module/unit; `from dlrm_flexflow_tpu_torch
            # import FFModel` binds a class and must attribute to the
            # root
            for a in node.names:
                yield node, base, (None if a.name == "*" else a.name)


def _alias_target(base: str, alias: Optional[str], known: set,
                  ranks: Dict[str, int]) -> str:
    """The dotted unit one `from <base> import <alias>` edge points at:
    ``base.alias`` when that names a loaded module or a mapped layer
    unit, else ``base`` (the alias is a class/function defined there)."""
    if alias is None:
        return base
    cand = f"{base}.{alias}"
    if cand in known:
        return cand
    top = _target_top(cand)
    if top is not None and top in ranks:
        return cand
    return base


def _target_top(dotted: str) -> Optional[str]:
    """The layering unit a dotted import target belongs to, or None
    for external libraries."""
    if dotted == PACKAGE:
        return "__init__"
    if dotted.startswith(PACKAGE + "."):
        return dotted.split(".")[1]
    if dotted == "chip_smoke":
        return dotted
    return None


class ImportLayeringPass(AnalysisPass):
    name = "import-layering"
    description = ("module-level imports must follow the layer DAG "
                   "downward (deferred imports exempt)")

    def __init__(self, ranks: Optional[Dict[str, int]] = None):
        self.ranks = layer_rank() if ranks is None else dict(ranks)

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        findings: List[Finding] = []
        known = {m.name for m in modules}
        for m in modules:
            src_top = m.top
            src_rank = self.ranks.get(src_top)
            if src_rank is None:
                findings.append(self.finding(
                    m.relpath, 1, "unmapped-module",
                    f"top-level unit {src_top!r} is not placed in the "
                    f"layer DAG (analysis/passes/layering.py LAYERS) — "
                    f"add it so layering stays enforced",
                    detail=src_top))
                continue
            for node, base, alias in _module_level_imports(m):
                dotted = _alias_target(base, alias, known, self.ranks)
                dst_top = _target_top(dotted)
                if dst_top is None or dst_top == src_top:
                    continue
                dst_rank = self.ranks.get(dst_top)
                if dst_rank is None:
                    findings.append(self.finding(
                        m.relpath, node.lineno, "unmapped-module",
                        f"import target unit {dst_top!r} (from "
                        f"{dotted!r}) is not placed in the layer DAG",
                        detail=dst_top))
                    continue
                if dst_rank >= src_rank:
                    direction = "upward" if dst_rank > src_rank \
                        else "sideways (same layer)"
                    findings.append(self.finding(
                        m.relpath, node.lineno, "upward-import",
                        f"module-level import of {dotted!r} "
                        f"({dst_top}, layer {dst_rank}) from "
                        f"{src_top} (layer {src_rank}) goes "
                        f"{direction} — defer it into the using "
                        f"function or move the dependency down",
                        detail=f"{src_top}->{dst_top}"))
        return findings
