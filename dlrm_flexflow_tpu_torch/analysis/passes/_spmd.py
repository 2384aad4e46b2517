"""The torch.distributed surface shared by the multi-rank passes.

``collective-divergence``, ``mesh-axis`` and ``barrier-protocol`` agree
on what the port's collectives look like:

* a **raw collective** is a ``torch.distributed`` call that every rank
  of its group must reach (:data:`DIST_COLLECTIVES`), spelled through a
  name bound to ``torch.distributed`` (``import torch.distributed as
  dist``) or the full ``torch.distributed.<op>`` chain;
* a **collective performer** is any function that (transitively, the
  engine's call graph closure) makes one: the wrappers of
  ``parallel/collectives.py``, ``HostComm.gather/scatter``, the serving
  engine's broadcasts — found structurally from the raw calls they
  make, not by name;
* an entry into the podshard file-barrier protocol is a function that
  *mints a fence directory* — recognized from the ``.barrier-`` path
  constant feeding its ``os.makedirs``, as the JAX package's passes
  recognize it, so a renamed helper cannot dodge the passes;
* a **mesh axis** is named where it is declared: module-level
  ``*_AXIS = "<name>"`` constants of the ``parallel`` unit
  (``DATA_AXIS``, ``MODEL_AXIS``, ``SEQ_AXIS`` in ``parallel/mesh.py``,
  ``PIPE_AXIS`` in ``parallel/pipeline.py``) and the keys of a
  ``make_mesh({...})`` literal.

Axis names are resolved like the tree spells them: string literals, or
names bound to module-level string constants (own module first, then
the project-unique constant map).  Anything dynamic resolves to nothing,
and the consuming passes stay silent rather than guess.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import PACKAGE, FunctionIndex, Module, iter_calls

#: torch.distributed calls every rank of the group must reach.
DIST_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "gather", "gather_object", "scatter",
    "scatter_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "barrier", "monitored_barrier",
    "batch_isend_irecv", "send", "recv", "isend", "irecv"})

#: the one module whose functions wrap the raw collectives for the
#: mesh, and the launcher module that owns the process group
WRAPPER_MODULES = frozenset({f"{PACKAGE}/parallel/collectives.py",
                             f"{PACKAGE}/distributed.py"})

#: mesh methods whose first argument is a set of axis names
AXIS_METHODS = frozenset({"group", "axis_size", "axis_index", "axes_key"})

#: the filesystem marker every podshard commit fence lives under
#: (resilience/manager.py).
FENCE_MARK = ".barrier"

#: parameter names that carry a rank by convention
DIVERGENT_PARAMS = frozenset({"pidx", "process_index", "process_id",
                              "rank"})


def own_statements(fn_node: ast.AST):
    """Descendants of this function excluding nested function/class
    bodies — the shared walk the SPMD passes agree on."""
    stack = [fn_node]
    while stack:
        n = stack.pop()
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            yield child
            stack.append(child)


def cached_own(index: FunctionIndex, fn_node: ast.AST) -> List[ast.AST]:
    """``own_statements(fn_node)`` as a list, cached on the index (the
    SPMD passes walk each body many times)."""
    cache = getattr(index, "_own_nodes_cache", None)
    if cache is None:
        cache = index._own_nodes_cache = {}
    out = cache.get(fn_node)
    if out is None:
        out = cache[fn_node] = list(own_statements(fn_node))
    return out


def process_local_names(fn_node: ast.AST, expr_local, *,
                        split_call=None, nodes=None) -> Set[str]:
    """THE one seeding rule for "this name holds a rank-local value",
    shared by collective-divergence and barrier-protocol: conventional
    parameter names (:data:`DIVERGENT_PARAMS`) plus assignment targets
    whose source ``expr_local(expr, names)`` deems rank-local.  A tuple
    assign with MATCHING arity taints elementwise — ``rank, world =
    dist.get_rank(), dist.get_world_size()`` taints ``rank`` only;
    a call returning a tuple taints every target (conservative) unless
    ``split_call(call, n)`` gives the per-element verdicts (the callee
    returns an ``n``-tuple literal everywhere: ``rank, world =
    _identity()`` taints ``rank`` only).  The scan runs to a fixed point
    over source-ordered statements, so alias chains converge wherever
    each link sits."""
    names: Set[str] = set()
    args = getattr(fn_node, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if a.arg in DIVERGENT_PARAMS:
                names.add(a.arg)
    assigns = sorted(
        (st for st in (own_statements(fn_node) if nodes is None
                       else nodes)
         if isinstance(st, ast.Assign)),
        key=lambda st: (st.lineno, st.col_offset))
    while True:
        before = len(names)
        for stmt in assigns:
            for t in stmt.targets:
                if isinstance(t, (ast.Tuple, ast.List)) \
                        and isinstance(stmt.value, (ast.Tuple,
                                                    ast.List)) \
                        and len(t.elts) == len(stmt.value.elts):
                    for el, src in zip(t.elts, stmt.value.elts):
                        if isinstance(el, ast.Name) \
                                and expr_local(src, names):
                            names.add(el.id)
                    continue
                if isinstance(t, (ast.Tuple, ast.List)) \
                        and isinstance(stmt.value, ast.Call) \
                        and split_call is not None:
                    parts = split_call(stmt.value, len(t.elts))
                    if parts is not None:
                        for el, local in zip(t.elts, parts):
                            if local and isinstance(el, ast.Name):
                                names.add(el.id)
                        continue
                els = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t])
                if expr_local(stmt.value, names):
                    for el in els:
                        if isinstance(el, ast.Name):
                            names.add(el.id)
        if len(names) == before:
            return names


# ------------------------------------------------------- string constants
def get_str_consts(modules: List[Module], index: FunctionIndex
                   ) -> Tuple[Dict[Tuple[str, str], str], Dict[str, str]]:
    """(per-module, project-unique) maps of module-level ``NAME =
    "literal"`` string constants — how ``DATA_AXIS``/``MODEL_AXIS``
    (and ``MANIFEST``) resolve at their use sites.  Cached on the index;
    the project-wide map only keeps names every defining module agrees
    on (ambiguity -> absent, never a guess)."""
    cached = getattr(index, "_str_consts_cache", None)
    if cached is not None:
        return cached
    per: Dict[Tuple[str, str], str] = {}
    values: Dict[str, Set[str]] = {}
    for m in modules:
        for stmt in m.tree.body:
            tgts: List[ast.expr] = []
            value = None
            if isinstance(stmt, ast.Assign):
                tgts, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                tgts, value = [stmt.target], stmt.value
            if not isinstance(value, ast.Constant) \
                    or not isinstance(value.value, str):
                continue
            for t in tgts:
                if isinstance(t, ast.Name):
                    per[(m.name, t.id)] = value.value
                    values.setdefault(t.id, set()).add(value.value)
    uniq = {n: next(iter(vs)) for n, vs in values.items() if len(vs) == 1}
    index._str_consts_cache = (per, uniq)
    return per, uniq


def resolve_str(expr: ast.AST, module: Module,
                per: Dict[Tuple[str, str], str],
                uniq: Dict[str, str]) -> Optional[str]:
    """A string literal, or a Name bound to one (own module first,
    then the project-unique map); None for anything dynamic."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.Name):
        own = per.get((module.name, expr.id))
        if own is not None:
            return own
        return uniq.get(expr.id)
    return None


def declared_axes(modules: List[Module], index: FunctionIndex
                  ) -> Set[str]:
    """Every axis name the port's meshes declare: ``*_AXIS`` string
    constants at module level in the ``parallel`` unit, and the string
    keys of ``make_mesh({...})`` literals anywhere.  Cached."""
    cached = getattr(index, "_declared_axes_cache", None)
    if cached is not None:
        return set(cached)
    per, uniq = get_str_consts(modules, index)
    out: Set[str] = set()
    for (modname, name), value in per.items():
        if name.endswith("_AXIS") \
                and modname.startswith(f"{PACKAGE}.parallel"):
            out.add(value)
    for m in modules:
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Call) \
                    and call_name(node) == "make_mesh":
                for arg in list(node.args) + [k.value
                                              for k in node.keywords]:
                    if isinstance(arg, ast.Dict):
                        for k in arg.keys:
                            s = (resolve_str(k, m, per, uniq)
                                 if k is not None else None)
                            if s is not None:
                                out.add(s)
    index._declared_axes_cache = out
    return set(out)


# ------------------------------------------------------------- collectives
def call_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def dist_aliases(module: Module) -> Set[str]:
    """Names bound to ``torch.distributed`` anywhere in the module
    (deferred imports included)."""
    out: Set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    out.add(a.asname or a.name)
    return out


def get_dist_aliases(modules: List[Module], index: FunctionIndex
                     ) -> Dict[str, Set[str]]:
    cached = getattr(index, "_dist_aliases_cache", None)
    if cached is None:
        cached = index._dist_aliases_cache = {
            m.name: dist_aliases(m) for m in modules}
    return cached


def raw_collective(call: ast.Call, aliases: Set[str]) -> Optional[str]:
    """``dist.<op>(...)`` / ``torch.distributed.<op>(...)`` for a
    collective ``op``: its name, else None."""
    fn = call.func
    if not isinstance(fn, ast.Attribute) \
            or fn.attr not in DIST_COLLECTIVES:
        return None
    v = fn.value
    if isinstance(v, ast.Name) and v.id in aliases:
        return fn.attr
    if isinstance(v, ast.Attribute) and v.attr == "distributed" \
            and isinstance(v.value, ast.Name) and v.value.id == "torch":
        return fn.attr
    return None


def iter_raw_collectives(fn_node: ast.AST, aliases: Set[str]):
    """``(call, name)`` of the raw collectives in this function's own
    body (nested defs excluded)."""
    for call in iter_calls(fn_node):
        nm = raw_collective(call, aliases)
        if nm is not None:
            yield call, nm


def _mentions_fence(expr: ast.AST) -> bool:
    """A ``.barrier`` path constant anywhere inside ``expr`` (plain
    string or f-string piece)."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and FENCE_MARK in node.value:
            return True
    return False


def _fence_names(fn_node: ast.AST) -> Set[str]:
    """Local names assigned from expressions mentioning the fence
    marker (``bdir = os.path.join(dir, f".barrier-{tag}")``)."""
    out: Set[str] = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign) and _mentions_fence(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def fence_creations(fn_node: ast.AST) -> List[ast.Call]:
    """``os.makedirs``/``os.mkdir`` calls whose target path derives
    from a ``.barrier`` constant — the act of minting a commit fence."""
    fences = _fence_names(fn_node)
    out: List[ast.Call] = []
    for call in iter_calls(fn_node):
        if call_name(call) not in ("makedirs", "mkdir"):
            continue
        for arg in call.args:
            if _mentions_fence(arg) or (isinstance(arg, ast.Name)
                                        and arg.id in fences):
                out.append(call)
                break
    return out


def sweeps_fences(fn_node: ast.AST) -> bool:
    """Whether this function removes fence directories: an
    ``rmtree``/``rmdir`` call in a function that also spells the
    fence marker."""
    has_rm = any(call_name(c) in ("rmtree", "rmdir")
                 for c in iter_calls(fn_node))
    return has_rm and _mentions_fence(fn_node)


def get_fence_creators(modules: List[Module], index: FunctionIndex
                       ) -> Dict[ast.AST, ast.Call]:
    """fn node -> its first fence-minting call; cached on the index
    (the divergence pass counts these as collectives, the barrier pass
    audits their lifecycle)."""
    cached = getattr(index, "_fence_creators_cache", None)
    if cached is not None:
        return dict(cached)
    out: Dict[ast.AST, ast.Call] = {}
    for node in index.owner:
        if not any(isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and FENCE_MARK in n.value
                   for n in cached_own(index, node)):
            continue  # mints nothing: the marker is spelled in the body
        created = fence_creations(node)
        if created:
            out[node] = created[0]
    index._fence_creators_cache = out
    return dict(out)


def collective_seed(modules: List[Module], index: FunctionIndex):
    """The ``get_value_taint`` seed for "performs a collective": a raw
    collective in the function's own body, or a fence minted there."""
    aliases = get_dist_aliases(modules, index)
    creators = get_fence_creators(modules, index)

    def seed(n: ast.AST, m: Module) -> Set[str]:
        if n in creators:
            return {"collective"}
        for _c in iter_raw_collectives(n, aliases.get(m.name, set())):
            return {"collective"}
        return set()

    return seed
