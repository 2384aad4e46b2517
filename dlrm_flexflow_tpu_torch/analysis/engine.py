"""ffcheck shared engine for the PyTorch port: module loader, symbol
index, findings, waivers.

The port's correctness rests on conventions no runtime test can
economically cover — "never emit telemetry while holding a lock", "no
host syncs inside a CUDA-graph capture", "serving's captured forward is
donation-free", "subsystems import downward only", "every rank reaches
every collective".  This is the JAX package's ffcheck engine, kept as
the port's own copy (same finding codes, waiver keys, JSON document and
SARIF), pointed at the port's tree.  RacerD (Blackshear et al.,
OOPSLA'18) showed this class of invariant is findable by compositional
AST analysis without executing anything; this module is the shared
spine every pass (``analysis/passes/``) builds on:

* :func:`load_modules` — ONE module walker: the package and
  ``chip_smoke.py`` parsed once into :class:`Module` records with
  repo-relative paths;
* :class:`FunctionIndex` — lexically-scoped function/method lookup so
  passes resolve ``f(...)`` / ``self.m(...)`` call targets the way the
  interpreter would, not by grepping names; ambiguous ``obj.m`` calls
  are narrowed by call-signature compatibility (arity + keyword names)
  before giving up;
* :class:`CallGraph` — the resolved call edges of the whole project
  plus the ONE interprocedural machinery every pass shares: a bounded-
  depth, cycle-safe fixed-point :meth:`~CallGraph.propagate` (function
  summaries union through helper layers) and a note-carrying
  :meth:`~CallGraph.reachable` closure (entry-point reachability);
* :class:`Finding` — ``path:line`` + pass + code + a STABLE waiver key
  (no line numbers — waivers survive unrelated edits);
* :class:`Waivers` — the committed baseline (``analysis/waivers.txt``):
  every entry carries a one-line justification, matching is exact-key,
  and an entry no finding uses FAILS the run (stale waivers rot into
  silent blanket exemptions otherwise);
* :func:`run_analysis` — load, run passes, apply waivers, one
  :class:`AnalysisResult` the CLI renders as text or JSON.

Everything here is stdlib-only (ast/os/json): the analyzer must stay
runnable before torch imports, in CI, and on machines with no card.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the package this analyzer belongs to (and analyzes by default)
PACKAGE = "dlrm_flexflow_tpu_torch"

#: default roots the analyzer covers, relative to the repo root: the
#: package itself and its one entry script on the card.
DEFAULT_ROOTS = (PACKAGE, "chip_smoke.py")

#: the committed waiver/baseline file, relative to the repo root: it
#: lives inside the package (absent == no waivers).
WAIVER_FILE = PACKAGE + "/analysis/waivers.txt"


def repo_root() -> str:
    """The directory holding the package (and the waiver file)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


# ---------------------------------------------------------------- modules
class Module:
    """One parsed source file: dotted name, repo-relative path, AST."""

    __slots__ = ("name", "path", "relpath", "tree", "source")

    def __init__(self, name: str, path: str, relpath: str,
                 tree: ast.Module, source: str):
        self.name = name          # e.g. "dlrm_flexflow_tpu_torch.serving.engine"
        self.path = path          # absolute
        self.relpath = relpath    # repo-relative, '/'-separated
        self.tree = tree
        self.source = source

    @property
    def top(self) -> str:
        """The layering unit: first path component under the repo for
        package modules ("dlrm_flexflow_tpu_torch/serving/..." ->
        "serving"), the first directory for other trees, the stem for
        top-level files ("chip_smoke.py" -> "chip_smoke")."""
        parts = self.relpath.split("/")
        if parts[0] == PACKAGE:
            if len(parts) == 2:
                return parts[1][:-3]  # <package>/model.py -> model
            return parts[1]
        if len(parts) > 1:
            return parts[0]           # tools/foo.py -> tools
        return parts[0][:-3]          # chip_smoke.py -> chip_smoke

    def __repr__(self):
        return f"Module({self.relpath!r})"


def load_modules(roots: Optional[Sequence[str]] = None,
                 repo: Optional[str] = None,
                 errors: Optional[List[Tuple[str, SyntaxError]]] = None
                 ) -> List[Module]:
    """Parse every ``*.py`` under ``roots`` (files or directories,
    repo-relative) into :class:`Module` records, sorted by relpath.
    A file that does not parse raises — an unparseable source would
    silently blind every pass, which is exactly the failure mode a
    lint exists to prevent.  Callers that want to REPORT per-file and
    keep scanning the rest (check_telemetry_schema's producer scan)
    pass ``errors``: failures append ``(relpath, exc)`` there and the
    file is skipped instead of raising."""
    repo = repo or repo_root()
    roots = DEFAULT_ROOTS if roots is None else roots
    out: List[Module] = []
    paths: List[str] = []
    for root in roots:
        full = os.path.join(repo, root)
        if os.path.isfile(full):
            paths.append(full)
        elif os.path.isdir(full):
            for dirpath, dirs, files in os.walk(full):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                paths.extend(os.path.join(dirpath, f)
                             for f in files if f.endswith(".py"))
    for path in sorted(paths):
        rel = os.path.relpath(path, repo).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            if errors is None:
                raise
            errors.append((rel, e))
            continue
        name = rel[:-3].replace("/", ".")
        if name.endswith(".__init__"):
            name = name[:-len(".__init__")]
        out.append(Module(name, path, rel, tree, source))
    return out


# --------------------------------------------------------- function index
def walk_functions(module: Module):
    """Yield ``(qualname, node, classname, scope)`` for every function/
    method in the module, where ``scope`` is the tuple of enclosing
    FUNCTION names (classes contribute to qualname but not to lexical
    name visibility — a method is not callable as a bare name)."""

    def visit(node, qual: Tuple[str, ...], cls: Optional[str],
              scope: Tuple[str, ...]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = qual + (child.name,)
                yield ".".join(q), child, cls, scope
                yield from visit(child, q, None, scope + (child.name,))
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, qual + (child.name,),
                                 child.name, scope)
            elif isinstance(child, (ast.stmt, ast.ExceptHandler)):
                # defs nested in if/try/for/with bodies: same scope
                yield from visit(child, qual, cls, scope)

    yield from visit(module.tree, (), None, ())


class FunctionIndex:
    """Call-target resolution for one project, the way Python scoping
    would: bare names resolve lexically (innermost enclosing function
    scope outward, then module level; methods are invisible to bare
    names), ``self.m`` resolves to the enclosing class, and ``obj.m``
    resolves only when exactly one class in the project defines ``m``
    (ambiguity -> None, never a guess).

    Unlike the JAX package's index, a name the module imports from
    another project module (``from .ops.row_update_kernel import
    row_update_cuda``, at module level or inside a function) resolves
    to that module's top-level def, and ``mod.f(...)`` resolves when
    ``mod`` is an imported project module: the port composes its
    captured step across modules through plain imports, and a capture
    walk that stopped at the module boundary would never reach a
    kernel wrapper.  An import bound to two different targets in one
    module resolves to nothing.  A call on a name bound to an outside
    package (``torch.save(...)``, ``np.save(...)``) resolves to nothing
    either: it is that package's function, never a project method that
    shares its name."""

    #: attribute names too generic to resolve by project-wide
    #: uniqueness — including the threading/re surface (Event.set/
    #: clear/wait, re.match) that would otherwise ghost-resolve onto
    #: whatever project class happens to share the name
    GENERIC = frozenset({
        "get", "put", "pop", "append", "add", "items", "keys", "values",
        "update", "copy", "close", "open", "read", "write", "start",
        "end", "run", "join", "split", "strip", "format", "emit",
        "set", "match", "clear", "wait",
        "__init__", "__enter__", "__exit__"})

    def __init__(self, modules: Iterable[Module]):
        self.modules = list(modules)
        # (module name, scope tuple, bare name) -> def node
        self._scoped: Dict[Tuple[str, Tuple[str, ...], str], ast.AST] = {}
        # method name -> [(module, classname, node)]
        self._methods: Dict[str, List[Tuple[Module, str, ast.AST]]] = {}
        # (module name, classname, method name) -> node
        self._class_methods: Dict[Tuple[str, str, str], ast.AST] = {}
        # def node -> (module, qualname, classname-or-None, scope)
        self.owner: Dict[ast.AST, Tuple[Module, str, Optional[str],
                                        Tuple[str, ...]]] = {}
        # class name -> [(module, ClassDef)] of torch.autograd.Function
        # subclasses (the base spelled ``Function`` in any chain)
        self._autograd: Dict[str, List[Tuple[Module, ast.ClassDef]]] = {}
        for m in self.modules:
            for c in ast.walk(m.tree):
                if isinstance(c, ast.ClassDef) and any(
                        (isinstance(b, ast.Attribute)
                         and b.attr == "Function")
                        or (isinstance(b, ast.Name) and b.id == "Function")
                        for b in c.bases):
                    self._autograd.setdefault(c.name, []).append((m, c))
        # (module name, local name) -> (source module, name) for
        # imported functions; (module name, local name) -> module name
        # for imported project modules
        self._imported: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self._mod_alias: Dict[Tuple[str, str], str] = {}
        # (module name, local name) bound by an import of an outside
        # package
        self._external: set = set()
        known = {m.name for m in self.modules}
        for m in self.modules:
            self._index_imports(m, known)
        for m in self.modules:
            for qual, node, cls, scope in walk_functions(m):
                self.owner[node] = (m, qual, cls, scope)
                if cls is None:
                    self._scoped[(m.name, scope, node.name)] = node
                else:
                    self._methods.setdefault(node.name, []).append(
                        (m, cls, node))
                    self._class_methods[(m.name, cls, node.name)] = node

    def _index_imports(self, m: Module, known: set) -> None:
        is_pkg = m.relpath.endswith("/__init__.py")
        parts = m.name.split(".")
        clash = object()
        funcs: Dict[str, object] = {}
        mods: Dict[str, object] = {}

        def bind(table, local, target):
            prev = table.get(local)
            table[local] = target if prev in (None, target) else clash

        top = m.name.split(".")[0]

        def outside(dotted: str) -> bool:
            return dotted.split(".")[0] not in (top, PACKAGE) \
                and dotted not in known

        for node in ast.walk(m.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in known and a.asname:
                        bind(mods, a.asname, a.name)
                    elif outside(a.name):
                        self._external.add(
                            (m.name, a.asname or a.name.split(".")[0]))
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    anchor = parts if is_pkg else parts[:-1]
                    anchor = anchor[:len(anchor) - (node.level - 1)]
                    base = ".".join(anchor)
                    if node.module:
                        base = f"{base}.{node.module}" if base \
                            else node.module
                else:
                    base = node.module or ""
                if not node.level and base and outside(base):
                    for a in node.names:
                        self._external.add((m.name, a.asname or a.name))
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    local = a.asname or a.name
                    if f"{base}.{a.name}" in known:
                        bind(mods, local, f"{base}.{a.name}")
                    elif base in known:
                        bind(funcs, local, (base, a.name))
        for local, t in funcs.items():
            if t is not clash:
                self._imported[(m.name, local)] = t
        for local, t in mods.items():
            if t is not clash:
                self._mod_alias[(m.name, local)] = t

    def _module_def(self, modname: str, name: str,
                    hops: int = 3) -> Optional[ast.AST]:
        """Top-level def ``name`` of module ``modname``, following the
        module's own re-exports (``__init__`` imports) a few hops."""
        node = self._scoped.get((modname, (), name))
        if node is not None or hops == 0:
            return node
        t = self._imported.get((modname, name))
        return self._module_def(*t, hops=hops - 1) if t else None

    def resolve_name(self, module: Module, scope: Tuple[str, ...],
                     name: str) -> Optional[ast.AST]:
        """A bare-name call ``name(...)`` made inside ``scope``: the
        lexical def, else the def an import binds to the name."""
        for i in range(len(scope), -1, -1):
            node = self._scoped.get((module.name, scope[:i], name))
            if node is not None:
                return node
        t = self._imported.get((module.name, name))
        return self._module_def(*t) if t else None

    def resolve_module_attr(self, module: Module,
                            fn: ast.Attribute) -> Optional[ast.AST]:
        """``mod.f`` where ``mod`` is an imported project module."""
        if not isinstance(fn.value, ast.Name):
            return None
        target = self._mod_alias.get((module.name, fn.value.id))
        return self._module_def(target, fn.attr) if target else None

    def resolve_self_method(self, module: Module, classname: str,
                            name: str) -> Optional[ast.AST]:
        return self._class_methods.get((module.name, classname, name))

    def resolve_unique_method(self, name: str,
                              call: Optional[ast.Call] = None
                              ) -> Optional[ast.AST]:
        """The project's one definition of method ``name`` — or, when
        several classes define it and the CALL is given, the one
        definition whose signature accepts the call (arity + keyword
        names); still-ambiguous stays None, never a guess."""
        if name in self.GENERIC:
            return None
        cands = self._methods.get(name, ())
        if len(cands) == 1:
            return cands[0][2]
        if call is not None and len(cands) > 1:
            fits = [n for _m, _c, n in cands
                    if self._call_compatible(call, n)]
            if len(fits) == 1:
                return fits[0]
        return None

    @staticmethod
    def _call_compatible(call: ast.Call, node: ast.AST) -> bool:
        """Could this call site bind against this def's signature?  A
        purely syntactic check (positional arity, keyword names,
        required parameters) that narrows ambiguous ``obj.m`` targets —
        e.g. ``predict(x, queue_wait_us=...)`` picks the one ``predict``
        that takes ``queue_wait_us``.  Splats at the call site make the
        check vacuously true (no exclusion without evidence)."""
        args = getattr(node, "args", None)
        if args is None:
            return False
        if any(isinstance(a, ast.Starred) for a in call.args) \
                or any(k.arg is None for k in call.keywords):
            return True
        params = [a.arg for a in list(args.posonlyargs) + list(args.args)]
        if params and params[0] in ("self", "cls"):
            params = params[1:]
        npos = len(call.args)
        if npos > len(params) and args.vararg is None:
            return False
        kwnames = {k.arg for k in call.keywords}
        kwonly = [a.arg for a in args.kwonlyargs]
        if args.kwarg is None:
            for k in kwnames:
                if k not in params and k not in kwonly:
                    return False
        # every parameter without a default must be bound
        required = params[:len(params) - len(args.defaults)]
        for i, p in enumerate(required):
            if i >= npos and p not in kwnames:
                return False
        if kwnames & set(params[:npos]):
            return False  # keyword repeats a positionally-bound param
        for p, d in zip(args.kwonlyargs, args.kw_defaults):
            if d is None and p.arg not in kwnames:
                return False
        return True

    def autograd_methods(self, call: ast.Call,
                         module: Module) -> List[ast.AST]:
        """``forward``/``backward`` of the autograd Function a
        ``Cls.apply(...)`` call runs: ``Cls`` defined in the calling
        module, else the project's one class of that name; [] for any
        other call."""
        fn = call.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "apply"
                and isinstance(fn.value, ast.Name)):
            return []
        cands = self._autograd.get(fn.value.id, ())
        own = [mc for mc in cands if mc[0] is module]
        pick = own or (list(cands) if len(cands) == 1 else [])
        out = []
        for m, c in pick[:1]:
            for meth in ("forward", "backward"):
                node = self._class_methods.get((m.name, c.name, meth))
                if node is not None:
                    out.append(node)
        return out

    def is_autograd(self, module: Module, classname: str) -> bool:
        """Whether ``module`` defines ``classname`` as an autograd
        Function."""
        return any(m is module for m, _c in
                   self._autograd.get(classname, ()))

    def resolve_call(self, call: ast.Call, module: Module,
                     scope: Tuple[str, ...],
                     classname: Optional[str]) -> Optional[ast.AST]:
        """Best-effort target of one Call node, or None."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return self.resolve_name(module, scope, fn.id)
        if isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                    and classname is not None:
                found = self.resolve_self_method(module, classname,
                                                 fn.attr)
                if found is not None:
                    return found
            found = self.resolve_module_attr(module, fn)
            if found is not None:
                return found
            if self.is_external(module, fn.value):
                return None
            return self.resolve_unique_method(fn.attr, call)
        return None

    def is_external(self, module: Module, expr: ast.AST) -> bool:
        """Whether ``expr`` is a name (or a ``name.attr`` chain) rooted
        at an import of an outside package."""
        while isinstance(expr, ast.Attribute):
            expr = expr.value
        return isinstance(expr, ast.Name) \
            and (module.name, expr.id) in self._external


# -------------------------------------------------------------- call graph
def iter_calls(fn_node: ast.AST):
    """Call nodes belonging to THIS function — nested function/lambda
    bodies excluded (they run in their own right; passes decide whether
    a nested def "happens" at the parent's call time)."""

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from visit(child)

    yield from visit(fn_node)


def call_display(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return "<call>"


class CallGraph:
    """Resolved call edges over the whole project plus the shared
    interprocedural machinery.

    Edges are the :class:`FunctionIndex`'s best-effort resolutions of
    every call in every function body, PLUS the ``forward`` and
    ``backward`` of a ``torch.autograd.Function`` subclass at each
    ``Cls.apply(...)`` call (autograd runs both as part of the
    surrounding step; ``apply`` itself is torch's, so no plain edge
    resolves it).  Nested function *definitions* are a separate
    relation (:attr:`nested`) because whether a nested def's body runs
    at the parent's call time is pass-specific: a capture walk follows
    it (closures run in the captured step), a lock walk must not (a
    callback bound under a lock runs later, lock released).

    Two shared algorithms replace the old per-pass one-level
    resolution:

    * :meth:`propagate` — bounded-depth fixed point: ``summary[f]`` is
      the union of per-function local facts over everything ``f`` can
      reach in at most ``depth`` call hops.  Monotone set union over a
      finite domain, so cycles (recursion, mutual recursion) converge
      instead of recursing forever; the depth bound is the documented
      "helper layers, not whole-program" intent.
    * :meth:`reachable` — note-carrying closure from entry points
      (capture sites, thread targets), each reached function remembering
      HOW it was reached for the finding message.
    """

    #: default propagation/reachability depth: deep enough to see
    #: through any real helper stack in this tree, small enough that a
    #: pathological chain cannot drag every fact everywhere.
    DEFAULT_DEPTH = 10

    def __init__(self, modules: List[Module], index: FunctionIndex):
        self.modules = modules
        self.index = index
        # fn node -> [(callee node, lineno, display name)]
        self.edges: Dict[ast.AST, List[Tuple[ast.AST, int, str]]] = {}
        # fn node -> directly nested def nodes
        self.nested: Dict[ast.AST, List[ast.AST]] = {}
        for node, (mod, qual, cls, def_scope) in index.owner.items():
            scope = def_scope + (qual.split(".")[-1],)
            edges: List[Tuple[ast.AST, int, str]] = []
            for call in iter_calls(node):
                target = index.resolve_call(call, mod, scope, cls)
                if target is not None and target is not node:
                    edges.append((target, call.lineno,
                                  call_display(call)))
                for t in index.autograd_methods(call, mod):
                    if t is not node:
                        edges.append((t, call.lineno,
                                      f"{call.func.value.id}.apply"))
            self.edges[node] = edges
            # every def nested anywhere inside (they are index-owned
            # functions themselves, so reachability recurses from them)
            self.nested[node] = [
                child for child in ast.walk(node)
                if child is not node
                and isinstance(child, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]

    def propagate(self, local: Dict[ast.AST, set],
                  depth: Optional[int] = None) -> Dict[ast.AST, set]:
        """``summary[f] = local[f] ∪ ⋃ summary[callee]`` iterated to a
        fixed point (or ``depth`` rounds, whichever first).  Round k
        sees exactly k call hops, so the bound has a crisp meaning:
        facts more than ``depth`` helper layers down stay invisible —
        and a cycle simply stops changing the union."""
        depth = self.DEFAULT_DEPTH if depth is None else depth
        summary = {n: frozenset(local.get(n, ()))
                   for n in self.index.owner}
        for _ in range(max(0, depth)):
            changed = False
            nxt: Dict[ast.AST, frozenset] = {}
            for n, edges in self.edges.items():
                s = summary[n]
                acc = set(local.get(n, ()))
                for callee, _ln, _nm in edges:
                    acc.update(summary.get(callee, ()))
                fs = frozenset(acc)
                nxt[n] = fs
                if fs != s:
                    changed = True
            summary = nxt
            if not changed:
                break
        return {n: set(s) for n, s in summary.items()}

    def reachable(self, entries: Dict[ast.AST, str],
                  depth: Optional[int] = None,
                  follow_nested: bool = True, *,
                  stop: Iterable[ast.AST] = ()) -> Dict[ast.AST, str]:
        """Everything callable within ``depth`` hops of the entry
        points; values are human-readable "how we got here" notes
        (first discovery wins — BFS keeps them shortest).  Functions in
        ``stop`` are neither reached nor expanded."""
        depth = self.DEFAULT_DEPTH if depth is None else depth
        stop = set(stop)
        reach: Dict[ast.AST, str] = {}
        frontier = [(n, note) for n, note in entries.items()
                    if n in self.index.owner and n not in stop]
        for n, note in frontier:
            reach.setdefault(n, note)
        for _ in range(max(0, depth)):
            nxt: List[Tuple[ast.AST, str]] = []
            for n, note in frontier:
                for callee, _ln, name in self.edges.get(n, ()):
                    if callee not in reach and callee not in stop:
                        reach[callee] = f"{note} via {name}()"
                        nxt.append((callee, reach[callee]))
                if follow_nested:
                    for kid in self.nested.get(n, ()):
                        if kid in reach:
                            continue
                        kname = getattr(kid, "name", "<nested>")
                        reach[kid] = f"{note} via nested {kname}"
                        nxt.append((kid, reach[kid]))
            if not nxt:
                break
            frontier = nxt
        return reach


# --------------------------------------------------------------- findings
class Finding:
    """One violation: ``path:line`` for humans, a line-number-free
    ``waiver_key`` for the committed baseline."""

    __slots__ = ("pass_name", "path", "line", "code", "message",
                 "severity", "detail")

    def __init__(self, pass_name: str, path: str, line: int, code: str,
                 message: str, detail: str = "", severity: str = "error"):
        self.pass_name = pass_name
        self.path = path
        self.line = int(line)
        self.code = code
        self.message = message
        self.detail = detail          # usually the enclosing qualname
        self.severity = severity

    @property
    def waiver_key(self) -> str:
        return f"{self.pass_name}:{self.path}:{self.detail}:{self.code}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}: "
                f"[{self.pass_name}/{self.code}] {self.message}")

    def to_dict(self) -> dict:
        return {"pass": self.pass_name, "path": self.path,
                "line": self.line, "code": self.code,
                "message": self.message, "detail": self.detail,
                "severity": self.severity,
                "waiver_key": self.waiver_key}

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(d["pass"], d["path"], d["line"], d["code"],
                   d["message"], d.get("detail", ""),
                   d.get("severity", "error"))

    def __repr__(self):
        return f"Finding({self.format()!r})"


class AnalysisPass:
    """Base class; subclasses set ``name``/``description`` and
    implement ``run(modules, index) -> List[Finding]``."""

    name: str = "?"
    description: str = ""

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        raise NotImplementedError

    def finding(self, path: str, line: int, code: str, message: str,
                detail: str = "", severity: str = "error") -> Finding:
        return Finding(self.name, path, line, code, message,
                       detail=detail, severity=severity)


def all_passes() -> Dict[str, type]:
    """name -> pass class for every shipped pass (import deferred so
    the engine itself stays importable from pass modules)."""
    from .passes import PASSES
    return {p.name: p for p in PASSES}


def get_callgraph(modules: List[Module],
                  index: FunctionIndex) -> CallGraph:
    """The run's one :class:`CallGraph`, built lazily and cached on the
    index — the passes share one edge walk, not one each."""
    cg = getattr(index, "_callgraph", None)
    if cg is None:
        cg = CallGraph(modules, index)
        index._callgraph = cg
    return cg


def get_value_taint(modules: List[Module], index: FunctionIndex,
                    key: str, seed) -> Dict[ast.AST, set]:
    """THE shared value-taint relation: ``seed(fn_node, module)``
    names the taint kinds a function's own body introduces (e.g.
    "divergent" for a ``dist.get_rank()`` call); the result maps
    every function to the union of kinds over everything it can reach
    — :meth:`CallGraph.propagate`'s bounded fixed point, so a helper
    that launders ``get_rank()`` through three wrappers still
    taints its callers.  Cached on the index per ``key`` like
    :func:`get_callgraph` (the collective-divergence and
    barrier-protocol passes share the same summaries)."""
    cache = getattr(index, "_value_taint_cache", None)
    if cache is None:
        cache = index._value_taint_cache = {}
    if key not in cache:
        cg = get_callgraph(modules, index)
        local = {n: set(seed(n, index.owner[n][0]))
                 for n in index.owner}
        cache[key] = cg.propagate(local)
    return {n: set(s) for n, s in cache[key].items()}


# ---------------------------------------------------------------- waivers
class WaiverError(ValueError):
    """The waiver file itself is malformed (fail loudly: a silently
    dropped waiver line would either block CI or mask a violation)."""


class Waivers:
    """The committed baseline: ``<waiver-key> | <justification>`` lines
    (``#`` comments, blanks ignored).  Matching is exact-key; every
    entry must justify itself and must still match at least one finding
    (:meth:`unused` feeds the stale-waiver failure)."""

    def __init__(self, entries: Optional[List[Tuple[str, str, int]]] = None,
                 path: Optional[str] = None,
                 comments: Optional[Dict[str, List[str]]] = None):
        self.path = path
        self.entries = entries or []   # (key, justification, lineno)
        self._used: Dict[str, bool] = {k: False for k, _, _ in self.entries}
        # key -> the '#' block right above the entry (regenerated
        # baselines keep the prose next to the exemption it explains)
        self.comments: Dict[str, List[str]] = comments or {}

    @classmethod
    def load(cls, path: str) -> "Waivers":
        entries: List[Tuple[str, str, int]] = []
        seen: Dict[str, int] = {}
        comments: Dict[str, List[str]] = {}
        block: List[str] = []
        with open(path, encoding="utf-8") as f:
            for i, raw in enumerate(f, 1):
                line = raw.strip()
                if not line:
                    block = []
                    continue
                if line.startswith("#"):
                    block.append(line)
                    continue
                if "|" not in line:
                    raise WaiverError(
                        f"{path}:{i}: waiver entry needs "
                        f"'<key> | <justification>', got {line!r}")
                key, just = (s.strip() for s in line.split("|", 1))
                if not just:
                    raise WaiverError(
                        f"{path}:{i}: waiver {key!r} has no "
                        f"justification — every exemption must say why")
                if key.count(":") < 3:
                    raise WaiverError(
                        f"{path}:{i}: malformed waiver key {key!r} "
                        f"(want pass:path:detail:code)")
                if key in seen:
                    raise WaiverError(
                        f"{path}:{i}: duplicate waiver {key!r} "
                        f"(first at line {seen[key]})")
                seen[key] = i
                entries.append((key, just, i))
                if block:
                    comments[key] = block
                    block = []
        return cls(entries, path=path, comments=comments)

    def match(self, finding: Finding) -> Optional[str]:
        """The justification when ``finding`` is waived (marking the
        entry used), else None."""
        key = finding.waiver_key
        for k, just, _ in self.entries:
            if k == key:
                self._used[k] = True
                return just
        return None

    def unused(self) -> List[Tuple[str, str, int]]:
        return [(k, j, ln) for k, j, ln in self.entries
                if not self._used.get(k)]


# ----------------------------------------------------------------- runner
class AnalysisResult:
    """One run: active findings, waived findings (with justification),
    and stale waivers.  ``ok`` is the CI gate."""

    def __init__(self, pass_names: List[str], n_modules: int,
                 findings: List[Finding],
                 waived: List[Tuple[Finding, str]],
                 unused_waivers: List[Tuple[str, str, int]],
                 only_paths: Optional[Sequence[str]] = None):
        self.pass_names = pass_names
        self.n_modules = n_modules
        self.findings = findings
        self.waived = waived
        self.unused_waivers = unused_waivers
        # --changed-only scope: the paths findings were restricted to
        # (None = whole tree)
        self.only_paths = sorted(only_paths) if only_paths is not None \
            else None

    @property
    def ok(self) -> bool:
        return not self.findings and not self.unused_waivers

    def by_pass(self) -> Dict[str, Dict[str, int]]:
        """Per-pass finding/waived counts (zero-filled for every pass
        that ran — the report CLI's delta needs stable keys)."""
        out = {n: {"findings": 0, "waived": 0} for n in self.pass_names}
        for f in self.findings:
            out.setdefault(f.pass_name,
                           {"findings": 0, "waived": 0})["findings"] += 1
        for f, _j in self.waived:
            out.setdefault(f.pass_name,
                           {"findings": 0, "waived": 0})["waived"] += 1
        return out

    def to_dict(self) -> dict:
        doc = {
            "version": 1,
            "tool": "ffcheck",
            "passes": list(self.pass_names),
            "modules": self.n_modules,
            "findings": [f.to_dict() for f in self.findings],
            "waived": [{**f.to_dict(), "justification": j}
                       for f, j in self.waived],
            "unused_waivers": [{"key": k, "justification": j, "line": ln}
                               for k, j, ln in self.unused_waivers],
            "by_pass": self.by_pass(),
            "summary": {"findings": len(self.findings),
                        "waived": len(self.waived),
                        "unused_waivers": len(self.unused_waivers),
                        "ok": self.ok},
        }
        if self.only_paths is not None:
            doc["changed_only"] = list(self.only_paths)
        return doc

    def format_text(self) -> str:
        lines: List[str] = []
        for f in self.findings:
            lines.append(f.format())
        for k, j, ln in self.unused_waivers:
            where = f"{self.waivers_path or WAIVER_FILE}:{ln}"
            lines.append(f"{where}: [waivers/unused-waiver] waiver "
                         f"{k!r} matches no finding — remove it "
                         f"(was: {j})")
        status = "OK" if self.ok else "FAIL"
        scope = ""
        if self.only_paths is not None:
            scope = (f" [changed-only: {len(self.only_paths)} "
                     f"file(s) in scope]")
        lines.append(
            f"ffcheck: {status} — {len(self.findings)} finding(s), "
            f"{len(self.waived)} waived, "
            f"{len(self.unused_waivers)} stale waiver(s); "
            f"{len(self.pass_names)} pass(es) over "
            f"{self.n_modules} modules{scope}")
        return "\n".join(lines)

    waivers_path: Optional[str] = None


def run_analysis(modules: Optional[List[Module]] = None,
                 pass_names: Optional[Sequence[str]] = None,
                 waivers: Optional[Waivers] = None,
                 repo: Optional[str] = None,
                 roots: Optional[Sequence[str]] = None,
                 only_paths: Optional[Sequence[str]] = None
                 ) -> AnalysisResult:
    """Load (unless given), run the requested passes (default: all),
    apply waivers.  ``only_paths`` (the CLI's ``--changed-only`` mode)
    still ANALYZES the whole tree — interprocedural passes need the
    whole program — but reports only findings in those repo-relative
    paths; waiver matching and the stale-waiver check stay global, so a
    changed-only run cannot silently retire a baseline entry.  Raises
    ValueError on an unknown pass name."""
    if modules is None:
        modules = load_modules(roots=roots, repo=repo)
    registry = all_passes()
    names = list(pass_names) if pass_names else sorted(registry)
    for n in names:
        if n not in registry:
            raise ValueError(
                f"unknown pass {n!r} (have: {sorted(registry)})")
    index = FunctionIndex(modules)
    findings: List[Finding] = []
    for n in names:
        findings.extend(registry[n]().run(modules, index))
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    active: List[Finding] = []
    waived: List[Tuple[Finding, str]] = []
    for f in findings:
        just = waivers.match(f) if waivers is not None else None
        if just is None:
            active.append(f)
        else:
            waived.append((f, just))
    unused = waivers.unused() if waivers is not None else []
    if only_paths is not None:
        scope = {p.replace(os.sep, "/") for p in only_paths}
        active = [f for f in active if f.path in scope]
        waived = [(f, j) for f, j in waived if f.path in scope]
    res = AnalysisResult(names, len(modules), active, waived, unused,
                         only_paths=only_paths)
    res.waivers_path = waivers.path if waivers is not None else None
    return res


def default_waivers(repo: Optional[str] = None) -> Optional[Waivers]:
    """The committed waiver file, or None when absent."""
    path = os.path.join(repo or repo_root(), WAIVER_FILE)
    return Waivers.load(path) if os.path.exists(path) else None


# ------------------------------------------------------------------ explain
def _edge_resolution(index: FunctionIndex, caller: ast.AST,
                     callee: ast.AST) -> Tuple[Optional[int], str]:
    """(line, mechanism) of the first call in ``caller`` that resolves
    to ``callee`` — the mechanism names WHY the edge exists, which is
    exactly what churns waiver keys: a ``self.m()`` edge survives
    anything outside the class; a project-unique edge dies the day a
    second class grows a method of the same name; a
    signature-narrowed edge flips when a call site gains or loses the
    keyword that disambiguated it ("waiver churn")."""
    mod, qual, cls, def_scope = index.owner[caller]
    scope = def_scope + (qual.split(".")[-1],)
    for call in iter_calls(caller):
        fn = call.func
        if isinstance(fn, ast.Name):
            if index.resolve_name(mod, scope, fn.id) is callee:
                lexical = any(
                    index._scoped.get((mod.name, scope[:i], fn.id))
                    is callee for i in range(len(scope), -1, -1))
                return call.lineno, "lexical" if lexical else "import"
        elif isinstance(fn, ast.Attribute):
            if index.resolve_module_attr(mod, fn) is callee:
                return call.lineno, "import"
            if isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                    and cls is not None \
                    and index.resolve_self_method(mod, cls,
                                                  fn.attr) is callee:
                return call.lineno, "self-method"
            if index.resolve_unique_method(fn.attr, call) is callee:
                cands = index._methods.get(fn.attr, ())
                return call.lineno, ("project-unique" if len(cands) == 1
                                     else "signature-narrowed")
    return None, "autograd-apply"


def explain_key(key: str,
                modules: Optional[List[Module]] = None,
                waivers: Optional[Waivers] = None,
                repo: Optional[str] = None,
                roots: Optional[Sequence[str]] = None) -> str:
    """A human-readable report on one waiver key: its status
    (ACTIVE / WAIVED / STALE / UNKNOWN), the findings it matches
    today, and the reverse caller chain into the detail function with
    each edge's resolution mechanism — the churn story.  For a key
    that matches nothing, lists the nearest live keys (same
    pass+path+code; same pass+detail) so a renamed helper or a
    resolution flip is a one-look diagnosis.  Raises ValueError on a
    malformed key or unknown pass."""
    parts = key.split(":")
    if len(parts) < 4:
        raise ValueError(
            f"malformed waiver key {key!r} (want pass:path:detail:code)")
    pass_name, path = parts[0], parts[1]
    code, detail = parts[-1], ":".join(parts[2:-1])
    registry = all_passes()
    if pass_name not in registry:
        raise ValueError(
            f"unknown pass {pass_name!r} (have: {sorted(registry)})")
    if modules is None:
        modules = load_modules(roots=roots, repo=repo)
    index = FunctionIndex(modules)
    findings = registry[pass_name]().run(modules, index)
    matches = [f for f in findings if f.waiver_key == key]
    if waivers is None:
        waivers = default_waivers(repo)
    entry = None
    if waivers is not None:
        for k, just, ln in waivers.entries:
            if k == key:
                entry = (just, ln)
                break

    if matches and entry:
        status = "WAIVED"
    elif matches:
        status = "ACTIVE"
    elif entry:
        status = "STALE"
    else:
        status = "UNKNOWN"
    lines = [f"{key}", f"  status: {status}"]
    if entry is not None:
        src = waivers.path or WAIVER_FILE
        lines.append(f"  waiver: {src}:{entry[1]} | {entry[0]}")
    for f in matches:
        lines.append(f"  finding: {f.path}:{f.line} [{f.code}]")
        lines.append(f"    {f.message}")

    # the reverse caller chain into the detail function: who reaches
    # it, one hop per line, each edge naming its resolution mechanism
    cg = get_callgraph(modules, index)
    rev: Dict[ast.AST, List[ast.AST]] = {}
    for caller, edges in cg.edges.items():
        for callee, _ln, _nm in edges:
            rev.setdefault(callee, []).append(caller)
    targets = [n for n, (m, q, _c, _s) in index.owner.items()
               if q == detail and m.relpath == path]
    if not targets:
        targets = [n for n, (m, q, _c, _s) in index.owner.items()
                   if m.relpath == path and q.endswith("." + detail)]
    if not targets and "." in detail:
        # growth/lifecycle details are Class.attr, not a function —
        # fall back to the class's methods in that file that actually
        # touch the attribute
        clsname, _, attr = detail.partition(".")

        def touches(n: ast.AST) -> bool:
            return any(isinstance(x, ast.Attribute) and x.attr == attr
                       for x in ast.walk(n))
        targets = [n for n, (m, q, c, _s) in index.owner.items()
                   if m.relpath == path and c == clsname and touches(n)]
    def order(n):
        m, q, _c, _s = index.owner[n]
        return (m.relpath, getattr(n, "lineno", 0), q)
    for t in sorted(targets, key=order)[:3]:
        _m, tq, _c, _s = index.owner[t]
        lines.append(f"  chain into {tq}:")
        callers = sorted(set(rev.get(t, ())), key=order)
        if not callers:
            lines.append("    (no resolved callers — an entry point, "
                         "or reached only as a thread/capture target)")
        node, hops = t, 0
        seen = {t}
        while hops < 10:
            cs = [c for c in sorted(set(rev.get(node, ())), key=order)
                  if c not in seen]
            if not cs:
                break
            if hops == 0 and len(callers) > 1:
                for c in callers[1:][:4]:
                    cm, cq, _cc, _cs2 = index.owner[c]
                    ln, how = _edge_resolution(index, c, t)
                    at = f"{cm.relpath}:{ln}" if ln else cm.relpath
                    lines.append(f"    <- also called by {cq} "
                                 f"({at}) [{how}]")
            c = cs[0]
            cm, cq, _cc, _cs2 = index.owner[c]
            ln, how = _edge_resolution(index, c, node)
            at = f"{cm.relpath}:{ln}" if ln else cm.relpath
            lines.append(f"    <- called by {cq} ({at}) [{how}]")
            seen.add(c)
            node = c
            hops += 1

    if status in ("STALE", "UNKNOWN"):
        near = sorted({f.waiver_key for f in findings
                       if f.path == path and f.code == code})
        same_detail = sorted({f.waiver_key for f in findings
                              if f.detail == detail})
        if not targets:
            lines.append(f"  note: no function matching {detail!r} in "
                         f"{path} — renamed, deleted, or the "
                         f"resolution that reached it flipped")
        for label, keys in (("nearest (same pass+path+code)", near),
                            ("nearest (same pass+detail)", same_detail)):
            for k in keys[:5]:
                lines.append(f"  {label}: {k}")
    return "\n".join(lines)


def write_json(result: AnalysisResult, path: str) -> None:
    """One ``artifacts/analysis_*.json``-style sink the telemetry
    report CLI's ``== analysis ==`` section reads."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(result.to_dict(), f, indent=1)
        f.write("\n")


# ------------------------------------------------------------------- SARIF
def to_sarif(result: AnalysisResult) -> dict:
    """The findings as one SARIF 2.1.0 run, the interchange shape CI
    annotators (GitHub code scanning, Gerrit checks) consume: each
    active finding becomes a ``result`` with a ``ruleId`` of
    ``<pass>/<code>``, a ``path:line`` physical location, and the
    ffcheck waiver key as a stable ``partialFingerprints`` entry so an
    annotator can track a finding across rebases the same way the
    baseline does.  Waived findings are emitted with
    ``suppressions`` so the annotation shows WHY it is quiet."""
    rules: Dict[str, dict] = {}
    results: List[dict] = []

    def one(f: Finding, suppression: Optional[str]) -> dict:
        rid = f"{f.pass_name}/{f.code}"
        rules.setdefault(rid, {
            "id": rid,
            "shortDescription": {"text": f.code.replace("-", " ")}})
        r = {
            "ruleId": rid,
            "level": "error" if f.severity == "error" else "warning",
            "message": {"text": f.message},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": f.line}}}],
            "partialFingerprints": {"ffcheckWaiverKey/v1": f.waiver_key},
        }
        if suppression is not None:
            r["suppressions"] = [{"kind": "external",
                                  "justification": suppression}]
        return r

    for f in result.findings:
        results.append(one(f, None))
    for f, just in result.waived:
        results.append(one(f, just))
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "ffcheck",
                "informationUri": "docs/analysis.md",
                "rules": [rules[k] for k in sorted(rules)]}},
            "results": results,
        }],
    }


def write_sarif(result: AnalysisResult, path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_sarif(result), f, indent=1)
        f.write("\n")


# --------------------------------------------------------- baseline update
BASELINE_HEADER = """\
# ffcheck waiver baseline of the PyTorch port.
#
# Format: one `<waiver-key> | <justification>` per line; the key is
# printed with every finding (pass:path:detail:code — line-number-free,
# so entries survive unrelated edits).  Every entry MUST carry a
# justification, and an entry that matches no finding FAILS the run
# (stale waivers rot into blanket exemptions).  Shrink this file when
# you can; grow it only with a reason the next reader will accept.
# Regenerate with `python -m dlrm_flexflow_tpu_torch.analysis
# --update-baseline` — it preserves justifications, drops stale
# entries, and REFUSES to invent a waiver for a new finding.
"""


class BaselineError(ValueError):
    """--update-baseline cannot proceed (typically: new findings with
    no justification — waiving is a deliberate act, never generated)."""


def update_baseline(result: AnalysisResult, waivers: Optional[Waivers],
                    path: str) -> List[str]:
    """Rewrite the waiver file from a finished run: every entry that
    still matches a finding is kept with its justification (and its
    explanatory comment block) VERBATIM; stale entries are dropped;
    and any ACTIVE finding makes the update refuse with
    :class:`BaselineError` — a regeneration must never mint an
    unjustified exemption (the hand-edit era's typo'd-key failure mode,
    inverted).  Returns the kept keys, sorted as written."""
    if result.findings:
        keys = sorted({f.waiver_key for f in result.findings})
        raise BaselineError(
            "refusing to regenerate the baseline over "
            f"{len(result.findings)} unwaived finding(s) — fix them or "
            "add a justified waiver line first:\n  " + "\n  ".join(keys))
    kept: Dict[str, str] = {}
    for f, just in result.waived:
        kept.setdefault(f.waiver_key, just)
    comments = waivers.comments if waivers is not None else {}
    lines = [BASELINE_HEADER]
    for key in sorted(kept):
        block = comments.get(key)
        if block:
            lines.append("\n".join(block))
        lines.append(f"{key} | {kept[key]}")
        lines.append("")
    text = "\n".join(lines).rstrip("\n") + "\n"
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return sorted(kept)
