"""barrier-protocol pass: the podshard file-barrier lifecycle rules.

The multihost checkpoint commit (resilience/manager.py,
docs/distributed.md) is fenced by SHARED-FILESYSTEM barriers:
``.barrier-<tag>/`` marker directories with a "missing dir = passed"
sweep rule.  Three properties make that protocol safe, each one a
review finding away from a fleet deadlock — so each is machine-checked:

* **fences get swept** — a fence directory someone mints but nobody
  ever removes survives into the next save, which then counts STALE
  markers toward its own arrival quorum (or, with per-tag fences,
  accumulates unbounded debris a "missing = passed" straggler rule
  can no longer interpret).  The minting class/module must also hold
  the sweep (``shutil.rmtree`` over the fence marker) — the success
  AND failure epilogues sharing one sweeper is the PR-14 shape; a
  class that can create but never remove a fence is flagged at the
  creation site.
* **no retry loops around the barrier** — the barrier is
  SINGLE-ATTEMPT by design (manager.py documents it): a per-process
  retry loop around a fenced phase re-enters the fence with a new
  attempt while the peers are still parked at the old one — the
  documented deadlock.  A loop in the minting class that (transitively)
  re-runs a fence-minting function is flagged; loops in OTHER
  classes/modules (a training loop calling ``save()`` per cadence) are
  the normal cadence and stay silent.
* **cross-host singletons are process-0's** — the manifest,
  ``meta.json``, and incumbent artifacts exist ONCE per checkpoint;
  two processes writing them race the commit rename.  In any function
  that names its rank (a ``pidx``/``rank``-style parameter or a local
  assigned from ``dist.get_rank()``), a write-mode ``open`` of a
  singleton file must sit under a ``pidx == 0`` guard.  Per-host
  shard writes (``shard-p{pidx}``-style paths) are the sanctioned
  replica-dedup pattern and never flagged.

Codes: ``fence-no-sweep``, ``barrier-in-retry-loop``,
``nonzero-singleton-write``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..engine import (AnalysisPass, Finding, FunctionIndex, Module,
                      get_value_taint, iter_calls)
from ._spmd import (call_name, get_fence_creators, get_str_consts,
                    process_local_names, resolve_str, sweeps_fences)

#: path fragments that name a once-per-checkpoint (or once-per-run)
#: cross-host file — the files only process 0 may write.
SINGLETON_MARKS = ("manifest", "meta.json", "incumbent")

FENCE_KEY = "mints-fence"


class BarrierProtocolPass(AnalysisPass):
    name = "barrier-protocol"
    description = ("podshard file-barrier lifecycle: fences get swept "
                   "by their minting class, no retry loops around the "
                   "single-attempt barrier, singleton files written "
                   "by process 0 only")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        findings: List[Finding] = []
        findings.extend(self._fence_lifecycle(modules, index))
        findings.extend(self._singleton_writes(modules, index))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    # ------------------------------------------------- fences + retries
    def _fence_lifecycle(self, modules: List[Module],
                         index: FunctionIndex) -> List[Finding]:
        creators = get_fence_creators(modules, index)
        if not creators:
            return []
        mints = get_value_taint(
            modules, index, FENCE_KEY,
            lambda n, _m: {"fence"} if n in creators else set())

        # sweep coverage per (module, class) unit: the protocol owner
        # must hold its own cleanup — a sweep in an unrelated module
        # does not count (it may never run in this process)
        def unit_of(fn) -> Tuple[str, Optional[str]]:
            mod, _qual, cls, _scope = index.owner[fn]
            return mod.name, cls

        sweeping_units: Set[Tuple[str, Optional[str]]] = {
            unit_of(fn) for fn in index.owner if sweeps_fences(fn)}

        findings: List[Finding] = []
        for fn, call in creators.items():
            mod, qual, cls, _scope = index.owner[fn]
            if unit_of(fn) not in sweeping_units:
                findings.append(self.finding(
                    mod.relpath, call.lineno, "fence-no-sweep",
                    f"{qual} mints a .barrier fence directory but "
                    f"nothing in {cls or mod.name} ever sweeps "
                    f"(.barrier rmtree) — stale fences feed the next "
                    f"save's arrival count and the 'missing dir = "
                    f"passed' rule stops meaning anything "
                    f"(docs/distributed.md)", detail=qual))

        # retry loops: a loop in the minting unit whose body calls
        # (transitively) back into a fence-minting function
        creator_units = {unit_of(fn) for fn in creators}
        for fn, (mod, qual, cls, scope) in index.owner.items():
            if unit_of(fn) not in creator_units:
                continue  # other classes' loops are cadence, not retry
            call_scope = scope + (qual.split(".")[-1],)
            for loop in self._own_loops(fn):
                for n in ast.walk(loop):
                    if not isinstance(n, ast.Call):
                        continue
                    target = index.resolve_call(n, mod, call_scope, cls)
                    if target is None or target is fn:
                        continue
                    if "fence" in mints.get(target, ()) \
                            or target in creators:
                        findings.append(self.finding(
                            mod.relpath, n.lineno,
                            "barrier-in-retry-loop",
                            f"{call_name(n)}() re-enters the "
                            f"single-attempt file barrier from the "
                            f"loop at line {loop.lineno} in {qual} — "
                            f"a retried attempt waits at a fresh "
                            f"fence while the peers are parked at the "
                            f"old one: the documented multihost "
                            f"deadlock (resilience/manager.py)",
                            detail=qual))
        return findings

    @staticmethod
    def _own_loops(fn_node: ast.AST):
        """for/while statements of THIS function (nested defs are
        their own protocol scope)."""
        stack = [fn_node]
        while stack:
            n = stack.pop()
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda,
                                      ast.ClassDef)):
                    continue
                if isinstance(child, (ast.For, ast.While)):
                    yield child
                stack.append(child)

    # --------------------------------------------------- singleton files
    def _singleton_writes(self, modules: List[Module],
                          index: FunctionIndex) -> List[Finding]:
        per, uniq = get_str_consts(modules, index)
        findings: List[Finding] = []
        for fn, (mod, qual, _cls, _scope) in index.owner.items():
            pidx_names = self._pidx_names(fn)
            if not pidx_names:
                continue  # not a process-aware function
            guarded = self._guarded_regions(fn, pidx_names)
            for call in iter_calls(fn):
                if call_name(call) != "open":
                    continue
                if not self._is_write_mode(call):
                    continue
                what = self._singleton_in(call, mod, per, uniq)
                if what is None:
                    continue
                if any(lo <= call.lineno <= hi for lo, hi in guarded):
                    continue
                findings.append(self.finding(
                    mod.relpath, call.lineno, "nonzero-singleton-write",
                    f"{qual} writes the cross-host singleton "
                    f"{what!r} without a process-0 guard "
                    f"({'/'.join(sorted(pidx_names))} == 0) — on a "
                    f"pod every process runs this line and the "
                    f"writes race the commit "
                    f"(docs/distributed.md's one-sweeper rule)",
                    detail=qual))
        return findings

    @staticmethod
    def _pidx_names(fn_node: ast.AST) -> Set[str]:
        """Names holding this process' index, via the one seeding rule
        the SPMD passes share (``_spmd.process_local_names`` —
        conventional parameter names + elementwise-tainted
        assignments) with THIS pass's narrower source predicate: a
        direct ``get_rank()`` (or ``process_index()``) call or an
        already-known name."""

        def expr_local(expr: ast.AST, names: Set[str]) -> bool:
            for n in ast.walk(expr):
                if isinstance(n, ast.Call) \
                        and call_name(n) in ("get_rank", "process_index"):
                    return True
                if isinstance(n, ast.Name) and n.id in names:
                    return True
            return False

        return process_local_names(fn_node, expr_local)

    @staticmethod
    def _guarded_regions(fn_node: ast.AST,
                         pidx_names: Set[str]) -> List[Tuple[int, int]]:
        """Line ranges only process 0 reaches: ``if <pidx> == 0:``
        bodies (``0 == pidx`` accepted; the else-arm is NOT guarded),
        and everything AFTER an ``if <pidx> != 0: return``-style
        early return (the other standard spelling of the same
        guard)."""
        out: List[Tuple[int, int]] = []

        def zero_compare(test: ast.AST, op_type) -> bool:
            for n in ast.walk(test):
                if isinstance(n, ast.Compare) \
                        and len(n.ops) == 1 \
                        and isinstance(n.ops[0], op_type):
                    sides = [n.left] + list(n.comparators)
                    names = {s.id for s in sides
                             if isinstance(s, ast.Name)}
                    zeros = any(isinstance(s, ast.Constant)
                                and s.value == 0 for s in sides)
                    if zeros and names & pidx_names:
                        return True
            return False

        for node in ast.walk(fn_node):
            if not isinstance(node, ast.If):
                continue
            if zero_compare(node.test, ast.Eq):
                last = node.body[-1]
                out.append((node.body[0].lineno,
                            getattr(last, "end_lineno", last.lineno)))
            elif zero_compare(node.test, ast.NotEq) and any(
                    isinstance(st, (ast.Return, ast.Raise))
                    for st in node.body):
                # every non-0 process left the function here: the
                # rest of it is process-0-only
                out.append((getattr(node, "end_lineno", node.lineno)
                            + 1, 10 ** 9))
        return out

    @staticmethod
    def _is_write_mode(call: ast.Call) -> bool:
        mode = None
        if len(call.args) >= 2:
            mode = call.args[1]
        for k in call.keywords:
            if k.arg == "mode":
                mode = k.value
        if mode is None:
            return False  # default "r"
        return isinstance(mode, ast.Constant) \
            and isinstance(mode.value, str) \
            and mode.value[:1] in ("w", "a", "x")

    @staticmethod
    def _singleton_in(call: ast.Call, module: Module, per, uniq
                      ) -> Optional[str]:
        """The singleton mark the open()'s path argument names, via
        string literals, f-string pieces, or resolvable constants
        (``MANIFEST``); None when the path names no singleton."""
        if not call.args:
            return None
        for n in ast.walk(call.args[0]):
            s = None
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                s = n.value
            elif isinstance(n, ast.Name):
                s = resolve_str(n, module, per, uniq)
            if s is None:
                continue
            low = s.lower()
            for mark in SINGLETON_MARKS:
                if mark in low:
                    return s
        return None
