"""shared-state pass: cross-thread attribute access needs a common lock.

The serving/telemetry side of the framework is multi-threaded by
design: the DynamicBatcher dispatcher, the /metrics scrape threads, and
(ROADMAP 4) the parameter hot-swap path all touch objects that client
threads touch through the public API.  The working convention — earned
through PR-5's two real serving lock bugs — is that every instance
attribute shared between a thread body and the public API is either

* written only during construction (immutable after ``__init__``),
* a thread-safe primitive (``queue.Queue``, ``threading.Event``, ...),
* or protected by ONE lock both sides hold.

This pass machine-checks that: thread entry points come from the
shared ctor-site inventory (``_threads.py`` — the target resolves like
any call: ``self._loop``, a bare name, or a unique/signature-narrowed
method), the attribute read/write sets reachable from them
(interprocedural, lock-held sets carried through calls via the shared
``_locked.py`` walker over ``locks.py``'s lock discovery) are compared
against the sets reachable from the same classes' public methods, and
an attribute touched on both sides — with at least one write — where
some thread-side access and some public-side access hold NO common
lock is a finding.

Code: ``unlocked-shared-attr``.  The deliberate exceptions (the
engine's double-checked bucket-cache read, GIL-atomic by construction)
live in the waiver baseline with their justification, exactly like the
lock-discipline ones.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import (AnalysisPass, Finding, FunctionIndex, Module,
                      get_callgraph)
from ._locked import walk_under_locks
from ._threads import thread_entry_notes
from .locks import get_lock_table

#: constructor callees whose instances are thread-safe by design — an
#: attribute initialized to one of these never needs an external lock.
THREADSAFE_CTORS = frozenset({
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "Event",
    "Condition", "Semaphore", "BoundedSemaphore", "Barrier", "Lock",
    "RLock", "local", "deque", "ThreadPoolExecutor"})

#: method calls that mutate a container in place — counted as writes to
#: the attribute holding the container.
MUTATORS = frozenset({
    "append", "appendleft", "add", "update", "setdefault", "pop",
    "popleft", "clear", "extend", "remove", "discard", "insert",
    "sort"})


class _Access:
    __slots__ = ("cls", "attr", "kind", "path", "line", "qual", "held")

    def __init__(self, cls: str, attr: str, kind: str, path: str,
                 line: int, qual: str, held: frozenset):
        self.cls = cls
        self.attr = attr
        self.kind = kind        # "read" | "write"
        self.path = path
        self.line = line
        self.qual = qual
        self.held = held


class SharedStatePass(AnalysisPass):
    name = "shared-state"
    description = ("attributes shared between thread bodies and the "
                   "public API must be immutable, thread-safe, or "
                   "guarded by a common lock")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        self._index = index
        self._locks = get_lock_table(modules, index)
        self._cg = get_callgraph(modules, index)

        thread_entries = set(thread_entry_notes(modules, index))
        if not thread_entries:
            return []

        # accesses reachable from the thread targets
        thread_acc: List[_Access] = []
        seen: Set[Tuple[ast.AST, frozenset]] = set()
        for entry in sorted(thread_entries,
                            key=lambda n: getattr(n, "lineno", 0)):
            self._collect(entry, thread_acc, seen)

        # the classes a thread touches; their public surface is the
        # other side of the race
        classes = {a.cls for a in thread_acc}
        public_entries = [
            node for node, (mod, qual, cls, _s) in index.owner.items()
            if cls in classes and not qual.split(".")[-1].startswith("_")
            and node not in thread_entries]
        public_acc: List[_Access] = []
        seen = set()
        for entry in public_entries:
            self._collect(entry, public_acc, seen)

        exempt = self._exempt_attrs(modules)
        by_key_t: Dict[Tuple[str, str], List[_Access]] = {}
        for a in thread_acc:
            by_key_t.setdefault((a.cls, a.attr), []).append(a)
        by_key_p: Dict[Tuple[str, str], List[_Access]] = {}
        for a in public_acc:
            by_key_p.setdefault((a.cls, a.attr), []).append(a)

        findings: List[Finding] = []
        for key in sorted(set(by_key_t) & set(by_key_p)):
            cls, attr = key
            if key in exempt or attr in self._locks.attr_classes:
                continue
            ts, ps = by_key_t[key], by_key_p[key]
            if not any(a.kind == "write" for a in ts + ps):
                continue  # read-only on both sides: immutable config
            worst: Optional[Tuple[_Access, _Access]] = None
            for t in ts:
                for p in ps:
                    if t.kind != "write" and p.kind != "write":
                        continue
                    if t.held & p.held:
                        continue  # a common lock covers this pair
                    if worst is None:
                        worst = (t, p)
            if worst is None:
                continue
            t, p = worst
            site = t if t.kind == "write" or p.kind != "write" else p
            other = p if site is t else t
            findings.append(self.finding(
                site.path, site.line, "unlocked-shared-attr",
                f"self.{attr} is {site.kind[:4]}{'ten' if site.kind == 'write' else ''} "
                f"in {site.qual} "
                f"({'no lock held' if not site.held else 'holding ' + '/'.join(sorted(site.held))}) "
                f"and {other.kind} by the other side in {other.qual} at "
                f"{other.path}:{other.line} with no common lock — "
                f"dispatcher thread and public API race on {cls}.{attr}",
                detail=f"{cls}.{attr}"))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings

    # ------------------------------------------------------------ discovery
    def _exempt_attrs(self, modules: List[Module]
                      ) -> Set[Tuple[str, str]]:
        """(class, attr) initialized to a thread-safe primitive."""
        out: Set[Tuple[str, str]] = set()
        for m in modules:
            for cls in ast.walk(m.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                for node in ast.walk(cls):
                    if not (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Call)):
                        continue
                    fn = node.value.func
                    ctor = fn.id if isinstance(fn, ast.Name) else (
                        fn.attr if isinstance(fn, ast.Attribute)
                        else None)
                    if ctor not in THREADSAFE_CTORS:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self":
                            out.add((cls.name, t.attr))
        return out

    # ----------------------------------------------------------- collection
    def _collect(self, fn_node: ast.AST, out: List[_Access],
                 seen: Set[Tuple[ast.AST, frozenset]]) -> None:
        """Record every ``self.X`` access reachable from ``fn_node``
        with the lock set held at that point — the shared ``_locked``
        walker carries caller-held locks into callees, which is what
        makes the InferenceEngine's under-lock write visible as locked
        even when the lock was taken one frame up."""

        def on_node(node, held, _where, ctx):
            _mod, qual, cls = ctx
            if cls is None:
                return
            path = _mod.relpath
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                kind = "write" if isinstance(node.ctx,
                                             (ast.Store, ast.Del)) \
                    else "read"
                out.append(_Access(cls, node.attr, kind, path,
                                   node.lineno, qual, held))
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)) \
                    and isinstance(node.value, ast.Attribute) \
                    and isinstance(node.value.value, ast.Name) \
                    and node.value.value.id == "self":
                # self._cache[k] = v mutates the container
                out.append(_Access(cls, node.value.attr, "write",
                                   path, node.lineno, qual, held))
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr in MUTATORS \
                        and isinstance(fn.value, ast.Attribute) \
                        and isinstance(fn.value.value, ast.Name) \
                        and fn.value.value.id == "self":
                    # self._buf.append(x) mutates the container
                    out.append(_Access(cls, fn.value.attr, "write",
                                       path, node.lineno, qual, held))

        walk_under_locks(fn_node, self._index, self._locks, on_node,
                         seen=seen, skip_init=True)
