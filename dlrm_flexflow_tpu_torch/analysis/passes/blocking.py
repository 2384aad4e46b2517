"""blocking-under-lock pass: nothing that parks the holder may run
while a lock is held.

The serving/telemetry/resilience threads share a handful of
``threading.Lock``/``RLock`` objects; a thread that blocks while
holding one parks EVERY other thread needing that lock — the
dispatcher stalls behind a disk flush, the scrape thread behind a
device sync, the watchdog behind a sleep.  PR 18's "dispatch under the
lock, single wait outside it" contract (``serving/engine.py``'s
``_dispatch``: ``runner.run_locked`` under the engine's lock, then the
one ``out.cpu().numpy()`` fence outside it) was a prose claim; this
pass makes it an invariant.

Detection is interprocedural the shared-state way (``_locked.py``):
every function is walked with the lock-held set carried through
``with`` items AND into resolved callees, so a helper three frames
below the ``with`` is flagged at the blocking SITE with the
acquisition site named in the message.  Four codes, one per blocking
family:

* ``device-sync-under-lock`` — torch's host syncs: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``, and
  ``torch.cuda.synchronize()``/``Event.synchronize()``/
  ``Stream.synchronize()`` (each ``.synchronize()``);
* ``sleep-under-lock``       — ``time.sleep`` and any ``.sleep()``;
* ``wait-under-lock``        — ``Event.wait``/``.wait()``,
  ``Thread.join`` (str/``os.path`` joins excluded), blocking
  ``.get()``/``.put()`` on attributes initialized to a
  ``queue.Queue`` family ctor (``get_nowait``/``put_nowait`` are
  different names and never match), and a raw ``torch.distributed``
  collective (``_spmd.DIST_COLLECTIVES``): it parks the caller until
  every rank of its group arrives;
* ``io-under-lock``          — ``open``/``print``, ``.write``/
  ``.flush``/``.read``/``.readline``, ``serve_forever``, socket
  ``.sendall``/``.recv``.

Known limit: ``Condition.wait`` releases its own lock while waiting —
but the lock table only tracks ``Lock``/``RLock`` ctors, so a
condition's underlying lock is never in the held set and the
sanctioned ``with cv: cv.wait()`` idiom cannot fire.  A ``.wait()``
on an Event while holding an UNRELATED Lock still fires, which is the
bug this pass exists for.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import AnalysisPass, Finding, FunctionIndex, Module
from ._locked import walk_under_locks
from ._spmd import get_dist_aliases, raw_collective
from .locks import get_lock_table
from .purity import module_aliases, numpy_names, numpy_valued, to_cpu

#: blocking bare-name calls -> code
BLOCKING_NAMES: Dict[str, str] = {
    "open": "io-under-lock",
    "print": "io-under-lock",
    "sleep": "sleep-under-lock",
}

#: blocking attribute calls -> code (queue get/put handled separately —
#: they need the attr-is-a-Queue evidence to not flood on dict.get)
BLOCKING_ATTRS: Dict[str, str] = {
    "sleep": "sleep-under-lock",
    "write": "io-under-lock",
    "flush": "io-under-lock",
    "read": "io-under-lock",
    "readline": "io-under-lock",
    "readinto": "io-under-lock",
    "serve_forever": "io-under-lock",
    "sendall": "io-under-lock",
    "recv": "io-under-lock",
    "join": "wait-under-lock",
    "wait": "wait-under-lock",
    "item": "device-sync-under-lock",
    "tolist": "device-sync-under-lock",
    "cpu": "device-sync-under-lock",
    "numpy": "device-sync-under-lock",
    "synchronize": "device-sync-under-lock",
}

#: queue ctor names whose instances block on get/put
QUEUE_CTORS = frozenset({"Queue", "LifoQueue", "PriorityQueue",
                         "SimpleQueue", "JoinableQueue"})


def _queue_attrs(modules: List[Module]) -> Set[Tuple[str, str]]:
    """(class, attr) initialized to a queue ctor anywhere in the
    class — the evidence that makes ``self.X.get()`` a blocking queue
    wait instead of a dict lookup."""
    out: Set[Tuple[str, str]] = set()
    for m in modules:
        for cls in ast.walk(m.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for node in ast.walk(cls):
                value = tgts = None
                if isinstance(node, ast.Assign):
                    value, tgts = node.value, node.targets
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
                    value, tgts = node.value, [node.target]
                if not isinstance(value, ast.Call):
                    continue
                fn = value.func
                ctor = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else None)
                if ctor not in QUEUE_CTORS:
                    continue
                for t in tgts:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        out.add((cls.name, t.attr))
    return out


def _join_exempt(fn: ast.Attribute) -> bool:
    """``"sep".join(...)`` is str.join; ``os.path.join`` builds a
    path — neither parks a thread."""
    v = fn.value
    if isinstance(v, ast.Constant):
        return True
    if isinstance(v, ast.Attribute) and v.attr == "path":
        return True
    if isinstance(v, ast.Name) and v.id in ("os", "posixpath",
                                            "ntpath", "path"):
        return True
    return False


class BlockingUnderLockPass(AnalysisPass):
    name = "blocking-under-lock"
    description = ("no device sync / sleep / queue-or-event wait / "
                   "file-socket I/O while any lock is held "
                   "(lock-held sets carried through calls)")

    def run(self, modules: List[Module],
            index: FunctionIndex) -> List[Finding]:
        locks = get_lock_table(modules, index)
        queue_attrs = _queue_attrs(modules)
        dist_alias = get_dist_aliases(modules, index)
        np_alias: Dict[str, Set[str]] = {
            m.name: module_aliases(m)[0] for m in modules}
        np_locals: Dict[str, Set[str]] = {}

        def host_only(call: ast.Call, mod: Module, qual: str) -> bool:
            """A sync-named call on a numpy value: host work."""
            aliases = np_alias.get(mod.name, set())
            if not aliases:
                return False
            names = np_locals.get((mod.name, qual))
            if names is None:
                fn = next((n for n, o in index.owner.items()
                           if o[0] is mod and o[1] == qual), None)
                names = np_locals[(mod.name, qual)] = (
                    numpy_names(fn, aliases) if fn is not None else set())
            return numpy_valued(call.func.value, aliases, names)

        # (path, line, code) -> finding; first (smallest-held, the
        # site's own lock context walks first) wins
        found: Dict[Tuple[str, int, str], Finding] = {}

        def classify(call: ast.Call, mod: Module, cls: Optional[str],
                     qual: str) -> Optional[Tuple[str, str]]:
            fn = call.func
            if isinstance(fn, ast.Name):
                code = BLOCKING_NAMES.get(fn.id)
                if code is not None:
                    return code, f"{fn.id}()"
                return None
            if not isinstance(fn, ast.Attribute):
                return None
            attr = fn.attr
            if attr in ("get", "put"):
                # blocking only when the receiver is a known queue attr
                if isinstance(fn.value, ast.Attribute) \
                        and isinstance(fn.value.value, ast.Name) \
                        and fn.value.value.id == "self" \
                        and cls is not None \
                        and (cls, fn.value.attr) in queue_attrs:
                    return ("wait-under-lock",
                            f"self.{fn.value.attr}.{attr}()")
                return None
            nm = raw_collective(call, dist_alias.get(mod.name, set()))
            if nm is not None:
                return "wait-under-lock", f"torch.distributed.{nm}()"
            if attr == "to" and to_cpu(call):
                return "device-sync-under-lock", ".to('cpu')"
            code = BLOCKING_ATTRS.get(attr)
            if code is None:
                return None
            if code == "device-sync-under-lock" \
                    and host_only(call, mod, qual):
                return None
            if attr == "join" and _join_exempt(fn):
                return None
            return code, f".{attr}()"

        def on_node(node, held, where, ctx):
            if not held or not isinstance(node, ast.Call):
                return
            mod, qual, cls = ctx
            hit = classify(node, mod, cls, qual)
            if hit is None:
                return
            code, what = hit
            key = (mod.relpath, node.lineno, code)
            if key in found:
                return
            lock = sorted(held)[0]
            origin = where.get(lock, "?")
            found[key] = self.finding(
                mod.relpath, node.lineno, code,
                f"{what} blocks while {lock} is held "
                f"(acquired in {origin}) in {qual} — a stalled holder "
                f"parks every thread needing the lock",
                detail=qual)

        seen: Set[Tuple[ast.AST, frozenset]] = set()
        roots = sorted(index.owner,
                       key=lambda n: (index.owner[n][0].relpath,
                                      getattr(n, "lineno", 0)))
        for root in roots:
            walk_under_locks(root, index, locks, on_node, seen=seen)

        findings = sorted(found.values(),
                          key=lambda f: (f.path, f.line, f.code))
        return findings
