"""Dapper-style span tracing over the EventLog (counterpart of
``dlrm_flexflow_tpu/telemetry/trace.py``, the same API and events).

A :class:`Span` is a timed, attributed region with identity
(``trace_id``/``span_id``/``parent_id``); closing it emits ONE
schema-checked ``span`` event into the active EventLog.  A serving
request is a chain ``serve.request`` -> ``serve.queue_wait`` and
``serve.forward``, its micro-batch ``serve.dispatch`` -> ``serve.pad``,
``serve.engine_forward``; a training run is ``train.fit`` ->
``train.epoch`` -> ``train.dispatch``.  ``exporter.chrome_trace`` renders
them on per-thread tracks.

Two APIs, both thread-safe:

* implicit: ``with span("name"):`` parents to the per-thread current
  span (a thread-local stack);
* explicit: ``start_span(...)`` / ``Span.end(status)`` for regions that
  open on one thread and close on another (a request's root span opens
  at ``submit`` on the client thread and closes on the dispatcher
  thread), plus ``record_span`` for an already-timed child.

Tracing is OFF unless an EventLog is active: every entry point checks
``active_log()`` once and returns the :data:`NULL_SPAN` no-op, so traced
code paths pay one global read when telemetry is off.  A span ends
exactly once: the first ``end`` wins, later calls do nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Union

from .events import active_log, emit

_tls = threading.local()

# Open-span registry for the flight recorder (telemetry/fleet.py): the
# spans still open when a run dies are the regions it died inside.  Lock
# free, as the recorder reads it inside exception handling: a plain dict
# of weakrefs changed only by single dict operations and read through a
# list() snapshot, so an abandoned span cannot leak.
_open_spans: Dict[str, "weakref.ref[Span]"] = {}


def _register_open(sp: "Span") -> None:
    if len(_open_spans) > 8192:  # prune dead refs, bound the table
        for key in [k for k, r in list(_open_spans.items())
                    if r() is None]:
            _open_spans.pop(key, None)
    _open_spans[sp.span_id] = weakref.ref(sp)


def open_span_records() -> List[Dict[str, Any]]:
    """Every span opened but not yet ended, as plain dicts for the
    flight-recorder JSON; ``age_us`` is how long each has been open."""
    now = time.perf_counter()
    out: List[Dict[str, Any]] = []
    for ref in list(_open_spans.values()):
        sp = ref()
        if sp is None or sp.ended:
            continue
        out.append({"name": sp.name, "trace_id": sp.trace_id,
                    "span_id": sp.span_id, "parent_id": sp.parent_id,
                    "start_s": sp._start_s,
                    "age_us": (now - sp._t0) * 1e6,
                    "thread": sp._thread, "tid": sp._tid,
                    "attrs": (dict(sp.attrs) if sp.attrs else None)})
    return out

def _rand_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


class _NullSpan:
    """The no-op span every API returns while tracing is off: swallows
    attrs and ends, is falsy, and parents nothing."""

    __slots__ = ()
    name = None
    trace_id = None
    span_id = None
    parent_id = None

    def set_attr(self, key, value):
        return self

    def end(self, status: str = "ok", dur_us: Optional[float] = None):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


NULL_SPAN = _NullSpan()
SpanLike = Union["Span", _NullSpan]


class Span:
    """One timed region.  Construct via :func:`start_span` /
    :func:`span` (they handle the tracing-off no-op and parenting);
    close with :meth:`end` — idempotent, first close wins and emits the
    ``span`` event.  ``thread``/``tid`` record the OPENING thread (the
    region's origin — a request span that closes on the dispatcher
    still belongs to its client's track)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "status", "_start_s", "_t0", "_thread", "_tid",
                 "_lock", "_ended", "__weakref__")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 start_s: Optional[float] = None,
                 t0: Optional[float] = None):
        self.name = str(name)
        self.trace_id = trace_id or _rand_id()
        self.span_id = _rand_id()
        self.parent_id = parent_id
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.status: Optional[str] = None
        self._start_s = time.time() if start_s is None else float(start_s)
        self._t0 = time.perf_counter() if t0 is None else float(t0)
        th = threading.current_thread()
        self._thread = th.name
        self._tid = int(th.ident or 0)
        self._lock = threading.Lock()
        self._ended = False
        _register_open(self)

    def set_attr(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    @property
    def ended(self) -> bool:
        return self._ended

    def end(self, status: str = "ok",
            dur_us: Optional[float] = None) -> Optional[dict]:
        """Close the span and emit its event (into whatever log is
        active NOW — a span outliving its log is silently dropped, like
        every producer).  Exactly-once: only the first call emits;
        later calls return None."""
        with self._lock:
            if self._ended:
                return None
            self._ended = True
        _open_spans.pop(self.span_id, None)
        if dur_us is None:
            dur_us = (time.perf_counter() - self._t0) * 1e6
        self.status = status
        return emit("span", name=self.name, trace_id=self.trace_id,
                    span_id=self.span_id, parent_id=self.parent_id,
                    start_s=self._start_s, dur_us=float(dur_us),
                    status=status, attrs=(self.attrs or None),
                    thread=self._thread, tid=self._tid)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.end(status="error" if exc_type is not None else "ok")
        return False

    def __bool__(self):
        return True

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, ended={self._ended})")


# ------------------------------------------------------- per-thread current
def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional[Span]:
    """This thread's innermost open span (the implicit parent), or
    None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def push_span(sp: SpanLike) -> SpanLike:
    """Make ``sp`` this thread's current span (explicit-API callers
    that cannot use the ``span()`` context manager without reindenting
    a whole loop body pair this with :func:`pop_span` in a
    try/finally).  No-op for the null span."""
    if sp:
        _stack().append(sp)
    return sp


def pop_span(sp: SpanLike) -> None:
    """Undo :func:`push_span` (tolerant: pops ``sp`` wherever it sits,
    no-ops when absent)."""
    if not sp:
        return
    st = _stack()
    if st and st[-1] is sp:
        st.pop()
    elif sp in st:
        st.remove(sp)


# ------------------------------------------------------------------ opening
def start_span(name: str, parent: Optional[SpanLike] = None,
               attrs: Optional[Dict[str, Any]] = None) -> SpanLike:
    """Open a span (tracing off -> :data:`NULL_SPAN`).  ``parent``
    defaults to this thread's current span; a parentless span roots a
    fresh trace.  The caller owns closing it (``end``) — use
    :func:`span` for scoped regions."""
    if active_log() is None:
        return NULL_SPAN
    if parent is None:
        parent = current_span()
    if not parent:
        return Span(name, attrs=attrs)
    return Span(name, trace_id=parent.trace_id, parent_id=parent.span_id,
                attrs=attrs)


@contextlib.contextmanager
def span(name: str, attrs: Optional[Dict[str, Any]] = None,
         parent: Optional[SpanLike] = None):
    """Scoped span: opens, becomes the thread's current span for the
    block (children parent to it implicitly), and closes on exit —
    ``status="error"`` when the block raised, ``"ok"`` otherwise unless
    the body already ended it with its own status."""
    sp = start_span(name, parent=parent, attrs=attrs)
    if not sp:
        yield sp
        return
    push_span(sp)
    try:
        yield sp
    except BaseException:
        pop_span(sp)
        sp.end(status="error")
        raise
    else:
        pop_span(sp)
        sp.end()


def record_span(name: str, start_s: float, dur_us: float,
                parent: Optional[SpanLike] = None,
                status: str = "ok",
                attrs: Optional[Dict[str, Any]] = None) -> Optional[dict]:
    """Emit one already-timed span (opened and closed in the past) —
    how the batcher gives EVERY request of a micro-batch its own
    ``serve.forward`` child sharing the batch's single engine wall.
    No-op when tracing is off or ``parent`` is the null span (the
    request was submitted while tracing was off: there is no trace to
    join)."""
    if active_log() is None:
        return None
    if parent is not None and not parent:
        return None
    th = threading.current_thread()
    return emit("span", name=str(name),
                trace_id=(parent.trace_id if parent else _rand_id()),
                span_id=_rand_id(),
                parent_id=(parent.span_id if parent else None),
                start_s=float(start_s), dur_us=float(dur_us),
                status=status, attrs=(dict(attrs) if attrs else None),
                thread=th.name, tid=int(th.ident or 0))
