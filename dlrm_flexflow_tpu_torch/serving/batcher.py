"""Dynamic micro-batching request queue (counterpart of
``dlrm_flexflow_tpu/serving/batcher.py``).

Online DLRM traffic arrives one small request at a time; the card wants
bucket-sized batches.  :class:`DynamicBatcher` sits between them: a
BOUNDED request queue feeding one dispatcher thread that coalesces
requests into micro-batches — dispatching as soon as ``max_batch_size``
rows are waiting or the oldest request has waited ``max_wait_us`` — and
fans results back out through per-request futures.

Overload is explicit, never silent: a full queue rejects at ``submit``
(:class:`Rejected`), and a request older than its deadline when popped
completes with :class:`DeadlineExceeded`.  ``close`` drains: submissions
stop, every queued request still gets its response, then the dispatcher
exits and a ``serve`` summary event is emitted.

Telemetry: every shed, deadline miss and dispatcher death is an event,
and ``/metrics`` scrapes the queue depth and counters while the batcher
lives (``telemetry.metrics.track_batcher``).  With an event log active,
each request is a span chain (``serve.request`` -> ``serve.queue_wait``,
``serve.forward``) with a tail exemplar, and each micro-batch a
``serve.dispatch`` span under which the engine's ``serve.pad`` and
``serve.engine_forward`` nest; with none, a request or a dispatch pays
one ``active_log()`` read for them.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np

from ..concurrency import CloseOnce
from ..telemetry import active_log, emit
from ..telemetry import metrics as _metrics
from ..telemetry.trace import (NULL_SPAN, pop_span, push_span, record_span,
                               start_span)
from .stats import LatencyStats


class Rejected(RuntimeError):
    """Request shed: the bounded queue was full (overload) or the batcher
    is shutting down."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it reached the card."""


class ServeFuture:
    """Per-request result slot: ``result(timeout)`` blocks until the
    dispatcher delivers the output array or an exception.  Completion is
    first-write-wins: the dispatcher and a racing close() never flip a
    delivered result.  Done callbacks run exactly once, outside the
    lock."""

    def __init__(self):
        self._ev = threading.Event()
        self._lk = threading.Lock()
        self._value = None
        self._exc: Optional[BaseException] = None
        self._cbs: List[Any] = []

    def _run_cbs(self, cbs) -> None:
        # a raising callback must not unwind the completing thread (it
        # would strand the rest of a batch's futures): report, carry on
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                traceback.print_exc()

    def _set(self, value) -> None:
        with self._lk:
            if self._ev.is_set():
                return
            self._value = value
            cbs, self._cbs = self._cbs, []
            self._ev.set()
        self._run_cbs(cbs)

    def _set_exception(self, exc: BaseException) -> None:
        with self._lk:
            if self._ev.is_set():
                return
            self._exc = exc
            cbs, self._cbs = self._cbs, []
            self._ev.set()
        self._run_cbs(cbs)

    def add_done_callback(self, cb) -> None:
        """Run ``cb(future)`` once the result or exception lands (at
        once when already done).  A raising callback is reported and
        swallowed, never propagated into the completing thread."""
        with self._lk:
            if not self._ev.is_set():
                self._cbs.append(cb)
                return
        self._run_cbs([cb])

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("serve result not ready")
        with self._lk:
            if self._exc is not None:
                raise self._exc
            return self._value


class _Request:
    __slots__ = ("inputs", "rows", "future", "t_submit", "deadline_us",
                 "span", "qspan")

    def __init__(self, inputs: Dict[str, np.ndarray], rows: int,
                 deadline_us: float):
        self.inputs = inputs
        self.rows = rows
        self.future = ServeFuture()
        self.t_submit = time.perf_counter()
        self.deadline_us = deadline_us  # 0 = no deadline
        # the request's root span and its queue-wait child (NULL_SPAN
        # while no event log is active); Span.end is first-close-wins
        self.span = NULL_SPAN
        self.qspan = NULL_SPAN


_STOP = object()


class DynamicBatcher:
    """See module docstring.  Knob defaults come from the engine's
    ``FFConfig``: ``serve_max_batch`` (0 = the engine's top bucket),
    ``serve_max_wait_us``, ``serve_queue_depth``, ``serve_timeout_us``
    (0 = no per-request deadline).  ``autostart=False`` leaves the
    dispatcher stopped until :meth:`start`."""

    def __init__(self, engine, max_batch_size: Optional[int] = None,
                 max_wait_us: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 timeout_us: Optional[float] = None,
                 autostart: bool = True,
                 stats: Optional[LatencyStats] = None):
        cfg = engine.model.config
        self.engine = engine
        self.max_batch_size = int(
            max_batch_size
            or getattr(cfg, "serve_max_batch", 0)
            or engine.buckets[-1])
        self.max_wait_us = float(
            getattr(cfg, "serve_max_wait_us", 2000.0)
            if max_wait_us is None else max_wait_us)
        depth = int(getattr(cfg, "serve_queue_depth", 256)
                    if queue_depth is None else queue_depth)
        self.timeout_us = float(getattr(cfg, "serve_timeout_us", 0.0)
                                if timeout_us is None else timeout_us)
        # a FRESH accumulator per batcher: its summary describes exactly
        # this batcher's traffic
        self.stats: LatencyStats = stats or LatencyStats()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._closed = False
        # serializes submit's closed-check-then-enqueue against close(),
        # so no request lands behind the shutdown sentinel
        self._intake_lock = threading.Lock()
        self._closer = CloseOnce()
        self._thread: Optional[threading.Thread] = None
        # one request held over from a batch it would have overflowed
        self._carry: Optional[_Request] = None
        self._cancelling = False  # close(drain=False) in progress
        # health, under _intake_lock: the exception that killed the
        # dispatcher (None while healthy) and the engine failures since
        # the last success (written by the dispatcher thread only)
        self._dispatch_exc: Optional[BaseException] = None
        self._engine_failures = 0
        _metrics.track_batcher(self)
        if autostart:
            self.start()

    # ---------------------------------------------------------------- intake
    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="dlrm-serve-batcher",
                                            daemon=True)
            self._thread.start()

    def submit(self, inputs: Dict[str, Any],
               timeout_us: Optional[float] = None,
               record_shed: bool = True) -> ServeFuture:
        """Enqueue one request (dict name -> (n, ...) array, or one
        unbatched sample); returns its :class:`ServeFuture`.  Raises
        :class:`Rejected` at once when the queue is full or the batcher
        is closed.

        ``record_shed=False`` makes a refusal silent (no shed counted, no
        reject event, the request's span closed as ``probe_refused``):
        the ``ReplicaRouter`` probes its replicas so, and records the one
        shed itself when every replica refused."""
        if self._closed:
            if record_shed:
                # record_shed_late: the batcher may already be retired
                # from /metrics, its stats folded
                _metrics.record_shed_late(self.stats, cause="shutdown")
                emit("serve", phase="reject", reason="shutdown")
                start_span("serve.request").set_attr(
                    "reason", "shutdown").end(status="shed")
            raise Rejected("batcher is shut down")
        arrs = {}
        rows = None
        for name, (shape, dtype) in self.engine._in_specs.items():
            if name not in inputs:
                raise ValueError(f"request missing input {name!r}")
            a = np.asarray(inputs[name], dtype=dtype)
            if a.shape == shape:  # single unbatched sample
                a = a[None]
            if a.shape[1:] != shape:
                raise ValueError(
                    f"request input {name!r} has feature shape "
                    f"{a.shape[1:]}, model expects {shape}")
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise ValueError(
                    f"inconsistent request rows: {name!r} has "
                    f"{a.shape[0]}, expected {rows}")
            arrs[name] = a
        if rows > self.max_batch_size:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch_size="
                f"{self.max_batch_size}; split it or call "
                f"engine.predict directly")
        req = _Request(arrs, rows,
                       self.timeout_us if timeout_us is None
                       else float(timeout_us))
        if active_log() is not None:
            # opened before the enqueue, so a shed request still leaves
            # one closed span with status="shed"
            req.span = start_span("serve.request", attrs={"rows": rows})
            req.qspan = start_span("serve.queue_wait", parent=req.span)
        shed = None
        with self._intake_lock:
            if self._closed:
                shed = "shutdown"
            else:
                try:
                    self._q.put_nowait(req)
                except queue.Full:
                    shed = "queue_full"
        if shed is not None:
            if record_shed:
                # either reason can race past the batcher's retire
                _metrics.record_shed_late(self.stats, cause=shed)
                emit("serve", phase="reject", reason=shed)
            # a silent probe's refusal is no shed: the next replica may
            # serve the request.  Its span still closes, once
            status = "shed" if record_shed else "probe_refused"
            req.qspan.end(status=status)
            req.span.set_attr("reason", shed)
            req.span.end(status=status)
            raise Rejected(
                "batcher is shut down" if shed == "shutdown" else
                f"request queue full ({self._q.maxsize} waiting) — "
                f"server overloaded, shedding")
        return req.future

    def predict(self, inputs: Dict[str, Any],
                timeout_us: Optional[float] = None,
                result_timeout_s: Optional[float] = None):
        """Blocking convenience: submit + wait for the result."""
        return self.submit(inputs, timeout_us).result(result_timeout_s)

    def queue_depth(self) -> int:
        """Requests waiting now (``Queue.qsize``, approximate)."""
        return self._q.qsize()

    def queue_full(self) -> bool:
        """Whether the bounded queue is full now (approximate, like
        :meth:`queue_depth`; ``submit`` stays the authority)."""
        return self._q.full()

    # ------------------------------------------------------------- dispatch
    def _expired(self, req: _Request, now: float) -> bool:
        return (req.deadline_us > 0
                and (now - req.t_submit) * 1e6 > req.deadline_us)

    def _collect(self) -> Optional[List[_Request]]:
        """Block for the first live request, then coalesce until
        ``max_batch_size`` rows are gathered or ``max_wait_us`` has
        elapsed since the first one.  None on the shutdown sentinel."""
        while True:
            with self._intake_lock:  # vs close(drain=False)'s carry flush
                head, self._carry = self._carry, None
            if head is None:
                head = self._q.get()
            if head is _STOP:
                return None
            if self._expired(head, time.perf_counter()):
                self._miss(head)
                continue
            head.qspan.end()  # queue wait ends when the batch forms
            batch, rows = [head], head.rows
            t0 = time.perf_counter()
            while rows < self.max_batch_size:
                wait_s = self.max_wait_us * 1e-6 - (time.perf_counter() - t0)
                if wait_s <= 0:
                    break
                try:
                    req = self._q.get(timeout=wait_s)
                except queue.Empty:
                    break
                if req is _STOP:
                    # deliver this batch first; exit on the next call (the
                    # slot get() just freed re-holds the sentinel)
                    self._q.put(_STOP)
                    break
                if self._expired(req, time.perf_counter()):
                    self._miss(req)
                    continue
                if rows + req.rows > self.max_batch_size:
                    # would overflow: dispatch what we have and lead the
                    # next batch with it, unless a close(drain=False)
                    # is cancelling
                    cancel = False
                    with self._intake_lock:
                        if self._cancelling:
                            cancel = True
                        else:
                            self._carry = req
                    if cancel:
                        self._cancel(req)
                    break
                req.qspan.end()
                batch.append(req)
                rows += req.rows
            return batch

    def _cancel(self, req: _Request) -> None:
        self.stats.record_reject()
        emit("serve", phase="reject", reason="shutdown")
        req.qspan.end(status="cancelled")
        req.span.set_attr("reason", "shutdown")
        req.span.end(status="cancelled")
        req.future._set_exception(Rejected("batcher closed without drain"))

    def _miss(self, req: _Request) -> None:
        self.stats.record_deadline_miss()
        emit("serve", phase="reject", reason="deadline")
        req.qspan.end(status="deadline")
        req.span.end(status="deadline")
        req.future._set_exception(DeadlineExceeded(
            f"request waited past its {req.deadline_us:.0f} us deadline"))

    def _loop(self) -> None:
        # the dispatcher must never die silently: an unexpected raise
        # would strand every queued future, so fail them all loudly
        batch: Optional[List[_Request]] = None
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    return
                self._dispatch(batch)
                batch = None
        except BaseException as e:
            self._dispatcher_died(e, batch or [])
            raise

    def _dispatch(self, batch: List[_Request]) -> None:
        joined = {name: np.concatenate([r.inputs[name] for r in batch],
                                       axis=0)
                  for name in self.engine._in_specs}
        traced = active_log() is not None
        dsp = NULL_SPAN
        if traced:
            # the micro-batch's span becomes this thread's current one,
            # so the engine's pad and forward spans nest under it
            rows = sum(r.rows for r in batch)
            dsp = push_span(start_span(
                "serve.dispatch", attrs={"requests": len(batch),
                                         "rows": rows}))
            fwd_start_s = time.time()
            t_fwd = time.perf_counter()
            timings = {}  # the engine fills bucket, pad_us, compute_us
        try:
            out = (self.engine.predict(
                joined, queue_wait_us=(t_fwd - min(
                    r.t_submit for r in batch)) * 1e6, timings=timings)
                if traced else self.engine.predict(joined))
        except Exception as e:  # deliver the failure, keep serving
            pop_span(dsp)
            dsp.end(status="error")
            for r in batch:
                r.span.end(status="error")
                r.future._set_exception(e)
            with self._intake_lock:  # the router's circuit breaker
                self._engine_failures += 1
            return
        if self._engine_failures:  # only this thread writes it
            with self._intake_lock:
                self._engine_failures = 0
        pop_span(dsp)
        self.stats.record_dispatch()
        done = time.perf_counter()
        lo = 0
        for r in batch:
            r.future._set(out[lo:lo + r.rows])
            lat_us = (done - r.t_submit) * 1e6
            self.stats.record(lat_us)
            if traced:
                self._trace_request(r, lat_us, int(timings.get(
                    "bucket", rows)), timings, t_fwd, fwd_start_s, done)
            lo += r.rows
        dsp.end()

    def _trace_request(self, r: _Request, lat_us: float, bucket: int,
                       timings: Dict[str, float], t_fwd: float,
                       fwd_start_s: float, done: float) -> None:
        """A delivered request's tail exemplar (its wall split into queue
        wait and the engine's pad / forward / stall, with its trace id)
        and its ``serve.forward`` span, which shares the batch's one
        engine wall."""
        fwd_us = (done - t_fwd) * 1e6
        self.stats.record_exemplar(
            bucket=bucket, lat_us=lat_us,
            trace_id=r.span.trace_id or "",
            queue_wait_us=(t_fwd - r.t_submit) * 1e6,
            pad_us=timings.get("pad_us", 0.0),
            compute_us=timings.get("compute_us", fwd_us),
            stall_us=timings.get("stall_us", 0.0))
        record_span("serve.forward", fwd_start_s, fwd_us, parent=r.span,
                    attrs={"rows": r.rows})
        r.span.end()

    # --------------------------------------------------------------- health
    def dispatcher_dead(self) -> bool:
        """Whether the dispatcher died unexpectedly: it recorded a fatal
        exception, or it was started, is no longer alive, and the
        batcher was never closed."""
        with self._intake_lock:
            if self._dispatch_exc is not None:
                return True
            dead_thread = (self._thread is not None
                           and not self._thread.is_alive())
            return dead_thread and not self._closed

    def consecutive_engine_failures(self) -> int:
        """Failed ``engine.predict`` dispatches since the last success."""
        with self._intake_lock:
            return self._engine_failures

    def fail_pending(self, exc: BaseException, extra=()) -> List[ServeFuture]:
        """Fail every pending request (the carry, the queue, and
        ``extra``) with ``exc`` and close intake.  Returns the futures
        actually failed."""
        with self._intake_lock:
            self._closed = True
            self._cancelling = True
            if self._dispatch_exc is None:
                self._dispatch_exc = exc
            pending = [self._carry] if self._carry is not None else []
            self._carry = None
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not _STOP:
                pending.append(req)
        pending.extend(r for r in extra if r is not None)
        failed: List[ServeFuture] = []
        for req in pending:
            if req.future.done():
                continue
            self.stats.record_reject()
            emit("serve", phase="reject", reason="replica_dead")
            req.qspan.end(status="error")
            req.span.set_attr("reason", "replica_dead")
            req.span.end(status="error")
            req.future._set_exception(exc)
            failed.append(req.future)
        return failed

    def _dispatcher_died(self, exc: BaseException, inflight) -> None:
        failed = self.fail_pending(exc, extra=inflight)
        emit("recovery", phase="dispatcher_died", error=repr(exc),
             failed=len(failed))
        print(f"# serve batcher: dispatcher thread died ({exc!r}) — "
              f"failed {len(failed)} pending request(s) loudly",
              file=sys.stderr)
        sys.stderr.flush()

    # ------------------------------------------------------------- shutdown
    def close(self, drain: bool = True,
              emit_summary: bool = True) -> Dict[str, float]:
        """Stop intake and shut the dispatcher down.  ``drain=True``: every
        queued request is dispatched and delivered first.
        ``drain=False``: pending requests complete with :class:`Rejected`.
        Returns the latency summary, and emits it as ``serve`` events
        unless ``emit_summary=False``; idempotent (a second close returns
        the first summary)."""
        return self._closer.run(lambda: self._close(drain, emit_summary))

    def _close(self, drain: bool, emit_summary: bool) -> Dict[str, float]:
        with self._intake_lock:
            self._closed = True
        # from here no submit can enqueue, so the sentinel is the queue's
        # LAST entry
        if not drain:
            with self._intake_lock:
                self._cancelling = True
                cancelled = [self._carry] if self._carry is not None else []
                self._carry = None
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                if req is not _STOP:
                    cancelled.append(req)
            for req in cancelled:
                self._cancel(req)
        if self._thread is None or not self._thread.is_alive():
            # never started: with drain, bring the dispatcher up so close()
            # keeps its deliver-everything contract
            with self._intake_lock:
                has_carry = self._carry is not None
            if drain and (has_carry or not self._q.empty()):
                self.start()
        if self._thread is not None and self._thread.is_alive():
            self._q.put(_STOP)
            self._thread.join()
        summary = (self.stats.emit_summary() if emit_summary
                   else self.stats.summary())
        _metrics.retire_batcher(self)
        return summary

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
