"""Dynamic micro-batching request queue (counterpart of
``dlrm_flexflow_tpu/serving/batcher.py``, without telemetry and trace
spans).

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
exits.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..concurrency import CloseOnce
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
    delivered result."""

    def __init__(self):
        self._ev = threading.Event()
        self._lk = threading.Lock()
        self._value = None
        self._exc: Optional[BaseException] = None

    def _set(self, value) -> None:
        with self._lk:
            if not self._ev.is_set():
                self._value = value
                self._ev.set()

    def _set_exception(self, exc: BaseException) -> None:
        with self._lk:
            if not self._ev.is_set():
                self._exc = exc
                self._ev.set()

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
    __slots__ = ("inputs", "rows", "future", "t_submit", "deadline_us")

    def __init__(self, inputs: Dict[str, np.ndarray], rows: int,
                 deadline_us: float):
        self.inputs = inputs
        self.rows = rows
        self.future = ServeFuture()
        self.t_submit = time.perf_counter()
        self.deadline_us = deadline_us  # 0 = no deadline


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
               timeout_us: Optional[float] = None) -> ServeFuture:
        """Enqueue one request (dict name -> (n, ...) array, or one
        unbatched sample); returns its :class:`ServeFuture`.  Raises
        :class:`Rejected` at once when the queue is full or the batcher
        is closed."""
        if self._closed:
            self.stats.record_reject()
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
            self.stats.record_reject()
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
                        self.stats.record_reject()
                        req.future._set_exception(Rejected(
                            "batcher closed without drain"))
                    break
                batch.append(req)
                rows += req.rows
            return batch

    def _miss(self, req: _Request) -> None:
        self.stats.record_deadline_miss()
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
        try:
            out = self.engine.predict(joined)
        except Exception as e:  # deliver the failure, keep serving
            for r in batch:
                r.future._set_exception(e)
            return
        self.stats.record_dispatch()
        done = time.perf_counter()
        lo = 0
        for r in batch:
            r.future._set(out[lo:lo + r.rows])
            self.stats.record((done - r.t_submit) * 1e6)
            lo += r.rows

    def fail_pending(self, exc: BaseException, extra=()) -> List[ServeFuture]:
        """Fail every pending request (the carry, the queue, and
        ``extra``) with ``exc`` and close intake.  Returns the futures
        actually failed."""
        with self._intake_lock:
            self._closed = True
            self._cancelling = True
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
            req.future._set_exception(exc)
            failed.append(req.future)
        return failed

    def _dispatcher_died(self, exc: BaseException, inflight) -> None:
        failed = self.fail_pending(exc, extra=inflight)
        print(f"# serve batcher: dispatcher thread died ({exc!r}) — "
              f"failed {len(failed)} pending request(s) loudly",
              file=sys.stderr)
        sys.stderr.flush()

    # ------------------------------------------------------------- shutdown
    def close(self, drain: bool = True) -> Dict[str, float]:
        """Stop intake and shut the dispatcher down.  ``drain=True``: every
        queued request is dispatched and delivered first.
        ``drain=False``: pending requests complete with :class:`Rejected`.
        Returns the latency summary; idempotent (a second close returns
        the first summary)."""
        return self._closer.run(lambda: self._close(drain))

    def _close(self, drain: bool) -> Dict[str, float]:
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
                self.stats.record_reject()
                req.future._set_exception(
                    Rejected("batcher closed without drain"))
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
        return self.stats.summary()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
