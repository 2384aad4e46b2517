"""Process-wide EventLog: JSONL sink + in-memory ring of typed events
(counterpart of ``dlrm_flexflow_tpu/telemetry/events.py``).

One log is process-wide "active" at a time (``set_event_log`` / the
``event_log`` context manager); the port's producers (``FFModel.fit``,
``train_epoch(s)``, the serving engine and batcher, the CUDA-graph
captures and kernel builds through ``torch_hooks``, ``profiling.OpTimer``)
look it up with ``active_log()`` and do nothing when telemetry is off:
the hot paths pay one global read.

Emission validates against the schema (``schema.py``, equal to the JAX
package's) and raises on drift; an event costs a dict, a validation
sweep and one buffered line write, microseconds, at the intended rates
(per epoch, per dispatch, per capture; never per sample).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from .schema import validate_event


def _jsonable(v):
    """Coerce numpy scalars, arrays and tensors to plain JSON types so the
    schema's isinstance checks and ``json.dumps`` both see native
    Python values."""
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        v = float(v)
    if isinstance(v, float) and not np.isfinite(v):
        # NaN/Inf serialize as spec-INVALID JSON tokens; None round-trips
        # (dropped as a top-level field, null inside dicts/lists)
        return None
    if isinstance(v, np.ndarray):
        return _jsonable(v.tolist())  # recurse: NaN/Inf elements -> None
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "detach") and hasattr(v, "cpu"):
        v = v.detach().cpu()  # a tensor of any rank, on any device
    if hasattr(v, "__array__") and not isinstance(v, (str, bytes)):
        arr = np.asarray(v)
        return _jsonable(arr.item() if arr.ndim == 0 else arr.tolist())
    return v


class EventLog:
    """Typed event log: every ``emit`` validates against the schema,
    lands in a bounded in-memory ring, and (when ``path`` is set)
    appends one JSON line to the sink.

    ``mode="w"`` truncates (one file per run); the default ``"a"``
    appends across restarts.

    ``stamp`` (a dict of schema COMMON_OPTIONAL fields, such as
    ``{"pidx": 2, "slice": 1}``) is merged into every emitted event that
    does not already carry those fields: how a multi-process run marks
    which process produced each line, so ``report --fleet`` can merge the
    per-process sinks (``fleet.py``).
    """

    def __init__(self, path: Optional[str] = None, ring: int = 4096,
                 mode: str = "a", stamp: Optional[Dict[str, Any]] = None):
        self.path = path
        self.stamp = dict(stamp) if stamp else None
        self._ring: deque = deque(maxlen=ring)
        self._lock = threading.Lock()
        self._fh = open(path, mode) if path else None

    # ------------------------------------------------------------- emission
    def emit(self, type: str, **fields) -> Dict[str, Any]:
        """Emit one event; None-valued fields are dropped (so callers can
        pass optional data unconditionally).  Raises ValueError when the
        event does not match the schema — producers and the report CLI
        must not drift apart silently.  Sink I/O is BEST-EFFORT: a write
        failure (disk full, vanished tmpfile) must never abort the
        training/search/bench run that emitted — the sink is dropped
        with one stderr warning and events keep landing in the ring."""
        ev: Dict[str, Any] = {"type": type, "ts": time.time()}
        for k, v in fields.items():
            v = _jsonable(v)  # may yield None (e.g. a NaN float): drop
            if v is not None:
                ev[k] = v
        if self.stamp:
            for k, v in self.stamp.items():
                ev.setdefault(k, v)
        errs = validate_event(ev)
        if errs:
            raise ValueError(
                f"invalid telemetry event: {'; '.join(errs)} — event {ev!r}")
        with self._lock:
            self._ring.append(ev)
            if self._fh is not None:
                try:
                    # default=str: a value _jsonable could not coerce
                    # degrades to its repr instead of aborting the run
                    self._fh.write(json.dumps(ev, default=str) + "\n")
                    self._fh.flush()
                except (OSError, ValueError) as e:
                    # OSError: disk full / sink vanished; ValueError:
                    # writing a closed file.  Schema errors raised above
                    # never reach this block.
                    import sys
                    print(f"# telemetry sink failed, dropping "
                          f"{self.path!r}: {e!r}", file=sys.stderr)
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
        return ev

    # --------------------------------------------------------------- access
    def events(self, type: Optional[str] = None) -> List[Dict[str, Any]]:
        """Snapshot of the ring (optionally one type only), oldest first."""
        with self._lock:
            evs = list(self._ring)
        if type is not None:
            evs = [e for e in evs if e.get("type") == type]
        return evs

    def last(self, type: str) -> Optional[Dict[str, Any]]:
        """The newest event of ``type`` still in the ring, or None."""
        evs = self.events(type)
        return evs[-1] if evs else None

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------- active log
_active: Optional[EventLog] = None


def set_event_log(log: Optional[EventLog]) -> Optional[EventLog]:
    """Install ``log`` as the process-wide active log (None deactivates).
    Returns the PREVIOUS active log so callers can restore it.  The
    port's compile events come from its own capture and build sites
    (``torch_hooks.record_compile``), so there is no hook to install."""
    global _active
    prev = _active
    _active = log
    return prev


def active_log() -> Optional[EventLog]:
    """The producers' one-liner: the active log or None (telemetry off)."""
    return _active


def emit(type: str, **fields) -> Optional[Dict[str, Any]]:
    """Emit into the active log, or no-op when telemetry is off."""
    log = _active
    if log is None:
        return None
    return log.emit(type, **fields)


@contextlib.contextmanager
def suppressed():
    """Silence all producers for the block (timed measurement windows:
    an emit+flush between a timer start and its fence perturbs the wall
    it is recording), restoring the previous active log on exit."""
    prev = set_event_log(None)
    try:
        yield
    finally:
        set_event_log(prev)


@contextlib.contextmanager
def event_log(path: Optional[str] = None, ring: int = 4096, mode: str = "a",
              stamp: Optional[Dict[str, Any]] = None):
    """Scoped telemetry: activate a fresh EventLog for the block, restore
    the previous active log (and close this one) on exit."""
    log = EventLog(path=path, ring=ring, mode=mode, stamp=stamp)
    prev = set_event_log(log)
    try:
        yield log
    finally:
        set_event_log(prev)
        log.close()


# ------------------------------------------------------------ memory events
def sample_memory(phase: Optional[str] = None,
                  log: Optional[EventLog] = None) -> int:
    """Emit one ``memory`` event per CUDA device with the caching
    allocator's counters (``torch.cuda.memory_allocated`` and
    ``max_memory_allocated``, ``source="memory_stats"``), or, with no
    card, one aggregate host event (``device="all"``, the process's
    resident set size, ``source="rss"``), as the JAX package emits one
    aggregate event where its allocator exposes nothing.  Reading the
    counters does not synchronise the device.  Returns the number of
    events emitted; no-op when telemetry is off."""
    log = log or _active
    if log is None:
        return 0
    import torch

    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            log.emit("memory", device=f"cuda:{i}",
                     bytes_in_use=int(torch.cuda.memory_allocated(i)),
                     peak_bytes=int(torch.cuda.max_memory_allocated(i)),
                     source="memory_stats", phase=phase)
        return torch.cuda.device_count()
    log.emit("memory", device="all", bytes_in_use=_rss_bytes(),
             source="rss", phase=phase)
    return 1


def _rss_bytes() -> int:
    """The process's resident set size (Linux ``/proc``; the peak RSS
    from ``getrusage`` elsewhere)."""
    try:
        with open("/proc/self/statm") as f:
            import os
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        import resource
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
