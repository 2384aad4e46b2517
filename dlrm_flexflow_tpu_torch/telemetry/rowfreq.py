"""Row-frequency telemetry: which embedding rows are hot (counterpart of
``dlrm_flexflow_tpu/telemetry/rowfreq.py``).

A :class:`RowFreqCounter` counts id accesses per embedding table on the
host, off the captured step: ``fit`` hands it the id batches it trains
on (:func:`observe_batch`, :func:`observe_dataset`), it counts every
``sample_every``-th batch only, and the whole thing is gated on
``active_log()``: with telemetry off the hot path pays one global read.

The summary a counter emits (one ``row_freq`` event per table) is a
power-of-two histogram (``bucket_counts[b]`` = number of distinct ids
accessed between ``2^b`` and ``2^(b+1)-1`` times) plus the top-k hottest
ids, hottest first.  :func:`hot_rows` is the admission read the tiered
store will use.
"""

from __future__ import annotations

import heapq
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .events import EventLog, active_log


class RowFreqCounter:
    """Bounded id-frequency counter for one embedding table.

    Counter state is guarded by a per-instance lock: the training thread
    writes through :meth:`observe` while readers take snapshots through
    :meth:`top`."""

    def __init__(self, table: str, capacity: int = 65536):
        self.table = str(table)
        self.capacity = int(capacity)
        self.counts: Dict[int, int] = {}
        self.rows_seen = 0
        self.sampled_batches = 0
        self.evicted = 0
        self._lock = threading.Lock()

    def observe(self, ids) -> None:
        """Count one batch of ids (any shape — flattened).  Cost is one
        ``np.unique`` over the batch plus a dict merge of its distinct
        ids — microseconds at DLRM batch sizes."""
        arr = _host(ids).reshape(-1)
        if arr.size == 0:
            return
        uniq, cnt = np.unique(arr, return_counts=True)
        with self._lock:
            self.rows_seen += int(arr.size)
            self.sampled_batches += 1
            counts = self.counts
            for i, n in zip(uniq.tolist(), cnt.tolist()):
                counts[i] = counts.get(i, 0) + n
            if len(counts) > 2 * self.capacity:
                self._prune()

    def _prune(self) -> None:
        # caller holds the lock.  Keep the hottest ``capacity`` ids: on
        # a power-law stream the dropped tail is ids seen a handful of
        # times, so the head ranking (what LFU admission reads)
        # survives eviction intact
        keep = heapq.nlargest(self.capacity, self.counts.items(),
                              key=lambda kv: (kv[1], -kv[0]))
        self.evicted += len(self.counts) - len(keep)
        self.counts = dict(keep)

    def _top(self, k: int) -> List[tuple]:
        # caller holds the lock
        return heapq.nsmallest(k, self.counts.items(),
                               key=lambda kv: (-kv[1], kv[0]))

    def top(self, k: int = 16) -> List[tuple]:
        """The k hottest (id, count) pairs, hottest first (count desc,
        then id asc for a deterministic order)."""
        with self._lock:
            return self._top(k)

    def head_mass(self, k: int) -> tuple:
        """(accesses landing in the k hottest ids, total accesses
        observed), one consistent snapshot: the ratio is the hit rate a
        k-slot LFU cache would have had on the observed stream, which is
        what the tiered-storage gate prices."""
        with self._lock:
            head = sum(c for _, c in self._top(k))
            return head, self.rows_seen

    def _buckets(self) -> List[int]:
        # caller holds the lock
        if not self.counts:
            return []
        out: List[int] = []
        for c in self.counts.values():
            b = max(int(c), 1).bit_length() - 1
            if b >= len(out):
                out.extend([0] * (b + 1 - len(out)))
            out[b] += 1
        return out

    def bucket_counts(self) -> List[int]:
        """``out[b]`` = distinct ids with count in [2^b, 2^(b+1))."""
        with self._lock:
            return self._buckets()

    def emit(self, log: Optional[EventLog] = None,
             top_k: int = 16) -> Optional[dict]:
        """Emit this table's ``row_freq`` summary event (no-op when
        telemetry is off or nothing was observed)."""
        log = log if log is not None else active_log()
        if log is None:
            return None
        with self._lock:  # snapshot only — the emit happens unlocked
            if not self.rows_seen:
                return None
            pairs = self._top(top_k)
            payload = dict(
                table=self.table, rows_seen=self.rows_seen,
                unique_ids=len(self.counts),
                top_ids=[int(i) for i, _ in pairs],
                top_counts=[int(c) for _, c in pairs],
                bucket_counts=self._buckets(),
                sampled_batches=self.sampled_batches,
                sample_every=_sample_every(),
                capacity=self.capacity,
                evicted=(self.evicted or None))
        return log.emit("row_freq", **payload)


# ------------------------------------------------------- process registry
# The fit loops observe through one process-wide registry keyed by
# table name, so a resumed fit keeps accumulating into the same
# counters.  The lock only guards registry mutation (counter creation /
# reset) — observe() itself runs on the single training thread.
_counters: Dict[str, RowFreqCounter] = {}
_lock = threading.Lock()
_batch_no = 0


def _sample_every() -> int:
    try:
        return max(1, int(os.environ.get("FF_ROWFREQ_EVERY", "8")))
    except ValueError:
        return 8


def counter(table: str, capacity: int = 65536) -> RowFreqCounter:
    c = _counters.get(table)
    if c is None:
        with _lock:
            c = _counters.setdefault(table,
                                     RowFreqCounter(table, capacity))
    return c


def reset() -> None:
    """Drop every counter and the batch cadence (tests)."""
    global _batch_no
    with _lock:
        _counters.clear()
        _batch_no = 0


def get(table: str) -> Optional[RowFreqCounter]:
    """The existing counter for ``table``, or None — unlike
    :func:`counter` this never creates one (admission probes must not
    fabricate empty counters for tables nothing observed)."""
    return _counters.get(table)


def hot_rows(table: str, k: int) -> List[tuple]:
    """The k hottest (id, count) pairs observed for ``table``, hottest
    first: what a tiered store's LFU warm start admits.  Empty when the
    table was never observed; one lock-guarded snapshot of the counter."""
    c = get(table)
    return c.top(k) if c is not None else []


def head_mass(table: str, k: int) -> tuple:
    """(accesses in ``table``'s k hottest ids, total observed), (0, 0)
    when never observed: head / total predicts a k-slot cache's hit
    rate for the tiered-storage gate."""
    c = get(table)
    return c.head_mass(k) if c is not None else (0, 0)


def _host(arr) -> np.ndarray:
    """A numpy view of ids: tensors (on any device) are copied to the
    host, one small device-to-host copy for a tensor on the card."""
    if hasattr(arr, "detach") and hasattr(arr, "cpu"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _is_ids(arr) -> bool:
    """Integer ids (numpy or torch), not dense features."""
    if hasattr(arr, "is_floating_point"):
        return not arr.is_floating_point() and not arr.is_complex()
    dt = getattr(arr, "dtype", None)
    return dt is not None and np.issubdtype(dt, np.integer)


def _tables(name: str, arr) -> List[tuple]:
    """Split one integer input tensor into per-table id streams: a
    DLRM sparse input is [batch, tables, bag], so axis 1 indexes the
    embedding table and each slice gets its own counter
    (``name[t]``); rank <= 2 inputs are one table."""
    a = _host(arr)
    if a.ndim >= 3:
        return [(f"{name}[{t}]", a[:, t]) for t in range(a.shape[1])]
    return [(name, a)]


def observe_batch(inputs: Dict[str, Any]) -> None:
    """The fit loops' hook: count the integer-id tensors of one input
    batch, every ``FF_ROWFREQ_EVERY``-th sampled batch only (default
    8), and only while telemetry is on — the hot path pays ~0."""
    if active_log() is None:
        return
    global _batch_no
    _batch_no += 1
    every = _sample_every()
    if every > 1 and _batch_no % every:
        return
    for name, arr in inputs.items():
        arr = getattr(arr, "local", arr)  # a GlobalArray: this rank's rows
        if not _is_ids(arr):
            continue  # dense features are not ids
        for tname, ids in _tables(name, _host(arr)):
            counter(tname).observe(ids)


def observe_dataset(inputs: Dict[str, Any]) -> None:
    """Scan-path hook: the fused/scanned fit stages the whole epoch as
    [num_batches, batch, ...] arrays up front and never loops on the
    host, so sample the staged dataset's batch slices once instead."""
    if active_log() is None:
        return
    every = _sample_every()
    for name, arr in inputs.items():
        if not _is_ids(arr):
            continue
        host = _host(arr)
        if host.ndim < 2:
            continue
        for b in range(0, host.shape[0], every):
            for tname, ids in _tables(name, host[b]):
                counter(tname).observe(ids)


def emit_all(log: Optional[EventLog] = None) -> int:
    """Emit one ``row_freq`` event per observed table (fit end / bench
    tail call this).  Returns the number of events emitted."""
    emitted = 0
    for c in list(_counters.values()):
        if c.emit(log) is not None:
            emitted += 1
    return emitted


def row_freq_summary(events: List[dict]) -> List[str]:
    """The ``== row frequency ==`` report section: per table (newest
    event wins), total and distinct ids, the hottest rows first, and
    the power-of-two count histogram."""
    rfs = [e for e in events if e.get("type") == "row_freq"]
    if not rfs:
        return []
    latest: Dict[str, dict] = {}
    for e in rfs:
        latest[e["table"]] = e
    lines = ["== row frequency =="]
    for table in sorted(latest):
        e = latest[table]
        lines.append(f"{table}: {e['rows_seen']} ids seen, "
                     f"{e['unique_ids']} distinct"
                     + (f", {e['evicted']} cold ids evicted"
                        if e.get("evicted") else ""))
        ids = e.get("top_ids") or []
        cts = e.get("top_counts") or []
        if ids:
            hot = "  ".join(f"{i}({c})" for i, c in
                            list(zip(ids, cts))[:8])
            lines.append(f"  hottest rows: {hot}")
        buckets = e.get("bucket_counts") or []
        if buckets:
            hist = "  ".join(f"2^{b}:{n}" for b, n in
                             enumerate(buckets) if n)
            lines.append(f"  count histogram: {hist}")
    return lines
