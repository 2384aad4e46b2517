"""Serving latency statistics (counterpart of
``dlrm_flexflow_tpu/serving/stats.py``).

One :class:`LatencyStats` per engine/batcher accumulates per-request
end-to-end latencies plus the overload/deadline counters, and folds them
into the ``serve`` ``phase="summary"`` telemetry event.  Percentiles use
linear interpolation between closest ranks (numpy's default
``percentile`` method).
"""

from __future__ import annotations

import bisect
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..telemetry.metrics import LATENCY_BUCKETS_US


class LatencyStats:
    """Thread-safe accumulator of per-request latencies (microseconds).

    ``max_samples`` bounds memory for long-running servers: once full,
    recording keeps COUNTING every request (``count`` / QPS stay exact)
    and maintains a uniform RESERVOIR sample (Vitter's algorithm R) of
    all latencies seen, so the percentile estimate keeps tracking live
    traffic instead of freezing on the first ``max_samples`` requests.

    Alongside the reservoir, every ``record`` increments one FIXED
    bucket counter (``LATENCY_BUCKETS_US`` + overflow: one bisect and
    one ``+= 1`` under the lock the record already holds), so the
    Prometheus exporter (telemetry/exporter.py) can serve cumulative
    ``_bucket`` counts per scrape without locking and scanning the full
    reservoir; ``summary()`` is unchanged and still reads the
    reservoir.  ``record_dispatch(bucket=...)`` likewise keeps
    per-bucket dispatch counts for the ``dlrm_serve_dispatches_total``
    family.
    """

    def __init__(self, max_samples: int = 100_000):
        self.max_samples = int(max_samples)
        self._lat_us: List[float] = []
        self._lock = threading.Lock()
        self._rng = random.Random(0x5e41)  # reservoir replacement draws
        self.count = 0
        self.rejected = 0
        self.deadline_misses = 0
        self.dispatches = 0
        # fixed-bucket histogram: one slot per LATENCY_BUCKETS_US edge
        # (counts values <= edge goes in the FIRST edge >= value) plus
        # the +Inf overflow slot; _lat_sum feeds the histogram's _sum
        self._hist = [0] * (len(LATENCY_BUCKETS_US) + 1)
        self._lat_sum = 0.0
        self.dispatch_buckets: Dict[int, int] = {}
        # per-BUCKET engine-forward latency histograms (the labeled
        # dlrm_serve_bucket_latency_us family + the serving-p99 bench
        # headline): same fixed edges, one slot list per bucket size,
        # fed by record_dispatch under the lock it already takes
        self._bucket_hist: Dict[int, List[int]] = {}
        self._bucket_lat_sum: Dict[int, float] = {}
        # shed counts split by cause (queue_full / deadline / shutdown
        # / replica_dead: the dlrm_serve_shed_total{cause=} family);
        # always a subset-sum of rejected + deadline_misses
        self._shed_causes: Dict[str, int] = {}
        # bounded top-K slowest requests per bucket, each carrying its
        # trace id + span-derived phase decomposition (queue-wait /
        # pad / engine-forward / storage miss-stall): the exporter's
        # exemplar lines and the tail events read these
        self.tail_k = 8
        self._tail: Dict[int, List[dict]] = {}
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------ recording
    def record(self, lat_us: float) -> None:
        lat = float(lat_us)
        with self._lock:
            self.count += 1
            self._lat_sum += lat
            self._hist[bisect.bisect_left(LATENCY_BUCKETS_US, lat)] += 1
            if len(self._lat_us) < self.max_samples:
                self._lat_us.append(lat)
            else:
                j = self._rng.randrange(self.count)
                if j < self.max_samples:
                    self._lat_us[j] = lat

    def record_many(self, lats_us) -> None:
        for v in lats_us:
            self.record(v)

    def record_reject(self, cause: str = "shutdown") -> None:
        """One shed request.  ``cause`` feeds the labelled
        dlrm_serve_shed_total split: "queue_full" (batcher queue at
        capacity) or "shutdown" (rejected while closing / replica
        lost)."""
        with self._lock:
            self.rejected += 1
            self._shed_causes[cause] = self._shed_causes.get(cause, 0) + 1

    def record_deadline_miss(self) -> None:
        with self._lock:
            self.deadline_misses += 1
            self._shed_causes["deadline"] = \
                self._shed_causes.get("deadline", 0) + 1

    def shed_causes(self) -> Dict[str, int]:
        """One locked snapshot of the per-cause shed counts."""
        with self._lock:
            return dict(self._shed_causes)

    def record_dispatch(self, bucket: Optional[int] = None,
                        lat_us: Optional[float] = None) -> None:
        """One engine dispatch; ``lat_us`` (the engine-forward wall for
        the padded bucket run) additionally lands in that bucket's
        fixed-edge latency histogram — one bisect + one increment under
        the lock this call already holds."""
        with self._lock:
            self.dispatches += 1
            if bucket is not None:
                b = int(bucket)
                self.dispatch_buckets[b] = \
                    self.dispatch_buckets.get(b, 0) + 1
                if lat_us is not None:
                    h = self._bucket_hist.get(b)
                    if h is None:
                        h = self._bucket_hist[b] = \
                            [0] * (len(LATENCY_BUCKETS_US) + 1)
                    lat = float(lat_us)
                    h[bisect.bisect_left(LATENCY_BUCKETS_US, lat)] += 1
                    self._bucket_lat_sum[b] = \
                        self._bucket_lat_sum.get(b, 0.0) + lat

    def record_exemplar(self, bucket: int, lat_us: float, trace_id: str,
                        queue_wait_us: float = 0.0, pad_us: float = 0.0,
                        compute_us: float = 0.0,
                        stall_us: float = 0.0) -> None:
        """Admit one completed request into the bounded top-K slowest
        set of its bucket.  The phase walls are the
        span-derived decomposition of ``lat_us``: time queued before
        dispatch, bucket padding, the engine forward wall, and the
        tiered-store miss stall inside it; ``dominant`` (the largest)
        is precomputed here so readers rank without re-deriving.  The
        batcher calls it for each delivered request while an event log
        is active (the row carries the request's trace id)."""
        lat = float(lat_us)
        row = {"bucket": int(bucket), "lat_us": lat,
               "trace_id": str(trace_id),
               "queue_wait_us": float(queue_wait_us),
               "pad_us": float(pad_us),
               "compute_us": float(compute_us),
               "stall_us": float(stall_us)}
        phases = (("queue_wait", row["queue_wait_us"]),
                  ("pad", row["pad_us"]),
                  ("engine_forward", row["compute_us"]),
                  ("miss_stall", row["stall_us"]))
        row["dominant"] = max(phases, key=lambda kv: kv[1])[0]
        with self._lock:
            top = self._tail.setdefault(int(bucket), [])
            if len(top) < self.tail_k:
                top.append(row)
            else:
                i = min(range(len(top)),
                        key=lambda j: top[j]["lat_us"])
                if lat > top[i]["lat_us"]:
                    top[i] = row
                else:
                    return

    def tail_exemplars(self) -> List[dict]:
        """Worst-first copy of every bucket's top-K exemplar rows (the
        metrics sweep and the ``serve`` ``phase="tail"`` events)."""
        with self._lock:
            rows = [dict(r) for top in self._tail.values() for r in top]
        rows.sort(key=lambda r: -r["lat_us"])
        return rows

    # ------------------------------------------------------------ histogram
    def histogram(self) -> Tuple[List[int], float, int]:
        """One locked snapshot for the exporter: (CUMULATIVE counts per
        ``LATENCY_BUCKETS_US`` edge plus the final +Inf slot, sum of all
        recorded latencies in us, total recorded count).  O(buckets) —
        never touches the reservoir."""
        with self._lock:
            per_slot = list(self._hist)
            total_sum = self._lat_sum
            n = self.count
        cum, running = [], 0
        for c in per_slot:
            running += c
            cum.append(running)
        return cum, total_sum, n

    def bucket_histograms(self) -> Dict[int, Tuple[List[int], float, int]]:
        """One locked snapshot of the per-bucket dispatch-latency
        histograms for the exporter: {bucket: (CUMULATIVE counts per
        ``LATENCY_BUCKETS_US`` edge + the +Inf slot, latency sum us,
        count)}."""
        with self._lock:
            slots = {b: list(h) for b, h in self._bucket_hist.items()}
            sums = dict(self._bucket_lat_sum)
        out: Dict[int, Tuple[List[int], float, int]] = {}
        for b, per_slot in slots.items():
            cum, running = [], 0
            for c in per_slot:
                running += c
                cum.append(running)
            out[b] = (cum, sums.get(b, 0.0), cum[-1])
        return out

    def bucket_percentile(self, bucket: int, p: float) -> Optional[float]:
        """Histogram-estimated p-th percentile (0..100) of one bucket's
        dispatch latencies in us — linear interpolation inside the
        fixed edge the rank falls in (the Prometheus
        ``histogram_quantile`` convention; resolution is the edge
        grid, good enough to GATE on).  None with no dispatches."""
        hists = self.bucket_histograms()
        if bucket not in hists:
            return None
        cum, _s, n = hists[bucket]
        if n <= 0:
            return None
        rank = (p / 100.0) * n
        lo = 0.0
        for i, edge in enumerate(LATENCY_BUCKETS_US):
            if cum[i] >= rank:
                prev = cum[i - 1] if i else 0
                in_slot = cum[i] - prev
                frac = (rank - prev) / in_slot if in_slot else 1.0
                return lo + frac * (edge - lo)
            lo = edge
        return float(LATENCY_BUCKETS_US[-1])  # rank in the +Inf slot

    # ------------------------------------------------------------- reading
    def samples(self) -> List[float]:
        """One locked copy of the latency reservoir (a router pools the
        replicas' reservoirs into one percentile summary)."""
        with self._lock:
            return list(self._lat_us)

    def lifetime_qps(self) -> float:
        """Served requests per second since construction (the live
        per-replica QPS gauge; 0.0 before any traffic)."""
        with self._lock:
            n = self.count
        return n / max(time.perf_counter() - self._t0, 1e-9)

    def percentile(self, p: float) -> Optional[float]:
        """The p-th percentile (0..100) of recorded latencies in us, by
        linear interpolation between closest ranks; None with no
        samples.  The lock covers only the list snapshot: the numpy
        conversion and rank math run outside it, so record() on the hot
        path never waits behind percentile arithmetic."""
        with self._lock:
            if not self._lat_us:
                return None
            lat = self._lat_us[:]
        return float(np.percentile(np.asarray(lat), p))

    @property
    def mean_us(self) -> Optional[float]:
        with self._lock:
            if not self._lat_us:
                return None
            return float(np.mean(self._lat_us))

    def summary(self, wall_s: Optional[float] = None) -> Dict[str, float]:
        """The ``serve`` summary-event payload: request count, QPS over
        ``wall_s`` (default: since construction), and the latency
        percentiles.  ONE locked pass snapshots counters and samples
        together (a racing record() can't pair one instant's count with
        another's percentiles); the buffer then converts once for all
        three percentiles + the mean outside the lock.  Fields with
        nothing to report are absent, as the telemetry layer drops
        None-valued fields."""
        if wall_s is None:
            wall_s = time.perf_counter() - self._t0
        with self._lock:
            out: Dict[str, float] = {
                "requests": int(self.count),
                "wall_s": float(wall_s),
                "qps": float(self.count) / max(float(wall_s), 1e-9),
                "dispatches": int(self.dispatches),
                "rejected": int(self.rejected),
                "deadline_misses": int(self.deadline_misses),
            }
            lat = self._lat_us[:]
        if lat:
            a = np.asarray(lat)
            p50, p95, p99 = np.percentile(a, [50, 95, 99])
            out.update(p50_us=float(p50), p95_us=float(p95),
                       p99_us=float(p99), mean_us=float(a.mean()))
        return out

    def emit_summary(self, wall_s: Optional[float] = None,
                     tail: int = 8) -> Dict[str, float]:
        """Emit the summary as one ``serve`` ``phase="summary"`` event
        plus up to ``tail`` worst-first ``phase="tail"`` exemplar
        events (no-op when telemetry is off) and return the summary
        payload.  The tail events are emitted outside the stats lock and
        before the summary, so the summary stays the run's last serve
        event (``log.last("serve")``)."""
        from ..telemetry import emit

        s = self.summary(wall_s)
        for r in self.tail_exemplars()[:max(int(tail), 0)]:
            emit("serve", phase="tail", **r)
        emit("serve", phase="summary", **s)
        return s
