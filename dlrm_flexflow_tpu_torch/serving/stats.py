"""Serving latency statistics (counterpart of
``dlrm_flexflow_tpu/serving/stats.py``, without the telemetry emits).

One :class:`LatencyStats` per engine/batcher accumulates per-request
end-to-end latencies plus the overload/deadline counters.  Percentiles
use linear interpolation between closest ranks (numpy's default).
"""

from __future__ import annotations

import bisect
import itertools
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

#: fixed latency-histogram edges in microseconds (+ an overflow slot)
LATENCY_BUCKETS_US: Tuple[float, ...] = (
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10_000.0, 25_000.0,
    50_000.0, 100_000.0, 250_000.0, 500_000.0, 1_000_000.0)


class LatencyStats:
    """Thread-safe accumulator of per-request latencies (microseconds).

    Once ``max_samples`` latencies are held, recording keeps COUNTING
    every request and keeps a uniform reservoir sample (Vitter's
    algorithm R), so percentiles track live traffic.  ``record_dispatch``
    keeps per-bucket dispatch counts and fixed-edge latency histograms.
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
        self.dispatch_buckets: Dict[int, int] = {}
        self._bucket_hist: Dict[int, List[int]] = {}
        self._bucket_lat_sum: Dict[int, float] = {}
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------ recording
    def record(self, lat_us: float) -> None:
        lat = float(lat_us)
        with self._lock:
            self.count += 1
            if len(self._lat_us) < self.max_samples:
                self._lat_us.append(lat)
            else:
                j = self._rng.randrange(self.count)
                if j < self.max_samples:
                    self._lat_us[j] = lat

    def record_reject(self) -> None:
        """One shed request (queue full, or the batcher shutting down)."""
        with self._lock:
            self.rejected += 1

    def record_deadline_miss(self) -> None:
        with self._lock:
            self.deadline_misses += 1

    def record_dispatch(self, bucket: Optional[int] = None,
                        lat_us: Optional[float] = None) -> None:
        """One engine dispatch; ``lat_us`` (the engine-forward wall of the
        padded bucket) also lands in that bucket's latency histogram."""
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

    # ------------------------------------------------------------ reading
    def bucket_histograms(self) -> Dict[int, Tuple[List[int], float, int]]:
        """{bucket: (CUMULATIVE counts per edge + the +Inf slot, latency
        sum in us, count)} of the engine-forward latencies."""
        with self._lock:
            slots = {b: list(h) for b, h in self._bucket_hist.items()}
            sums = dict(self._bucket_lat_sum)
        out: Dict[int, Tuple[List[int], float, int]] = {}
        for b, per_slot in slots.items():
            cum = list(itertools.accumulate(per_slot))
            out[b] = (cum, sums.get(b, 0.0), cum[-1])
        return out

    def bucket_percentile(self, bucket: int, p: float) -> Optional[float]:
        """Histogram-estimated p-th percentile (0..100) of one bucket's
        dispatch latencies in us, interpolating linearly inside the edge
        the rank falls in.  None with no dispatches."""
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

    def summary(self, wall_s: Optional[float] = None) -> Dict[str, float]:
        """Request count, QPS over ``wall_s`` (default: since
        construction), and the latency percentiles, from one locked
        snapshot.  Fields with nothing to report are absent."""
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
