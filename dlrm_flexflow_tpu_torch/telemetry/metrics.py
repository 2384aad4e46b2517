"""Pull-based metrics registry + Prometheus text exposition (counterpart
of ``dlrm_flexflow_tpu/telemetry/metrics.py``).

The registry behind ``telemetry/exporter.py``'s ``/metrics``: a declared
table of metric families (:data:`FAMILIES`, under the JAX package's
names, help texts and labels), three instrument kinds (Counter / Gauge /
Histogram), and pull-based collection: values are computed at scrape
time from state the hot paths already keep, so serving metrics add no
lock on the engine's forward path beyond what ``LatencyStats`` already
takes.

Live serving objects register themselves (``track_batcher`` /
``track_engine``) into weak sets; a closed batcher folds its final
counters into a retained base (``retire_batcher``) and a collected engine
folds through a finalizer, so the exposed counters stay monotone across
scrapes.

The families are those the port's trainer, engine, batcher and router
produce (``track_router`` / ``retire_router`` keep the router's shed
count monotone the same way), the durability families (checkpoint saves
and age, sentinel rollbacks, the host watchdog's heartbeat age) and the
tiered store's two gauges, the fleet identity and skew, the closed
tuning loop's calibration error and strategy version and age, and the SLO
monitor's budget and burn rows.  ``dlrm_elastic_reshard_total`` comes
with ``elastic/`` (ROADMAP.md).  The registry is process-wide, as the
JAX package's is; ``reset`` clears its live and retained state (tests).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

#: fixed latency histogram bucket upper edges, microseconds (the +Inf
#: overflow slot is implicit).  Shared with serving.LatencyStats so the
#: accumulator and the exposition can never disagree on edges.
LATENCY_BUCKETS_US: Tuple[float, ...] = (
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10_000.0, 25_000.0,
    50_000.0, 100_000.0, 250_000.0, 500_000.0, 1_000_000.0)

#: The metric-name registry: family -> (type, help), the JAX package's
#: entries for the families the port produces.  Every registered metric
#: must be declared here (``MetricsRegistry.register`` refuses unknown or
#: duplicate names).
FAMILIES: Dict[str, Tuple[str, str]] = {
    "dlrm_serve_queue_depth": (
        "gauge",
        'requests waiting in live DynamicBatcher queues'),
    "dlrm_serve_requests_total": (
        "counter",
        'requests served to completion (latency recorded)'),
    "dlrm_serve_rejected_total": (
        "counter",
        'requests shed (queue full / shutdown)'),
    "dlrm_serve_deadline_missed_total": (
        "counter",
        'requests expired before dispatch'),
    "dlrm_serve_dispatches_total": (
        "counter",
        'engine forward dispatches by compiled bucket size'),
    "dlrm_serve_latency_us": (
        "histogram",
        'end-to-end request latency in microseconds'),
    "dlrm_serve_bucket_latency_us": (
        "histogram",
        'engine forward wall per dispatch, labelled by compiled '
        'bucket'),
    "dlrm_serve_replica_qps": (
        "gauge", "lifetime-average served QPS per routed serving "
                 "replica (served count / seconds since construction)"),
    "dlrm_serve_replica_queue_depth": (
        "gauge", "requests waiting per routed serving replica queue"),
    "dlrm_serve_router_shed_total": (
        "counter",
        "requests a ReplicaRouter shed with every replica saturated"),
    "dlrm_serve_replicas": (
        "gauge", "live serving replicas across all ReplicaRouters "
                 "(moves with scale_to/rebuild — docs/elastic.md)"),
    "dlrm_train_steps_total": (
        "counter",
        'training dispatches adopted (global steps)'),
    "dlrm_train_samples_per_s": (
        "gauge",
        'throughput of the most recent fit/bench window'),
    "dlrm_data_stall_pct": (
        "gauge",
        'host time waiting for input batches as a percent of the most'
        " recent per-batch fit window's wall"),
    "dlrm_exposed_comm_pct": (
        "gauge",
        'measured exposed-communication share of the step wall: host '
        'time blocked on device completion (grad-sync wait) as a '
        "percent of the most recent fit window's wall — the measured "
        "column next to the cost model's DCN-exposed prediction "
        '(PERF.md)'),
    "dlrm_checkpoint_saves_total": (
        "counter", "checkpoints committed by CheckpointManager.save"),
    "dlrm_checkpoint_age_s": (
        "gauge", "seconds since the last committed checkpoint"),
    "dlrm_sentinel_rollbacks_total": (
        "counter", "dispatches the NaN sentinel rejected and rolled back"),
    "dlrm_host_heartbeat_age_s": (
        "gauge", "age in seconds of the stalest peer heartbeat file "
                 "the host watchdog saw on its latest sweep — crosses "
                 "the watchdog deadline when a peer host died or hung "
                 "(resilience/watchdog.py — docs/resilience.md)"),
    "dlrm_serve_replica_ejected_total": (
        "counter", "serving replicas ejected from dispatch by the "
                   "ReplicaRouter health probe (dead dispatcher "
                   "thread or tripped consecutive-engine-failure "
                   "circuit breaker — docs/serving.md)"),
    "dlrm_embed_cache_hit_pct": (
        "gauge", "tiered embedding store cumulative hit rate: percent "
                 "of lookups served from the device-resident hot tier "
                 "(storage/tiered.py — docs/storage.md)"),
    "dlrm_embed_cache_miss_stall_us": (
        "gauge", "wall microseconds the most recent tiered-store miss "
                 "block stalled streaming cold rows host->device "
                 "(start-all-then-wait — docs/storage.md)"),
    "dlrm_serve_shed_total": (
        "counter",
        'requests shed, labelled by cause: queue_full (batcher queue '
        'at capacity), deadline (expired before dispatch), shutdown '
        '(rejected while closing / replica lost), saturated (router '
        'found every replica queue full) — docs/slo.md; the '
        'availability SLO reads this split'),
    "dlrm_process_index": (
        "gauge", "this process' index in the multi-host fleet "
                 "(jax.process_index; 0 single-host — "
                 "docs/distributed.md)"),
    "dlrm_process_count": (
        "gauge", "host processes in the fleet (jax.process_count; a "
                 "scraper joining per-host /metrics endpoints checks "
                 "it saw them all — docs/distributed.md)"),
    "dlrm_sim_calibration_error_pct": (
        "gauge", "mean per-op sim-vs-measured relative error of the "
                 "newest calibration fit, percent"),
    "dlrm_strategy_age_s": (
        "gauge", "seconds since the incumbent SOAP strategy artifact "
                 "was created (strategy freshness)"),
    "dlrm_strategy_version": (
        "gauge", "version number of the incumbent SOAP strategy "
                 "artifact"),
    "dlrm_step_skew_ms": (
        "gauge", "fleet straggler skew: slowest minus median host "
                 "step wall of the newest aligned step across merged "
                 "per-process telemetry (telemetry/fleet.py — "
                 "docs/telemetry.md)"),
    "dlrm_slo_error_budget_pct": (
        "gauge", "error budget remaining per declared SLO since the "
                 "monitor started, percent (100 = untouched, 0 = "
                 "exhausted — telemetry/slo.py, docs/slo.md)"),
    "dlrm_slo_burn_rate": (
        "gauge", "worst-window burn rate per declared SLO: observed "
                 "error rate over budgeted error rate (1.0 = burning "
                 "exactly the budget — telemetry/slo.py, docs/slo.md)"),
}


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Metric:
    """One family.  ``expose()`` returns the sample lines (no HELP/TYPE
    headers — the registry prints those from :data:`FAMILIES`)."""

    def __init__(self, name: str):
        if name not in FAMILIES:
            raise ValueError(
                f"metric {name!r} is not declared in telemetry.metrics."
                f"FAMILIES: declare it there first")
        self.name = name
        self.mtype, self.help = FAMILIES[name]

    def expose(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(Metric):
    """Monotone counter; ``inc`` takes one short lock (host-loop rates
    only — scrape-hot serving counts are pulled, not pushed)."""

    def __init__(self, name: str):
        super().__init__(name)
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def expose(self) -> List[str]:
        return [f"{self.name} {_fmt(self._v)}"]


class Gauge(Metric):
    """Set-able or pull-based (``fn`` evaluated at scrape; returning
    None omits the sample — 'no data yet' is absent, never faked)."""

    def __init__(self, name: str,
                 fn: Optional[Callable[[], Optional[float]]] = None):
        super().__init__(name)
        self._v: Optional[float] = None
        self._fn = fn

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> Optional[float]:
        return self._fn() if self._fn is not None else self._v

    def expose(self) -> List[str]:
        v = self.value
        return [] if v is None else [f"{self.name} {_fmt(v)}"]


class LabeledCounter(Metric):
    """Pull-based counter family with one label (``label``): ``fn``
    returns {label_value: count} at scrape time."""

    def __init__(self, name: str, label: str,
                 fn: Callable[[], Dict[str, float]]):
        super().__init__(name)
        self.label = label
        self._fn = fn

    def expose(self) -> List[str]:
        return [f'{self.name}{{{self.label}="{k}"}} {_fmt(v)}'
                for k, v in sorted(self._fn().items())]

    def sample(self) -> Dict[str, float]:
        """{label_value: value} right now (what a scrape would see): the
        SLOMonitor's programmatic read (``slo.py``)."""
        return dict(self._fn())


class LabeledGauge(LabeledCounter):
    """Pull-based gauge family with one label: ``fn`` returns
    {label_value: value} at scrape time.  Rows come and go with the
    live objects behind them (a retired replica's row disappears); the
    exposition is :class:`LabeledCounter`'s, only the contract differs."""


class Histogram(Metric):
    """Pull-based cumulative histogram: ``fn`` returns (cumulative
    counts per ``buckets`` edge + the +Inf slot, sum, count) — the
    exact shape ``LatencyStats.histogram()`` snapshots under its one
    existing lock."""

    def __init__(self, name: str, buckets: Tuple[float, ...],
                 fn: Callable[[], Tuple[List[float], float, float]]):
        super().__init__(name)
        self.buckets = tuple(buckets)
        self._fn = fn

    def sample(self) -> Tuple[List[float], float, float]:
        """(cumulative counts per edge + +Inf, sum, count) right now: the
        SLOMonitor's programmatic read (``slo.py``)."""
        return self._fn()

    def expose(self) -> List[str]:
        cum, total_sum, n = self._fn()
        lines = []
        for edge, c in zip(self.buckets, cum):
            lines.append(f'{self.name}_bucket{{le="{_fmt(edge)}"}} '
                         f'{_fmt(c)}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {_fmt(cum[-1])}')
        lines.append(f"{self.name}_sum {_fmt(total_sum)}")
        lines.append(f"{self.name}_count {_fmt(n)}")
        return lines


class LabeledHistogram(Metric):
    """Pull-based cumulative histogram FAMILY with one label: ``fn``
    returns ``{label_value: (cumulative counts per edge + the +Inf
    slot, sum, count)}`` at scrape time — the per-bucket shape
    ``LatencyStats.bucket_histograms()`` snapshots under its one
    existing lock."""

    def __init__(self, name: str, label: str, buckets: Tuple[float, ...],
                 fn: Callable[[], Dict[str, Tuple[List[float], float,
                                                  float]]]):
        super().__init__(name)
        self.label = label
        self.buckets = tuple(buckets)
        self._fn = fn

    def sample(self) -> Dict[str, Tuple[List[float], float, float]]:
        """{label_value: (cumulative counts, sum, count)} right now: the
        SLOMonitor's per-bucket latency read (``slo.py``)."""
        return dict(self._fn())

    def expose(self) -> List[str]:
        lines: List[str] = []
        for lv, (cum, total_sum, n) in sorted(self._fn().items()):
            pre = f'{self.name}_bucket{{{self.label}="{lv}",'
            for edge, c in zip(self.buckets, cum):
                lines.append(f'{pre}le="{_fmt(edge)}"}} {_fmt(c)}')
            lines.append(f'{pre}le="+Inf"}} {_fmt(cum[-1])}')
            lines.append(f'{self.name}_sum{{{self.label}="{lv}"}} '
                         f'{_fmt(total_sum)}')
            lines.append(f'{self.name}_count{{{self.label}="{lv}"}} '
                         f'{_fmt(n)}')
        return lines


class MetricsRegistry:
    """Ordered family table -> one Prometheus text exposition."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(
                    f"duplicate metric registration: {metric.name!r}")
            self._metrics[metric.name] = metric
        return metric

    def get(self, name: str) -> Optional[Metric]:
        """The registered instrument for ``name`` (None if absent): the
        SLOMonitor samples instruments through this instead of parsing
        the text exposition."""
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    def render(self) -> str:
        """The ``/metrics`` body (Prometheus text format 0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: List[str] = []
        for m in metrics:
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.mtype}")
            out.extend(m.expose())
        return "\n".join(out) + "\n"


# --------------------------------------------------- live serving collection
#
# Counter rigor: every tracked LatencyStats is at any instant EITHER in
# the strong ``_live_stats`` registry (swept by scrapes) OR folded into
# the retained base — the transition happens atomically under
# ``_retired_lock``, so a scrape can never observe an object in neither
# place and report a "monotone" counter moving backwards.  A
# batcher/engine abandoned without close() is handled by a GC
# finalizer, which only queues the stats on a LOCK-FREE deque (a
# finalizer can fire at any allocation point, possibly on a thread
# already holding some LatencyStats lock, so it must never contend for
# _retired_lock itself); the strong registry keeps the stats alive and
# scrapeable until the queue is drained at the next collection.
_live_stats: set = set()                 # strong refs until folded
_live_batchers: "weakref.WeakSet" = weakref.WeakSet()  # queue depth only
_pending_folds: deque = deque()
_retired_lock = threading.Lock()
_retired = {"requests": 0, "rejected": 0, "deadline": 0}
# shed-by-cause retained base (dlrm_serve_shed_total{cause=} — the
# split by cause); the causes fold here from LatencyStats.shed_causes()
_retired_shed_causes: Dict[str, int] = {}
_retired_hist = [0] * (len(LATENCY_BUCKETS_US) + 1)  # cumulative
_retired_sum = 0.0
_retired_count = 0
_retired_buckets: Dict[int, int] = {}
# per-bucket dispatch-latency histograms of retired stats (cumulative
# slot counts + sum + count per bucket size)
_retired_bucket_hist: Dict[int, List[int]] = {}
_retired_bucket_sum: Dict[int, float] = {}
_retired_bucket_n: Dict[int, int] = {}


def _fold_stats_locked(stats) -> None:
    """Fold one retiring LatencyStats into the retained base and drop
    it from the live registry — callers hold ``_retired_lock``.
    Idempotent per stats object (close() and the GC path can race)."""
    global _retired_sum, _retired_count
    if getattr(stats, "_metrics_folded", False):
        _live_stats.discard(stats)
        return
    stats._metrics_folded = True
    _retired["requests"] += int(stats.count)
    _retired["rejected"] += int(stats.rejected)
    _retired["deadline"] += int(stats.deadline_misses)
    cum, s, n = stats.histogram()
    for i, c in enumerate(cum):
        _retired_hist[i] += int(c)
    _retired_sum += float(s)
    _retired_count += int(n)
    with stats._lock:
        snap = dict(stats.dispatch_buckets)
    for b, c in snap.items():
        _retired_buckets[b] = _retired_buckets.get(b, 0) + int(c)
    for b, (bc, bs, bn) in stats.bucket_histograms().items():
        base = _retired_bucket_hist.setdefault(
            b, [0] * (len(LATENCY_BUCKETS_US) + 1))
        for i, c in enumerate(bc):
            base[i] += int(c)
        _retired_bucket_sum[b] = _retired_bucket_sum.get(b, 0.0) + float(bs)
        _retired_bucket_n[b] = _retired_bucket_n.get(b, 0) + int(bn)
    for cause, c in stats.shed_causes().items():
        _retired_shed_causes[cause] = (_retired_shed_causes.get(cause, 0)
                                       + int(c))
    _live_stats.discard(stats)


def _drain_pending_locked() -> None:
    while True:
        try:
            stats = _pending_folds.popleft()
        except IndexError:
            return
        _fold_stats_locked(stats)


def _finalize_stats(stats) -> None:
    _pending_folds.append(stats)  # lock-free; folded at next scrape


def track_batcher(batcher) -> None:
    """Called by ``DynamicBatcher.__init__``: expose this batcher's
    queue depth and counters until it closes (``retire_batcher``) or is
    collected (finalizer queues its stats for folding so counters stay
    monotone).  Tracking also drains the pending-fold queue, so a
    process that never scrapes (``metrics_port=0``) still folds-and-
    frees the stats of GC'd instances instead of retaining them in the
    strong registry forever."""
    with _retired_lock:
        _drain_pending_locked()
        _live_stats.add(batcher.stats)
    _live_batchers.add(batcher)
    weakref.finalize(batcher, _finalize_stats, batcher.stats)


def retire_batcher(batcher) -> None:
    """Called by ``DynamicBatcher.close``: fold the final counters into
    the retained base and stop scraping the instance."""
    with _retired_lock:
        _drain_pending_locked()
        _fold_stats_locked(batcher.stats)
    _live_batchers.discard(batcher)


def track_engine(engine) -> None:
    """Called by ``InferenceEngine.__init__``: expose per-bucket
    dispatch counts (LatencyStats.dispatch_buckets).  Engine stats
    record no latencies/rejects, so sharing the batchers' registry is
    harmless — their contribution to those families is zero.  Drains
    the pending-fold queue like ``track_batcher`` (engines have no
    close(); a reloading server folds the previous generation here)."""
    with _retired_lock:
        _drain_pending_locked()
        _live_stats.add(engine.stats)
    weakref.finalize(engine, _finalize_stats, engine.stats)


def record_shed_late(stats, kind: str = "rejected",
                     cause: str = "shutdown") -> None:
    """Count one shed (``kind="rejected"``) or deadline miss
    (``"deadline"``) that may land AFTER its batcher retired (a submit
    racing close): once the stats object is folded its counters are
    invisible to scrapes, so the count goes straight into the retained
    base; before the fold it rides the stats object like any other
    (lock order retired->stats matches ``_fold_stats_locked``).
    ``cause`` feeds the dlrm_serve_shed_total{cause=} split (deadline
    misses always count under cause="deadline")."""
    with _retired_lock:
        if getattr(stats, "_metrics_folded", False):
            _retired[kind] += 1
            key = "deadline" if kind == "deadline" else cause
            _retired_shed_causes[key] = (
                _retired_shed_causes.get(key, 0) + 1)
        elif kind == "rejected":
            stats.record_reject(cause=cause)
        else:
            stats.record_deadline_miss()


def _queue_depth() -> float:
    return float(sum(b._q.qsize() for b in list(_live_batchers)))


# the scrape collectors hold _retired_lock across the pending-fold
# drain, the retained base, AND the live sweep, so fold transitions are
# invisible to them and the exposed counters are exactly-once sums

# ------------------------------------------------------- router collection
#
# A live router's shed count lives in a _ShedCell swept by scrapes;
# retire_router folds it into the retained base under _retired_lock,
# and every increment goes through record_router_shed, which sends a
# shed that lands after the fold (a submit racing close) straight into
# the base.  A router dropped without close() folds through a finalizer
# that only queues its cell on a lock-free deque.  The per-replica QPS
# and queue-depth gauges carry no monotonicity contract: their rows come
# from the live routers and vanish with them.

class _ShedCell:
    """One router's shed count, mutated only under ``_retired_lock``."""

    __slots__ = ("n", "folded")

    def __init__(self):
        self.n = 0
        self.folded = False


_live_routers: "weakref.WeakSet" = weakref.WeakSet()
_live_shed_cells: set = set()          # strong refs until folded
_pending_router_folds: deque = deque()
_retired_router_shed = 0


def _fold_shed_cell_locked(cell: _ShedCell) -> None:
    global _retired_router_shed
    if not cell.folded:
        cell.folded = True
        _retired_router_shed += cell.n
    _live_shed_cells.discard(cell)


def _drain_router_pending_locked() -> None:
    while True:
        try:
            cell = _pending_router_folds.popleft()
        except IndexError:
            return
        _fold_shed_cell_locked(cell)


def _finalize_router(cell: _ShedCell) -> None:
    _pending_router_folds.append(cell)  # lock-free; folded at next scrape


def track_router(router) -> _ShedCell:
    """Called by ``ReplicaRouter.__init__``: expose the per-replica
    gauge rows and the router's shed count until it closes
    (``retire_router``) or is collected (a finalizer queues the cell, so
    the counter stays monotone).  Returns the router's shed cell."""
    cell = _ShedCell()
    with _retired_lock:
        _drain_router_pending_locked()
        _live_shed_cells.add(cell)
    _live_routers.add(router)
    weakref.finalize(router, _finalize_router, cell)
    return cell


def retire_router(router) -> None:
    """Called by ``ReplicaRouter.close``: fold the shed count into the
    retained base and drop the gauge rows."""
    with _retired_lock:
        _drain_router_pending_locked()
        _fold_shed_cell_locked(router._shed_cell)
    _live_routers.discard(router)


def record_router_shed(cell: _ShedCell) -> None:
    """Count one router-level shed.  A shed after the fold (a submit
    racing close) lands in the retained base, so the exposed counter
    never loses one."""
    global _retired_router_shed
    with _retired_lock:
        if cell.folded:
            _retired_router_shed += 1
        else:
            cell.n += 1


def router_shed_count(cell: _ShedCell) -> int:
    """One router's shed count so far (its own cell: a folded cell keeps
    its final value for the router's summary)."""
    with _retired_lock:
        return int(cell.n)


def _router_shed_total() -> float:
    with _retired_lock:
        _drain_router_pending_locked()
        return float(_retired_router_shed
                     + sum(c.n for c in _live_shed_cells))


def _replica_qps() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in list(_live_routers):
        # one consistent (label, batcher) snapshot: the replica set
        # changes under scale_to / rebuild
        for label, b in r.replica_rows():
            out[label] = out.get(label, 0.0) + b.stats.lifetime_qps()
    return out


def _replica_queue_depth() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in list(_live_routers):
        for label, b in r.replica_rows():
            out[label] = out.get(label, 0.0) + float(b.queue_depth())
    return out


def _serve_replicas() -> Optional[float]:
    """Live replicas across routers (None with no live router: no
    serving tier is absent, never a fake 0)."""
    routers = list(_live_routers)
    if not routers:
        return None
    return float(sum(len(r) for r in routers))


def _count_of(field: str, retired_key: str) -> Callable[[], float]:
    def fn() -> float:
        with _retired_lock:
            _drain_pending_locked()
            return float(_retired[retired_key]
                         + sum(int(getattr(s, field))
                               for s in _live_stats))
    return fn


def _latency_hist() -> Tuple[List[float], float, float]:
    with _retired_lock:
        _drain_pending_locked()
        cum = [float(c) for c in _retired_hist]
        s, n = _retired_sum, _retired_count
        for st in _live_stats:
            bc, bs, bn = st.histogram()
            for i, c in enumerate(bc):
                cum[i] += c
            s += bs
            n += bn
    return cum, s, n


def _bucket_latency_hists() -> Dict[str, Tuple[List[float], float, float]]:
    """Scrape collector for dlrm_serve_bucket_latency_us: retained base
    + live sweep per bucket label, under the same exactly-once locking
    discipline as the unlabeled latency histogram."""
    with _retired_lock:
        _drain_pending_locked()
        out: Dict[str, Tuple[List[float], float, float]] = {}
        for b, base in _retired_bucket_hist.items():
            out[str(b)] = ([float(c) for c in base],
                           _retired_bucket_sum.get(b, 0.0),
                           float(_retired_bucket_n.get(b, 0)))
        for st in _live_stats:
            for b, (bc, bs, bn) in st.bucket_histograms().items():
                key = str(b)
                if key in out:
                    cum, s, n = out[key]
                    for i, c in enumerate(bc):
                        cum[i] += c
                    out[key] = (cum, s + bs, n + bn)
                else:
                    out[key] = ([float(c) for c in bc], float(bs),
                                float(bn))
    return out


def _dispatch_buckets() -> Dict[str, float]:
    with _retired_lock:
        _drain_pending_locked()
        out = {str(k): float(v) for k, v in _retired_buckets.items()}
        for st in _live_stats:
            with st._lock:
                snap = dict(st.dispatch_buckets)
            for b, c in snap.items():
                out[str(b)] = out.get(str(b), 0.0) + c
    return out


def _shed_causes() -> Dict[str, float]:
    """Scrape collector for dlrm_serve_shed_total{cause=}: retained
    base + live LatencyStats sweep of the batcher-level causes
    (queue_full / deadline / shutdown / replica_dead), under the one
    exactly-once lock, plus the routers' "saturated" count, so the
    labelled split sums to rejected + deadline + router shed."""
    with _retired_lock:
        _drain_pending_locked()
        _drain_router_pending_locked()
        out = {k: float(v) for k, v in _retired_shed_causes.items()}
        for st in _live_stats:
            for cause, c in st.shed_causes().items():
                out[cause] = out.get(cause, 0.0) + c
        sat = float(_retired_router_shed
                    + sum(c.n for c in _live_shed_cells))
        if sat:
            out["saturated"] = out.get("saturated", 0.0) + sat
    return out


def tail_exemplars(limit: int = 10) -> List[dict]:
    """Worst-first tail exemplars swept from the live LatencyStats
    (each row: bucket, lat_us, trace_id + the span-derived phase
    decomposition — serving/stats.py).  Exemplars carry no
    monotonicity contract, so retired stats contribute nothing; the
    sweep holds _retired_lock like every other collector and each
    stats snapshots under its own lock."""
    rows: List[dict] = []
    with _retired_lock:
        _drain_pending_locked()
        for st in _live_stats:
            rows.extend(st.tail_exemplars())
    rows.sort(key=lambda r: -float(r.get("lat_us", 0.0)))
    return rows[:limit] if limit else rows


def render_exemplars(limit: int = 10) -> str:
    """OpenMetrics-flavoured exemplar lines the exporter appends after
    the text exposition: one comment line per tail exemplar next to
    the dlrm_serve_latency_us histogram, carrying the trace id and the
    dominant attributed phase so a scrape can jump from a p99 spike to
    the exact slow request (docs/slo.md)."""
    lines = []
    for r in tail_exemplars(limit):
        lines.append(
            f'# EXEMPLAR dlrm_serve_latency_us'
            f'{{bucket="{r.get("bucket", "")}",'
            f'trace_id="{r.get("trace_id", "")}",'
            f'dominant="{r.get("dominant", "")}"}} '
            f'{_fmt(r.get("lat_us", 0.0))}')
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------- checkpoint age
_last_ckpt_ts: Optional[float] = None


def note_checkpoint_save() -> None:
    """Called by ``CheckpointManager.save`` on every committed
    checkpoint: bumps the saves counter and resets the age gauge."""
    global _last_ckpt_ts
    _last_ckpt_ts = time.time()
    CHECKPOINT_SAVES.inc()


def _ckpt_age() -> Optional[float]:
    return None if _last_ckpt_ts is None else time.time() - _last_ckpt_ts


def _slo_rows(which: str) -> Callable[[], Dict[str, float]]:
    """Collector factory for the dlrm_slo_* gauge families: defers to
    ``slo.py`` at scrape time (a lazy import: slo.py imports this module,
    and a process with no live SLOMonitor exposes no rows)."""
    def fn() -> Dict[str, float]:
        try:
            from . import slo as _slo
            return _slo.gauge_rows(which)
        except Exception:
            return {}
    return fn


# ----------------------------------------------------- tuning-loop gauges
_strategy_promoted_ts: Optional[float] = None


def note_calibration(mae_pct: float) -> None:
    """Called by ``sim.tune.fit_calibration`` on every fit: the
    simulator-accuracy gauge tracks the newest calibration's residual
    error."""
    SIM_CALIBRATION_ERROR.set(float(mae_pct))


def note_strategy_promotion(version: int,
                            ts: Optional[float] = None) -> None:
    """Called by ``sim.tune.promote`` on every incumbent move (and by a
    consumer loading an incumbent at startup): the freshness gauge ages
    from the artifact's ``created_ts``, so a server running a week-old
    strategy shows a week, not its own uptime."""
    global _strategy_promoted_ts
    _strategy_promoted_ts = time.time() if ts is None else float(ts)
    STRATEGY_VERSION.set(int(version))


def _strategy_age() -> Optional[float]:
    return (None if _strategy_promoted_ts is None
            else time.time() - _strategy_promoted_ts)


# the fleet identity, read at scrape time so a process that joins its
# process group after the exporter started still reports it
def _process_index() -> Optional[float]:
    from .fleet import process_identity
    return float(process_identity()[0])


def _process_count() -> Optional[float]:
    from .fleet import process_identity
    return float(process_identity()[1])


# ------------------------------------------------------- the default registry
REGISTRY = MetricsRegistry()

SERVE_QUEUE_DEPTH = REGISTRY.register(
    Gauge("dlrm_serve_queue_depth", fn=_queue_depth))
SERVE_REQUESTS = REGISTRY.register(
    Gauge("dlrm_serve_requests_total", fn=_count_of("count", "requests")))
SERVE_REJECTED = REGISTRY.register(
    Gauge("dlrm_serve_rejected_total",
          fn=_count_of("rejected", "rejected")))
SERVE_DEADLINE_MISSED = REGISTRY.register(
    Gauge("dlrm_serve_deadline_missed_total",
          fn=_count_of("deadline_misses", "deadline")))
SERVE_DISPATCHES = REGISTRY.register(
    LabeledCounter("dlrm_serve_dispatches_total", "bucket",
                   _dispatch_buckets))
SERVE_LATENCY = REGISTRY.register(
    Histogram("dlrm_serve_latency_us", LATENCY_BUCKETS_US, _latency_hist))
SERVE_BUCKET_LATENCY = REGISTRY.register(
    LabeledHistogram("dlrm_serve_bucket_latency_us", "bucket",
                     LATENCY_BUCKETS_US, _bucket_latency_hists))
SERVE_REPLICA_QPS = REGISTRY.register(
    LabeledGauge("dlrm_serve_replica_qps", "replica", _replica_qps))
SERVE_REPLICA_QUEUE_DEPTH = REGISTRY.register(
    LabeledGauge("dlrm_serve_replica_queue_depth", "replica",
                 _replica_queue_depth))
SERVE_ROUTER_SHED = REGISTRY.register(
    Gauge("dlrm_serve_router_shed_total", fn=_router_shed_total))
SERVE_REPLICAS = REGISTRY.register(
    Gauge("dlrm_serve_replicas", fn=_serve_replicas))
PROCESS_INDEX = REGISTRY.register(
    Gauge("dlrm_process_index", fn=_process_index))
PROCESS_COUNT = REGISTRY.register(
    Gauge("dlrm_process_count", fn=_process_count))
TRAIN_STEPS = REGISTRY.register(Counter("dlrm_train_steps_total"))
TRAIN_SAMPLES_PER_S = REGISTRY.register(
    Gauge("dlrm_train_samples_per_s"))
DATA_STALL_PCT = REGISTRY.register(Gauge("dlrm_data_stall_pct"))
CHECKPOINT_SAVES = REGISTRY.register(
    Counter("dlrm_checkpoint_saves_total"))
CHECKPOINT_AGE = REGISTRY.register(
    Gauge("dlrm_checkpoint_age_s", fn=_ckpt_age))
SENTINEL_ROLLBACKS = REGISTRY.register(
    Counter("dlrm_sentinel_rollbacks_total"))
# the closed tuning loop (sim/tune.py): the newest fit's residual error,
# and the incumbent strategy's version and age
SIM_CALIBRATION_ERROR = REGISTRY.register(
    Gauge("dlrm_sim_calibration_error_pct"))
STRATEGY_AGE = REGISTRY.register(
    Gauge("dlrm_strategy_age_s", fn=_strategy_age))
STRATEGY_VERSION = REGISTRY.register(Gauge("dlrm_strategy_version"))
# fleet observability (telemetry/fleet.py): fleet_data folds the newest
# aligned step's skew in
STEP_SKEW_MS = REGISTRY.register(Gauge("dlrm_step_skew_ms"))
# the per-batch fit loop's measured exposed share: host time blocked on
# the final device fence as a percent of the fit window's wall
EXPOSED_COMM_PCT = REGISTRY.register(Gauge("dlrm_exposed_comm_pct"))
HOST_HEARTBEAT_AGE = REGISTRY.register(
    Gauge("dlrm_host_heartbeat_age_s"))
# the router bumps the ejection counter as it removes a dead replica
REPLICA_EJECTED = REGISTRY.register(
    Counter("dlrm_serve_replica_ejected_total"))
# tiered embedding storage (storage/tiered.py): the store sets both after
# a remap, outside its lock: the hit percent is cumulative over the
# store's life, the stall the latest miss block's device time
EMBED_CACHE_HIT_PCT = REGISTRY.register(
    Gauge("dlrm_embed_cache_hit_pct"))
EMBED_CACHE_MISS_STALL_US = REGISTRY.register(
    Gauge("dlrm_embed_cache_miss_stall_us"))
SERVE_SHED = REGISTRY.register(
    LabeledCounter("dlrm_serve_shed_total", "cause", _shed_causes))
# the serving SLO monitor (telemetry/slo.py): per-SLO budget and burn
# rows, which appear with a live SLOMonitor and vanish with it
SLO_ERROR_BUDGET = REGISTRY.register(
    LabeledGauge("dlrm_slo_error_budget_pct", "slo",
                 _slo_rows("budget_pct")))
SLO_BURN_RATE = REGISTRY.register(
    LabeledGauge("dlrm_slo_burn_rate", "slo", _slo_rows("burn")))


def reset() -> None:
    """Drop every tracked serving object and the retained base, and zero
    the train instruments (tests: the registry is process-wide, so a test
    that reads it starts from here)."""
    global _retired_sum, _retired_count
    with _retired_lock:
        _pending_folds.clear()
        _live_stats.clear()
        for k in _retired:
            _retired[k] = 0
        _retired_shed_causes.clear()
        for i in range(len(_retired_hist)):
            _retired_hist[i] = 0
        _retired_sum = 0.0
        _retired_count = 0
        _retired_buckets.clear()
        _retired_bucket_hist.clear()
        _retired_bucket_sum.clear()
        _retired_bucket_n.clear()
    for b in list(_live_batchers):
        _live_batchers.discard(b)
    global _retired_router_shed
    with _retired_lock:
        _pending_router_folds.clear()
        _live_shed_cells.clear()
        _retired_router_shed = 0
    for r in list(_live_routers):
        _live_routers.discard(r)
    global _last_ckpt_ts, _strategy_promoted_ts
    _last_ckpt_ts = None
    _strategy_promoted_ts = None
    for c in (TRAIN_STEPS, CHECKPOINT_SAVES, SENTINEL_ROLLBACKS,
              REPLICA_EJECTED):
        with c._lock:
            c._v = 0.0
    for g in (TRAIN_SAMPLES_PER_S, DATA_STALL_PCT, EXPOSED_COMM_PCT,
              HOST_HEARTBEAT_AGE, EMBED_CACHE_HIT_PCT,
              EMBED_CACHE_MISS_STALL_US, SIM_CALIBRATION_ERROR,
              STRATEGY_VERSION, STEP_SKEW_MS):
        g._v = None
