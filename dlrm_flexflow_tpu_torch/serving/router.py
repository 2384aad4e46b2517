"""Least-loaded replica routing over N serving engines (counterpart of
``dlrm_flexflow_tpu/serving/router.py``, ported whole).

One :class:`~.engine.InferenceEngine` + :class:`~.batcher.DynamicBatcher`
pair is a **replica**; horizontal serving scale is N of them behind a
:class:`ReplicaRouter`.  Each replica keeps its own dispatcher thread
and its own bounded queue.  The engines may be distinct or the SAME
engine shared N ways (queue-level replication: the batcher threads
interleave dispatches on one engine, whose dispatch is thread-safe; a
tiered engine keeps each dispatch's remap, install and replay in one
critical section).  On a machine with one card every replica runs on it.

Routing is **least-loaded**: ``submit`` snapshots each replica's
outstanding work (its router-accepted, not yet completed count, floored
by the batcher's live queue depth, see :meth:`loads`) and offers the
request to replicas in ascending-load order.  Offers are SILENT probes
(``record_shed=False``): a full replica's refusal is not a replica-level
shed; the router sheds the request exactly once (:class:`~.batcher.
Rejected`, reason ``router_saturated``, counted in
``dlrm_serve_router_shed_total``) and only when EVERY replica refused
it.  ``close`` drains all replicas in parallel (one closer thread each)
and returns a pooled summary with per-replica breakdowns.

The replica set is a runtime variable: :meth:`scale_to` adds or removes
replicas live (removal drains the retiring replicas, so every accepted
request still completes) and :meth:`rebuild` swaps the whole set for
fresh engine-backed replicas.  Retired replicas fold their counters into
the metrics' retained base and into this router's pooled close summary,
so the served and shed counters stay monotone across any resize.

The router is also self-healing: a replica whose dispatcher thread died,
or whose engine failed ``max_engine_failures`` consecutive dispatches
(the circuit breaker), is EJECTED from dispatch by :meth:`check_health`:
its pending futures fail with a named :class:`ReplicaDead` instead of
hanging clients, the ejection counts in
``dlrm_serve_replica_ejected_total``, and one ``recovery``
``phase="eject"`` event names the replica and reason.

Per-replica live metrics (``dlrm_serve_replica_qps{replica=}``,
``dlrm_serve_replica_queue_depth{replica=}``), the live replica count
(``dlrm_serve_replicas``) and the monotone ``dlrm_serve_router_shed_total``
ride the pull-based registry (``telemetry/metrics.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..concurrency import CloseOnce
from ..telemetry import emit
from ..telemetry import metrics as _metrics
from .batcher import DynamicBatcher, Rejected, ServeFuture


class ReplicaDead(RuntimeError):
    """A serving replica was ejected from dispatch (dead dispatcher
    thread or tripped engine circuit breaker); every future it still
    owed completes with this — NAMED, immediate — instead of leaving
    clients blocked on results that can never arrive."""


class _Replica:
    """One routed serving replica: its batcher, its stable metric label
    (labels are never reused across a router's lifetime — a scaled-away
    ``r1`` does not come back as a different engine's row), and the
    router-accepted not-yet-completed count (mutated only under the
    router's lock)."""

    __slots__ = ("batcher", "label", "inflight")

    def __init__(self, batcher: DynamicBatcher, label: str):
        self.batcher = batcher
        self.label = label
        self.inflight = 0


class ReplicaRouter:
    """N serving replicas behind one least-loaded ``submit``.

    ``engines``: one engine per replica (repeat one engine for
    queue-level replication).  The batcher knobs (``max_batch_size``,
    ``max_wait_us``, ``queue_depth``, ``timeout_us``) apply to every
    replica — including ones added later by :meth:`scale_to` /
    :meth:`rebuild`; ``name`` prefixes the ``replica=`` metric labels
    (give concurrent routers distinct names so their label rows stay
    apart).
    """

    def __init__(self, engines: Sequence, name: str = "r",
                 max_batch_size: Optional[int] = None,
                 max_wait_us: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 timeout_us: Optional[float] = None,
                 autostart: bool = True):
        engines = list(engines)
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.name = str(name)
        self._knobs = dict(max_batch_size=max_batch_size,
                           max_wait_us=max_wait_us,
                           queue_depth=queue_depth, timeout_us=timeout_us,
                           autostart=autostart)
        # one lock for the replica list, the in-flight counters, the
        # retired-replica fold buffers, and the closed flag; shed
        # counting lives in telemetry.metrics (its retained-base lock
        # keeps the counter monotone across router retirement)
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._replicas: List[_Replica] = [self._make_replica(e)
                                          for e in engines]
        # summaries + stats of replicas retired by scale_to/rebuild:
        # their requests are part of this router's story, so the pooled
        # close() summary folds them back in (their /metrics counters
        # already folded at their own close)
        self._folded: List[Dict[str, float]] = []
        self._folded_stats: List[Any] = []
        self._closed = False
        self._closer = CloseOnce()
        self._t0 = time.perf_counter()
        self._shed_cell = _metrics.track_router(self)

    def _make_replica(self, engine, force_start: bool = False) -> _Replica:
        label = f"{self.name}{next(self._seq)}"
        knobs = dict(self._knobs)
        if force_start:
            # replicas born inside a LIVE resize dispatch immediately —
            # a router built autostart=False (tests building
            # deterministic queue states) must not mint dead replicas
            # when it scales under traffic
            knobs["autostart"] = True
        return _Replica(DynamicBatcher(engine, **knobs), label)

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    @property
    def batchers(self) -> List[DynamicBatcher]:
        """Snapshot of the live replicas' batchers (the replica set is
        mutable — scale_to/rebuild; mutating this LIST changes
        nothing)."""
        with self._lock:
            return [r.batcher for r in self._replicas]

    # ---------------------------------------------------------------- intake
    def start(self) -> None:
        for b in self.batchers:
            b.start()

    def _snapshot(self) -> List[_Replica]:
        with self._lock:
            return list(self._replicas)

    @staticmethod
    def _load_of(rep: _Replica, inflight: int) -> int:
        """THE load definition: outstanding router work (accepted, not
        yet completed — queued AND dispatched) floored by the batcher's
        own queue depth (which also sees directly-submitted traffic).
        A router request still queued appears in BOTH views, so taking
        the max — not the sum — keeps it from counting twice and
        skewing the ranking toward replicas with dispatched work."""
        return max(rep.batcher.queue_depth(), inflight)

    def _load_snapshot(self, reps: Optional[List[_Replica]] = None
                       ) -> List[Tuple[_Replica, int]]:
        """One consistent ``(replica, inflight)`` snapshot (a single
        critical section) for the load computations — dispatch,
        loads(), and drain accounting all derive from it."""
        with self._lock:
            if reps is None:
                reps = list(self._replicas)
            return [(r, r.inflight) for r in reps]

    def loads(self) -> List[int]:
        """Live per-replica load (see :meth:`_load_of`).  The snapshot
        is advisory (queues move under us) — good enough to spread
        traffic, never used for correctness."""
        return [self._load_of(r, n) for r, n in self._load_snapshot()]

    def _release(self, rep: _Replica) -> None:
        with self._lock:
            rep.inflight -= 1

    def submit(self, inputs: Dict[str, Any],
               timeout_us: Optional[float] = None) -> ServeFuture:
        """Enqueue one request on the least-loaded replica; returns its
        :class:`ServeFuture`.  Raises :class:`Rejected` only when every
        replica's queue is full (reason ``router_saturated``) or the
        router is closed.  A request accepted here ALWAYS completes —
        even if its replica is scaled away mid-flight, the resize
        drains it first (docs/elastic.md)."""
        with self._lock:
            closed = self._closed
            pairs = [(r, r.inflight) for r in self._replicas]
        if closed:
            raise self._reject_shutdown()
        reps = [r for r, _n in pairs]
        loads = [self._load_of(r, n) for r, n in pairs]
        for i in sorted(range(len(reps)), key=lambda i: loads[i]):
            rep = reps[i]
            if rep.batcher.queue_full():
                continue  # saturated: skip the coercion-cost probe
            try:
                # silent probe: a refused offer must not count as a
                # replica-level shed, or one router-shed request would
                # inflate dlrm_serve_rejected_total (and the pooled
                # summary's `rejected`) N-fold — the router records
                # the ONE real shed below.  A replica retired by a
                # concurrent scale_to refuses here too (its batcher is
                # closed or draining; anything it already accepted is
                # still delivered by the drain).
                fut = rep.batcher.submit(inputs, timeout_us,
                                         record_shed=False)
            except Rejected:
                continue  # this replica is saturated; try the next
            with self._lock:
                rep.inflight += 1
            fut.add_done_callback(lambda _f, rep=rep: self._release(rep))
            return fut
        # every replica refused.  Re-check _closed before calling it a
        # shed: a submit racing close() sees every probe refused because
        # the batchers were swept, not because traffic saturated them —
        # that is a shutdown reject, and counting it would pollute
        # dlrm_serve_router_shed_total's pure-saturation signal.
        with self._lock:
            closed = self._closed
        if closed:
            raise self._reject_shutdown()
        # THE router-level shed.  The count goes through the metrics
        # module so it stays monotone even when the fold-on-retire
        # races a late submit; the emit runs outside every lock.  The
        # cell also backs dlrm_serve_shed_total{cause="saturated"}.
        _metrics.record_router_shed(self._shed_cell)
        emit("serve", phase="reject", reason="router_saturated")
        raise Rejected(
            f"all {len(reps)} replicas saturated — router shedding")

    def _reject_shutdown(self) -> Rejected:
        """Record + emit one post-shutdown reject and build its
        exception.  Counts into ``dlrm_serve_rejected_total`` exactly
        like a submit on a closed batcher would (the retired batchers'
        stats are folded, so the count lands in the retained base) —
        /metrics and the event stream stay in agreement during
        shutdown."""
        with self._lock:
            # ejections can empty the live set — fall back to a folded
            # replica's stats so the reject still reaches /metrics
            stats = (self._replicas[0].batcher.stats if self._replicas
                     else self._folded_stats[0] if self._folded_stats
                     else None)
        if stats is not None:
            _metrics.record_shed_late(stats, cause="shutdown")
        emit("serve", phase="reject", reason="shutdown")
        return Rejected("router is shut down")

    def predict(self, inputs: Dict[str, Any],
                timeout_us: Optional[float] = None,
                result_timeout_s: Optional[float] = None):
        """Blocking convenience: submit + wait for the result."""
        return self.submit(inputs, timeout_us).result(result_timeout_s)

    # -------------------------------------------------------------- metrics
    def replica_labels(self) -> List[str]:
        return [r.label for r in self._snapshot()]

    def replica_rows(self) -> List[Tuple[str, DynamicBatcher]]:
        """ONE consistent (label, batcher) snapshot for the metrics
        collectors — the replica set is mutable, so separate
        labels/batchers reads could zip mismatched rows."""
        return [(r.label, r.batcher) for r in self._snapshot()]

    def shed_count(self) -> int:
        """Router-level sheds so far (requests no replica could take)."""
        return _metrics.router_shed_count(self._shed_cell)

    # ---------------------------------------------------------------- health
    def check_health(self, max_engine_failures: Optional[int] = None
                     ) -> List[str]:
        """Probe every live replica and eject the dead ones; returns
        the ejected labels (usually empty).  Two probes
        (docs/serving.md):

        * **dispatcher liveness** — the batcher's dispatcher thread
          died unexpectedly (``DynamicBatcher.dispatcher_dead``); its
          own death path already failed its pending futures, ejection
          removes it from dispatch and folds its counters;
        * **circuit breaker** — ``max_engine_failures`` (when given)
          or more CONSECUTIVE failed engine dispatches: the engine
          still answers but only with errors, so routing more traffic
          at it just converts requests into exceptions.

        Each ejection fails the replica's remaining futures with
        :class:`ReplicaDead`, bumps
        ``dlrm_serve_replica_ejected_total``, and emits one
        ``recovery`` ``phase="eject"`` event.  Cheap enough to call on
        a timer or before every scrape; never blocks on a dead
        dispatcher."""
        dead: List[Tuple[_Replica, str]] = []
        for rep in self._snapshot():
            if rep.batcher.dispatcher_dead():
                dead.append((rep, "dispatcher_dead"))
            elif (max_engine_failures is not None
                  and rep.batcher.consecutive_engine_failures()
                  >= int(max_engine_failures)):
                dead.append((rep, "engine_failures"))
        return [rep.label for rep, reason in dead
                if self._eject(rep, reason)]

    def _eject(self, rep: _Replica, reason: str) -> bool:
        """Remove one dead replica from dispatch and fail what it owed.
        Returns False when a concurrent eject/resize/close already took
        it (the list swap under the lock is the election)."""
        with self._lock:
            if self._closed or rep not in self._replicas:
                return False
            self._replicas = [r for r in self._replicas if r is not rep]
        err = ReplicaDead(
            f"replica {rep.label} ejected from dispatch: {reason} — "
            f"its pending requests fail here; surviving replicas keep "
            f"serving (docs/serving.md)")
        # fail first (queued + carry complete NOW, loudly), then close
        # without drain: on a live-but-broken dispatcher (the breaker
        # case) that lands the stop sentinel and joins the thread; on a
        # dead one it just folds the counters.
        failed = rep.batcher.fail_pending(err)
        summary = rep.batcher.close(drain=False, emit_summary=False)
        with self._lock:
            self._folded.append(summary)
            self._folded_stats.append(rep.batcher.stats)
        _metrics.REPLICA_EJECTED.inc()
        emit("recovery", phase="eject", replica=rep.label,
             reason=reason, failed=len(failed))
        return True

    # ------------------------------------------------------------- elasticity
    def _retire(self, retiring: List[_Replica]) -> int:
        """Gracefully drain + fold a batch of removed replicas (already
        swapped OUT of the live list, so no new offer reaches them).
        Every request they had accepted is delivered before their
        dispatchers exit; their summaries/stats join the fold buffers
        so the pooled close() summary keeps counting them.  Returns the
        (advisory) number of requests that were still outstanding when
        the resize started."""
        outstanding = sum(self._load_of(r, n)
                          for r, n in self._load_snapshot(retiring))
        for r in retiring:
            # fold each replica as its drain completes (not batched at
            # the end): a close() racing the tail of a resize misses at
            # most the replicas still draining, and their counters are
            # already safe in the metrics retained base either way
            summary = r.batcher.close(drain=True, emit_summary=False)
            with self._lock:
                self._folded.append(summary)
                self._folded_stats.append(r.batcher.stats)
        return outstanding

    def scale_to(self, n: int, engines: Optional[Sequence] = None
                 ) -> Dict[str, int]:
        """Resize the live replica set to ``n`` without dropping a
        single accepted request (docs/elastic.md).

        Growing: new replicas are built with the router's batcher knobs
        around ``engines`` (cycling the CURRENT engines when omitted —
        queue-level replication) and start taking traffic as soon as
        the list swap lands.  Shrinking: the highest-numbered replicas
        are atomically removed from dispatch, then drained — their
        queued and in-flight requests all complete, their counters fold
        (metrics stay monotone), and only then does scale_to return.
        Emits one ``elastic`` ``phase="scale"`` event.  Returns
        ``{"replicas_from", "replicas_to", "drained"}``.

        Concurrent ``scale_to`` calls are not coordinated (last swap
        wins), and a ``close()`` overlapping a shrink's drain may
        snapshot the pooled summary before the still-draining replicas
        fold into it (their /metrics counters are safe regardless —
        fold-on-retire) — callers serialize resizes and shutdown.
        """
        n = int(n)
        if n < 1:
            raise ValueError(f"scale_to needs n >= 1, got {n}")
        t0 = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("router is shut down")
            before = len(self._replicas)
            pool = (list(engines) if engines
                    else [r.batcher.engine for r in self._replicas])
        if n > before and not pool:
            # every replica was ejected dead: there is no live engine
            # to clone — the caller must supply rebuilt ones
            raise ValueError(
                "scale_to cannot grow an empty replica set without "
                "engines= — every replica was ejected; pass fresh "
                "engines (docs/serving.md)")
        drained = 0
        if n > before:
            # build OUTSIDE the lock (batcher ctors start threads and
            # register metrics), swap in under it
            built = [self._make_replica(pool[i % len(pool)],
                                        force_start=True)
                     for i in range(n - before)]
            with self._lock:
                if self._closed:
                    rollback = built
                else:
                    self._replicas = self._replicas + built
                    rollback = []
            for r in rollback:  # lost the race with close()
                r.batcher.close(drain=False, emit_summary=False)
            if rollback:
                raise RuntimeError("router is shut down")
        elif n < before:
            with self._lock:
                if self._closed:
                    raise RuntimeError("router is shut down")
                retiring = self._replicas[n:]
                self._replicas = self._replicas[:n]
            drained = self._retire(retiring)
        emit("elastic", phase="scale", replicas_from=before,
             replicas_to=n, drained=drained,
             duration_s=time.perf_counter() - t0)
        return {"replicas_from": before, "replicas_to": n,
                "drained": drained}

    def rebuild(self, engines: Sequence) -> Dict[str, int]:
        """Swap EVERY replica for fresh ones backed by ``engines`` —
        the serving half of a topology change (docs/elastic.md): the
        caller builds new engines (e.g. from a newer checkpoint), the
        router brings them live first, then drains the old replicas so
        every accepted request still completes.  Emits one
        ``elastic`` ``phase="scale"`` event; returns the same dict as
        :meth:`scale_to`."""
        engines = list(engines)
        if not engines:
            raise ValueError("rebuild needs at least one engine")
        t0 = time.perf_counter()
        built = [self._make_replica(e, force_start=True)
                 for e in engines]
        with self._lock:
            if self._closed:
                rollback, old = built, []
            else:
                old = self._replicas
                self._replicas = built
                rollback = []
        for r in rollback:
            r.batcher.close(drain=False, emit_summary=False)
        if rollback:
            raise RuntimeError("router is shut down")
        before = len(old)
        drained = self._retire(old)
        emit("elastic", phase="scale", replicas_from=before,
             replicas_to=len(built), drained=drained,
             duration_s=time.perf_counter() - t0)
        return {"replicas_from": before, "replicas_to": len(built),
                "drained": drained}

    # ------------------------------------------------------------- shutdown
    def close(self, drain: bool = True,
              emit_summary: bool = True) -> Dict[str, Any]:
        """Stop intake on every replica and close them IN PARALLEL
        (graceful by default: each replica drains its queue and
        delivers every future before its dispatcher exits).  Returns a
        pooled summary — totals, pooled latency percentiles, the
        router-level shed count, and ``per_replica`` breakdowns
        (replicas retired earlier by scale_to/rebuild included: their
        folded counts keep the totals monotone with what /metrics
        exposed) — and by default emits it as one ``serve``
        ``phase="summary"`` event (replica batchers fold their
        counters into /metrics' retained base as they retire; their
        per-batcher summary events are suppressed in favor of this
        pooled one).  Idempotent like ``DynamicBatcher.close`` —
        winner election, parked concurrent closers, and
        failed-shutdown un-elect shared via
        :class:`~..concurrency.CloseOnce`."""
        return self._closer.run(lambda: self._close(drain, emit_summary))

    def _close(self, drain: bool, emit_summary: bool) -> Dict[str, Any]:
        with self._lock:
            self._closed = True
            live = list(self._replicas)
        per: List[Optional[Dict[str, float]]] = [None] * len(live)
        errs: List[BaseException] = []

        def closer(i: int, b: DynamicBatcher) -> None:
            try:
                per[i] = b.close(drain=drain, emit_summary=False)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs.append(e)

        threads = [threading.Thread(target=closer, args=(i, r.batcher),
                                    name=f"dlrm-router-close-{i}",
                                    daemon=True)
                   for i, r in enumerate(live)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        # wall measured AFTER the parallel drain: requests served while
        # draining are in the replicas' counts, so the pooled qps must
        # span the time they took (same contract as the batcher, whose
        # summary wall closes after the dispatcher join)
        wall_s = time.perf_counter() - self._t0
        with self._lock:
            folded = list(self._folded)
            folded_stats = list(self._folded_stats)
        all_summaries = folded + [s for s in per if s is not None]
        pooled = np.asarray(
            [v for st in (folded_stats + [r.batcher.stats for r in live])
             for v in st.samples()])
        summary: Dict[str, Any] = {
            "replicas": len(live),
            "wall_s": float(wall_s),
            "requests": int(sum(s["requests"] for s in all_summaries)),
            "dispatches": int(sum(s["dispatches"]
                                  for s in all_summaries)),
            "rejected": int(sum(s["rejected"] for s in all_summaries)),
            "deadline_misses": int(sum(s["deadline_misses"]
                                       for s in all_summaries)),
            "router_shed": int(self.shed_count()),
        }
        summary["qps"] = summary["requests"] / max(wall_s, 1e-9)
        if pooled.size:
            p50, p95, p99 = np.percentile(pooled, [50, 95, 99])
            summary.update(p50_us=float(p50), p95_us=float(p95),
                           p99_us=float(p99),
                           mean_us=float(pooled.mean()))
        ev = dict(summary)  # schema-shaped (per_replica is report-only)
        summary["per_replica"] = folded + per
        _metrics.retire_router(self)
        if emit_summary:
            emit("serve", phase="summary", **ev)
        return summary

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
