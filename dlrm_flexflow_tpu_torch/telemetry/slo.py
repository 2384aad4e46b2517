"""Serving SLO engine: declarative objectives + multi-window burn-rate
monitoring (counterpart of ``dlrm_flexflow_tpu/telemetry/slo.py``, the
same state machine, events and gauges).

The serving tier exposes raw gauges (p99, queue depth, shed counts);
this module turns them into *verdicts*: is the service meeting its
declared objectives, how fast is it burning error budget, and why is
the tail slow.  An :class:`SLO` declares one objective —

* **latency** — at most ``1 - objective`` of requests may exceed a
  latency threshold (``p99_ms=5``: 1% of requests over 5 ms), read
  from the ``dlrm_serve_latency_us`` cumulative histogram (or one
  bucket's row of ``dlrm_serve_bucket_latency_us``);
* **availability** — served / (served + shed + deadline + rejected)
  must stay above a target, read from the request counter next to the
  cause-split ``dlrm_serve_shed_total`` family;
* **freshness** — a gauge (default ``dlrm_strategy_age_s``) must stay
  under a max age; each evaluation tick contributes one good/stale
  sample.

— and an :class:`SLOMonitor` samples the metrics registry on an
injectable clock and evaluates Google-SRE-style multi-window burn
rates: the error rate over a FAST window (default 60 s) and a SLOW
window (default 300 s), each divided by the budgeted error rate
(``1 - objective``).  A fast-window burn over its threshold (default
14.4 — the SRE-workbook page-severity rate) trips quickly on a step
change; the slow window (default threshold 6) catches sustained
smolder the fast window forgives.  Window lengths are per-SLO
configuration, so tests run the whole state machine in milliseconds
on a fake clock.

Every tick emits one schema-checked ``slo`` event per objective
(phase ``eval``); crossing into breach emits ``breach`` — naming the
objective, the measured windowed bad fraction, and the dominant tail
phase from the exemplar sweep — dumps ONE flight record via
:func:`telemetry.fleet.dump_flight_record` (best-effort: serving is
never aborted by its own monitoring), and flips the exporter's
``/healthz`` to degraded; returning below threshold emits ``recover``
and restores health once no objective is breached.  Remaining error
budget since monitor start is tracked per SLO and exposed (with the
worst-window burn rate) as the labelled gauge families
``dlrm_slo_error_budget_pct{slo=}`` / ``dlrm_slo_burn_rate{slo=}``.

Everything here runs OFF the engine forward path: the monitor reads
pull-based collectors the hot paths already feed, so it adds no lock
acquisition to serving dispatch.  Monitor state is guarded by the
monitor's own lock; events and flight records are emitted outside it.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from . import metrics as tmetrics
from .events import emit

#: the burn-rate thresholds of the SRE workbook's two paging windows:
#: a 14.4x burn exhausts a 30-day budget in ~2 days (page now), a 6x
#: burn in 5 days (page soon) — docs/slo.md.
FAST_BURN = 14.4
SLOW_BURN = 6.0

_PCTL_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)_(ms|us)$")


class SLO:
    """One declarative objective.  ``kind`` is "latency",
    "availability", or "freshness"; ``objective`` is the required
    GOOD fraction (0.999 = three nines), so the error budget is
    ``1 - objective``.  Latency SLOs carry ``threshold_us`` (+
    optional ``bucket`` to gate one compiled bucket's histogram row);
    freshness SLOs carry ``gauge`` + ``max_age_s``.  ``probe``
    overrides the registry read with any ``() -> (total, bad)``
    cumulative-count callable — tests feed synthetic streams through
    it."""

    def __init__(self, name: str, kind: str, objective: float,
                 threshold_us: Optional[float] = None,
                 bucket: Optional[int] = None,
                 gauge: str = "dlrm_strategy_age_s",
                 max_age_s: Optional[float] = None,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0,
                 burn_fast: float = FAST_BURN,
                 burn_slow: float = SLOW_BURN,
                 probe: Optional[Callable[[], Tuple[float, float]]]
                 = None):
        if kind not in ("latency", "availability", "freshness"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if not 0.0 < float(objective) < 1.0:
            raise ValueError(
                f"SLO {name!r}: objective must be in (0, 1), got "
                f"{objective!r} (the error budget is 1 - objective)")
        if kind == "latency" and threshold_us is None:
            raise ValueError(f"latency SLO {name!r} needs threshold_us")
        if kind == "freshness" and max_age_s is None:
            raise ValueError(f"freshness SLO {name!r} needs max_age_s")
        if float(slow_window_s) <= float(fast_window_s):
            raise ValueError(
                f"SLO {name!r}: slow window ({slow_window_s}s) must "
                f"be longer than the fast window ({fast_window_s}s)")
        self.name = str(name)
        self.kind = kind
        self.objective = float(objective)
        self.threshold_us = (None if threshold_us is None
                             else float(threshold_us))
        self.bucket = None if bucket is None else int(bucket)
        self.gauge = str(gauge)
        self.max_age_s = None if max_age_s is None else float(max_age_s)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_fast = float(burn_fast)
        self.burn_slow = float(burn_slow)
        self.probe = probe

    @property
    def budget(self) -> float:
        """The budgeted error rate: the bad fraction the objective
        permits (1 - objective)."""
        return 1.0 - self.objective

    def __repr__(self):
        return (f"SLO({self.name!r}, kind={self.kind!r}, "
                f"objective={self.objective})")


def parse_slos(spec: str, **window_kw) -> List["SLO"]:
    """SLOs from the ``--slo`` mini-language of the JAX package's
    serve_bench: comma-separated ``key=value`` pairs (docs/slo.md).

    * ``p99_ms=5`` (any ``pXX_ms``/``pXX_us``) — latency: at most
      (100-XX)% of requests over the threshold;
    * ``availability=99.9`` — percent of submitted requests served;
    * ``freshness=600`` or ``freshness:dlrm_checkpoint_age_s=600`` —
      the gauge (default ``dlrm_strategy_age_s``) stays under the
      bound, with a 99% objective on evaluation samples.

    ``window_kw`` (``fast_window_s`` etc.) applies to every parsed
    SLO — a bench shrinks the windows to fit the run length.
    """
    out: List[SLO] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"--slo entry {part!r}: want key=value (docs/slo.md)")
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        m = _PCTL_RE.match(key)
        if m:
            pct, unit = float(m.group(1)), m.group(2)
            thr = float(val) * (1000.0 if unit == "ms" else 1.0)
            out.append(SLO(key, "latency", objective=pct / 100.0,
                           threshold_us=thr, **window_kw))
        elif key == "availability":
            out.append(SLO(key, "availability",
                           objective=float(val) / 100.0, **window_kw))
        elif key == "freshness" or key.startswith("freshness:"):
            gauge = (key.partition(":")[2] if ":" in key
                     else "dlrm_strategy_age_s")
            out.append(SLO(key, "freshness", objective=0.99,
                           gauge=gauge, max_age_s=float(val),
                           **window_kw))
        else:
            raise ValueError(
                f"--slo entry {key!r}: want pXX_ms/pXX_us, "
                f"availability, or freshness[:<gauge>] (docs/slo.md)")
    if not out:
        raise ValueError(f"--slo {spec!r}: no objectives parsed")
    return out


# live monitors, swept by the dlrm_slo_* gauge collectors
# (metrics._slo_rows); rows appear with a monitor and vanish with it
_monitors: "weakref.WeakSet" = weakref.WeakSet()
_monitors_lock = threading.Lock()


def gauge_rows(which: str) -> Dict[str, float]:
    """{slo_name: value} across live monitors for one gauge family
    ("budget_pct" or "burn") — the scrape-time collector behind
    ``dlrm_slo_error_budget_pct`` / ``dlrm_slo_burn_rate``."""
    with _monitors_lock:
        monitors = list(_monitors)
    out: Dict[str, float] = {}
    for mon in monitors:
        out.update(mon.rows(which))
    return out


def dominant_tail_phase() -> str:
    """The phase that contributes the most wall across the live tail
    exemplars (queue_wait / pad / engine_forward / miss_stall), or
    "none" with no exemplars — the breach event's attribution field."""
    sums = {"queue_wait": 0.0, "pad": 0.0, "engine_forward": 0.0,
            "miss_stall": 0.0}
    rows = tmetrics.tail_exemplars(limit=0)
    if not rows:
        return "none"
    for r in rows:
        sums["queue_wait"] += float(r.get("queue_wait_us", 0.0))
        sums["pad"] += float(r.get("pad_us", 0.0))
        sums["engine_forward"] += float(r.get("compute_us", 0.0))
        sums["miss_stall"] += float(r.get("stall_us", 0.0))
    return max(sums.items(), key=lambda kv: kv[1])[0]


class _SloState:
    """Per-SLO monitor state: the (t, total, bad) cumulative snapshot
    ring the windowed deltas read, the monitor-start baseline the
    budget reads, and the breach latch."""

    __slots__ = ("samples", "base_total", "base_bad", "breached",
                 "burn_fast", "burn_slow", "budget_pct", "value")

    def __init__(self):
        self.samples: List[Tuple[float, float, float]] = []
        self.base_total: Optional[float] = None
        self.base_bad = 0.0
        self.breached = False
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.budget_pct = 100.0
        self.value = 0.0


class SLOMonitor:
    """Samples the metrics registry on an injectable clock and turns
    declared SLOs into burn rates, budget, events, and breach
    response.  ``tick()`` is one evaluation pass (tests and
    benches drive it directly — deterministic, no thread);
    ``start()`` runs it on a daemon thread every ``interval_s`` until
    ``stop()``.  ``flight_dir`` overrides where breach flight records
    land (default: dump_flight_record's own artifacts/ policy);
    ``flight`` disables the dump entirely when False."""

    #: in-memory breach flight-record paths retained (the newest); the
    #: record FILES are never deleted — this bounds only the list
    KEEP_FLIGHT_PATHS = 16

    def __init__(self, slos: List[SLO], interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[tmetrics.MetricsRegistry] = None,
                 flight: bool = True,
                 flight_dir: Optional[str] = None):
        if not slos:
            raise ValueError("SLOMonitor needs at least one SLO")
        self.slos = list(slos)
        self.interval_s = float(interval_s)
        self.clock = clock
        self.registry = registry or tmetrics.REGISTRY
        self.flight = bool(flight)
        self.flight_dir = flight_dir
        self._lock = threading.Lock()
        self._state: Dict[str, _SloState] = {
            s.name: _SloState() for s in self.slos}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.breach_count = 0
        self.flight_paths: List[str] = []
        with _monitors_lock:
            _monitors.add(self)

    # ------------------------------------------------------------ probes
    def _probe(self, slo: SLO) -> Optional[Tuple[float, float]]:
        """Cumulative (total, bad) for one SLO right now, or None when
        the source has no data yet (freshness gauge unset)."""
        if slo.probe is not None:
            t, b = slo.probe()
            return float(t), float(b)
        if slo.kind == "latency":
            return self._probe_latency(slo)
        if slo.kind == "availability":
            return self._probe_availability()
        return self._probe_freshness(slo)

    def _probe_latency(self, slo: SLO) -> Optional[Tuple[float, float]]:
        if slo.bucket is not None:
            inst = self.registry.get("dlrm_serve_bucket_latency_us")
            if inst is None:
                return None
            row = inst.sample().get(str(slo.bucket))
            if row is None:
                return (0.0, 0.0)
            cum, _s, n = row
        else:
            inst = self.registry.get("dlrm_serve_latency_us")
            if inst is None:
                return None
            cum, _s, n = inst.sample()
        edges = inst.buckets
        i = bisect.bisect_left(edges, float(slo.threshold_us))
        # count at the first edge >= threshold bounds "requests under
        # threshold" from above: bad counts only requests the edge
        # grid PROVES are over (threshold past the last edge can
        # prove nothing — every request lands in a <= slot)
        good = float(cum[i]) if i < len(edges) else float(n)
        return float(n), max(float(n) - good, 0.0)

    def _probe_availability(self) -> Tuple[float, float]:
        inst = self.registry.get("dlrm_serve_requests_total")
        served = 0.0
        if inst is not None and inst.value is not None:
            served = float(inst.value)
        shed = self.registry.get("dlrm_serve_shed_total")
        bad = 0.0
        if shed is not None:
            bad = float(sum(shed.sample().values()))
        return served + bad, bad

    def _probe_freshness(self, slo: SLO) -> Optional[Tuple[float, float]]:
        inst = self.registry.get(slo.gauge)
        if inst is None or inst.value is None:
            return None  # gauge unset: no sample this tick
        st = self._state[slo.name]
        with self._lock:
            total = (st.samples[-1][1] + 1.0) if st.samples else 1.0
            bad = (st.samples[-1][2] if st.samples else 0.0)
        if float(inst.value) > float(slo.max_age_s):
            bad += 1.0
        return total, bad

    # -------------------------------------------------------- evaluation
    @staticmethod
    def _window_rate(samples: List[Tuple[float, float, float]],
                     now: float, window_s: float) -> float:
        """Bad fraction over the trailing window: delta against the
        newest snapshot at or before the window start (the earliest
        retained snapshot when the monitor is younger than the
        window).  No traffic in the window = no errors = rate 0."""
        if not samples:
            return 0.0
        t_lo = now - window_s
        base = samples[0]
        for s in samples:
            if s[0] <= t_lo:
                base = s
            else:
                break
        d_total = samples[-1][1] - base[1]
        d_bad = samples[-1][2] - base[2]
        if d_total <= 0:
            return 0.0
        return max(d_bad, 0.0) / d_total

    def tick(self) -> List[dict]:
        """One evaluation pass over every SLO: sample, rotate windows,
        update burn/budget, run the breach state machine.  Returns the
        emitted event payloads (tests assert on them).  State mutates
        under the monitor lock; events, flight records, and the health
        flip happen OUTSIDE it."""
        now = float(self.clock())
        events: List[dict] = []
        breaches: List[dict] = []
        for slo in self.slos:
            sample = self._probe(slo)
            st = self._state[slo.name]
            with self._lock:
                if sample is not None:
                    total, bad = sample
                    if st.base_total is None:
                        st.base_total, st.base_bad = total, bad
                    st.samples.append((now, total, bad))
                    # rotate: keep one snapshot at/older than the slow
                    # window so its delta stays full-width
                    t_lo = now - slo.slow_window_s
                    while (len(st.samples) >= 2
                           and st.samples[1][0] <= t_lo):
                        st.samples.pop(0)
                st.burn_fast = self._window_rate(
                    st.samples, now, slo.fast_window_s) / slo.budget
                st.burn_slow = self._window_rate(
                    st.samples, now, slo.slow_window_s) / slo.budget
                st.value = self._window_rate(
                    st.samples, now, slo.fast_window_s)
                if st.samples and st.base_total is not None:
                    life_total = st.samples[-1][1] - st.base_total
                    life_bad = st.samples[-1][2] - st.base_bad
                    if life_total > 0:
                        used = ((life_bad / life_total) / slo.budget)
                        st.budget_pct = max(0.0, 100.0 * (1.0 - used))
                tripped = (st.burn_fast >= slo.burn_fast
                           or st.burn_slow >= slo.burn_slow)
                transition = None
                if tripped and not st.breached:
                    st.breached, transition = True, "breach"
                elif not tripped and st.breached:
                    st.breached, transition = False, "recover"
                snap = dict(slo=slo.name, kind=slo.kind,
                            value=st.value, objective=slo.objective,
                            burn_fast=st.burn_fast,
                            burn_slow=st.burn_slow,
                            budget_pct=st.budget_pct)
            events.append(dict(snap, phase="eval"))
            if transition == "breach":
                breaches.append(dict(
                    snap, phase="breach",
                    window_s=slo.fast_window_s,
                    dominant=dominant_tail_phase()))
            elif transition == "recover":
                events.append(dict(snap, phase="recover"))
        # breach response outside the lock: flight record (best-effort
        # — monitoring must never abort serving), breach event naming
        # the objective + dominant tail phase, health degraded
        for ev in breaches:
            with self._lock:
                self.breach_count += 1
            if self.flight:
                try:
                    from .fleet import dump_flight_record
                    path = dump_flight_record(out_dir=self.flight_dir)
                except Exception:
                    path = None
                if path:
                    ev["flight"] = path
                    with self._lock:
                        self.flight_paths.append(path)
                        # keep the recent records only: a flapping
                        # objective breaches every tick for hours and
                        # this list lives as long as the process
                        # (ffcheck bounded-growth); the files stay on
                        # disk, operators list flight_dir for history
                        del self.flight_paths[:-self.KEEP_FLIGHT_PATHS]
            events.append(ev)
        for ev in events:
            emit("slo", **ev)
        self._update_health()
        return events

    def _update_health(self) -> None:
        from . import exporter
        with self._lock:
            bad = sorted(n for n, st in self._state.items()
                         if st.breached)
        if bad:
            exporter.set_health("degraded",
                                reason="slo:" + ",".join(bad))
        else:
            exporter.set_health("ok")

    def rows(self, which: str) -> Dict[str, float]:
        """{slo_name: value} for one gauge family ("budget_pct" or
        "burn" — the worst of the two windows)."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, st in self._state.items():
                out[name] = (st.budget_pct if which == "budget_pct"
                             else max(st.burn_fast, st.burn_slow))
        return out

    def breached(self) -> List[str]:
        """Names of currently-breached SLOs (sorted)."""
        with self._lock:
            return sorted(n for n, st in self._state.items()
                          if st.breached)

    def summary(self) -> Dict[str, dict]:
        """Per-SLO end-of-run readout for a bench: budget
        remaining, worst burn rate, current windowed bad fraction,
        breach latch."""
        with self._lock:
            return {n: {"budget_pct": st.budget_pct,
                        "burn": max(st.burn_fast, st.burn_slow),
                        "value": st.value,
                        "breached": st.breached}
                    for n, st in self._state.items()}

    # ---------------------------------------------------------- threading
    def start(self) -> "SLOMonitor":
        """Run ``tick()`` every ``interval_s`` on a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="slo-monitor", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # monitoring must never take the server down with it;
                # next tick retries against fresh registry state
                pass

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        with _monitors_lock:
            _monitors.discard(self)
        from . import exporter
        exporter.set_health("ok")
