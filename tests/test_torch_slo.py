"""The port's serving SLO engine (``dlrm_flexflow_tpu_torch/telemetry/slo.py``
with ``exporter.set_health``/``health``) against the JAX package's on the
CPU: the ``--slo`` mini-language, and on one fake clock and one request
stream the same sequence of ``slo`` events (``ts`` aside) from both
monitors, whether the stream comes through a probe or through each
package's metrics registry; breach and recover with the ``/healthz``
verdict over HTTP, one flight record a breach, the budget and burn gauge
rows, the freshness SLO on the strategy-age gauge, and the port's fused
engine served under a monitor.  No sleeps in the monitor tests: the clock
is advanced by hand.

The port's metrics registry is process-wide, so every test starts from
``metrics.reset()``; every monitor a test starts is stopped.
"""

import json
import urllib.request

import numpy as np
import pytest

from dlrm_flexflow_tpu.serving.stats import LatencyStats as JaxLatencyStats
from dlrm_flexflow_tpu.telemetry import EventLog as JaxEventLog
from dlrm_flexflow_tpu.telemetry import exporter as jexporter
from dlrm_flexflow_tpu.telemetry import metrics as jmetrics
from dlrm_flexflow_tpu.telemetry import set_event_log as jax_set_event_log
from dlrm_flexflow_tpu.telemetry import slo as jslo
from dlrm_flexflow_tpu.telemetry.fleet import render_flight as jax_render

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.serving import DynamicBatcher, InferenceEngine
from dlrm_flexflow_tpu_torch.serving.stats import LatencyStats
from dlrm_flexflow_tpu_torch.telemetry import EventLog, set_event_log
from dlrm_flexflow_tpu_torch.telemetry import exporter as pexporter
from dlrm_flexflow_tpu_torch.telemetry import fleet as pfleet
from dlrm_flexflow_tpu_torch.telemetry import metrics as pmetrics
from dlrm_flexflow_tpu_torch.telemetry import slo as pslo
from dlrm_flexflow_tpu_torch.telemetry.regress import lower_is_better
from dlrm_flexflow_tpu_torch.telemetry.schema import SCHEMA, validate_event


@pytest.fixture(autouse=True)
def _fresh_registry():
    pmetrics.reset()
    yield
    pmetrics.reset()
    pexporter.set_health("ok")


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class _Stream:
    """A scripted cumulative (total, bad) probe."""

    def __init__(self):
        self.total = 0.0
        self.bad = 0.0

    def feed(self, n: float, bad: float = 0.0) -> None:
        self.total += n
        self.bad += bad

    def __call__(self):
        return self.total, self.bad


def _slo_attrs(s):
    return {k: v for k, v in vars(s).items() if k != "probe"}


# ------------------------------------------------------------------ spec

@pytest.mark.parametrize("spec,kw", [
    ("p99_ms=5,p95_us=800", {}),
    ("availability=99.9,freshness=600,freshness:dlrm_checkpoint_age_s=30",
     {}),
    ("p99_ms=5,availability=99", {"fast_window_s": 0.5,
                                  "slow_window_s": 2.0}),
    ("p99.9_ms=2.5", {"burn_fast": 10.0, "burn_slow": 3.0}),
])
def test_parse_slos_equals_jax(spec, kw):
    got = [_slo_attrs(s) for s in pslo.parse_slos(spec, **kw)]
    assert got == [_slo_attrs(s) for s in jslo.parse_slos(spec, **kw)]


@pytest.mark.parametrize("spec", ["p99=5", "qps=100", "p99_ms", ""])
def test_parse_slos_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as pe:
        pslo.parse_slos(spec)
    with pytest.raises(ValueError) as je:
        jslo.parse_slos(spec)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("args,kw", [
    (("x", "latencies", 0.99), {"threshold_us": 1.0}),
    (("x", "availability", 99.9), {}),
    (("x", "latency", 0.99), {}),
    (("x", "freshness", 0.99), {}),
    (("x", "availability", 0.99), {"fast_window_s": 5.0,
                                   "slow_window_s": 5.0}),
])
def test_slo_shape_checks_equal_jax(args, kw):
    with pytest.raises(ValueError) as pe:
        pslo.SLO(*args, **kw)
    with pytest.raises(ValueError) as je:
        jslo.SLO(*args, **kw)
    assert str(pe.value) == str(je.value)


# ------------------------------------------------- event sequences vs JAX

#: scripted ticks: (requests, bad) fed before each tick
SCENARIOS = {
    "healthy": [(100, 0)] * 12,
    "step-change-fast-trips": [(100, 0)] * 10 + [(100, 30)] + [(100, 0)] * 3,
    "breach-and-recover": [(100, 0)] * 6 + [(100, 50)] + [(100, 0)] * 14,
    "budget-exhausted": [(0, 0), (1000, 5), (1000, 100), (1000, 0)],
    "no-traffic": [(0, 0)] * 6,
    "smolder-slow-window": [(100, 3)] * 16 + [(100, 0)] * 12,
}


def _run_probe(mod, log_cls, set_log, ticks, seed, rows):
    stream, clock = _Stream(), _FakeClock()
    rng = np.random.default_rng(seed)
    slo = mod.SLO("s", "availability", objective=0.99, fast_window_s=2.0,
                  slow_window_s=10.0, probe=stream)
    log = log_cls()
    prev = set_log(log)
    mon = mod.SLOMonitor([slo], clock=clock, flight=False)
    try:
        for n, bad in ticks:
            stream.feed(n, bad)
            clock.t += float(rng.choice([0.5, 1.0, 1.0, 2.0]))
            mon.tick()
        state = (mon.breached(), mon.summary(), mon.rows("budget_pct"),
                 mon.rows("burn"), mon._state["s"].samples)
    finally:
        mon.stop()
        set_log(prev)
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in log.events("slo")], state


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("seed", [0, 1])
def test_probe_stream_events_equal_jax(scenario, seed, monkeypatch):
    """The same stream on the same clock: the same slo events in the same
    order (eval, breach with its dominant tail phase, recover) and the
    same end state, in both packages."""
    rows = [{"lat_us": 900.0, "queue_wait_us": 700.0, "pad_us": 5.0,
             "compute_us": 150.0, "stall_us": 0.0}]
    monkeypatch.setattr(pmetrics, "tail_exemplars", lambda limit=10: rows)
    monkeypatch.setattr(jmetrics, "tail_exemplars", lambda limit=10: rows)
    ticks = SCENARIOS[scenario]
    pev, pstate = _run_probe(pslo, EventLog, set_event_log, ticks, seed,
                             rows)
    jev, jstate = _run_probe(jslo, JaxEventLog, jax_set_event_log, ticks,
                             seed, rows)
    assert pev == jev
    assert pstate == jstate
    for e in pev:
        assert validate_event(dict(e, type="slo", ts=0.0)) == []
    if scenario == "breach-and-recover":
        phases = [e["phase"] for e in pev if e["phase"] != "eval"]
        assert phases[:2] == ["breach", "recover"]
        assert phases == ["breach", "recover"] * (len(phases) // 2)
        assert {e["dominant"] for e in pev if e["phase"] == "breach"} == \
            {"queue_wait"}


class _StubBatcher:
    """A batcher-shaped carrier of one LatencyStats for the registry's
    fold paths."""

    def __init__(self, stats_cls):
        import queue

        self.stats = stats_cls()
        self._q = queue.Queue()


def test_registry_stream_events_equal_jax(monkeypatch):
    """Latency and availability SLOs read from each package's own
    registry (the latency histogram, the request counter and the cause
    split of the shed counter) fed the same requests: the same events."""
    monkeypatch.setattr(pmetrics, "tail_exemplars", lambda limit=10: [])
    monkeypatch.setattr(jmetrics, "tail_exemplars", lambda limit=10: [])
    rng = np.random.default_rng(7)
    ticks = []
    for i in range(24):
        slow = 8 <= i < 10
        lats = rng.uniform(200.0, 4000.0, size=64)
        if slow:
            lats = lats + 30_000.0
        ticks.append((lats.tolist(), int(rng.integers(0, 2)) if i % 5
                      else 0, int(i == 9)))
    out = []
    for mod, tm, stats_cls, log_cls, set_log in (
            (pslo, pmetrics, LatencyStats, EventLog, set_event_log),
            (jslo, jmetrics, JaxLatencyStats, JaxEventLog,
             jax_set_event_log)):
        stub = _StubBatcher(stats_cls)
        tm.track_batcher(stub)
        clock = _FakeClock()
        slos = mod.parse_slos("p99_ms=10,availability=99.9",
                              fast_window_s=2.0, slow_window_s=6.0)
        log = log_cls()
        prev = set_log(log)
        mon = mod.SLOMonitor(slos, clock=clock, flight=False)
        try:
            mon.tick()
            for lats, rejects, misses in ticks:
                for v in lats:
                    stub.stats.record(v)
                for _ in range(rejects):
                    stub.stats.record_reject(cause="queue_full")
                for _ in range(misses):
                    stub.stats.record_deadline_miss()
                clock.t += 1.0
                mon.tick()
        finally:
            mon.stop()
            set_log(prev)
            tm.retire_batcher(stub)
        out.append([{k: v for k, v in e.items() if k != "ts"}
                    for e in log.events("slo")])
    assert out[0] == out[1]
    breaches = [e["slo"] for e in out[0] if e["phase"] == "breach"]
    assert "p99_ms" in breaches


# ------------------------------------------------- health, gauges, flight

def _monitor(flight=False, flight_dir=None, **kw):
    stream, clock = _Stream(), _FakeClock()
    slo = pslo.SLO("s", "availability", objective=0.99, fast_window_s=2.0,
                   slow_window_s=10.0, probe=stream, **kw)
    mon = pslo.SLOMonitor([slo], clock=clock, flight=flight,
                          flight_dir=flight_dir)
    return mon, stream, clock


def _step(mon, stream, clock, n, bad=0):
    stream.feed(n, bad)
    clock.t += 1.0
    return mon.tick()


def test_healthz_degrades_over_http_and_restores():
    srv = pexporter.MetricsServer(port=0).start()
    mon, stream, clock = _monitor()

    def healthz():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
            return json.loads(r.read().decode())

    try:
        _step(mon, stream, clock, 100)
        assert healthz() == {"status": "ok", "reason": ""}
        _step(mon, stream, clock, 100, bad=100)
        assert healthz() == {"status": "degraded", "reason": "slo:s"}
        assert pexporter.health() == healthz()
        for _ in range(12):
            _step(mon, stream, clock, 100)
        assert healthz()["status"] == "ok"
        _step(mon, stream, clock, 100, bad=100)
        assert healthz()["status"] == "degraded"
    finally:
        mon.stop()
        srv.stop()
    assert pexporter.health()["status"] == "ok"  # stop() restores


def test_gauge_rows_appear_and_vanish_with_the_monitor():
    mon, stream, clock = _monitor()
    try:
        _step(mon, stream, clock, 100)
        assert pslo.gauge_rows("budget_pct")["s"] == 100.0
        text = pmetrics.REGISTRY.render()
        assert 'dlrm_slo_error_budget_pct{slo="s"} 100' in text
        assert 'dlrm_slo_burn_rate{slo="s"}' in text
        _step(mon, stream, clock, 1000, bad=5)
        # 5 bad in the 1000 since the first sample: half the 1% budget
        assert pmetrics.SLO_ERROR_BUDGET.sample()["s"] == \
            pytest.approx(50.0)
    finally:
        mon.stop()
    assert "s" not in pslo.gauge_rows("budget_pct")
    assert "dlrm_slo_burn_rate{" not in pmetrics.REGISTRY.render()


def test_one_flight_record_a_breach_renders_as_in_jax(tmp_path):
    """A breach under an active event log writes one flight record into
    the monitor's flight_dir and names it on the breach event; both
    packages find, load and render it alike."""
    fdir = str(tmp_path / "flight")
    mon, stream, clock = _monitor(flight=True, flight_dir=fdir)
    log = EventLog()
    prev = set_event_log(log)
    try:
        _step(mon, stream, clock, 100)
        evs = _step(mon, stream, clock, 100, bad=100)
        _step(mon, stream, clock, 100, bad=100)  # still breached: no dump
    finally:
        mon.stop()
        set_event_log(prev)
    from dlrm_flexflow_tpu.telemetry import fleet as jfleet
    recs = pfleet.find_flight_records(fdir)
    assert len(recs) == 1 and recs == jfleet.find_flight_records(fdir)
    breach = [e for e in evs if e["phase"] == "breach"]
    assert breach[0]["flight"] == recs[0] == mon.flight_paths[0]
    doc = pfleet.load_flight_record(recs[0])
    assert doc == jfleet.load_flight_record(recs[0])
    assert pfleet.render_flight(doc) == jax_render(doc)
    assert any(e["type"] == "slo" for e in doc["events"])


def test_freshness_reads_the_strategy_age_gauge():
    clock = _FakeClock()
    slo, = pslo.parse_slos("freshness=600", fast_window_s=2.0,
                           slow_window_s=10.0)
    mon = pslo.SLOMonitor([slo], clock=clock, flight=False)
    try:
        clock.t += 1.0
        mon.tick()
        assert mon._state["freshness"].samples == []  # gauge unset
        import time
        pmetrics.note_strategy_promotion(3, ts=time.time() - 30.0)
        for _ in range(3):
            clock.t += 1.0
            mon.tick()
        assert mon._state["freshness"].samples[-1][1:] == (3.0, 0.0)
        pmetrics.note_strategy_promotion(4, ts=time.time() - 3600.0)
        clock.t += 1.0
        evs = mon.tick()
        assert [e["phase"] for e in evs] == ["eval", "breach"]
    finally:
        mon.stop()


def test_schema_and_regress_direction():
    assert set(SCHEMA["slo"]["phases"]) == {"eval", "breach", "recover"}
    assert lower_is_better("dlrm_slo_burn_rate") is True
    assert lower_is_better("dlrm_slo_error_budget_pct") is False


def test_threaded_monitor_stops_and_restores_health():
    mon, stream, clock = _monitor()
    mon.interval_s = 0.01
    mon.start()
    assert mon.start() is mon  # idempotent
    mon.stop()
    assert mon._thread is None
    assert pexporter.health()["status"] == "ok"


# --------------------------------------------------------- serving, e2e

def test_fused_engine_under_a_monitor_breaches_on_a_delay(tmp_path):
    """The port's fused engine through the batcher, a latency SLO read
    from the registry: a delayed stretch breaches it with one flight
    record, healthy ticks recover it (CPU, the kernel's plain version)."""

    class Delayed(InferenceEngine):
        delay_s = 0.0

        def predict(self, inputs, queue_wait_us=0.0, timings=None):
            if self.delay_s:
                import time
                time.sleep(self.delay_s)
            return super().predict(inputs, queue_wait_us, timings)

    cfg = DLRMConfig(sparse_feature_size=8, embedding_size=[64, 48],
                     embedding_bag_size=2, mlp_bot=[4, 8, 8],
                     mlp_top=[24, 8, 1], fused_interaction="on")
    m = build_dlrm(cfg, fft.FFConfig(batch_size=8)).compile()
    engine = Delayed(m, m.init(seed=0, device="cpu"), buckets=[1, 8],
                     device="cpu")
    rng = np.random.default_rng(0)
    reqs = [{"dense": rng.standard_normal((1, 4)).astype(np.float32),
             "sparse": rng.integers(0, 48, size=(1, 2, 2))}
            for _ in range(8)]
    clock = _FakeClock()
    slos = pslo.parse_slos("p99_ms=100,availability=99.9",
                           fast_window_s=2.0, slow_window_s=4.0)
    mon = pslo.SLOMonitor(slos, clock=clock,
                          flight_dir=str(tmp_path / "flight"))
    batcher = DynamicBatcher(engine)
    log = EventLog()
    prev = set_event_log(log)
    try:
        def tick():
            for f in [batcher.submit(r) for r in reqs]:
                f.result(timeout=60)
            clock.t += 1.0
            return [e["phase"] for e in mon.tick()]

        mon.tick()
        assert tick() == ["eval", "eval"]
        engine.delay_s = 0.15
        assert tick() == ["eval", "eval", "breach"]  # breaches last
        engine.delay_s = 0.0
        phases = []
        for _ in range(8):
            phases += tick()
        assert phases.count("recover") == 1
    finally:
        batcher.close()
        mon.stop()
        set_event_log(prev)
    assert len(pfleet.find_flight_records(str(tmp_path / "flight"))) == 1
    assert pexporter.health()["status"] == "ok"
    assert all(validate_event(e) == [] for e in log.events())
