"""The port's telemetry core (dlrm_flexflow_tpu_torch/telemetry) against the
JAX package's on the CPU: the schema, the events and spans of a small
``fit`` and of a serving run, the metric families, the exporter, the
row-frequency counter, and the compile events of the CUDA-graph
captures.

The comparisons are structural and exact: the same event types, the same
field names per type and phase, the same span names and parents, every
port event valid under the JAX package's ``validate_event``.  Values
(walls, bytes) are the run's own.  The metrics registry is process-wide
in both packages, so every test that reads it starts from
``metrics.reset()`` and tracks its own objects: the file passes in any
order and beside any other file on an xdist worker.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import telemetry as jt
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.data.loader import ArrayDataLoader as JaxLoader
from dlrm_flexflow_tpu.serving import DynamicBatcher as JaxBatcher
from dlrm_flexflow_tpu.serving import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.telemetry import exporter as jexporter
from dlrm_flexflow_tpu.telemetry import metrics as jmetrics
from dlrm_flexflow_tpu.telemetry import rowfreq as jrowfreq
from dlrm_flexflow_tpu.telemetry import schema as jschema

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import telemetry as pt
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import params_from_jax
from dlrm_flexflow_tpu_torch.serving import DynamicBatcher, InferenceEngine
from dlrm_flexflow_tpu_torch.telemetry import exporter as pexporter
from dlrm_flexflow_tpu_torch.telemetry import metrics as pmetrics
from dlrm_flexflow_tpu_torch.telemetry import report as preport
from dlrm_flexflow_tpu_torch.telemetry import rowfreq as prowfreq
from dlrm_flexflow_tpu_torch.telemetry import schema as pschema

D = 8
TABLES = [20, 30, 40]


@pytest.fixture(autouse=True)
def _fresh_registry():
    pmetrics.reset()
    prowfreq.reset()
    yield
    pmetrics.reset()
    prowfreq.reset()


def test_schema_equals_jax():
    assert pschema.SCHEMA == jschema.SCHEMA
    assert pschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert pschema.COMMON_REQUIRED == jschema.COMMON_REQUIRED
    assert pschema.COMMON_OPTIONAL == jschema.COMMON_OPTIONAL


def _cfg(cls):
    return cls(sparse_feature_size=D, embedding_size=TABLES,
               mlp_bot=[13, 16, D], mlp_top=[D + len(TABLES) * D, 16, 1],
               arch_interaction_op="cat", fused_interaction="on")


def _data(n=64):
    rng = np.random.default_rng(0)
    inputs = {"dense": rng.standard_normal((n, 13)).astype(np.float32),
              "sparse": np.stack([rng.integers(0, r, (n, 1)) for r in TABLES],
                                 1).astype(np.int64)}
    return inputs, rng.integers(0, 2, (n, 1)).astype(np.float32)


def _pair():
    jm = jax_build_dlrm(_cfg(JaxDLRMConfig),
                        JaxFFConfig(batch_size=16, serve_buckets="1,8"))
    jm.compile(optimizer=ffj.SGDOptimizer(0.01), metrics=("accuracy",),
               mesh=False)
    js = jm.init(seed=0)
    np_params = jax.tree.map(np.asarray, js.params)
    pm = build_dlrm(_cfg(DLRMConfig),
                    fft.FFConfig(batch_size=16, serve_buckets="1,8"))
    pm.compile(optimizer=fft.SGDOptimizer(0.01), metrics=("accuracy",))
    ps = pm.load_params(params_from_jax(np_params), device="cpu")
    return jm, js, pm, ps


def _shape(events):
    """{(type, phase/kind/name): field names} and the (span, parent span)
    name pairs of a run's events."""
    fields = {}
    for e in events:
        key = (e["type"], e.get("phase") or e.get("kind") or e.get("name"))
        fields.setdefault(key, set()).update(e)
    names = {e["span_id"]: e["name"] for e in events if e["type"] == "span"}
    spans = {(e["name"], names.get(e.get("parent_id")))
             for e in events if e["type"] == "span"}
    return fields, spans


def _without_compiles(fields):
    # the JAX package observes XLA's compiles through jax.monitoring
    # (kind="backend_compile"); the port's compile events are its
    # CUDA-graph captures (kind="aot"), checked on their own below.
    # predicted_sync_ms is the JAX package's cost-model prediction
    # (telemetry/fleet.py over sim/), which the port has no model for yet
    return {k: v - {"predicted_sync_ms"} for k, v in fields.items()
            if k[0] != "compile"}


@pytest.mark.parametrize("shuffle", [False, True])  # staged / per batch
def test_fit_events_match_jax(shuffle):
    jm, js, pm, ps = _pair()
    inputs, labels = _data()
    with jt.event_log() as jlog:
        jm.fit(js, JaxLoader(inputs, labels, 16, shuffle=shuffle), epochs=2,
               verbose=False)
    with pt.event_log() as plog:
        pm.fit(ps, fft.ArrayDataLoader(inputs, labels, 16, shuffle=shuffle),
               epochs=2, verbose=False)
    assert pm._last_fit_used_scan is not shuffle
    events = plog.events()
    for e in events:
        assert jschema.validate_event(e) == [], e
    jfields, jspans = _shape(jlog.events())
    pfields, pspans = _shape(events)
    assert _without_compiles(pfields) == _without_compiles(jfields)
    assert pspans == jspans
    assert ("train.fit", None) in pspans
    # the step's capture is the port's compile event, with JAX's aot fields
    captures = [e for e in events if e["type"] == "compile"]
    assert len(captures) == pm.graph_captures == 1
    assert captures[0]["kind"] == "aot" and captures[0]["fn"] == "train_step"
    assert set(captures[0]) <= set(jschema.SCHEMA["compile"]["required"]) \
        | set(jschema.SCHEMA["compile"]["optional"]) | {"type", "ts"}
    fit = [e for e in events if e["type"] == "step"][-1]
    assert fit["phase"] == "fit" and fit["fenced"] is True
    assert fit["samples"] == 2 * 64 and fit["epochs"] == 2


def test_train_epoch_events_match_jax():
    jm, js, pm, ps = _pair()
    inputs, labels = _data()
    stacked = ({k: v.reshape((4, 16) + v.shape[1:])
                for k, v in inputs.items()}, labels.reshape(4, 16, 1))
    with jt.event_log() as jlog:
        js, _ = jm.train_epoch(js, *stacked)
        jm.train_epochs(js, *stacked, 2)
    with pt.event_log() as plog:
        ps, _ = pm.train_epoch(ps, *stacked)
        pm.train_epochs(ps, *stacked, 2)
    jfields, _ = _shape(jlog.events())
    pfields, _ = _shape(plog.events())
    assert _without_compiles(pfields) == _without_compiles(jfields)
    steps = [e for e in plog.events() if e["type"] == "step"]
    assert [e["phase"] for e in steps] == ["train_epoch", "train_epochs"]
    assert steps[1]["samples"] == 2 * 64 and steps[1]["fenced"] is False


def test_serving_events_match_jax():
    jm, js, pm, ps = _pair()
    inputs, _ = _data(6)
    reqs = [{k: v[i:i + 1] for k, v in inputs.items()} for i in range(6)]
    with jt.event_log() as jlog:
        eng = JaxEngine(jm, js)
        with JaxBatcher(eng, max_wait_us=0.0) as b:
            for f in [b.submit(r) for r in reqs]:
                f.result(60)
        b.close()
    with pt.event_log() as plog:
        eng = InferenceEngine(pm, ps, device="cpu")
        with DynamicBatcher(eng, max_wait_us=0.0) as b:
            for f in [b.submit(r) for r in reqs]:
                f.result(60)
        b.close()
        with pytest.raises(Exception, match="shut down"):
            b.submit(reqs[0])
    events = plog.events()
    for e in events:
        assert jschema.validate_event(e) == [], e
    jfields, jspans = _shape(jlog.events())
    pfields, pspans = _shape(events)
    for key in (("serve", "dispatch"), ("serve", "summary"),
                ("serve", "tail")):
        assert pfields[key] == jfields[key], key
    assert ("serve", "reject") in pfields
    assert pspans >= jspans
    assert {("serve.pad", "serve.dispatch"),
            ("serve.engine_forward", "serve.dispatch"),
            ("serve.queue_wait", "serve.request"),
            ("serve.forward", "serve.request")} <= pspans
    # one compile event per bucket capture, named as the JAX engine names
    # its AOT bucket programs
    compiles = [e for e in events if e["type"] == "compile"]
    assert sorted(e["fn"] for e in compiles) == ["serve[bucket=1]",
                                                 "serve[bucket=8]"]
    assert {e["kind"] for e in compiles} == {"aot"}
    summary, = [e for e in events
                if e["type"] == "serve" and e["phase"] == "summary"]
    assert summary["requests"] == 6 and summary["dispatches"] >= 1


def test_metric_families_match_jax():
    names = pmetrics.REGISTRY.names()
    for name in names:
        assert pmetrics.FAMILIES[name] == jmetrics.FAMILIES[name], name
    assert names == [n for n in jmetrics.REGISTRY.names() if n in names]
    text = pmetrics.REGISTRY.render()
    for name in names:
        assert f"# TYPE {name} {pmetrics.FAMILIES[name][0]}" in text
    # the engine, batcher and train families are all there
    for fam in ("dlrm_serve_dispatches_total", "dlrm_serve_latency_us",
                "dlrm_serve_queue_depth", "dlrm_serve_shed_total",
                "dlrm_train_steps_total", "dlrm_train_samples_per_s"):
        assert fam in names


def test_served_and_trained_counts_reach_metrics():
    jm, js, pm, ps = _pair()
    inputs, labels = _data()
    pm.fit(ps, fft.ArrayDataLoader(inputs, labels, 16), epochs=1,
           verbose=False)
    eng = InferenceEngine(pm, ps, device="cpu")
    with DynamicBatcher(eng, max_wait_us=0.0) as b:
        for f in [b.submit({k: v[i:i + 1] for k, v in inputs.items()})
                  for i in range(5)]:
            f.result(60)
    text = pmetrics.REGISTRY.render()
    assert "dlrm_serve_requests_total 5" in text
    assert "dlrm_train_steps_total 4" in text
    assert 'dlrm_serve_dispatches_total{bucket="1"}' in text \
        or 'dlrm_serve_dispatches_total{bucket="8"}' in text
    assert pmetrics.TRAIN_SAMPLES_PER_S.value > 0


def test_exporter_serves_metrics_and_healthz():
    with pexporter.MetricsServer(port=0, host="127.0.0.1") as srv:
        assert srv.port > 0
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            body = r.read().decode()
            assert r.status == 200
        assert "# TYPE dlrm_serve_requests_total counter" in body
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)


def test_chrome_trace_of_a_run(tmp_path):
    jm, js, pm, ps = _pair()
    inputs, labels = _data()
    sink = tmp_path / "run.jsonl"
    with pt.event_log(path=str(sink)):
        pm.fit(ps, fft.ArrayDataLoader(inputs, labels, 16, shuffle=True),
               epochs=1, verbose=False)
    out = tmp_path / "trace.json"
    counts = pexporter.export_trace(str(sink), str(out))
    doc = json.loads(out.read_text())
    assert counts["spans"] == 6 and counts["events"] > counts["spans"]
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"train.fit", "train.epoch", "train.dispatch"} <= names
    assert doc == jexporter.chrome_trace(preport.load_events(str(sink)))


def test_rowfreq_top_k_matches_jax():
    rng = np.random.default_rng(5)
    ids = [rng.zipf(1.3, size=(64, 3)) % 500 for _ in range(6)]
    jc, pc = jrowfreq.RowFreqCounter("t", capacity=40), \
        prowfreq.RowFreqCounter("t", capacity=40)
    for batch in ids:
        jc.observe(batch)
        pc.observe(torch.from_numpy(batch))
    assert pc.top(10) == jc.top(10)
    assert pc.bucket_counts() == jc.bucket_counts()
    assert (pc.evicted, pc.rows_seen) == (jc.evicted, jc.rows_seen)
    with pt.event_log() as log:
        ev = pc.emit()
    assert jschema.validate_event(ev) == [] and log.last("row_freq") == ev
    prowfreq.counter("x").observe(np.arange(4))
    assert prowfreq.hot_rows("x", 2) == [(0, 1), (1, 1)]
    assert prowfreq.hot_rows("unseen", 2) == []


def test_memory_events_and_compile_stats_on_the_cpu():
    with pt.event_log() as log:
        assert pt.sample_memory(phase="probe") == 1
        pt.record_compile("nvcc", 0.5, fn="csrc/x.cu", backend="cuda")
    mem, comp = log.events("memory")[0], log.events("compile")[0]
    assert mem["device"] == "all" and mem["bytes_in_use"] > 0
    assert comp["kind"] == "nvcc" and comp["fn"] == "csrc/x.cu"
    for e in (mem, comp):
        assert jschema.validate_event(e) == []
    stats = pt.compile_stats()
    assert stats["nvcc"] >= 1 and stats["nvcc_s"] >= 0.5
    assert pt.sample_memory() == 0  # telemetry off: nothing


def test_telemetry_off_emits_nothing_and_costs_no_span():
    assert pt.active_log() is None
    assert pt.start_span("x") is pt.NULL_SPAN
    assert pt.emit("step", wall_s=1.0, samples=1) is None
    with pt.event_log() as log:
        with pt.suppressed():
            assert pt.emit("step", wall_s=1.0, samples=1) is None
        assert pt.emit("step", wall_s=1.0, samples=1) is not None
    assert len(log.events()) == 1


def test_metrics_port_starts_the_endpoint_at_compile(monkeypatch):
    started = []
    monkeypatch.setattr(pexporter, "start_metrics_server",
                        lambda port: started.append(port))
    pm = build_dlrm(_cfg(DLRMConfig), fft.FFConfig(batch_size=16,
                                                   metrics_port=9177))
    pm.compile()
    assert started == [9177]
    build_dlrm(_cfg(DLRMConfig), fft.FFConfig(batch_size=16)).compile()
    assert started == [9177]
