"""The port's report and regress CLIs (``dlrm_flexflow_tpu_torch/telemetry/
{report,regress,__main__}.py``) against the JAX package's on the CPU.

One JSONL holds every event type of the schema: the port's own producers
write most of it (a per-batch ``fit``, ``sample_memory``, ``OpTimer``,
``mcmc_search`` and a simulator calibration, the closed tuning loop, an
engine and batcher, an SLO monitor, a checkpoint manager) and doctored
events, drawn from a numpy seed, add the types whose producers need more
than one process or a tiered store.  Both packages' ``format_report``
print it byte for byte alike and their ``report_data`` are equal, also
through ``main`` in one working directory with ffcheck sinks beside it
(the analysis-artifact lookup).  ``regress``: ``load_metrics`` and
``compare`` equal on every bench file in the repo, H100 entries (a
``device`` field) keyed apart from TPU ones.  The CLIs run as
subprocesses.  JAX is imported here only.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from dlrm_flexflow_tpu.telemetry import regress as jregress
from dlrm_flexflow_tpu.telemetry import report as jreport
from dlrm_flexflow_tpu.telemetry import rowfreq as jrowfreq

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader
from dlrm_flexflow_tpu_torch.profiling import OpTimer
from dlrm_flexflow_tpu_torch.resilience import CheckpointManager
from dlrm_flexflow_tpu_torch.serving import DynamicBatcher, InferenceEngine
from dlrm_flexflow_tpu_torch.sim import tune as ptune
from dlrm_flexflow_tpu_torch.sim.search import (data_parallel_strategy,
                                                mcmc_search)
from dlrm_flexflow_tpu_torch.sim.simulator import Simulator
from dlrm_flexflow_tpu_torch.telemetry import event_log, sample_memory
from dlrm_flexflow_tpu_torch.telemetry import metrics as pmetrics
from dlrm_flexflow_tpu_torch.telemetry import regress as pregress
from dlrm_flexflow_tpu_torch.telemetry import report as preport
from dlrm_flexflow_tpu_torch.telemetry import rowfreq as prowfreq
from dlrm_flexflow_tpu_torch.telemetry import slo as pslo
from dlrm_flexflow_tpu_torch.telemetry.schema import SCHEMA, validate_event

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_FILES = ["bench_history.json"] + [f"BENCH_r0{i}.json"
                                        for i in range(1, 6)]


@pytest.fixture(autouse=True)
def _fresh_registry():
    pmetrics.reset()
    prowfreq.reset()
    yield
    pmetrics.reset()
    prowfreq.reset()


def _doctored(rng):
    """Schema-valid events of the types whose producers the run below
    does not reach on one CPU process, values from ``rng``."""
    u = lambda lo, hi: float(rng.uniform(lo, hi))  # noqa: E731
    i = lambda lo, hi: int(rng.integers(lo, hi))  # noqa: E731
    return [
        {"type": "compile", "kind": "backend_compile",
         "duration_s": u(0.1, 2), "fn": "train_step"},
        {"type": "compile", "kind": "aot", "duration_s": u(0.1, 2),
         "donated_args": 3},
        {"type": "anomaly", "kind": "nan_loss", "step": i(1, 9),
         "action": "rollback", "rollbacks": 1, "policy": "skip"},
        {"type": "fault", "kind": "nan_grads", "point": "step",
         "step": i(1, 9)},
        {"type": "storage", "phase": "miss", "table": "emb",
         "misses": i(1, 99), "stall_us": u(10, 900)},
        {"type": "storage", "phase": "admit", "table": "emb",
         "admitted": i(1, 99), "policy": "lfu"},
        {"type": "elastic", "phase": "scale", "replicas_from": 2,
         "replicas_to": 4, "drained": 3},
        {"type": "recovery", "phase": "eject", "replica": "r1",
         "reason": "dead dispatcher"},
        {"type": "distributed", "phase": "init", "process_index": 0,
         "process_count": 1, "global_devices": 1, "local_devices": 1},
        {"type": "serve", "phase": "reject", "reason": "queue_full"},
        {"type": "serve", "phase": "tail", "bucket": 8,
         "lat_us": u(1e3, 9e3), "trace_id": "t0", "dominant": "pad",
         "queue_wait_us": u(0, 90), "pad_us": u(500, 900),
         "compute_us": u(0, 90), "stall_us": 0.0},
        {"type": "phase_time", "step": 16, "step_wall_ms": u(5, 50),
         "phase": "fit", "steps": 16, "exposed_comm_pct": u(1, 30),
         "predicted_sync_ms": u(0.1, 2), "sync_wait_ms": u(0.1, 2)},
    ]


def _tiny():
    cfg = DLRMConfig(sparse_feature_size=8, embedding_size=[64, 48],
                     embedding_bag_size=2, mlp_bot=[4, 8, 8],
                     mlp_top=[24, 8, 1])
    m = build_dlrm(cfg, fft.FFConfig(batch_size=8)).compile(
        optimizer=fft.SGDOptimizer(lr=0.05),
        loss_type="mean_squared_error", metrics=("mean_squared_error",))
    return m, m.init(seed=0, device="cpu")


@pytest.fixture(scope="module")
def run_jsonl(tmp_path_factory):
    """The run's JSONL (every schema type) and its events."""
    d = tmp_path_factory.mktemp("run")
    path = str(d / "run.jsonl")
    rng = np.random.default_rng(14)
    m, state = _tiny()
    n = 32
    inputs = {"dense": rng.standard_normal((n, 4)).astype(np.float32),
              "sparse": rng.integers(0, 48, size=(n, 2, 2))}
    labels = rng.standard_normal((n, 1)).astype(np.float32)
    m.config.fit_scan_max_bytes = 0  # the per-batch loop
    prowfreq.reset()
    with event_log(path=path, mode="w") as log:
        state, _ = m.fit(state, ArrayDataLoader(inputs, labels, 8),
                         epochs=2, verbose=False)
        sample_memory(phase="after_fit")
        OpTimer(m, iters=2).profile(state, None)
        ops = str(d / "ops.jsonl")
        with open(ops, "w") as f:
            for e in log.events("op_time"):
                f.write(json.dumps(e) + "\n")
        best = mcmc_search(m, 4, budget=12, seed=0, backend="python",
                           measure=False)
        Simulator(m, 1).calibrate(data_parallel_strategy(m, 1), 2e-3)
        art = str(d / "art")
        ptune.search_tune(m, 4, ops, art, budget=8)
        ptune.search_tune(m, 4, ops, art, budget=8,
                          bench_fn=lambda doc: 1e-3 * doc["version"])
        engine = InferenceEngine(m, state, buckets=[1, 8], device="cpu")
        batcher = DynamicBatcher(engine)
        reqs = [{k: v[i:i + 1 + i % 3] for k, v in inputs.items()}
                for i in range(12)]
        for f in [batcher.submit(r) for r in reqs]:
            f.result(timeout=60)
        batcher.close()
        stream = {"t": 0.0, "n": 0.0, "bad": 0.0}
        slo = pslo.SLO("availability", "availability", 0.99,
                       fast_window_s=2.0, slow_window_s=4.0,
                       probe=lambda: (stream["n"], stream["bad"]))
        mon = pslo.SLOMonitor([slo], clock=lambda: stream["t"],
                              flight=False)
        try:
            for bad in (0, 0, 50, 0, 0, 0, 0, 0):
                stream["n"] += 100
                stream["bad"] += bad
                stream["t"] += 1.0
                mon.tick()
        finally:
            mon.stop()
        CheckpointManager(str(d / "ckpt"), keep_n=1).save(state, m)
        for e in _doctored(rng):
            log.emit(e.pop("type"), **e)
        del best
    return path, preport.load_events(path, strict=True)


def test_the_run_holds_every_schema_type(run_jsonl):
    _, events = run_jsonl
    assert {e["type"] for e in events} == set(SCHEMA)
    assert all(validate_event(e) == [] for e in events)
    assert preport.load_events(run_jsonl[0]) == \
        jreport.load_events(run_jsonl[0])


def test_text_is_byte_equal_and_json_equal(run_jsonl):
    _, events = run_jsonl
    text = preport.format_report(events)
    assert text == jreport.format_report(events)
    data = preport.report_data(events)
    assert data == jreport.report_data(events)
    for name in ("throughput", "phases", "per_op", "calibration",
                 "compile", "memory", "row_freq", "search", "tuning",
                 "resilience", "serving", "tail", "slo", "spans",
                 "distributed"):
        assert name in data, name
    heads = [ln for ln in text.splitlines() if ln.startswith("== ")]
    assert len(heads) == len(data)  # the run summary is "run" in JSON


@pytest.mark.parametrize("section", [n for n, _ in preport.SECTIONS])
def test_each_section_renders_as_in_jax(run_jsonl, section):
    _, events = run_jsonl
    pfn = dict(preport.SECTIONS)[section]
    jfn = dict(jreport.SECTIONS)[section]
    assert pfn(events) == jfn(events)


def _analysis_sink(path, findings, changed_only=False):
    doc = {"tool": "ffcheck", "passes": ["locks", "purity"],
           "modules": 12, "changed_only": changed_only,
           "summary": {"ok": not findings, "findings": findings,
                       "waived": 1, "unused_waivers": 0},
           "findings": [{"path": "a.py", "line": i, "pass": "locks",
                         "code": "L1", "message": "m"}
                        for i in range(findings)],
           "waived": [{"pass": "purity"}], "unused_waivers": []}
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("with_analysis", [False, True])
def test_main_prints_alike_in_one_directory(run_jsonl, tmp_path,
                                            monkeypatch, capsys, fmt,
                                            with_analysis):
    """Both packages' ``report`` main, run in one temp working directory
    so the analysis-artifact lookup sees the same files: the same
    bytes."""
    path = shutil.copy(run_jsonl[0], tmp_path / "run.jsonl")
    monkeypatch.chdir(tmp_path)
    if with_analysis:
        os.makedirs("artifacts")
        _analysis_sink("artifacts/analysis_1.json", 3)
        os.utime("artifacts/analysis_1.json", (1, 1))
        _analysis_sink("artifacts/analysis_2.json", 1)
    argv = ["report", str(path)] + (["--format", "json"]
                                     if fmt == "json" else [])
    assert preport.main(argv) == 0
    pout = capsys.readouterr().out
    assert jreport.main(argv) == 0
    assert pout == capsys.readouterr().out
    assert ("== analysis ==" in pout or '"analysis"' in pout) == \
        with_analysis


@pytest.mark.parametrize("events", [
    [],
    [{"type": "step", "ts": 1.0, "wall_s": 1.0, "samples": 8}],
    [{"type": "op_time", "ts": 1.0, "op": "small_err", "forward_s": 1e-3,
      "backward_s": 2e-3, "sim_forward_s": 1.1e-3},
     {"type": "op_time", "ts": 2.0, "op": "big_err", "forward_s": 1e-4,
      "backward_s": 2e-4, "sim_forward_s": 5e-4},
     {"type": "op_time", "ts": 3.0, "op": "no_sim", "forward_s": 9e-3,
      "backward_s": 1e-3}],
    [{"type": "search", "ts": 1.0, "phase": "promote", "verdict": "first",
      "version": 1, "candidate_s": 1e-3, "app": "dlrm", "num_devices": 8},
     {"type": "search", "ts": 2.0, "phase": "promote", "verdict": "first",
      "version": 2, "candidate_s": 1e-3, "app": "dlrm", "num_devices": 4},
     {"type": "search", "ts": 3.0, "phase": "promote",
      "verdict": "promoted", "version": 3, "incumbent_version": 2,
      "candidate_s": 0.9e-3, "incumbent_s": 1e-3, "app": "dlrm",
      "num_devices": 4}],
], ids=["empty", "step-only", "per-op-ranked", "lineage-per-topology"])
def test_small_runs_render_as_in_jax(events):
    assert preport.format_report(events) == jreport.format_report(events)
    assert preport.report_data(events) == jreport.report_data(events)


def test_per_op_ranks_worst_error_first():
    evs = [{"type": "op_time", "ts": 1.0, "op": "small_err",
            "forward_s": 1e-3, "sim_forward_s": 1.1e-3},
           {"type": "op_time", "ts": 2.0, "op": "big_err",
            "forward_s": 1e-4, "sim_forward_s": 5e-4},
           {"type": "op_time", "ts": 3.0, "op": "no_sim",
            "forward_s": 9e-3}]
    lines = preport.per_op_table(evs)
    assert [ln.split()[0] for ln in lines[2:]] == ["big_err", "small_err",
                                                   "no_sim"]
    ops = preport.report_data(evs)["per_op"]["ops"]
    assert ops[0]["err_pct"] == pytest.approx(400.0)


def test_row_freq_summary_equals_jax(run_jsonl):
    _, events = run_jsonl
    lines = prowfreq.row_freq_summary(events)
    assert lines and lines == jrowfreq.row_freq_summary(events)


# ------------------------------------------------------------------ regress

@pytest.mark.parametrize("name", BENCH_FILES)
def test_load_metrics_equals_jax_on_every_bench_file(name):
    path = os.path.join(REPO, name)
    got = pregress.load_metrics(path)
    assert got and got == jregress.load_metrics(path)


@pytest.mark.parametrize("base,new", [
    ("bench_history.json", "BENCH_r05.json"),
    ("BENCH_r01.json", "BENCH_r05.json"),
    ("BENCH_r05.json", "BENCH_r01.json"),
    ("bench_history.json", "bench_history.json"),
])
@pytest.mark.parametrize("tol", [5.0, 50.0])
def test_compare_and_main_equal_jax(base, new, tol, capsys):
    b, n = (os.path.join(REPO, x) for x in (base, new))
    pb, pn = pregress.load_metrics(b), pregress.load_metrics(n)
    assert pregress.compare(pb, pn, tol) == jregress.compare(
        jregress.load_metrics(b), jregress.load_metrics(n), tol)
    argv = ["--baseline", b, "--new", n, "--tolerance", str(tol)]
    prc = pregress.main(argv)
    pout = capsys.readouterr().out
    assert prc == jregress.main(argv)
    assert pout == capsys.readouterr().out


def test_h100_entries_never_anchor_tpu_ones(tmp_path):
    """A device-stamped entry keys ``<metric>:device=<name>`` (after the
    JAX qualifiers); an entry without one keeps the JAX key; a TPU-only
    baseline and an H100-only result share no metric."""
    card = "NVIDIA H100 80GB HBM3"
    tpu = {"metric": "dlrm_serving_p99_ms", "value": 4.0, "fenced": True,
           "quantize": "int8", "bucket": 8}
    gpu = dict(tpu, value=9.0, device=card)
    hist = tmp_path / "h.json"
    hist.write_text(json.dumps([tpu, gpu]))
    got = pregress.load_metrics(str(hist))
    key = "dlrm_serving_p99_ms:quantize=int8:bucket=8"
    assert got == {key: 4.0, f"{key}:device={card}": 9.0}
    assert jregress.load_metrics(str(hist)) == {key: 9.0}  # JAX: one key
    only_tpu = tmp_path / "t.json"
    only_tpu.write_text(json.dumps([tpu]))
    only_gpu = tmp_path / "g.json"
    only_gpu.write_text(json.dumps({"metric": "dlrm_serving_p99_ms",
                                    "value": 99.0, "device": card}))
    assert pregress.load_metrics(str(only_gpu)) == {
        f"dlrm_serving_p99_ms:device={card}": 99.0}
    rows, regressions = pregress.compare(
        pregress.load_metrics(str(only_tpu)),
        pregress.load_metrics(str(only_gpu)), 5.0)
    assert rows == regressions == []
    assert pregress.main(["--baseline", str(only_tpu), "--new",
                          str(only_gpu)]) == 2


def test_a_slower_h100_result_regresses_against_its_own_anchor(tmp_path):
    card = "NVIDIA H100 80GB HBM3"
    base = [{"metric": "dlrm_tune_step_ms", "value": 1.0, "fenced": True,
             "device": card},
            {"metric": "dlrm_synthetic_samples_per_sec", "value": 1000.0,
             "fenced": True, "device": card}]
    slow = [dict(base[0], value=1.2), dict(base[1], value=1000.0 / 1.2)]
    for name, doc in (("b.json", base), ("s.json", slow)):
        (tmp_path / name).write_text(json.dumps(doc))
    b, s = str(tmp_path / "b.json"), str(tmp_path / "s.json")
    assert pregress.main(["--baseline", b, "--new", b]) == 0
    assert pregress.main(["--baseline", b, "--new", s]) == 1
    _, regressions = pregress.compare(pregress.load_metrics(b),
                                      pregress.load_metrics(s), 5.0)
    assert [r[0].split(":")[0] for r in regressions] == [
        "dlrm_synthetic_samples_per_sec", "dlrm_tune_step_ms"]


# ---------------------------------------------------------------- the CLIs

def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "dlrm_flexflow_tpu_torch.telemetry", *args],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "PYTHONPATH": REPO})


def test_cli_report_export_trace_and_regress(run_jsonl, tmp_path):
    path = shutil.copy(run_jsonl[0], tmp_path / "run.jsonl")
    text = _cli("report", str(path), cwd=str(tmp_path))
    assert text.returncode == 0, text.stderr[-2000:]
    assert text.stdout.rstrip("\n") == jreport.format_report(
        jreport.load_events(str(path)))
    js = _cli("report", str(path), "--format", "json", cwd=str(tmp_path))
    assert js.returncode == 0, js.stderr[-2000:]
    assert json.loads(js.stdout) == json.loads(json.dumps(
        jreport.report_data(jreport.load_events(str(path))), default=str))
    out = str(tmp_path / "t.json")
    tr = _cli("export-trace", str(path), "-o", out, cwd=str(tmp_path))
    assert tr.returncode == 0 and "export-trace:" in tr.stdout
    assert json.load(open(out))["traceEvents"]
    hist = os.path.join(REPO, "bench_history.json")
    rg = _cli("regress", "--baseline", hist, "--new", hist,
              cwd=str(tmp_path))
    assert rg.returncode == 0 and "regress: OK" in rg.stdout
    bad = _cli("report", cwd=str(tmp_path))
    assert bad.returncode == 2
    assert _cli(cwd=str(tmp_path)).returncode == 2  # no subcommand: help
