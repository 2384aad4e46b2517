"""The port's fleet observability (``dlrm_flexflow_tpu_torch/telemetry/
fleet.py``) against the JAX package's on the CPU: per-process sinks and
their stamps, the merge of doctored three-process sinks (either package's
writer, both packages' readers: equal ``fleet_data`` and ``render_fleet``),
the report on a directory, the flight recorder (a real death of the
port's resilient ``fit``, found, loaded and rendered alike by both), the
process identity from ``torch.distributed`` in three gloo processes, and
the row-frequency report section.  JAX is imported here only.

The golden numbers of the doctored fleet are the JAX tests' (hosts at
100/130/100 ms: skew 30 ms, p001 the straggler), so they can be
recomputed by hand.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from dlrm_flexflow_tpu.telemetry import fleet as jfleet
from dlrm_flexflow_tpu.telemetry import rowfreq as jrowfreq
from dlrm_flexflow_tpu.telemetry.regress import \
    lower_is_better as jax_lower_is_better

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader
from dlrm_flexflow_tpu_torch.resilience import (NaNSentinel,
                                                TrainingDiverged,
                                                faultinject)
from dlrm_flexflow_tpu_torch.telemetry import EventLog, event_log
from dlrm_flexflow_tpu_torch.telemetry import fleet as pfleet
from dlrm_flexflow_tpu_torch.telemetry import metrics as pmetrics
from dlrm_flexflow_tpu_torch.telemetry import rowfreq as prowfreq
from dlrm_flexflow_tpu_torch.telemetry.regress import lower_is_better

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    faultinject.clear()
    prowfreq.reset()
    pmetrics.reset()
    yield
    faultinject.clear()
    prowfreq.reset()
    pmetrics.reset()


def write_fleet(mod, d, walls, syncs, slices, steps=3):
    """One per-process sink per host through ``mod.fleet_event_log``
    (explicit pidx/slice/nproc, the JAX tests' doctoring)."""
    for pidx, wall in walls.items():
        with mod.fleet_event_log(path=os.path.join(str(d), "run.jsonl"),
                                 mode="w", pidx=pidx,
                                 slice_id=slices[pidx],
                                 nproc=len(walls)) as log:
            for s in range(1, steps + 1):
                log.emit("phase_time", step=s, phase="step",
                         step_wall_ms=wall, sync_wait_ms=syncs[pidx],
                         samples=8)
            log.emit("step", wall_s=steps * wall / 1e3,
                     samples=8 * steps, samples_per_s=1000.0,
                     fenced=True, phase="fit")


def _strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


FLEETS = {
    "golden": ({0: 100.0, 1: 130.0, 2: 100.0}, {0: 10.0, 1: 40.0, 2: 10.0},
               {0: 0, 1: 0, 2: 1}),
    "two-slow": ({0: 90.0, 1: 140.0, 2: 150.0}, {0: 5.0, 1: 5.0, 2: 70.0},
                 {0: 0, 1: 1, 2: 2}),
    "one-slice": ({0: 50.0, 1: 50.0, 2: 80.0}, {0: 0.0, 1: 1.0, 2: 2.0},
                  {0: 0, 1: 0, 2: 0}),
}


@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_merge_equals_jax(tmp_path, fleet, writer):
    """Three doctored per-process sinks, written by one package, merged
    by both: the same stamped events, fleet_data and render_fleet."""
    walls, syncs, slices = FLEETS[fleet]
    write_fleet(pfleet if writer == "port" else jfleet, tmp_path, walls,
                syncs, slices)
    assert sorted(os.listdir(tmp_path)) == [f"run_p00{i}.jsonl"
                                            for i in range(3)]
    pev = pfleet.load_fleet_events(str(tmp_path), strict=True)
    jev = jfleet.load_fleet_events(str(tmp_path), strict=True)
    assert pev == jev
    pdata, jdata = pfleet.fleet_data(pev), jfleet.fleet_data(jev)
    assert pdata == jdata
    assert pfleet.render_fleet(pdata) == jfleet.render_fleet(jdata)
    assert pfleet.fleet_section(pev) == jfleet.fleet_section(jev)
    assert pmetrics.STEP_SKEW_MS.value == pdata["steps"][-1]["skew_ms"]
    if fleet == "golden":
        assert pdata["straggler"]["pidx"] == 1
        assert pdata["straggler"]["total_skew_ms"] == pytest.approx(90.0)
        assert pdata["exposed_comm_pct"] == pytest.approx(
            100.0 * 60.0 / 330.0)
        text = "\n".join(pfleet.render_fleet(pdata))
        assert "slice 0: 2,000 samples/s over 2 host(s)" in text


def test_sink_naming_and_stamp_equal_jax():
    for args in ((2, 3), (0, 1), (11, 12)):
        assert pfleet.process_sink_path("t.jsonl", *args) == \
            jfleet.process_sink_path("t.jsonl", *args)
    assert pfleet.process_sink_path("t", pidx=2, nproc=3) == "t_p002.jsonl"
    for kw in ({"pidx": 2, "slice_id": 1, "nproc": 3},
               {"pidx": 2, "nproc": 3}, {"pidx": 0, "nproc": 1}):
        assert pfleet.fleet_stamp(**kw) == jfleet.fleet_stamp(**kw)
    # no process group: process 0 of 1, one flat slice, no rewrite
    assert pfleet.fleet_stamp() == {"pidx": 0, "slice": 0}
    assert pfleet.process_sink_path("t.jsonl") == "t.jsonl"


def test_single_process_fleet_log_is_the_plain_log(tmp_path):
    with pfleet.fleet_event_log(path=str(tmp_path / "t.jsonl")) as log:
        log.emit("phase_time", step=1, phase="step", step_wall_ms=5.0,
                 samples=8)
    assert log.stamp is None
    ev, = pfleet.load_fleet_events(str(tmp_path))
    assert "pidx" not in ev
    data = pfleet.fleet_data([ev])
    assert data["aligned_steps"] == 0 and pfleet.render_fleet(data) == []


def test_unstamped_sinks_inherit_the_filename_pidx(tmp_path):
    for pidx in (0, 1):
        with event_log(path=str(tmp_path / f"run_p{pidx:03d}.jsonl")) as log:
            log.emit("phase_time", step=1, phase="step",
                     step_wall_ms=10.0 * (pidx + 1), samples=8)
    pev = pfleet.load_fleet_events(str(tmp_path))
    assert pev == jfleet.load_fleet_events(str(tmp_path))
    data = pfleet.fleet_data(pev)
    assert data["hosts"] == [0, 1] and data["steps"][0]["worst_pidx"] == 1
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        pfleet.load_fleet_events(str(tmp_path / "empty"))


def test_report_accepts_a_directory(tmp_path):
    write_fleet(pfleet, tmp_path, {0: 100.0, 1: 130.0}, {0: 10.0, 1: 10.0},
                {0: 0, 1: 1})
    outs = []
    for flag in ([str(tmp_path)], ["--fleet", str(tmp_path)]):
        r = subprocess.run(
            [sys.executable, "-m", "dlrm_flexflow_tpu_torch.telemetry",
             "report", *flag, "--format", "json"],
            capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
            env={**os.environ, "PYTHONPATH": REPO})
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(json.loads(r.stdout))
    assert outs[0] == outs[1]
    assert outs[0]["fleet"]["straggler"]["pidx"] == 1
    assert set(outs[0]["fleet"]["per_slice"]) == {"0", "1"}


# ---------------------------------------------------------- flight recorder

def _model():
    m = fft.FFModel(fft.FFConfig(batch_size=8))
    x = m.create_tensor((8, 4), name="x")
    m.dense(x, 8, activation="relu")
    m.dense(m.layers[-1].outputs[0], 1)
    m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=())
    return m


def _loader(n=64):
    rng = np.random.default_rng(0)
    return ArrayDataLoader(
        {"x": rng.standard_normal((n, 4)).astype(np.float32)},
        rng.standard_normal((n, 1)).astype(np.float32), 8)


def test_a_dying_fit_leaves_one_record_both_packages_render(tmp_path,
                                                            monkeypatch):
    """The port's resilient fit killed by nan_grads: the original
    exception propagates, one record holds the death, and both packages
    find, load and render it alike (``report --flight`` too)."""
    monkeypatch.setenv("FF_FLIGHT_DIR", str(tmp_path))
    faultinject.install("nan_grads@step=1,nan_grads@step=2,"
                        "nan_grads@step=3")
    m = _model()
    with pytest.raises(TrainingDiverged):
        with event_log():
            m.fit(m.init(seed=0, device="cpu"), _loader(), epochs=2,
                  verbose=False,
                  sentinel=NaNSentinel(policy="skip", max_rollbacks=2))
    recs = pfleet.find_flight_records(str(tmp_path))
    assert len(recs) == 1 and recs == jfleet.find_flight_records(
        str(tmp_path))
    doc = pfleet.load_flight_record(recs[0])
    assert doc == jfleet.load_flight_record(recs[0])
    assert doc["exception"]["type"] == "TrainingDiverged"
    last = doc["events"][-1]
    fatal = max(e["step"] for e in doc["events"]
                if e["type"] == "fault" and e["kind"] == "nan_grads")
    assert last["type"] == "anomaly" and last["step"] == fatal
    lines = pfleet.render_flight(doc)
    assert lines == jfleet.render_flight(doc)
    assert "died: TrainingDiverged" in "\n".join(lines)
    r = subprocess.run(
        [sys.executable, "-m", "dlrm_flexflow_tpu_torch.telemetry",
         "report", "--flight", recs[0]], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0 and r.stdout.rstrip("\n") == "\n".join(lines)


@pytest.mark.parametrize("last_s,max_events", [(5.0, 20), (0.0, 3),
                                               (1e9, 2)])
def test_a_stamped_record_renders_as_in_jax(tmp_path, last_s, max_events):
    log = EventLog(stamp={"pidx": 2, "slice": 1})
    for i in range(6):
        log.emit("step", wall_s=0.5, samples=8, phase="fit", loss=0.1 * i)
    from dlrm_flexflow_tpu_torch.telemetry import set_event_log
    from dlrm_flexflow_tpu_torch.telemetry.trace import start_span
    prev = set_event_log(log)  # spans open only with telemetry on
    sp = start_span("train.fit")
    try:
        path = pfleet.dump_flight_record(RuntimeError("boom"),
                                         out_dir=str(tmp_path))
    finally:
        sp.end()
        set_event_log(prev)
    assert os.path.basename(path).endswith("_p002.json")
    doc = pfleet.load_flight_record(path)
    assert doc["stamp"] == {"pidx": 2, "slice": 1}
    assert [s["name"] for s in doc["open_spans"]] == ["train.fit"]
    got = pfleet.render_flight(doc, last_s=last_s, max_events=max_events)
    assert got == jfleet.render_flight(doc, last_s=last_s,
                                       max_events=max_events)
    assert "process: p002 (slice 1)" in got


def test_partial_writes_and_missing_logs(tmp_path, monkeypatch):
    tmp = tmp_path / "flightrecorder_1.json.tmp"
    tmp.write_text('{"kind": "flightrec')  # a torn write
    assert pfleet.find_flight_records(str(tmp_path)) == []
    with pytest.raises(ValueError, match="partial"):
        pfleet.load_flight_record(str(tmp))
    other = tmp_path / "flightrecorder_2.json"
    other.write_text(json.dumps({"kind": "not-a-record"}))
    with pytest.raises(ValueError, match="not a flight-recorder"):
        pfleet.load_flight_record(str(other))
    monkeypatch.setenv("FF_FLIGHT_DIR", str(tmp_path / "d"))
    assert pfleet.dump_flight_record(RuntimeError("x"), log=None) is None
    assert not (tmp_path / "d").exists()
    (tmp_path / "f").write_text("")  # a FILE where the dir should be
    log = EventLog()
    log.emit("step", wall_s=1.0, samples=8)
    assert pfleet.dump_flight_record(
        RuntimeError("x"), log=log, out_dir=str(tmp_path / "f" / "x")) \
        is None
    assert pfleet.find_flight_records(str(tmp_path / "nowhere")) == []


# ------------------------------------------------ torch.distributed identity

_WORKER = r"""
import json, os, sys
import torch.distributed as dist
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from dlrm_flexflow_tpu_torch.telemetry import fleet, metrics
with fleet.fleet_event_log(path=os.path.join(out, "run.jsonl"),
                           mode="w") as log:
    for s in (1, 2):
        log.emit("phase_time", step=s, phase="step",
                 step_wall_ms=100.0 + 15.0 * rank, samples=8)
dist.barrier()
print(json.dumps({"stamp": fleet.fleet_stamp(),
                  "sink": fleet.process_sink_path("run.jsonl"),
                  "index": metrics.PROCESS_INDEX.value,
                  "count": metrics.PROCESS_COUNT.value}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_three_gloo_processes_stamp_and_merge(tmp_path):
    """Three processes in one gloo group: each stamps its rank, writes
    its own sink, and reports its index and the count on the metrics;
    the merge names the slowest rank the straggler."""
    world, port = 3, _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": REPO})
        for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for r, o in enumerate(outs):
        assert o == {"stamp": {"pidx": r, "slice": r},
                     "sink": f"run_p{r:03d}.jsonl",
                     "index": float(r), "count": float(world)}
    data = pfleet.fleet_data(pfleet.load_fleet_events(str(tmp_path)))
    assert data == jfleet.fleet_data(jfleet.load_fleet_events(
        str(tmp_path)))
    assert data["hosts"] == [0, 1, 2] and data["straggler"]["pidx"] == 2
    assert data["steps"][0]["skew_ms"] == pytest.approx(15.0)


# ------------------------------------------------------------ row frequency

def test_row_freq_section_equals_jax():
    log = EventLog()
    rng = np.random.default_rng(11)
    for t in ("sparse[0]", "sparse[1]"):
        c = prowfreq.RowFreqCounter(t, capacity=16)
        c.observe(rng.zipf(1.3, size=4000) % 500)
        c.emit(log)
    evs = log.events()
    assert prowfreq.row_freq_summary(evs) == jrowfreq.row_freq_summary(evs)
    assert prowfreq.row_freq_summary(evs)[0] == "== row frequency =="
    assert prowfreq.row_freq_summary([]) == []


def test_skew_gates_lower_is_better():
    for name in ("dlrm_step_skew_ms", "dlrm_step_skew_ms:hosts=2"):
        assert lower_is_better(name) is jax_lower_is_better(name) is True
