"""The port's closed SOAP loop (``dlrm_flexflow_tpu_torch/sim/tune.py``,
``tools/search_tune.py``) against the JAX package's (``sim/tune.py``) on
the CPU: the calibration fit bit for bit on the same ``op_time`` JSONL,
calibration and strategy artifacts that cross between the packages (an
incumbent promoted by one gates the other), ``search_tune``'s strategy,
versions and verdicts equal under the same machine constants (the port's
``H100MachineModel`` given the JAX ``TPUMachineModel``'s values, as
``test_torch_sim.py`` does), the promotion gate, the freshness gauges,
and the tool as a subprocess.  JAX is imported here only.

Every comparison of fitted numbers is exact: the fit is pure Python on
the same floats in both packages.  Telemetry is made from a numpy seed.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.sim import cost_model as jcm
from dlrm_flexflow_tpu.sim import tune as jtune
from dlrm_flexflow_tpu.telemetry import event_log as jax_event_log
from dlrm_flexflow_tpu.telemetry.report import load_events as jax_load_events

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.parallel import Strategy
from dlrm_flexflow_tpu_torch.sim import cost_model as pcm
from dlrm_flexflow_tpu_torch.sim import tune as ptune
from dlrm_flexflow_tpu_torch.sim.cost_model import CostModel
from dlrm_flexflow_tpu_torch.sim.search import (data_parallel_strategy,
                                                mcmc_search)
from dlrm_flexflow_tpu_torch.telemetry import event_log
from dlrm_flexflow_tpu_torch.telemetry import metrics as pmetrics
from dlrm_flexflow_tpu_torch.telemetry.regress import lower_is_better
from dlrm_flexflow_tpu_torch.telemetry.report import load_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "dlrm_flexflow_tpu_torch", "tools",
                    "search_tune.py")
D = 8
BATCH = 16

#: small graphs: (tables, bag, interaction, fused, stacked inputs)
GRAPHS = {
    "ragged-cat": ([300, 200, 120], 2, "cat", "off", True),
    "stacked-dot": ([256, 256], 1, "dot", "off", True),
    "fused-cat": ([300, 200, 120], 2, "cat", "on", True),
    "per-table": ([300, 200, 120], 1, "cat", "off", False),
}


@pytest.fixture(autouse=True)
def _fresh_registry():
    pmetrics.reset()
    yield
    pmetrics.reset()


def _pair(graph="ragged-cat"):
    """(JAX model, port model) of one small DLRM graph, built alike."""
    tables, bag, interact, fused, stacked = GRAPHS[graph]
    t = len(tables)
    top0 = D + t * D if interact == "cat" else D + (t + 1) ** 2
    kw = dict(sparse_feature_size=D, embedding_size=list(tables),
              embedding_bag_size=bag, mlp_bot=[13, 16, D],
              mlp_top=[top0, 16, 1], arch_interaction_op=interact,
              fused_interaction=fused)
    j = jax_build_dlrm(JaxDLRMConfig(**kw), ffj.FFConfig(batch_size=BATCH),
                       stacked_embeddings=stacked)
    p = build_dlrm(DLRMConfig(**kw), fft.FFConfig(batch_size=BATCH),
                   stacked_embeddings=stacked)
    assert [(o.name, type(o).__name__) for o in j.layers] == \
        [(o.name, type(o).__name__) for o in p.layers]
    return j, p


def _jax_valued_machine_class():
    """``H100MachineModel`` whose defaults are the JAX machine's values."""
    j = jcm.TPUMachineModel()
    values = dict(
        name=j.name, peak_flops_bf16=j.peak_flops_bf16,
        peak_flops_f32=j.peak_flops_f32, hbm_bandwidth=j.hbm_bandwidth,
        hbm_bytes=j.hbm_bytes, nvlink_bandwidth=j.ici_bandwidth,
        nvlink_links_per_gpu=j.ici_links_per_chip,
        ib_bandwidth=j.dcn_bandwidth,
        kernel_launch_overhead=j.kernel_launch_overhead)
    return dataclasses.make_dataclass(
        "H100MachineModel",
        [(f.name, f.type, dataclasses.field(default=values[f.name]))
         for f in dataclasses.fields(pcm.H100MachineModel)
         if f.name != "topology"],
        bases=(pcm.H100MachineModel,))


def _op_time_events(model, seed=0, extra=()):
    """op_time telemetry for every op of ``model``: measured and
    predicted times drawn from a numpy seed, the measured ones a
    per-class factor off the predictions with a per-op wobble, so a fit
    improves the error but cannot zero it."""
    rng = np.random.default_rng(seed)
    factor = {}
    evs = []
    for i, op in enumerate(model.layers):
        cls = type(op).__name__
        f = factor.setdefault(cls, float(rng.uniform(0.05, 40.0)))
        sf, sb = (float(x) for x in rng.uniform(1e-6, 1e-3, size=2))
        wf, wb = (float(x) for x in rng.uniform(0.7, 1.4, size=2))
        evs.append({"type": "op_time", "ts": float(i), "op": op.name,
                    "forward_s": sf * f * wf, "backward_s": sb * f * wb,
                    "sim_forward_s": sf, "sim_backward_s": sb})
    return evs + list(extra)


def _write(path, events):
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return str(path)


def _cal_fields(cal):
    return (cal.scales, cal.source, cal.ops, cal.mae_pct_before,
            cal.mae_pct_after)


# ------------------------------------------------------------- calibration

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [0, 1])
def test_fit_calibration_is_bit_equal_to_jax(tmp_path, graph, seed):
    """The same op_time JSONL through both packages' loaders and fits:
    equal scales and equal errors before and after, bit for bit; the
    fit events and the gauge agree too."""
    j, p = _pair(graph)
    path = _write(tmp_path / "run.jsonl", _op_time_events(p, seed))
    with jax_event_log() as jlog:
        jcal = jtune.fit_calibration(jax_load_events(path), j, source=path)
    with event_log() as plog:
        pcal = ptune.fit_calibration(load_events(path), p, source=path)
    assert _cal_fields(pcal) == _cal_fields(jcal)
    assert pcal.mae_pct_after < pcal.mae_pct_before
    strip = [{k: v for k, v in e.items() if k != "ts"}
             for e in plog.events("calibration")]
    assert strip == [{k: v for k, v in e.items() if k != "ts"}
                     for e in jlog.events("calibration")]
    assert pmetrics.SIM_CALIBRATION_ERROR.value == pcal.mae_pct_after


@pytest.mark.parametrize("seed", range(4))
def test_best_scale_matches_jax_and_never_hurts(seed):
    rng = np.random.default_rng(seed)
    meas = [float(x) for x in rng.uniform(1e-6, 1e-2, size=7)]
    sims = [float(x) for x in rng.uniform(1e-6, 1e-2, size=7)]
    s = ptune._best_scale(meas, sims)
    assert s == jtune._best_scale(meas, sims)

    def err(k):
        return sum(abs(k * b - a) / a for a, b in zip(meas, sims))

    assert err(s) <= err(1.0)
    assert ptune._best_scale([2.0, 2.0, 8.0], [1.0, 1.0, 1.0]) == 2.0
    assert ptune._best_scale([], []) == 1.0


def test_pairs_and_class_map_match_jax(tmp_path):
    j, p = _pair("fused-cat")
    evs = _op_time_events(p, extra=[
        {"type": "op_time", "ts": 1e9, "op": p.layers[0].name,
         "forward_s": 123.0},  # the newest rerun dropped the prediction
        {"type": "op_time", "ts": 1e9, "op": "ghost_op", "forward_s": 1.0,
         "sim_forward_s": 1e-6}])
    assert ptune.op_class_map(p) == jtune.op_class_map(j)
    pairs = ptune.pair_op_times(evs, ptune.op_class_map(p))
    assert pairs == jtune.pair_op_times(evs, jtune.op_class_map(j))
    assert p.layers[0].name not in {x["op"] for x in pairs}
    assert ptune.mean_abs_rel_error_pct(
        [x for x in pairs if x["cls"]]) == jtune.mean_abs_rel_error_pct(
        [x for x in pairs if x["cls"]])


def test_fit_refuses_what_jax_refuses():
    j, p = _pair()
    for mod, m in ((ptune, p), (jtune, j)):
        with pytest.raises(ValueError, match="no op_time events"):
            mod.fit_calibration([{"type": "step"}], m)
        foreign = [dict(e, op=f"other_{i}")
                   for i, e in enumerate(_op_time_events(p))]
        with pytest.raises(ValueError, match="different architecture"):
            mod.fit_calibration(foreign, m)
    ghost = _op_time_events(p, extra=[{
        "type": "op_time", "ts": 99.0, "op": "ghost_op",
        "forward_s": 1.0, "sim_forward_s": 1e-6}])
    cal = ptune.fit_calibration(ghost, p)
    assert cal.ops == len(p.layers) and "ghost_op" not in cal.scales


def test_calibrated_cost_model_scales_the_analytic_estimate():
    _, p = _pair()
    op = next(o for o in p.layers if type(o).__name__ == "Linear")
    base = CostModel().op_times(op, 1)
    cal = ptune.Calibration(scales={"Linear": (3.0, 5.0)})
    fwd, bwd = CostModel(calibration=cal).op_times(op, 1)
    assert (fwd, bwd) == (base[0] * 3.0, base[1] * 5.0)
    other = ptune.Calibration(scales={"Conv2D": (9.0, 9.0)})
    assert CostModel(calibration=other).op_times(op, 1) == base


# ---------------------------------------------------------------- artifacts

def test_calibration_artifacts_version_and_cross_packages(tmp_path):
    cal = ptune.Calibration(scales={"Linear": (1.5, 2.5)},
                            source="a.jsonl", fitted_ts=1.0, ops=3,
                            mae_pct_before=40.0, mae_pct_after=4.0)
    p1 = ptune.save_calibration_artifact(str(tmp_path), cal)
    jcal = jtune.Calibration(scales={"Linear": (1.5, 2.5)},
                             source="a.jsonl", fitted_ts=1.0, ops=3,
                             mae_pct_before=40.0, mae_pct_after=4.0)
    p2 = jtune.save_calibration_artifact(str(tmp_path), jcal)
    p3 = ptune.save_calibration_artifact(str(tmp_path), cal)
    assert [os.path.basename(x) for x in (p1, p2, p3)] == [
        f"calibration_v000{i}.json" for i in (1, 2, 3)]
    for path in (p1, p2, p3):
        assert _cal_fields(ptune.Calibration.load(path)) == \
            _cal_fields(jtune.Calibration.load(path)) == _cal_fields(cal)
    assert open(p1).read() == open(p2).read().replace(
        "_v0002", "_v0001").replace('"version": 2', '"version": 1')
    assert ptune.example_calibration_artifact() == \
        jtune.example_calibration_artifact()
    assert ptune.validate_calibration_artifact(
        ptune.example_calibration_artifact()) == []


@pytest.mark.parametrize("doctor", ["missing-scales", "extra", "schema",
                                    "listy-scales", "bool-ops"])
def test_calibration_validator_names_what_jax_names(doctor):
    doc = ptune.example_calibration_artifact()
    if doctor == "missing-scales":
        del doc["scales"]
    elif doctor == "extra":
        doc["extra"] = 1
    elif doctor == "schema":
        doc["schema"] = 99
    elif doctor == "listy-scales":
        doc["scales"] = [["Linear", 1.0]]
    else:
        doc["ops"] = True
    errs = ptune.validate_calibration_artifact(doc)
    assert errs and errs == jtune.validate_calibration_artifact(doc)


def _strategy_kw(**kw):
    return dict(dict(app="dlrm", num_devices=8, sim_step_s=1e-3, seed=0,
                     budget=50), **kw)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_strategy_artifacts_cross_packages(tmp_path, writer):
    """A strategy artifact either package writes validates and loads in
    both, as the same op configs, and through the port's Strategy.load;
    versions continue across writers in one directory."""
    j, p = _pair()
    pstrat = data_parallel_strategy(p, 8)
    from dlrm_flexflow_tpu.sim.search import \
        data_parallel_strategy as jax_dp
    jstrat = jax_dp(j, 8)
    first, second = ((ptune, pstrat), (jtune, jstrat))[::1 if writer ==
                                                          "port" else -1]
    path1, doc1 = first[0].save_strategy_artifact(
        str(tmp_path), first[1], **_strategy_kw(telemetry="t.jsonl",
                                               calibration="c.json"))
    path2, doc2 = second[0].save_strategy_artifact(
        str(tmp_path), second[1], **_strategy_kw(parent_version=1))
    assert (doc1["version"], doc2["version"]) == (1, 2)
    for path in (path1, path2):
        pdoc = ptune.load_strategy_artifact(path)
        jdoc = jtune.load_strategy_artifact(path)
        assert pdoc == jdoc
        assert ptune.validate_strategy_artifact(jdoc) == []
        got = {k: (tuple(v.dims), v.device_type, v.device_ids)
               for k, v in ptune.strategy_from_artifact(pdoc)
               .configs.items()}
        want = {k: (tuple(v.dims), v.device_type, v.device_ids)
                for k, v in jtune.strategy_from_artifact(jdoc)
                .configs.items()}
        assert got == want
        assert {k: tuple(v.dims) for k, v in Strategy.load(path)
                .configs.items()} == {k: d[0] for k, d in got.items()}
    assert doc2["provenance"]["parent_version"] == 1


@pytest.mark.parametrize("doctor", ["nameless-op", "dims", "schema",
                                    "provenance"])
def test_strategy_validator_names_what_jax_names(tmp_path, doctor):
    doc = ptune.example_strategy_artifact()
    if doctor == "nameless-op":
        doc["strategy"] = {"ops": [{"dims": [1]}]}
    elif doctor == "dims":
        doc["strategy"] = {"ops": [{"name": "x", "dims": ["x", 1]}]}
    elif doctor == "schema":
        doc["schema"] = 99
    else:
        del doc["provenance"]["seed"]
    errs = ptune.validate_strategy_artifact(doc)
    assert errs and errs == jtune.validate_strategy_artifact(doc)
    path = tmp_path / "s.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="invalid strategy"):
        ptune.load_strategy_artifact(str(path))
    if doctor == "schema":
        with pytest.raises(ValueError, match="unsupported"):
            Strategy.load(str(path))


def test_version_claim_survives_a_race(tmp_path, monkeypatch):
    _, p = _pair()
    s = data_parallel_strategy(p, 8)
    p1, _ = ptune.save_strategy_artifact(str(tmp_path), s, **_strategy_kw())
    first = open(p1).read()
    real = ptune.next_version
    stale = iter([1])  # one stale scan, then the real answer
    monkeypatch.setattr(ptune, "next_version",
                        lambda d, kind: next(stale, None) or real(d, kind))
    p2, doc2 = ptune.save_strategy_artifact(str(tmp_path), s,
                                            **_strategy_kw(seed=1))
    assert p2.endswith("strategy_v0002.json") and doc2["version"] == 2
    assert open(p1).read() == first


@pytest.mark.parametrize("promoter", ["port", "jax"])
def test_promote_moves_the_pointer_and_the_gauges(tmp_path, promoter):
    mod = ptune if promoter == "port" else jtune
    assert ptune.load_incumbent(str(tmp_path), "dlrm", 8) is None
    doc = ptune.example_strategy_artifact()
    path = mod.promote(str(tmp_path), doc)
    assert path == ptune.incumbent_path(str(tmp_path), "dlrm", 8) == \
        jtune.incumbent_path(str(tmp_path), "dlrm", 8)
    assert ptune.load_incumbent(str(tmp_path), "dlrm", 8) == \
        jtune.load_incumbent(str(tmp_path), "dlrm", 8) == doc
    if promoter == "port":
        assert pmetrics.STRATEGY_VERSION.value == doc["version"]
        assert pmetrics.STRATEGY_AGE.value > 0  # created_ts=1.0: ancient
    topo = pcm.PodTopology(2, 4)
    assert ptune.incumbent_path("a", "dlrm", 8, topo).endswith(
        "strategy_incumbent_dlrm_8dev_2x4pod.json")


# --------------------------------------------------------------- the gate

def test_gate_verdicts_and_events_match_jax():
    cand = dict(ptune.example_strategy_artifact(), version=2)
    inc = ptune.example_strategy_artifact()
    benches = [lambda d: 1e-3,
               lambda d: 1e-3 if d["version"] == 2 else 2e-3,
               lambda d: 3e-3 if d["version"] == 2 else 1e-3,
               lambda d: 1.03e-3 if d["version"] == 2 else 1e-3]
    got = []
    for mod, log_cm in ((ptune, event_log), (jtune, jax_event_log)):
        with log_cm() as log:
            out = [mod.gate_candidate(cand, None, benches[0])]
            out += [mod.gate_candidate(cand, inc, b) for b in benches[1:]]
        evs = [{k: v for k, v in e.items() if k != "ts"}
               for e in log.events("search")]
        got.append((out, evs))
    assert got[0] == got[1]
    assert [v for v, _, _ in got[0][0]] == ["first", "promoted", "rejected",
                                           "promoted"]
    assert lower_is_better(ptune.TUNE_METRIC)


def test_gate_fails_closed_on_a_nonpositive_bench():
    cand = dict(ptune.example_strategy_artifact(), version=2)
    inc = ptune.example_strategy_artifact()
    with pytest.raises(ValueError, match="non-positive baseline"):
        ptune.gate_candidate(cand, inc,
                             lambda d: 1.0 if d["version"] == 2 else 0.0)
    with pytest.raises(ValueError, match="bench bug"):
        ptune.gate_candidate(cand, inc, lambda d: 0.0)


@pytest.mark.parametrize("seed", [3, 4])
def test_search_is_deterministic_under_a_seed(seed):
    _, p = _pair()

    def run(s):
        with event_log() as log:
            best = mcmc_search(p, 8, budget=25, seed=s, backend="python",
                               measure=False)
        its = [{k: e[k] for k in ("it", "op", "dims", "accepted",
                                  "current_s", "best_s")}
               for e in log.events("search") if e["phase"] == "iteration"]
        return {k: v.dims for k, v in best.configs.items()}, its

    assert run(seed) == run(seed)


# ------------------------------------------------------------- search_tune

def _lineage_view(r, art):
    """A search_tune result without its paths and wall-clock fields, and
    its strategy artifact's configs."""
    doc = ptune.load_strategy_artifact(r["strategy_path"])
    return ({k: v for k, v in r.items()
             if k not in ("strategy_path", "calibration_path")},
            os.path.basename(r["strategy_path"]),
            os.path.relpath(r["calibration_path"], art),
            doc["strategy"], doc["sim_step_s"], doc["provenance"]["seed"],
            doc["provenance"]["parent_version"],
            doc["provenance"]["mae_pct_after"])


@pytest.mark.parametrize("graph", ["ragged-cat", "fused-cat"])
def test_search_tune_lineage_equals_jax(tmp_path, monkeypatch, graph):
    """Three runs (8 devices, then 4 twice) on the same telemetry: the
    same strategies, simulated steps, versions, verdicts and parents in
    both packages when the port's machine carries the JAX values; each
    topology keeps its own incumbent."""
    j, p = _pair(graph)
    tel = _write(tmp_path / "rec.jsonl", _op_time_events(p, seed=5))
    jart, part = str(tmp_path / "jax"), str(tmp_path / "port")
    plan = [(8, 10), (4, 10), (4, 10)]
    jres = [jtune.search_tune(j, n, tel, jart, budget=b) for n, b in plan]
    with monkeypatch.context() as m:
        m.setattr(pcm, "H100MachineModel", _jax_valued_machine_class())
        pres = [ptune.search_tune(p, n, tel, part, budget=b)
                for n, b in plan]
    assert [_lineage_view(r, part) for r in pres] == \
        [_lineage_view(r, jart) for r in jres]
    assert [(r["verdict"], r["version"], r["parent_version"])
            for r in pres] == [("first", 1, None), ("first", 2, None),
                               ("promoted", 3, 2)]
    assert ptune.load_incumbent(part, "dlrm", 8)["version"] == 1
    assert ptune.load_incumbent(part, "dlrm", 4)["version"] == 3


@pytest.mark.parametrize("first", ["jax", "port"])
def test_an_incumbent_from_one_package_gates_the_other(tmp_path, first):
    """One artifacts directory, both packages: the second package's run
    finds the first's incumbent, gates against it and continues the
    lineage; under the same constants the tie promotes."""
    j, p = _pair()
    tel = _write(tmp_path / "rec.jsonl", _op_time_events(p, seed=6))
    art = str(tmp_path / "art")
    runs = [("jax", lambda: jtune.search_tune(j, 4, tel, art, budget=10)),
            ("port", lambda: ptune.search_tune(p, 4, tel, art, budget=10))]
    if first == "port":
        runs.reverse()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pcm, "H100MachineModel", _jax_valued_machine_class())
        r1 = runs[0][1]()
        r2 = runs[1][1]()
    assert (r1["verdict"], r1["version"]) == ("first", 1)
    assert (r2["verdict"], r2["version"], r2["parent_version"]) == \
        ("promoted", 2, 1)
    assert r2["incumbent_s"] == r1["candidate_s"]
    inc_p = ptune.load_incumbent(art, "dlrm", 4)
    assert inc_p == jtune.load_incumbent(art, "dlrm", 4)
    assert inc_p["version"] == 2


def test_search_tune_on_h100_constants_gates_a_doctored_bench(tmp_path):
    """On its own H100 constants the loop promotes v1, refuses a bench
    that makes the candidate slower, and the report renders the lineage
    and verdicts."""
    _, p = _pair()
    tel = _write(tmp_path / "rec.jsonl", _op_time_events(p, seed=7))
    art = str(tmp_path / "art")
    sink = str(tmp_path / "tune.jsonl")
    with event_log(path=sink):
        r1 = ptune.search_tune(p, 4, tel, art, budget=10)
        r2 = ptune.search_tune(
            p, 4, tel, art, budget=10,
            bench_fn=lambda d: 2e-3 if d["version"] == 2 else 1e-3)
    assert (r1["verdict"], r2["verdict"]) == ("first", "rejected")
    assert ptune.load_incumbent(art, "dlrm", 4)["version"] == 1
    assert pmetrics.STRATEGY_VERSION.value == 1
    from dlrm_flexflow_tpu_torch.telemetry.report import format_report
    text = format_report(load_events(sink))
    assert "strategy lineage [dlrm/4dev]: v1" in text
    assert "rejected" in text and "== tuning ==" in text


# ---------------------------------------------------------------- the tool

def _tool(*args, cwd):
    return subprocess.run([sys.executable, TOOL, *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=cwd)


def _tiny_telemetry(path):
    """op_time telemetry of the tool's --tiny model."""
    sys.path.insert(0, os.path.dirname(TOOL))
    try:
        import search_tune as tool
    finally:
        sys.path.pop(0)
    _, m = tool.build_model(tool.parse_args(["--telemetry", "x", "--tiny"]))
    return _write(path, _op_time_events(m, seed=8))


def test_tool_runs_on_the_cpu_and_prints_one_json_line(tmp_path):
    tel = _tiny_telemetry(tmp_path / "rec.jsonl")
    art = str(tmp_path / "art")
    base = ["--telemetry", tel, "--artifacts", art, "--tiny", "--device",
            "cpu", "--devices", "4", "--budget", "20"]
    outs = []
    for extra in ([], ["--bench", "real", "--bench-batches", "2"]):
        r = _tool(*base, *extra, cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr[-2000:]
        lines = r.stdout.strip().splitlines()
        assert len(lines) == 1
        outs.append(json.loads(lines[0]))
    assert (outs[0]["verdict"], outs[0]["version"]) == ("first", 1)
    assert outs[1]["version"] == 2 and outs[1]["parent_version"] == 1
    assert outs[1]["verdict"] in ("promoted", "rejected")
    assert outs[1]["candidate_s"] > 0 and outs[1]["incumbent_s"] > 0
    assert outs[0]["mae_pct_after"] < outs[0]["mae_pct_before"]
    sink = os.path.join(art, "telemetry_tune.jsonl")
    phases = [e["phase"] for e in load_events(sink, strict=True)
              if e["type"] == "search" and e.get("phase") == "promote"]
    assert phases == ["promote", "promote"]


def test_tool_needs_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    r = _tool("--telemetry", str(tmp_path / "none.jsonl"), "--tiny",
              cwd=str(tmp_path))
    assert r.returncode == 2
    assert "--device cpu" in r.stderr and not r.stdout
