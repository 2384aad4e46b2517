"""The port's strategies (``dlrm_flexflow_tpu_torch/parallel``) and
``compile(strategy=)`` against the JAX package, on the CPU: ``.json`` and
reference ``.pb`` strategy files byte for byte from both packages
(data-parallel, the DLRM generators stacked, per-table and hetero, and
random strategies), each package loading the other's; the search-tune
artifact through its validator; the SOAP flags; and on one device a
strategy (given, imported or searched at compile) that changes no value,
three steps bit for bit against the same model compiled without one.
JAX is imported here only.
"""

import json
import random

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.parallel import parallel_config as jpc
from dlrm_flexflow_tpu.parallel import strategy_pb as jpb
from dlrm_flexflow_tpu.sim import search as jsearch

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import telemetry as tele
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.apps.dlrm import run as cli_run
from dlrm_flexflow_tpu_torch.parallel import parallel_config as ppc
from dlrm_flexflow_tpu_torch.parallel import strategy_pb as ppb
from dlrm_flexflow_tpu_torch.sim import search as psearch

D = 8
BATCH = 16
TABLES = [300, 200, 120]


def _kw(interact="cat", fused="off"):
    t = len(TABLES)
    top0 = D + t * D if interact == "cat" else D + (t + 1) ** 2
    return dict(sparse_feature_size=D, embedding_size=list(TABLES),
                mlp_bot=[13, 16, D], mlp_top=[top0, 16, 1],
                arch_interaction_op=interact, fused_interaction=fused)


def _port_model(interact="cat", fused="off", stacked=True, **config):
    return build_dlrm(DLRMConfig(**_kw(interact, fused)),
                      fft.FFConfig(batch_size=BATCH, **config),
                      stacked_embeddings=stacked)


def _jax_model(interact="cat", fused="off", stacked=True):
    return jax_build_dlrm(JaxDLRMConfig(**_kw(interact, fused)),
                          ffj.FFConfig(batch_size=BATCH),
                          stacked_embeddings=stacked)


def _configs(strategy):
    return {k: (tuple(v.dims), v.device_type,
                None if v.device_ids is None else list(v.device_ids))
            for k, v in strategy.configs.items()}


def _both(make):
    """``make(module namespace)`` for the JAX and the port modules."""
    return (make(jpc, jpb, jsearch, _jax_model),
            make(ppc, ppb, psearch, _port_model))


def _random(pc_mod, search, build, n, seed, stacked=True):
    model = build(stacked=stacked)
    rng = random.Random(seed)
    s = pc_mod.Strategy()
    for op in model.layers:
        s[op.name] = rng.choice(search.legal_configs(op, n))
    if seed % 2:  # a hetero placement and a config without device ids
        op = model.layers[0].name
        s[op] = pc_mod.ParallelConfig(dims=s[op].dims, device_type="cpu")
    return s


STRATEGIES = {
    **{f"data-parallel-{n}": (
        lambda n: lambda pc, pb, search, build:
        search.data_parallel_strategy(build(), n))(n) for n in (1, 3, 8)},
    **{f"dlrm-{kind}-{t}x{n}": (
        lambda t, n, kw: lambda pc, pb, search, build:
        pb.dlrm_strategy(t, n, **kw))(t, n, kw)
       for kind, kw in (("stacked", {}),
                        ("per-table", {"stacked": False}),
                        ("hetero", {"hetero_cpu_embeddings": True,
                                    "stacked": False}))
       for t, n in ((8, 8), (16, 8), (8, 16), (3, 2))},
    **{f"random-{seed}": (
        lambda seed: lambda pc, pb, search, build:
        _random(pc, search, build, 8, seed, stacked=seed < 3))(seed)
       for seed in range(5)},
}


@pytest.mark.parametrize("ext", [".json", ".pb"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_files_are_byte_equal_and_cross_load(name, ext, tmp_path):
    """The same strategy saved by both packages gives the same bytes, and
    each package loads the other's file to the same configs."""
    js, ps = _both(STRATEGIES[name])
    assert _configs(ps) == _configs(js)
    jpath, ppath = tmp_path / f"j{ext}", tmp_path / f"p{ext}"
    js.save(str(jpath))
    ps.save(str(ppath))
    assert ppath.read_bytes() == jpath.read_bytes()
    assert _configs(ppc.Strategy.load(str(jpath))) == \
        _configs(jpc.Strategy.load(str(ppath)))
    assert _configs(ppc.Strategy.load(str(jpath))) == _configs(ps)


def test_reference_pb_reads_packed_dims_innermost_first(tmp_path):
    """A reference-written op: packed dims and ids (wire type 2),
    innermost-first dims, memory types; both packages decode it alike,
    batch-first."""
    def varint(n):
        return jpb._encode_varint(n)

    packed = bytes([4, 2, 1])
    op = (jpb._tag(1, 2) + varint(3) + b"emb" + jpb._tag(2, 0) + varint(1)
          + jpb._tag(3, 2) + varint(len(packed)) + packed
          + jpb._tag(4, 2) + varint(2) + bytes([5, 6])
          + jpb._tag(5, 0) + varint(1))
    path = tmp_path / "ref.pb"
    path.write_bytes(jpb._tag(1, 2) + varint(len(op)) + op)
    got = ppb.load_strategy_pb(str(path))
    assert _configs(got) == _configs(jpb.load_strategy_pb(str(path))) == \
        {"emb": ((1, 2, 4), "cpu", [5, 6])}


def test_parallel_config_and_find_match_jax():
    for ndim, n in ((1, 1), (2, 4), (3, 8)):
        a = ppc.ParallelConfig.data_parallel(ndim, n)
        b = jpc.ParallelConfig.data_parallel(ndim, n)
        assert (a.dims, a.device_ids, a.num_parts) == \
            (b.dims, b.device_ids, b.num_parts)
    a = ppc.ParallelConfig.from_reference_dims([2, 1, 4], device_type="cpu")
    assert a.to_json() == \
        jpc.ParallelConfig.from_reference_dims([2, 1, 4],
                                               device_type="cpu").to_json()
    s = ppc.Strategy({"x": a})
    assert s.find("x", 3, 8) is a and "x" in s and s["x"] is a
    assert s.find("y", 2, 4).to_json() == \
        jpc.Strategy().find("y", 2, 4).to_json()
    with pytest.raises(AssertionError):
        ppc.ParallelConfig(device_type="gpu")


def _artifact(ops):
    return {"schema": 1, "kind": "strategy", "version": 3,
            "created_ts": 1.5, "app": "dlrm", "num_devices": 8,
            "sim_step_s": 0.002, "strategy": {"ops": ops},
            "provenance": {"telemetry": None, "calibration": None,
                           "parent_version": 2, "seed": 0, "budget": 200,
                           "mae_pct_before": 10.0, "mae_pct_after": 2.0}}


def test_strategy_artifact_loads_through_the_validator(tmp_path):
    """A search-tune strategy artifact loads as its strategy; a doctored
    one is refused with the JAX package's message."""
    ops = [{"name": "bot_0", "dims": [8, 1], "device_type": "tpu",
            "device_ids": list(range(8))}]
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_artifact(ops)))
    assert _configs(ppc.Strategy.load(str(good))) == \
        _configs(jpc.Strategy.load(str(good)))
    doc = _artifact(ops + [{"dims": [2]}])
    doc["schema"] = 9
    doc["extra"] = 1
    doc["provenance"]["seed"] = "0"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(ValueError) as pe:
        ppc.Strategy.load(str(bad))
    with pytest.raises(ValueError) as je:
        jpc.Strategy.load(str(bad))
    assert str(pe.value) == str(je.value)
    assert "unsupported" in str(pe.value)


# ----------------------------------------------------------------- flags
@pytest.mark.parametrize("argv", [
    ["--budget", "7", "--alpha", "0.5", "--import", "a.json",
     "--export", "b.pb", "--overlap", "-d", "4"],
    ["--search-budget", "3", "--search-alpha", "0.25", "--devices", "2"],
    ["-ll:gpu", "8", "-b", "32"],
    [],
])
def test_soap_flags_parse_as_in_jax(argv):
    got, want = fft.FFConfig.parse_args(argv), JaxFFConfig.parse_args(argv)
    for field in ("num_devices", "search_budget", "search_alpha",
                  "search_overlap_backward_update", "import_strategy_file",
                  "export_strategy_file", "batch_size"):
        assert getattr(got, field) == getattr(want, field), field
    with pytest.raises(TypeError):  # keyword-only, as every later field
        fft.FFConfig(1, 64, None)


def test_resolved_num_devices():
    assert fft.FFConfig(num_devices=6).resolved_num_devices() == 6
    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert fft.FFConfig().resolved_num_devices() == want


# ------------------------------------------------------- compile(strategy=)
def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, 90, size=(BATCH, 1)) for _ in TABLES],
                   axis=1).astype(np.int64)
    return ({"dense": rng.standard_normal((BATCH, 13)).astype(np.float32),
             "sparse": ids},
            rng.integers(0, 2, size=(BATCH, 1)).astype(np.float32))


def _steps(model, steps=3):
    state = model.init(seed=0, device="cpu")
    before = {f"{o}/{k}": v.clone() for o, ps in state.params.items()
              for k, v in ps.items()}
    losses = []
    for i in range(steps):
        state, mets = model.train_step(state, *_batch(i))
        losses.append(mets["loss"])
    return before, state, losses


def _same(a, b):
    (pa, sa, la), (pb, sb, lb) = a, b
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for op in sa.params:
        for k, v in sa.params[op].items():
            assert torch.equal(v, sb.params[op][k]), (op, k)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _compiled(strategy=None, interact="cat", fused="off", **config):
    model = _port_model(interact, fused, **config)
    return model.compile(fft.SGDOptimizer(lr=0.1), "mean_squared_error",
                         ("accuracy",), None, strategy)


@pytest.mark.parametrize("interact,fused", [("cat", "off"), ("dot", "off"),
                                            ("cat", "on")])
def test_compile_with_a_strategy_changes_no_value_on_one_device(interact,
                                                                fused):
    """``compile(optimizer, loss, metrics, mesh, strategy)``: every op of
    an 8-device searched strategy gets its config, and the parameters and
    three steps equal the model compiled without a strategy bit for
    bit."""
    model = _port_model(interact, fused)
    best = psearch.mcmc_search(model, 8, budget=60, seed=2,
                               backend="python")
    with_s = _compiled(best, interact, fused)
    assert with_s.strategy is best
    assert all(op.parallel_config is best[op.name] for op in with_s.layers)
    plain = _compiled(None, interact, fused)
    assert plain.strategy.configs == {}
    assert all(op.parallel_config is None for op in plain.layers)
    _same(_steps(with_s), _steps(plain))


def test_import_export_and_search_at_compile(tmp_path):
    """``search_budget > 0`` searches at compile over ``num_devices`` and
    exports; ``import_strategy_file`` loads it back into another model;
    both train bit for bit as the model without a strategy; the search
    events validate."""
    out = tmp_path / "s.pb"
    with tele.event_log() as log:
        searched = _compiled(num_devices=4, search_budget=40,
                             export_strategy_file=str(out))
    assert out.exists() and set(searched.strategy.configs) == \
        {op.name for op in searched.layers}
    assert max(pc.num_parts for pc in searched.strategy.configs.values()) \
        <= 4
    events = log.events("search")
    assert events and all(tele.validate_event(e) == [] for e in events)
    imported = _compiled(import_strategy_file=str(out))
    assert {k: v.dims for k, v in imported.strategy.configs.items()} == \
        {k: v.dims for k, v in searched.strategy.configs.items()}
    plain = _steps(_compiled())
    _same(_steps(imported), plain)
    _same(_steps(searched), plain)


def test_cpu_placement_raises_naming_hetero(tmp_path):
    """A hetero strategy (tables in host memory) used to be refused at
    compile; it is honoured now, as in the JAX package: given on the
    per-table graph it places every table on the host, imported for the
    stacked graph (whose op has no placement) it places none, and the
    CLI's ``--import`` of it compiles and goes on to place the model on
    the card (here, without one, that raises)."""
    hetero = ppb.dlrm_strategy(len(TABLES), 2, hetero_cpu_embeddings=True,
                               stacked=False)
    model = _port_model(stacked=False)
    model.compile(strategy=hetero)
    assert [op.name for op in model._hetero_ops] == \
        [f"emb_{i}" for i in range(len(TABLES))]
    jm = _jax_model(stacked=False)
    jm.compile(strategy=jpb.dlrm_strategy(len(TABLES), 2,
                                          hetero_cpu_embeddings=True,
                                          stacked=False), mesh=False)
    assert [op.name for op in jm._hetero_ops] == \
        [op.name for op in model._hetero_ops]
    path = tmp_path / "hetero.json"
    ppb.dlrm_strategy(len(TABLES), 2, hetero_cpu_embeddings=True).save(
        str(path))
    assert _compiled(import_strategy_file=str(path))._hetero_ops == []
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_run(["--import", str(path), "-b", "16",
                 "--arch-embedding-size", "300-200-120",
                 "--arch-sparse-feature-size", "8",
                 "--arch-mlp-bot", "13-16-8", "--arch-mlp-top", "32-16-1"])
