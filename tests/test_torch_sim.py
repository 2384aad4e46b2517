"""The port's SOAP core (``dlrm_flexflow_tpu_torch/sim``, the op geometry
of ``ops/``, ``native_lib.py``) against the JAX package's, on the CPU:
op FLOPs, parameter shapes and the input rectangle of every part under
every legal config; the candidate sets and placements; analytic op
costs and simulated step times bit for bit under the same machine
constants (the port's ``H100MachineModel`` given the JAX
``TPUMachineModel``'s values), with overlap and a two-node topology;
the Python search's trajectory, best strategy and time; the native
search's best strategy; the sim CLI's file.  JAX is imported here only.

Every comparison is exact.  The JAX native engine is handed the
library the port builds from the same ``native/ffsim.cpp`` with the same
flags (its module's library cache, restored after each test), so no test
here runs ``make`` inside ``native/``, where the JAX package's own tests
build it.
"""

import dataclasses
import functools
import random
import re
import threading
import warnings

import pytest

import dlrm_flexflow_tpu as ffj
import dlrm_flexflow_tpu.sim.native_sim as jnative
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.ops.base import part_coords as jax_part_coords
from dlrm_flexflow_tpu.ops.base import rect_of_part as jax_rect_of_part
from dlrm_flexflow_tpu.sim import __main__ as jcli
from dlrm_flexflow_tpu.sim import cost_model as jcm
from dlrm_flexflow_tpu.sim import search as jsearch
from dlrm_flexflow_tpu.sim import simulator as jsim
from dlrm_flexflow_tpu.sim.tune import Calibration

import dlrm_flexflow_tpu_torch as fft
import dlrm_flexflow_tpu_torch.native_lib as native_lib
import dlrm_flexflow_tpu_torch.sim.native_sim as pnative
from dlrm_flexflow_tpu_torch import telemetry as tele
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.ops.base import part_coords, rect_of_part
from dlrm_flexflow_tpu_torch.sim import __main__ as pcli
from dlrm_flexflow_tpu_torch.sim import cost_model as pcm
from dlrm_flexflow_tpu_torch.sim import search as psearch
from dlrm_flexflow_tpu_torch.sim import simulator as psim

D = 8
BATCH = 16
DEVICES = (1, 2, 4, 8)

#: small graphs: (tables, bag, interaction, fused, stacked inputs)
GRAPHS = {
    "ragged-cat": ([300, 200, 120], 2, "cat", "off", True),
    "ragged-dot": ([300, 200, 120], 2, "dot", "off", True),
    "stacked-cat": ([256, 256], 1, "cat", "off", True),
    "fused-cat": ([300, 200, 120], 2, "cat", "on", True),
    "fused-dot": ([300, 200], 1, "dot", "on", True),
    "per-table": ([300, 200, 120], 1, "cat", "off", False),
}


@functools.lru_cache(maxsize=None)
def _pair(graph):
    """(JAX model, port model) of one graph, built alike."""
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


def _topologies(two_node):
    if not two_node:
        return None, None
    return jcm.PodTopology(2, 4), pcm.PodTopology(2, 4)


def _machines(two_node=False):
    """The JAX default machine and the port's machine given its values."""
    jt, pt = _topologies(two_node)
    j = jcm.TPUMachineModel(topology=jt)
    p = pcm.H100MachineModel(
        name=j.name, peak_flops_bf16=j.peak_flops_bf16,
        peak_flops_f32=j.peak_flops_f32, hbm_bandwidth=j.hbm_bandwidth,
        hbm_bytes=j.hbm_bytes, nvlink_bandwidth=j.ici_bandwidth,
        nvlink_links_per_gpu=j.ici_links_per_chip,
        ib_bandwidth=j.dcn_bandwidth,
        kernel_launch_overhead=j.kernel_launch_overhead, topology=pt)
    return j, p


def _jax_valued_machine_class():
    """``H100MachineModel`` whose defaults are the JAX machine's values."""
    _, pm = _machines()
    return dataclasses.make_dataclass(
        "H100MachineModel",
        [(f.name, f.type, dataclasses.field(default=getattr(pm, f.name)))
         for f in dataclasses.fields(pm) if f.name != "topology"],
        bases=(pcm.H100MachineModel,))


def _pc(pc):
    return (tuple(pc.dims), pc.device_type,
            None if pc.device_ids is None else list(pc.device_ids))


def _configs(strategy):
    return {k: _pc(v) for k, v in strategy.configs.items()}


def _port_config(pc):
    from dlrm_flexflow_tpu_torch.parallel import ParallelConfig
    return ParallelConfig(dims=pc.dims, device_type=pc.device_type,
                          device_ids=pc.device_ids)


def _random_strategies(j, p, n, topology_pair, count, seed):
    """``count`` random strategies drawn from the JAX candidate sets,
    as (JAX Strategy, port Strategy)."""
    from dlrm_flexflow_tpu.parallel.parallel_config import \
        Strategy as JaxStrategy
    from dlrm_flexflow_tpu_torch.parallel import Strategy
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        js, ps = JaxStrategy(), Strategy()
        for op in j.layers:
            pc = rng.choice(jsearch.legal_configs(
                op, n, topology=topology_pair[0]))
            js[op.name], ps[op.name] = pc, _port_config(pc)
        out.append((js, ps))
    return out


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX native bindings over the port's build of ffsim.cpp."""
    monkeypatch.setattr(jnative, "_LIB", pnative.get_lib())


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_op_geometry_matches_jax(graph):
    """flops at two batches, parameter names and shapes, and the input
    rectangle each part of every legal config reads (every op, every
    input, n = 1-8, flat and on two nodes): equal."""
    j, p = _pair(graph)
    for jo, po in zip(j.layers, p.layers):
        for b in (1, BATCH):
            assert po.flops(b) == jo.flops(b), po.name
        assert [(s.param_name, tuple(s.shape)) for s in po.param_specs()] \
            == [(s.param_name, tuple(s.shape)) for s in jo.param_specs()]
        assert po.parallel_config is None
        for n in DEVICES:
            for two_node in (False, True):
                jt, pt = _topologies(two_node and n == 8)
                jc = jsearch.legal_configs(jo, n, topology=jt)
                pc = psearch.legal_configs(po, n, topology=pt)
                assert [_pc(c) for c in pc] == [_pc(c) for c in jc]
                for c in jc:
                    shape = po.outputs[0].shape
                    for part in range(c.num_parts):
                        assert part_coords(c, len(shape), part) == \
                            jax_part_coords(c, len(shape), part)
                        assert rect_of_part(c, shape, part) == \
                            jax_rect_of_part(c, shape, part)
                        for i in range(len(po.inputs)):
                            assert po.input_rect(c, i, part) == \
                                jo.input_rect(c, i, part), (po.name, c, i)


@pytest.mark.parametrize("two_node", [False, True])
def test_placements_and_data_parallel_match_jax(two_node):
    """placement_variants for every part count, and data_parallel_strategy
    of every graph, for n = 1-8: equal."""
    jt, pt = _topologies(two_node)
    for n in DEVICES:
        for parts in range(1, n + 2):
            assert psearch.placement_variants(parts, n, pt) == \
                jsearch.placement_variants(parts, n, jt)
        for graph in GRAPHS:
            j, p = _pair(graph)
            assert _configs(psearch.data_parallel_strategy(p, n)) == \
                _configs(jsearch.data_parallel_strategy(j, n))


# ------------------------------------------------------- costs, simulation
@pytest.mark.parametrize("two_node", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("graph", ["ragged-dot", "fused-cat", "per-table"])
def test_analytic_costs_and_simulation_are_bit_equal(graph, overlap,
                                                     two_node):
    """Under the same constants: every op's analytic (forward, backward)
    at every part count, and the simulated step of the data-parallel and
    of random strategies at n = 4 and 8, with and without overlapped
    weight sync, flat and on 2 nodes of 4: equal to the bit."""
    j, p = _pair(graph)
    jm, pm = _machines(two_node=two_node)
    jc, pc = jcm.CostModel(machine=jm), pcm.CostModel(machine=pm)
    for jo, po in zip(j.layers, p.layers):
        for parts in (1, 2, 4, 8):
            assert pc.op_times(po, parts) == jc.op_times(jo, parts)
    for n in (4, 8):
        tpair = _topologies(two_node and n == 8)
        js = jsim.Simulator(j, n, jc, overlap_backward_update=overlap)
        ps = psim.Simulator(p, n, pc, overlap_backward_update=overlap)
        pairs = [(jsearch.data_parallel_strategy(j, n),
                  psearch.data_parallel_strategy(p, n))]
        pairs += _random_strategies(j, p, n, tpair, 6, seed=n)
        for jst, pst in pairs:
            assert ps.simulate(pst) == js.simulate(jst)


def test_machine_formulas_are_bit_equal():
    """Every transfer and collective formula of the machine models, flat
    and on two nodes, with and without the participants' ids."""
    for two_node in (False, True):
        jm, pm = _machines(two_node=two_node)
        for nbytes in (1.0, 4096.0, 3.7e8):
            assert pm.matmul_time(nbytes, "bfloat16") == \
                jm.matmul_time(nbytes, "bfloat16")
            assert pm.matmul_time(nbytes, "float32") == \
                jm.matmul_time(nbytes, "float32")
            assert pm.memory_time(nbytes) == jm.memory_time(nbytes)
            assert pm.ici_time(nbytes, 3) == jm.ici_time(nbytes, 3)
            assert pm.dcn_time(nbytes) == jm.dcn_time(nbytes)
            for src, dst in ((0, 1), (1, 6), (None, 5)):
                assert pm.xfer_time(nbytes, src, dst) == \
                    jm.xfer_time(nbytes, src, dst)
            for n, devs in ((1, None), (4, None), (8, None),
                            (4, [0, 1, 4, 5]), (3, [2, 6, 7])):
                for f in ("all_reduce_time", "all_gather_time",
                          "all_to_all_time"):
                    assert getattr(pm, f)(nbytes, n, devs) == \
                        getattr(jm, f)(nbytes, n, devs), (f, n, devs)


def test_calibrated_costs_match_jax():
    """A calibration's per-class scales on the analytic estimates (the
    JAX ``Calibration``, which the port's CostModel takes as it is)."""
    j, p = _pair("ragged-cat")
    cal = Calibration(scales={"Linear": (1.5, 0.75),
                              "RaggedStackedEmbedding": (2.0, 3.0)})
    jm, pm = _machines()
    jc = jcm.CostModel(machine=jm, calibration=cal)
    pc = pcm.CostModel(machine=pm, calibration=cal)
    for jo, po in zip(j.layers, p.layers):
        assert pc.op_times(po, 2) == jc.op_times(jo, 2)


def test_h100_constants_are_the_data_sheets():
    """The defaults are the H100 SXM5 data sheet's (and the f32 peak is
    the FP64 tensor-core rate the port's f64 Linear layers run at, not
    TF32's); the launch overhead is the card's empty kernel."""
    m = pcm.H100MachineModel()
    assert (m.peak_flops_bf16, m.peak_flops_f32, m.hbm_bandwidth,
            m.hbm_bytes) == (989e12, 67e12, 3.35e12, 80e9)
    assert (m.nvlink_bandwidth, m.nvlink_links_per_gpu,
            m.ib_bandwidth) == (450e9, 18, 50e9)
    assert 0.82e-6 <= m.kernel_launch_overhead <= 1.03e-6
    assert pcm.CostModel().machine == m


def test_measuring_off_the_card_falls_back_loudly():
    """``measure=True`` without a card warns and prices the op
    analytically, once per key (memoized)."""
    _, p = _pair("ragged-cat")
    op = p.layers[0]
    cm = pcm.CostModel(measure=True)
    with pytest.warns(RuntimeWarning, match="measured cost for bot_0"):
        got = cm.op_times(op, 1)
    assert got == pcm.CostModel().op_times(op, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cm.op_times(op, 1) == got


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("graph,n,two_node", [
    ("ragged-dot", 4, False), ("fused-cat", 8, False),
    ("per-table", 8, True)])
def test_python_search_matches_jax(graph, n, two_node, seed):
    """``mcmc_search(backend="python")`` on the same costs: the same
    on_iteration sequence, the same best strategy and best time."""
    j, p = _pair(graph)
    jm, pm = _machines(two_node=two_node)
    jt, pt = _topologies(two_node)
    trail = {"jax": [], "port": []}
    jbest = jsearch.mcmc_search(
        j, n, budget=150, seed=seed, backend="python", topology=jt,
        simulator=jsim.Simulator(j, n, jcm.CostModel(machine=jm)),
        on_iteration=lambda *a: trail["jax"].append(a))
    pbest = psearch.mcmc_search(
        p, n, budget=150, seed=seed, backend="python", topology=pt,
        simulator=psim.Simulator(p, n, pcm.CostModel(machine=pm)),
        on_iteration=lambda *a: trail["port"].append(a))
    assert trail["port"] == trail["jax"] and len(trail["jax"]) == 150
    assert _configs(pbest) == _configs(jbest)
    assert pbest.best_simulated_time == jbest.best_simulated_time


@pytest.mark.parametrize("graph,n", [("ragged-cat", 4), ("fused-dot", 8),
                                     ("per-table", 8)])
def test_native_search_matches_jax(graph, n, jax_native):
    """``backend="native"``: the same best strategy as the JAX package's
    native chain, and the native engine prices it as the Python
    simulator does."""
    j, p = _pair(graph)
    jm, pm = _machines()
    jbest = jsearch.mcmc_search(
        j, n, budget=200, seed=1, backend="native",
        simulator=jsim.Simulator(j, n, jcm.CostModel(machine=jm)))
    psim_ = psim.Simulator(p, n, pcm.CostModel(machine=pm))
    pbest = psearch.mcmc_search(p, n, budget=200, seed=1, backend="native",
                                simulator=psim_)
    assert _configs(pbest) == _configs(jbest)
    assert pbest.best_simulated_time == pytest.approx(
        psim_.simulate(pbest), rel=1e-12)


def test_search_events_validate_against_the_schema():
    """The search's telemetry (one event per proposal, the summary, and
    calibrate's sim-against-measured event) validates against the
    schema, for both backends."""
    _, p = _pair("ragged-cat")
    with tele.event_log() as log:
        psearch.mcmc_search(p, 4, budget=20, backend="python")
        psearch.mcmc_search(p, 4, budget=20, backend="native")
        sim = psim.Simulator(p, 4)
        scale = sim.calibrate(psearch.data_parallel_strategy(p, 4), 2e-3)
    events = log.events("search")
    phases = [e["phase"] for e in events]
    assert phases == ["iteration"] * 20 + ["summary", "summary",
                                           "calibrate"]
    assert [e["backend"] for e in events if e["phase"] == "summary"] == \
        ["python", "native"]
    for e in events:
        assert tele.validate_event(e) == [], e
    assert sim.simulate(psearch.data_parallel_strategy(p, 4)) == \
        pytest.approx(2e-3, rel=1e-12) and scale > 0


# --------------------------------------------------------------------- CLI
def test_sim_cli_writes_the_jax_file(tmp_path, jax_native, capsys,
                                    monkeypatch):
    """``python -m dlrm_flexflow_tpu_torch.sim --app dlrm --devices 8
    --budget 200`` writes the JAX CLI's file byte for byte when the port's
    machine model carries the JAX machine's values as its defaults; on its
    own H100 constants it writes a strategy no slower than data-parallel."""
    argv = ["--app", "dlrm", "--devices", "8", "--budget", "200"]
    assert jcli.main(argv + ["--export", str(tmp_path / "j.json")]) == 0
    with monkeypatch.context() as m:
        m.setattr(pcm, "H100MachineModel", _jax_valued_machine_class())
        assert pcli.main(argv + ["--export", str(tmp_path / "p.json")]) == 0
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert pcli.main(argv + ["--export", str(tmp_path / "h.pb")]) == 0
    out = capsys.readouterr().out
    dp, best = [float(x) for x in re.findall(
        r"(\d+\.\d+) ms/iter", out.split("dlrm: 10 ops")[-1])]
    assert 0 < best <= dp
    from dlrm_flexflow_tpu_torch.parallel import Strategy
    assert len(Strategy.load(str(tmp_path / "h.pb")).configs) == 10
    # the other apps simulate too (tests/test_torch_sim_apps.py holds
    # their files against the JAX CLI's)
    assert pcli.main(["--app", "resnet", "--budget", "10"]) == 0


# -------------------------------------------------------------- native lib
def test_native_lib_builds_with_the_makefile_flags():
    """The port compiles native/ffsim.cpp with the Makefile's CXXFLAGS and
    LDFLAGS, so its results equal the JAX package's build."""
    text = (native_lib.NATIVE_DIR / "Makefile").read_text()
    want = {k: tuple(v.split()) for k, v in re.findall(
        r"^(CXXFLAGS|LDFLAGS) \?= (.*)$", text, re.M)}
    assert want == {"CXXFLAGS": native_lib.CXX_FLAGS,
                    "LDFLAGS": native_lib.LD_FLAGS}
    cxx = native_lib.compilers()[0]
    assert native_lib.library_path("ffsim.cpp", cxx).parent == \
        native_lib.BUILD_DIR


def test_native_lib_builds_once_under_concurrent_loads(tmp_path,
                                                       monkeypatch):
    """Three loaders at once into an empty build directory: one build,
    every loader gets the library, no partial file left."""
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path)
    libs, errors = [], []

    def load():
        try:
            libs.append(native_lib.load_native_lib("libffsim.so",
                                                   "ffsim.cpp"))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(libs) == 3
    built = sorted(p.name for p in tmp_path.iterdir()
                   if not p.name.startswith("."))
    assert built == [native_lib.library_path(
        "ffsim.cpp", native_lib.compilers()[0]).name]
    assert all(hasattr(lib, "ffsim_search") for lib in libs)


def _fake_cxx(tmp_path, name, body):
    """A ``g++`` wrapper that runs ``body`` (shell) before handing over."""
    cxx = tmp_path / name
    cxx.write_text(f'#!/bin/sh\n{body}\nexec g++ "$@"\n')
    cxx.chmod(0o755)
    return str(cxx)


def test_native_lib_falls_back_past_a_failing_compiler(tmp_path,
                                                        monkeypatch):
    """A ``$CXX`` without OpenMP's runtime (its driver stops on
    ``-fopenmp``) is passed over for ``g++``; when none builds, the error
    carries each compiler's output."""
    bad = _fake_cxx(tmp_path, "bad-cxx", (
        'case " $* " in *" -fopenmp "*) echo "g++: fatal error: cannot '
        "read spec file 'libgomp.spec'\" >&2; exit 1;; esac"))
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", bad)
    assert native_lib.compilers()[0] == bad
    lib = native_lib.load_native_lib("libffsim.so", "ffsim.cpp")
    assert hasattr(lib, "ffsim_create")
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build2")
    monkeypatch.setattr(native_lib, "compilers", lambda: [bad])
    with pytest.raises(OSError, match="libgomp.spec"):
        native_lib.load_native_lib("libffsim.so", "ffsim.cpp")
    assert not any((tmp_path / "build2").glob("*.tmp"))


def test_native_lib_is_named_by_its_compiler_and_target(tmp_path):
    """Another compiler version, or another target for ``-march=native``,
    names another library: a build is reused only where it was made."""
    gxx = native_lib.compilers()[-1]
    ident = native_lib.compiler_identity(gxx)
    assert "-march=" in ident and "-mtune=" in ident
    other_version = _fake_cxx(tmp_path, "v-cxx", (
        'if [ "$1" = --version ]; then echo "g++ 99.0"; exit 0; fi'))
    other_target = _fake_cxx(tmp_path, "t-cxx", (
        'if [ "$1" = -### ]; then g++ "$@" 2>&1 | '
        "sed 's/-march=[a-z0-9-]*/-march=x86-64/' >&2; exit 0; fi"))
    names = {native_lib.library_path("ffsim.cpp", c).name
             for c in (gxx, other_version, other_target)}
    assert len(names) == 3
