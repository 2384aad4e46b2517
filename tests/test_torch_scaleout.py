"""The port's scale-out, part 2, the rest that one card can check:
host-placed (hetero) tables under a mesh of ranks (``ops/hetero.py::
HostComm``, ``parallel/spmd.py``, ``model.py``, ``checkpoint.py``,
``serving/engine.py``), quantized serving under a mesh of ranks
(``serving/engine.py``, ``parallel/spmd.py::_rank_scale``) and
``tools/search_tune.py --pod``, against the JAX package on the 8-device
virtual CPU platform.

The port's ranks are gloo processes (``distributed.launch``, rank bodies
in ``tests/torch_scaleout_ranks.py``, which import no JAX): one group of
2 ranks and one of 4, launched together by one module fixture.  The JAX
references run here, each on a JAX mesh, from the same weights; the JAX
hetero callbacks take their numpy branches.  Tolerances: host tables,
handles and parameters within 1e-6, losses rtol 1e-5, the hetero and
quantized engines within 1e-6 of JAX's engine (JAX's own mesh engine is
within 6e-8 of its one-device engine), checkpoints bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jbuild_dlrm
from dlrm_flexflow_tpu.data import native as jnative
from dlrm_flexflow_tpu.parallel import mesh as jmesh
from dlrm_flexflow_tpu.parallel import parallel_config as jpc
from dlrm_flexflow_tpu.serving import InferenceEngine as JEngine
from dlrm_flexflow_tpu.sim import search as jsearch
from dlrm_flexflow_tpu.sim import tune as jtune
from dlrm_flexflow_tpu.sim.cost_model import PodTopology as JPod
from dlrm_flexflow_tpu.telemetry import metrics as jmetrics

from dlrm_flexflow_tpu_torch import distributed as fdist
from dlrm_flexflow_tpu_torch.checkpoint import restore_checkpoint
from dlrm_flexflow_tpu_torch.sim import search as psearch
from dlrm_flexflow_tpu_torch.sim import tune as ptune
from dlrm_flexflow_tpu_torch.sim.cost_model import PodTopology

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
import torch_scaleout_ranks as ranks  # noqa: E402

TOL = 1e-6
SIZES = [1, 3, 8, 11]   # the served requests' rows
HETERO2 = [("d2", {"data": 2}, [0, 1]), ("mixed", {"data": 2}, [0])]
HETERO4 = [("d2m2", {"data": 2, "model": 2}, [0, 1])]
QUANT2 = [("q12_int8", {"data": 1, "model": 2}, "int8", "off"),
          ("q12_bf16", {"data": 1, "model": 2}, "bf16", "off"),
          ("x12_int8", {"data": 1, "model": 2}, "int8", "allgather")]
QUANT4 = [("q22_int8", {"data": 2, "model": 2}, "int8", "off"),
          ("q22_bf16", {"data": 2, "model": 2}, "bf16", "off")]


# ----------------------------------------------------------- the JAX side
def jax_hetero(mesh, cpu=(0, 1)):
    cfg = JDLRMConfig(sparse_feature_size=ranks.D,
                      embedding_size=list(ranks.TABLES),
                      embedding_bag_size=ranks.BAG, mlp_bot=[4, 8, ranks.D],
                      mlp_top=[ranks.D * 3, 8, 1])
    m = jbuild_dlrm(cfg, ffj.FFConfig(batch_size=ranks.BATCH,
                                      serve_buckets="8"),
                    stacked_embeddings=False)
    s = ffj.Strategy()
    for i in cpu:
        s[f"emb_{i}"] = jpc.ParallelConfig(dims=(1, 1), device_type="cpu",
                                           device_ids=[0])
    m.compile(optimizer=ffj.SGDOptimizer(lr=ranks.LR),
              loss_type="mean_squared_error", metrics=(), strategy=s,
              mesh=jmesh.make_mesh(mesh) if mesh else False)
    return m


def jax_quant(mesh):
    cfg = JDLRMConfig(sparse_feature_size=ranks.D,
                      embedding_size=[ranks.QROWS] * ranks.QTABLES,
                      embedding_bag_size=ranks.BAG, mlp_bot=[4, 16, ranks.D],
                      mlp_top=[ranks.D * ranks.QTABLES + ranks.D, 16, 1])
    m = jbuild_dlrm(cfg, ffj.FFConfig(batch_size=32, serve_buckets="1,8"),
                    table_parallel=True)
    m.compile(optimizer=ffj.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=(),
              mesh=jmesh.make_mesh(mesh) if mesh else False)
    return m


def np_tree(t):
    return {op: {k: np.array(v) for k, v in d.items()}
            for op, d in t.items()}


def tables_of(m):
    return {op.name: np.array(op.host_table.array) for op in m._hetero_ops}


def _data():
    rng = np.random.default_rng(1)
    t, b = ranks.STEPS, ranks.BATCH
    d = {"dense": rng.standard_normal((t, b, 4)).astype(np.float32),
         "labels": rng.integers(0, 2, size=(t, b, 1)).astype(np.float32),
         "sizes": np.array(SIZES)}
    for i, rows in enumerate(ranks.TABLES):
        d[f"sparse_{i}"] = rng.integers(0, rows, size=(t, b, ranks.BAG),
                                        dtype=np.int64)
    n = sum(SIZES)
    d["req/dense"] = rng.standard_normal((n, 4)).astype(np.float32)
    for i, rows in enumerate(ranks.TABLES):
        d[f"req/sparse_{i}"] = rng.integers(0, rows, size=(n, ranks.BAG),
                                            dtype=np.int64)
    d["qreq/dense"] = rng.standard_normal((n, 4)).astype(np.float32)
    d["qreq/sparse"] = rng.integers(
        0, ranks.QROWS, size=(n, ranks.QTABLES, ranks.BAG)).astype(np.int32)
    return d


def _requests(d, prefix, names):
    return ranks.requests(d, prefix, names)


class _Group(threading.Thread):
    """One rank group launched in the background: its error, if any, is
    raised by ``join_ok``."""

    def __init__(self, world, **kwargs):
        super().__init__(daemon=True)
        self.world, self.kwargs = world, kwargs
        self.err = None

    def run(self):
        try:
            fdist.launch("torch_scaleout_ranks:run_group", self.world,
                         kwargs=self.kwargs, device="cpu", timeout_s=240,
                         pythonpath=[TESTS])
        except BaseException as e:  # noqa: BLE001 — re-raised by join_ok
            self.err = e

    def join_ok(self):
        self.join()
        if self.err is not None:
            raise self.err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups and every JAX reference of this file, once."""
    tmp = tmp_path_factory.mktemp("scaleout")
    d = _data()
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "native_available", lambda: False)
        # the JAX engines stay out of the JAX package's process-wide
        # metrics registry, which its own tests read exactly
        mp.setattr(jmetrics, "track_engine", lambda engine: None)
        for tag, shape, cpu in HETERO2 + HETERO4:
            jm = jax_hetero(shape, tuple(cpu))
            st = jm.init(seed=0)
            d.update({f"{tag}/p/{op}/{k}": v for op, dd in
                      np_tree(st.params).items() for k, v in dd.items()})
            d.update({f"{tag}/t/{k}": v for k, v in tables_of(jm).items()})
            losses = []
            for t in range(ranks.STEPS):
                x, y = ranks.batch(d, t)
                st, mets = jm.train_step(st, x, y)
                losses.append(float(mets["loss"]))
            ref[tag] = {"losses": losses, "params": np_tree(st.params),
                        "tables": tables_of(jm),
                        "forward": np.asarray(jm.forward(
                            st, ranks.batch(d, 0)[0]))}
            if tag == "d2":
                eng = JEngine(jm, st)
                ref[tag]["serve"] = [np.asarray(eng.predict(r)) for r in
                                     _requests(d, "req/", ["dense",
                                                           "sparse_0",
                                                           "sparse_1"])]
        jq = jax_quant({"data": 2, "model": 4})
        st = jq.init(seed=0)
        d.update({f"q/p/{op}/{k}": v for op, dd in np_tree(st.params).items()
                  for k, v in dd.items()})
        qreqs = _requests(d, "qreq/", ["dense", "sparse"])
        for mode in ("int8", "bf16"):
            eng = JEngine(jq, st, quantize=mode)
            ref[mode] = {"out": [np.asarray(eng.predict(r)) for r in qreqs],
                         "bytes": (eng.quantization["bytes_before"],
                                   eng.quantization["bytes_after"])}
    data = str(tmp / "data.npz")
    np.savez(data, **d)
    ckpt = str(tmp / "ckpt")
    g2 = _Group(2, hetero_kw=dict(data=data, cases=HETERO2,
                                  out=str(tmp / "g2"), ckpt=ckpt),
                quant_kw=dict(data=data, cases=QUANT2, out=str(tmp / "q2")))
    g4 = _Group(4, hetero_kw=dict(data=data, cases=HETERO4,
                                  out=str(tmp / "g4")),
                quant_kw=dict(data=data, cases=QUANT4, out=str(tmp / "q4")))
    g2.start()
    g4.start()
    g2.join_ok()
    g4.join_ok()
    return {"tmp": tmp, "ref": ref, "data": d, "ckpt": ckpt}


def _rank(runs, prefix, r):
    return np.load(runs["tmp"] / f"{prefix}.rank{r}.npz")


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, (what, err)


# ------------------------------------------------------------ hetero steps
@pytest.mark.parametrize("tag,prefix,world", [
    ("d2", "g2", 2), ("mixed", "g2", 2), ("d2m2", "g4", 4)])
def test_hetero_steps_under_a_mesh_match_jax(runs, tag, prefix, world):
    """Three steps from the JAX weights and tables: the losses within
    rtol 1e-5, every parameter (the handles included), the owner's host
    tables and the stepped model's forward within 1e-6 of JAX's mesh
    run, the same on every rank."""
    want = runs["ref"][tag]
    lead = _rank(runs, prefix, 0)
    np.testing.assert_allclose(lead[f"{tag}/losses"], want["losses"],
                               rtol=1e-5, atol=0)
    for op, dd in want["params"].items():
        for k, v in dd.items():
            _close(lead[f"{tag}/p/{op}/{k}"], v, f"{tag} {op}/{k}")
    assert set(want["tables"]) == {k.split("/")[-1] for k in lead.files
                                   if k.startswith(f"{tag}/t/")}
    for op, v in want["tables"].items():
        _close(lead[f"{tag}/t/{op}"], v, f"{tag} host table {op}")
    _close(lead[f"{tag}/forward"], want["forward"], f"{tag} forward")
    for r in range(1, world):
        other = _rank(runs, prefix, r)
        np.testing.assert_array_equal(other[f"{tag}/losses"],
                                      lead[f"{tag}/losses"])
        np.testing.assert_array_equal(other[f"{tag}/forward"],
                                      lead[f"{tag}/forward"])


@pytest.mark.parametrize("tag,prefix,world", [
    ("d2", "g2", 2), ("mixed", "g2", 2), ("d2m2", "g4", 4)])
def test_exactly_one_rank_holds_and_updates_each_host_table(
        runs, tag, prefix, world):
    """The owner (rank 0) holds every host table and applies one host
    update a table a step; every other rank holds no table bytes and
    applies none, and its ids and cotangents reach the owner (the
    gather parts of its wall split are timed)."""
    n_host = len(runs["ref"][tag]["tables"])
    parts = dict(zip(ranks.hetero.PARTS,
                     _rank(runs, prefix, 0)[f"{tag}/parts"]))
    lead = _rank(runs, prefix, 0)
    assert int(lead[f"{tag}/updates"]) == n_host * ranks.STEPS
    assert int(lead[f"{tag}/held_bytes"]) == sum(
        4 * ranks.TABLES[int(op[-1])] * ranks.D
        for op in runs["ref"][tag]["tables"])
    assert parts["lookup"] > 0 and parts["host_grad"] > 0
    assert parts["id_gather"] > 0 and parts["grad_gather"] > 0
    for r in range(1, world):
        other = _rank(runs, prefix, r)
        assert int(other[f"{tag}/updates"]) == 0
        assert int(other[f"{tag}/held_bytes"]) == 0
        assert not any(k.startswith(f"{tag}/t/") for k in other.files)
        p = dict(zip(ranks.hetero.PARTS, other[f"{tag}/parts"]))
        assert p["lookup"] == 0 and p["host_grad"] == 0


def test_hetero_epochs_and_fit_under_a_mesh_equal_the_steps(runs):
    """``train_epochs`` and ``fit`` (batch by batch, the host update after
    each step; no warmup step) from the same start leave the owner's tables bit for bit
    those of the three ``train_step`` calls, and no table elsewhere."""
    lead, other = _rank(runs, "g2", 0), _rank(runs, "g2", 1)
    for how in ("epochs", "fit"):
        for op in ("emb_0", "emb_1"):
            np.testing.assert_array_equal(lead[f"{how}/t/{op}"],
                                          lead[f"d2/t/{op}"])
        assert int(other[f"{how}/held_bytes"]) == 0


# ------------------------------------------------------- hetero checkpoints
def test_hetero_podshard_restores_on_one_process_bit_for_bit(runs):
    """The podshard of the two-rank run: rank 0's shard file alone holds
    the host tables; a restore on one process puts them back bit for bit
    (and the gathered npz holds the same), and the reshard restore onto
    a {"model": 2} mesh puts them on its rank 0 only."""
    pod = os.path.join(runs["ckpt"], "pod")
    lead = _rank(runs, "g2", 0)
    with np.load(os.path.join(pod, "shard-p001.npz")) as f:
        assert not any(k.startswith("host_tables/") for k in f.files)
    with np.load(os.path.join(pod, "shard-p000.npz")) as f:
        assert sorted(k for k in f.files if k.startswith("host_tables/")) \
            == ["host_tables/emb_0", "host_tables/emb_1"]
    m = ranks.hetero_model(False)
    m.init(seed=7, device="cpu")  # tables to be overwritten
    st = restore_checkpoint(pod, m, on_mesh_change="reshard", device="cpu")
    assert int(st.step) == ranks.STEPS
    for op in ("emb_0", "emb_1"):
        got = np.array(m.get_op(op).host_table.array)
        np.testing.assert_array_equal(got, lead[f"d2/t/{op}"])
        np.testing.assert_array_equal(lead[f"restored/t/{op}"],
                                      lead[f"d2/t/{op}"])
        np.testing.assert_array_equal(
            np.load(os.path.join(runs["ckpt"], "npz", "state.npz"))[
                f"host_tables/{op}"], lead[f"d2/t/{op}"])
    assert int(_rank(runs, "g2", 1)["restored/held_bytes"]) == 0


# ------------------------------------------------------------- serving
def test_hetero_mesh_engine_answers_as_jax(runs):
    """The mesh engine (a replica: every parameter replicated) over the
    stepped hetero model: the owner looks each bucket up, rank 0's
    answers within 1e-6 of JAX's engine on the same mesh, and the
    follower served every bucket the leader dispatched."""
    lead = _rank(runs, "g2", 0)
    want = runs["ref"]["d2"]["serve"]
    assert not bool(lead["serve/sharded"])
    assert list(lead["serve/buckets"]) == [8]
    for i, (w, n) in enumerate(zip(want, SIZES)):
        assert lead[f"serve/out{i}"].shape == (n, 1)
        _close(lead[f"serve/out{i}"], w, f"request {i}")
    n_dispatch = 1 + sum(-(-n // 8) for n in SIZES)
    assert int(_rank(runs, "g2", 1)["serve/followed"]) == n_dispatch


@pytest.mark.parametrize("tag,prefix,world", [
    (c[0], "q2", 2) for c in QUANT2] + [(c[0], "q4", 4) for c in QUANT4])
def test_quantized_mesh_engine_matches_jax(runs, tag, prefix, world):
    """A table-parallel engine quantized at load across the ranks: the
    global tables' byte report, the scale column replicated, buckets
    rounded to the data size, and answers within 1e-6 of JAX's engine on
    its 8-device {"data": 2, "model": 4} mesh."""
    mode = tag.split("_")[1]
    want = runs["ref"][mode]
    lead = _rank(runs, prefix, 0)
    data = 2 if tag.startswith("q22") else 1
    assert bool(lead[f"{tag}/sharded"])
    assert list(lead[f"{tag}/buckets"]) == sorted(
        {-(-b // data) * data for b in (1, 8)})
    assert tuple(int(x) for x in lead[f"{tag}/bytes"]) == want["bytes"]
    for r in range(world):
        assert bool(_rank(runs, prefix, r)[f"{tag}/scale_replicated"])
    for i, (w, n) in enumerate(zip(want["out"], SIZES)):
        assert lead[f"{tag}/out{i}"].shape == (n, 1)
        _close(lead[f"{tag}/out{i}"], w, f"{tag} request {i}")


# ----------------------------------------------------------------- --pod
def test_pod_placements_and_scope_key_match_jax():
    """``PodTopology(2, 4)``: the placement variants and the incumbent's
    scope key equal JAX's (``tests/test_pod.py``)."""
    for n, dev in ((2, 4), (4, 4), (8, 8)):
        assert psearch.placement_variants(n, dev, PodTopology(2, 4)) == \
            jsearch.placement_variants(n, dev, JPod(2, 4))
    assert os.path.basename(ptune.incumbent_path("a", "dlrm", 8,
                                                 PodTopology(2, 4))) \
        == os.path.basename(jtune.incumbent_path("a", "dlrm", 8,
                                                 JPod(2, 4))) \
        == "strategy_incumbent_dlrm_8dev_2x4pod.json"


def test_search_tune_tool_takes_pod(tmp_path):
    """``--pod 2x4 --bench sim --device cpu`` exits 0 and promotes into
    the ``_2x4pod`` pointer; ``--pod auto`` without a group is one flat
    node (the flat name); a bad shape fails as JAX's parse does."""
    tool = os.path.join(REPO, "dlrm_flexflow_tpu_torch", "tools",
                        "search_tune.py")
    sys.path.insert(0, os.path.dirname(tool))
    try:
        import search_tune
    finally:
        sys.path.pop(0)
    _, m = search_tune.build_model(search_tune.parse_args(
        ["--telemetry", "x", "--tiny"]))
    rng = np.random.default_rng(8)
    tel = str(tmp_path / "rec.jsonl")
    with open(tel, "w") as f:
        for i, op in enumerate(m.layers):
            sf, sb = (float(x) for x in rng.uniform(1e-6, 1e-3, size=2))
            f.write(json.dumps({
                "type": "op_time", "ts": float(i), "op": op.name,
                "forward_s": 3 * sf, "backward_s": 2 * sb,
                "sim_forward_s": sf, "sim_backward_s": sb}) + "\n")
    art = str(tmp_path / "art")
    base = [sys.executable, tool, "--telemetry", tel, "--artifacts", art,
            "--tiny", "--device", "cpu", "--devices", "8", "--budget", "20",
            "--bench", "sim"]
    for pod, name in (("2x4", "strategy_incumbent_dlrm_8dev_2x4pod.json"),
                      ("auto", "strategy_incumbent_dlrm_8dev.json")):
        r = subprocess.run(base + ["--pod", pod], capture_output=True,
                           text=True, cwd=str(tmp_path), timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["verdict"] == "first"
        assert os.path.isfile(os.path.join(art, name))
    assert search_tune.pod_topology_arg("") is None
    with pytest.raises(ValueError, match="2x4"):
        search_tune.pod_topology_arg("2by4")
    assert search_tune.pod_topology_arg("2x4") == PodTopology(2, 4)
