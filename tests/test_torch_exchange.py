"""The port's table-parallel exchange (``parallel/table_exchange.py``),
its overlapped pipeline (``parallel/overlap.py``,
``ops/overlap_embed.py``) and their pricing against the JAX package.

One 4-rank gloo group ({"data": 2, "model": 2}) runs every scenario
(rank bodies in ``tests/torch_mesh_ranks.py``); the JAX references run
here on the virtual 8-device platform from the same weights.  The
lookup is exact against JAX's, its gradient and the trained DLRM at
rtol 1e-5; the overlapped pipeline is held to the serial exchange at
rtol 1e-5 (a reordered reduction, never 1e-6).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.ops import kernel_costs as jkc
from dlrm_flexflow_tpu.parallel import mesh as jmesh
from dlrm_flexflow_tpu.parallel.table_exchange import \
    table_parallel_lookup as jlookup
from dlrm_flexflow_tpu.sim import cost_model as jcm

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import distributed as fdist
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.ops import kernel_costs as pkc
from dlrm_flexflow_tpu_torch.sim import cost_model as pcm

from test_torch_mesh import dlrm_data, jax_case, replica_groups

TESTS = os.path.dirname(os.path.abspath(__file__))
T, R, D, B, BAG = 8, 64, 16, 32, 3


def _jax_ref_lookup(tables, ids):
    t, r, d = tables.shape
    gids = ids + (jnp.arange(t, dtype=ids.dtype)[:, None] * r)
    return jnp.take(tables.reshape(t * r, d), gids, axis=0).sum(axis=2)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4-rank group and the JAX references of every scenario."""
    tmp = tmp_path_factory.mktemp("exchange")
    rng = np.random.default_rng(0)
    tables = rng.standard_normal((T, R, D)).astype(np.float32)
    ids = rng.integers(0, R, size=(B, T, BAG)).astype(np.int32)
    qtables = rng.integers(-127, 128, size=(T, R, D)).astype(np.int8)
    qscale = (rng.random((T * R, 1)) * 0.01).astype(np.float32)
    mesh = jmesh.make_mesh({"data": 2, "model": 2})
    tg = jax.device_put(jnp.asarray(tables),
                        NamedSharding(mesh, JP("model", None, None)))
    ig = jax.device_put(jnp.asarray(ids),
                        NamedSharding(mesh, JP("data", None, None)))
    qg = jax.device_put(jnp.asarray(qtables),
                        NamedSharding(mesh, JP("model", None, None)))
    lookups = {}
    for mode in ("allgather", "all_to_all"):
        lookups[f"{mode}/out"] = np.asarray(jlookup(tg, ig, mesh, "sum",
                                                    mode))
        lookups[f"{mode}/grad"] = np.asarray(jax.grad(lambda tb: jnp.sum(
            jlookup(tb, ig, mesh, "sum", mode) ** 2))(tg))
        lookups[f"{mode}/qout"] = np.asarray(jlookup(
            qg, ig, mesh, "sum", mode, qscale=jnp.asarray(qscale)))
    lookups["ref"] = np.asarray(_jax_ref_lookup(jnp.asarray(tables),
                                                jnp.asarray(ids)))
    lookups["grad_ref"] = np.asarray(jax.grad(lambda tb: jnp.sum(
        _jax_ref_lookup(tb, jnp.asarray(ids)) ** 2))(jnp.asarray(tables)))
    ldata = str(tmp / "lookup.npz")
    np.savez(ldata, tables=tables, ids=ids, qtables=qtables, qscale=qscale)
    odata = str(tmp / "overlap.npz")
    np.savez(odata, tables=tables, ids=ids,
             dense=rng.standard_normal((B, 8)).astype(np.float32),
             w=rng.standard_normal((8, 12)).astype(np.float32) * 0.3)

    ins, lab = dlrm_data(16, seed=5)
    shape = {"data": 2, "model": 2}
    cases, refs = [], {}
    for name, kw in [
            ("ag", {"batch": 16, "tp": True, "xmode": "allgather"}),
            ("a2a", {"batch": 16, "tp": True, "xmode": "all_to_all"}),
            ("ov_ag_on", {"batch": 16, "tp": True, "xmode": "allgather",
                          "overlap": "on"}),
            ("ov_a2a_on", {"batch": 16, "tp": True, "xmode": "all_to_all",
                           "overlap": "on"})]:
        rk, ref = jax_case(tmp, name, "dlrm", shape, kw, ins, lab, steps=3,
                           seed=2)
        cases.append(rk)
        refs[name] = (rk, ref)
        if name.startswith("ov_"):
            # the same graph with the op's serial exchange
            off = dict(rk, out=rk["out"].replace("_on.", "_off."),
                       overlap_op=["emb_bot", "off"])
            cases.append(off)
            refs[name.replace("_on", "_off")] = (off, ref)
    louts = {n: str(tmp / f"{n}.out.npz") for n in ("lookup", "overlap")}
    fdist.launch("torch_mesh_ranks:run_exchange_group", 4,
                 kwargs={"cases": json.dumps(cases), "lookup": ldata,
                         "overlap": odata, "louts": louts},
                 device="cpu", timeout_s=240, pythonpath=[TESTS])
    return lookups, np.load(louts["lookup"]), np.load(louts["overlap"]), refs


# ---------------------------------------------------------- the lookup
@pytest.mark.parametrize("mode", ["allgather", "all_to_all"])
def test_lookup_exact_and_grads(group, mode):
    """``table_parallel_lookup`` on each rank's tables and data shard: the
    output equals JAX's (and the dense lookup) exactly, the tables'
    gradient within rtol 1e-5 (``test_parallel.py:529-554``)."""
    jref, got, _, _ = group
    np.testing.assert_array_equal(got[f"{mode}/out"], jref[f"{mode}/out"])
    np.testing.assert_array_equal(got[f"{mode}/out"], jref["ref"])
    np.testing.assert_allclose(got[f"{mode}/grad"], jref[f"{mode}/grad"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[f"{mode}/grad"], jref["grad_ref"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["allgather", "all_to_all"])
def test_int8_rows_dequantize_before_the_exchange(group, mode):
    """An int8 table with its per-row scale: each rank dequantizes its
    gathered rows inside the exchange, as the JAX body does."""
    jref, got, _, _ = group
    np.testing.assert_allclose(got[f"{mode}/qout"], jref[f"{mode}/qout"],
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- the model
@pytest.mark.parametrize("name", ["ag", "a2a"])
def test_dlrm_trains_with_manual_exchange(group, name):
    """``FFConfig.table_exchange`` routes the table-parallel lookup
    through the exchange (dense path, the sparse path excluded): three
    steps' losses and every parameter match JAX's mesh run at rtol 1e-5,
    each rank holding 2 of the 4 tables, replicas equal."""
    _, _, _, refs = group
    rk, ref = refs[name]
    got = np.load(rk["out"])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for op, d in ref["params"].items():
        for k, v in d.items():
            np.testing.assert_allclose(got[f"p/{op}/{k}"], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{op}/{k}")
    assert "emb" not in list(got["sparse"])  # the dense table gradient
    blocks = [np.load(f"{rk['out']}.rank{r}.npz") for r in range(4)]
    assert blocks[0]["p/emb/embedding"].shape == (2, 64, 8)
    for grp in replica_groups(rk["mesh_shape"], ("model",)):
        for r in grp[1:]:
            for key in blocks[0].files:
                assert np.array_equal(blocks[r][key], blocks[grp[0]][key])


@pytest.mark.parametrize("mode", ["ag", "a2a"])
def test_overlapped_graph_matches_serial_and_jax(group, mode):
    """The overlapped graph (``exchange_overlap="on"``): the pipelined run
    against the same graph's serial exchange at rtol 1e-5, and both
    against JAX's run of the overlapped graph."""
    _, _, _, refs = group
    on, off = np.load(refs[f"ov_{mode}_on"][0]["out"]), np.load(
        refs[f"ov_{mode}_off"][0]["out"])
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
    for key in off.files:
        if key.startswith("p/"):
            np.testing.assert_allclose(on[key], off[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    ref = refs[f"ov_{mode}_on"][1]
    np.testing.assert_allclose(on["losses"], ref["losses"], rtol=1e-5)
    for op, d in ref["params"].items():
        for k, v in d.items():
            np.testing.assert_allclose(on[f"p/{op}/{k}"], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{op}/{k}")


@pytest.mark.parametrize("mode", ["allgather", "all_to_all"])
def test_overlapped_pipeline_against_serial(group, mode):
    """``overlapped_embed_bottom`` at K = 2 and 4 against the serial
    exchange and dense stack (K = 1): the outputs in the serial row
    order, the tables' and dense weights' gradients at rtol 1e-5."""
    _, _, got, _ = group
    np.testing.assert_array_equal(got["microbatch_ok"],
                                  [True, False, True, False])
    for k in (2, 4):
        for part in ("emb", "bottom", "gt", "gw"):
            np.testing.assert_allclose(got[f"{mode}/k{k}/{part}"],
                                       got[f"{mode}/k1/{part}"], rtol=1e-5,
                                       atol=1e-5, err_msg=f"k{k}/{part}")


# ----------------------------------------------------------- the pricing
def _jax_constants(monkeypatch):
    """The port's gate constants set to the JAX package's values."""
    monkeypatch.setattr(pkc, "NVLINK_GBPS", jkc.ICI_GBPS)
    monkeypatch.setattr(pkc, "DENSE_FLOPS_PER_NS", jkc.MXU_F32_FLOPS_PER_NS)
    monkeypatch.setattr(pkc, "OP_BOUNDARY_NS", jkc.OP_BOUNDARY_NS)
    monkeypatch.setattr(pkc, "DISPATCH_MARGIN", jkc.DISPATCH_MARGIN)


def test_exchange_overlap_wins_matches_jax(monkeypatch):
    """Under the JAX constants the gate decides as JAX's on a grid of
    shapes; under the H100 data-sheet constants K = 1 and one model rank
    still never overlap."""
    grid = [(b, t, d, mp, k, mode) for b in (64, 512, 4096)
            for t in (8, 26) for d in (16, 64) for mp in (1, 2, 4)
            for k in (1, 2, 4) for mode in ("allgather", "all_to_all")]

    def flops(b):
        return 2 * b * (64 * 512 + 512 * 512 + 512 * 64)

    for b, t, d, mp, k, mode in grid:
        assert not pkc.exchange_overlap_wins(b, t, d, 4, 1, flops(b), k,
                                             mode)
        assert not pkc.exchange_overlap_wins(b, t, d, 4, mp, flops(b), 1,
                                             mode)
    _jax_constants(monkeypatch)
    for b, t, d, mp, k, mode in grid:
        assert pkc.exchange_overlap_wins(b, t, d, 4, mp, flops(b), k,
                                         mode) == jkc.exchange_overlap_wins(
            b, t, d, 4, mp, flops(b), k, mode), (b, t, d, mp, k, mode)


def test_pod_topology_and_overlapped_time_match_jax():
    for spec in ("2x4", "1x8", "4X2"):
        assert pcm.PodTopology.parse(spec).to_json() == \
            jcm.PodTopology.parse(spec).to_json()
    for bad in ("2-4", "x", "2x", "0x4"):
        with pytest.raises(ValueError):
            pcm.PodTopology.parse(bad)
        with pytest.raises(ValueError):
            jcm.PodTopology.parse(bad)
    m = jcm.TPUMachineModel()
    for ex, dn, k, ov in [(3e-6, 5e-6, 2, True), (9e-6, 1e-6, 4, True),
                          (3e-6, 5e-6, 1, True), (3e-6, 5e-6, 4, False)]:
        assert pcm.overlapped_exchange_time(m, ex, dn, k, ov) == \
            jcm.overlapped_exchange_time(m, ex, dn, k, ov)


@pytest.mark.parametrize("xmode", ["off", "all_to_all"])
def test_exchange_overlap_cost_hook_matches_jax(monkeypatch, xmode):
    """The op's pricing hook under the JAX machine model and constants
    gives JAX's (forward, backward), and the cost model calls it."""
    _jax_constants(monkeypatch)
    cfg = dict(sparse_feature_size=16, embedding_size=[1000] * 8,
               mlp_bot=[13, 512, 16], mlp_top=[16 * 8 + 16, 64, 1],
               exchange_overlap="on", exchange_microbatches=2)
    pm = build_dlrm(DLRMConfig(**cfg), fft.FFConfig(batch_size=2048,
                                                    table_exchange=xmode))
    from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JC
    from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jb
    jm = jb(JC(**cfg), ffj.FFConfig(batch_size=2048, table_exchange=xmode))
    pop, jop = pm.get_op("emb_bot"), jm.get_op("emb_bot")
    pop.exchange_mode = jop.exchange_mode = (None if xmode == "off"
                                             else xmode)
    machine = jcm.TPUMachineModel()
    for parts in (1, 2, 4, 8):
        assert pop.exchange_overlap_cost(machine, parts) == \
            jop.exchange_overlap_cost(machine, parts)
    cm = pcm.CostModel(machine=machine)
    assert cm.op_times(pop, 4) == pop.exchange_overlap_cost(machine, 4)


def test_overlapped_graph_without_a_mesh_is_the_classic_graph():
    """No exchange engaged: the overlapped node's forward is the stacked
    lookup beside the bottom Linear chain, bit for bit the classic
    graph's outputs from the same weights."""
    cfg = dict(sparse_feature_size=8, embedding_size=[64] * 4,
               embedding_bag_size=2, mlp_bot=[4, 16, 8], mlp_top=[40, 16, 1])
    ins, _ = dlrm_data(16, seed=1)
    classic = build_dlrm(DLRMConfig(**cfg), fft.FFConfig(batch_size=16))
    ov = build_dlrm(DLRMConfig(exchange_overlap="on", **cfg),
                    fft.FFConfig(batch_size=16))
    for m in (classic, ov):
        m.compile(mesh=False)
    st = classic.init(seed=0, device="cpu")
    p = {k: v.clone() for k, v in st.params["emb"].items()}
    for i in range(2):
        p[f"bot{i}_kernel"] = st.params[f"bot_{i}"]["kernel"]
        p[f"bot{i}_bias"] = st.params[f"bot_{i}"]["bias"]
    params = {"emb_bot": p, **{k: v for k, v in st.params.items()
                               if k.startswith("top")}}
    so = ov.load_params(params, device="cpu")
    assert torch.equal(classic.forward(st, ins), ov.forward(so, ins))
