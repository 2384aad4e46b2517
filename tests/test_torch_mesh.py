"""The port's device mesh (``parallel/mesh.py``, ``parallel/spmd.py``,
``distributed.py``) against the JAX package's mesh on the 8-device
virtual CPU platform.

The port's ranks are gloo processes (``distributed.launch``, rank bodies
in ``tests/torch_mesh_ranks.py``, which import no JAX); one launch per
mesh size runs every scenario of that size and writes ``.npz`` results.
The JAX references run here, each on a JAX mesh of the same shape, from
the same weights: the port loads the JAX model's initial parameters.
Tolerances are JAX's own (``tests/test_parallel.py``): rtol 1e-5 for
losses and parameters, rtol 1e-4 / atol 1e-5 for the spatial conv, and
bit for bit for a ``{"data": 1}`` mesh against no mesh.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import pytest

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jbuild_dlrm
from dlrm_flexflow_tpu.parallel import mesh as jmesh
from dlrm_flexflow_tpu.parallel.parallel_config import \
    ParallelConfig as JPC

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import distributed as fdist
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import params_to_numpy
from dlrm_flexflow_tpu_torch.parallel import mesh as pmesh
from dlrm_flexflow_tpu_torch.parallel.parallel_config import (
    ParallelConfig, Strategy)

TESTS = os.path.dirname(os.path.abspath(__file__))
P = pmesh.PartitionSpec


# ------------------------------------------------------ the JAX side
def jax_dlrm(batch, tp=False, xmode="off", overlap="off", bot=(4, 16, 8),
             tables=4, rows=64, dim=8, bag=2, microbatches=2):
    cfg = JDLRMConfig(sparse_feature_size=dim, embedding_size=[rows] * tables,
                      embedding_bag_size=bag, mlp_bot=list(bot),
                      mlp_top=[dim * tables + bot[-1], 16, 1],
                      exchange_overlap=overlap,
                      exchange_microbatches=microbatches)
    return jbuild_dlrm(cfg, ffj.FFConfig(batch_size=batch,
                                         table_exchange=xmode),
                       table_parallel=tp)


def jax_tp_linear(batch, tp=True, model_ranks=2):
    m = ffj.FFModel(ffj.FFConfig(batch_size=batch))
    t = m.create_tensor((batch, 32), name="x")
    h = m.dense(t, 64, activation="relu", name="fc1")
    m.dense(h, 8, name="fc2")
    if tp:
        m.get_op("fc1").parallel_config = JPC(dims=(1, model_ranks))
    return m


def jax_moe(batch, tp=True):
    m = ffj.FFModel(ffj.FFConfig(batch_size=batch))
    t = m.create_tensor((batch, 8), name="x")
    h = m.moe(t, num_experts=4, hidden_dim=16, top_k=2, name="moe")
    m.dense(h, 4)
    if tp:
        m.get_op("moe").parallel_config = JPC(dims=(1, 2))
    return m


def jax_conv(batch, spatial=True):
    m = ffj.FFModel(ffj.FFConfig(batch_size=batch))
    x = m.create_tensor((batch, 3, 16, 16), name="img")
    h = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="c1")
    h = m.pool2d(h, 2, 2, 2, 2, 0, 0, name="p1")
    h = m.conv2d(h, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="c2")
    h = m.flat(h, name="f")
    m.dense(h, 4, name="out")
    if spatial:
        for n in ("c1", "c2", "p1"):
            m.get_op(n).parallel_config = JPC(dims=(2, 1, 2, 2))
    return m


JAX_MODEL_FNS = {"dlrm": jax_dlrm, "tp_linear": jax_tp_linear,
                "moe": jax_moe, "conv": jax_conv}


def np_params(params):
    return {op: {k: np.array(v) for k, v in d.items()}
            for op, d in params.items()}


def flat(tree, prefix):
    return {f"{prefix}{op}/{k}": v for op, d in tree.items()
            for k, v in d.items()}


def jax_case(tmp, name, case, mesh_shape, build_kw, inputs, labels,
             steps=2, lr=0.05, forward=False, seed=0, **extra):
    """The JAX run of one scenario on a JAX mesh of ``mesh_shape``; writes
    the rank bodies' input file and returns ``(rank kwargs, reference)``."""
    m = JAX_MODEL_FNS[case](**build_kw)
    m.compile(optimizer=ffj.SGDOptimizer(lr=lr),
              loss_type="mean_squared_error", metrics=("accuracy",),
              mesh=jmesh.make_mesh(mesh_shape))
    st = m.init(seed=seed)
    p0 = np_params(st.params)
    ref = {"p0": p0}
    if forward:
        ref["forward"] = np.asarray(m.forward(st, inputs))
    losses = []
    for _ in range(steps):
        st, mets = m.train_step(st, inputs, labels)
        losses.append(float(mets["loss"]))
    ref["losses"] = np.array(losses)
    ref["params"] = np_params(st.params)
    data = str(tmp / f"{name}.in.npz")
    np.savez(data, labels=labels, **flat(p0, "p/"),
             **{f"in/{k}": v for k, v in inputs.items()})
    kw = dict(case=case, mesh_shape=mesh_shape, build_kw=build_kw,
              data=data, out=str(tmp / f"{name}.out.npz"), steps=steps,
              lr=lr, forward=forward, **extra)
    return kw, ref


def dlrm_data(batch, seed=0, tables=4, rows=64, bot0=4, bag=2):
    rng = np.random.default_rng(seed)
    inputs = {"dense": rng.standard_normal((batch, bot0)).astype(np.float32),
              "sparse": rng.integers(0, rows, size=(batch, tables, bag)
                                     ).astype(np.int32)}
    labels = rng.integers(0, 2, size=(batch, 1)).astype(np.float32)
    return inputs, labels


def launch(cases, world):
    fdist.launch("torch_mesh_ranks:run_cases", world,
                 kwargs={"cases": json.dumps(cases)}, device="cpu",
                 timeout_s=240, pythonpath=[TESTS])


def compare(out, ref, rtol=1e-5, atol=1e-6):
    got = np.load(out)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=rtol)
    for op, d in ref["params"].items():
        for k, v in d.items():
            np.testing.assert_allclose(got[f"p/{op}/{k}"], v, rtol=rtol,
                                       atol=atol, err_msg=f"{op}/{k}")
    return got


def coords(mesh_shape, rank):
    sizes = list(mesh_shape.values())
    return dict(zip(mesh_shape, np.unravel_index(rank, sizes)))


def replica_groups(mesh_shape, spec_axes):
    """Ranks that hold the same block of a parameter sharded over
    ``spec_axes``: equal coordinates on those axes."""
    groups = {}
    for r in range(int(np.prod(list(mesh_shape.values())))):
        c = coords(mesh_shape, r)
        groups.setdefault(tuple(c[a] for a in spec_axes), []).append(r)
    return list(groups.values())


# ------------------------------------------------------------- launches
@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    """One 4-rank group: data parallel, channel parallel, experts, the
    table-parallel DLRM without an exchange."""
    tmp = tmp_path_factory.mktemp("mesh4")
    ins, lab = dlrm_data(16)
    x = np.random.default_rng(0).standard_normal((16, 32)).astype(np.float32)
    y = np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32)
    xm = np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32)
    ym = np.random.default_rng(3).standard_normal((16, 4)).astype(np.float32)
    specs = {
        "dp": ("dlrm", {"data": 4}, {"batch": 16}, ins, lab, 3),
        "tp_linear": ("tp_linear", {"data": 2, "model": 2},
                      {"batch": 16}, {"x": x}, y, 2),
        "moe": ("moe", {"data": 2, "model": 2}, {"batch": 16}, {"x": xm},
                ym, 2),
        "tables": ("dlrm", {"data": 2, "model": 2},
                   {"batch": 16, "tp": True}, ins, lab, 3),
    }
    cases, refs = [], {}
    for name, (case, shape, kw, i, lb, steps) in specs.items():
        rk, ref = jax_case(tmp, name, case, shape, kw, i, lb, steps=steps,
                           seed=7)
        cases.append(rk)
        refs[name] = (rk, ref)
    internal = str(tmp / "one_device.npz")
    fdist.launch("torch_mesh_ranks:run_mesh4", 4,
                 kwargs={"cases": json.dumps(cases), "internal": internal},
                 device="cpu", timeout_s=240, pythonpath=[TESTS])
    refs["one_device"] = np.load(internal)
    return refs


@pytest.fixture(scope="module")
def mesh8(tmp_path_factory):
    """One 8-rank group: the spatial conv on {"data": 2, "seq": 2,
    "model": 2}."""
    tmp = tmp_path_factory.mktemp("mesh8")
    rng = np.random.default_rng(0)
    img = rng.standard_normal((8, 3, 16, 16)).astype(np.float32)
    lab = rng.standard_normal((8, 4)).astype(np.float32)
    rk, ref = jax_case(tmp, "conv", "conv", {"data": 2, "seq": 2,
                                              "model": 2},
                       {"batch": 8}, {"img": img}, lab, steps=3,
                       forward=True)
    launch([rk], 8)
    return rk, ref


@pytest.fixture(scope="module")
def hosts2(tmp_path_factory):
    """Two processes feeding their rows through a HostShardLoader; the
    JAX reference is one process on a {"data": 2} mesh."""
    tmp = tmp_path_factory.mktemp("hosts2")
    ins, lab = dlrm_data(32, seed=4)
    m = jax_dlrm(16)
    m.compile(optimizer=ffj.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=(),
              mesh=jmesh.make_mesh({"data": 2}))
    st = m.init(seed=1)
    p0 = np_params(st.params)
    losses = []
    for b in range(2):
        sl = slice(16 * b, 16 * (b + 1))
        st, mets = m.train_step(st, {k: v[sl] for k, v in ins.items()},
                                lab[sl])
        losses.append(float(mets["loss"]))
    data, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(data, labels=lab, **flat(p0, "p/"),
             **{f"in/{k}": v for k, v in ins.items()})
    fdist.launch("torch_mesh_ranks:run_host_shards", 2,
                 kwargs={"data": data, "out": out}, device="cpu",
                 timeout_s=180, pythonpath=[TESTS])
    return np.load(out), np.array(losses), np_params(st.params)


# ------------------------------------------------- layouts, one process
def layout_mesh(shape):
    return pmesh.Mesh(np.arange(int(np.prod(list(shape.values()))))
                      .reshape(tuple(shape.values())), tuple(shape),
                      groups=False)


def test_make_mesh_and_pspec_translation():
    """``make_mesh`` on one process and JAX's translation rules
    (``test_parallel.py:32-54``, ``:508-513``)."""
    m = fft.make_mesh()
    assert m.shape == {"data": 1} and m.trivial
    with pytest.raises(AssertionError, match="needs 2 devices, have 1"):
        fft.make_mesh({"data": 2})
    for shape, pc, nd in [({"data": 4, "model": 2}, (2, 8), 2),
                          ({"data": 4, "model": 2}, (1, 2), 2),
                          ({"data": 4, "model": 2}, (4, 2), 2),
                          ({"data": 4, "model": 2}, (1, 4, 1), 3),
                          ({"data": 2, "seq": 2, "model": 2}, (2, 1, 2, 2),
                           4),
                          ({"data": 2, "seq": 4}, (2, 4, 1), 3),
                          ({"data": 8}, None, 3)]:
        jpc = None if pc is None else (
            JPC.data_parallel(*pc) if pc == (2, 8) else JPC(dims=pc))
        ppc = None if pc is None else (
            ParallelConfig.data_parallel(*pc) if pc == (2, 8)
            else ParallelConfig(dims=pc))
        want = jmesh.pspec_for_config(jpc, nd, jmesh.make_mesh(shape))
        got = pmesh.pspec_for_config(ppc, nd, layout_mesh(shape))
        assert tuple(got) == tuple(want), (shape, pc)
    assert pmesh.pspec_for_config(
        ParallelConfig(dims=(4, 2)), 2, layout_mesh({"data": 4, "model": 2})
    ) == P("data", "model")
    assert tuple(pmesh.param_pspec(1, 2, layout_mesh({"data": 2, "model": 2}),
                                   True)) == (None, "model")


def test_effective_config_and_topology_match_jax():
    """``effective_config`` (``test_parallel.py:656-672``) and the
    topology ids the checkpoints record."""
    shape = {"data": 4, "model": 2}
    jm, pm = jmesh.make_mesh(shape), layout_mesh(shape)
    for dims, ids in [((8, 1), list(range(8))), ((4, 2), list(range(8))),
                      ((1, 1), [5]), ((4, 1), None), ((2, 2), [0, 1, 2, 3])]:
        assert pmesh.effective_config(ParallelConfig(dims=dims,
                                                     device_ids=ids), 2, pm) \
            == jmesh.effective_config(JPC(dims=dims, device_ids=ids), 2, jm)
    assert pmesh.mesh_topology(pm) == jmesh.mesh_topology(jm) == shape
    for a, b in [({"data": 1}, {}), ({"data": 2}, {"data": 2, "model": 1}),
                 ({"data": 2}, {"model": 2})]:
        assert pmesh.same_topology(a, b) == jmesh.same_topology(a, b)
        assert pmesh.format_topology(a) == jmesh.format_topology(a)


def _narrow_model(strategy, mesh):
    m = fft.FFModel(fft.FFConfig(batch_size=16))
    x = m.create_tensor((16, 8), name="x")
    m.dense(x, 8, name="d0")
    m.compile(optimizer=fft.SGDOptimizer(lr=0.1),
              loss_type="mean_squared_error", metrics=(), mesh=mesh,
              strategy=strategy)
    return m


def test_placement_narrowing_warns_with_the_jax_wording():
    """A pinned device or a degree the mesh cannot execute warns once
    with the op list (``test_parallel.py:600-654``); a faithful config
    does not."""
    mesh = fft.make_mesh({"data": 1})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _narrow_model(Strategy({"d0": ParallelConfig(dims=(1, 1))}), mesh)
    with pytest.warns(UserWarning, match="axis-sharded"):
        m = _narrow_model(Strategy({"d0": ParallelConfig(
            dims=(1, 1), device_ids=[5])}), mesh)
    st = m.init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    st, mets = m.train_step(
        st, {"x": rng.standard_normal((16, 8)).astype(np.float32)},
        rng.standard_normal((16, 8)).astype(np.float32))
    assert np.isfinite(float(mets["loss"]))
    with pytest.warns(UserWarning, match="nearest axis-sharded"):
        _narrow_model(Strategy({"d0": ParallelConfig(
            dims=(4, 1), device_ids=[0, 1, 2, 3])}), mesh)


def test_config_fields_and_sharded_dims_match_jax():
    """``FFConfig.mesh_shape`` / ``table_exchange`` keyword-only with the
    JAX defaults and ``ValueError``; every parameter's ``sharded_dim`` is
    the JAX op's."""
    pc, jc = fft.FFConfig(), ffj.FFConfig()
    assert (pc.mesh_shape, pc.table_exchange) == (jc.mesh_shape,
                                                  jc.table_exchange)
    with pytest.raises(TypeError):
        fft.FFConfig(1, 64, 1)
    m = build_dlrm(DLRMConfig(sparse_feature_size=8, embedding_size=[64] * 4,
                              mlp_bot=[4, 8], mlp_top=[40, 1]),
                   fft.FFConfig(batch_size=8, table_exchange="bogus"))
    with pytest.raises(ValueError, match="table_exchange must be"):
        m.compile(mesh=False)
    for pbuild, jbuild in [(lambda: build_dlrm(DLRMConfig(
            sparse_feature_size=8, embedding_size=[64] * 4, mlp_bot=[4, 8],
            mlp_top=[40, 1]), fft.FFConfig(batch_size=8)),
            lambda: jax_dlrm(8, bot=(4, 8)))]:
        pm_, jm_ = pbuild(), jbuild()
        for pop, jop in zip(pm_.layers, jm_.layers):
            assert [(s.param_name, s.sharded_dim) for s in pop.param_specs()] \
                == [(s.param_name, s.sharded_dim) for s in jop.param_specs()]
    import torch_mesh_ranks as tmr  # the rank bodies' models, JAX-free
    for case in ("tp_linear", "moe", "conv"):
        pm_, jm_ = tmr.MODEL_FNS[case](8), JAX_MODEL_FNS[case](8)
        for pop, jop in zip(pm_.layers, jm_.layers):
            assert [(s.param_name, s.sharded_dim) for s in pop.param_specs()] \
                == [(s.param_name, s.sharded_dim) for s in jop.param_specs()]


def test_trivial_mesh_is_bit_for_bit_no_mesh():
    """``{"data": 1}`` and ``{"data": 1, "model": 1}`` with
    ``table_exchange="allgather"`` (which warns and stays off) run the
    program of no mesh: every loss and parameter bit for bit, the step
    captured the same way, ``train_epoch`` and ``fit`` included."""
    from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader
    ins, lab = dlrm_data(16, seed=2)
    out = {}
    for name, mesh, xmode in [("none", False, "off"),
                              ("d1", fft.make_mesh({"data": 1}), "off"),
                              ("d1m1", fft.make_mesh({"data": 1,
                                                      "model": 1}),
                               "allgather")]:
        m = build_dlrm(DLRMConfig(sparse_feature_size=8,
                                  embedding_size=[64] * 4,
                                  embedding_bag_size=2, mlp_bot=[4, 16, 8],
                                  mlp_top=[40, 16, 1]),
                       fft.FFConfig(batch_size=16, table_exchange=xmode),
                       table_parallel=xmode != "off")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
                      loss_type="mean_squared_error", metrics=("accuracy",),
                      mesh=mesh)
        if xmode != "off":
            assert any("cannot engage it" in str(x.message) for x in w)
        assert m._spmd is None and m.mesh is (mesh or None)
        assert m._allow_kernel and all(op._allow_kernel for op in m.layers)
        st = m.init(seed=3, device="cpu")
        losses = []
        for _ in range(3):
            st, mets = m.train_step(st, ins, lab)
            losses.append(mets["loss"].item())
        st, folded = m.train_epoch(
            st, {k: np.stack([v, v]) for k, v in ins.items()},
            np.stack([lab, lab]))
        st, _ = m.fit(st, ArrayDataLoader(ins, lab, 8, shuffle=False),
                      epochs=1, verbose=False)
        out[name] = (losses, folded["loss"].item(),
                     params_to_numpy(st.params), m.graph_captures)
    for name in ("d1", "d1m1"):
        assert out[name][:2] == out["none"][:2]
        assert out[name][3] == out["none"][3]
        for op, d in out["none"][2].items():
            for k, v in d.items():
                assert np.array_equal(out[name][2][op][k], v), (name, op, k)


def test_partition_rules_and_mesh_errors():
    """``partition_rules`` on a compiled model; ``compile`` refuses what
    is not a mesh; a mesh of several ranks needs a process group."""
    m = build_dlrm(DLRMConfig(sparse_feature_size=8, embedding_size=[64] * 4,
                              mlp_bot=[4, 8], mlp_top=[40, 1]),
                   fft.FFConfig(batch_size=8), table_parallel=True)
    m.compile(mesh=fft.make_mesh({"data": 1, "model": 1}))
    rules = pmesh.partition_rules(m)
    assert rules[-1] == (".*", P())
    assert pmesh.match_partition_rule(rules, "emb/embedding") == \
        P("model", None, None)
    assert pmesh.match_partition_rule(rules, "emb/qscale__") == P()
    with pytest.raises(TypeError, match="make_mesh"):
        m.compile(mesh=object())
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.Mesh(np.arange(2), ("data",))


# ------------------------------------------------------------ four ranks
def test_data_parallel_dlrm_matches_jax_and_replicas_agree(mesh4):
    """DP {"data": 4}: three steps' losses and every parameter against
    the JAX mesh run at rtol 1e-5; the row-sparse tables' replicas are
    identical on every rank after the steps; compile turned the kernels
    off for every op and the row updates."""
    rk, ref = mesh4["dp"]
    compare(rk["out"], ref)
    assert bool(np.load(rk["out"])["kernels_off"])
    blocks = [np.load(f"{rk['out']}.rank{r}.npz") for r in range(4)]
    for key in blocks[0].files:
        for b in blocks[1:]:
            assert np.array_equal(b[key], blocks[0][key]), key


def test_channel_parallel_linear_holds_its_columns(mesh4):
    """fc1 channel parallel on {"data": 2, "model": 2}: each rank holds
    its (32, 32) columns of the (32, 64) weight, replicas agree, and the
    losses and parameters match JAX's mesh run."""
    rk, ref = mesh4["tp_linear"]
    compare(rk["out"], ref)
    blocks = [np.load(f"{rk['out']}.rank{r}.npz") for r in range(4)]
    assert blocks[0]["p/fc1/kernel"].shape == (32, 32)
    assert blocks[0]["p/fc1/bias"].shape == (32,)
    assert blocks[0]["p/fc2/kernel"].shape == (64, 8)
    for grp in replica_groups(rk["mesh_shape"], ("model",)):
        for r in grp[1:]:
            for key in blocks[0].files:
                assert np.array_equal(blocks[r][key], blocks[grp[0]][key])
    full = np.concatenate([blocks[0]["p/fc1/kernel"],
                           blocks[1]["p/fc1/kernel"]], axis=1)
    np.testing.assert_array_equal(full, np.load(rk["out"])["p/fc1/kernel"])


def test_experts_sharded_over_model(mesh4):
    """MoE experts over "model": each rank holds 2 of the 4 experts, and
    the losses and parameters match JAX's mesh run."""
    rk, ref = mesh4["moe"]
    compare(rk["out"], ref)
    b0 = np.load(f"{rk['out']}.rank0.npz")
    assert b0["p/moe/w_in"].shape == (2, 8, 16)
    assert b0["p/moe/b_out"].shape == (2, 8)
    assert b0["p/moe/router"].shape == (8, 4)


def test_table_parallel_dlrm_row_sparse_matches_jax(mesh4):
    """``build_dlrm(table_parallel=True)`` without an exchange: each rank
    holds 2 of the 4 tables and steps them row-sparsely; the losses and
    parameters match JAX's SPMD-automatic run."""
    rk, ref = mesh4["tables"]
    compare(rk["out"], ref)
    b0 = np.load(f"{rk['out']}.rank0.npz")
    assert b0["p/emb/embedding"].shape == (2, 64, 8)


@pytest.mark.parametrize("name", ["coupled_dp", "coupled_tp", "lazy_adam",
                                  "epochs"])
def test_mesh_matches_the_one_device_port(mesh4, name):
    """Paths JAX's mesh tests do not reach, held to the port's one-device
    run at rtol 1e-5: batch norm (statistics over the whole batch),
    dropout (masks by global position), a softmax output with sparse CCE
    beside a channel-parallel Linear, momentum; lazy Adam on the
    row-sparse tables (every rank's rows and slot rows gathered in rank
    order); ``train_epoch`` and ``fit``, which step batch by batch under
    a mesh.  The optimizer's slot tables compare through
    ``bridge.state_to_numpy``, which gathers a sharded slot as its
    parameter."""
    got = mesh4["one_device"]
    keys = [k[len(f"{name}/one/"):] for k in got.files
            if k.startswith(f"{name}/one/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[f"{name}/mesh/{k}"],
                                   got[f"{name}/one/{k}"], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------ eight ranks
def test_spatial_conv_matches_jax(mesh8):
    """The (2, 1, 2, 2) conv and pool strategy on {"data": 2, "seq": 2,
    "model": 2} (``test_parallel.py:456-506``): forward and three steps
    against JAX's mesh run at rtol 1e-4 / atol 1e-5; the conv kernels are
    held sharded on their out channels."""
    rk, ref = mesh8
    got = compare(rk["out"], ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["forward"], ref["forward"], rtol=1e-5,
                               atol=1e-5)
    b0 = np.load(f"{rk['out']}.rank0.npz")
    assert b0["p/c1/kernel"].shape == (3, 3, 3, 4)


# -------------------------------------------------------------- two hosts
def test_two_process_host_shard_loader(hosts2):
    """Two processes, each holding only its rows of every batch
    (``test_distributed.py:145``): ``train_step`` and ``fit`` through a
    ``HostShardLoader`` match the one-process JAX run on a {"data": 2}
    mesh, and the group reports its topology and prices its gradient
    all-reduce on the two-node H100 model."""
    from dlrm_flexflow_tpu_torch.sim.cost_model import (H100MachineModel,
                                                        PodTopology)
    got, losses, params = hosts2
    np.testing.assert_array_equal(got["topology"], [0, 2, 2, 2])
    nbytes = sum(v.nbytes for d in params.values() for v in d.values())
    want = H100MachineModel(topology=PodTopology(2, 1)).all_reduce_time(
        float(nbytes), 2) * 1e3
    assert float(got["predicted_sync_ms"]) == pytest.approx(want, rel=1e-12)
    np.testing.assert_array_equal(got["host_slice"], [0, 16])
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for op, d in params.items():
        for k, v in d.items():
            for pre in ("p/", "fit/"):
                np.testing.assert_allclose(got[f"{pre}{op}/{k}"], v,
                                           rtol=1e-5, atol=1e-6)
