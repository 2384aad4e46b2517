"""The port's hetero path (host-placed tables, ``ops/hetero.py``, the
native runtime ``data/native.py``) against the JAX package's on the CPU,
at the JAX tests' small size (``tests/test_checkpoint.py``'s two-table
hetero DLRM: 40 and 60 rows of 8, bag 2, SGD at lr 0.1).  Also the three
repaired API faults: the initializers' ``seed`` and ``NormInitializer``,
the names at the package root, and a ``"cpu"`` strategy entry on an op
without a placement.  JAX is imported here only.

The JAX hetero functions run their numpy branches
(``native_available`` patched to False in each test), which sum in the
native kernels' order; the JAX native bindings, where a test needs them,
take the port's build of ``native/ffruntime.cpp`` (no ``make`` in
``native/``).  Lookups and deposits are compared bit for bit; steps of
the MLPs (f32 in JAX, f64-accumulated in the port) within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import checkpoint as jckpt
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.data import loader as jloader
from dlrm_flexflow_tpu.data import native as jnative
from dlrm_flexflow_tpu.ops import hetero as jhetero
from dlrm_flexflow_tpu.parallel import parallel_config as jpc
from dlrm_flexflow_tpu.parallel import strategy_pb as jpb
from dlrm_flexflow_tpu.resilience import NaNSentinel as JaxNaNSentinel
from dlrm_flexflow_tpu.resilience import faultinject as jfault

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import initializers as pinit
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import (host_tables_from_jax,
                                            opt_state_from_jax,
                                            params_from_jax, state_from_jax)
from dlrm_flexflow_tpu_torch.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from dlrm_flexflow_tpu_torch.data import loader as ploader
from dlrm_flexflow_tpu_torch.data import native as pnative
from dlrm_flexflow_tpu_torch.ops import hetero as phetero
from dlrm_flexflow_tpu_torch.parallel import parallel_config as ppc
from dlrm_flexflow_tpu_torch.parallel import strategy_pb as ppb
from dlrm_flexflow_tpu_torch.resilience import NaNSentinel, faultinject

TABLES = [40, 60]
D, BAG, BATCH, LR = 8, 2, 8, 0.1
TOL = 1e-6


@pytest.fixture(autouse=True)
def _jax_numpy_branches(monkeypatch):
    """The JAX hetero callbacks take their numpy branches, so no JAX test
    runs ``make`` in native/."""
    monkeypatch.setattr(jnative, "native_available", lambda: False)


def _cfg(pkg_cfg):
    return pkg_cfg(sparse_feature_size=D, embedding_size=list(TABLES),
                   embedding_bag_size=BAG, mlp_bot=[4, 8, D],
                   mlp_top=[D * 2 + D, 8, 1])


def _cpu_strategy(pkg, pc_mod):
    s = pkg.Strategy()
    for i in range(len(TABLES)):
        s[f"emb_{i}"] = pc_mod.ParallelConfig(dims=(1, 1), device_type="cpu",
                                              device_ids=[0])
    return s


def _jax_model():
    m = jax_build_dlrm(_cfg(JaxDLRMConfig), ffj.FFConfig(batch_size=BATCH),
                       stacked_embeddings=False)
    m.compile(optimizer=ffj.SGDOptimizer(lr=LR),
              loss_type="mean_squared_error", metrics=(),
              strategy=_cpu_strategy(ffj, jpc), mesh=False)
    return m


def _port_model():
    m = build_dlrm(_cfg(DLRMConfig), fft.FFConfig(batch_size=BATCH),
                   stacked_embeddings=False)
    m.compile(optimizer=fft.SGDOptimizer(lr=LR),
              loss_type="mean_squared_error", metrics=(),
              strategy=_cpu_strategy(fft, ppc))
    return m


def _port_from_jax(jm, jstate):
    """A port hetero model holding the JAX model's params, optimizer
    state and host tables."""
    pm = _port_model()
    ps = pm.load_params(
        params_from_jax(jax.tree.map(np.asarray, jstate.params)),
        device="cpu",
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray,
                                                  jstate.opt_state)),
        host_tables=host_tables_from_jax(jm))
    return pm, ps


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = {"dense": rng.standard_normal((BATCH, 4)).astype(np.float32)}
        for i, rows in enumerate(TABLES):
            x[f"sparse_{i}"] = rng.integers(0, rows, size=(BATCH, BAG),
                                            dtype=np.int64)
        out.append((x, rng.integers(0, 2, size=(BATCH, 1)).astype(
            np.float32)))
    return out


def _tables(model):
    return {op.name: np.array(op.host_table.array)
            for op in model._hetero_ops}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= TOL, (what, err)


def _same_run(pm, ps, jm, jstate):
    """Every parameter (handles included) and host table within TOL."""
    jp = jax.tree.map(np.asarray, jstate.params)
    for op, d in jp.items():
        for k, v in d.items():
            _close(ps.params[op][k].numpy(), v, f"{op}/{k}")
    pt, jt = _tables(pm), _tables(jm)
    assert set(pt) == set(jt) == {"emb_0", "emb_1"}
    for k in jt:
        _close(pt[k], jt[k], f"host table {k}")


@pytest.fixture(scope="module")
def jax_steps():
    """JAX: the hetero model at init, then 3 train_steps, with its losses,
    handles and tables after each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "native_available", lambda: False)
        jm = _jax_model()
        st = jm.init(seed=0)
        init = (jax.tree.map(np.array, st.params),
                jax.tree.map(np.array, st.opt_state), _tables(jm))
        losses = []
        for x, y in _batches(3):
            st, mets = jm.train_step(st, x, y)
            losses.append(float(mets["loss"]))
        return {"model": jm, "state": st, "init": init, "losses": losses}


def _port_at_init(jax_steps):
    params, opt, tables = jax_steps["init"]
    pm = _port_model()
    ps = pm.load_params(params_from_jax(params), device="cpu",
                        opt_state=opt_state_from_jax(opt),
                        host_tables=tables)
    return pm, ps


# ----------------------------------------------------------------- the bag
@pytest.mark.parametrize("mode,native", [("sum", True), ("sum", False),
                                         ("avg", False)])
def test_host_embedding_bag_forward_and_deposit_match_jax(monkeypatch, mode,
                                                          native):
    """Forward (times a handle of 0.75) and the deposited host gradient
    bit for bit against the JAX custom VJP; the handle's gradient within
    TOL.  The cotangent is a fixed array, so both get the same one."""
    if not native:
        monkeypatch.setattr(pnative, "native_available", lambda: False)
    rng = np.random.default_rng(3)
    table = rng.standard_normal((30, D)).astype(np.float32)
    ids = rng.integers(0, 30, size=(6, 3), dtype=np.int64)
    ids[0] = [5, 5, 5]                                # one row thrice
    cot = rng.standard_normal((6, D)).astype(np.float32)
    jhetero.HostEmbeddingTable("hb", table)
    phetero.HostEmbeddingTable("hb", table)

    def jloss(handle):
        out = jhetero.host_embedding_bag(jnp.asarray(ids), handle, "hb", D,
                                         mode)
        return jnp.sum(out * cot), out
    (_, jout), jdh = jax.value_and_grad(jloss, has_aux=True)(
        jnp.float32(0.75))
    handle = torch.tensor(0.75, requires_grad=True)
    with phetero.timing() as times:
        out = phetero.host_embedding_bag(torch.from_numpy(ids), handle, "hb",
                                         D, mode)
        (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(
        phetero.HostEmbeddingTable._tables["hb/grad"],
        jhetero.HostEmbeddingTable._tables["hb/grad"])
    _close(handle.grad.numpy(), np.asarray(jdh), "d_handle")
    assert times["lookup"] > 0 and times["host_grad"] > 0
    before = phetero.HostEmbeddingTable._tables["hb"]
    ht = phetero.HostEmbeddingTable.__new__(phetero.HostEmbeddingTable)
    ht.key = "hb"
    phetero.apply_host_sgd(ht, 0.5)
    jt = jhetero.HostEmbeddingTable.__new__(jhetero.HostEmbeddingTable)
    jt.key = "hb"
    jhetero.apply_host_sgd(jt, 0.5)
    np.testing.assert_array_equal(ht.array, jt.array)
    assert ht.array is not before                     # rebound, not written
    np.testing.assert_array_equal(before, table)
    for store in (phetero.HostEmbeddingTable, jhetero.HostEmbeddingTable):
        store.drop("hb")
    assert "hb/grad" not in phetero.HostEmbeddingTable._tables


# --------------------------------------------------------- the native lib
def test_native_kernels_match_their_numpy_versions():
    """The ctypes binding of ffruntime.cpp (built from the repo's source)
    against the plain numpy versions: the sum and its gradient bit for
    bit; ``avg``'s forward within one f32 ulp (it multiplies by 1/bag
    where numpy divides) and its gradient within 1e-6 (the compiler may
    fuse each ``+= g * (1/bag)`` into one rounding, and a row that sums
    to near zero shows that as many ulps); the gather exact for f32,
    int64 and another dtype."""
    assert pnative.native_available()
    assert "_build" in pnative.get_lib()._name
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, size=(12, 5), dtype=np.int64)
    g = rng.standard_normal((12, 16)).astype(np.float32)
    np.testing.assert_array_equal(pnative.embedding_bag_cpu(table, ids, "sum"),
                                  phetero.bag_numpy(table, ids, "sum"))
    np.testing.assert_array_max_ulp(
        pnative.embedding_bag_cpu(table, ids, "avg"),
        phetero.bag_numpy(table, ids, "avg"), maxulp=1)
    np.testing.assert_array_equal(
        pnative.embedding_bag_cpu_grad(g, ids, 50, "sum"),
        phetero.bag_grad_numpy(table, ids, g, "sum"))
    np.testing.assert_allclose(
        pnative.embedding_bag_cpu_grad(g, ids, 50, "avg"),
        phetero.bag_grad_numpy(table, ids, g, "avg"), rtol=0, atol=TOL)
    idx = rng.integers(0, 50, size=(17,), dtype=np.int64)
    for src in (table, ids.repeat(10, axis=0)[:50],
                table.astype(np.float64)):
        np.testing.assert_array_equal(pnative.gather_rows(src, idx),
                                      src[idx])


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_data_loader_batches_equal_jax(monkeypatch, shuffle):
    """``NativeDataLoader`` (the JAX binding over the same library) yields
    the same batches in the same order, two epochs, and ``peek``."""
    monkeypatch.setattr(jnative, "_LIB", pnative.get_lib())
    rng = np.random.default_rng(5)
    inputs = {"dense": rng.standard_normal((40, 3)).astype(np.float32),
              "sparse": rng.integers(0, 9, size=(40, 2, 3), dtype=np.int64)}
    labels = rng.standard_normal((40, 1)).astype(np.float32)
    jl = jnative.NativeDataLoader(inputs, labels, 8, shuffle=shuffle, seed=2)
    pl = pnative.NativeDataLoader(inputs, labels, 8, shuffle=shuffle, seed=2)
    try:
        assert len(pl) == len(jl) == 5
        for _ in range(2):
            for (px, py), (jx, jy) in zip(pl, jl):
                assert set(px) == set(jx)
                for k in jx:
                    np.testing.assert_array_equal(px[k], jx[k])
                np.testing.assert_array_equal(py, jy)
        (px, py), (jx, jy) = pl.peek(), jl.peek()
        np.testing.assert_array_equal(py, jy)
        for k in jx:
            np.testing.assert_array_equal(px[k], jx[k])
    finally:
        pl.close()
        jl.close()


# --------------------------------------------------------------- training
def test_three_train_steps_match_jax(jax_steps):
    """From the JAX model's weights and host tables: 3 port train_steps
    give the JAX losses, MLP weights, handles (trained, as in JAX) and
    host tables within TOL; the ids stay in host memory, the tables take
    no row-sparse path and no step is captured."""
    pm, ps = _port_at_init(jax_steps)
    assert [op.name for op in pm._hetero_ops] == ["emb_0", "emb_1"]
    assert pm._sparse_ops == [] and pm._host_inputs == {"sparse_0",
                                                        "sparse_1"}
    assert set(ps.params["emb_0"]) == {"handle"}
    losses = []
    for x, y in _batches(3):
        ps, mets = pm.train_step(ps, x, y)
        losses.append(float(mets["loss"]))
    _close(losses, jax_steps["losses"], "losses")
    _same_run(pm, ps, jax_steps["model"], jax_steps["state"])
    assert float(ps.params["emb_0"]["handle"]) != 1.0
    assert pm.graph_captures == 0 and pm.graph_replays == 0


def test_train_epoch_equals_jax_loop_of_train_step(jax_steps):
    """The port's train_epoch on a hetero model applies the host update
    after every step: it equals JAX's loop of train_step (the staged
    epoch, cache and ladder are not taken)."""
    pm, ps = _port_at_init(jax_steps)
    batches = _batches(3)
    xs = {k: np.stack([b[0][k] for b in batches]) for k in batches[0][0]}
    ys = np.stack([b[1] for b in batches])
    pm.config.epoch_row_cache = "on"
    ps, folded = pm.train_epoch(ps, xs, ys)
    assert not pm._epoch_cache_active
    _close(float(folded["loss"]), np.mean(jax_steps["losses"]), "mean loss")
    _same_run(pm, ps, jax_steps["model"], jax_steps["state"])
    assert pm.graph_captures == 0


def test_set_learning_rate_moves_the_host_update_too(jax_steps):
    """``set_learning_rate`` syncs ``optimizer.lr``: the next host SGD
    step runs at the new rate, ``table - lr * grad`` bit for bit."""
    pm, ps = _port_at_init(jax_steps)
    ps = pm.set_learning_rate(ps, 0.025)
    before = _tables(pm)
    x, y = _batches(1)[0]
    pm.train_step(ps, x, y)
    for op in pm._hetero_ops:
        g = phetero.HostEmbeddingTable._tables[op.host_table.key + "/grad"]
        np.testing.assert_array_equal(op.host_table.array,
                                      before[op.name] - 0.025 * g)


def test_jax_train_epoch_leaves_the_host_table_unchanged():
    """A reference-side caveat, pinned: JAX's scanned train_epoch trains
    the MLPs and the handles but never applies the host update, so the
    host tables come back as they went in (ROADMAP.md Queue C)."""
    jm = _jax_model()
    st = jm.init(seed=0)
    before = _tables(jm)
    handle = float(st.params["emb_0"]["handle"])
    batches = _batches(2)
    xs = {k: np.stack([b[0][k] for b in batches]) for k in batches[0][0]}
    ys = np.stack([b[1] for b in batches])
    st, _ = jm.train_epoch(st, xs, ys)
    for k, v in _tables(jm).items():
        np.testing.assert_array_equal(v, before[k])
    assert float(st.params["emb_0"]["handle"]) != handle


def test_fit_matches_jax_fit():
    """``fit`` (warmup step, 2 epochs of 4 batches) against JAX's fit: the
    per-batch path in both, the same weights and host tables within
    TOL; no staged epoch and no capture in the port."""
    jm = _jax_model()
    st = jm.init(seed=0)
    pm, ps = _port_from_jax(jm, st)
    batches = _batches(4, seed=7)
    x = {k: np.concatenate([b[0][k] for b in batches]) for k in batches[0][0]}
    y = np.concatenate([b[1] for b in batches])
    st, _ = jm.fit(st, jloader.ArrayDataLoader(x, y, BATCH), epochs=2,
                   verbose=False)
    ps, _ = pm.fit(ps, ploader.ArrayDataLoader(x, y, BATCH), epochs=2,
                   verbose=False)
    assert not pm._last_fit_used_scan and pm.graph_captures == 0
    _same_run(pm, ps, jm, st)


def test_prefetching_fit_equals_the_plain_fit():
    """``FFConfig(prefetch_depth=2)``: the prefetcher keeps the host
    tables' ids on the host, and the fit equals the synchronous one bit
    for bit."""
    out = []
    for depth in (0, 2):
        pm = build_dlrm(_cfg(DLRMConfig), fft.FFConfig(
            batch_size=BATCH, prefetch_depth=depth), stacked_embeddings=False)
        pm.compile(optimizer=fft.SGDOptimizer(lr=LR), metrics=(),
                   strategy=_cpu_strategy(fft, ppc))
        ps = pm.init(seed=0, device="cpu")
        assert pm.batch_placer().host == {"sparse_0", "sparse_1"}
        ps, _ = pm.fit(ps, ploader.SyntheticDLRMLoader(
            32, 4, TABLES, BAG, BATCH, stacked=False), epochs=2,
            verbose=False)
        out.append((ps, _tables(pm)))
    for k, v in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][k], v)
    for op, d in out[0][0].params.items():
        for k, v in d.items():
            assert torch.equal(out[1][0].params[op][k], v), (op, k)


def test_sentinel_rollback_restores_the_host_tables():
    """JAX tests/test_resilience.py:309 through both packages: a NaN batch
    at step 1 under NaNSentinel("skip") is rolled back, host tables
    included; 3 of 4 batches adopted, the tables finite and within TOL of
    the JAX run's."""
    jm = _jax_model()
    st = jm.init(seed=0)
    pm, ps = _port_from_jax(jm, st)
    loader = dict(num_samples=32, num_dense=4, table_sizes=TABLES,
                  bag_size=BAG, batch_size=BATCH, seed=2, stacked=False)
    try:
        jfault.install("nan_grads@step=1")
        st, _ = jm.fit(st, jloader.SyntheticDLRMLoader(**loader), epochs=1,
                       verbose=False, sentinel=JaxNaNSentinel(policy="skip"))
        jfault.clear()
        faultinject.install("nan_grads@step=1")
        ps, _ = pm.fit(ps, ploader.SyntheticDLRMLoader(**loader), epochs=1,
                       verbose=False, sentinel=NaNSentinel(policy="skip"))
    finally:
        jfault.clear()
        faultinject.clear()
    for k, v in _tables(pm).items():
        assert np.isfinite(v).all(), f"{k} poisoned by the NaN batch"
    assert len(pm._fit_loss_trace) == len(jm._fit_loss_trace) == 3
    _close(pm._fit_loss_trace, jm._fit_loss_trace, "loss trace")
    _same_run(pm, ps, jm, st)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_round_trip_keeps_host_tables(tmp_path, direction):
    """A trained hetero state saved by one package (npz, with the model)
    and restored by the other: the host tables byte for byte in the live
    ops, the params equal; from the same state both packages write the
    same npz keys, in the same order, with the same bytes."""
    jm = _jax_model()
    st = jm.init(seed=0)
    x, y = _batches(1, seed=9)[0]
    st, _ = jm.train_step(st, x, y)
    pm, ps = _port_from_jax(jm, st)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), st, use_orbax=False,
                                  model=jm)
    ppath = save_checkpoint(str(tmp_path / "p"),
                            state_from_jax(jax.tree.map(np.asarray, st)),
                            model=pm)
    with np.load(f"{jpath}/state.npz") as a, np.load(f"{ppath}/state.npz") as b:
        assert a.files == b.files
        assert {"host_tables/emb_0", "host_tables/emb_1"} <= set(a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    want = _tables(jm)
    if direction == "jax_to_port":
        target = _port_model()
        target.init(seed=5, device="cpu")
        got = restore_checkpoint(jpath, target, device="cpu")
        np.testing.assert_array_equal(got.params["bot_0"]["kernel"].numpy(),
                                      np.asarray(st.params["bot_0"]["kernel"]))
    else:
        target = _jax_model()
        target.init(seed=5)
        got = jckpt.restore_checkpoint(ppath, model=target)
        np.testing.assert_array_equal(np.asarray(got.params["top_1"]["kernel"]),
                                      ps.params["top_1"]["kernel"].numpy())
    for k, v in _tables(target).items():
        assert v.tobytes() == want[k].tobytes(), k


def test_model_checkpoint_callback_holds_the_host_tables(tmp_path):
    """``ModelCheckpoint`` saves with ``model=``: its checkpoint carries
    the trained host tables, and a restore puts them back."""
    from dlrm_flexflow_tpu_torch.frontends.keras_callbacks import \
        ModelCheckpoint
    pm = _port_model()
    ps = pm.init(seed=0, device="cpu")
    batches = _batches(2, seed=11)
    x = {k: np.concatenate([b[0][k] for b in batches]) for k in batches[0][0]}
    y = np.concatenate([b[1] for b in batches])
    cb = ModelCheckpoint(str(tmp_path / "ck"))
    ps, _ = pm.fit(ps, ploader.ArrayDataLoader(x, y, BATCH), epochs=1,
                   verbose=False, callbacks=[cb])
    trained = _tables(pm)
    with np.load(str(tmp_path / "ck" / "state.npz")) as z:
        for k, v in trained.items():
            np.testing.assert_array_equal(z[f"host_tables/{k}"], v)
    for op in pm._hetero_ops:
        op.host_table.array = np.zeros_like(op.host_table.array)
    restore_checkpoint(str(tmp_path / "ck"), pm, device="cpu")
    for k, v in _tables(pm).items():
        np.testing.assert_array_equal(v, trained[k])


def test_two_models_keep_their_own_tables_and_serve_eagerly():
    """Store keys are per op instance; an engine over a hetero model runs
    eagerly (a host lookup cannot be captured) and answers as
    ``predict``; the table never lands in the params."""
    from dlrm_flexflow_tpu_torch.serving import InferenceEngine
    m1, m2 = _port_model(), _port_model()
    s1, s2 = m1.init(seed=0, device="cpu"), m2.init(seed=1, device="cpu")
    k1, k2 = (m.get_op("emb_0").host_table.key for m in (m1, m2))
    assert k1 != k2
    assert not np.array_equal(m1.get_op("emb_0").host_table.array,
                              m2.get_op("emb_0").host_table.array)
    engine = InferenceEngine(m1, s1, "8", device="cpu")
    assert not any(r.capture for r in engine._graphs.values())
    x, _ = _batches(1, seed=12)[0]
    np.testing.assert_array_equal(engine.predict(x),
                                  m1.predict(s1, x).numpy())


# ------------------------------------------------- the three repaired faults
def test_c1_initializers_take_seed_and_norm():
    """``UniformInitializer(minval, maxval, seed)`` and
    ``NormInitializer(mean, stddev, seed)`` as in JAX: seed 0 draws what
    the generator draws (today's values bit for bit), a nonzero seed
    changes the draw and leaves the generator where it was; the moments
    are the distribution's."""
    def gen():
        return torch.Generator().manual_seed(11)
    ref = torch.empty(64, 8).uniform_(-0.1, 0.1, generator=gen())
    torch.testing.assert_close(pinit.UniformInitializer(-0.1, 0.1)(
        gen(), (64, 8)), ref, rtol=0, atol=0)
    g = gen()
    seeded = pinit.UniformInitializer(-0.1, 0.1, 7)(g, (64, 8))
    assert not torch.equal(seeded, ref)
    assert torch.equal(g.get_state(), gen().get_state())
    assert torch.equal(seeded,
                       pinit.UniformInitializer(-0.1, 0.1, 7)(gen(), (64, 8)))
    assert not torch.equal(seeded, pinit.UniformInitializer(-0.1, 0.1, 8)(
        gen(), (64, 8)))
    assert float(seeded.min()) >= -0.1 and float(seeded.max()) < 0.1
    for p_args, j_cls in (((-0.1, 0.1, 7), ffj.UniformInitializer),
                          ((0.5, 2.0, 3), ffj.NormInitializer)):
        j = j_cls(*p_args)
        p = getattr(fft, j_cls.__name__)(*p_args)
        assert vars(p) == vars(j)
    zero = torch.empty(4000, 50).normal_(generator=gen())
    norm = pinit.NormInitializer(0.5, 2.0)(gen(), (4000, 50))
    torch.testing.assert_close(norm, 0.5 + 2.0 * zero, rtol=0, atol=0)
    for seed in (0, 3):
        d = pinit.NormInitializer(0.5, 2.0, seed)(gen(), (4000, 50))
        jd = np.asarray(ffj.NormInitializer(0.5, 2.0, seed)(
            jax.random.PRNGKey(0), (4000, 50)))
        for x in (d.numpy(), jd):
            assert abs(float(x.mean()) - 0.5) < 0.02
            assert abs(float(x.std()) - 2.0) < 0.02
    assert not torch.equal(pinit.NormInitializer(0.5, 2.0, 3)(
        gen(), (4000, 50)), norm)


def test_c2_the_jax_root_names_are_on_the_port_root():
    """Every name of the JAX package's ``__all__`` is on the port's root
    and in its ``__all__``, and ``__version__`` is the JAX one."""
    missing = [n for n in ffj.__all__
               if not (hasattr(fft, n) and n in fft.__all__)]
    assert missing == []
    assert fft.__version__ == ffj.__version__ == "0.1.0"
    from dlrm_flexflow_tpu_torch import (DeadlineExceeded, ParallelConfig,
                                         Rejected, Strategy)
    assert Strategy is ppc.Strategy and ParallelConfig is ppc.ParallelConfig
    assert issubclass(Rejected, Exception) and issubclass(DeadlineExceeded,
                                                          Exception)


def test_c3_cpu_entry_on_an_op_without_placement_is_ignored(tmp_path):
    """The generator's hetero strategy on the stacked graph: both packages
    compile it with no host op (a "cpu" config on an op without a
    placement is ignored), and the port's step equals the step compiled
    without the strategy bit for bit.  The per-table form, as a
    reference .pb, places both tables on the host."""
    jm = jax_build_dlrm(_cfg(JaxDLRMConfig), ffj.FFConfig(batch_size=BATCH))
    jm.compile(optimizer=ffj.SGDOptimizer(lr=LR), metrics=(),
               strategy=jpb.dlrm_strategy(2, 1, hetero_cpu_embeddings=True),
               mesh=False)
    assert jm._hetero_ops == []
    losses = []
    for strategy in (ppb.dlrm_strategy(2, 1, hetero_cpu_embeddings=True),
                     None):
        pm = build_dlrm(_cfg(DLRMConfig), fft.FFConfig(batch_size=BATCH))
        pm.compile(optimizer=fft.SGDOptimizer(lr=LR), metrics=(),
                   strategy=strategy)
        assert pm._hetero_ops == [] and pm._host_inputs == frozenset()
        ps = pm.init(seed=0, device="cpu")
        x, y = _batches(1, seed=13)[0]
        stacked = {"dense": x["dense"],
                   "sparse": np.stack([x["sparse_0"], x["sparse_1"]], 1)}
        ps, mets = pm.train_step(ps, stacked, y)
        losses.append(mets["loss"])
    assert torch.equal(losses[0], losses[1])
    pb = str(tmp_path / "hetero.pb")
    ppb.dlrm_strategy(2, 1, hetero_cpu_embeddings=True,
                      stacked=False).save(pb)
    pm = build_dlrm(_cfg(DLRMConfig), fft.FFConfig(
        batch_size=BATCH, import_strategy_file=pb), stacked_embeddings=False)
    pm.compile(optimizer=fft.SGDOptimizer(lr=LR), metrics=())
    assert [op.name for op in pm._hetero_ops] == ["emb_0", "emb_1"]
