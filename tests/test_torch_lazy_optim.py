"""The port's row-lazy optimizers (``lazy_embeddings=True``: momentum and
Adam applied to embedding rows on touch, ``FFModel._lazy_update``) against
the JAX package on the CPU: the counterpart of tests/test_lazy_optim.py,
on its small ``build_dlrm`` (sparse 8, tables 64 and 96 or 64 and 64,
bag 2, ids drawn from a quarter of each table, so duplicates are heavy).
JAX is imported here only.

Tolerances, each with its reason:
  * the port against JAX after 4 steps from the same weights: parameters
    rtol 1e-4, atol 1e-5; the slot tables rtol 1e-4, atol 1e-5 times
    their largest magnitude (Adam's v is ~1e-6, where 1e-5 would say
    nothing); losses rtol 1e-3, the repo's precedent for reordered
    reductions (the port's Linear accumulates in f64 and rounds once);
  * the port against itself (cached, laddered and uncached epochs):
    bit for bit, parameters and slot tables: the same adds in the same
    order, only the row addressing differs;
  * against ``torch.optim.SparseAdam`` and a hand-written momentum loop:
    the JAX test's rtol 2e-5 / atol 2e-6 and rtol 1e-5 / atol 1e-6.

On the CPU every row update runs the row-update kernel's plain version
(``row_update_ref``); chip_smoke.py phase 21 holds the kernel path to it
on the card.
"""

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import epoch_cache
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import opt_state_from_jax, params_from_jax

D, BATCH = 8, 8
LR = 0.05


def _kw(tables):
    return dict(sparse_feature_size=D, embedding_size=list(tables),
                embedding_bag_size=2, mlp_bot=[4, D],
                mlp_top=[D * 2 + D, 8, 1])


def _optimizer(pkg, kind, lazy=True):
    if kind == "adam":
        return pkg.AdamOptimizer(lr=LR, lazy_embeddings=lazy)
    return pkg.SGDOptimizer(lr=LR, momentum=0.9, lazy_embeddings=lazy)


def _port(kind, tables=(64, 96), lazy=True, batch=BATCH, **config):
    m = build_dlrm(DLRMConfig(**_kw(tables)),
                   fft.FFConfig(batch_size=batch, **config))
    m.compile(optimizer=_optimizer(fft, kind, lazy),
              loss_type="mean_squared_error", metrics=("accuracy",))
    return m


def _data(tables, nb, batch=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    inputs = {"dense": rng.standard_normal((nb, batch, 4)).astype(np.float32),
              "sparse": np.stack([rng.integers(0, r // 4, size=(nb, batch, 2),
                                               dtype=np.int64)
                                  for r in tables], axis=2)}
    labels = rng.integers(0, 2, size=(nb, batch, 1)).astype(np.float32)
    return inputs, labels


def _slots(state, kind):
    return {sn: state.opt_state[sn]["emb"]["embedding"]
            for sn in (("m", "v") if kind == "adam" else ("v",))}


# ------------------------------------------------------ against JAX
@pytest.mark.parametrize("tables", [(64, 96), (64, 64)],
                         ids=["ragged_2d", "stacked_3d"])
@pytest.mark.parametrize("kind", ["adam", "momentum"])
def test_lazy_steps_match_jax(kind, tables):
    """Four lazy steps in both packages from the same weights and batches:
    the parameters, the slot tables (2-D ragged and 3-D stacked) and the
    loss trajectory."""
    jm = jax_build_dlrm(JaxDLRMConfig(**_kw(tables)),
                        ffj.FFConfig(batch_size=BATCH,
                                     epoch_row_cache="off"))
    jm.compile(optimizer=_optimizer(ffj, kind),
               loss_type="mean_squared_error", metrics=("accuracy",),
               mesh=False)
    pm = _port(kind, tables, epoch_row_cache="off")
    assert jm._sparse_emb_ops == ["emb"]
    assert [op.name for op in pm._sparse_ops] == ["emb"]
    js = jm.init(seed=0)
    ps = pm.load_params(
        params_from_jax(jax.tree.map(np.asarray, js.params)), device="cpu",
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state)))
    inputs, labels = _data(tables, 4)
    jl, pl = [], []
    for i in range(4):
        x = {k: v[i] for k, v in inputs.items()}
        js, jmets = jm.train_step(
            js, {**x, "sparse": x["sparse"].astype(np.int32)}, labels[i])
        ps, pmets = pm.train_step(ps, x, labels[i])
        jl.append(float(jmets["loss"]))
        pl.append(float(pmets["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=1e-3)
    assert int(ps.opt_state["step"]) == int(js.opt_state["step"]) == 4
    for op, params in js.params.items():
        for k, v in params.items():
            np.testing.assert_allclose(ps.params[op][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{op}/{k}")
    for sn, got in _slots(ps, kind).items():
        want = np.asarray(js.opt_state[sn]["emb"]["embedding"])
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=sn)


# -------------------------------------------------- within the port
def _count_row_sets(monkeypatch):
    calls = []
    real = epoch_cache.row_set_cuda

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(epoch_cache, "row_set_cuda", counted)
    return calls


@pytest.mark.parametrize("ladder", [False, True], ids=["epoch", "ladder"])
@pytest.mark.parametrize("kind", ["adam", "momentum"])
def test_lazy_cached_and_laddered_equal_uncached(kind, ladder, monkeypatch):
    """Two epochs cached (an epoch cache of 128 of the 256 rows; with the
    ladder "4,2" two in-graph levels inside it) and uncached give the
    same parameter and slot-table bits: the slot tables are cached with
    the weights' rowof and slots and written back with them."""
    nb, batch = (8, 4) if ladder else (4, BATCH)
    levels = "4,2" if ladder else "off"
    inputs, labels = _data((64, 96), nb, batch)
    states = {}
    calls = _count_row_sets(monkeypatch)
    for cache in ("on", "off"):
        m = _port(kind, batch=batch, epoch_row_cache=cache,
                  epoch_cache_levels=levels)
        st = m.init(seed=0, device="cpu")
        for _ in range(2):
            st, _ = m.train_epoch(st, inputs, labels)
        assert m._epoch_cache_active == (cache == "on")
        states[cache] = st
    # every writeback of the weights and of each slot table: the epilogue,
    # and with the ladder the 2 + 4 blocks of each epoch
    tables = 1 + len(_slots(states["on"], kind))
    assert len(calls) == 2 * tables * (7 if ladder else 1)
    a, b = states["on"], states["off"]
    for op, params in a.params.items():
        for k, v in params.items():
            assert torch.equal(v, b.params[op][k]), (op, k)
    for sn, v in _slots(a, kind).items():
        assert torch.equal(v, _slots(b, kind)[sn]), sn
        assert v.abs().max() > 0


def test_lazy_staged_fit_equals_train_epochs():
    """``fit``'s staged branch (one ``train_epochs``, cached) gives the
    bits of ``train_epochs`` uncached, slot tables included."""
    inputs, labels = _data((64, 96), 4)
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in inputs.items()}
    loader = fft.ArrayDataLoader(flat, labels.reshape(-1, 1), BATCH,
                                 shuffle=False)
    m = _port("adam", epoch_row_cache="on", epoch_cache_levels="off")
    fit_state, _ = m.fit(m.init(seed=0, device="cpu"), loader, epochs=2,
                         verbose=False, warmup=False)
    assert m._last_fit_used_scan and m._epoch_cache_active
    off = _port("adam", epoch_row_cache="off")
    st, _ = off.train_epochs(off.init(seed=0, device="cpu"), inputs, labels,
                             2)
    for op, params in st.params.items():
        for k, v in params.items():
            assert torch.equal(v, fit_state.params[op][k]), (op, k)
    for sn in ("m", "v"):
        assert torch.equal(_slots(st, "adam")[sn],
                           _slots(fit_state, "adam")[sn])


# ------------------------------------------- against torch and by hand
def test_lazy_adam_matches_torch_sparse_adam():
    """ids -> bag sum -> sum -> MSE against 0, so d loss / d rows is the
    same in both: lazy Adam against ``torch.optim.SparseAdam`` on an
    ``EmbeddingBag`` (JAX test_lazy_optim.py:203)."""
    rows, d, batch, bag, steps = 32, 4, 8, 2, 5
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((rows, d)).astype(np.float32)
    ids = rng.integers(0, rows, size=(steps, batch, bag))
    emb = torch.nn.EmbeddingBag(rows, d, mode="sum", sparse=True)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(w0))
    opt = torch.optim.SparseAdam(emb.parameters(), lr=LR)
    for s in range(steps):
        opt.zero_grad()
        loss = (emb(torch.from_numpy(ids[s])).sum(dim=1) ** 2).mean()
        loss.backward()
        opt.step()
    want = emb.weight.detach().numpy()

    model = fft.FFModel(fft.FFConfig(batch_size=batch,
                                     epoch_row_cache="off"))
    t_ids = model.create_tensor((batch, bag), "int32", name="ids")
    model.embedding(t_ids, rows, d, aggr="sum", name="e")
    model.compile(optimizer=fft.AdamOptimizer(lr=LR, lazy_embeddings=True),
                  loss_type=lambda preds, labels: torch.mean(
                      torch.square(torch.sum(preds, dim=-1))),
                  metrics=())
    assert [op.name for op in model._sparse_ops] == ["e"]
    st = model.load_params({"e": {"embedding": w0}}, device="cpu")
    dummy = np.zeros((batch, 1), np.float32)
    for s in range(steps):
        st, _ = model.train_step(st, {"ids": ids[s].astype(np.int32)}, dummy)
    np.testing.assert_allclose(st.params["e"]["embedding"].numpy(), want,
                               rtol=2e-5, atol=2e-6)


def test_lazy_momentum_matches_manual_reference():
    """One row updated twice with a gap: its velocity decays only on the
    steps that touch it (JAX test_lazy_optim.py:249)."""
    rows, d, batch = 16, 4, 4
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((rows, d)).astype(np.float32)
    model = fft.FFModel(fft.FFConfig(batch_size=batch,
                                     epoch_row_cache="off"))
    t_ids = model.create_tensor((batch, 1), "int32", name="ids")
    model.embedding(t_ids, rows, d, aggr="sum", name="e")
    model.compile(optimizer=fft.SGDOptimizer(lr=0.1, momentum=0.9,
                                             lazy_embeddings=True),
                  loss_type=lambda preds, labels: torch.sum(preds),
                  metrics=())
    st = model.load_params({"e": {"embedding": w0}}, device="cpu")
    dummy = np.zeros((batch, 1), np.float32)
    step_ids = [np.full((batch, 1), 3), np.full((batch, 1), 7),
                np.full((batch, 1), 3)]
    for ids in step_ids:
        st, _ = model.train_step(st, {"ids": ids.astype(np.int32)}, dummy)
    w, v = w0.copy(), np.zeros_like(w0)
    for ids in step_ids:
        r = int(ids[0, 0])
        v[r] = 0.9 * v[r] + float(batch)  # the batch's summed occurrences
        w[r] = w[r] - 0.1 * v[r]
    np.testing.assert_allclose(st.params["e"]["embedding"].numpy(), w,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.opt_state["v"]["e"]["embedding"].numpy(),
                               v, rtol=1e-5, atol=1e-6)


def test_lazy_adam_bias_correction_reads_the_step_before_the_update():
    """The dense update advances ``opt_state["step"]`` in place before
    the rows step; the rows must still use t = 1 on the first step:
    alpha_1 = lr sqrt(1 - b2) / (1 - b1).  Read after the increment (t =
    2), alpha would be 0.74 of it."""
    m = _port("adam", epoch_row_cache="off")
    st = m.init(seed=0, device="cpu")
    before = st.params["emb"]["embedding"].clone().double()
    inputs, labels = _data((64, 96), 1)
    st, _ = m.train_step(st, {k: v[0] for k, v in inputs.items()}, labels[0])
    assert int(st.opt_state["step"]) == 1
    moved = (st.params["emb"]["embedding"].double() - before).abs()
    m1 = st.opt_state["m"]["emb"]["embedding"].double()
    v1 = st.opt_state["v"]["emb"]["embedding"].double()
    alpha1 = LR * np.sqrt(1 - 0.999) / (1 - 0.9)
    touched = m1 != 0
    assert int(touched.any(dim=1).sum()) > 8
    np.testing.assert_allclose(moved[touched].numpy(),
                               (alpha1 * m1.abs() / (v1.sqrt() + 1e-8)
                                )[touched].numpy(), rtol=1e-4)
    assert not bool(moved[~touched].any())


# ------------------------------------------------ dense-fallback choice
@pytest.mark.parametrize("kind", ["adam", "momentum"])
def test_without_the_flag_tables_take_the_dense_gradient(kind):
    """``lazy_embeddings=False`` keeps momentum and Adam on the dense table
    gradient (JAX test_lazy_optim.py:40-49): no row-sparse op, no epoch
    cache, and a row's stale slot keeps moving it on steps that do not
    touch it (the lazy step would leave it)."""
    m = _port(kind, lazy=False, epoch_row_cache="on")
    assert m._sparse_ops == [] and m._lazy_slots == ()
    lazy = _port(kind, epoch_row_cache="on")
    assert [op.name for op in lazy._sparse_ops] == ["emb"]
    assert lazy._lazy_slots == (("m", "v") if kind == "adam" else ("v",))
    inputs, labels = _data((64, 96), 2)
    st = m.init(seed=0, device="cpu")
    st, _ = m.train_step(st, {k: v[0] for k, v in inputs.items()}, labels[0])
    before = st.params["emb"]["embedding"].clone()
    st, _ = m.train_epoch(st, {k: v[1:] for k, v in inputs.items()},
                          labels[1:])
    assert not m._epoch_cache_active
    slot = st.opt_state["m" if kind == "adam" else "v"]["emb"]["embedding"]
    changed = (st.params["emb"]["embedding"] != before).any(dim=1)
    assert torch.equal(changed, (slot != 0).any(dim=1))
    second = torch.zeros_like(changed)
    second[lazy.get_op("emb").flat_ids(
        torch.from_numpy(inputs["sparse"][1])).reshape(-1)] = True
    assert bool((changed & ~second).any())
