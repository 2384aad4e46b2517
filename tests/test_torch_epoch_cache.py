"""The port's staged epoch and its epoch row cache
(dlrm_flexflow_tpu_torch/epoch_cache.py, ops/slotting.py and the epoch
entry points of model.py) against the JAX package on the CPU.

  * ``slot_rows``, ``ladder_sizes`` and ``_epoch_chunk_bounds`` are
    integer or shape math: equal to the JAX package's exactly;
  * a cached epoch (``epoch_row_cache="on"``) equals the uncached one bit
    for bit, as the JAX package's own ``TestEpochRowCache`` pins for JAX:
    the same adds hit the same values in the same order;
  * the port's cached epochs against the JAX package's cached epochs on
    transferred weights: losses rtol 1e-5, parameters rtol 1e-4 and
    atol 1e-6, as ``test_torch_training_slice.py`` (the port's Linear
    accumulates in f64 and rounds once);
  * ``fit``'s staged branch against ``train_epoch(s)``: bit for bit.

Every writeback goes through ``epoch_cache.row_set_cuda``; the tests
count its calls by wrapping it.  On the CPU it runs the plain version.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.data.loader import ArrayDataLoader as JaxArrayDataLoader
from dlrm_flexflow_tpu.ops.slotting import slot_rows as jax_slot_rows

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import epoch_cache
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import opt_state_from_jax, params_from_jax
from dlrm_flexflow_tpu_torch.ops.row_set_kernel import row_set_cuda
from dlrm_flexflow_tpu_torch.ops.slotting import slot_rows

D, BATCH, BAG = 8, 16, 2
BIG = {"stacked": [4096] * 3, "ragged": [4096, 1396, 2048]}
SMALL = {"stacked": [64] * 3, "ragged": [64, 96, 32]}


# ------------------------------------------------------------ slot_rows
@pytest.mark.parametrize("kind", ["random", "all_equal", "sorted", "single",
                                  "multi_dim"])
def test_slot_rows_equals_jax(kind):
    rng = np.random.default_rng(1)
    rows = 500
    ids = {"random": rng.integers(0, rows, size=300),
           "all_equal": np.full(64, 77),
           "sorted": np.sort(rng.integers(0, rows, size=128)),
           "single": np.array([rows - 1]),
           "multi_dim": rng.integers(0, 40, size=(4, 16, 3, 2))}[kind]
    prowof, pslots = slot_rows(torch.from_numpy(ids), rows)
    jrowof, jslots = jax_slot_rows(jnp.asarray(ids.astype(np.int32)), rows)
    assert prowof.dtype == pslots.dtype == torch.int32
    np.testing.assert_array_equal(prowof.numpy(), np.asarray(jrowof))
    np.testing.assert_array_equal(pslots.numpy(), np.asarray(jslots))
    assert torch.equal(prowof[pslots.long()], torch.from_numpy(ids).int())


# --------------------------------------------------- shape math vs JAX
def _cell(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@functools.lru_cache(maxsize=1)
def _jax_shape_model():
    """A compiled JAX model and its ``ladder_sizes`` closure (compile's
    closures read the config at call time, so one model serves every
    grid point)."""
    cfg = JaxDLRMConfig(sparse_feature_size=D, embedding_size=[4096] * 2,
                        embedding_bag_size=BAG, mlp_bot=[4, 16, D],
                        mlp_top=[3 * D, 16, 1])
    m = jax_build_dlrm(cfg, ffj.FFConfig(batch_size=BATCH,
                                         epoch_row_cache="on"))
    m.compile(optimizer=ffj.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", mesh=False)
    ladder_meta = _cell(_cell(m._train_epoch.__wrapped__, "ladder_plan"),
                        "ladder_meta")
    return m, _cell(ladder_meta, "ladder_sizes")


NBS = [1, 7, 8, 9, 16, 24, 63, 64, 65, 72, 128, 256, 1000, 1001]


@pytest.mark.parametrize("inner", [0, 1, 2, 8])
@pytest.mark.parametrize("levels", ["auto", "off", "8,4,2", "16"])
def test_ladder_sizes_and_chunk_bounds_equal_jax(levels, inner):
    jm, jax_ladder_sizes = _jax_shape_model()
    pm = fft.FFModel()
    for chunk in (0, 4, 16, 256):
        for c in (jm.config, pm.config):
            c.epoch_cache_levels, c.epoch_cache_inner = levels, inner
            c.epoch_cache_chunk = chunk
        for active in (True, False):
            jm._epoch_cache_active = pm._epoch_cache_active = active
            for nb in NBS:
                key = (levels, inner, chunk, active, nb)
                assert pm._epoch_chunk_bounds(nb) == \
                    jm._epoch_chunk_bounds(nb), key
                assert epoch_cache.ladder_sizes(pm.config, nb) == \
                    jax_ladder_sizes(nb, False), key


# ------------------------------------------------ cached equals uncached
def _graph(kind, big):
    """The DLRM graph of ``kind`` at width D: a StackedEmbedding
    ("stacked"), one Embedding per table ("per_table"), a
    RaggedStackedEmbedding ("ragged") or a FusedEmbedInteract ("fused")."""
    rows = (BIG if big else SMALL)["stacked" if kind == "stacked"
                                   else "ragged"]
    t = len(rows)
    return dict(sparse_feature_size=D, embedding_size=list(rows),
                embedding_bag_size=BAG, mlp_bot=[4, 16, D],
                mlp_top=[D + t * D, 16, 1],
                fused_interaction="on" if kind == "fused" else "off"), \
        kind != "per_table"


def _data(rows, stacked, nb, seed, narrow=200):
    """``nb`` stacked batches; ids from a narrow range, so rows repeat
    within and across steps and blocks."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, min(r, narrow), size=(nb, BATCH, BAG))
            for r in rows]
    inputs = {"dense": rng.standard_normal((nb, BATCH, 4)).astype(
        np.float32)}
    if stacked:
        inputs["sparse"] = np.stack(cols, axis=2)
    else:
        inputs.update({f"sparse_{i}": c for i, c in enumerate(cols)})
    return inputs, rng.integers(0, 2, size=(nb, BATCH, 1)).astype(
        np.float32)


def _port_model(kw, stacked, **cfg):
    m = build_dlrm(DLRMConfig(**kw), fft.FFConfig(batch_size=BATCH, **cfg),
                   stacked_embeddings=stacked)
    m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error",
              metrics=("accuracy", "mean_squared_error"))
    return m


@pytest.fixture
def writebacks(monkeypatch):
    """Counts the cache's row-set calls (every writeback goes through
    ``epoch_cache.row_set_cuda``)."""
    calls = []

    def counted(table, ids, rows):
        calls.append(ids.numel())
        return row_set_cuda(table, ids, rows)

    monkeypatch.setattr(epoch_cache, "row_set_cuda", counted)
    return calls


def _assert_same(a, b):
    for op, params in a.params.items():
        for k, v in params.items():
            assert torch.equal(v, b.params[op][k]), f"{op}/{k}"
    assert int(a.step) == int(b.step)


def _assert_same_metrics(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("big", [True, False])
@pytest.mark.parametrize("kind", ["stacked", "per_table", "ragged", "fused"])
def test_cached_equals_uncached_epoch(kind, big, writebacks):
    """16 steps, the auto ladder [8]: two block caches inside the epoch
    cache.  Small tables clamp: no cache would be smaller than its
    table, so every op stays on the per-step path."""
    kw, stacked = _graph(kind, big)
    inputs, labels = _data(kw["embedding_size"], stacked, 16, seed=2)
    runs = {}
    for mode in ("on", "off"):
        m = _port_model(kw, stacked, epoch_row_cache=mode)
        st = m.init(seed=0, device="cpu")
        runs[mode] = m.train_epoch(st, inputs, labels) + (m,)
    (st_c, mets_c, m_c), (st_u, mets_u, _) = runs["on"], runs["off"]
    _assert_same(st_c, st_u)
    _assert_same_metrics(mets_c, mets_u)
    n_ops = len(m_c._sparse_ops)
    assert n_ops == (3 if kind == "per_table" else 1)
    # per op: two block writebacks into the epoch cache, one epilogue
    assert len(writebacks) == (3 * n_ops if big else 0)


def test_auto_cache_stays_off_on_the_cpu(writebacks):
    kw, stacked = _graph("stacked", True)
    m = _port_model(kw, stacked)
    st = m.init(seed=0, device="cpu")
    m.train_epoch(st, *_data(kw["embedding_size"], stacked, 8, seed=3))
    assert not m._epoch_cache_active and not writebacks


@pytest.mark.parametrize("kind", ["stacked", "fused"])
def test_train_epochs_equals_repeated_train_epoch(kind, writebacks):
    """One prologue and epilogue across three epochs (4 blocks per epoch
    under the ladder [2]) against three cached epochs."""
    kw, stacked = _graph(kind, True)
    inputs, labels = _data(kw["embedding_size"], stacked, 8, seed=4)
    m = _port_model(kw, stacked, epoch_row_cache="on", epoch_cache_inner=2)
    st = m.init(seed=0, device="cpu")
    fused, stacked_mets = m.train_epochs(st.clone(), inputs, labels, 3)
    assert len(writebacks) == 3 * 4 + 1
    once, folded = st, []
    for _ in range(3):
        once, f = m.train_epoch(once, inputs, labels)
        folded.append(f)
    _assert_same(fused, once)
    for k, v in stacked_mets.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([f[k] for f in folded])), k


@pytest.mark.parametrize("levels,chunk", [("off", 4), ("off", 5),
                                          ("auto", 4)])
def test_chunked_epoch_equals_unchunked(levels, chunk, writebacks):
    """9 steps: with levels "off" (or an auto ladder that no level
    divides) the epoch runs as chunks, each with its own prologue and
    epilogue; rows updated in one chunk are re-cached by the next."""
    kw, stacked = _graph("stacked", True)
    inputs, labels = _data(kw["embedding_size"], stacked, 9, seed=5,
                           narrow=24)
    runs = {}
    for c in (chunk, 0):
        m = _port_model(kw, stacked, epoch_row_cache="on",
                        epoch_cache_levels=levels, epoch_cache_chunk=c)
        st = m.init(seed=0, device="cpu")
        m._resolve_cache(st.params["emb"]["embedding"].device)
        runs[c] = (m._epoch_chunk_bounds(9),) + m.train_epoch(st, inputs,
                                                              labels)
    bounds, st_c, mets_c = runs[chunk]
    assert bounds is not None and len(bounds) > 1
    assert runs[0][0] is None
    _assert_same(st_c, runs[0][1])
    np.testing.assert_allclose(float(mets_c["loss"]),
                               float(runs[0][2]["loss"]), rtol=1e-6)
    for k in ("train_all", "train_correct", "mse"):
        assert torch.equal(mets_c[k], runs[0][2][k]), k


# ------------------------------------------------------------------ fit
def _loader(inputs, labels, **kw):
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in inputs.items()}
    return fft.ArrayDataLoader(flat, labels.reshape(-1, 1), BATCH, **kw)


@pytest.mark.parametrize("epochs,cfg", [
    (2, {}),                                         # one train_epochs
    (1, {}),                                         # one train_epoch
    (2, {"epoch_cache_levels": "off",
         "epoch_cache_chunk": 4})])                  # chunked epochs
def test_fit_stages_array_loaders(epochs, cfg, writebacks):
    kw, stacked = _graph("stacked", True)
    inputs, labels = _data(kw["embedding_size"], stacked, 9 if cfg else 8,
                           seed=6)
    m = _port_model(kw, stacked, epoch_row_cache="on", **cfg)
    st = m.init(seed=0, device="cpu")
    by_fit, thpt = m.fit(st.clone(), _loader(inputs, labels), epochs=epochs,
                         verbose=False)
    assert m._last_fit_used_scan and thpt > 0
    by_fit_writes = len(writebacks)
    # fit's warmup is one real step on the first batch
    ref, _ = m.train_step(st, {k: v[0] for k, v in inputs.items()},
                          labels[0])
    ref, mets = m.train_epochs(ref, inputs, labels, epochs)
    _assert_same(by_fit, ref)
    assert int(by_fit.step) == 1 + epochs * labels.shape[0]
    assert by_fit_writes == len(writebacks) - by_fit_writes > 0
    last = m.get_perf_metrics().finalized_means()
    assert last["train_all"] == labels.shape[0] * BATCH
    np.testing.assert_allclose(last["mse"], float(mets["mse"][-1])
                               / last["train_all"], rtol=1e-6)


def test_fit_keeps_the_per_batch_loop_for_a_shuffled_loader():
    kw, stacked = _graph("stacked", True)
    inputs, labels = _data(kw["embedding_size"], stacked, 6, seed=7)
    m = _port_model(kw, stacked, epoch_row_cache="on")
    st = m.init(seed=0, device="cpu")
    by_fit, _ = m.fit(st.clone(), _loader(inputs, labels, shuffle=True,
                                          seed=3),
                      epochs=1, warmup=False, verbose=False)
    assert not m._last_fit_used_scan
    order = list(_loader(inputs, labels, shuffle=True, seed=3))
    ref, _ = m.train_epoch(st, {k: np.stack([b[0][k] for b in order])
                                for k in inputs},
                           np.stack([b[1] for b in order]))
    _assert_same(by_fit, ref)


def test_fit_branch_matches_jax():
    """The same loaders take the same branch in both packages."""
    kw, stacked = _graph("stacked", True)
    inputs, labels = _data(kw["embedding_size"], stacked, 4, seed=8)
    jm = jax_build_dlrm(JaxDLRMConfig(**kw), ffj.FFConfig(batch_size=BATCH))
    jm.compile(optimizer=ffj.SGDOptimizer(lr=0.05), mesh=False,
               loss_type="mean_squared_error")
    pm = _port_model(kw, stacked)
    js, ps = jm.init(seed=0), pm.init(seed=0, device="cpu")
    for kwargs in ({}, {"shuffle": True}, {"drop_last": False}):
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in inputs.items()}
        jl = JaxArrayDataLoader(flat, labels.reshape(-1, 1), BATCH,
                                **kwargs)
        js, _ = jm.fit(js, jl, epochs=1, verbose=False)
        ps, _ = pm.fit(ps, _loader(inputs, labels, **kwargs), epochs=1,
                       verbose=False)
        assert pm._last_fit_used_scan == jm._last_fit_used_scan == (
            not kwargs), kwargs


# ------------------------------------------------ cached port vs JAX
@pytest.mark.parametrize("kind", ["stacked", "per_table"])
def test_cached_epochs_match_jax(kind):
    """Two cached epochs (``train_epochs``, ladder [4]) in both packages,
    from the same weights and batches."""
    kw, stacked = _graph(kind, True)
    inputs, labels = _data(kw["embedding_size"], stacked, 8, seed=9)
    cfg = dict(batch_size=BATCH, epoch_row_cache="on", epoch_cache_inner=4)
    jm = jax_build_dlrm(JaxDLRMConfig(**kw), ffj.FFConfig(**cfg),
                        stacked_embeddings=stacked)
    jm.compile(optimizer=ffj.SGDOptimizer(lr=0.05), mesh=False,
               loss_type="mean_squared_error",
               metrics=("accuracy", "mean_squared_error"))
    js = jm.init(seed=0)
    pm = _port_model(kw, stacked, epoch_row_cache="on", epoch_cache_inner=4)
    ps = pm.load_params(
        params_from_jax(jax.tree.map(np.asarray, js.params)), device="cpu",
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state)))
    jin = {k: v.astype(np.int32) if v.dtype == np.int64 else v
           for k, v in inputs.items()}
    js, jmets = jm.train_epochs(js, jin, labels, 2)
    ps, pmets = pm.train_epochs(ps, inputs, labels, 2)
    assert jm._epoch_cache_active and pm._epoch_cache_active
    assert set(pmets) == set(jmets)
    np.testing.assert_allclose(pmets["loss"].numpy(),
                               np.asarray(jmets["loss"]), rtol=1e-5)
    for k in ("train_all", "train_correct"):
        np.testing.assert_array_equal(pmets[k].numpy(), np.asarray(jmets[k]))
    np.testing.assert_allclose(pmets["mse"].numpy(), np.asarray(jmets["mse"]),
                               rtol=1e-5)
    assert int(ps.step) == int(js.step) == 16
    for op, params in js.params.items():
        for k, v in params.items():
            np.testing.assert_allclose(ps.params[op][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{op}/{k}")


# ------------------------------------------------------------ bad values
@pytest.mark.parametrize("field", ["epoch_row_cache",
                                   "sparse_embedding_updates"])
def test_bad_cache_modes_raise_as_in_jax(field):
    """The port checks both modes at compile, as the JAX package does.
    Same exception, same text."""
    kw, stacked = _graph("stacked", True)
    inputs, labels = _data(kw["embedding_size"], stacked, 2, seed=10)
    jin = {k: v.astype(np.int32) if v.dtype == np.int64 else v
           for k, v in inputs.items()}
    cfg = dict(batch_size=BATCH, epoch_row_cache="on")
    cfg[field] = "sometimes"
    msgs = []
    for build, ffc, opt, extra, data in (
            (jax_build_dlrm, ffj.FFConfig, ffj.SGDOptimizer,
             {"mesh": False}, jin),
            (build_dlrm, fft.FFConfig, fft.SGDOptimizer, {}, inputs)):
        with pytest.raises(ValueError) as err:
            m = build(DLRMConfig(**kw) if build is build_dlrm
                      else JaxDLRMConfig(**kw), ffc(**cfg))
            m.compile(optimizer=opt(lr=0.05), **extra)
            st = (m.init(seed=0, device="cpu") if build is build_dlrm
                  else m.init(seed=0))
            m.train_epoch(st, data, labels)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == (f"{field} must be 'auto'|'on'|'off', got "
                                  f"'sometimes'")
