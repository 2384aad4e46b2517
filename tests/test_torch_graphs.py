"""The port's compiled dispatch (dlrm_flexflow_tpu_torch/graphs.py, the
step in model.py, the per-bucket runners in serving/engine.py) on the
CPU, where a :class:`GraphRunner` calls its function on its static
buffers instead of replaying a CUDA graph.

  * three donated ``train_step``s through the runner equal the eager
    body (``donate=False``) bit for bit: parameters, tables, both step
    counts, every metric;
  * the metrics of consecutive steps are distinct tensors that keep
    their values;
  * a state tensor that moved makes the runner raise, and the model
    step runs eagerly on the new tensor, then captures anew;
  * ``fit`` (cached ladder, uncached, chunked, per batch) through the
    runner equals the same ``fit`` on the eager body bit for bit, and the
    JAX package's ``fit`` and ``train_epochs`` on transferred weights at
    the training slice's tolerances (losses rtol 1e-5 at f32, 1e-3 under
    bf16 compute);
  * the engine's per-bucket runners return ``model.predict``'s bits.
"""

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.data.loader import ArrayDataLoader as JaxArrayDataLoader

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import opt_state_from_jax, params_from_jax
from dlrm_flexflow_tpu_torch.graphs import GraphRunner, StaleGraphError
from dlrm_flexflow_tpu_torch.serving import InferenceEngine

D, BATCH, BAG = 8, 16, 2
TABLES = [300, 200, 256]
# tables large enough that the epoch row cache and its ladder engage
BIG = [4096, 1396, 2048]


def _kw(fused="off", interact="cat", tables=TABLES):
    t = len(tables)
    top0 = D + t * D if interact == "cat" else D + (t + 1) ** 2
    return dict(sparse_feature_size=D, embedding_size=list(tables),
                embedding_bag_size=BAG, mlp_bot=[4, 16, D],
                mlp_top=[top0, 16, 1], arch_interaction_op=interact,
                fused_interaction=fused)


def _model(fused="off", interact="cat", stacked=True, momentum=0.0,
           tables=TABLES, **cfg):
    m = build_dlrm(DLRMConfig(**_kw(fused, interact, tables)),
                   fft.FFConfig(batch_size=BATCH, **cfg),
                   stacked_embeddings=stacked)
    m.compile(optimizer=fft.SGDOptimizer(lr=0.05, momentum=momentum),
              loss_type="mean_squared_error",
              metrics=("accuracy", "mean_squared_error"))
    return m


def _data(nb, seed, stacked=True, narrow=40, tables=TABLES):
    """``nb`` stacked batches; ids from a narrow range, so rows repeat
    within and across steps."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, min(r, narrow), size=(nb, BATCH, BAG))
            for r in tables]
    inputs = {"dense": rng.standard_normal((nb, BATCH, 4)).astype(
        np.float32)}
    if stacked:
        inputs["sparse"] = np.stack(cols, axis=2)
    else:
        inputs.update({f"sparse_{i}": c for i, c in enumerate(cols)})
    return inputs, rng.integers(0, 2, size=(nb, BATCH, 1)).astype(
        np.float32)


def _batch(inputs, labels, i):
    return {k: v[i] for k, v in inputs.items()}, labels[i]


def _assert_same(a, b):
    for op, params in a.params.items():
        for k, v in params.items():
            assert torch.equal(v, b.params[op][k]), f"{op}/{k}"
    assert set(a.opt_state) == set(b.opt_state)
    assert torch.equal(a.opt_state["step"], b.opt_state["step"])
    assert torch.equal(a.step, b.step)


def _assert_same_metrics(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture
def eager_steps(monkeypatch):
    """Runs a model's donated steps on the eager body, the path before
    the compiled dispatch."""
    def patch(model):
        monkeypatch.setattr(model, "_step", model._step_body)
        return model
    return patch


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("graph", [
    dict(),                                  # row-sparse, stacked tables
    dict(fused="on"),                        # fused graph, row-sparse
    dict(fused="on", sparse_embedding_updates="off"),  # dense gradient
    dict(interact="dot", momentum=0.9),      # momentum buffers in place
    dict(stacked=False, compute_dtype="bfloat16"),     # per-table, bf16
])
def test_three_donated_steps_equal_the_eager_body(graph):
    model = _model(**graph)
    inputs, labels = _data(3, seed=1, stacked=graph.get("stacked", True))
    start = model.init(seed=0, device="cpu")
    eager, graphed = start.clone(), start
    for i in range(3):
        eager, em = model.train_step(eager, *_batch(inputs, labels, i),
                                     False)
        graphed, gm = model.train_step(graphed, *_batch(inputs, labels, i))
        _assert_same_metrics(em, gm)
    _assert_same(eager, graphed)
    assert int(graphed.step) == int(graphed.opt_state["step"]) == 3
    # the donated steps: one eager, one capture (and its run), one replay
    assert (model.graph_captures, model.graph_replays) == (1, 2)
    assert graphed.params["emb" if graph.get("stacked", True)
                          else "emb_0"]["embedding"] is (
        start.params["emb" if graph.get("stacked", True)
                     else "emb_0"]["embedding"])


def test_metrics_of_consecutive_steps_are_distinct_and_kept():
    model = _model()
    inputs, labels = _data(5, seed=2)
    state = model.init(seed=0, device="cpu")
    kept, values = [], []
    for i in range(5):
        state, mets = model.train_step(state, *_batch(inputs, labels, i))
        kept.append(mets)
        values.append({k: v.clone() for k, v in mets.items()})
    storages = {m["loss"].untyped_storage().data_ptr() for m in kept}
    assert len(storages) == 5
    for mets, want in zip(kept, values):
        _assert_same_metrics(mets, want)
    assert len({float(m["loss"]) for m in kept}) > 1


def test_runner_raises_on_a_moved_state_tensor_and_checks_inputs():
    w = torch.ones(3)
    bias = torch.zeros(3)
    runner = GraphRunner(lambda x, s: (x["a"] * s["w"]).sum(),
                         {"a": torch.zeros(3)}, {"w": w})
    assert float(runner.run({"a": np.arange(3.0)}, {"w": w})) == 3.0
    w.mul_(2)  # in place: the same tensor
    out = runner.run({"a": torch.ones(3)}, {"w": w})
    assert float(out) == 6.0 and runner.replays == 2
    with pytest.raises(StaleGraphError):
        runner.run({"a": torch.ones(3)}, {"w": w.clone()})
    with pytest.raises(StaleGraphError):
        runner.run({"a": torch.ones(3)}, {"w": w, "b": bias})
    with pytest.raises(ValueError, match="shape"):
        runner.run({"a": torch.ones(4)}, {"w": w})
    with pytest.raises(ValueError, match="do not match"):
        runner.run({"b": torch.ones(3)}, {"w": w})
    assert runner.replays == 2


def test_runner_returns_clones_not_its_static_outputs():
    runner = GraphRunner(lambda x, s: {"y": x["a"]}, {"a": torch.zeros(2)})
    first = runner.run({"a": torch.ones(2)})
    second = runner.run({"a": torch.full((2,), 5.0)})
    assert first["y"].tolist() == [1.0, 1.0]
    assert second["y"].tolist() == [5.0, 5.0]
    assert first["y"].data_ptr() != runner.static["a"].data_ptr()


def test_a_replaced_parameter_is_read_never_the_old_one():
    """After a step graph exists, ``set_weights`` puts a new tensor in
    the state: the next step reads it (eagerly), and the one after
    captures against it."""
    model = _model()
    inputs, labels = _data(6, seed=3)
    state = model.init(seed=0, device="cpu")
    for i in range(3):
        state, _ = model.train_step(state, *_batch(inputs, labels, i))
    assert model.graph_captures == 1
    new_w = np.full((16, 1), 0.01, dtype=np.float32)
    state = model.set_weights(state, "top_1", "kernel", new_w)
    ref = state.clone()
    for i in range(3, 6):
        ref, rm = model.train_step(ref, *_batch(inputs, labels, i), False)
        state, m = model.train_step(state, *_batch(inputs, labels, i))
        _assert_same_metrics(rm, m)
    _assert_same(ref, state)
    assert model.graph_captures == 2


# ------------------------------------------------------------------ fit
def _loader(inputs, labels, **kw):
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in inputs.items()}
    return fft.ArrayDataLoader(flat, labels.reshape(-1, 1), BATCH, **kw)


_FITS = {
    # 16 batches, two epochs: one train_epochs, the ladder [8]
    "cached_ladder": (16, dict(epoch_row_cache="on"), {}),
    "uncached": (16, dict(epoch_row_cache="off"), {}),
    # 9 batches, levels off, chunk 4: three chunks of 3 steps, each with
    # its own prologue
    "chunked": (9, dict(epoch_row_cache="on", epoch_cache_levels="off",
                        epoch_cache_chunk=4), {}),
    "per_batch": (6, dict(epoch_row_cache="on"), {"shuffle": True,
                                                  "seed": 4}),
}


@pytest.mark.parametrize("name", sorted(_FITS))
def test_fit_through_the_runner_equals_the_eager_fit(name, eager_steps):
    nb, cfg, loader_kw = _FITS[name]
    inputs, labels = _data(nb, seed=5, tables=BIG)
    runs = {}
    for mode in ("graphed", "eager"):
        m = _model(tables=BIG, **cfg)
        if mode == "eager":
            eager_steps(m)
        st = m.init(seed=0, device="cpu")
        st, _ = m.fit(st, _loader(inputs, labels, **loader_kw), epochs=2,
                      verbose=False)
        runs[mode] = (st, m.get_perf_metrics().finalized_means(), m)
    (st_g, mets_g, m_g), (st_e, mets_e, _) = runs["graphed"], runs["eager"]
    _assert_same(st_g, st_e)
    assert mets_g == mets_e
    assert m_g._last_fit_used_scan == (name != "per_batch")
    assert int(st_g.step) == 1 + 2 * nb
    assert m_g.graph_captures >= 1 and m_g.graph_replays > 0
    roles = {key[0][0] for key in m_g._cache_buffers}
    assert roles == {"cached_ladder": {"epoch", "block"}, "uncached": set(),
                     "chunked": {"epoch"}, "per_batch": set()}[name]
    if name in ("cached_ladder", "chunked"):
        # one capture serves every block (every chunk of 3 steps) of both
        # epochs: the caches are the model's buffers, at fixed addresses
        assert m_g.graph_captures == 1


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_fit_through_the_runner_matches_jax(cd):
    """``fit(epochs=2)`` (warmup step, one cached ``train_epochs``) and then
    ``train_epochs`` in both packages from the same weights: the per-epoch
    losses and the last epoch's metrics at the training slice's
    tolerances, the parameters at the epoch cache tests'."""
    inputs, labels = _data(8, seed=6, tables=BIG)
    cfg = dict(batch_size=BATCH, compute_dtype=cd, epoch_row_cache="on",
               epoch_cache_inner=4)
    jm = jax_build_dlrm(JaxDLRMConfig(**_kw(tables=BIG)),
                        ffj.FFConfig(**cfg))
    jm.compile(optimizer=ffj.SGDOptimizer(lr=0.05), mesh=False,
               loss_type="mean_squared_error",
               metrics=("accuracy", "mean_squared_error"))
    js = jm.init(seed=0)
    pm = build_dlrm(DLRMConfig(**_kw(tables=BIG)), fft.FFConfig(**cfg))
    pm.compile(optimizer=fft.SGDOptimizer(lr=0.05),
               loss_type="mean_squared_error",
               metrics=("accuracy", "mean_squared_error"))
    ps = pm.load_params(
        params_from_jax(jax.tree.map(np.asarray, js.params)), device="cpu",
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state)))
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in inputs.items()}
    jflat = {k: v.astype(np.int32) if v.dtype == np.int64 else v
             for k, v in flat.items()}
    js, _ = jm.fit(js, JaxArrayDataLoader(jflat, labels.reshape(-1, 1),
                                          BATCH), epochs=2, verbose=False)
    ps, _ = pm.fit(ps, _loader(inputs, labels), epochs=2, verbose=False)
    assert pm._last_fit_used_scan and jm._last_fit_used_scan
    rtol = 1e-3 if cd else 1e-5
    jmeans = jm.get_perf_metrics().finalized_means()
    pmeans = pm.get_perf_metrics().finalized_means()
    for k in ("train_all", "train_correct"):
        assert pmeans[k] == jmeans[k], k
    np.testing.assert_allclose(pmeans["mse"], jmeans["mse"], rtol=rtol)
    jin = {k: v.astype(np.int32) if v.dtype == np.int64 else v
           for k, v in inputs.items()}
    js, jmets = jm.train_epochs(js, jin, labels, 2)
    ps, pmets = pm.train_epochs(ps, inputs, labels, 2)
    np.testing.assert_allclose(pmets["loss"].numpy(),
                               np.asarray(jmets["loss"]), rtol=rtol)
    assert int(ps.step) == int(js.step) == 1 + 4 * 8
    assert pm.graph_replays > 0 and pm._epoch_cache_active
    tol = dict(rtol=0, atol=2e-3) if cd else dict(rtol=1e-4, atol=1e-6)
    for op, params in js.params.items():
        for k, v in params.items():
            np.testing.assert_allclose(ps.params[op][k].numpy(),
                                       np.asarray(v), err_msg=f"{op}/{k}",
                                       **tol)


# -------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def engine():
    m = build_dlrm(DLRMConfig(**_kw(fused="on")),
                   fft.FFConfig(batch_size=BATCH, serve_buckets="1,8,64")
                   ).compile()
    state = m.init(seed=0, device="cpu")
    return m, state, InferenceEngine(m, state, device="cpu")


@pytest.mark.parametrize("n", [1, 3, 40, 300])
def test_engine_runners_return_the_bits_of_predict(engine, n):
    model, state, eng = engine
    rng = np.random.default_rng(n)
    req = {"dense": rng.standard_normal((n, 4)).astype(np.float32),
           "sparse": np.stack([rng.integers(0, r, size=(n, BAG))
                               for r in TABLES], axis=1)}
    before = eng.graph_replays
    got = eng.predict(req)
    np.testing.assert_array_equal(got, model.predict(state, req).numpy())
    assert sorted(eng._graphs) == eng.buckets == [1, 8, 64]
    # 300 rows run as five top-bucket chunks
    assert eng.graph_replays - before == -(-n // 64)


def test_engine_runners_serve_concurrent_callers(engine):
    """Threads calling ``engine.predict`` at once share each bucket's
    static buffers: the engine's lock keeps every answer its own."""
    import sys
    import threading
    model, state, eng = engine
    rng = np.random.default_rng(7)
    reqs = {}
    for c in range(8):
        for i in range(6):
            n = 1 + (c * 6 + i) % 9
            reqs[c, i] = {"dense": rng.standard_normal((n, 4)).astype(
                np.float32), "sparse": np.stack(
                [rng.integers(0, r, size=(n, BAG)) for r in TABLES], axis=1)}
    got, errors = {}, []

    def client(c):
        try:
            for i in range(6):
                got[c, i] = eng.predict(reqs[c, i])
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:1]
    for key, req in reqs.items():
        np.testing.assert_array_equal(got[key],
                                      model.predict(state, req).numpy())
