"""The port's training slice (dlrm_flexflow_tpu_torch) against the JAX
package on the CPU: shape ops, embedding ops, losses, metrics, the SGD
update, the data loaders, and whole DLRM training steps on transferred
weights and identical numpy batches.  JAX is imported here only.

Tolerances, each with its reason:
  * data movement (shape ops, gathers, the scatter, cat interactions'
    slices, loaders): bit-exact;
  * f32 training: losses rtol 1e-5, parameters after 5 steps rtol 1e-4
    and atol 1e-6: the port's Linear accumulates in f64 and rounds once
    (ROADMAP Queue C), so the last bits of a sum differ and carry on;
  * bf16 compute: losses rtol 1e-3 (the repo's bf16 gate), parameters
    atol 2e-3: the two frameworks round the bf16 operands of the
    backward's products at different places;
  * losses, metrics and the SGD update: rtol 1e-6 where transcendental
    functions or reductions may round differently, exact otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import losses as jlosses
from dlrm_flexflow_tpu import metrics as jmetrics
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.data import loader as jloader
from dlrm_flexflow_tpu.ops import embedding as jemb
from dlrm_flexflow_tpu.ops import shape_ops as jshape
from dlrm_flexflow_tpu.optim import SGDOptimizer as JaxSGD
from dlrm_flexflow_tpu.tensor import Tensor as JaxTensor

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import losses as tlosses
from dlrm_flexflow_tpu_torch import metrics as tmetrics
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import opt_state_from_jax, params_from_jax
from dlrm_flexflow_tpu_torch.data import loader as tloader
from dlrm_flexflow_tpu_torch.ops import embedding as temb
from dlrm_flexflow_tpu_torch.ops import shape_ops as tshape
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import row_update_cuda
from dlrm_flexflow_tpu_torch.tensor import Tensor

TABLES = [64, 200, 1000, 77, 300, 500, 128, 90]
D = 16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _both(shape, dtype=np.float32):
    jd = {np.float32: jnp.float32, np.int64: jnp.int32}[dtype]
    td = {np.float32: torch.float32, np.int64: torch.int64}[dtype]
    return JaxTensor(shape, jd), Tensor(shape, td)


# ------------------------------------------------------------- shape ops
def _shape_case(name):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 4, 5)).astype(np.float32)
    b = rng.standard_normal((6, 4, 5)).astype(np.float32)
    (ja, pa), (jb, pb) = _both(a.shape), _both(b.shape)
    if name == "concat":
        return (jshape.Concat("c", [ja, jb], 1),
                tshape.Concat("c", [pa, pb], 1), [a, b])
    if name == "reshape":   # batch-polymorphic: built for 6, run at 3
        return (jshape.Reshape("r", ja, (6, 20)),
                tshape.Reshape("r", pa, (6, 20)), [a[:3]])
    if name == "reshape_fixed":
        return (jshape.Reshape("r", ja, (4, -1)),
                tshape.Reshape("r", pa, (4, -1)), [a])
    if name == "transpose":
        return (jshape.Transpose("t", ja), tshape.Transpose("t", pa), [a])
    if name == "flat":      # built for 6, run at 2
        return jshape.Flat("f", ja), tshape.Flat("f", pa), [a[:2]]
    cd = "bfloat16" if name == "bmm_bf16" else None
    return (jshape.BatchMatmul("m", ja, jb, trans_b=True, compute_dtype=cd),
            tshape.BatchMatmul("m", pa, pb, trans_b=True, compute_dtype=cd),
            [a, b])


@pytest.mark.parametrize("name", ["concat", "reshape", "reshape_fixed",
                                  "transpose", "flat", "bmm", "bmm_bf16"])
def test_shape_ops_match_jax(name):
    jop, pop, xs = _shape_case(name)
    assert pop.outputs[0].shape == jop.outputs[0].shape
    (want,) = jop.forward({}, [jnp.asarray(x) for x in xs])
    (got,) = pop.forward({}, [_t(x) for x in xs])
    if name.startswith("bmm"):
        # f32 dot products summed in another order (the port sums in f64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ embeddings
def _emb_ops(kind, aggr="sum", bag=2):
    rng = np.random.default_rng(2)
    if kind == "embedding":
        (ji, pi), shape = _both((5, bag), np.int64), (30, D)
        jop = jemb.Embedding("e", ji, 30, D, aggr)
        pop = temb.Embedding("e", pi, 30, D, aggr)
        ids = rng.integers(0, 30, size=(5, bag))
        ids[0, 0], ids[1, -1], ids[2, 0] = -1, 30, -30   # wrap, NaN, wrap
    elif kind == "stacked":
        (ji, pi), shape = _both((5, 3, bag), np.int64), (3, 20, D)
        jop = jemb.StackedEmbedding("e", ji, 3, 20, D, aggr)
        pop = temb.StackedEmbedding("e", pi, 3, 20, D, aggr)
        ids = rng.integers(0, 20, size=(5, 3, bag))
        ids[0, 1, 0], ids[1, 2, -1] = -2, 20
    else:
        rows = [40, 24, 32]
        (ji, pi) = _both((5, 3, bag), np.int64)
        jop = jemb.RaggedStackedEmbedding("e", ji, rows, D, aggr)
        pop = temb.RaggedStackedEmbedding("e", pi, rows, D, aggr)
        shape = (pop.total_rows, D)
        ids = np.stack([rng.integers(0, r, size=(5, bag)) for r in rows], 1)
    assert pop.param_specs()[0].shape == jop.param_specs()[0].shape == shape
    table = rng.standard_normal(shape).astype(np.float32)
    return jop, pop, table, ids.astype(np.int64)


@pytest.mark.parametrize("kind,aggr", [("embedding", "sum"),
                                       ("embedding", "avg"),
                                       ("embedding", "none"),
                                       ("stacked", "sum"), ("stacked", "avg"),
                                       ("ragged", "sum"), ("ragged", "avg")])
def test_embedding_forward_matches_jax(kind, aggr):
    """Pure gathers and pools: bit-exact, including the JAX package's
    out-of-range rule for a forward (ids in [-R, 0) wrap per table, other
    out-of-range ids read NaN rows)."""
    bag = 3 if aggr == "avg" else 2
    jop, pop, table, ids = _emb_ops(kind, aggr, bag)
    (want,) = jop.forward({"embedding": jnp.asarray(table)},
                          [jnp.asarray(ids.astype(np.int32))])
    (got,) = pop.forward({"embedding": _t(table)}, [_t(ids)])
    assert got.shape == want.shape
    if aggr == "avg":
        # XLA on the CPU runs jnp.mean's division by the bag of 3 as a
        # multiply by its reciprocal, one ulp off the port's division
        # (ROADMAP Queue C); NaN rows must still agree
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1.2e-7, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["embedding", "stacked", "ragged"])
def test_gather_rows_and_rows_forward_match_jax(kind):
    """``gather_rows`` on in-range ids, then the forward on the injected
    rows: both bit-exact."""
    jop, pop, table, ids = _emb_ops(kind)
    ids = np.abs(ids) % 20
    jrows = jop.gather_rows(jnp.asarray(table), jnp.asarray(ids.astype(np.int32)))
    prows = pop.gather_rows(_t(table), _t(ids))
    np.testing.assert_array_equal(prows.numpy(), np.asarray(jrows))
    (want,) = jop.forward({"embedding": jnp.asarray(table), "rows__": jrows},
                          [jnp.asarray(ids.astype(np.int32))])
    (got,) = pop.forward({"embedding": _t(table), "rows__": prows}, [_t(ids)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["embedding", "stacked", "ragged"])
def test_scatter_apply_matches_jax(kind):
    """The row-sparse step on the op's flat row space, with duplicates,
    and for the single table ids that wrap ([-R, 0)) or drop (>= R):
    bit-exact against the JAX op's ``.at[].add``."""
    jop, pop, table, ids = _emb_ops(kind)
    if kind != "embedding":
        ids = np.abs(ids) % 20
    ids[3] = ids[4]  # duplicate rows inside the batch
    grads = np.random.default_rng(3).standard_normal(
        ids.shape + (D,)).astype(np.float32)
    want = jop.scatter_apply(jnp.asarray(table),
                             jnp.asarray(ids.astype(np.int32)),
                             jnp.asarray(grads), jnp.float32(-0.05))
    pt = _t(table.copy())
    got = pop.scatter_apply(pt, _t(ids), _t(grads),
                            torch.tensor(-0.05, dtype=torch.float32))
    assert got.data_ptr() == pt.data_ptr()  # in place
    np.testing.assert_array_equal(pt.numpy(), np.asarray(want))
    assert row_update_cuda.launches == 0  # CPU tensors: the plain version


# ---------------------------------------------------- losses and metrics
def _loss_inputs(name):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((8, 5)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    classes = rng.integers(0, 5, size=(8, 1))
    onehot = np.eye(5, dtype=np.float32)[classes[:, 0]]
    if "sparse" in name:
        x = logits if "logits" in name else probs
        return x.astype(np.float32), classes
    if "crossentropy" in name:
        return (logits if "logits" in name else probs.astype(np.float32),
                onehot)
    return logits, rng.standard_normal((8, 5)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(jlosses.LOSS_FUNCTIONS))
def test_loss_value_and_gradient_match_jax(name):
    """Every registered loss, including the reference's 1/batch scaling
    of the gradient.  Logs and exponentials round differently per
    library: rtol 1e-6."""
    assert sorted(tlosses.LOSS_FUNCTIONS) == sorted(jlosses.LOSS_FUNCTIONS)
    x, y = _loss_inputs(name)
    jv, jg = jax.value_and_grad(jlosses.get_loss(name))(jnp.asarray(x),
                                                       jnp.asarray(y))
    tx = _t(x).requires_grad_()
    tv = tlosses.get_loss(name)(tx, _t(y))
    (tg,) = torch.autograd.grad(tv, tx)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.parametrize("loss_type,metrics", [
    ("mean_squared_error", ("accuracy", "mean_squared_error", "mae")),
    ("sparse_categorical_crossentropy", ("accuracy", "sparse_cce")),
    ("categorical_crossentropy", ("accuracy", "cce", "rmse"))])
def test_compute_metrics_and_report_match_jax(loss_type, metrics):
    rng = np.random.default_rng(5)
    if loss_type == "mean_squared_error":
        preds = rng.random((16, 1)).astype(np.float32)
        labels = rng.integers(0, 2, size=(16, 1)).astype(np.float32)
    else:
        preds = rng.random((16, 4)).astype(np.float32)
        preds /= preds.sum(-1, keepdims=True)
        cls = rng.integers(0, 4, size=(16, 1))
        labels = (cls if "sparse" in loss_type
                  else np.eye(4, dtype=np.float32)[cls[:, 0]])
    want = jmetrics.compute_metrics(jnp.asarray(preds), jnp.asarray(labels),
                                    metrics, loss_type)
    got = tmetrics.compute_metrics(_t(preds), _t(labels), metrics, loss_type)
    assert set(got) == set(want)
    for k in want:
        # sums of logs and squares in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    jacc = jmetrics.MetricsAccumulator(metrics)
    tacc = tmetrics.MetricsAccumulator(metrics)
    for _ in range(2):
        jacc.update(want)
        tacc.update(got)
    assert tacc.report() == jacc.report()
    assert tacc.get_accuracy() == pytest.approx(jacc.get_accuracy())


# ------------------------------------------------------------------ SGD
@pytest.mark.parametrize("kw", [{}, {"momentum": 0.9},
                                {"momentum": 0.9, "nesterov": True},
                                {"weight_decay": 1e-3},
                                {"momentum": 0.5, "weight_decay": 1e-2}])
def test_sgd_update_matches_jax(kw):
    """Three updates of two ops' parameters.  XLA may fuse the update's
    multiply-adds: rtol 1e-6."""
    rng = np.random.default_rng(6)
    params = {"a": {"kernel": rng.standard_normal((7, 3)).astype(np.float32),
                    "bias": rng.standard_normal(3).astype(np.float32)},
              "b": {"embedding": rng.standard_normal((9, 4)).astype(
                  np.float32)}}
    jopt, topt = JaxSGD(lr=0.1, **kw), fft.SGDOptimizer(lr=0.1, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {o: {k: _t(v.copy()) for k, v in d.items()}
          for o, d in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert set(ts) == set(js)
    for _ in range(3):
        grads = {o: {k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in d.items()} for o, d in params.items()}
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts = topt.update(tp, {o: {k: _t(v) for k, v in d.items()}
                                  for o, d in grads.items()}, ts)
    assert int(ts["step"]) == int(js["step"]) == 3
    for o, d in params.items():
        for k in d:
            np.testing.assert_allclose(tp[o][k].numpy(), np.asarray(jp[o][k]),
                                       rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- loaders
@pytest.mark.parametrize("kind", ["uniform", "zipf", "per_table",
                                  "zipf_loader"])
def test_loader_batches_equal_jax(kind):
    args = (96, 13, [50, 7, 1000], 2, 32)
    if kind == "zipf_loader":
        jl, tl = jloader.ZipfDLRMLoader(*args), tloader.ZipfDLRMLoader(*args)
    else:
        kw = dict(stacked=kind != "per_table", seed=3,
                  id_dist="zipf" if kind == "zipf" else "uniform")
        jl = jloader.SyntheticDLRMLoader(*args, **kw)
        tl = tloader.SyntheticDLRMLoader(*args, **kw)
    assert tl.num_batches == jl.num_batches == 3
    for (ti, tlab), (ji, jlab) in zip(tl, jl):
        assert set(ti) == set(ji)
        for k in ti:
            assert ti[k].dtype == ji[k].dtype
            np.testing.assert_array_equal(ti[k], ji[k])
        np.testing.assert_array_equal(tlab, jlab)


def test_loader_state_dict_resume_replays_batches():
    rng = np.random.default_rng(7)
    inputs = {"x": rng.standard_normal((50, 3)).astype(np.float32)}
    labels = rng.standard_normal((50, 1)).astype(np.float32)
    ref = tloader.ArrayDataLoader(inputs, labels, 8, shuffle=True, seed=2)
    jref = jloader.ArrayDataLoader(inputs, labels, 8, shuffle=True, seed=2)
    list(ref), list(jref)  # one epoch, so the RNG has moved
    it = iter(ref)
    seen = [next(it) for _ in range(2)]
    sd = ref.state_dict()
    rest = list(it)
    resumed = tloader.ArrayDataLoader(inputs, labels, 8, shuffle=True,
                                      seed=99)
    resumed.load_state_dict(sd)
    replay = list(resumed)
    assert len(seen) + len(rest) == ref.num_batches == 6
    assert len(replay) == len(rest)
    for (a, la), (b, lb) in zip(replay, rest):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(la, lb)
    jit = iter(jref)
    for (a, _), (b, _) in zip(seen, [next(jit) for _ in range(2)]):
        np.testing.assert_array_equal(a["x"], b["x"])


def test_config_training_fields_match_jax():
    argv = ["-e", "3", "--lr", "0.5", "--wd", "0", "--seed", "4",
            "-b", "16"]
    pc, jc = fft.FFConfig.parse_args(argv), JaxFFConfig.parse_args(argv)
    for f in ("epochs", "learning_rate", "weight_decay", "seed",
              "batch_size"):
        assert getattr(pc, f) == getattr(jc, f), f
    d = fft.FFConfig()
    for f in ("epochs", "learning_rate", "weight_decay",
              "sparse_embedding_updates", "epoch_row_cache",
              "epoch_cache_chunk", "epoch_cache_inner", "epoch_cache_levels",
              "fit_scan_max_bytes"):
        assert getattr(d, f) == getattr(JaxFFConfig(), f), f
    # the port's own flags for the path fit and the CLI take
    assert fft.FFConfig.parse_args(
        ["--epoch-row-cache", "off", "--fit-scan-max-bytes", "0"]) == \
        fft.FFConfig(epoch_row_cache="off", fit_scan_max_bytes=0)
    assert fft.FFConfig.parse_args(["--learning-rate", "0.2",
                                    "--weight-decay", "0.1"]) == \
        fft.FFConfig(learning_rate=0.2, weight_decay=0.1)


# ------------------------------------------------ whole training steps
def _dlrm_kwargs(interact, fused, tables):
    t = len(tables)
    top0 = D + t * D if interact == "cat" else D + (t + 1) ** 2
    return dict(sparse_feature_size=D, embedding_size=list(tables),
                mlp_bot=[13, 32, D], mlp_top=[top0, 32, 1],
                arch_interaction_op=interact, fused_interaction=fused)


def _batches(tables, batch, steps, stacked, seed=11):
    """Ids drawn from a narrow range, so rows repeat inside a batch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = np.stack([rng.integers(0, min(r, 20), size=(batch, 1))
                        for r in tables], axis=1).astype(np.int64)
        inputs = {"dense": rng.standard_normal((batch, 13)).astype(
            np.float32)}
        if stacked:
            inputs["sparse"] = ids
        else:
            inputs.update({f"sparse_{i}": ids[:, i]
                           for i in range(len(tables))})
        out.append((inputs, rng.integers(0, 2, size=(batch, 1)).astype(
            np.float32)))
    return out


def _models(interact, fused, cd, sparse="auto", stacked=True, tables=TABLES,
            batch=32, interpret=False, lr=0.05):
    kw = _dlrm_kwargs(interact, fused, tables)
    fk = dict(batch_size=batch, compute_dtype=cd,
              sparse_embedding_updates=sparse)
    mets = ("accuracy", "mean_squared_error")
    jm = jax_build_dlrm(JaxDLRMConfig(**kw), JaxFFConfig(**fk),
                       stacked_embeddings=stacked)
    if interpret:
        jm.get_op("emb")._interpret = True  # before the first trace
    jm.compile(optimizer=ffj.SGDOptimizer(lr=lr), metrics=mets, mesh=False,
               loss_type="mean_squared_error")
    jstate = jm.init(seed=0)
    pm = build_dlrm(DLRMConfig(**kw), fft.FFConfig(**fk),
                    stacked_embeddings=stacked)
    pm.compile(optimizer=fft.SGDOptimizer(lr=lr), metrics=mets,
               loss_type="mean_squared_error")
    pstate = pm.load_params(
        params_from_jax(jax.tree.map(np.asarray, jstate.params)),
        device="cpu",
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray,
                                                  jstate.opt_state)))
    return jm, jstate, pm, pstate


_CONFIGS = {
    # same-size tables: one (T, R, d) StackedEmbedding
    "a_classic_stacked_cat_f32": dict(interact="cat", fused="off", cd=None,
                                      tables=[200] * 8),
    "b_classic_dot_f32": dict(interact="dot", fused="off", cd=None),
    "c_classic_cat_bf16": dict(interact="cat", fused="off", cd="bfloat16"),
    "d_fused_cat_sparse": dict(interact="cat", fused="on", cd=None),
    # the dense table gradient through the fused kernels; the JAX side
    # runs its Pallas forward and backward kernels in interpret mode (a
    # narrower model keeps their traces short)
    "e_fused_cat_dense": dict(interact="cat", fused="on", cd=None,
                              sparse="off", interpret=True,
                              tables=[40, 24, 32], batch=16),
    "e_fused_dot_dense": dict(interact="dot", fused="on", cd=None,
                              sparse="off", interpret=True,
                              tables=[40, 24, 32], batch=16),
    "f_per_table_classic": dict(interact="cat", fused="off", cd=None,
                                stacked=False),
    "classic_ragged_dot_bf16": dict(interact="dot", fused="off",
                                    cd="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_training_steps_match_jax(name):
    cfg = dict(_CONFIGS[name])
    tables = cfg.pop("tables", TABLES)
    batch = cfg.pop("batch", 32)
    stacked = cfg.get("stacked", True)
    jm, js, pm, ps = _models(tables=tables, batch=batch, **cfg)
    sparse = cfg.get("sparse", "auto") != "off"
    assert [op.name for op in pm._sparse_ops] == (
        jm._sparse_emb_ops if sparse else [])
    bf16 = cfg["cd"] == "bfloat16"
    for inputs, labels in _batches(tables, batch, 5, stacked):
        js, jmets = jm.train_step(js, inputs, labels)
        ps, pmets = pm.train_step(ps, inputs, labels)
        assert set(pmets) == set(jmets)
        np.testing.assert_allclose(float(pmets["loss"]),
                                   float(jmets["loss"]),
                                   rtol=1e-3 if bf16 else 1e-5)
        assert float(pmets["train_all"]) == float(jmets["train_all"])
    assert int(ps.step) == int(js.step) == 5
    assert int(ps.opt_state["step"]) == int(js.opt_state["step"]) == 5
    tol = dict(rtol=0, atol=2e-3) if bf16 else dict(rtol=1e-4, atol=1e-6)
    for op, params in js.params.items():
        for k, v in params.items():
            np.testing.assert_allclose(ps.params[op][k].numpy(),
                                       np.asarray(v), err_msg=f"{op}/{k}",
                                       **tol)


def test_eval_step_matches_jax():
    jm, js, pm, ps = _models("dot", "off", None)
    (inputs, labels), = _batches(TABLES, 32, 1, True)
    want = jm.eval_step(js, inputs, labels)
    got = pm.eval_step(ps, inputs, labels)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


# ------------------------------------------------- the port's own rules
@pytest.fixture(scope="module")
def port_model():
    pm = build_dlrm(DLRMConfig(**_dlrm_kwargs("cat", "on", TABLES)),
                    fft.FFConfig(batch_size=32))
    pm.compile(optimizer=fft.SGDOptimizer(lr=0.1),
               metrics=("accuracy", "mean_squared_error"))
    return pm


def _stacked(batches):
    return ({k: np.stack([b[0][k] for b in batches])
             for k in batches[0][0]},
            np.stack([b[1] for b in batches]))


def _assert_states_equal(a, b):
    for op, params in a.params.items():
        for k, v in params.items():
            assert torch.equal(v, b.params[op][k]), f"{op}/{k}"
    assert int(a.step) == int(b.step)


def test_sparse_step_leaves_untouched_rows_bit_identical(port_model):
    state = port_model.init(seed=3, device="cpu")
    before = state.params["emb"]["embedding"].clone()
    (inputs, labels), = _batches(TABLES, 32, 1, True)
    state, _ = port_model.train_step(state, inputs, labels)
    after = state.params["emb"]["embedding"]
    op = port_model.get_op("emb")
    touched = torch.zeros(after.shape[0], dtype=torch.bool)
    touched[op.flat_ids(torch.from_numpy(inputs["sparse"])).reshape(-1)] = True
    assert torch.equal(after[~touched], before[~touched])
    assert not torch.equal(after[touched], before[touched])


def test_train_epoch_equals_train_steps_and_fit(port_model):
    batches = _batches(TABLES, 32, 4, True, seed=12)
    state = port_model.init(seed=4, device="cpu")
    by_steps, by_epoch, by_fit = state, state.clone(), state.clone()
    losses = []
    for inputs, labels in batches:
        by_steps, m = port_model.train_step(by_steps, inputs, labels)
        losses.append(float(m["loss"]))
    by_epoch, folded = port_model.train_epoch(by_epoch, *_stacked(batches))
    _assert_states_equal(by_steps, by_epoch)
    assert float(folded["loss"]) == pytest.approx(np.mean(losses), rel=1e-6)
    assert float(folded["train_all"]) == 4 * 32
    inputs, labels = _stacked(batches)
    loader = fft.ArrayDataLoader({k: v.reshape((-1,) + v.shape[2:])
                                  for k, v in inputs.items()},
                                 labels.reshape(-1, 1), 32)
    by_fit, thpt = port_model.fit(by_fit, loader, epochs=1, warmup=False,
                                  verbose=False)
    _assert_states_equal(by_steps, by_fit)
    assert thpt > 0
    assert port_model.get_perf_metrics().finalized_means()["train_all"] == 128


def test_train_epochs_equals_repeated_train_epoch(port_model):
    inputs, labels = _stacked(_batches(TABLES, 32, 2, True, seed=13))
    state = port_model.init(seed=5, device="cpu")
    twice, stacked = port_model.train_epochs(state.clone(), inputs, labels, 2)
    once = state
    folded = []
    for _ in range(2):
        once, m = port_model.train_epoch(once, inputs, labels)
        folded.append(m)
    _assert_states_equal(once, twice)
    assert stacked["loss"].shape == (2,)
    for k, v in stacked.items():
        assert torch.equal(v, torch.stack([m[k] for m in folded])), k


def test_bridge_carries_stacked_per_table_and_momentum_state():
    """params_from_jax covers the (T, R, d) stacked table and per-table
    tables; opt_state_from_jax the step, lr and momentum leaves."""
    for stacked in (True, False):
        kw = _dlrm_kwargs("cat", "off", [30] * 3)
        jm = jax_build_dlrm(JaxDLRMConfig(**kw), JaxFFConfig(batch_size=8),
                            stacked_embeddings=stacked)
        jm.compile(optimizer=JaxSGD(lr=0.1, momentum=0.9), mesh=False)
        js = jm.init(seed=1)
        params = params_from_jax(jax.tree.map(np.asarray, js.params))
        opt = opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state))
        names = ({"emb"} if stacked else {f"emb_{i}" for i in range(3)})
        assert names <= set(params)
        for n in names:
            want = np.asarray(js.params[n]["embedding"])
            assert want.shape == ((3, 30, D) if stacked else (30, D))
            np.testing.assert_array_equal(params[n]["embedding"].numpy(),
                                          want)
        assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0
        assert float(opt["lr"]) == pytest.approx(0.1)
        assert set(opt["v"]) == set(params)
        pm = build_dlrm(DLRMConfig(**kw), fft.FFConfig(batch_size=8),
                        stacked_embeddings=stacked)
        pm.compile(optimizer=fft.SGDOptimizer(lr=0.1, momentum=0.9))
        assert pm._sparse_ops == []  # momentum: the dense path
        ps = pm.load_params(params, device="cpu", opt_state=opt)
        assert ps.opt_state["v"]["top_1"]["kernel"].shape == (32, 1)


def test_cli_run_needs_the_card():
    from dlrm_flexflow_tpu_torch.apps.dlrm import run
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(["--arch-embedding-size", "10-10", "--arch-mlp-top",
             "192-1", "--arch-mlp-bot", "64-64"])
