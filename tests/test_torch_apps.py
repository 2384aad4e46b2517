"""The port's five other apps (AlexNet, ResNet, Inception-v3, Candle-Uno,
NMT) against the JAX package's on the CPU, at the sizes
tests/test_apps.py builds them at.  JAX is imported here only.

Each app is built alike in both packages (the same op names, types,
output shapes and parameter shapes), the JAX parameters and optimizer
state are carried across through ``bridge.py``, and both packages get
the same numpy batches from one seed.  The forwards agree at rtol 1e-4
(atol 1e-6; the products of the port accumulate in f64, XLA's in f32,
and a CNN's convolutions sum in orders of their own); three training
steps of the app's CLI optimizer and loss give losses at rtol 1e-3, the
repo's precedent for trajectories.

Inception-v3 is held by its graph at 299 x 299 (the 8 x 8 average pool
needs that size); its forward on the CPU would cost the whole budget of
these tests in XLA compiles, and its ops are held one by one in
tests/test_torch_ops.py.  The card holds its forward and step against
the port's CPU path (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import apps as japps

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import apps as papps
from dlrm_flexflow_tpu_torch.bridge import opt_state_from_jax, params_from_jax

STEPS = 3
FWD = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-3


def _candle(pkg):
    return pkg.CandleConfig(
        dense_layers=[64, 64], dense_feature_layers=[64],
        feature_shapes={"dose": 1, "cell.rnaseq": 50,
                        "drug.descriptors": 80, "drug.fingerprints": 100},
        input_features={"dose1": "dose", "dose2": "dose",
                        "cell.rnaseq": "cell.rnaseq",
                        "drug1.descriptors": "drug.descriptors",
                        "drug1.fingerprints": "drug.fingerprints"})


_NMT = dict(vocab_size=64, embed_size=16, hidden_size=12, num_layers=2,
            src_len=6, tgt_len=5)


def _build(pkg, app):
    """(model, optimizer, loss, batch size) of one app at its test size,
    with the CLI's optimizer and loss."""
    a = japps if pkg is ffj else papps
    if app == "alexnet":
        return (a.build_alexnet(pkg.FFConfig(batch_size=4), image_size=67),
                pkg.SGDOptimizer(lr=0.001), "sparse_categorical_crossentropy",
                4)
    if app == "resnet":
        return (a.build_resnet(pkg.FFConfig(batch_size=2), image_size=64,
                               stages=(1, 1, 1, 1)),
                pkg.SGDOptimizer(lr=0.001), "sparse_categorical_crossentropy",
                2)
    if app == "candle_uno":
        return (a.build_candle_uno(_candle(a), pkg.FFConfig(batch_size=8)),
                pkg.AdamOptimizer(lr=0.001), "mean_squared_error", 8)
    # NMT under SGD at a rate that moves the rows: the embeddings train on
    # the row-sparse path in both packages
    return (a.build_nmt(a.NMTConfig(**_NMT), pkg.FFConfig(batch_size=4)),
            pkg.SGDOptimizer(lr=0.5), "sparse_categorical_crossentropy", 4)


def _batches(model, batch, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        inputs = {}
        for t in model._inputs:
            shape = (batch,) + tuple(t.shape[1:])
            if "int" in str(t.dtype):
                inputs[t.name] = rng.integers(0, _NMT["vocab_size"],
                                              size=shape).astype(np.int32)
            else:
                inputs[t.name] = rng.standard_normal(shape).astype(
                    np.float32)
        final = model.final_tensor.shape
        if final[-1] == 1:
            labels = rng.standard_normal((batch, 1)).astype(np.float32)
        else:
            labels = rng.integers(0, final[-1], size=(batch,) + tuple(
                final[1:-1]) + (1,)).astype(np.int32)
        out.append((inputs, labels))
    return out


def _graph(model):
    return [(op.name, op.op_type, [tuple(o.shape) for o in op.outputs],
             [(s.param_name, tuple(s.shape)) for s in op.param_specs()])
            for op in model.layers]


@pytest.mark.parametrize("app", ["alexnet", "resnet", "candle_uno", "nmt"])
def test_app_forward_and_three_steps_match_jax(app):
    jm, jopt, loss, batch = _build(ffj, app)
    pm, popt, _, _ = _build(fft, app)
    assert _graph(pm) == _graph(jm)
    jm.compile(optimizer=jopt, loss_type=loss, metrics=("accuracy",),
               mesh=False)
    pm.compile(optimizer=popt, loss_type=loss, metrics=("accuracy",))
    assert [op.name for op in pm._sparse_ops] == (
        ["src_embed", "tgt_embed"] if app == "nmt" else [])
    js = jm.init(seed=0)
    ps = pm.load_params(params_from_jax(jax.tree.map(np.asarray, js.params)),
                        device="cpu", opt_state=opt_state_from_jax(
                            jax.tree.map(np.asarray, js.opt_state)))
    batches = _batches(pm, batch, STEPS + 1, seed=1)
    want = np.asarray(jm.forward(js, batches[-1][0]))
    got = pm.forward(ps, batches[-1][0]).numpy()
    np.testing.assert_allclose(got, want, **FWD)
    jl, pl = [], []
    for inputs, labels in batches[:STEPS]:
        js, jmets = jm.train_step(js, inputs, labels)
        ps, pmets = pm.train_step(ps, inputs, labels)
        jl.append(float(jmets["loss"]))
        pl.append(float(pmets["loss"]))
    assert all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert len(set(pl)) == STEPS  # the steps moved the parameters


def test_a_softmax_graph_trains_on_the_logits_as_jax_does():
    """A graph ending in a Softmax op: the loss reads the softmax's input
    through the from-logits form (the JAX package's fusion), so the
    gradient is softmax - onehot, not that of log(p + 1e-12)."""
    m, opt, loss, _ = _build(fft, "alexnet")
    m.compile(optimizer=opt, loss_type=loss)
    assert m._loss_uid == m.layers[-1].inputs[0].uid
    assert m._loss_fn.__name__.endswith("_from_logits")
    c, opt, loss, _ = _build(fft, "candle_uno")
    c.compile(optimizer=opt, loss_type=loss)
    assert c._loss_uid == c.final_tensor.uid


def test_inception_graph_matches_jax_at_299():
    jm = japps.build_inception(ffj.FFConfig(batch_size=2), image_size=299)
    pm = papps.build_inception(fft.FFConfig(batch_size=2), image_size=299)
    assert _graph(pm) == _graph(jm)
    assert pm.final_tensor.shape == (2, 10)
    assert sum(op.op_type == "Conv2D" for op in pm.layers) == 94


def test_full_size_graphs_match_jax():
    """AlexNet at 229, ResNet-50 (3/4/6/3) at 224, Candle-Uno and NMT at
    their defaults: the same graphs (no parameter is drawn)."""
    for build in (lambda a, f: a.build_alexnet(f(batch_size=2)),
                  lambda a, f: a.build_resnet(f(batch_size=2)),
                  lambda a, f: a.build_candle_uno(ffconfig=f(batch_size=2)),
                  lambda a, f: a.build_nmt(ffconfig=f(batch_size=2))):
        assert _graph(build(papps, fft.FFConfig)) == \
            _graph(build(japps, ffj.FFConfig))


def test_nmt_seq_shards_sets_the_lstm_configs_and_changes_no_value():
    """``build_nmt(seq_shards=2)``: every LSTM carries the time-sharded
    config, as in JAX, and a step on one device equals the unsharded one
    bit for bit."""
    cfg = papps.NMTConfig(**_NMT)
    jcfg = japps.NMTConfig(**_NMT)
    sharded = papps.build_nmt(cfg, fft.FFConfig(batch_size=4), seq_shards=2)
    jsharded = japps.build_nmt(jcfg, ffj.FFConfig(batch_size=4),
                               seq_shards=2)
    for op, jop in zip(sharded.layers, jsharded.layers):
        want = jop.parallel_config
        got = op.parallel_config
        assert (None if want is None else tuple(want.dims)) == \
            (None if got is None else tuple(got.dims)), op.name
    plain = papps.build_nmt(cfg, fft.FFConfig(batch_size=4))
    results = []
    for m in (plain, sharded):
        m.compile(optimizer=fft.SGDOptimizer(lr=0.5),
                  loss_type="sparse_categorical_crossentropy")
        st = m.init(seed=0, device="cpu")
        inputs, labels = _batches(m, 4, 1, seed=2)[0]
        st, mets = m.train_step(st, inputs, labels)
        results.append((float(mets["loss"]), st))
    assert results[0][0] == results[1][0]
    for op, d in results[0][1].params.items():
        for k, v in d.items():
            assert torch.equal(v, results[1][1].params[op][k]), (op, k)


def test_app_clis_match_jax_signatures_and_data():
    """``run`` and the ``build_*`` functions take the JAX signatures;
    each CLI loader yields the JAX CLI's data (the same generator and
    draws)."""
    import inspect
    for name in ("alexnet", "resnet", "inception", "candle_uno", "nmt"):
        jmod = getattr(japps, name)
        pmod = getattr(papps, name)
        assert inspect.signature(pmod.run) == inspect.signature(jmod.run)
    f = fft.FFConfig(batch_size=2)
    x, y = next(iter(papps.alexnet.cli_loader(f)))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        x["input"], rng.standard_normal((8, 3, 229, 229)).astype(
            np.float32)[:2])
    cfg = papps.NMTConfig()
    x, y = next(iter(papps.nmt.cli_loader(cfg, f)))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        x["src"], rng.integers(0, cfg.vocab_size, size=(8, 40),
                               dtype=np.int32)[:2])
    assert y.shape == (2, 40, 1)
