"""The port's stateful and stochastic training against the JAX package's
on the CPU: batch norm's running statistics through the training step,
the eval-mode forward on them, both packages' npz checkpoints of a small
ResNet with a batch-norm layer, and a dropout graph's fit killed and
resumed.  JAX is imported here only.

Tolerances: the running statistics and losses of two steps at rtol 1e-5
(atol 1e-6; the port's products accumulate in f64, XLA's in f32), the
eval forward at rtol 1e-4; everything a checkpoint carries is compared
bit for bit (it moves data and computes nothing), and the resumed fit
equals the uninterrupted one bit for bit (the port's dropout masks are a
function of the key and the step alone).
"""

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import checkpoint as jckpt
from dlrm_flexflow_tpu.apps.resnet import bottleneck_block as jax_block

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.resnet import bottleneck_block
from dlrm_flexflow_tpu_torch.bridge import (opt_state_from_jax,
                                            params_from_jax, state_from_jax)
from dlrm_flexflow_tpu_torch.checkpoint import (restore_checkpoint,
                                                save_checkpoint)

B = 4


def _resnet_bn(pkg):
    """A small ResNet with a batch-norm layer after its stem: conv, batch
    norm (relu), one bottleneck block, global avg pool, dense, softmax."""
    m = pkg.FFModel(pkg.FFConfig(batch_size=B))
    x = m.create_tensor((B, 3, 16, 16), name="input")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1)
    t = m.batch_norm(t, relu=True)
    t = (jax_block if pkg is ffj else bottleneck_block)(m, t, 4, 2)
    t = m.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, pool_type="avg")
    t = m.dense(m.flat(t), 10)
    m.softmax(t)
    kw = {"mesh": False} if pkg is ffj else {}
    m.compile(optimizer=pkg.SGDOptimizer(lr=0.1),
              loss_type="sparse_categorical_crossentropy", metrics=(), **kw)
    return m


def _batch(seed):
    rng = np.random.default_rng(seed)
    return ({"input": (rng.standard_normal((B, 3, 16, 16)) * 2 + 0.5
                       ).astype(np.float32)},
            rng.integers(0, 10, size=(B, 1)).astype(np.int32))


def _jax_state(jm, steps):
    st = jm.init(seed=0)
    for i in range(steps):
        st, _ = jm.train_step(st, *_batch(i))
    return st


def _bits(x):
    a = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x))
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _assert_tree_bits(p, j):
    if isinstance(j, dict):
        assert set(p) == set(j)
        for k in j:
            _assert_tree_bits(p[k], j[k])
        return
    np.testing.assert_array_equal(_bits(p), _bits(j))


def test_running_statistics_and_eval_forward_match_jax():
    """Two steps from the same parameters: the losses and the running
    mean and variance equal JAX's; the eval forward (running statistics)
    equals JAX's predict."""
    jm, pm = _resnet_bn(ffj), _resnet_bn(fft)
    js = jm.init(seed=0)
    ps = pm.load_params(params_from_jax(jax.tree.map(np.asarray, js.params)),
                        device="cpu", opt_state=opt_state_from_jax(
                            jax.tree.map(np.asarray, js.opt_state)))
    assert set(ps.bn_state) == {"batch_norm"}
    for k in ("mean", "var"):
        np.testing.assert_array_equal(ps.bn_state["batch_norm"][k].numpy(),
                                      np.asarray(js.bn_state["batch_norm"][k]))
    held = {k: v for k, v in ps.bn_state["batch_norm"].items()}
    for i in range(2):
        js, jmets = jm.train_step(js, *_batch(i))
        ps, pmets = pm.train_step(ps, *_batch(i))
        np.testing.assert_allclose(float(pmets["loss"]),
                                   float(jmets["loss"]), rtol=1e-5)
    for k in ("mean", "var"):
        # written in place: the tensors the state started with
        assert ps.bn_state["batch_norm"][k] is held[k]
        np.testing.assert_allclose(ps.bn_state["batch_norm"][k].numpy(),
                                   np.asarray(js.bn_state["batch_norm"][k]),
                                   rtol=1e-5, atol=1e-6)
    x = _batch(7)[0]
    np.testing.assert_allclose(pm.predict(ps, x).numpy(),
                               np.asarray(jm.predict(js, x)), rtol=1e-4,
                               atol=1e-6)
    # one sample alone equals its row of the batch: no batch statistics
    one = pm.predict(ps, {"input": x["input"][:1]})
    torch.testing.assert_close(one[0], pm.predict(ps, x)[0], rtol=1e-6,
                               atol=1e-7)


def test_stateful_graph_refuses_bare_params():
    pm = _resnet_bn(fft)
    st = pm.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="BatchNorm"):
        pm.predict(st.params, _batch(0)[0])
    with pytest.raises(ValueError, match="BatchNorm"):
        fft.InferenceEngine(pm, st.params, warmup=False, device="cpu")
    engine = fft.InferenceEngine(pm, st, buckets=[4], device="cpu")
    x = _batch(1)[0]
    np.testing.assert_array_equal(np.asarray(engine.predict(x)),
                                  pm.predict(st, x).numpy())


def test_jax_bn_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    jm, pm = _resnet_bn(ffj), _resnet_bn(fft)
    js = _jax_state(jm, 2)
    p = jckpt.save_checkpoint(str(tmp_path / "j"), js, use_orbax=False,
                              model=jm)
    pm.init(seed=0, device="cpu")
    ps = restore_checkpoint(p, pm)
    for field in ("params", "opt_state", "bn_state"):
        _assert_tree_bits(getattr(ps, field), getattr(js, field))
    assert set(ps.bn_state["batch_norm"]) == {"mean", "var"}
    # the port steps the restored state as it steps the bridged one
    ref = state_from_jax(jax.tree.map(np.asarray, js))
    _, a = pm.train_step(ps, *_batch(3))
    _, b = pm.train_step(ref, *_batch(3))
    assert float(a["loss"]) == float(b["loss"])


def test_port_bn_checkpoint_restores_into_jax_bit_for_bit(tmp_path):
    pm = _resnet_bn(fft)
    ps = pm.init(seed=0, device="cpu")
    for i in range(2):
        ps, _ = pm.train_step(ps, *_batch(i))
    p = save_checkpoint(str(tmp_path / "p"), ps, model=pm)
    js = jckpt.restore_checkpoint(p, _resnet_bn(ffj))
    for field in ("params", "opt_state", "bn_state", "rng", "step"):
        _assert_tree_bits(getattr(ps, field), getattr(js, field))
    assert not np.array_equal(np.asarray(js.bn_state["batch_norm"]["var"]),
                              np.ones(8, np.float32))


def _dropout_model():
    m = fft.FFModel(fft.FFConfig(batch_size=8))
    x = m.create_tensor((8, 6), name="x")
    t = m.dense(x, 16, activation="relu")
    t = m.dropout(t, 0.4)
    t = m.dense(t, 16, activation="tanh")
    t = m.dropout(t, 0.2, seed=5)
    m.dense(t, 1)
    m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=())
    return m


def test_dropout_fit_killed_and_resumed_equals_uninterrupted(tmp_path):
    """A dropout graph's ``fit`` over 2 epochs x 8 shuffled batches,
    saving every 4 steps, killed at step 10 and resumed from its step-8
    checkpoint: every step's loss and the final parameters equal the
    uninterrupted run's bit for bit, and the masks did change the run
    (the same run with the key of another seed differs)."""
    from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader
    from dlrm_flexflow_tpu_torch.resilience import (CheckpointManager,
                                                    Preemption, faultinject)
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((64, 6)).astype(np.float32)
    ys = rng.standard_normal((64, 1)).astype(np.float32)

    def run(root, seed=0, **kw):
        m = _dropout_model()
        loader = ArrayDataLoader({"x": xs}, ys, 8, shuffle=True, seed=2)
        st, _ = m.fit(m.init(seed=seed, device="cpu"), loader, epochs=2,
                      verbose=False, checkpoint_every_n_steps=4,
                      checkpoint_manager=CheckpointManager(
                          str(tmp_path / root), use_orbax=False), **kw)
        return m, st

    faultinject.clear()
    faultinject.install("preempt@step=10")
    try:
        with pytest.raises(Preemption):
            run("ck")
    finally:
        faultinject.clear()
    resumed, rs = run("ck", resume=True)
    twin, ts = run("twin")
    assert resumed._fit_loss_steps[0] == 9
    ref = dict(zip(twin._fit_loss_steps.tolist(),
                   twin._fit_loss_trace.tolist()))
    assert len(ref) == 16
    for step, loss in zip(resumed._fit_loss_steps.tolist(),
                          resumed._fit_loss_trace.tolist()):
        assert ref[step] == loss
    for op, d in ts.params.items():
        for k, v in d.items():
            assert torch.equal(rs.params[op][k], v), (op, k)
    # the params of another seed's run would differ anyway, so compare
    # the same initial params under another key
    other = _dropout_model()
    base = other.init(seed=0, device="cpu")
    keyed = other.init(seed=1, device="cpu")
    keyed = fft.TrainState(base.clone().params, keyed.opt_state,
                           keyed.bn_state, keyed.rng, keyed.step)
    batch = ({"x": xs[:8]}, ys[:8])
    _, a = other.train_step(base, *batch)
    _, b = other.train_step(keyed, *batch)
    assert float(a["loss"]) != float(b["loss"])
