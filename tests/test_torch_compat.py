"""The port's reference-compatible API (``dlrm_flexflow_tpu_torch/flexflow``)
against the JAX package's (``flexflow/``) and against the port's own
model, on the CPU at small sizes.

* JAX's ``flexflow`` and the port's, built with the same calls, the JAX
  model's weights carried across with ``bridge.state_from_jax``: forward
  values within 1e-5; after 3 steps of the imperative verbs and after 2
  epochs of ``train()``, every weight within 1e-5 of its largest
  magnitude and every metric within 1e-5 (relative).
* The port's compat model against a native port ``FFModel`` built with
  the same calls, the same weights and arrays: ``train()`` against
  ``fit`` and the verbs against ``train_step``, bit for bit (tolerance
  0, with embeddings too: the verbs are the step's two halves).
* The counterpart of every class of ``tests/test_flexflow_compat.py``,
  the port's RNG rule (a step never advances ``rng``; the verbs draw
  ``train_step``'s masks) in place of JAX's split key.
* Every ``examples/compat/`` script unchanged under
  ``use_port_flexflow(device="cpu")``, the scoping of the alias, the
  ``python -m`` entry, and that nothing under the subpackage (nor
  ``chip_smoke.py``) imports JAX, JAX's ``flexflow`` or the JAX package.
"""

import ast
import contextlib
import importlib
import io
import os
import sys

import numpy as np
import pytest
import torch

import flexflow.core as jc  # the JAX package's binding
from dlrm_flexflow_tpu_torch import SGDOptimizer as CoreSGD
from dlrm_flexflow_tpu_torch import bridge
from dlrm_flexflow_tpu_torch.config import FFConfig as CoreConfig
from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader
from dlrm_flexflow_tpu_torch.flexflow import use_port_flexflow
from dlrm_flexflow_tpu_torch.flexflow.scope import run_script
from dlrm_flexflow_tpu_torch.metrics import MetricsAccumulator
from dlrm_flexflow_tpu_torch.model import FFModel as CoreModel

import dlrm_flexflow_tpu_torch.flexflow.core as pc  # the port's binding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "compat")
PORT_DIR = os.path.join(ROOT, "dlrm_flexflow_tpu_torch", "flexflow")

WEIGHT_TOL = 1e-5   # of each weight's largest magnitude
METRIC_RTOL = 1e-5
FORWARD_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These graphs are tiny: one intra-op thread runs them many times
    faster than a pool that wakes for every op on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def port():
    """The port's ``flexflow`` under its own name, weights on the CPU."""
    with use_port_flexflow(device="cpu") as ff:
        yield ff


# ------------------------------------------------------ model construction
def _mnist_like(n=256, d=64, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, classes)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32).reshape(n, 1)
    return x, y


def _dlrm_data(n, tables, rows, bot, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, bot)).astype(np.float32)
    ids = [rng.integers(0, rows, (n, 1)).astype(np.int64)
           for _ in range(tables)]
    labels = rng.integers(0, 2, (n, 1)).astype(np.float32)
    return dense, ids, labels


def _build(fc, kind, batch=16, n=64):
    """The same model through ``fc`` (JAX's binding or the port's): an
    MLP under sparse CCE ("mlp") or the run_random.sh DLRM shape cut to
    4 tables of 1000 x 8 ("dlrm").  Returns the model, its config, its
    loaders (over ``n`` samples from a seed) and its output tensor."""
    ffconfig = fc.FFConfig()
    ffconfig.parse_args(["-b", str(batch)])
    m = fc.FFModel(ffconfig)
    relu = fc.ActiMode.AC_MODE_RELU
    if kind == "mlp":
        x, y = _mnist_like(n, d=32, classes=4)
        inp = m.create_tensor([batch, 32], fc.DataType.DT_FLOAT)
        t = m.dense(inp, 24, relu)
        t = m.dense(t, 4)
        out = m.softmax(t)
        m.compile(optimizer=fc.SGDOptimizer(m, 0.1),
                  loss_type=fc.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[fc.MetricsType.METRICS_ACCURACY,
                           fc.MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
        feeds = [(inp, x, fc.DataType.DT_FLOAT)]
        labels = (y, fc.DataType.DT_INT32)
    else:
        tables, rows, dim, bot = 4, 1000, 8, 8
        dense, ids, y = _dlrm_data(n, tables, rows, bot)
        d_in = m.create_tensor([batch, bot], fc.DataType.DT_FLOAT)
        id_ins = [m.create_tensor([batch, 1], fc.DataType.DT_INT64)
                  for _ in range(tables)]
        embs = [m.embedding(i, rows, dim, fc.AggrMode.AGGR_MODE_SUM)
                for i in id_ins]
        t = m.dense(d_in, 16, relu)
        t = m.dense(t, dim, relu)
        t = m.concat([t] + embs, axis=1)
        t = m.dense(t, 16, relu)
        out = m.dense(t, 1, fc.ActiMode.AC_MODE_SIGMOID)
        m.compile(optimizer=fc.SGDOptimizer(m, 0.1),
                  loss_type=fc.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                  metrics=[fc.MetricsType.METRICS_ACCURACY,
                           fc.MetricsType.METRICS_MEAN_SQUARED_ERROR])
        feeds = ([(d_in, dense, fc.DataType.DT_FLOAT)]
                 + [(i, a, fc.DataType.DT_INT64) for i, a in zip(id_ins, ids)])
        labels = (y, fc.DataType.DT_FLOAT)
    loaders = []
    for tensor, arr, dt in feeds + [(m.get_label_tensor(),) + labels]:
        full = m.create_tensor(list(arr.shape), dt)
        full.attach_numpy_array(ffconfig, arr)
        loaders.append(fc.SingleDataLoader(m, tensor, full, n, dt))
    return m, ffconfig, loaders, out


def _carry(jm, pm):
    """The JAX compat model's state into the port compat model (CPU)."""
    st = bridge.state_from_jax(jm._require_state())
    pm._state = pm._core.load_params(st.params, device="cpu",
                                     opt_state=st.opt_state)


def _verb_steps(m, loaders, steps):
    for _ in range(steps):
        for d in loaders:
            d.next_batch(m)
        m.forward()
        m.zero_gradients()
        m.backward()
        m.update()


def _weights(m):
    return {(op.name, s.param_name): np.asarray(
        m._core.get_weights(m._state, op.name, s.param_name))
        for op in m._core.layers for s in op.param_specs()}


def _assert_weights_close(jm, pm):
    jw, pw = _weights(jm), _weights(pm)
    assert jw.keys() == pw.keys()
    for k in jw:
        scale = max(float(np.abs(jw[k]).max()), 1e-30)
        err = float(np.abs(jw[k] - pw[k]).max())
        assert err <= WEIGHT_TOL * scale, (k, err, scale)


def _assert_metrics_close(jm, pm):
    jmets = jm._acc.finalized_means()
    pmets = pm._acc.finalized_means()
    assert jmets.keys() == pmets.keys()
    for k in jmets:
        np.testing.assert_allclose(pmets[k], jmets[k], rtol=METRIC_RTOL,
                                   err_msg=k)


# ----------------------------------------------------- JAX against the port
@pytest.mark.parametrize("kind", ["mlp", "dlrm"])
class TestAgainstJax:

    def test_forward_values(self, port, kind):
        jm, jcfg, jl, jout = _build(jc, kind)
        pm, pcfg, pl, pout = _build(pc, kind)
        _carry(jm, pm)
        for m, loaders in ((jm, jl), (pm, pl)):
            for d in loaders:
                d.next_batch(m)
            m.forward()
        want = np.asarray(jout.get_array(jcfg))
        got = pout.get_array(pcfg)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)

    def test_verbs_three_steps(self, port, kind):
        jm, _, jl, _ = _build(jc, kind)
        pm, _, pl, _ = _build(pc, kind)
        _carry(jm, pm)
        _verb_steps(jm, jl, 3)
        _verb_steps(pm, pl, 3)
        assert int(pm._state.step) == 3
        _assert_weights_close(jm, pm)
        _assert_metrics_close(jm, pm)

    def test_train_two_epochs(self, port, kind, capsys):
        jm, _, jl, _ = _build(jc, kind)
        pm, _, pl, _ = _build(pc, kind)
        _carry(jm, pm)
        jm.train(jl, epochs=2)
        pm.train(pl, epochs=2)
        out = capsys.readouterr().out
        assert pm._core._last_fit_used_scan
        assert int(pm._state.step) == 2 * (64 // 16)
        _assert_weights_close(jm, pm)
        _assert_metrics_close(jm, pm)
        assert out.count("epoch 1:") == 2 and "THROUGHPUT" not in out


# ----------------------------------------------- the port against the port
def _native(kind, batch=16):
    """The port's own FFModel built with the calls ``_build`` makes
    through the binding."""
    m = CoreModel(CoreConfig(batch_size=batch))
    if kind == "mlp":
        inp = m.create_tensor((batch, 32), "float32")
        t = m.dense(inp, 24, "relu")
        t = m.dense(t, 4)
        m.softmax(t)
        m.compile(optimizer=CoreSGD(lr=0.1),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=("accuracy", "sparse_categorical_crossentropy"))
        return m, [inp.name]
    d_in = m.create_tensor((batch, 8), "float32")
    ids = [m.create_tensor((batch, 1), "int64") for _ in range(4)]
    embs = [m.embedding(i, 1000, 8, "sum") for i in ids]
    t = m.dense(d_in, 16, "relu")
    t = m.dense(t, 8, "relu")
    t = m.concat([t] + embs, axis=1)
    t = m.dense(t, 16, "relu")
    m.dense(t, 1, "sigmoid")
    m.compile(optimizer=CoreSGD(lr=0.1), loss_type="mean_squared_error",
              metrics=("accuracy", "mean_squared_error"))
    return m, [d_in.name] + [i.name for i in ids]


def _same_state(a, b):
    pa, pb = _flat(a.params), _flat(b.params)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert int(a.step) == int(b.step)


def _flat(params):
    return {(o, k): v for o, d in params.items() for k, v in d.items()}


@pytest.mark.parametrize("kind", ["mlp", "dlrm"])
class TestAgainstNative:

    def _pair(self, kind):
        pm, _, loaders, _ = _build(pc, kind)
        state = pm._require_state()
        native, names = _native(kind)
        nstate = native.load_params(
            {o: dict(d) for o, d in state.params.items()}, device="cpu")
        arrays = [d._data for d in loaders]
        inputs = dict(zip(names, arrays[:-1]))
        return pm, loaders, native, nstate, inputs, arrays[-1]

    def test_train_is_fit(self, port, kind, capsys):
        pm, loaders, native, nstate, inputs, labels = self._pair(kind)
        pm.train(loaders, epochs=2)
        nstate, _ = native.fit(nstate, ArrayDataLoader(inputs, labels, 16),
                               epochs=2, verbose=True, warmup=False,
                               show_throughput=False)
        out = capsys.readouterr().out.splitlines()
        assert out[:2] == out[2:] and len(out) == 4
        _same_state(pm._state, nstate)
        assert (pm._acc.finalized_means()
                == native.get_perf_metrics().finalized_means())

    def test_verbs_are_train_step(self, port, kind):
        pm, loaders, native, nstate, inputs, labels = self._pair(kind)
        acc = MetricsAccumulator(native.metrics)
        for i in range(3):
            _verb_steps(pm, loaders, 1)
            sl = slice(16 * i, 16 * (i + 1))
            nstate, mets = native.train_step(
                nstate, {k: v[sl] for k, v in inputs.items()}, labels[sl])
            acc.update({k: v for k, v in mets.items() if k != "loss"})
        _same_state(pm._state, nstate)
        assert pm._acc.finalized_means() == acc.finalized_means()


# ----------------------------------- counterparts of test_flexflow_compat.py
class TestNativeScriptParity:
    """The reference mnist_mlp.py top_level_task, line for line, on the
    port (``TestNativeScriptParity`` of test_flexflow_compat.py)."""

    def test_mnist_mlp_script(self, port):
        from flexflow.core import (ActiMode, DataType, FFConfig, FFModel,
                                   LossType, MetricsType, SGDOptimizer,
                                   SingleDataLoader, UniformInitializer)
        ffconfig = FFConfig()
        ffconfig.parse_args(["-b", "32", "-e", "8"])
        assert ffconfig.get_batch_size() == 32
        assert ffconfig.get_epochs() == 8
        assert ffconfig.get_num_nodes() == 1
        ffmodel = FFModel(ffconfig)
        num_samples = 256
        input_tensor = ffmodel.create_tensor([32, 64], DataType.DT_FLOAT)
        t = ffmodel.dense(input_tensor, 128, ActiMode.AC_MODE_RELU,
                          kernel_initializer=UniformInitializer(12, -0.08,
                                                                0.08))
        t = ffmodel.dense(t, 128, ActiMode.AC_MODE_RELU)
        t = ffmodel.dense(t, 10)
        t = ffmodel.softmax(t)
        ffmodel.set_sgd_optimizer(SGDOptimizer(ffmodel, 0.2))
        ffmodel.compile(
            loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
            metrics=[MetricsType.METRICS_ACCURACY,
                     MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
        label_tensor = ffmodel.get_label_tensor()
        assert label_tensor.data_type == DataType.DT_INT32
        x_train, y_train = _mnist_like(num_samples)
        full_input = ffmodel.create_tensor([num_samples, 64],
                                           DataType.DT_FLOAT)
        full_label = ffmodel.create_tensor([num_samples, 1],
                                           DataType.DT_INT32)
        full_input.attach_numpy_array(ffconfig, x_train)
        full_label.attach_numpy_array(ffconfig, y_train)
        dl_in = SingleDataLoader(ffmodel, input_tensor, full_input,
                                 num_samples, DataType.DT_FLOAT)
        dl_lab = SingleDataLoader(ffmodel, label_tensor, full_label,
                                  num_samples, DataType.DT_INT32)
        full_input.detach_numpy_array(ffconfig)
        full_label.detach_numpy_array(ffconfig)
        ffmodel.init_layers()
        ts_start = ffconfig.get_current_time()
        ffmodel.train((dl_in, dl_lab), ffconfig.get_epochs())
        ffmodel.eval((dl_in, dl_lab))
        assert ffconfig.get_current_time() > ts_start
        accuracy = ffmodel.get_perf_metrics().get_accuracy()
        assert accuracy > 50.0, f"eval accuracy {accuracy}"

    def test_imperative_verbs_reduce_loss(self, port):
        m, cfg, loaders, _ = _build(pc, "mlp", batch=64, n=64)

        def current_accuracy():
            m.reset_metrics()
            for d in loaders:
                d.reset()
                d.next_batch(m)
            m.forward()
            m.compute_metrics()
            return m.get_perf_metrics().get_accuracy()

        acc0 = current_accuracy()
        for _ in range(30):
            for d in loaders:
                d.reset()
            _verb_steps(m, loaders, 1)
        acc1 = current_accuracy()
        assert acc1 > acc0 or acc1 == pytest.approx(100.0)

    def test_weights_roundtrip_and_layer_access(self, port):
        from flexflow.core import (DataType, FFConfig, FFModel, LossType,
                                   MetricsType, SGDOptimizer)
        ffconfig = FFConfig()
        ffmodel = FFModel(ffconfig)
        inp = ffmodel.create_tensor([16, 8], DataType.DT_FLOAT)
        ffmodel.dense(inp, 4, name="fc1")
        ffmodel.compile(optimizer=SGDOptimizer(ffmodel, 0.01),
                        loss_type=LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                        metrics=[MetricsType.METRICS_MEAN_SQUARED_ERROR])
        ffmodel.init_layers()
        kernel = ffmodel.get_layer_by_name("fc1").get_weight_tensor()
        w = kernel.get_weights(ffmodel)
        assert w.shape == (8, 4) and kernel.data_type == DataType.DT_FLOAT
        new_w = np.ones_like(w)
        kernel.set_weights(ffmodel, new_w)
        np.testing.assert_array_equal(kernel.get_weights(ffmodel), new_w)
        # both verbs copy (ROADMAP C4, C5): neither array aliases the state
        new_w[0, 0] = 7.0
        got = kernel.get_weights(ffmodel)
        assert got[0, 0] == 1.0
        got[0, 1] = 9.0
        assert kernel.get_weights(ffmodel)[0, 1] == 1.0
        p0 = ffmodel.get_tensor_by_id(0)
        np.testing.assert_array_equal(p0.get_weights(ffmodel),
                                      np.ones_like(w))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ffmodel.print_layers()
        assert "layer 0: fc1 (LINEAR) -> (16, 4)" in buf.getvalue()

    def test_ops_surface(self, port):
        from flexflow.core import (ActiMode, AdamOptimizer, DataLoader2D,
                                   DataType, FFConfig, FFModel, LossType,
                                   MetricsType, PoolType)
        ffconfig = FFConfig()
        ffconfig.parse_args(["-b", "8"])
        ffmodel = FFModel(ffconfig)
        img = ffmodel.create_tensor([8, 3, 16, 16], DataType.DT_FLOAT)
        t = ffmodel.conv2d(img, 4, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
        t = ffmodel.pool2d(t, 2, 2, 2, 2, 0, 0, PoolType.POOL_MAX)
        t = ffmodel.batch_norm(t, relu=True)
        t = ffmodel.flat(t)
        a = ffmodel.dense(t, 16, ActiMode.AC_MODE_TANH)
        b = ffmodel.dense(t, 16, ActiMode.AC_MODE_SIGMOID)
        t = ffmodel.add(a, b)
        t = ffmodel.subtract(t, b)
        t = ffmodel.multiply(t, a)
        t = ffmodel.exp(t)
        t = ffmodel.dropout(t, 0.2, 0)
        parts = ffmodel.split(t, 2, axis=1)
        t = ffmodel.concat(parts, axis=1)
        t = ffmodel.reshape(t, [8, 4, 4])
        t = ffmodel.transpose(t, [0, 2, 1])
        t = ffmodel.reverse(t, 1)
        t = ffmodel.reshape(t, [8, 16])
        t = ffmodel.dense(t, 4)
        t = ffmodel.softmax(t)
        ffmodel.compile(
            optimizer=AdamOptimizer(ffmodel, 0.001),
            loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
            metrics=[MetricsType.METRICS_ACCURACY])
        ffmodel.init_layers()
        rng = np.random.default_rng(0)
        x = rng.standard_normal((8, 3, 16, 16)).astype(np.float32)
        y = rng.integers(0, 4, (8, 1)).astype(np.int32)
        full_x = ffmodel.create_tensor([8, 3, 16, 16], DataType.DT_FLOAT)
        full_y = ffmodel.create_tensor([8, 1], DataType.DT_INT32)
        full_x.attach_numpy_array(ffconfig, x)
        full_y.attach_numpy_array(ffconfig, y)
        dl = DataLoader2D(ffmodel, img, ffmodel.get_label_tensor(),
                          full_x, full_y, 8)
        ffmodel.train((dl,), epochs=1)
        assert int(ffmodel._state.step) == 1

    def test_embedding_and_constant(self, port):
        from flexflow.core import (ActiMode, AggrMode, DataType, FFConfig,
                                   FFModel, GlorotUniformInitializer,
                                   LossType, MetricsType, SGDOptimizer,
                                   SingleDataLoader, ZeroInitializer)
        ffconfig = FFConfig()
        ffconfig.parse_args(["-b", "16"])
        ffmodel = FFModel(ffconfig)
        idx = ffmodel.create_tensor([16, 4], DataType.DT_INT64)
        emb = ffmodel.embedding(idx, 100, 8, AggrMode.AGGR_MODE_SUM,
                                kernel_initializer=GlorotUniformInitializer(7))
        c = ffmodel.create_constant([16, 8], 1.0, DataType.DT_FLOAT)
        t = ffmodel.multiply(emb, c)
        ffmodel.dense(t, 1, ActiMode.AC_MODE_SIGMOID,
                      bias_initializer=ZeroInitializer())
        ffmodel.compile(optimizer=SGDOptimizer(ffmodel, 0.01),
                        loss_type=LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                        metrics=[MetricsType.METRICS_MEAN_SQUARED_ERROR,
                                 MetricsType.METRICS_ACCURACY])
        ffmodel.init_layers()
        rng = np.random.default_rng(1)
        ids = rng.integers(0, 100, (16, 4)).astype(np.int64)
        lab = rng.random((16, 1)).astype(np.float32)
        full_i = ffmodel.create_tensor([16, 4], DataType.DT_INT64)
        full_l = ffmodel.create_tensor([16, 1], DataType.DT_FLOAT)
        full_i.attach_numpy_array(ffconfig, ids)
        full_l.attach_numpy_array(ffconfig, lab)
        dl_i = SingleDataLoader(ffmodel, idx, full_i, 16, DataType.DT_INT64)
        dl_l = SingleDataLoader(ffmodel, ffmodel.get_label_tensor(), full_l,
                                16, DataType.DT_FLOAT)
        before = ffmodel.get_layers()[0].get_weight_tensor().get_weights(
            ffmodel)
        ffmodel.train((dl_i, dl_l), epochs=1)
        # the constant keeps the per-batch loop: one train_step
        assert int(ffmodel._state.step) == 1
        after = ffmodel.get_layers()[0].get_weight_tensor().get_weights(
            ffmodel)
        touched = np.unique(ids)
        assert not np.array_equal(after[touched], before[touched])
        rest = np.setdiff1d(np.arange(100), touched)
        np.testing.assert_array_equal(after[rest], before[rest])

    def test_netconfig(self, port):
        from flexflow.core import NetConfig
        assert NetConfig().dataset_path == ""


class TestKerasScriptParity:
    """``TestKerasScriptParity`` of test_flexflow_compat.py on the port."""

    def test_seq_mnist_mlp_script(self, port):
        import flexflow.keras.optimizers
        from flexflow.keras.initializers import GlorotUniform, Zeros
        from flexflow.keras.layers import Activation, Dense, Dropout
        from flexflow.keras.models import Sequential
        x_train, y_train = _mnist_like(128, d=48, classes=10)
        model = Sequential()
        model.add(Dense(64, input_shape=(48,),
                        kernel_initializer=GlorotUniform(123),
                        bias_initializer=Zeros()))
        model.add(Activation("relu"))
        model.add(Dropout(0.1))
        model.add(Dense(64, activation="relu"))
        model.add(Dense(10))
        model.add(Activation("softmax"))
        model.compile(optimizer=flexflow.keras.optimizers.SGD(
                          learning_rate=0.05),
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy", "sparse_categorical_crossentropy"],
                      batch_size=32)
        # compile took the scope's device
        assert all(v.device.type == "cpu" for d in model.state.params.values()
                   for v in d.values())
        model.fit(x_train, y_train, epochs=2, verbose=False)
        model.evaluate(x=x_train, y=y_train)

    def test_functional_with_loss_metric_objects(self, port):
        from flexflow.keras import losses, metrics
        from flexflow.keras.layers import (Activation, Concatenate, Dense,
                                           Input)
        from flexflow.keras.models import Model
        i1, i2 = Input(shape=(8,)), Input(shape=(8,))
        merged = Concatenate(axis=1)([i1, i2])
        out = Dense(4, activation="relu")(merged)
        out = Activation("softmax")(Dense(2)(out))
        model = Model(inputs=[i1, i2], outputs=out)
        model.compile(optimizer="adam",
                      loss=losses.SparseCategoricalCrossentropy(),
                      metrics=[metrics.Accuracy(),
                               metrics.SparseCategoricalCrossentropy()],
                      batch_size=16)
        rng = np.random.default_rng(0)
        x1 = rng.standard_normal((32, 8)).astype(np.float32)
        x2 = rng.standard_normal((32, 8)).astype(np.float32)
        y = rng.integers(0, 2, (32, 1)).astype(np.int32)
        model.fit([x1, x2], y, epochs=1, verbose=False)

    def test_datasets_and_utils(self, port):
        from flexflow.keras.datasets import cifar10, mnist
        from flexflow.keras.utils import np_utils, to_categorical
        (x, _), _ = mnist.load_data()
        assert x.shape[1:] == (28, 28)
        (xc, _), _ = cifar10.load_data(64)
        assert xc.shape[1:] == (3, 32, 32)
        assert to_categorical(np.array([0, 2, 1]), 3).shape == (3, 3)
        assert np_utils.to_categorical is to_categorical

    def test_typed_op_handles(self, port):
        import flexflow.core as fc
        ffconfig = fc.FFConfig()
        ffconfig.parse_args(["x", "-b", "4"])
        ffmodel = fc.FFModel(ffconfig)
        t = ffmodel.create_tensor([4, 8], fc.DataType.DT_FLOAT)
        d = ffmodel.dense(t, 16, fc.ActiMode.AC_MODE_RELU)
        ffmodel.dense(d, 1)
        layers = ffmodel.get_layers()
        assert isinstance(layers[0], fc.Linear)
        assert isinstance(layers[1], fc.Linear)
        ffmodel.optimizer = fc.SGDOptimizer(ffmodel, 0.01)
        ffmodel.compile(
            loss_type=fc.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
            metrics=[fc.MetricsType.METRICS_MEAN_SQUARED_ERROR])
        t.attach_numpy_array(
            ffconfig, np.random.default_rng(0).standard_normal(
                (4, 8)).astype(np.float32))
        layers[0].init(ffmodel)
        layers[0].forward(ffmodel)
        assert layers[0].get_output_tensor().get_array(
            ffconfig).shape == (4, 16)
        assert layers[0].get_weight_tensor().get_weights(
            ffmodel).shape == (8, 16)
        converted = fc.convert_op_handle_to_op(
            fc.OpType.LINEAR, (ffmodel, layers[0]._core_op), 0, "l0")
        assert isinstance(converted, fc.Linear)

    def test_per_op_forward_runs_the_graph_once(self, port, monkeypatch):
        """Per-op Op.forward runs the graph once per (state, step, input
        contents): the memo goes stale on a refilled buffer and on a
        step, since the state keeps its identity (the JAX memo's
        identity key would not)."""
        m, cfg, loaders, _ = _build(pc, "mlp")
        for d in loaders:
            d.next_batch(m)
        runs = []
        real = m._core._apply
        monkeypatch.setattr(m._core, "_apply",
                            lambda *a, **k: runs.append(1) or real(*a, **k))
        for op in m.get_layers().values():
            op.forward(m)
        assert len(runs) == 1
        m._pending[loaders[0]._target][0, 0] += 1.0  # refilled in place
        m.forward()
        assert len(runs) == 2
        state = m._state
        m.backward()
        m.update()
        assert m._state is state
        m.forward()
        assert len(runs) == 4  # backward's training forward, then this one

    def test_submodule_import_styles(self, port):
        for mod in ("flexflow.keras.datasets.mnist",
                    "flexflow.keras.datasets.cifar10",
                    "flexflow.keras.datasets.reuters",
                    "flexflow.keras.utils.np_utils",
                    "flexflow.keras.utils.data_utils",
                    "flexflow.keras.utils.generic_utils"):
            importlib.import_module(mod)
        from flexflow.keras.utils.generic_utils import Progbar
        p = Progbar(4)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            p.update(2, values=[("loss", 0.5)])
            p.add(2, values=[("loss", 0.3)])
        out = buf.getvalue()
        assert "4/4" in out and "loss" in out


class TestTorchScriptParity:
    """reference examples/python/pytorch/mnist_mlp.py shape, on the port."""

    def test_torch_to_flexflow_roundtrip(self, port, tmp_path):
        import torch.nn as nn
        from flexflow.core import (DataType, FFConfig, FFModel, LossType,
                                   MetricsType, SGDOptimizer,
                                   SingleDataLoader)
        from flexflow.torch.fx import torch_to_flexflow
        from flexflow.torch.model import PyTorchModel
        mlp = nn.Sequential(nn.Linear(32, 16), nn.ReLU(), nn.Linear(16, 4),
                            nn.Softmax(dim=1))
        fname = str(tmp_path / "mlp.ff")
        torch_to_flexflow(mlp, fname)
        ffconfig = FFConfig()
        ffconfig.parse_args(["-b", "16"])
        ffmodel = FFModel(ffconfig)
        input_tensor = ffmodel.create_tensor([16, 32], DataType.DT_FLOAT)
        torch_model = PyTorchModel(fname)
        output_tensors = torch_model.apply(ffmodel, [input_tensor])
        assert output_tensors[0].dims == (16, 4)
        ffmodel.compile(
            optimizer=SGDOptimizer(ffmodel, 0.01),
            loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
            metrics=[MetricsType.METRICS_ACCURACY])
        ffmodel.init_layers()
        torch_model.import_weights(ffmodel)
        x = np.random.default_rng(0).standard_normal((16, 32)).astype(
            np.float32)
        full_x = ffmodel.create_tensor([16, 32], DataType.DT_FLOAT)
        full_x.attach_numpy_array(ffconfig, x)
        dl = SingleDataLoader(ffmodel, input_tensor, full_x, 16,
                              DataType.DT_FLOAT)
        dl.next_batch(ffmodel)
        ffmodel.forward()
        got = output_tensors[0].get_array(ffconfig)
        with torch.no_grad():
            want = mlp(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _threading_model(with_dropout=False, with_bn=False):
    """``TestImperativeStateThreading._build`` of test_flexflow_compat.py
    on the port, with the native twin's arrays."""
    import flexflow.core as fc
    ffconfig = fc.FFConfig()
    ffconfig.parse_args(["-b", "16"])
    ffmodel = fc.FFModel(ffconfig)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 1)).astype(np.float32)
    inp = ffmodel.create_tensor([16, 8], fc.DataType.DT_FLOAT)
    t = ffmodel.dense(inp, 8, fc.ActiMode.AC_MODE_RELU)
    if with_bn:
        t4 = ffmodel.reshape(t, [16, 2, 2, 2])
        t4 = ffmodel.batch_norm(t4, relu=False)
        t = ffmodel.reshape(t4, [16, 8])
    if with_dropout:
        t = ffmodel.dropout(t, 0.5, 0)
    ffmodel.dense(t, 1)
    ffmodel.compile(optimizer=fc.SGDOptimizer(ffmodel, 0.05),
                    loss_type=fc.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                    metrics=[fc.MetricsType.METRICS_MEAN_SQUARED_ERROR])
    ffmodel.init_layers()
    fx = ffmodel.create_tensor([16, 8], fc.DataType.DT_FLOAT)
    fy = ffmodel.create_tensor([16, 1], fc.DataType.DT_FLOAT)
    fx.attach_numpy_array(ffconfig, x)
    fy.attach_numpy_array(ffconfig, y)
    loaders = [fc.SingleDataLoader(ffmodel, inp, fx, 16, fc.DataType.DT_FLOAT),
               fc.SingleDataLoader(ffmodel, ffmodel.get_label_tensor(), fy,
                                   16, fc.DataType.DT_FLOAT)]
    return ffmodel, loaders, {inp._t.name: x}, y


class TestImperativeStateThreading:
    """The verbs thread batch norm's statistics and the dropout key as
    ``train_step`` does.  The port's key rule replaces JAX's split: a
    step never advances ``rng``, and the masks hash ``(rng, step)``."""

    def _against_train_step(self, **kw):
        m, loaders, x, y = _threading_model(**kw)
        twin = m._state.clone()
        rng0 = m._state.rng.clone()
        _verb_steps(m, loaders, 1)
        twin, _ = m._core.train_step(twin, x, y, donate=False)
        _same_state(m._state, twin)
        return m, twin, rng0

    def test_bn_running_stats_advance(self, port):
        m, loaders, x, y = _threading_model(with_bn=True)
        before = {k: v.clone() for k, v in _flat(m._state.bn_state).items()}
        assert before, "graph has no BN state"
        m, twin, _ = self._against_train_step(with_bn=True)
        after = _flat(m._state.bn_state)
        assert any(not torch.equal(before[k], after[k]) for k in before)
        for k, v in _flat(twin.bn_state).items():
            assert torch.equal(after[k], v)

    def test_dropout_masks_are_the_steps(self, port):
        m, _, rng0 = self._against_train_step(with_dropout=True)
        assert int(m._state.step) == 1
        assert torch.equal(m._state.rng, rng0)  # the key is never split

    def test_core_optimizer_passthrough(self, port):
        import dlrm_flexflow_tpu_torch as ffcore
        import flexflow.core as fc
        ffconfig = fc.FFConfig()
        ffconfig.parse_args(["-b", "16"])
        ffmodel = fc.FFModel(ffconfig)
        inp = ffmodel.create_tensor([16, 8], fc.DataType.DT_FLOAT)
        ffmodel.dense(inp, 1)
        core_adam = ffcore.AdamOptimizer(lr=0.007)
        ffmodel.compile(optimizer=core_adam,
                        loss_type=fc.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                        metrics=[])
        assert ffmodel._core.optimizer is core_adam


def test_train_fast_path_step_and_stdout_parity(port, capsys):
    """train() through fit's staged branch runs exactly nb * epochs
    updates (no warmup step) and prints only 'epoch N:' lines; epochs=0
    does nothing."""
    m, loaders, _, _ = _threading_model()
    fc = sys.modules["flexflow.core"]
    full = m.create_tensor([64, 8], fc.DataType.DT_FLOAT)
    full_y = m.create_tensor([64, 1], fc.DataType.DT_FLOAT)
    rng = np.random.default_rng(0)
    full.attach_numpy_array(None, rng.standard_normal((64, 8)).astype(
        np.float32))
    full_y.attach_numpy_array(None, rng.standard_normal((64, 1)).astype(
        np.float32))
    dx = fc.SingleDataLoader(m, m.get_layers()[0].get_input_tensor(), full,
                             64, fc.DataType.DT_FLOAT)
    dy = fc.SingleDataLoader(m, m.get_label_tensor(), full_y, 64,
                             fc.DataType.DT_FLOAT)
    m.train([dx, dy], epochs=2)
    out = capsys.readouterr().out
    assert "THROUGHPUT" not in out
    assert [ln.split(":")[0] for ln in out.splitlines()] == ["epoch 0",
                                                            "epoch 1"]
    assert m._core._last_fit_used_scan
    assert int(m._state.step) == 2 * (64 // 16)
    m.train([dx, dy], epochs=0)
    assert int(m._state.step) == 2 * (64 // 16)
    assert capsys.readouterr().out == ""


# ------------------------------------------------------- the example matrix
SCRIPTS = [
    "keras/seq_mnist_mlp.py", "keras/seq_mnist_cnn.py",
    "keras/seq_reuters_mlp.py", "keras/seq_cifar10_cnn.py",
    "keras/seq_mnist_mlp_net2net.py", "keras/seq_mnist_cnn_nested.py",
    "keras/callback.py", "keras/unary.py", "keras/reshape.py",
    "keras/func_mnist_mlp.py", "keras/func_mnist_mlp_concat.py",
    "keras/func_mnist_cnn.py", "keras/func_cifar10_cnn.py",
    "keras/func_cifar10_cnn_nested.py", "keras/func_mnist_mlp_net2net.py",
    "keras/func_cifar10_alexnet.py",
    "keras/func_cifar10_cnn_concat_seq_model.py",
    "native/mnist_mlp.py", "native/mnist_cnn.py", "native/cifar10_cnn.py",
    "native/print_layers.py", "native/split.py", "native/tensor_attach.py",
    "pytorch/mnist_mlp.py",
]


def _run_example(rel, monkeypatch):
    monkeypatch.setenv("FF_EXAMPLE_SAMPLES", "128")
    monkeypatch.setenv("FF_EXAMPLE_EPOCHS", "1")
    return run_script(os.path.join(EXAMPLES, rel), device="cpu")


def test_example_matrix_is_whole():
    """SCRIPTS holds every runnable script of examples/compat (all but
    the keras accuracy helper and the onnx one, tested below)."""
    found = sorted(os.path.relpath(os.path.join(d, f), EXAMPLES)
                   for d, _, fs in os.walk(EXAMPLES) for f in fs
                   if f.endswith(".py"))
    assert found == sorted(SCRIPTS + ["keras/accuracy.py",
                                      "onnx/mnist_mlp.py"])


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_the_port(script, monkeypatch):
    before = {k: v for k, v in sys.modules.items()
              if k == "flexflow" or k.startswith("flexflow.")}
    _run_example(script, monkeypatch)
    after = {k: v for k, v in sys.modules.items()
             if k == "flexflow" or k.startswith("flexflow.")}
    assert after == before  # the alias left with the script


def test_onnx_example_runs_on_the_port(monkeypatch):
    pytest.importorskip("onnx")
    _run_example("onnx/mnist_mlp.py", monkeypatch)


# --------------------------------------------------- scoping and the entry
def test_alias_scoping():
    with use_port_flexflow(device="cpu"):
        import flexflow.core as inner
        with use_port_flexflow(device="cpu"):
            import flexflow.keras.datasets.mnist as m1
        import flexflow.keras.datasets.mnist as m2
    import flexflow.core as outer
    assert inner is pc
    assert m1 is m2 and m1.__name__.startswith("dlrm_flexflow_tpu_torch.")
    assert outer is jc and outer.__file__.startswith(
        os.path.join(ROOT, "flexflow"))
    assert sys.modules.get("flexflow.keras.datasets.mnist") is not m1


def test_module_entry(capsys):
    from dlrm_flexflow_tpu_torch.flexflow.__main__ import main
    script = os.path.join(EXAMPLES, "native", "tensor_attach.py")
    assert main(["--device", "cpu", script]) == 0
    assert "zero-copy tensor attach OK" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # no card and no --device cpu: refused before the script runs
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([script])
        assert capsys.readouterr().out == ""


def test_default_device_is_the_card():
    """Outside any scope and without --device the weights go to the
    card; without one init_layers raises (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    m, _, _, _ = _build(pc, "mlp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_layers()


FORBIDDEN = {"jax", "jaxlib", "flexflow", "dlrm_flexflow_tpu"}


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_flexflow_imports_nothing_of_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT_DIR)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) >= 24
    for path in files:
        bad = FORBIDDEN & set(_imported_tops(path))
        assert not bad, (path, bad)
