"""The port's frontends (dlrm_flexflow_tpu_torch/frontends) against the
JAX package's on the CPU: keras Sequential and functional models, nested
models, layer reuse and rebinding, net2net weight transfer, summaries,
``fit``/``evaluate``/``predict`` on weights carried across with
``bridge``; ``keras_utils`` and ``keras_datasets`` output for output;
``torch_fx.PyTorchModel`` against the torch module and against the JAX
package's conversion; the ONNX importer gated on ``onnx`` and its
handlers without it.  JAX is imported here only.

Tolerances, each with its reason:
  * graphs (op names, types, shapes), utilities, datasets, error
    messages, weights read back: exact (no arithmetic, or the same
    numpy code);
  * forwards and losses on the same weights: rtol 1e-5 / atol 1e-6
    (the port's products accumulate in f64, XLA's in f32), against a
    torch module the JAX test's own atol 1e-5 (MLP) and 1e-4 (CNN);
  * weights after training steps: rtol 1e-4 / atol 1e-6, the training
    slice's tolerance.
"""

import gc
import importlib
import subprocess
import sys
import tarfile
import types
import weakref

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.frontends import keras as JK
from dlrm_flexflow_tpu.frontends import keras_datasets as jdatasets
from dlrm_flexflow_tpu.frontends import keras_utils as jutils
from dlrm_flexflow_tpu.frontends import onnx_model as jonnx
from dlrm_flexflow_tpu.frontends.torch_fx import PyTorchModel as JaxPTModel

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.bridge import state_from_jax
from dlrm_flexflow_tpu_torch.frontends import keras as PK
from dlrm_flexflow_tpu_torch.frontends import keras_datasets as pdatasets
from dlrm_flexflow_tpu_torch.frontends import keras_utils as putils
from dlrm_flexflow_tpu_torch.frontends import onnx_model as ponnx
from dlrm_flexflow_tpu_torch.frontends.torch_fx import PyTorchModel

TOL = dict(rtol=1e-5, atol=1e-6)
W_TOL = dict(rtol=1e-4, atol=1e-6)


def _graph(model):
    """(name, op_type, output shapes) of every op of an FFModel."""
    return [(op.name, op.op_type, [tuple(t.shape) for t in op.outputs])
            for op in model.layers]


def _carry(jm, pm):
    """The port keras model's state set to the JAX one's (weights,
    optimizer and batch-norm state, key and step) through ``bridge``."""
    pm.state = state_from_jax(jm.state)


def _compile_pair(build, optimizer, loss, metrics, batch_size):
    """The same keras model built through both frontends and compiled;
    the port's weights carried from JAX's."""
    jm, pm = build(JK), build(PK)
    jm.compile(optimizer, loss, metrics, batch_size)
    pm.compile(optimizer, loss, metrics, batch_size, device="cpu")
    assert _graph(pm.ffmodel) == _graph(jm.ffmodel)
    _carry(jm, pm)
    return jm, pm


def _assert_state_close(pm, jm, **tol):
    for op, params in jm.state.params.items():
        for k, v in params.items():
            np.testing.assert_allclose(pm.state.params[op][k].numpy(),
                                       np.asarray(v), err_msg=f"{op}/{k}",
                                       **tol)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------- keras models
def _seq_mlp(K):
    return K.Sequential([K.Input((20,)), K.Dense(32, activation="relu"),
                         K.Dense(4), K.Activation("softmax")])


def _seq_cnn(K):
    return K.Sequential([
        K.Input((3, 16, 16)),
        K.Conv2D(8, 3, padding="same", activation="relu"),
        K.MaxPooling2D(),
        K.BatchNormalization(),
        K.Conv2D(4, (3, 3), strides=(1, 1), padding="valid"),
        K.AveragePooling2D(pool_size=2),
        K.Flatten(),
        K.Dense(10),
        K.Activation("softmax")])


def _func_two_inputs(K):
    a = K.InputTensor((8,), name="a")
    b = K.InputTensor((4,), name="b")
    ha = K.Dense(16, activation="relu")(a)
    hb = K.Dense(16, activation="tanh")(b)
    merged = K.Concatenate(axis=1)(ha, hb)
    return K.Model(inputs=[a, b], outputs=K.Dense(1)(merged))


def _func_residual(K):
    x = K.InputTensor((16,), name="x")
    h = K.Dense(16, activation="relu")(x)
    s = K.Add()(x, h)
    d = K.Subtract()(s, K.Dense(16)(x))
    m = K.Multiply()(d, K.Activation("sigmoid")(h))
    r = K.Reshape((4, 4))(m)
    return K.Model(inputs=x, outputs=K.Dense(2)(K.Flatten()(r)))


def _func_embedding(K):
    ids = K.InputTensor((5,), dtype="int32", name="ids")
    e = K.Embedding(50, 6)(ids)
    return K.Model(ids, K.Dense(3)(K.Flatten()(e)))


def _nested_functional(K):
    in1 = K.Input(shape=(8,))()
    model1 = K.Model(in1, K.Dense(16, activation="relu")(in1))
    in2 = K.Input(shape=(16,))()
    model2 = K.Model(in2, K.Activation("softmax")(K.Dense(4)(in2)))
    in3 = K.Input(shape=(8,))()
    return K.Model(in3, model2(model1(in3)))


def _sequential_of_models(K):
    model1 = K.Sequential([K.Dense(16, activation="relu", input_shape=(8,))])
    in2 = K.Input(shape=(16,))()
    model2 = K.Model(in2, K.Activation("softmax")(K.Dense(4)(in2)))
    model = K.Sequential()
    model.add(model1)
    model.add(model2)
    return model


def _concat_of_sequentials(K):
    m1 = K.Sequential([K.Dense(8, activation="relu", input_shape=(8,))])
    m2 = K.Sequential([K.Dense(8, activation="relu", input_shape=(8,))])
    merged = K.Concatenate(axis=1)([m1.output, m2.output])
    out = K.Activation("softmax")(K.Dense(4)(merged))
    return K.Model([m1.input[0], m2.input[0]], out)


def _class_labels(n, classes, seed=1):
    return np.random.default_rng(seed).integers(
        0, classes, size=(n, 1)).astype(np.int32)


KERAS_CASES = {
    # name: (build, optimizer, loss, inputs of n samples, labels)
    "seq_mlp": (_seq_mlp, "adam", "sparse_categorical_crossentropy",
                lambda n: _x((n, 20)), lambda n: _class_labels(n, 4)),
    "seq_cnn": (_seq_cnn, "sgd", "sparse_categorical_crossentropy",
                lambda n: _x((n, 3, 16, 16)), lambda n: _class_labels(n, 10)),
    "func_two_inputs": (_func_two_inputs, "adam", "mse",
                        lambda n: [_x((n, 8)), _x((n, 4), 2)],
                        lambda n: _x((n, 1), 3)),
    "func_residual": (_func_residual, "sgd", "mean_squared_error",
                      lambda n: _x((n, 16)), lambda n: _x((n, 2), 3)),
    "func_embedding": (_func_embedding, "sgd", "mse",
                       lambda n: np.random.default_rng(4).integers(
                           0, 50, size=(n, 5)).astype(np.int32),
                       lambda n: _x((n, 3), 3)),
    "nested_functional": (_nested_functional, "sgd",
                          "sparse_categorical_crossentropy",
                          lambda n: _x((n, 8)), lambda n: _class_labels(n, 4)),
    "sequential_of_models": (_sequential_of_models, "sgd",
                             "sparse_categorical_crossentropy",
                             lambda n: _x((n, 8)),
                             lambda n: _class_labels(n, 4)),
    "concat_of_sequentials": (_concat_of_sequentials, "sgd",
                              "sparse_categorical_crossentropy",
                              lambda n: [_x((n, 8)), _x((n, 8), 5)],
                              lambda n: _class_labels(n, 4)),
}


#: the cases whose keras ``fit`` and ``evaluate`` are held to JAX's too:
#: one per optimizer, and the one with batch-norm statistics
FIT_CASES = ("seq_mlp", "seq_cnn", "sequential_of_models")


@pytest.mark.parametrize("case", sorted(KERAS_CASES))
def test_keras_model_matches_jax(case):
    """The same graph (op names, types and shapes) and summary; on the
    JAX model's weights the same predictions, three steps' losses and
    weights; then one epoch of keras ``fit`` and ``evaluate`` (held to
    JAX's in ``FIT_CASES``)."""
    build, opt, loss, xs, ys = KERAS_CASES[case]
    batch = 8
    jm, pm = _compile_pair(build, opt, loss, ("accuracy",), batch)
    assert pm.summary() == jm.summary()
    np.testing.assert_allclose(pm.predict(xs(batch)), jm.predict(xs(batch)),
                               **TOL)
    x, y = xs(3 * batch), ys(3 * batch)
    xd, jd = pm._as_input_dict(x), jm._as_input_dict(x)
    for i in range(3):
        sl = slice(i * batch, (i + 1) * batch)
        jm.state, jmets = jm.ffmodel.train_step(
            jm.state, {k: v[sl] for k, v in jd.items()}, y[sl])
        pm.state, pmets = pm.ffmodel.train_step(
            pm.state, {k: v[sl] for k, v in xd.items()}, y[sl])
        np.testing.assert_allclose(float(pmets["loss"]),
                                   float(jmets["loss"]), **TOL)
    _assert_state_close(pm, jm, **W_TOL)
    _carry(jm, pm)
    assert pm.fit(x, y, epochs=1, verbose=False) > 0
    if case not in FIT_CASES:  # the loops are the same code for all
        assert np.isfinite(pm.evaluate(x, y))
        return
    jm.fit(x, y, epochs=1, verbose=False)
    _assert_state_close(pm, jm, **W_TOL)
    np.testing.assert_allclose(pm.evaluate(x, y), jm.evaluate(x, y), **W_TOL)


def test_dropout_layer_lowers_and_predicts_as_jax():
    """Dropout lowers to the same op; predictions (no dropout) agree.
    Training masks are drawn differently by the two packages, so no
    training step is compared."""
    def build(K):
        return K.Sequential([K.Input((20,)), K.Dense(32, activation="relu"),
                             K.Dropout(0.1), K.Dense(4),
                             K.Activation("softmax")])
    jm, pm = _compile_pair(build, "adam", "sparse_categorical_crossentropy",
                           ("accuracy",), 16)
    x = _x((16, 20))
    got = pm.predict(x)
    np.testing.assert_allclose(got, jm.predict(x), **TOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    pm.fit(_x((64, 20)), _class_labels(64, 4), epochs=1, verbose=False)
    assert np.isfinite(pm.evaluate(_x((64, 20)), _class_labels(64, 4)))


def test_keras_fit_drives_callbacks_on_the_keras_model():
    """``fit`` hands callbacks the keras-level model, and a
    LearningRateScheduler changes the held state's rate as in JAX."""
    seen = {}

    class Spy(PK.callbacks.Callback):
        def on_train_begin(self, logs=None):
            seen["model"] = self.model

    rates = {}
    for K in (JK, PK):
        m = K.Sequential([K.Input((8,)), K.Dense(4)])
        kw = {"device": "cpu"} if K is PK else {}
        m.compile("sgd", "mse", (), 16, **kw)
        cbs = [K.callbacks.LearningRateScheduler(lambda e: 0.5 / (e + 1))]
        if K is PK:
            cbs.append(Spy())
        m.fit(_x((64, 8)), _x((64, 4), 1), epochs=2, verbose=False,
              callbacks=cbs)
        rates[K] = float(m.state.opt_state["lr"])
        if K is PK:
            assert seen["model"] is m
    assert rates[PK] == pytest.approx(rates[JK]) == pytest.approx(0.25)


# ------------------------------------------------ net2net and rebinding
def _teacher(K, **kw):
    return K.Sequential([
        K.Dense(16, activation="relu", input_shape=(8,), name="d1"),
        K.Dense(16, activation="relu", name="d2"),
        K.Dense(4, name="d3"),
        K.Activation("softmax")])


def test_net2net_weight_transfer_matches_jax():
    """JAX's ``test_layer_weight_transfer_between_models``: a teacher
    trained one epoch from the same weights in both packages; its layers'
    weights read by index and name, set on a student in both the
    reference and the keras forms; the student predicts as the teacher
    and as JAX's student."""
    x, y = _x((64, 8)), _class_labels(64, 4)
    jt, pt = _compile_pair(_teacher, "sgd", "sparse_categorical_crossentropy",
                           ("accuracy",), 16)
    jt.fit(x, y, epochs=1, verbose=False)
    pt.fit(x, y, epochs=1, verbose=False)
    students = {}
    for K, t in ((JK, jt), (PK, pt)):
        ws = [t.get_layer(index=0).get_weights(t.ffmodel),
              t.get_layer(index=1).get_weights(t.ffmodel),
              t.get_layer(name="d3").get_weights(t.ffmodel)]
        assert ws[0][0].shape == (8, 16) and ws[0][1].shape == (16,)
        layers = [K.Dense(16, activation="relu", input_shape=(8,),
                          name="s1"),
                  K.Dense(16, activation="relu", name="s2"),
                  K.Dense(4, name="s3"), K.Activation("softmax")]
        s = K.Sequential(layers)
        kw = {"device": "cpu"} if K is PK else {}
        s.compile("sgd", "sparse_categorical_crossentropy", ("accuracy",),
                  16, **kw)
        layers[0].set_weights(s.ffmodel, *ws[0])
        layers[1].set_weights(s.ffmodel, list(ws[1]))  # the keras form
        layers[2].set_weights(s.ffmodel, *ws[2])
        np.testing.assert_allclose(s.predict(x[:16]), t.predict(x[:16]),
                                   rtol=1e-5, atol=1e-5)
        students[K] = s
    np.testing.assert_allclose(students[PK].predict(x[:16]),
                               students[JK].predict(x[:16]), **W_TOL)


def _errors(fn):
    """The exception each package raises for ``fn(K)``: (type, text)."""
    out = []
    for K in (JK, PK):
        with pytest.raises(Exception) as e:
            fn(K)
        out.append((type(e.value), str(e.value)))
    return out


def _compiled(K, model, batch=8, loss="mean_squared_error"):
    kw = {"device": "cpu"} if K is PK else {}
    model.compile("sgd", loss, (), batch, **kw)
    return model


def _weighted_reuse(K):
    shared = K.Dense(4)
    a, b = K.Input(shape=(8,))(), K.Input(shape=(8,))()
    _compiled(K, K.Model([a, b], K.Concatenate(axis=1)([shared(a),
                                                        shared(b)])))


def _set_weights_missing_bias(K):
    m = _compiled(K, K.Sequential([K.Dense(4, input_shape=(8,), name="d")]))
    m.get_layer(index=0).set_weights(np.zeros((8, 4)))


def _set_weights_bad_shape(K):
    m = _compiled(K, K.Sequential([K.Dense(4, input_shape=(8,), name="d")]))
    m.get_layer(index=0).set_weights(np.zeros((8, 5)), np.zeros(4))


def _unbuilt_layer(K):
    K.Dense(4).get_weights()


def _wrong_model(K):
    da = K.Dense(4, input_shape=(8,), name="da")
    _compiled(K, K.Sequential([da]))
    b = _compiled(K, K.Sequential([K.Dense(4, input_shape=(8,))]))
    da.get_weights(b.ffmodel)


def _nested_sequential_two_inputs(K):
    m1 = K.Sequential([K.Dense(4, input_shape=(8,))])
    a, b = K.Input(shape=(8,))(), K.Input(shape=(8,))()
    _compiled(K, K.Model([a, b], m1(a, b)))


def _unknown_layer_name(K):
    _compiled(K, K.Sequential([K.Dense(4, input_shape=(8,))])).get_layer(
        name="nope")


@pytest.mark.parametrize("fn", [_weighted_reuse, _set_weights_missing_bias,
                                _set_weights_bad_shape, _unbuilt_layer,
                                _wrong_model, _nested_sequential_two_inputs,
                                _unknown_layer_name],
                         ids=lambda f: f.__name__.strip("_"))
def test_keras_errors_match_jax(fn):
    (jt, jmsg), (pt, pmsg) = _errors(fn)
    assert pt is jt and pmsg == jmsg


def test_stateless_layer_reuse_is_allowed():
    relu = PK.Activation("relu")
    m = _compiled(PK, PK.Sequential([PK.Dense(16, input_shape=(8,)), relu,
                                     PK.Dense(4), relu]), batch=16)
    m.fit(_x((64, 8)), np.zeros((64, 4), np.float32), epochs=1,
          verbose=False)
    assert [op.op_type for op in m.ffmodel.layers].count("ElementUnary") == 2


def _fit(m, x, y, epochs=1):
    m.fit(x, y, epochs=epochs, verbose=False)
    return m


def test_composition_adopts_trained_weights_as_jax():
    """JAX's rebinding cases, each run through both packages from the
    same starting weights: a composed model adopts its teacher's trained
    weights (``model(x)`` nesting, doubly nested, symbolic ``m.output``
    composition) and a recompiled, retrained source wins over a stale
    composition."""
    x = _x((64, 8))
    got = {}
    for K in (JK, PK):
        # model(x) nesting
        t = _compiled(K, K.Sequential([
            K.Dense(16, activation="relu", input_shape=(8,), name="t1"),
            K.Dense(4, name="t2")]), batch=16)
        if K is PK:
            t.state = got[JK, "t0"]
        else:
            got[JK, "t0"] = state_from_jax(t.state)
        _fit(t, x, np.zeros((64, 4), np.float32))
        k_trained, _ = t.get_layer(index=0).get_weights()
        head = K.Input(shape=(8,))()
        c = _compiled(K, K.Model(head, t(head)), batch=16)
        k_after, _ = t.get_layer(index=0).get_weights(t.ffmodel)
        np.testing.assert_array_equal(k_after, k_trained)
        np.testing.assert_allclose(c.predict(x[:16]), t.predict(x[:16]),
                                   rtol=1e-5, atol=1e-5)
        got[K, "t"], got[K, "composed"] = t, c.predict(x[:16])
        # doubly nested: top adopts mid's training, not inner's stale W0
        d = K.Dense(16, activation="relu", input_shape=(8,), name="deep")
        inner = _compiled(K, K.Sequential([d]), batch=16)
        k0, _ = d.get_weights(inner.ffmodel)
        mid = K.Sequential()
        mid.add(inner)
        mid.add(K.Dense(4, name="mid_head"))
        _fit(_compiled(K, mid, batch=16), x, np.zeros((64, 4), np.float32))
        k_mid, _ = d.get_weights(mid.ffmodel)
        assert not np.allclose(k0, k_mid)
        top = K.Sequential()
        top.add(mid)
        top.add(K.Dense(2, name="top_head"))
        _compiled(K, top, batch=16)
        np.testing.assert_array_equal(d.get_weights(top.ffmodel)[0], k_mid)
        # symbolic composition, then a recompiled and retrained source
        m1 = _compiled(K, K.Sequential([K.Dense(8, activation="relu",
                                                input_shape=(8,),
                                                name="m1d")]), batch=16)
        _fit(m1, x, np.zeros((64, 8), np.float32))
        k1, _ = m1.get_layer(index=0).get_weights(m1.ffmodel)
        m2 = K.Sequential([K.Dense(8, activation="relu", input_shape=(8,))])
        merged = K.Concatenate(axis=1)([m1.output, m2.output])
        comp = _compiled(K, K.Model([m1.input[0], m2.input[0]],
                                    K.Dense(4)(merged)), batch=16)
        np.testing.assert_array_equal(
            m1.get_layer(index=0).get_weights(comp.ffmodel)[0], k1)
        _compiled(K, m1, batch=16)
        _fit(m1, x, np.ones((64, 8), np.float32), epochs=2)
        k_fresh, _ = m1.get_layer(index=0).get_weights(m1.ffmodel)
        h2 = K.Input(shape=(8,))()
        c2 = _compiled(K, K.Model(h2, m1(h2)), batch=16)
        np.testing.assert_array_equal(
            m1.get_layer(index=0).get_weights(c2.ffmodel)[0], k_fresh)
    np.testing.assert_allclose(got[PK, "composed"], got[JK, "composed"],
                               **W_TOL)


def test_discarded_models_are_not_pinned():
    teacher = _compiled(PK, PK.Sequential([PK.Dense(4, input_shape=(8,),
                                                    name="wd")]))
    head = PK.Input(shape=(8,))()
    composed = _compiled(PK, PK.Model(head, teacher(head)))
    ref = weakref.ref(composed)
    del composed, head
    gc.collect()
    assert ref() is None


def test_nested_weights_live_in_the_outer_state():
    d_inner = PK.Dense(16, activation="relu", input_shape=(8,), name="inner")
    model = PK.Sequential()
    model.add(PK.Sequential([d_inner]))
    model.add(PK.Dense(4, name="head"))
    assert "not compiled" in model.summary()
    _compiled(PK, model, batch=16)
    k_before, _ = d_inner.get_weights()
    _fit(model, _x((64, 8)), _x((64, 4), 1))
    k_after, _ = d_inner.get_weights()
    assert not np.allclose(k_before, k_after)


def test_keras_compile_places_on_the_card_by_default():
    m = PK.Sequential([PK.Input((8,)), PK.Dense(4)])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    with pytest.raises(RuntimeError):
        m.compile("sgd", "mse", (), 8)


def test_module_aliases_match_jax():
    assert PK.callbacks.__name__.endswith("frontends.keras_callbacks")
    assert PK.datasets is pdatasets and PK.utils is putils
    assert PK.preprocessing.sequence.pad_sequences is putils.pad_sequences
    assert PK.preprocessing.text.Tokenizer is putils.Tokenizer
    for name in ("mnist", "cifar10", "reuters"):
        mod = getattr(pdatasets, name)
        assert sys.modules[mod.__name__] is mod
        assert sorted(n for n in vars(mod) if not n.startswith("_")) == \
            sorted(n for n in vars(getattr(jdatasets, name))
                   if not n.startswith("_"))


# ------------------------------------------------------ keras_utils
UTIL_CALLS = {
    "to_categorical": lambda u: u.to_categorical([0, 2, 1, 2], 3),
    "to_categorical_infers": lambda u: u.to_categorical([1, 3], dtype="int8"),
    "normalize": lambda u: u.normalize(np.array([[3.0, 4.0], [0.0, 0.0]])),
    "normalize_l1_axis0": lambda u: u.normalize(
        np.arange(6.0).reshape(2, 3), axis=0, order=1),
    "pad_pre": lambda u: u.pad_sequences([[1, 2], [3], []], maxlen=3),
    "pad_post": lambda u: u.pad_sequences([[1, 2], [3]], maxlen=3,
                                          padding="post", value=-1),
    "truncate_post": lambda u: u.pad_sequences([[1, 2, 3, 4]], maxlen=2,
                                               truncating="post"),
    "tokenizer": lambda u: _tokenize(u),
    "small_utils": lambda u: (u.to_list(3), u.unpack_singleton([7]),
                              u.is_all_none([None, None]),
                              [list(a) for a in u.slice_arrays(
                                  [np.arange(10), np.arange(10) * 2], 2, 5)]),
    "serialize": lambda u: u.serialize_keras_object(_Cfg(3)),
}


class _Cfg:
    def __init__(self, x=0):
        self.x = x

    def get_config(self):
        return {"x": self.x}


def _tokenize(u):
    tok = u.Tokenizer(num_words=6)
    tok.fit_on_texts(["the cat sat", "The dog sat on the mat"])
    seqs = tok.texts_to_sequences(["the cat on the mat"])
    return (tok.word_index, seqs,
            tok.sequences_to_matrix([[1, 2, 2], [4]], mode="binary"),
            tok.sequences_to_matrix([[1, 2, 2], [4]], mode="count"))


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("call", sorted(UTIL_CALLS))
def test_keras_utils_outputs_equal_jax(call):
    _same(UTIL_CALLS[call](putils), UTIL_CALLS[call](jutils))


def test_keras_utils_names_and_enqueuers_match_jax():
    public = lambda m: sorted(n for n in vars(m)  # noqa: E731
                              if not n.startswith("_"))
    assert public(putils) == public(jutils)

    class Seq(putils.Sequence):
        def __getitem__(self, i):
            return np.full((2,), i)

        def __len__(self):
            return 4

    enq = putils.OrderedEnqueuer(Seq())
    enq.start(max_queue_size=2)
    gen = enq.get()
    got = [int(next(gen)[0]) for _ in range(8)]
    enq.stop()
    assert got == [0, 1, 2, 3, 0, 1, 2, 3]
    genq = putils.GeneratorEnqueuer(iter(range(5)))
    genq.start()
    assert list(genq.get()) == [0, 1, 2, 3, 4]
    genq.stop()
    f = putils.func_load(putils.func_dump(lambda x, y=2: x * y))
    assert f(3) == 6 and f(3, 4) == 12
    with putils.custom_object_scope({"C": _Cfg}):
        obj = putils.deserialize_keras_object(
            {"class_name": "C", "config": {"x": 5}})
    assert isinstance(obj, _Cfg) and obj.x == 5


def test_get_file_matches_jax(tmp_path):
    """A cached archive extracts in place; a missing file raises the
    same FileNotFoundError in both packages, and nothing is fetched."""
    cache = tmp_path / ".keras" / "datasets"
    cache.mkdir(parents=True)
    inner = tmp_path / "payload.txt"
    inner.write_text("hello")
    with tarfile.open(cache / "arch.tar.gz", "w:gz") as t:
        t.add(inner, arcname="payload.txt")
    out = putils.get_file("arch", untar=True,
                          cache_dir=str(tmp_path / ".keras"))
    assert out == str(cache / "arch")
    assert (cache / "payload.txt").read_text() == "hello"
    errs = []
    for u in (jutils, putils):
        with pytest.raises(FileNotFoundError) as e:
            u.get_file("absent.npz", origin="https://example.invalid/a",
                       cache_dir=str(tmp_path / ".keras"))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_hdf5matrix_reads_as_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    p = str(tmp_path / "d.h5")
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    with h5py.File(p, "w") as f:
        f.create_dataset("x", data=data)
    pm, jm = putils.HDF5Matrix(p, "x", 2, 8), jutils.HDF5Matrix(p, "x", 2, 8)
    assert pm.shape == jm.shape == (6, 4) and pm.dtype == jm.dtype
    for key in (0, slice(0, 3), np.array([3, 1, 1, 0]), slice(4, None)):
        np.testing.assert_array_equal(pm[key], jm[key])
    for key in (7, np.array([0, 6])):
        with pytest.raises(IndexError):
            pm[key]


@pytest.fixture
def no_keras_cache(tmp_path, monkeypatch):
    """Both dataset modules read an empty cache: the synthetic data."""
    monkeypatch.setattr(jdatasets, "_CACHE", str(tmp_path))
    monkeypatch.setattr(pdatasets, "_CACHE", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("name,kw", [("mnist", {}),
                                     ("cifar10", {"num_samples": 20000}),
                                     ("reuters", {"num_words": 1000,
                                                  "maxlen": 150})])
def test_datasets_equal_jax(name, kw, no_keras_cache, capsys):
    """The same call gives the same arrays (values, dtypes, shapes)."""
    got = getattr(pdatasets, name).load_data(**kw)
    want = getattr(jdatasets, name).load_data(**kw)
    assert "synthetic" in capsys.readouterr().out
    for (pa, pb), (ja, jb) in zip(got, want):
        for p, j in ((pa, ja), (pb, jb)):
            assert p.dtype == j.dtype and p.shape == j.shape
            if p.dtype == object:
                assert all(list(a) == list(b) for a, b in zip(p, j))
            else:
                np.testing.assert_array_equal(p, j)
    if name == "reuters":
        assert pdatasets.reuters.get_word_index() == \
            jdatasets.reuters.get_word_index()


def test_datasets_read_a_local_cache_as_jax(no_keras_cache):
    rng = np.random.default_rng(7)
    arrays = {k: rng.integers(0, 255, size=s, dtype=np.uint8)
              for k, s in (("x_train", (5, 28, 28)), ("y_train", (5,)),
                           ("x_test", (2, 28, 28)), ("y_test", (2,)))}
    np.savez(no_keras_cache / "mnist.npz", **arrays)
    got = pdatasets.mnist.load_data()
    want = jdatasets.mnist.load_data()
    for (pa, pb), (ja, jb) in zip(got, want):
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(got[0][0], arrays["x_train"])


# ------------------------------------------------------------ torch.fx
class TorchMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(12, 24)
        self.fc2 = nn.Linear(24, 3)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class TorchCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.pool = nn.MaxPool2d(2)
        self.avg = nn.AvgPool2d(2, stride=2)
        self.flat = nn.Flatten()
        self.fc = nn.Linear(8 * 4 * 4, 5)

    def forward(self, x):
        h = self.pool(torch.relu(self.bn(self.conv(x))))
        return self.fc(self.flat(self.avg(h)))


class TorchOps(nn.Module):
    """The functions and modules the importer lowers besides the above."""

    def __init__(self):
        super().__init__()
        self.a = nn.Linear(6, 6)
        self.b = nn.Linear(6, 6, bias=False)
        self.act = nn.GELU(approximate="tanh")  # the lowering's gelu
        self.sig = nn.Sigmoid()
        self.tanh = nn.Tanh()
        self.drop = nn.Dropout(0.0)
        self.id = nn.Identity()
        self.head = nn.Linear(12, 4)
        self.soft = nn.Softmax(dim=-1)

    def forward(self, x):
        a, b = self.act(self.a(x)), self.tanh(self.b(x))
        s = torch.sigmoid(a + b) * (a - b) / (self.sig(b) + torch.sigmoid(a))
        h = torch.cat([self.id(s), torch.tanh(a)], dim=1)
        return self.soft(self.head(self.drop(h)))


class TorchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(30, 4)
        self.fc = nn.Linear(20, 2)

    def forward(self, ids):
        return self.fc(torch.flatten(self.emb(ids), 1))


FX_CASES = {
    # name: (module, per-sample input shapes, dtypes, batch, input, tol)
    "mlp": (TorchMLP, {"x": (12,)}, None, 8, lambda: _x((8, 12)), 1e-5),
    "cnn": (TorchCNN, {"x": (3, 16, 16)}, None, 4,
            lambda: _x((4, 3, 16, 16), 1), 1e-4),
    "ops": (TorchOps, {"x": (6,)}, None, 8, lambda: _x((8, 6), 2), 1e-5),
    "embedding": (TorchEmbed, {"ids": (5,)}, {"ids": "int32"}, 8,
                  lambda: np.random.default_rng(3).integers(
                      0, 30, size=(8, 5)).astype(np.int32), 1e-5),
}


def _fx_pair(case, optimizer_lr=None):
    cls, shapes, dtypes, batch, _, _ = FX_CASES[case]
    torch.manual_seed(0)
    module = cls().eval()
    out = {}
    for conv_cls, pkg in ((JaxPTModel, ffj), (PyTorchModel, fft)):
        conv = conv_cls(module)
        model = conv.apply(pkg.FFConfig(batch_size=batch), shapes, dtypes)
        kw = {"mesh": False} if pkg is ffj else {}
        opt = pkg.SGDOptimizer(optimizer_lr) if optimizer_lr else None
        model.compile(optimizer=opt, loss_type="mean_squared_error",
                      metrics=(), **kw)
        init = {} if pkg is ffj else {"device": "cpu"}
        state = conv.import_weights(model, model.init(seed=0, **init))
        out[pkg] = (conv, model, state)
    return module, out


@pytest.mark.parametrize("case", sorted(FX_CASES))
def test_torch_fx_matches_the_module_and_jax(case):
    """The same graph as the JAX package's conversion; on the module's
    weights the forward equals the torch module's (the JAX test's
    tolerance) and the JAX conversion's."""
    module, out = _fx_pair(case)
    (_, jmodel, jstate), (_, pmodel, pstate) = out[ffj], out[fft]
    assert _graph(pmodel) == _graph(jmodel)
    x = FX_CASES[case][4]()
    name = next(iter(FX_CASES[case][1]))
    got = pmodel.forward(pstate, {name: x}).numpy()
    with torch.no_grad():
        ref = module(torch.from_numpy(x).long() if x.dtype == np.int32
                     else torch.from_numpy(x)).numpy()
    tol = FX_CASES[case][5]
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, np.asarray(jmodel.forward(
        jstate, {name: x})), rtol=1e-5, atol=tol / 10)


def test_torch_fx_converted_model_trains_as_jax():
    """Three SGD steps of the converted MLP from the module's weights:
    the losses and weights of the JAX conversion."""
    _, out = _fx_pair("mlp", optimizer_lr=0.01)
    (_, jm, js), (_, pm, ps) = out[ffj], out[fft]
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.standard_normal((8, 12)).astype(np.float32)
        y = rng.standard_normal((8, 3)).astype(np.float32)
        js, jmets = jm.train_step(js, {"x": x}, y)
        ps, pmets = pm.train_step(ps, {"x": x}, y)
        np.testing.assert_allclose(float(pmets["loss"]),
                                   float(jmets["loss"]), **TOL)
    for op, params in js.params.items():
        for k, v in params.items():
            np.testing.assert_allclose(ps.params[op][k].numpy(),
                                       np.asarray(v), **W_TOL)


def test_torch_fx_lower_onto_and_refusals_match_jax():
    """``lower_onto`` replays onto a model with bound inputs, as the
    reference's ``apply(ffmodel, ...)``; unsupported modules and
    functions raise the same NotImplementedError."""
    torch.manual_seed(0)
    module = TorchMLP()
    graphs = []
    for conv_cls, pkg in ((JaxPTModel, ffj), (PyTorchModel, fft)):
        conv = conv_cls(module)
        m = pkg.FFModel(pkg.FFConfig(batch_size=4))
        bound = {"x": m.create_tensor((4, 12), name="x")}
        outs = conv.lower_onto(m, bound)
        assert conv.placeholder_names() == ["x"]
        graphs.append((_graph(m), [tuple(o.shape) for o in outs]))
    assert graphs[0] == graphs[1]

    class Bad(nn.Module):
        def __init__(self):
            super().__init__()
            self.rnn = nn.GRU(4, 4)

        def forward(self, x):
            return self.rnn(x)

    class BadFn(nn.Module):
        def forward(self, x):
            return torch.cumsum(x, 1)

    for bad in (Bad(), BadFn()):
        msgs = []
        for conv_cls, pkg in ((JaxPTModel, ffj), (PyTorchModel, fft)):
            with pytest.raises(NotImplementedError) as e:
                conv_cls(bad).apply(pkg.FFConfig(batch_size=2), {"x": (4,)})
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- ONNX
def test_onnx_model_refuses_without_onnx(monkeypatch):
    """Without the package ``ONNXModel`` raises JAX's ImportError; the
    module itself imports (and names the same handlers)."""
    monkeypatch.setitem(sys.modules, "onnx", None)
    msgs = []
    for mod in (jonnx, ponnx):
        with pytest.raises(ImportError) as e:
            mod.ONNXModel("model.onnx")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    handlers = lambda m: sorted(n for n in vars(m.ONNXModel)  # noqa: E731
                                if n.startswith("handle"))
    assert handlers(ponnx) == handlers(jonnx)


def _node(op_type, inputs, outputs, **attrs):
    """An onnx NodeProto's fields, for graphs that need no initializer."""
    def attr(name, v):
        if isinstance(v, float):
            return types.SimpleNamespace(name=name, f=v)
        if isinstance(v, int):
            return types.SimpleNamespace(name=name, i=v)
        return types.SimpleNamespace(name=name, ints=list(v))
    return types.SimpleNamespace(op_type=op_type, input=inputs,
                                 output=outputs,
                                 attribute=[attr(k, v)
                                            for k, v in attrs.items()])


ONNX_NODES = [
    _node("MaxPool", ["x"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
    _node("AveragePool", ["x"], ["q"], kernel_shape=[2, 2], strides=[2, 2],
          pads=[0, 0]),
    _node("Add", ["p", "q"], ["s"]),
    _node("Mul", ["s", "p"], ["m"]),
    _node("Sub", ["m", "q"], ["d"]),
    _node("BatchNormalization", ["d"], ["bn"]),
    _node("Relu", ["bn"], ["r"]),
    _node("Concat", ["r", "s"], ["c"], axis=1),
    _node("Split", ["c"], ["c0", "c1"], axis=1, split=[3, 3]),
    _node("Sigmoid", ["c0"], ["g"]),
    _node("Tanh", ["c1"], ["t"]),
    _node("Dropout", ["t"], ["dr"], ratio=0.0),
    _node("Add", ["g", "dr"], ["u"]),
    _node("Flatten", ["u"], ["f"]),
    _node("Softmax", ["f"], ["out"]),
]


def test_onnx_handlers_lower_without_onnx_as_jax():
    """A graph of handlers that read no initializer, replayed by
    ``lower_onto`` through both packages: the same ops, and on the same
    input the same output."""
    x = _x((2, 3, 8, 8))
    outs = {}
    for mod, pkg in ((jonnx, ffj), (ponnx, fft)):
        imp = object.__new__(mod.ONNXModel)
        imp.model = types.SimpleNamespace(graph=types.SimpleNamespace(
            node=ONNX_NODES, output=[types.SimpleNamespace(name="out")]))
        imp.initializers = {}
        m = pkg.FFModel(pkg.FFConfig(batch_size=2))
        (out,) = imp.lower_onto(m, {"x": m.create_tensor((2, 3, 8, 8),
                                                         name="x")})
        assert out is m.layers[-1].outputs[0]
        kw = {"mesh": False} if pkg is ffj else {}
        m.compile(loss_type="mean_squared_error", metrics=(), **kw)
        st = m.init(seed=0, **({} if pkg is ffj else {"device": "cpu"}))
        outs[pkg] = (_graph(m), np.asarray(m.forward(st, {"x": x})))
    assert outs[fft][0] == outs[ffj][0]
    np.testing.assert_allclose(outs[fft][1], outs[ffj][1], **TOL)


# ------------------------------------------------------- import hygiene
def test_frontends_import_neither_jax_nor_the_optional_packages():
    """Importing every frontend loads no JAX, no JAX package module, no
    h5py and no onnx (each comes in only when a call needs it)."""
    code = ("import sys\n"
            "import dlrm_flexflow_tpu_torch.frontends.keras\n"
            "import dlrm_flexflow_tpu_torch.frontends.torch_fx\n"
            "import dlrm_flexflow_tpu_torch.frontends.onnx_model\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'dlrm_flexflow_tpu', 'h5py', 'onnx')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=importlib.import_module(
                       "dlrm_flexflow_tpu_torch").__path__[0] + "/..")


def test_get_weights_is_a_snapshot():
    """``FFModel.get_weights`` returns a host copy: the donated step that
    follows updates the parameter in place and leaves the copy as it
    was, as the JAX package's array is (ROADMAP Queue C, C4)."""
    m = _compiled(PK, PK.Sequential([PK.Dense(4, input_shape=(8,),
                                              name="d")]))
    before = m.ffmodel.get_weights(m.state, "d", "kernel")
    kept = before.copy()
    m.state, _ = m.ffmodel.train_step(m.state, {"input": _x((8, 8))},
                                      _x((8, 4), 1))
    np.testing.assert_array_equal(before, kept)
    assert not np.array_equal(
        m.ffmodel.get_weights(m.state, "d", "kernel"), kept)


def test_set_weights_copies_the_callers_values():
    """``set_weights`` and ``load_params`` install copies: training a
    torch.fx conversion leaves the source module's parameters as they
    were, and training a keras layer given numpy arrays (and a model
    loaded from tensors) leaves those arrays and tensors as they were, as
    the JAX package's immutable arrays do (ROADMAP Queue C, C5)."""
    torch.manual_seed(0)
    module = TorchMLP().eval()
    held = {k: v.detach().clone() for k, v in module.state_dict().items()}
    conv = PyTorchModel(module)
    model = conv.apply(fft.FFConfig(batch_size=8), {"x": (12,)})
    model.compile(optimizer=fft.SGDOptimizer(0.1),
                  loss_type="mean_squared_error", metrics=())
    state = conv.import_weights(model, model.init(seed=0, device="cpu"))
    for _ in range(2):
        state, _ = model.train_step(state, {"x": _x((8, 12))},
                                    _x((8, 3), 1))
    for k, v in module.state_dict().items():
        assert torch.equal(v, held[k]), k
    m = _compiled(PK, PK.Sequential([PK.Dense(4, input_shape=(8,),
                                              name="d")]))
    kernel, bias = _x((8, 4), 2), _x((4,), 3)
    kept = kernel.copy(), bias.copy()
    m.get_layer("d").set_weights([kernel, bias])
    loaded = {op: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
              for op, d in m.state.params.items()}
    loaded_kept = {op: {k: v.clone() for k, v in d.items()}
                   for op, d in loaded.items()}
    for st in (m.state, m.ffmodel.load_params(loaded, device="cpu")):
        st, _ = m.ffmodel.train_step(st, {"input": _x((8, 8))},
                                     _x((8, 4), 1))
        assert not np.array_equal(
            m.ffmodel.get_weights(st, "d", "kernel"), kept[0])
    np.testing.assert_array_equal(kernel, kept[0])
    np.testing.assert_array_equal(bias, kept[1])
    for op, d in loaded.items():
        for k, v in d.items():
            assert torch.equal(v, loaded_kept[op][k]), (op, k)
