"""The port's bf16 activation storage (``FFConfig(activation_dtype=
"bfloat16")``) against the JAX package on the CPU: the tensor dtypes
``compile`` declares, op by op; the final output and the loss input kept
f32 and restored across recompiles; the conv, batch-norm and
average-pool forwards under bf16 storage; the losses of whole training
runs (a small conv net, the classic and fused DLRM graphs, an NMT step);
the serving engine's padding contract; and the step and bucket graphs a
recompile must drop.  JAX is imported here only.

Tolerances, each with its reason:
  * declared and runtime dtypes, exemptions and restores: exact;
  * the conv, average-pool and batch-norm forwards under bf16 storage:
    bit for bit, on inputs where the other forms of their epilogues
    differ;
  * the other graphs' forwards under bf16 storage: atol 2 bf16 ulps of
    the output's magnitude (rtol 1.6e-2, atol 1e-2): the port's products
    accumulate in f64 and round once to bf16, XLA's in f32 and round
    again, so one value may sit a rounding step apart (the
    double-rounding ulp);
  * losses: atol 0.01 step by step against JAX's (the JAX package's own
    test holds bf16 against f32 activations to 0.05 at the last step);
  * padding: bit for bit (the engine's contract).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.apps.nmt import NMTConfig as JaxNMTConfig
from dlrm_flexflow_tpu.apps.nmt import build_nmt as jax_build_nmt
from dlrm_flexflow_tpu.ops import conv as jconv
from dlrm_flexflow_tpu.tensor import Tensor as JaxTensor

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.apps.nmt import NMTConfig, build_nmt
from dlrm_flexflow_tpu_torch.bridge import opt_state_from_jax, params_from_jax
from dlrm_flexflow_tpu_torch.ops import conv as tconv
from dlrm_flexflow_tpu_torch.serving import InferenceEngine
from dlrm_flexflow_tpu_torch.tensor import Tensor

LOSS_ATOL = 0.01
FWD_TOL = dict(rtol=1.6e-2, atol=1e-2)


def _compile(pkg, m, loss, metrics=(), lr=0.05):
    kw = {"mesh": False} if pkg is ffj else {}
    m.compile(optimizer=pkg.SGDOptimizer(lr=lr), loss_type=loss,
              metrics=metrics, **kw)
    return m


def _port_state(jm, pm):
    js = jm.init(seed=0)
    ps = pm.load_params(
        params_from_jax(jax.tree.map(np.asarray, js.params)), device="cpu",
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state)))
    return js, ps


def _declared(m):
    """(op name, output index, dtype name) of every op output."""
    return [(op.name, i, jnp.dtype(t.dtype).name if not isinstance(
        t.dtype, torch.dtype) else str(t.dtype).replace("torch.", ""))
        for op in m.layers for i, t in enumerate(op.outputs)]


# ------------------------------------------------------ the conv model
def _conv_model(pkg, act, softmax_final=False, loss=None):
    """JAX's ``TestActivationDtype._conv_model``."""
    fc = pkg.FFConfig(batch_size=8, compute_dtype="bfloat16",
                      activation_dtype=act)
    m = pkg.FFModel(fc)
    x = m.create_tensor((8, 3, 16, 16), name="input")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu")
    t = m.batch_norm(t, relu=True)
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0, pool_type="avg")
    t = m.conv2d(t, 8, 3, 3, 1, 1, 1, 1, activation="relu")
    t = m.flat(t)
    t = m.dense(t, 10)
    if softmax_final:
        t = m.softmax(t)
    return _compile(pkg, m, loss or "sparse_categorical_crossentropy",
                    ("accuracy",))


def _conv_batch():
    rng = np.random.default_rng(0)
    return ({"input": rng.standard_normal((8, 3, 16, 16)).astype(
        np.float32)}, rng.integers(0, 10, size=(8, 1)).astype(np.int32))


def _losses(jm, pm, batches):
    js, ps = _port_state(jm, pm)
    jl, pl = [], []
    for inputs, labels in batches:
        js, jmets = jm.train_step(js, inputs, labels)
        ps, pmets = pm.train_step(ps, inputs, labels)
        jl.append(float(jmets["loss"]))
        pl.append(float(pmets["loss"]))
    return np.asarray(jl), np.asarray(pl), ps


@pytest.mark.parametrize("softmax_final", [False, True])
def test_final_output_stays_f32_and_intermediates_flip(softmax_final):
    """Tensor by tensor the dtypes JAX declares; the final output and
    the loss input f32; the runtime prediction f32; a recompile at f32
    restores every dtype."""
    jm = _conv_model(ffj, "bfloat16", softmax_final)
    pm = _conv_model(fft, "bfloat16", softmax_final)
    assert _declared(pm) == _declared(jm)
    final = pm.layers[-1].outputs[0]
    assert final.dtype == torch.float32
    exempt = {final.uid, pm._loss_uid}
    inter = [t for op in pm.layers for t in op.outputs]
    assert all(t.dtype == torch.bfloat16 for t in inter
               if t.uid not in exempt)
    if softmax_final:
        logits = pm.layers[-1].inputs[0]
        assert pm._loss_uid == logits.uid
        assert logits.dtype == torch.float32
    ps = pm.init(seed=0, device="cpu")
    preds = pm.forward(ps, _conv_batch()[0])
    assert preds.dtype == torch.float32
    pm.config.activation_dtype = "float32"
    jm.config.activation_dtype = "float32"
    _compile(fft, pm, "sparse_categorical_crossentropy", ("accuracy",))
    _compile(ffj, jm, "sparse_categorical_crossentropy", ("accuracy",))
    assert all(t.dtype == torch.float32 for t in inter)
    assert _declared(pm) == _declared(jm)


def test_newly_exempt_loss_input_is_restored():
    """MSE on a softmax-final graph reads the softmax output, so the
    logits are a plain intermediate (bf16); the fused softmax and CCE
    makes them the loss input again, exempt and f32, as in JAX."""
    models = {pkg: _conv_model(pkg, "bfloat16", True) for pkg in (ffj, fft)}
    for loss, want in (("mean_squared_error", torch.bfloat16),
                       ("sparse_categorical_crossentropy", torch.float32)):
        for pkg, m in models.items():
            _compile(pkg, m, loss)
        logits = models[fft].layers[-1].inputs[0]
        assert logits.dtype == want
        assert _declared(models[fft]) == _declared(models[ffj])


def test_bad_activation_dtype_raises_the_jax_message():
    errors = []
    for pkg in (ffj, fft):
        m = pkg.FFModel(pkg.FFConfig(batch_size=8,
                                     activation_dtype="float16"))
        m.dense(m.create_tensor((8, 4), name="input"), 2)
        with pytest.raises(ValueError) as e:
            _compile(pkg, m, "mean_squared_error")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("softmax_final", [False, True])
def test_loss_trajectory_tracks_jax_and_f32_activations(softmax_final):
    """20 steps on one memorised batch: the bf16-activation losses
    follow JAX's step by step and, as in the JAX test, learn and end
    within 0.05 of the f32-activation run."""
    batches = [_conv_batch()] * 20
    got = {}
    for act in ("bfloat16", "float32"):
        jl, pl, _ = _losses(_conv_model(ffj, act, softmax_final),
                            _conv_model(fft, act, softmax_final), batches)
        np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_ATOL)
        got[act] = pl
    assert got["bfloat16"][-1] < got["bfloat16"][0]
    assert abs(got["bfloat16"][-1] - got["float32"][-1]) < 0.05


def test_elementwise_final_clamped_to_f32():
    """An elementwise op passes its input dtype through; the model
    clamps its final output to f32, as in JAX."""
    outs = {}
    for pkg in (ffj, fft):
        m = pkg.FFModel(pkg.FFConfig(batch_size=8, compute_dtype="bfloat16",
                                     activation_dtype="bfloat16"))
        x = m.create_tensor((8, 4), name="input")
        a = m.dense(x, 8, activation="relu")
        b = m.dense(x, 8, activation="relu")
        m.add(a, b)
        _compile(pkg, m, "mean_squared_error")
        outs[pkg] = m
    jm, pm = outs[ffj], outs[fft]
    assert _declared(pm) == _declared(jm)
    js, ps = _port_state(jm, pm)
    x = {"input": np.random.default_rng(2).standard_normal(
        (8, 4)).astype(np.float32)}
    got = pm.forward(ps, x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.forward(js, x)),
                               **FWD_TOL)


def _shape_graph(pkg):
    """Dense layers feeding every op that passes its input dtype through
    (concat, split, reshape, transpose, reverse, the elementwise ops)
    and a softmax, under bf16 storage."""
    m = pkg.FFModel(pkg.FFConfig(batch_size=4, compute_dtype="bfloat16",
                                 activation_dtype="bfloat16"))
    x = m.create_tensor((4, 6), name="input")
    a = m.dense(x, 8, activation="relu")
    b = m.dense(x, 8)
    c = m.concat([a, b], 1)
    s0, s1 = m.split(c, [6, 10], 1)
    r = m.reshape(s1, (4, 2, 5))
    r = m.reverse(m.transpose(r, (0, 2, 1)), 1)
    e = m.multiply(m.exp(m.flat(r)), m.scalar_multiply(s1, 0.5))
    h = m.concat([s0, m.softmax(e)], 1)
    m.dense(m.relu(h), 3)
    return _compile(pkg, m, "mean_squared_error")


def test_pass_through_ops_emit_jaxs_dtypes():
    """Every op output's runtime dtype, under bf16 storage, is the one
    the JAX package's forward gives, and the values agree."""
    jm, pm = _shape_graph(ffj), _shape_graph(fft)
    assert _declared(pm) == _declared(jm)
    js, ps = _port_state(jm, pm)
    x = np.random.default_rng(5).standard_normal((4, 6)).astype(np.float32)
    jvals, _ = jm._apply(js.params, {"input": jnp.asarray(x)},
                         training=False, rng=None, bn_state={})
    pvals, _ = pm._apply(ps.params, {"input": torch.from_numpy(x)})
    for jop, pop in zip(jm.layers, pm.layers):
        for jt, pt in zip(jop.outputs, pop.outputs):
            want, got = jvals[jt.uid], pvals[pt.uid]
            assert str(got.dtype).replace("torch.", "") == \
                jnp.dtype(want.dtype).name, pop.name
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                err_msg=pop.name, **FWD_TOL)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_softmax_final_matches_logits_final(act):
    """JAX's ``test_softmax_final_matches_logits_final[act]``: the loss
    of a softmax-final graph equals the same graph ending in logits, in
    both packages, and the port's equals JAX's."""
    rng = np.random.default_rng(0)
    inputs = {"input": rng.standard_normal((8, 4)).astype(np.float32)}
    labels = rng.integers(0, 10, size=(8, 1)).astype(np.int32)
    losses = {}
    for pkg in (ffj, fft):
        for with_softmax in (True, False):
            m = pkg.FFModel(pkg.FFConfig(batch_size=8, activation_dtype=act))
            t = m.dense(m.create_tensor((8, 4), name="input"), 16,
                        activation="relu")
            t = m.dense(t, 10)
            if with_softmax:
                m.softmax(t)
            _compile(pkg, m, "sparse_categorical_crossentropy", lr=0.1)
            losses[pkg, with_softmax] = m
    jm, pm = losses[ffj, True], losses[fft, True]
    js, ps = _port_state(jm, pm)
    got = {}
    for pkg, st in ((ffj, js), (fft, ps)):
        for with_softmax in (True, False):
            _, mets = losses[pkg, with_softmax].train_step(
                st, inputs, labels, donate=False)
            got[pkg, with_softmax] = float(mets["loss"])
    assert got[fft, True] == pytest.approx(got[fft, False], abs=1e-6)
    assert got[fft, True] == pytest.approx(got[ffj, True], abs=1e-5)


def test_lstm_initial_state_under_bf16_activations():
    """The decoder LSTM takes its initial (h, c) from encoder outputs
    the rewrite declares bf16; the carry stays f32 and the step's loss
    is finite and JAX's."""
    kw = dict(vocab_size=128, embed_size=16, hidden_size=16, num_layers=1,
              src_len=5, tgt_len=4)
    fk = dict(batch_size=4, compute_dtype="bfloat16",
              activation_dtype="bfloat16")
    jm = _compile(ffj, jax_build_nmt(JaxNMTConfig(**kw), ffj.FFConfig(**fk)),
                  "sparse_categorical_crossentropy", lr=0.1)
    pm = _compile(fft, build_nmt(NMTConfig(**kw), fft.FFConfig(**fk)),
                  "sparse_categorical_crossentropy", lr=0.1)
    assert _declared(pm) == _declared(jm)
    rng = np.random.default_rng(0)
    inputs = {"src": rng.integers(0, 128, size=(4, 5), dtype=np.int32),
              "tgt_in": rng.integers(0, 128, size=(4, 4), dtype=np.int32)}
    labels = rng.integers(0, 128, size=(4, 4, 1)).astype(np.int32)
    jl, pl, _ = _losses(jm, pm, [(inputs, labels)] * 2)
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_ATOL)


# -------------------------------------------------- op forwards, bf16
def _op_pair(kind):
    shape = (4, 6, 9, 9)
    jx, px = JaxTensor(shape, jnp.bfloat16), Tensor(shape, torch.bfloat16)
    if kind.startswith("conv"):
        act = "relu" if "relu" in kind else None
        ops = [mod.Conv2D("c", x, 5, 3, 3, 1, 1, 1, 1, activation=act,
                          compute_dtype="bfloat16")
               for mod, x in ((jconv, jx), (tconv, px))]
    elif kind.startswith("pool"):
        ops = [mod.Pool2D("p", x, 3, 3, 2, 2, 1, 1,
                          pool_type=kind.split("_")[1])
               for mod, x in ((jconv, jx), (tconv, px))]
    else:
        ops = [mod.BatchNorm("bn", x, relu=True)
               for mod, x in ((jconv, jx), (tconv, px))]
    for op in ops:   # the rewrite's declaration: a bf16 intermediate
        op.outputs[0].dtype = (jnp.bfloat16 if op is ops[0]
                               else torch.bfloat16)
    return ops


def _bits(t):
    return t.view(torch.int16).numpy()


def _rival_forms(kind, pop, params, px, state):
    """The forms JAX's bf16-storage epilogues are not, on the same
    inputs: Conv2D's bias and activation in f32 after the widened
    convolution, and batch norm's apply in f32 or folded into ``x * k +
    (bias - mean * k)`` in bf16."""
    if kind.startswith("conv"):
        k = params["kernel"].permute(3, 2, 0, 1).to(torch.bfloat16)
        y = tconv._Conv2dFn.apply(px.contiguous(), k.contiguous(),
                                  pop.stride, pop.padding, pop.groups)
        y = y.float() + params["bias"][None, :, None, None]
        return [(torch.relu(y) if "relu" in kind else y).to(torch.bfloat16)]
    xf = px.float()
    if kind == "bn_train":
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean, var = state["mean"], state["var"]
    k = torch.rsqrt(var + pop.eps) * params["scale"]

    def c(v, dt=torch.float32):
        return v.to(dt)[None, :, None, None]
    f32 = (xf - c(mean)) * c(k) + c(params["bias"])
    folded = px * c(k, torch.bfloat16) + c(params["bias"] - mean * k,
                                           torch.bfloat16)
    return [torch.relu(y).to(torch.bfloat16) for y in (f32, folded)]


@pytest.mark.parametrize("kind", ["conv", "conv_relu", "pool_avg",
                                  "pool_max", "bn_train", "bn_eval"])
def test_op_forward_under_bf16_storage_matches_jax(kind):
    """Conv2D's bf16 epilogue, average pooling's f32 sum and batch
    norm's subtract-first bf16 apply (f32 statistics), on bf16 inputs
    with a bf16 output declared, equal the JAX ops bit for bit.  The
    inputs tell the forms apart: the convolution's inputs lie on a
    coarse grid, so its f32 sums are exact in any order and only the
    epilogue decides the bits, and an f32 epilogue differs from JAX's
    on them; batch norm's channels have a mean far above their spread,
    where an f32 or a folded apply differs from JAX's."""
    jop, pop = _op_pair(kind)
    rng = np.random.default_rng(3)
    if kind.startswith("conv"):
        x = (rng.integers(-16, 17, (4, 6, 9, 9)) / 4).astype(np.float32)
    else:
        x = (rng.standard_normal((4, 6, 9, 9)) * 3 + 5).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    px = torch.from_numpy(x).to(torch.bfloat16)
    params = {}
    for spec in pop.param_specs():
        params[spec.param_name] = rng.standard_normal(spec.shape).astype(
            np.float32) * 0.3
    if kind.startswith("conv"):
        params["kernel"] = (rng.integers(-8, 9, params["kernel"].shape)
                            / 16).astype(np.float32)
    kw, pkw, state = {}, {}, None
    if kind.startswith("bn"):
        state = {"mean": rng.standard_normal(6).astype(np.float32) + 5,
                 "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
        kw = {"state": {k: jnp.asarray(v) for k, v in state.items()},
              "training": kind == "bn_train"}
        state = {k: torch.from_numpy(v) for k, v in state.items()}
        pkw = {"state": state, "training": kind == "bn_train"}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    (want,) = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [jx], **kw)
    (got,) = pop.forward(tparams, [px], **pkw)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want = np.asarray(want).view(np.int16)
    np.testing.assert_array_equal(_bits(got), want)
    if not kind.startswith("pool"):
        for rival in _rival_forms(kind, pop, tparams, px, state):
            assert (_bits(rival) != want).sum() > 0
    if kind == "bn_train":
        for k in ("mean", "var"):
            np.testing.assert_allclose(pop._last_state[k].numpy(),
                                       np.asarray(jop._last_state[k]),
                                       rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ the DLRM
TABLES = [64, 200, 1000, 77]
D = 16


def _dlrm_pair(fused, interact="cat", cd="bfloat16", act="bfloat16"):
    t = len(TABLES)
    top0 = D + t * D if interact == "cat" else D + (t + 1) ** 2
    kw = dict(sparse_feature_size=D, embedding_size=list(TABLES),
              mlp_bot=[13, 32, D], mlp_top=[top0, 32, 1],
              arch_interaction_op=interact, fused_interaction=fused)
    fk = dict(batch_size=32, compute_dtype=cd, activation_dtype=act)
    mets = ("accuracy", "mean_squared_error")
    jm = jax_build_dlrm(JaxDLRMConfig(**kw), ffj.FFConfig(**fk))
    pm = build_dlrm(DLRMConfig(**kw), fft.FFConfig(**fk))
    return (_compile(ffj, jm, "mean_squared_error", mets),
            _compile(fft, pm, "mean_squared_error", mets))


def _dlrm_batches(steps, batch=32, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = np.stack([rng.integers(0, min(r, 20), size=(batch, 1))
                        for r in TABLES], axis=1).astype(np.int64)
        out.append(({"dense": rng.standard_normal((batch, 13)).astype(
            np.float32), "sparse": ids},
            rng.integers(0, 2, size=(batch, 1)).astype(np.float32)))
    return out


@pytest.mark.parametrize("fused,interact", [("off", "cat"), ("off", "dot"),
                                            ("on", "cat")])
def test_dlrm_steps_under_bf16_activations_track_jax(fused, interact):
    """Five row-sparse steps of the classic graph (B2 on the CPU: the
    plain row update) and of the fused graph (the row-sparse
    ``masked_pool_interact`` with a bf16 output): the same declared
    dtypes as JAX, losses within LOSS_ATOL of JAX's, and the tables
    still f32 after the bf16 cotangents' deposits."""
    jm, pm = _dlrm_pair(fused, interact)
    assert _declared(pm) == _declared(jm)
    assert [op.name for op in pm._sparse_ops] == jm._sparse_emb_ops
    jl, pl, ps = _losses(jm, pm, _dlrm_batches(5))
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_ATOL)
    assert ps.params["emb"]["embedding"].dtype == torch.float32


@pytest.fixture(scope="module")
def served_bf16():
    jm, pm = _dlrm_pair("on")
    _, ps = _port_state(jm, pm)
    return pm, ps, InferenceEngine(pm, ps, buckets=(8, 32), device="cpu")


def _request(n, seed):
    return _dlrm_batches(1, batch=n, seed=seed)[0][0]


def test_padding_is_bit_identical_under_bf16_activations(served_bf16):
    """The first n rows of a padded bucket equal the unpadded forward,
    with bf16 between the ops."""
    pm, ps, engine = served_bf16
    for n in (1, 3, 7, 8, 20):
        req = _request(n, seed=100 + n)
        unpadded = pm.predict(ps, req)
        assert unpadded.dtype == torch.float32
        np.testing.assert_array_equal(engine.predict(req), unpadded.numpy())


def test_recompile_that_flips_the_dtype_drops_the_graphs():
    """The step graphs and the engine's bucket graphs built under f32
    activations never run after a recompile to bf16: the model's are
    cleared at compile, the engine's rebuilt at its next dispatch, and
    each then gives the bf16 model's values."""
    # f32 compute: under bf16 compute every matmul rounds its operands
    # to bf16 anyway, and bf16 storage would change no value here
    jm, pm = _dlrm_pair("on", cd=None, act="float32")
    _, ps = _port_state(jm, pm)
    engine = InferenceEngine(pm, ps, buckets=(8,), device="cpu")
    batches = _dlrm_batches(3, batch=8)
    st = ps.clone()
    for inputs, labels in batches[:2]:
        st, _ = pm.train_step(st, inputs, labels)
    assert pm._step_graphs
    req = batches[2][0]
    f32_out = engine.predict(req)
    runner = engine._graphs[8]
    pm.config.activation_dtype = "bfloat16"
    _compile(fft, pm, "mean_squared_error", ("accuracy",
                                             "mean_squared_error"))
    assert not pm._step_graphs and pm._graph_pool is None
    bf16_out = engine.predict(req)
    assert engine._graphs[8] is not runner
    np.testing.assert_array_equal(bf16_out, pm.predict(ps, req).numpy())
    assert not np.array_equal(bf16_out, f32_out)
    eager, stepped = st, st.clone()
    for inputs, labels in batches[:2]:  # an eager step, then the graph
        eager, _ = pm.train_step(eager, inputs, labels, donate=False)
        stepped, _ = pm.train_step(stepped, inputs, labels)
    assert pm._step_graphs
    for op, params in eager.params.items():
        for k, v in params.items():
            torch.testing.assert_close(stepped.params[op][k], v, rtol=0,
                                       atol=0)
