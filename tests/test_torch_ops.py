"""The port's op set (dlrm_flexflow_tpu_torch/ops: conv, pooling, batch
norm, elementwise, softmax, dropout, split, reverse, attention, mixture of
experts, LSTM) against the JAX package's ops on the CPU.  JAX is imported
here only.

Each case builds the JAX op and the port's op on the same shapes, draws
the parameters in JAX and carries them across as numpy arrays, and feeds
both the same inputs from a seeded numpy generator.  The forward and the
gradients (``jax.grad`` of ``sum(out * cot)`` for a random cotangent,
against autograd) are compared at f32:

  * forwards: rtol 1e-5, atol 1e-5 times the output's largest magnitude
    (the port's products accumulate in f64 and round once, XLA's in f32;
    the two convolutions sum in orders of their own);
  * gradients: rtol 1e-4, atol 1e-5 times the gradient's largest
    magnitude (sums over the batch and the window, in other orders);
  * bf16 compute: rtol 2e-2, atol 1e-2 times the largest magnitude (one
    bf16 rounding of each operand and of the convolution's result, at
    places of each framework's own).

Dropout's masks cannot equal JAX's (``jax.random`` is not replayable in
torch); its cases check the port's own contract: the identity outside
training, the keep rate, the 1/keep scaling, the mask a pure function of
(key, step, op index, seed).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrm_flexflow_tpu.ops import attention as jatt
from dlrm_flexflow_tpu.ops import conv as jconv
from dlrm_flexflow_tpu.ops import elementwise as jelem
from dlrm_flexflow_tpu.ops import moe as jmoe
from dlrm_flexflow_tpu.ops import rnn as jrnn
from dlrm_flexflow_tpu.ops import shape_ops as jshape
from dlrm_flexflow_tpu.ops import softmax as jsoft
from dlrm_flexflow_tpu.tensor import Tensor as JaxTensor

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.ops import attention as patt
from dlrm_flexflow_tpu_torch.ops import conv as pconv
from dlrm_flexflow_tpu_torch.ops import elementwise as pelem
from dlrm_flexflow_tpu_torch.ops import moe as pmoe
from dlrm_flexflow_tpu_torch.ops import rnn as prnn
from dlrm_flexflow_tpu_torch.ops import shape_ops as pshape
from dlrm_flexflow_tpu_torch.ops import softmax as psoft
from dlrm_flexflow_tpu_torch.tensor import Tensor

F32 = dict(fwd=(1e-5, 1e-5), grad=(1e-4, 1e-5))
BF16 = dict(fwd=(2e-2, 1e-2), grad=None)


def _tensors(*shapes):
    """(JAX placeholders, port placeholders) of f32 tensors."""
    return ([JaxTensor(s, jnp.float32) for s in shapes],
            [Tensor(s, torch.float32) for s in shapes])


def _close(got, want, tol, what):
    rtol, scale = tol
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    atol = scale * max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _params(jop):
    return {k: np.asarray(v) for k, v in
            jop.init_params(jax.random.PRNGKey(3)).items()}


def check_op(jop, pop, xs, tol=F32, params=None, jkw=None, pkw=None,
             seed=0):
    """Forward of both ops on ``xs``, then the gradients of ``sum(out *
    cot)`` with respect to every parameter and input (``tol["grad"]``
    None: forward only).  Returns the outputs (JAX's, the port's)."""
    params = _params(jop) if params is None else params
    jkw, pkw = jkw or {}, pkw or {}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = [jnp.asarray(x) for x in xs]
    pp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    px = [torch.from_numpy(np.array(x)) for x in xs]
    jout = jax.jit(lambda p, x: jop.forward(p, x, **jkw))(jp, jx)
    pout = pop.forward(pp, px, **pkw)
    assert len(jout) == len(pout) == len(pop.outputs)
    for i, (j, p) in enumerate(zip(jout, pout)):
        assert tuple(p.shape) == tuple(j.shape) == pop.outputs[i].shape
        _close(p.detach().float().numpy(), np.asarray(j, np.float32),
               tol["fwd"], f"forward {i}")
    if tol["grad"] is None:
        return jout, pout
    rng = np.random.default_rng(seed + 100)
    cots = [rng.standard_normal(j.shape).astype(np.float32) for j in jout]

    def jloss(p, x):
        outs = jop.forward(p, x, **jkw)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cots))

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    leaves = {k: v.requires_grad_() for k, v in pp.items()}
    xin = [x.requires_grad_() for x in px]
    outs = pop.forward(leaves, xin, **pkw)
    loss = sum((o.float() * torch.from_numpy(c)).sum()
               for o, c in zip(outs, cots))
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + xin,
                                allow_unused=True, materialize_grads=True)
    for k, g in zip(names, grads):
        _close(g.numpy(), np.asarray(jgp[k]), tol["grad"], f"d{k}")
    for i, g in enumerate(grads[len(names):]):
        _close(g.numpy(), np.asarray(jgx[i]), tol["grad"], f"dx{i}")
    return jout, pout


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------- conv
CONV_CASES = {
    # (input NCHW, out, kh, kw, sh, sw, ph, pw, act, bias, groups)
    "groups_stride_asym": ((2, 4, 9, 7), 6, 3, 2, 2, 1, 1, 0, "relu",
                           True, 2),
    "pointwise_nobias": ((3, 5, 6, 6), 4, 1, 1, 1, 1, 0, 0, None, False, 1),
    "k5_pad2_tanh": ((2, 3, 8, 10), 4, 5, 5, 1, 1, 2, 2, "tanh", True, 1),
    "depthwise_s2": ((2, 4, 7, 7), 4, 3, 3, 2, 2, 1, 1, "sigmoid", True, 4),
}


def _conv_pair(case, compute_dtype=None):
    shape, *args = CONV_CASES[case]
    out, kh, kw, sh, sw, ph, pw, act, bias, groups = args
    (jx,), (px,) = _tensors(shape)
    jop = jconv.Conv2D("c", jx, out, kh, kw, sh, sw, ph, pw, act, bias,
                       groups, compute_dtype=compute_dtype)
    pop = pconv.Conv2D("c", px, out, kh, kw, sh, sw, ph, pw, act, bias,
                       groups, compute_dtype=compute_dtype)
    return jop, pop, shape


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case):
    jop, pop, shape = _conv_pair(case)
    assert [(s.param_name, s.shape) for s in pop.param_specs()] == \
        [(s.param_name, tuple(s.shape)) for s in jop.param_specs()]
    check_op(jop, pop, [_normal(1, *shape)])


def test_conv2d_bf16_compute_matches_jax():
    jop, pop, shape = _conv_pair("k5_pad2_tanh", "bfloat16")
    check_op(jop, pop, [_normal(2, *shape)], tol=BF16)


def test_conv2d_keeps_hwio_and_the_cudnn_settings():
    """The kernel parameter is HWIO; the call leaves the process's cuDNN
    settings as it found them."""
    _, pop, shape = _conv_pair("groups_stride_asym")
    assert pop.param_specs()[0].shape == (3, 2, 2, 6)
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    p = {k: v.requires_grad_() for k, v in pop.init_params(
        torch.Generator().manual_seed(0)).items()}
    (y,) = pop.forward(p, [torch.from_numpy(_normal(0, *shape))])
    y.sum().backward()
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == before


POOL_CASES = {
    # (input, kh, kw, sh, sw, ph, pw, type, activation)
    "max3_s2_p1": ((2, 3, 9, 9), 3, 3, 2, 2, 1, 1, "max", None),
    "max2x3_asym": ((2, 2, 8, 9), 2, 3, 2, 1, 0, 1, "max", "relu"),
    "max3_pad2": ((2, 2, 7, 6), 3, 3, 1, 2, 2, 2, "max", None),
    "avg3_s1_p1": ((2, 3, 8, 8), 3, 3, 1, 1, 1, 1, "avg", None),
    "avg3_pad2": ((2, 2, 6, 7), 3, 3, 2, 1, 2, 2, "avg", None),
    "avg_global": ((3, 4, 5, 5), 5, 5, 1, 1, 0, 0, "avg", None),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case):
    """Max and avg pools, a pad above half the kernel among them (padded
    with -inf or 0 explicitly)."""
    shape, kh, kw, sh, sw, ph, pw, kind, act = POOL_CASES[case]
    (jx,), (px,) = _tensors(shape)
    jop = jconv.Pool2D("p", jx, kh, kw, sh, sw, ph, pw, kind, act)
    pop = pconv.Pool2D("p", px, kh, kw, sh, sw, ph, pw, kind, act)
    check_op(jop, pop, [_normal(3, *shape)])


# ------------------------------------------------------------- batch norm
def _bn_pair(relu):
    (jx,), (px,) = _tensors((4, 3, 5, 5))
    return (jconv.BatchNorm("bn", jx, relu), pconv.BatchNorm("bn", px, relu))


def _bn_state(seed):
    rng = np.random.default_rng(seed)
    return {"mean": rng.standard_normal(3).astype(np.float32),
            "var": (rng.random(3) + 0.5).astype(np.float32)}


@pytest.mark.parametrize("mode", ["train", "eval", "stateless"])
@pytest.mark.parametrize("relu", [False, True])
def test_batch_norm_matches_jax(mode, relu):
    """Training (batch statistics, the running statistics' update), eval
    (the running statistics) and no state (batch statistics)."""
    jop, pop = _bn_pair(relu)
    x = _normal(4, 4, 3, 5, 5) * 2.0 + 1.0
    params = {"scale": np.linspace(0.5, 1.5, 3).astype(np.float32),
              "bias": np.linspace(-0.2, 0.3, 3).astype(np.float32)}
    st = None if mode == "stateless" else _bn_state(5)
    jkw = {"training": mode == "train",
           "state": None if st is None else {k: jnp.asarray(v)
                                             for k, v in st.items()}}
    pkw = {"training": mode == "train",
           "state": None if st is None else {k: torch.from_numpy(v)
                                             for k, v in st.items()}}
    check_op(jop, pop, [x], params=params, jkw=jkw, pkw=pkw)
    if mode == "train":
        # again, returning the state from the trace that set it
        jstate = jax.jit(lambda p, xv: (jop.forward(p, xv, **jkw),
                                        jop._last_state)[1])(
            {k: jnp.asarray(v) for k, v in params.items()}, [jnp.asarray(x)])
        pop.forward({k: torch.from_numpy(v) for k, v in params.items()},
                    [torch.from_numpy(x)], **pkw)
        for k in ("mean", "var"):
            _close(pop._last_state[k].detach().numpy(),
                   np.asarray(jstate[k]), F32["fwd"], k)
    assert [k for k in pop.init_state()] == ["mean", "var"]
    for k, v in pop.init_state().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jop.init_state()[k]))


# ------------------------------------------------------------ elementwise
UNARY = sorted(pelem._UNARY) + ["scalar_add", "scalar_sub", "scalar_mul",
                                "scalar_truediv", "pow", "pow_half"]


@pytest.mark.parametrize("fn", UNARY)
def test_element_unary_matches_jax(fn):
    assert set(pelem._UNARY) == set(jelem._UNARY)
    scalar = {"scalar_add": 1.5, "scalar_sub": -0.75, "scalar_mul": 3.0,
              "scalar_truediv": 3.0, "pow": 2.0, "pow_half": 0.5}.get(fn)
    fn = "pow" if fn == "pow_half" else fn
    x = _normal(6, 4, 7)
    if fn in ("log", "rsqrt", "sqrt") or scalar == 0.5:
        x = np.abs(x) + 0.5
    (jx,), (px,) = _tensors(x.shape)
    check_op(jelem.ElementUnary("u", jx, fn, scalar),
             pelem.ElementUnary("u", px, fn, scalar), [x])


@pytest.mark.parametrize("fn", sorted(pelem._BINARY))
@pytest.mark.parametrize("broadcast", [False, True])
def test_element_binary_matches_jax(fn, broadcast):
    assert set(pelem._BINARY) == set(jelem._BINARY)
    a = _normal(7, 4, 5)
    b = _normal(8, 1 if broadcast else 4, 5)
    if fn in ("div", "divide"):
        b = np.abs(b) + 0.5
    (ja, jb), (pa, pb) = _tensors(a.shape, b.shape)
    jop = jelem.ElementBinary("b", ja, jb, fn)
    pop = pelem.ElementBinary("b", pa, pb, fn)
    assert pop.outputs[0].shape == tuple(jop.outputs[0].shape)
    check_op(jop, pop, [a, b])


def test_unknown_elementwise_fns_raise():
    (px,) = _tensors((2, 2))[1]
    with pytest.raises(ValueError):
        pelem.ElementUnary("u", px, "cube")
    with pytest.raises(ValueError):
        pelem.ElementBinary("b", px, px, "pow")


# ---------------------------------------------------- softmax, split, flip
@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_matches_jax(axis):
    x = _normal(9, 3, 4, 6) * 3.0
    (jx,), (px,) = _tensors(x.shape)
    check_op(jsoft.Softmax("s", jx, axis), psoft.Softmax("s", px, axis), [x])


@pytest.mark.parametrize("sizes,axis", [([2, 3, 1], 1), ([4, 1], -1)])
def test_split_matches_jax(sizes, axis):
    x = _normal(10, 3, 6, 5)
    (jx,), (px,) = _tensors(x.shape)
    jop = jshape.Split("s", jx, sizes, axis)
    pop = pshape.Split("s", px, sizes, axis)
    assert [o.shape for o in pop.outputs] == \
        [tuple(o.shape) for o in jop.outputs]
    check_op(jop, pop, [x])
    with pytest.raises(ValueError):
        pshape.Split("s", px, [1, 1], axis)


@pytest.mark.parametrize("axis", [0, 2, -1])
def test_reverse_matches_jax(axis):
    x = _normal(11, 3, 4, 5)
    (jx,), (px,) = _tensors(x.shape)
    _, (got,) = check_op(jshape.Reverse("r", jx, axis),
                         pshape.Reverse("r", px, axis), [x])
    np.testing.assert_array_equal(got.numpy(), np.flip(x, axis))


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_multihead_attention_matches_jax(causal, cross):
    """Self attention (one input three times) and cross attention (keys
    and values of another length and width), causal and not."""
    b, s, e, h = 2, 5, 8, 2
    t, kd = (7, 6) if cross else (s, e)
    q = _normal(12, b, s, e)
    kv = _normal(13, b, t, kd) if cross else q
    (jq, jk, jv), (pq, pk, pv) = _tensors((b, s, e), (b, t, kd), (b, t, kd))
    jop = jatt.MultiHeadAttention("a", jq, jk, jv, e, h, causal)
    pop = patt.MultiHeadAttention("a", pq, pk, pv, e, h, causal)
    assert pop.flops(b) == jop.flops(b)
    check_op(jop, pop, [q, kv, kv.copy()])


def test_sdpa_matches_jax():
    q, k, v = (_normal(i, 2, 3, 4, 5) for i in (14, 15, 16))
    for causal in (False, True):
        want = jatt.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
        got = patt.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal)
        _close(got.numpy(), np.asarray(want), F32["fwd"], "sdpa")


def test_sequence_parallel_attention_raises_until_the_mesh():
    """The mesh has come: ``seq_parallel=True`` constructs (ring attention
    over a "seq" axis, ``tests/test_torch_seq_parallel.py``), and without
    a mesh the op runs on one device."""
    (pq,) = _tensors((2, 4, 8))[1]
    op = patt.MultiHeadAttention("a", pq, pq, pq, 8, 2, seq_parallel=True)
    assert op.seq_parallel and op._mesh is None and op._allow_kernel


# ------------------------------------------------------ mixture of experts
@pytest.mark.parametrize("top_k,shape", [(2, (6, 8)), (4, (6, 8)),
                                         (1, (2, 3, 8))])
def test_moe_matches_jax(top_k, shape):
    x = _normal(17, *shape)
    (jx,), (px,) = _tensors(shape)
    jop = jmoe.MixtureOfExperts("m", jx, 4, 12, top_k)
    pop = pmoe.MixtureOfExperts("m", px, 4, 12, top_k)
    params = _params(jop)
    # nonzero biases, so that their gradients are exercised
    rng = np.random.default_rng(18)
    for k in ("b_in", "b_out"):
        params[k] = rng.standard_normal(params[k].shape).astype(np.float32)
    check_op(jop, pop, [x], params=params)
    # again, returning the loss from the trace that set it
    jaux = jax.jit(lambda p, xv: (jop.forward(p, xv),
                                  jop._last_aux_loss)[1])(
        {k: jnp.asarray(v) for k, v in params.items()}, [jnp.asarray(x)])
    with torch.no_grad():
        pop.forward({k: torch.from_numpy(v) for k, v in params.items()},
                    [torch.from_numpy(x)])
    _close(pop._last_aux_loss.numpy(), np.asarray(jaux), F32["fwd"],
           "aux loss")


# ------------------------------------------------------------------- LSTM
LSTM_CASES = {
    "plain": dict(),
    "reverse": dict(reverse=True),
    "last_state": dict(return_sequences=False),
    "handoff": dict(initial_state=True, return_state=True),
}


@pytest.mark.parametrize("jax_path", ["custom_vjp", "autodiff"])
@pytest.mark.parametrize("case", sorted(LSTM_CASES))
def test_lstm_matches_both_jax_paths(case, jax_path, monkeypatch):
    """The port's autograd over its loop against the JAX op's hand-written
    backward and against JAX's autodiff of the scan, including the
    initial state's inputs (their gradients too) and the final state's
    outputs."""
    monkeypatch.setenv("FF_LSTM_CUSTOM_VJP",
                       "1" if jax_path == "custom_vjp" else "0")
    kw = dict(LSTM_CASES[case])
    b, t, i, h = 3, 5, 4, 6
    shapes = [(b, t, i)] + ([(b, h), (b, h)] if kw.get("initial_state")
                            else [])
    jts, pts = _tensors(*shapes)
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("initial_state"):
        jkw["initial_state"], pkw["initial_state"] = jts[1:], pts[1:]
    jop = jrnn.LSTM("l", jts[0], h, **jkw)
    pop = prnn.LSTM("l", pts[0], h, **pkw)
    assert [o.shape for o in pop.outputs] == \
        [tuple(o.shape) for o in jop.outputs]
    assert pop.flops(b) == jop.flops(b)
    params = _params(jop)
    params["bias"] = np.random.default_rng(19).standard_normal(
        4 * h).astype(np.float32) * 0.1
    xs = [_normal(20 + n, *s) for n, s in enumerate(shapes)]
    check_op(jop, pop, xs, params=params)


# ---------------------------------------------------------------- dropout
def _dropout_model(rate=0.3, seed=0, n=4096):
    m = fft.FFModel(fft.FFConfig(batch_size=4))
    x = m.create_tensor((4, n), name="x")
    t = m.dense(x, n, use_bias=False, name="lin")
    m.dropout(t, rate, seed, name="drop")
    m.compile(optimizer=fft.SGDOptimizer(lr=0.0),
              loss_type="mean_squared_error", metrics=())
    return m


def _drop_out(m, st, x):
    """The dropout op's training-mode output at the state's (rng, step),
    as the step computes it."""
    key = psoft.fold_in(st.rng, st.step)
    values, _ = m._apply(st.params, {"x": x}, training=True, rng=key)
    return values[m.final_tensor.uid]


def test_dropout_is_the_identity_outside_training_as_in_jax():
    x = _normal(21, 4, 16)
    (jx,), (px,) = _tensors(x.shape)
    jop, pop = jsoft.Dropout("d", jx, 0.5), psoft.Dropout("d", px, 0.5)
    (want,) = jop.forward({}, [jnp.asarray(x)])
    (got,) = pop.forward({}, [torch.from_numpy(x)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        pop.forward({}, [torch.from_numpy(x)], training=True)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scaling(rate):
    m = _dropout_model(rate)
    st = m.init(seed=1, device="cpu")
    st.params["lin"]["kernel"] = torch.eye(4096)
    x = torch.from_numpy(np.abs(_normal(22, 4, 4096)) + 1.0)
    y = _drop_out(m, st, x)
    kept = y != 0
    keep = 1.0 - rate
    # 16,384 Bernoulli draws: 5 standard deviations
    sd = (keep * rate / kept.numel()) ** 0.5
    assert abs(kept.float().mean().item() - keep) < 5 * sd
    torch.testing.assert_close(y[kept], x[kept] / keep, rtol=1e-6, atol=0)


def test_dropout_mask_is_a_function_of_key_step_index_and_seed():
    """The same (rng, step) gives the same mask, in another model and on
    a clone; the next step, another seed, another key or another op index
    give another."""
    x = torch.ones((4, 4096))

    def mask(m, st):
        st.params["lin"]["kernel"] = torch.eye(4096)
        return _drop_out(m, st, x) != 0

    m = _dropout_model()
    st = m.init(seed=1, device="cpu")
    first = mask(m, st)
    assert torch.equal(first, mask(_dropout_model(), st.clone()))
    st.step.add_(1)
    assert not torch.equal(first, mask(m, st))
    st.step.sub_(1)
    assert not torch.equal(first, mask(_dropout_model(seed=7), st))
    assert not torch.equal(first, mask(m, m.init(seed=2, device="cpu")))
    bits = psoft.random_bits(psoft.fold_in(st.rng, 0), (64,))
    assert torch.unique(bits).numel() == 64
    assert not torch.equal(
        psoft.random_bits(psoft.fold_in(psoft.fold_in(st.rng, 0), 1), (64,)),
        psoft.random_bits(psoft.fold_in(psoft.fold_in(st.rng, 0), 2), (64,)))


def test_dropout_training_step_draws_a_new_mask_each_step():
    """Through ``train_step`` (the CPU runs of the captured step): the
    loss of a fixed batch changes from one step to the next only through
    the mask (lr 0), and the donated and kept-state steps agree."""
    m = _dropout_model(n=64)
    st = m.init(seed=3, device="cpu")
    x = _normal(23, 4, 64)
    y = np.zeros((4, 64), np.float32)
    losses = []
    for _ in range(3):
        kept, mk = m.train_step(st, {"x": x}, y, donate=False)
        st, mets = m.train_step(st, {"x": x}, y)
        assert float(mets["loss"]) == float(mk["loss"])
        losses.append(float(mets["loss"]))
    assert len(set(losses)) == 3
    assert m.has_stochastic and int(st.step) == 3
