"""The port's sequence and pipeline parallelism (``parallel/
ring_attention.py``, ``parallel/ulysses.py``, ``parallel/pipeline.py``,
``MultiHeadAttention(seq_parallel=True)``) against the JAX package.

One 4-rank gloo group runs every scenario (rank bodies in
``tests/torch_mesh_ranks.py``): ring and Ulysses attention on {"seq": 4}
and {"data": 2, "seq": 2}, causal and not, forward and input gradients;
the sequence-parallel attention op's forward and two steps; the SPMD
pipeline on {"pipe": 4}.  The JAX references run here; the tolerances
are JAX's own (``tests/test_parallel.py:133-166``, ``:229-289``,
``:394-454``).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.ops.attention import sdpa as jsdpa
from dlrm_flexflow_tpu.parallel import mesh as jmesh
from dlrm_flexflow_tpu.parallel.pipeline import (pipeline_loss_and_grad,
                                                 place_stage_params,
                                                 spmd_pipeline)
from dlrm_flexflow_tpu.parallel.ring_attention import ring_attention_sharded
from dlrm_flexflow_tpu.parallel.ulysses import ulysses_attention_sharded

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import distributed as fdist

from test_torch_mesh import flat, np_params

TESTS = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"s4": {"seq": 4}, "d2s2": {"data": 2, "seq": 2}}
#: the attention op's SGD rate: two steps move its weights (|w| <= 0.31
#: at init) by about a tenth and leave them of order 1
MHA_LR = 0.01
FNS = {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
               for _ in range(3))
    ref = {}
    for causal in (False, True):
        def loss(a, b, c, causal=causal):
            return jnp.sum(jsdpa(a, b, c, causal=causal) ** 2)
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        ref[f"dense/{int(causal)}"] = [np.asarray(g) for g in grads]
        ref[f"dense/{int(causal)}/out"] = np.asarray(
            jsdpa(q, k, v, causal=causal))
    # JAX's own sharded forms on one mesh shape (the rest against the
    # dense attention, which JAX's tests hold them to at 2e-5)
    mesh = jmesh.make_mesh(SHAPES["d2s2"])
    for name, fn in FNS.items():
        ref[f"d2s2/{name}/1/out"] = np.asarray(
            fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
               causal=True))
    # the sequence-parallel op: JAX on the same mesh shape
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    y = rng.standard_normal((4, 16, 32)).astype(np.float32)
    m = ffj.FFModel(ffj.FFConfig(batch_size=4))
    t = m.create_tensor((4, 16, 32), name="x")
    m.multihead_attention(t, t, t, embed_dim=32, num_heads=4, causal=True,
                          seq_parallel=True)
    m.compile(optimizer=ffj.SGDOptimizer(lr=MHA_LR),
              loss_type="mean_squared_error", metrics=(),
              mesh=jmesh.make_mesh({"data": 2, "seq": 2}))
    st = m.init(seed=2)
    p0 = np_params(st.params)
    ref["mha/forward"] = np.asarray(m.forward(st, {"x": x}))
    losses = []
    for _ in range(2):
        st, mets = m.train_step(st, {"x": x}, y)
        losses.append(float(mets["loss"]))
    ref["mha/losses"] = np.array(losses)
    ref["mha/params"] = np_params(st.params)
    # the pipeline
    pw = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    pb = (rng.standard_normal((4, 16)) * 0.1).astype(np.float32)
    px = rng.standard_normal((8, 4, 16)).astype(np.float32)
    pmesh = jmesh.make_mesh({"pipe": 4})
    params = {"w": jnp.asarray(pw), "b": jnp.asarray(pb)}

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    placed = place_stage_params(params, pmesh)
    ref["pipe/out"] = np.asarray(spmd_pipeline(stage_fn, pmesh, 8)(placed,
                                                                  px))
    lg = pipeline_loss_and_grad(stage_fn, lambda p, t: jnp.mean((p - t) ** 2),
                                pmesh, 8)
    loss, grads = jax.jit(lg)(placed, px, jnp.zeros_like(px))
    ref["pipe/loss"], ref["pipe/gw"] = float(loss), np.asarray(grads["w"])
    data, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(data, q=q, k=k, v=v, mha_x=x, mha_y=y, mha_lr=MHA_LR,
             pipe_w=pw, pipe_b=pb,
             pipe_x=px, **flat(p0, "mha/"))
    fdist.launch("torch_mesh_ranks:run_attention", 4,
                 kwargs={"data": data, "out": out}, device="cpu",
                 timeout_s=240, pythonpath=[TESTS])
    return ref, np.load(out)


@pytest.mark.parametrize("causal", [0, 1])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("tag", ["s4", "d2s2"])
def test_sequence_parallel_attention_matches_jax(group, tag, name, causal):
    """The sharded attention's output against JAX's dense attention (and
    against JAX's own sharded form on {"data": 2, "seq": 2}, causal) at
    atol/rtol 2e-5, and its input gradients against the dense
    attention's (rtol 2e-4, atol 2e-5)."""
    ref, got = group
    key = f"{tag}/{name}/{causal}"
    np.testing.assert_allclose(got[f"{key}/out"], ref[f"dense/{causal}/out"],
                               rtol=2e-5, atol=2e-5)
    if f"{key}/out" in ref:
        np.testing.assert_allclose(got[f"{key}/out"], ref[f"{key}/out"],
                                   rtol=2e-5, atol=2e-5)
    for n, g in zip("qkv", ref[f"dense/{causal}"]):
        np.testing.assert_allclose(got[f"{key}/d{n}"], g, rtol=2e-4,
                                   atol=2e-5, err_msg=f"d{n}")


def test_ulysses_head_divisibility_asserted(group):
    _, got = group
    assert int(got["s4/ulysses_assert"]) == 1


def test_seq_parallel_mha_op_matches_jax(group):
    """``MultiHeadAttention(seq_parallel=True)`` on {"data": 2, "seq": 2}:
    the ring forward and two steps' losses match JAX's run on the same
    mesh at 2e-5 and 1e-5, and the parameters after the two steps match
    JAX's and the port's one-device run at rtol 1e-5 / atol 1e-6, the
    bound of every other mesh case."""
    ref, got = group
    np.testing.assert_allclose(got["mha/forward"], ref["mha/forward"],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["mha/losses"], ref["mha/losses"],
                               rtol=1e-5)
    for op, d in ref["mha/params"].items():
        for k, v in d.items():
            assert np.abs(v).max() < 1.0, f"{op}/{k} grew to {v.max()}"
            np.testing.assert_allclose(got[f"mhap/{op}/{k}"],
                                       got[f"mha1p/{op}/{k}"], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{op}/{k}")
            np.testing.assert_allclose(got[f"mhap/{op}/{k}"], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{op}/{k}")


def test_seq_parallel_mha_without_a_seq_axis_is_dense():
    """Without a mesh the op computes plain ``sdpa``."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    outs = []
    for sp in (False, True):
        m = fft.FFModel(fft.FFConfig(batch_size=2))
        t = m.create_tensor((2, 8, 16), name="x")
        m.multihead_attention(t, t, t, 16, 2, causal=True, seq_parallel=sp)
        m.compile(mesh=False)
        outs.append(m.forward(m.init(seed=0, device="cpu"), {"x": x}))
    assert np.array_equal(outs[0].numpy(), outs[1].numpy())


def test_spmd_pipeline_matches_jax(group):
    """The pipeline on {"pipe": 4}: each rank holds one stage's
    parameters; forward, microbatch-count independence, the loss and
    the stacked gradient against JAX's (atol 1e-6)."""
    ref, got = group
    np.testing.assert_array_equal(got["pipe/local_w_shape"], [1, 16, 16])
    np.testing.assert_allclose(got["pipe/out"], ref["pipe/out"], atol=1e-6)
    np.testing.assert_allclose(got["pipe/out4"], got["pipe/out"], atol=1e-6)
    assert abs(float(got["pipe/loss"]) - ref["pipe/loss"]) < 1e-6
    np.testing.assert_allclose(got["pipe/gw"], ref["pipe/gw"], atol=1e-6)
