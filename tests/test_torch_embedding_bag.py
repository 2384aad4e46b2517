"""The port's embedding bag (dlrm_flexflow_tpu_torch/ops/bag_kernel.py and
``Embedding(use_pallas=True)`` in ops/embedding.py) against the JAX package
on the CPU, on the same numpy inputs:

  * ``embedding_bag_ref`` against the Pallas bag kernel
    ``embedding_bag_pallas`` run in interpret mode;
  * ``EmbeddingBagFn``'s gradient against ``jax.grad`` through the JAX
    package's ``embedding_bag`` custom VJP;
  * the op's flag, forward and training step, and its exclusion from the
    row-sparse set, against the JAX op and model.

Tolerances, each with its reason:
  * ``sum``: bit-exact; both sum each bag in bag order, and the gradient
    of both is a scatter that adds duplicates in the ids' order from 0.0;
  * ``avg``: within one ulp; XLA on the CPU may run the division by the
    bag as a multiply by its reciprocal, the port divides (ROADMAP
    Queue C);
  * whole training steps: losses rtol 1e-5, parameters rtol 1e-4 and
    atol 1e-6, as ``test_torch_training_slice.py`` (the port's Linear
    accumulates in f64 and rounds once).

The CUDA kernel runs only on the card; chip_smoke.py holds it against
the plain version there.  Here the wrappers receive CPU tensors, so they
run the plain versions and launch nothing.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.ops import embedding as jemb
from dlrm_flexflow_tpu.ops import pallas_embedding as jbag

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.bridge import params_from_jax
from dlrm_flexflow_tpu_torch.ops import embedding as temb
from dlrm_flexflow_tpu_torch.ops.bag_kernel import (embedding_bag_cuda,
                                                   embedding_bag_ref)
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import row_update_cuda
from dlrm_flexflow_tpu_torch.tensor import Tensor

ROWS, D = 300, 128


def _inputs(bsz, bag, seed, rows=ROWS, d=D):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, d)).astype(np.float32)
    ids = rng.integers(0, rows, size=(bsz, bag))
    ids[1] = ids[0]                  # a bag that repeats another
    ids[2, :] = ids[0, 0]            # a bag of one repeated row
    return table, ids.astype(np.int64)


def _assert_agree(port, want, mode):
    if mode == "sum":
        np.testing.assert_array_equal(port, want)
    else:
        np.testing.assert_array_max_ulp(port, want, maxulp=1)


@functools.lru_cache(maxsize=None)
def _interpret_kernel(mode):
    return jax.jit(functools.partial(jbag.embedding_bag_pallas, mode=mode,
                                     interpret=True))


@pytest.mark.parametrize("bsz", [8, 16])
@pytest.mark.parametrize("bag", [1, 3, 8])
@pytest.mark.parametrize("mode", ["sum", "avg"])
def test_plain_matches_interpret_kernel(mode, bag, bsz):
    table, ids = _inputs(bsz, bag, seed=bsz + bag)
    port = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids),
                             mode)
    want = _interpret_kernel(mode)(jnp.asarray(table),
                                   jnp.asarray(ids.astype(np.int32)))
    assert port.shape == (bsz, D)
    _assert_agree(port.numpy(), np.asarray(want), mode)


def test_plain_reads_take_rule_for_out_of_range_ids():
    """Ids in [-R, 0) wrap; any other id outside [0, R) reads NaN, as the
    port's plain forward (jnp.take's rule)."""
    table, ids = _inputs(8, 3, seed=1)
    ids[3, 1], ids[4, 0], ids[5, 2] = -1, ROWS, -ROWS - 1
    port = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids))
    want = jnp.take(jnp.asarray(table), jnp.asarray(ids.astype(np.int32)),
                    axis=0)
    want = ((want[:, 0] + want[:, 1]) + want[:, 2])
    np.testing.assert_array_equal(port.numpy(), np.asarray(want))
    assert torch.isnan(port[4]).all() and torch.isfinite(port[3]).all()


@pytest.mark.parametrize("mode", ["sum", "avg"])
def test_wrapper_on_cpu_runs_the_plain_version(mode):
    table, ids = _inputs(8, 3, seed=2)
    before = embedding_bag_cuda.launches
    got = embedding_bag_cuda(torch.from_numpy(table),
                             torch.from_numpy(ids.astype(np.int32)), mode)
    assert embedding_bag_cuda.launches == before
    np.testing.assert_array_equal(
        got.numpy(), embedding_bag_ref(torch.from_numpy(table),
                                       torch.from_numpy(ids), mode).numpy())


@pytest.mark.parametrize("case,exc", [("mode", ValueError),
                                      ("ids_1d", ValueError),
                                      ("ids_float", TypeError),
                                      ("devices", ValueError)])
def test_wrapper_validates_its_inputs(case, exc):
    table, ids = torch.zeros((8, 4)), torch.zeros((2, 3), dtype=torch.int64)
    mode = "max" if case == "mode" else "sum"
    if case == "ids_1d":
        ids = ids.reshape(-1)
    elif case == "ids_float":
        ids = ids.float()
    elif case == "devices":
        ids = ids.to("meta")
    with pytest.raises(exc):
        embedding_bag_cuda(table, ids, mode)


@pytest.mark.parametrize("bag", [1, 3, 8])
@pytest.mark.parametrize("mode", ["sum", "avg"])
def test_gradient_matches_jax_custom_vjp(mode, bag):
    """``EmbeddingBagFn``'s table gradient (the row update into a zero
    table) against ``jax.grad`` through ``embedding_bag``'s custom VJP
    (its segment-sum ``_bwd``), with duplicate ids across bags."""
    table, ids = _inputs(16, bag, seed=3 * bag)
    w = np.random.default_rng(4).standard_normal((16, D)).astype(np.float32)
    jgrad = jax.grad(lambda t: jnp.sum(
        jbag.embedding_bag(t, jnp.asarray(ids.astype(np.int32)), mode, False)
        * jnp.asarray(w)))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = temb.EmbeddingBagFn.apply(t, torch.from_numpy(ids), mode)
    (tgrad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), t)
    assert row_update_cuda.launches == 0  # CPU tensors: the plain version
    _assert_agree(tgrad.numpy(), np.asarray(jgrad), mode)


@pytest.mark.parametrize("out_dim", [64, 128])
def test_use_pallas_flag_matches_jax(out_dim):
    """The JAX eligibility (d % 128 == 0), kept though the Hopper kernel
    needs none of it: it decides the op's path."""
    for flag in (False, True):
        jop = jemb.Embedding("e", ffj.Tensor((8, 3), jnp.int32), 50, out_dim,
                             use_pallas=flag)
        pop = temb.Embedding("e", Tensor((8, 3), torch.int64), 50, out_dim,
                             use_pallas=flag)
        assert pop.use_pallas == jop.use_pallas == (flag and out_dim == 128)


@pytest.mark.parametrize("bsz", [8, 6])
@pytest.mark.parametrize("mode", ["sum", "avg"])
def test_op_forward_matches_jax(mode, bsz):
    """B % 8 == 0: the bag path, against the interpret-mode kernel; B = 6:
    the gather-and-pool path, against the JAX op's own forward."""
    table, ids = _inputs(bsz, 3, seed=5 + bsz)
    pop = temb.Embedding("e", Tensor((bsz, 3), torch.int64), ROWS, D, mode,
                         use_pallas=True)
    (got,) = pop.forward({"embedding": torch.from_numpy(table)},
                         [torch.from_numpy(ids)])
    if bsz % 8 == 0:
        want = _interpret_kernel(mode)(jnp.asarray(table),
                                       jnp.asarray(ids.astype(np.int32)))
    else:
        jop = jemb.Embedding("e", ffj.Tensor((bsz, 3), jnp.int32), ROWS, D,
                             mode, use_pallas=True)
        (want,) = jop.forward({"embedding": jnp.asarray(table)},
                              [jnp.asarray(ids.astype(np.int32))])
    _assert_agree(got.numpy(), np.asarray(want), mode)


def _bag_models(out_dim, bsz=8, bag=3):
    """One use_pallas Embedding over (B, bag) ids, concatenated with a
    dense input, then Linear to 1, MSE: the same graph in both packages
    (``FFModel.embedding`` never passes the flag, in either)."""
    models = []
    for pkg, emb_cls, cfg in ((ffj, jemb.Embedding, JaxFFConfig),
                              (fft, temb.Embedding, fft.FFConfig)):
        m = pkg.FFModel(cfg(batch_size=bsz))
        ids = m.create_tensor((bsz, bag), "int32" if pkg is ffj else "int64",
                              name="ids")
        dense = m.create_tensor((bsz, 16), "float32", name="dense")
        e = m._add(emb_cls(m._name("embedding"), ids, ROWS, out_dim, "sum",
                           use_pallas=True))
        m.dense(m.concat([e, dense], axis=1), 1, name="out")
        kw = {"mesh": False} if pkg is ffj else {}
        m.compile(optimizer=pkg.SGDOptimizer(lr=0.05),
                  loss_type="mean_squared_error",
                  metrics=("mean_squared_error",), **kw)
        models.append(m)
    return models


@pytest.mark.parametrize("out_dim", [64, 128])
def test_bag_ops_leave_the_row_sparse_set_as_in_jax(out_dim):
    jm, pm = _bag_models(out_dim)
    assert [op.name for op in pm._sparse_ops] == jm._sparse_emb_ops
    assert jm._sparse_emb_ops == ([] if out_dim == 128 else ["embedding"])


def test_training_steps_match_jax(monkeypatch):
    """Three dense-gradient steps of the use_pallas graph: the JAX side's
    bag kernel runs in interpret mode (patched in for this test only)."""
    monkeypatch.setattr(jbag, "embedding_bag_pallas", functools.partial(
        jbag.embedding_bag_pallas, interpret=True))
    jm, pm = _bag_models(D)
    js = jm.init(seed=0)
    ps = pm.load_params(params_from_jax(jax.tree.map(np.asarray, js.params)),
                        device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(3):
        inputs = {"ids": rng.integers(0, 40, size=(8, 3)),
                  "dense": rng.standard_normal((8, 16)).astype(np.float32)}
        labels = rng.standard_normal((8, 1)).astype(np.float32)
        js, jmets = jm.train_step(
            js, {**inputs, "ids": inputs["ids"].astype(np.int32)}, labels)
        ps, pmets = pm.train_step(ps, inputs, labels)
        np.testing.assert_allclose(float(pmets["loss"]),
                                   float(jmets["loss"]), rtol=1e-5)
    for op, params in js.params.items():
        for k, v in params.items():
            np.testing.assert_allclose(ps.params[op][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{op}/{k}")
    assert embedding_bag_cuda.launches == 0
