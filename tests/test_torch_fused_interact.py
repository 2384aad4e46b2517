"""The port's fused gather -> pool -> interact
(dlrm_flexflow_tpu_torch/ops/fused_interact_kernel.py and
ops/fused_interact.py) against the JAX package on the CPU: the plain
PyTorch version against JAX's plain ``fused_interact_ref`` and against
its Pallas kernel run in interpret mode, on the same numpy inputs.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there.  Here the wrapper receives CPU tensors,
so it runs the plain version and launches nothing.

Tolerances, each with its reason:
  * cat with bag 1 (and any empty bag): pure data movement, bit-exact;
  * a bag > 1: the bag sum may run in another order, rtol 1e-6 atol 1e-6;
  * dot: the f32 dot products run in another order, rtol 1e-5 atol 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrm_flexflow_tpu.ops import pallas_fused_interact as jk
from dlrm_flexflow_tpu.ops.embedding import \
    RaggedStackedEmbedding as JaxRagged
from dlrm_flexflow_tpu.ops.fused_interact import \
    FusedEmbedInteract as JaxFused
from dlrm_flexflow_tpu.tensor import Tensor as JaxTensor
from dlrm_flexflow_tpu_torch.ops import fused_interact_kernel as tk
from dlrm_flexflow_tpu_torch.ops.embedding import RaggedStackedEmbedding
from dlrm_flexflow_tpu_torch.ops.fused_interact import FusedEmbedInteract
from dlrm_flexflow_tpu_torch.tensor import Tensor

ROW_COUNTS = [40, 24, 32]
OFFSETS = np.concatenate([[0], np.cumsum(ROW_COUNTS[:-1])])
D = 16
B = 13  # odd: the JAX kernel pads a partial 8-sample block
INT32_MIN = int(np.iinfo(np.int32).min)


def _inputs(seed, bag, dropped=True):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((sum(ROW_COUNTS), D)).astype(np.float32)
    bottom = rng.standard_normal((B, D)).astype(np.float32)
    # a narrow id range: duplicates across and within bags
    local = rng.integers(0, 12, size=(B, len(ROW_COUNTS), bag)
                         ).astype(np.int32)
    if dropped and bag:
        local[0, 0, 0] = -1
        local[1, 1, :] = -3
        local[2, 2, bag - 1] = ROW_COUNTS[2]       # one past the table
        local[3, 0, 0] = INT32_MIN
        local[4, 1, 0] = ROW_COUNTS[1] + 5
    return table, bottom, local


def _assert_agree(port, ref, interact, bag):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == np.float32 and port.shape == ref.shape
    if interact == "cat" and bag <= 1:
        np.testing.assert_array_equal(port, ref)   # pure data movement
    elif interact == "cat":
        # bag sums in another order
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)
    else:
        # f32 dot products in another order
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def _port(table, local, bottom, **kw):
    gids = tk.mask_local_ids(torch.from_numpy(local), OFFSETS, ROW_COUNTS)
    return tk.fused_interact_cuda(torch.from_numpy(table), gids,
                                  torch.from_numpy(bottom), **kw).numpy()


def _jax_gids(local):
    return jk.mask_local_ids(jnp.asarray(local), OFFSETS, ROW_COUNTS)


def test_mask_local_ids_exact():
    # (B=2, T=2, bag=2); tables: 40 rows at offset 0, 24 at 40
    idx = [[[0, -1], [5, 24]], [[39, 2], [-9, 0]]]
    want = [[[0, -1], [45, -1]], [[39, 2], [-1, 40]]]
    for dtype in (torch.int32, torch.int64):
        gids = tk.mask_local_ids(torch.tensor(idx, dtype=dtype),
                                 OFFSETS[:2], ROW_COUNTS[:2])
        np.testing.assert_array_equal(gids.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jk.mask_local_ids(jnp.asarray(idx), OFFSETS[:2],
                                     ROW_COUNTS[:2])), want)


@pytest.mark.parametrize("bag", [1, 3])
def test_mask_local_ids_matches_jax_on_dropped_ids(bag):
    _, _, local = _inputs(7, bag)
    port = tk.mask_local_ids(torch.from_numpy(local), OFFSETS, ROW_COUNTS)
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(_jax_gids(local)))


_CASES = ([("cat", aggr, bag, None) for aggr in ("sum", "avg")
           for bag in (1, 3)]
          + [("dot", aggr, bag, cd) for aggr in ("sum", "avg")
             for bag in (1, 3) for cd in (None, "bfloat16")])


@pytest.mark.parametrize("interact,aggr,bag,cd", _CASES)
def test_plain_matches_jax_ref_and_interpret_kernel(interact, aggr, bag, cd):
    """Dropped ids (-1, -3, int32 min, local ids past their table) are
    in every case."""
    table, bottom, local = _inputs(_CASES.index((interact, aggr, bag, cd)),
                                   bag)
    port = _port(table, local, bottom, interact=interact, aggr=aggr,
                 compute_dtype=cd)
    assert port.shape == (B, jk.interact_width(interact, 3, D, D))
    args = (jnp.asarray(table), _jax_gids(local), jnp.asarray(bottom))
    ref = jax.jit(functools.partial(jk.fused_interact_ref, interact=interact,
                                    aggr=aggr, compute_dtype=cd))(*args)
    _assert_agree(port, ref, interact, bag)
    kern = jax.jit(functools.partial(
        jk.fused_interact_pallas, interact=interact, aggr=aggr,
        interpret=True, compute_dtype=cd))(*args)
    _assert_agree(port, kern, interact, bag)


@pytest.mark.parametrize("interact", ["cat", "dot"])
@pytest.mark.parametrize("aggr", ["sum", "avg"])
def test_empty_bag_matches_jax_ref(interact, aggr):
    """bag == 0 pools to exact zeros (the mean of nothing is not NaN).
    The JAX kernel refuses an empty bag, so the reference is its plain
    function."""
    table, bottom, local = _inputs(3, 0)
    port = _port(table, local, bottom, interact=interact, aggr=aggr)
    ref = jk.fused_interact_ref(jnp.asarray(table), _jax_gids(local),
                                jnp.asarray(bottom), interact=interact,
                                aggr=aggr)
    _assert_agree(port, ref, interact, 0)
    if interact == "cat":
        np.testing.assert_array_equal(port[:, D:], 0.0)


def test_cpu_tensors_launch_no_kernel():
    table, bottom, local = _inputs(11, 2)
    before = tk.fused_interact_cuda.launches
    port = _port(table, local, bottom, interact="dot", aggr="avg")
    gids = tk.mask_local_ids(torch.from_numpy(local), OFFSETS, ROW_COUNTS)
    plain = tk.fused_interact_ref(torch.from_numpy(table), gids,
                                  torch.from_numpy(bottom), interact="dot",
                                  aggr="avg").numpy()
    np.testing.assert_array_equal(port, plain)
    assert tk.fused_interact_cuda.launches == before == 0


def test_bf16_dot_differs_from_f32_dot():
    """The bf16 operand rounding engages (as in the JAX package)."""
    table, bottom, local = _inputs(5, 2)
    f32 = _port(table, local, bottom, interact="dot", compute_dtype=None)
    bf16 = _port(table, local, bottom, interact="dot",
                 compute_dtype="bfloat16")
    assert f32.dtype == bf16.dtype == np.float32
    assert not np.array_equal(f32, bf16)


# ------------------------------------------------------------- the op level
def _ops(interact, aggr, bag):
    jids = JaxTensor((B, len(ROW_COUNTS), bag), jnp.int32)
    jbot = JaxTensor((B, D), jnp.float32)
    pids = Tensor((B, len(ROW_COUNTS), bag), torch.int64)
    pbot = Tensor((B, D), torch.float32)
    return (JaxFused("emb", jids, jbot, ROW_COUNTS, D, interact, aggr),
            FusedEmbedInteract("emb", pids, pbot, ROW_COUNTS, D, interact,
                               aggr))


@pytest.mark.parametrize("interact", ["cat", "dot"])
@pytest.mark.parametrize("aggr", ["sum", "avg"])
def test_fused_op_forward_matches_jax_op(interact, aggr):
    """FusedEmbedInteract: same padded row space and parameter shape,
    same output on the same table (the JAX op takes its emitter path on
    the CPU)."""
    bag = 2
    jop, pop = _ops(interact, aggr, bag)
    assert pop.total_rows == jop.total_rows
    assert pop.param_specs()[0].shape == jop.param_specs()[0].shape
    assert pop.outputs[0].shape == jop.outputs[0].shape
    rng = np.random.default_rng(1)
    table = rng.standard_normal((pop.total_rows, D)).astype(np.float32)
    _, bottom, local = _inputs(9, bag)
    (want,) = jop.forward({"embedding": jnp.asarray(table)},
                          [jnp.asarray(local), jnp.asarray(bottom)])
    (got,) = pop.forward({"embedding": torch.from_numpy(table)},
                         [torch.from_numpy(local.astype(np.int64)),
                          torch.from_numpy(bottom)])
    _assert_agree(got.numpy(), want, interact, bag)


@pytest.mark.parametrize("rows,dim", [
    (ROW_COUNTS, D), ([1_000_000] * 8, 64), ([7, 5], 48), ([3], 256),
    ([1396, 550, 1761917, 507795, 290, 21, 11948], 16)])
def test_ragged_row_space_matches_jax(rows, dim):
    """Offsets, the padded row space and flat ids equal the JAX op's, so
    parameters cross between the packages with identical shapes."""
    bag = 2
    jop = JaxRagged("emb", JaxTensor((4, len(rows), bag), jnp.int32), rows,
                    dim)
    pop = RaggedStackedEmbedding("emb", Tensor((4, len(rows), bag),
                                               torch.int64), rows, dim)
    assert pop.total_rows == jop.total_rows
    np.testing.assert_array_equal(pop.offsets, jop.offsets)
    assert pop.param_specs()[0].shape == jop.param_specs()[0].shape
    local = np.random.default_rng(4).integers(0, min(rows),
                                              size=(4, len(rows), bag))
    np.testing.assert_array_equal(
        pop.flat_ids(torch.from_numpy(local)).numpy(),
        np.asarray(jop.flat_ids(jnp.asarray(local.astype(np.int32)))))
