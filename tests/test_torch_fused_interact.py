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


@pytest.mark.parametrize("interact", ["cat", "dot"])
@pytest.mark.parametrize("bag", [1, 3])
def test_plain_drops_premasked_ids_past_the_table_like_the_kernel(interact,
                                                                  bag):
    """A pre-masked flat id >= R (which ``mask_local_ids`` never makes)
    is dropped by the TPU kernel (``live()`` in ``_fused_kernel``), and
    the port's plain version follows the kernel it ports; the JAX plain
    ``fused_interact_ref`` ``jnp.take``s it (a NaN row) instead."""
    table, bottom, local = _inputs(17, bag, dropped=False)
    gids = np.asarray(_jax_gids(local)).copy()
    rows = table.shape[0]
    gids[0, 0, 0], gids[5, 2, bag - 1], gids[6, 1, 0] = rows, rows + 7, -1
    port = tk.fused_interact_ref(torch.from_numpy(table),
                                 torch.from_numpy(gids),
                                 torch.from_numpy(bottom), interact=interact,
                                 aggr="sum").numpy()
    args = (jnp.asarray(table), jnp.asarray(gids), jnp.asarray(bottom))
    kern = jax.jit(functools.partial(jk.fused_interact_pallas,
                                     interact=interact, aggr="sum",
                                     interpret=True))(*args)
    assert np.isfinite(port).all()
    _assert_agree(port, kern, interact, bag)
    ref = jk.fused_interact_ref(*args, interact=interact, aggr="sum")
    assert np.isnan(np.asarray(ref)[0]).any()


@pytest.mark.parametrize("aggr", ["sum", "avg"])
def test_plain_sums_each_bag_in_bag_order(aggr):
    """Rows whose sum depends on its order (1e8 absorbs a 1 in f32): the
    plain version pools ((r0 + r1) + r2) + r3, as the CUDA kernel does,
    bit for bit against a sequential numpy sum and against the JAX
    package's plain function and interpret-mode kernel.  (On the card
    ``Tensor.sum`` reduces in an order of its own.)"""
    bag = 4
    table = np.zeros((sum(ROW_COUNTS), D), np.float32)
    table[:4, 0] = [1e8, 1, -1e8, 1]
    table[:4, 1] = [1, 1e8, 1, -1e8]
    table[:4, 2:] = np.random.default_rng(2).standard_normal((4, D - 2))
    local = np.broadcast_to(np.arange(bag, dtype=np.int32),
                            (B, len(ROW_COUNTS), bag)).copy()
    bottom = np.random.default_rng(3).standard_normal((B, D)).astype(
        np.float32)
    port = _port(table, local, bottom, interact="cat", aggr=aggr)
    rows = table[:4]
    want = ((rows[0] + rows[1]) + rows[2]) + rows[3]
    if aggr == "avg":
        want = want / np.float32(bag)
    np.testing.assert_array_equal(port[:, D:D + D],
                                  np.broadcast_to(want, (B, D)))
    assert port[0, D] == np.float32(1.0) / (bag if aggr == "avg" else 1)
    args = (jnp.asarray(table), _jax_gids(local), jnp.asarray(bottom))
    for kernel in (False, True):
        _assert_agree(port, _jax_fwd("cat", aggr, None, kernel)(*args),
                      "cat", 1)  # bit-exact


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


# ------------------------------------------ the folded call (ids masked in it)
# fused_embed_interact_cuda takes the op's local ids, int32 or int64, with
# the per-table offsets and row counts, and masks them in the same launch;
# its plain version (what the CPU runs) is mask_local_ids followed by
# fused_interact_ref.  Tolerances as above.
_FOLDED_CASES = ([("cat", aggr, bag, None) for aggr in ("sum", "avg")
                  for bag in (0, 1, 3)]
                 + [("dot", aggr, bag, cd) for aggr in ("sum", "avg")
                    for bag in (0, 1, 3) for cd in (None, "bfloat16")])


@functools.lru_cache(maxsize=None)
def _jax_fwd(interact, aggr, cd, kernel: bool):
    if kernel:
        return jax.jit(functools.partial(
            jk.fused_interact_pallas, interact=interact, aggr=aggr,
            interpret=True, compute_dtype=cd))
    return jax.jit(functools.partial(jk.fused_interact_ref,
                                     interact=interact, aggr=aggr,
                                     compute_dtype=cd))


def _consts():
    return (torch.as_tensor(OFFSETS),
            torch.as_tensor(ROW_COUNTS, dtype=torch.int64))


def _folded(table, local, bottom, **kw):
    return tk.fused_embed_interact_cuda(
        torch.from_numpy(table), torch.from_numpy(local), *_consts(),
        torch.from_numpy(bottom), **kw)


@pytest.mark.parametrize("interact,aggr,bag,cd", _FOLDED_CASES)
def test_folded_call_matches_jax_mask_ref_and_interpret_kernel(interact,
                                                                aggr, bag,
                                                                cd):
    """Local ids with dropped entries (-1, -3, int32 min, one at and one
    past its table's count), int64 in even cases and int32 in odd ones,
    against JAX's ``mask_local_ids`` + ``fused_interact_ref`` and its
    interpret-mode kernel (which refuses an empty bag); the masked ids
    come back bit for bit."""
    i = _FOLDED_CASES.index((interact, aggr, bag, cd))
    table, bottom, local = _inputs(100 + i, bag)
    local = local.astype(np.int64 if i % 2 == 0 else np.int32)
    out, gids = _folded(table, local, bottom, interact=interact, aggr=aggr,
                        compute_dtype=cd, want_gids=True)
    assert out.shape == (B, jk.interact_width(interact, 3, D, D))
    args = (jnp.asarray(table), _jax_gids(local), jnp.asarray(bottom))
    assert gids.dtype == torch.int32
    np.testing.assert_array_equal(gids.numpy(), np.asarray(args[1]))
    _assert_agree(out.numpy(), _jax_fwd(interact, aggr, cd, False)(*args),
                  interact, bag)
    if bag:
        _assert_agree(out.numpy(), _jax_fwd(interact, aggr, cd, True)(*args),
                      interact, bag)


@pytest.mark.parametrize("bag", [1, 3])
def test_folded_gids_are_mask_local_ids_in_both_id_widths(bag):
    """The gids output equals ``mask_local_ids(...).to(int32)`` bit for
    bit, from int32 and int64 ids alike (int32 min and ids at and past a
    table's count included), and the output does not depend on the
    width; without ``want_gids`` no gids come back."""
    table, bottom, local = _inputs(31, bag)
    local[5, 2, 0] = np.iinfo(np.int32).max
    want = tk.mask_local_ids(torch.from_numpy(local.astype(np.int64)),
                             *_consts()).to(torch.int32)
    outs = []
    for dtype in (np.int32, np.int64):
        out, gids = _folded(table, local.astype(dtype), bottom,
                            interact="dot", aggr="avg", want_gids=True)
        assert gids.dtype == torch.int32 and torch.equal(gids, want)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    out, gids = _folded(table, local, bottom, interact="dot", aggr="avg")
    assert gids is None and torch.equal(out, outs[0])


def test_folded_entry_on_cpu_launches_no_kernel():
    table, bottom, local = _inputs(13, 2)
    before = tk.fused_interact_cuda.launches
    out, gids = _folded(table, local, bottom, interact="cat", aggr="sum",
                        want_gids=True)
    plain, plain_gids = tk.fused_embed_interact_ref(
        torch.from_numpy(table), torch.from_numpy(local), *_consts(),
        torch.from_numpy(bottom), interact="cat", aggr="sum",
        want_gids=True)
    assert torch.equal(out, plain) and torch.equal(gids, plain_gids)
    assert tk.fused_interact_cuda.launches == before == 0


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


# -------------------------------------------------------------- the backward
# Tolerances of the backward, each with its reason:
#   * cat: the row grads are slices of g, broadcast over the bag and
#     divided by it for avg, then masked; dbottom is a slice: bit-exact;
#   * dot: dz is two f32 matmuls whose sums run in another order,
#     rtol 1e-5, atol 1e-6.
_BWD_CASES = [(i, a, bag) for i in ("cat", "dot") for a in ("sum", "avg")
              for bag in (1, 3)]


def _assert_bwd_agree(port, ref, interact):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == np.float32 and port.shape == ref.shape
    if interact == "cat":
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def _cotangent(seed, interact):
    width = jk.interact_width(interact, len(ROW_COUNTS), D, D)
    return np.random.default_rng(seed).standard_normal(
        (B, width)).astype(np.float32)


def _port_dtable(table, gids, rowg):
    """The dense table gradient as the port's autograd.Function forms it:
    one deterministic scatter of the row grads at max(gids, 0)."""
    from dlrm_flexflow_tpu_torch.ops.row_update_kernel import row_update_ref
    return row_update_ref(torch.zeros_like(table), gids.clamp_min(0), rowg,
                          1.0)


@pytest.mark.parametrize("interact,aggr,bag", _BWD_CASES)
def test_bwd_plain_matches_jax_kernel_and_vjp(interact, aggr, bag):
    """The plain backward against the JAX Pallas backward kernel in
    interpret mode (row grads and dbottom) and against ``jax.vjp`` of the
    JAX plain forward (dense table gradient and dbottom).  Dropped ids are
    in every case; they must give exact-zero row grads."""
    table, bottom, local = _inputs(50 + _BWD_CASES.index(
        (interact, aggr, bag)), bag)
    g = _cotangent(7, interact)
    gids = tk.mask_local_ids(torch.from_numpy(local), OFFSETS, ROW_COUNTS)
    tt, tb, tg = map(torch.from_numpy, (table, bottom, g))
    rowg, dbot = tk.fused_interact_bwd_cuda(tt, gids, tb, tg,
                                            interact=interact, aggr=aggr)
    assert rowg.shape == (B, len(ROW_COUNTS), bag, D)
    np.testing.assert_array_equal(rowg.numpy()[gids.numpy() < 0], 0.0)
    args = (jnp.asarray(table), _jax_gids(local), jnp.asarray(bottom),
            jnp.asarray(g))
    krowg, kdbot = jax.jit(functools.partial(
        jk.fused_interact_bwd_pallas, interact=interact, aggr=aggr,
        interpret=True))(*args)
    if interact == "cat" and aggr == "avg" and bag & (bag - 1):
        # The JAX kernel's ``dpooled / bag`` runs as a multiply by the
        # reciprocal in interpret mode on the CPU, one ulp off the
        # division that jax.vjp (bit-exact below), the port and the CUDA
        # kernel do when the bag is not a power of two (ROADMAP Queue C)
        np.testing.assert_allclose(rowg.numpy(), np.asarray(krowg),
                                   rtol=1.2e-7, atol=0)
    else:
        _assert_bwd_agree(rowg, krowg, interact)
    _assert_bwd_agree(dbot, kdbot, interact)
    _, vjp = jax.vjp(lambda t, b: jk.fused_interact_ref(
        t, args[1], b, interact=interact, aggr=aggr), args[0], args[2])
    jdt, jdb = vjp(args[3])
    _assert_bwd_agree(_port_dtable(tt, gids, rowg), jdt, interact)
    _assert_bwd_agree(dbot, jdb, interact)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("interact", ["cat", "dot"])
def test_autograd_fn_grads_match_jax_custom_vjp(interact, cd):
    """``FusedEmbedInteractFn``'s gradients on the CPU against the JAX
    custom VJP ``fused_embed_interact``: with the interpret-mode kernels
    at f32 (the backward kernel then runs on the JAX side) and through
    the emitter VJP under bf16 compute, where both packages fall back to
    autodiff of the plain formulation.  Tolerances as above; bf16 dot
    rounds its operands at other places in the two frameworks, rtol 1e-3
    (the repo's bf16 gate)."""
    from dlrm_flexflow_tpu_torch.ops.fused_interact import \
        FusedEmbedInteractFn
    bag = 2
    table, bottom, local = _inputs(70, bag)
    g = _cotangent(8, interact)
    tt = torch.from_numpy(table).requires_grad_()
    tb = torch.from_numpy(bottom).requires_grad_()
    out = FusedEmbedInteractFn.apply(
        tt, tb, torch.from_numpy(local), torch.as_tensor(OFFSETS),
        torch.as_tensor(ROW_COUNTS, dtype=torch.int64), interact, "sum", cd)
    dt, db = torch.autograd.grad(out, (tt, tb), torch.from_numpy(g))
    jids = _jax_gids(local).astype(jnp.int32)
    _, vjp = jax.vjp(lambda t, b: jk.fused_embed_interact(
        t, jids, b, interact, "sum", cd is None, cd is None, cd),
        jnp.asarray(table), jnp.asarray(bottom))
    jdt, jdb = vjp(jnp.asarray(g))
    if cd is None:
        _assert_bwd_agree(dt, jdt, interact)
        _assert_bwd_agree(db, jdb, interact)
    else:
        np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("interact", ["cat", "dot"])
def test_fused_op_grads_match_jax_op(interact):
    """``FusedEmbedInteract.forward`` (the folded call inside the
    autograd.Function) and its gradients against ``jax.vjp`` of the JAX
    op's forward, on int64 local ids with dropped entries; tolerances of
    the backward above."""
    bag = 2
    jop, pop = _ops(interact, "sum", bag)
    rng = np.random.default_rng(3)
    table = rng.standard_normal((pop.total_rows, D)).astype(np.float32)
    _, bottom, local = _inputs(77, bag)
    g = _cotangent(10, interact)
    jidx = jnp.asarray(local)
    want, vjp = jax.vjp(
        lambda t, b: jop.forward({"embedding": t}, [jidx, b])[0],
        jnp.asarray(table), jnp.asarray(bottom))
    jdt, jdb = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_()
    tb = torch.from_numpy(bottom).requires_grad_()
    (got,) = pop.forward({"embedding": tt},
                         [torch.from_numpy(local.astype(np.int64)), tb])
    dt, db = torch.autograd.grad(got, (tt, tb), torch.from_numpy(g))
    _assert_agree(got.detach().numpy(), want, interact, bag)
    _assert_bwd_agree(dt, jdt, interact)
    _assert_bwd_agree(db, jdb, interact)


def test_bwd_cpu_tensors_launch_no_kernel():
    table, bottom, local = _inputs(12, 2)
    gids = tk.mask_local_ids(torch.from_numpy(local), OFFSETS, ROW_COUNTS)
    g = torch.from_numpy(_cotangent(9, "dot"))
    args = (torch.from_numpy(table), gids, torch.from_numpy(bottom), g)
    got = tk.fused_interact_bwd_cuda(*args, interact="dot", aggr="avg")
    want = tk.fused_interact_bwd_ref(*args, interact="dot", aggr="avg")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tk.fused_interact_bwd_cuda.launches == 0
