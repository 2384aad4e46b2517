"""The row update's preparation and the cases its Hopper kernels special-
case (dlrm_flexflow_tpu_torch/ops/row_update_kernel.py), against the JAX
package on the CPU, on the same numpy inputs.

``prepare_row_update_ref`` is the plain version of the prepare-and-sort
kernel: its int32 keys (``.at[].add``'s wrap applied, R for a dropped id)
and int32 order are held bit for bit against ``jnp.argsort(...,
stable=True)`` of the same keys.  ``row_update_ref`` is held bit for bit
against ``table.at[ids].add(u)`` and against the Pallas row-update kernel
run in interpret mode (``sparse_row_update(..., interpret=True)``) at the
sizes and id patterns that the kernels treat apart: R at a radix digit's
bit boundary, n past one tile of the sort, runs longer than the update
kernel's 32-row ring, wrapped ids in one run with unwrapped ones, every id
dropped, int32 min, and f32 and bf16 updates with a float or a 0-dim
tensor scale.

The port forms the scaled update as ``f32(scale) * f32(upd)`` rounded once
to the update's dtype.  JAX promotes otherwise for bf16 updates (a
traced f32 scale keeps the product in f32; a Python float is rounded to
the update's dtype first), so against ``sparse_row_update`` itself those
cases hold to a stated bound: two ulps of the update's dtype on each
scaled update plus an f32 ulp of the row per add, summed over the updates
of a row (``_promotion_bound``).
Against ``.at[].add`` of the port's own product they are bit-exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrm_flexflow_tpu.ops.pallas_scatter import sparse_row_update
from dlrm_flexflow_tpu_torch.data.loader import zipf_ids
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import (
    _scale_args, launch_row_update, prepare_row_update_cuda,
    prepare_row_update_ref, row_update_cuda, row_update_ref)

I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_prepare(ids, rows_n):
    """The keys and order the prepare-and-sort kernel writes, from JAX."""
    flat = jnp.asarray(ids.reshape(-1).astype(np.int64))
    wrapped = jnp.where(flat < 0, flat + rows_n, flat)
    live = (wrapped >= 0) & (wrapped < rows_n)
    keys = jnp.where(live, wrapped, rows_n).astype(jnp.int32)
    order = jnp.argsort(keys, stable=True)
    return np.asarray(keys[order]), np.asarray(order.astype(jnp.int32))


def _ids(rng, n, rows_n, dtype):
    """ids over [-2R, 2R): a quarter wrap, half are dropped; int32 ids
    also carry int32 min and max."""
    ids = rng.integers(-2 * rows_n, 2 * rows_n, size=n).astype(dtype)
    if dtype == np.int32 and n >= 4:
        ids[[0, n // 3, n // 2, n - 1]] = [I32_MIN, I32_MAX, I32_MIN + 1, -1]
    return ids


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 100, 4097, 9000])
@pytest.mark.parametrize("rows_n", [255, 2 ** 8, 2 ** 8 + 1, 2 ** 16,
                                    2 ** 16 + 1])
def test_prepare_matches_jax_stable_argsort(rows_n, n, dtype):
    """R = 2^k and 2^k + 1 change the sort's digit count; n = 4097 and
    9000 lie past one tile of the kernel (4096 slots in its small block,
    8192 in its large one), neither a multiple of it."""
    rng = np.random.default_rng(rows_n + n)
    ids = _ids(rng, n, rows_n, dtype)
    keys, order = prepare_row_update_ref(torch.from_numpy(ids), rows_n)
    assert keys.dtype == order.dtype == torch.int32
    want_keys, want_order = _jax_prepare(ids, rows_n)
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    np.testing.assert_array_equal(order.numpy(), want_order)


def test_prepare_key_convention():
    """Wrapped ids join their row's run in slot order; a dropped id
    (int32 min among them: dropped, not wrapped) takes the key R and sorts
    after every live one, in slot order."""
    r = 10
    ids = np.array([3, -7, I32_MIN, 12, -10, 3, -11, 0, I32_MAX],
                   dtype=np.int32)
    keys, order = prepare_row_update_ref(torch.from_numpy(ids), r)
    np.testing.assert_array_equal(keys.numpy(), [0, 0, 3, 3, 3, r, r, r, r])
    np.testing.assert_array_equal(order.numpy(), [4, 7, 0, 1, 5, 2, 3, 6, 8])


def test_prepare_all_dropped_keeps_slot_order():
    ids = np.array([5, -6, 100, I32_MIN], dtype=np.int32)
    keys, order = prepare_row_update_ref(torch.from_numpy(ids), 5)
    np.testing.assert_array_equal(keys.numpy(), [5, 5, 5, 5])
    np.testing.assert_array_equal(order.numpy(), [0, 1, 2, 3])


def test_prepare_on_cpu_launches_nothing():
    ids = torch.from_numpy(_ids(np.random.default_rng(1), 50, 20, np.int64))
    before = prepare_row_update_cuda.launches
    keys, order = prepare_row_update_cuda(ids, 20)
    want = prepare_row_update_ref(ids, 20)
    assert torch.equal(keys, want[0]) and torch.equal(order, want[1])
    assert prepare_row_update_cuda.launches == before


# ------------------------------------------------------------ row update
def _port(table, ids, upd, scale):
    t = torch.from_numpy(table.copy())
    if isinstance(scale, np.ndarray):
        scale = torch.from_numpy(scale)
    out = row_update_cuda(t, torch.from_numpy(ids), upd, scale)
    assert out is t
    return t.numpy()


def _port_product(upd, scale):
    """The port's scaled update in numpy: f32 product, rounded once to the
    update's dtype, widened back."""
    prod = np.float32(scale) * upd.float().numpy()
    return torch.from_numpy(prod).to(upd.dtype).float().numpy()


def _xla(table, ids, u):
    return np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].add(
        jnp.asarray(u)))


@functools.lru_cache(maxsize=None)
def _jitted_kernel(pipeline):
    return jax.jit(functools.partial(sparse_row_update, interpret=True,
                                     pipeline=pipeline))


def _kernel(table, ids, upd, scale, pipeline):
    return np.asarray(_jitted_kernel(pipeline)(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd),
        jnp.float32(scale)))


@pytest.mark.parametrize("pipeline", [False, True])
def test_runs_longer_than_the_ring(pipeline):
    """One run of 200 slots (past the update kernel's 32-row ring and its
    four chunks of keys in flight), one of 33 and one of 32 among distinct
    ids: the interpret-mode kernel carries them across its 16-slot
    blocks."""
    rng = np.random.default_rng(20)
    r, d, n = 512, 64, 320
    ids = rng.permutation(np.concatenate([
        np.full(200, 7), np.full(33, 300), np.full(32, 11),
        rng.choice(np.arange(400, 512), n - 265, replace=False)]))
    ids = ids.astype(np.int32)
    table = rng.standard_normal((r, d)).astype(np.float32)
    upd = rng.standard_normal((n, d)).astype(np.float32)
    port = _port(table, ids, torch.from_numpy(upd), -0.05)
    np.testing.assert_array_equal(port, _xla(table, ids, np.float32(-0.05)
                                             * upd))
    np.testing.assert_array_equal(port, _kernel(table, ids, upd, -0.05,
                                                pipeline))


@pytest.mark.parametrize("rows_n", [2 ** 8, 2 ** 8 + 1])
def test_bit_boundary_tables_and_zipf_runs(rows_n):
    """R at a digit's bit boundary with zipf ids (long hot runs), against
    the interpret-mode kernel (d = 32 is packed four to a lane row
    there)."""
    rng = np.random.default_rng(rows_n)
    d, n = 32, 256
    table = rng.standard_normal((rows_n, d)).astype(np.float32)
    ids = zipf_ids(rng, rows_n, (n,), a=1.2).astype(np.int32)
    upd = rng.standard_normal((n, d)).astype(np.float32)
    assert np.bincount(ids).max() > 32
    port = _port(table, ids, torch.from_numpy(upd), 0.5)
    np.testing.assert_array_equal(port, _xla(table, ids, np.float32(0.5)
                                             * upd))
    if rows_n % 4 == 0:  # the kernel packs only tables of whole lane rows
        np.testing.assert_array_equal(port, _kernel(table, ids, upd, 0.5,
                                                    True))


def test_wrapped_ids_share_a_run_with_unwrapped_ones():
    """Row 3 is named as 3 and as 3 - R: one run, accumulated in slot
    order whichever spelling each slot uses."""
    rng = np.random.default_rng(21)
    r, d = 16, 8
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = np.array([3, 3 - r, 5, 3, -1, 3 - r, r - 1, 3], dtype=np.int64)
    upd = rng.standard_normal((ids.size, d)).astype(np.float32)
    port = _port(table, ids, torch.from_numpy(upd), 1.0)
    np.testing.assert_array_equal(port, _xla(table, ids, upd))
    row3 = table[3].copy()
    for k in np.flatnonzero((ids == 3) | (ids == 3 - r)):
        row3 = row3 + upd[k]
    np.testing.assert_array_equal(port[3], row3)


@pytest.mark.parametrize("ids", [
    np.array([16, -17, 40, I32_MIN, I32_MAX], dtype=np.int32),
    np.array([I32_MIN] * 6, dtype=np.int32),
    np.array([2 ** 40, -2 ** 40, 16], dtype=np.int64),
])
def test_every_id_dropped_leaves_the_table(ids):
    rng = np.random.default_rng(22)
    table = rng.standard_normal((16, 8)).astype(np.float32)
    upd = rng.standard_normal((ids.size, 8)).astype(np.float32)
    port = _port(table, ids, torch.from_numpy(upd), 2.0)
    np.testing.assert_array_equal(port, table)


def test_many_slots_past_one_tile():
    """n = 9000 zipf ids with wrapped and dropped ones (the sort walks
    more than one tile on the card), against ``.at[].add``."""
    rng = np.random.default_rng(23)
    r, d, n = 3000, 16, 9000
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = zipf_ids(rng, r, (n,), a=1.05)
    ids[::7] -= r        # wrapped
    ids[3::11] += 2 * r  # dropped
    upd = rng.standard_normal((n, d)).astype(np.float32)
    port = _port(table, ids, torch.from_numpy(upd), -0.01)
    np.testing.assert_array_equal(port, _xla(table, ids, np.float32(-0.01)
                                             * upd))


def _promotion_bound(table, ids, u):
    """Per element: two ulps of bf16 on each |scaled update| (the
    scale's rounding and the product's, on either side), plus one f32 ulp
    of the row's magnitude for each add, summed over the updates that
    reach the element's row."""
    ulp = 2.0 ** -7
    mag = np.abs(table).astype(np.float64)
    np.add.at(mag, ids, np.abs(u))
    bound = np.zeros(table.shape, np.float64)
    np.add.at(bound, ids, np.abs(u) * ulp + mag[ids] * 2.0 ** -23)
    return bound


@pytest.mark.parametrize("scale_kind", ["float", "tensor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_dtypes_and_scales(dtype, scale_kind):
    """f32 and bf16 updates with a float or a 0-dim tensor scale:
    bit-exact against ``.at[].add`` of the port's product; against
    ``sparse_row_update`` on the same inputs (its own promotion) exact at
    f32 and within ``_promotion_bound`` otherwise."""
    rng = np.random.default_rng(24)
    r, d, n = 64, 32, 96
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = zipf_ids(rng, r, (n,), a=1.1).astype(np.int32)
    upd = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                           ).to(TORCH_DTYPES[dtype])
    scale = np.float32(-0.3)
    arg = np.array(scale) if scale_kind == "tensor" else float(scale)
    port = _port(table, ids, upd, arg)
    u = _port_product(upd, scale)
    np.testing.assert_array_equal(port, _xla(table, ids, u))
    jax_upd = jnp.asarray(upd.float().numpy()).astype(dtype)
    jax_scale = jnp.float32(scale) if scale_kind == "tensor" else float(scale)
    want = np.asarray(sparse_row_update(jnp.asarray(table), jnp.asarray(ids),
                                        jax_upd, jax_scale))
    if dtype == "float32":
        np.testing.assert_array_equal(port, want)
    else:
        bound = _promotion_bound(table, ids, u)
        assert np.all(np.abs(port.astype(np.float64) - want) <= bound)
        assert not np.array_equal(port, table)


def test_scale_and_size_checks():
    """A tensor scale must be 0-dim, and f32 on the table's device when it
    is not on the CPU; the update kernel's 32-bit row offsets bound
    n * d.  Checked before anything is built or launched."""
    cuda = torch.device("cuda", 0)
    assert _scale_args(0.5, cuda) == (None, 0.5)
    assert _scale_args(torch.tensor(-2.0), cuda) == (None, -2.0)
    with pytest.raises(ValueError, match="0-dim"):
        _scale_args(torch.ones(1), cuda)
    with pytest.raises(TypeError, match="must be f32"):
        _scale_args(torch.tensor(1.0, device="meta"), cuda)
    table = torch.empty((8, 2 ** 20), device="meta")
    keys = torch.empty(2 ** 12, dtype=torch.int32, device="meta")
    upd = torch.empty((2 ** 12, 2 ** 20), device="meta")
    with pytest.raises(ValueError, match="32-bit offsets"):
        launch_row_update(table, keys, keys, upd, 1.0)


def test_plain_version_matches_the_wrapper_on_cpu():
    """``row_update_cuda`` on CPU tensors is ``row_update_ref``, f32 and
    bf16 updates alike, and counts no launch."""
    rng = np.random.default_rng(25)
    table = rng.standard_normal((32, 16)).astype(np.float32)
    ids = rng.integers(-40, 40, size=(5, 9))
    upd = torch.from_numpy(rng.standard_normal((5, 9, 16)).astype(
        np.float32)).to(torch.bfloat16)
    before = row_update_cuda.launches
    a = _port(table, ids, upd, 0.25)
    b = torch.from_numpy(table.copy())
    row_update_ref(b, torch.from_numpy(ids), upd, 0.25)
    np.testing.assert_array_equal(a, b.numpy())
    assert row_update_cuda.launches == before
