"""The port's sorted in-place row update
(dlrm_flexflow_tpu_torch/ops/row_update_kernel.py) against the JAX
package on the CPU: the plain PyTorch version ``row_update_ref`` against
``table.at[ids].add(scale * upd)`` and against the Pallas row-update
kernel run in interpret mode (serial ``_row_update_kernel`` and pipelined
``_row_update_kernel_v2``), on the same numpy inputs.

Every comparison is bit-exact (``assert_array_equal``): both sides add
each duplicate run in the ids' stable order starting from the row as it
was, and the updates are scaled the same way, so no rounding differs.

The CUDA kernel runs only on the card; chip_smoke.py holds it against
the plain version there.  Here the wrapper receives CPU tensors, so it
runs the plain version and launches nothing.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrm_flexflow_tpu.ops.pallas_scatter import sparse_row_update
from dlrm_flexflow_tpu_torch.data.loader import zipf_ids
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import (row_update_cuda,
                                                          row_update_ref)


def _port(table, ids, upd, scale):
    t = torch.from_numpy(table.copy())
    out = row_update_ref(t, torch.from_numpy(ids), torch.from_numpy(upd),
                         scale)
    assert out is t  # in place
    return t.numpy()


def _xla(table, ids, upd, scale):
    return np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].add(
        scale * jnp.asarray(upd)))


@functools.lru_cache(maxsize=None)
def _jitted_kernel(pipeline):
    # one jit per variant, with the scale traced: cases of one shape share
    # a compile, which is most of an interpret-mode kernel's cost
    return jax.jit(functools.partial(sparse_row_update, interpret=True,
                                     pipeline=pipeline))


def _kernel(table, ids, upd, scale, pipeline):
    return np.asarray(_jitted_kernel(pipeline)(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd),
        jnp.float32(scale)))


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("shape", [(64, 128, 32), (128, 64, 64),
                                   (64, 32, 32), (256, 8, 64)])
def test_plain_matches_scatter_add_and_interpret_kernel(shape, pipeline):
    r, d, n = shape
    rng = np.random.default_rng(r + d + n)
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = rng.integers(0, r, size=(n,), dtype=np.int32)
    upd = rng.standard_normal((n, d)).astype(np.float32)
    port = _port(table, ids, upd, -0.1)
    np.testing.assert_array_equal(port, _xla(table, ids, upd, -0.1))
    np.testing.assert_array_equal(port,
                                  _kernel(table, ids, upd, -0.1, pipeline))


@pytest.mark.parametrize("pipeline", [False, True])
def test_heavy_duplicates_cross_blocks(pipeline):
    """Three ids over 32 slots: runs longer than the TPU kernel's 16-slot
    blocks, so runs cross block boundaries there."""
    rng = np.random.default_rng(5)
    r, d, n = 64, 128, 32
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = np.sort(rng.integers(0, 3, size=(n,))).astype(np.int32)
    upd = rng.standard_normal((n, d)).astype(np.float32)
    port = _port(table, ids, upd, 1.0)
    np.testing.assert_array_equal(port, _xla(table, ids, upd, 1.0))
    np.testing.assert_array_equal(port, _kernel(table, ids, upd, 1.0,
                                                pipeline))


@pytest.mark.parametrize("pipeline", [False, True])
def test_packed_neighbours(pipeline):
    """d=32: the TPU kernel packs 4 rows per 128-lane view row and
    serialises their updates; the port has no packing and must agree."""
    rng = np.random.default_rng(6)
    r, d, n = 64, 32, 32
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = (np.arange(n) % 8).astype(np.int32)  # rows 0..7, 4 times each
    upd = rng.standard_normal((n, d)).astype(np.float32)
    port = _port(table, ids, upd, 0.5)
    np.testing.assert_array_equal(port, _xla(table, ids, upd, 0.5))
    np.testing.assert_array_equal(port, _kernel(table, ids, upd, 0.5,
                                                pipeline))


def test_no_updates_leaves_the_table():
    table = np.random.default_rng(7).standard_normal((16, 8)).astype(
        np.float32)
    ids = np.zeros((0,), np.int64)
    upd = np.zeros((0, 8), np.float32)
    port = _port(table, ids, upd, -0.1)
    np.testing.assert_array_equal(port, table)
    np.testing.assert_array_equal(port, _xla(table, ids, upd, -0.1))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_wrapped_and_dropped_ids(dtype):
    """The ``.at[].add`` contract: an id in [-R, 0) wraps to id + R; an
    id >= R or < -R is dropped (neither read nor written)."""
    rng = np.random.default_rng(8)
    r, d = 32, 16
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = np.array([3, -1, r, -r, 5, -r - 1, 3, 2 * r + 7, -1, 0, r - 1],
                   dtype=dtype)
    upd = rng.standard_normal((ids.size, d)).astype(np.float32)
    port = _port(table, ids, upd, -0.25)
    np.testing.assert_array_equal(port, _xla(table, ids, upd, -0.25))
    untouched = sorted(set(range(r)) - {0, 3, 5, r - 1})
    np.testing.assert_array_equal(port[untouched], table[untouched])


def test_multidim_ids_and_zipf_runs():
    """(B, T, bag) ids with (B, T, bag, d) updates, as the embedding ops
    pass them, and zipf runs with a long hot head."""
    rng = np.random.default_rng(9)
    r, d = 500, 16
    table = rng.standard_normal((r, d)).astype(np.float32)
    ids = zipf_ids(rng, r, (40, 4, 3), a=1.05)
    upd = rng.standard_normal(ids.shape + (d,)).astype(np.float32)
    assert np.bincount(ids.ravel()).max() > 20  # a long run
    np.testing.assert_array_equal(_port(table, ids, upd, -0.01),
                                  _xla(table, ids, upd, -0.01))


def test_tensor_scale_matches_float_scale():
    """The training step passes -lr as a 0-dim f32 tensor."""
    rng = np.random.default_rng(10)
    table = rng.standard_normal((20, 8)).astype(np.float32)
    ids = rng.integers(0, 20, size=(30,))
    upd = rng.standard_normal((30, 8)).astype(np.float32)
    lr = torch.tensor(0.05, dtype=torch.float32)
    t = torch.from_numpy(table.copy())
    row_update_ref(t, torch.from_numpy(ids), torch.from_numpy(upd), -lr)
    np.testing.assert_array_equal(t.numpy(),
                                  _xla(table, ids, upd, -np.float32(0.05)))


def test_cpu_tensors_launch_no_kernel():
    rng = np.random.default_rng(11)
    table = rng.standard_normal((20, 8)).astype(np.float32)
    ids = rng.integers(-20, 25, size=(30,))
    upd = rng.standard_normal((30, 8)).astype(np.float32)
    before = row_update_cuda.launches
    t = torch.from_numpy(table.copy())
    row_update_cuda(t, torch.from_numpy(ids), torch.from_numpy(upd), 0.3)
    np.testing.assert_array_equal(t.numpy(), _port(table, ids, upd, 0.3))
    assert row_update_cuda.launches == before == 0


def test_rejects_bad_inputs():
    t = torch.zeros(10, 4)
    with pytest.raises(ValueError, match="do not match"):
        row_update_cuda(t, torch.zeros(3, dtype=torch.int64), torch.zeros(3, 5))
    with pytest.raises(TypeError, match="int32 or int64"):
        row_update_cuda(t, torch.zeros(3), torch.zeros(3, 4))
    with pytest.raises(ValueError, match=r"\(R, d\)"):
        row_update_cuda(torch.zeros(10), torch.zeros(3, dtype=torch.int64),
                        torch.zeros(3, 4))
