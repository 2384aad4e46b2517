"""The port's in-place row set (dlrm_flexflow_tpu_torch/ops/row_set_kernel.py)
against the JAX package on the CPU: the plain PyTorch version
``row_set_ref`` against the Pallas row-set kernel ``_row_set_pallas`` run
in interpret mode, on the cases the JAX package pins for it
(``tests/test_pallas_kernels.py::TestRowSetKernel``), and against
``.at[].set(mode="drop")`` on the ids a caller produces (distinct rows in
``[0, R)`` and the sentinel ``R``).

Every comparison is bit-exact (``assert_array_equal``): a row set moves
values and rounds nothing.

The CUDA kernel runs only on the card; chip_smoke.py holds it against the
plain version there.  Here the wrapper receives CPU tensors, so it runs
the plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlrm_flexflow_tpu.ops.pallas_scatter import _row_set_pallas
from dlrm_flexflow_tpu_torch.ops.row_set_kernel import (row_set_cuda,
                                                       row_set_ref)
from dlrm_flexflow_tpu_torch.ops.slotting import slot_rows


def _port(table, ids, rows, fn=row_set_ref):
    t = torch.from_numpy(table.copy())
    out = fn(t, torch.from_numpy(ids), torch.from_numpy(rows))
    assert out is t  # in place
    return t.numpy()


def _interpret(table, ids, rows):
    return np.asarray(_row_set_pallas(jnp.asarray(table), jnp.asarray(ids),
                                      jnp.asarray(rows), interpret=True))


@pytest.mark.parametrize("n,rows_n,seed", [
    (32, 4096, 0),       # a multiple of the TPU kernel's 16-slot block
    (40, 4096, 1),       # padded to a block multiple there
    (16, 64, 2),         # dense-ish touch
    (48, 4096, 3),       # sentinel holes at the tail
])
def test_plain_matches_interpret_kernel_and_drop_set(n, rows_n, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows_n, 128)).astype(np.float32)
    live = rng.choice(rows_n, size=n - n // 4, replace=False)
    ids = np.full((n,), rows_n, np.int32)      # sentinel-padded tail
    ids[:live.size] = np.sort(live)
    rows = rng.standard_normal((n, 128)).astype(np.float32)
    port = _port(table, ids, rows)
    np.testing.assert_array_equal(port, _interpret(table, ids, rows))
    want = jnp.asarray(table).at[jnp.asarray(ids)].set(jnp.asarray(rows),
                                                       mode="drop")
    np.testing.assert_array_equal(port, np.asarray(want))


def test_negative_ids_dropped_like_the_kernel():
    """-1 and int32 min are dropped, as the TPU kernel drops them (where
    ``.at[].set(mode="drop")`` would wrap -1 to the last row)."""
    rng = np.random.default_rng(7)
    rows_n, n = 256, 32
    table = rng.standard_normal((rows_n, 128)).astype(np.float32)
    ids = np.full((n,), rows_n, np.int32)
    ids[:8] = np.sort(rng.choice(rows_n, size=8, replace=False))
    ids[8:16] = -1
    ids[16] = np.iinfo(np.int32).min
    rows = rng.standard_normal((n, 128)).astype(np.float32)
    port = _port(table, ids, rows)
    np.testing.assert_array_equal(port, _interpret(table, ids, rows))
    want = table.copy()
    want[ids[:8]] = rows[:8]
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(port[-1], table[-1])  # not wrapped


@pytest.mark.parametrize("d", [16, 64, 128])
def test_cache_writeback_plans_match_drop_set(d):
    """The plans the epoch cache writes back with: ``rowof`` from
    ``slot_rows`` (distinct rows ascending, sentinel holes), some of them
    padded further to a lane-pack multiple."""
    rng = np.random.default_rng(d)
    rows_n = 3000
    table = rng.standard_normal((rows_n, d)).astype(np.float32)
    occ = rng.integers(0, 200, size=(37, 3))  # repeats: sentinel holes
    rowof, _ = slot_rows(torch.from_numpy(occ), rows_n)
    ids = np.concatenate([rowof.numpy(), np.full(3, rows_n, np.int32)])
    rows = rng.standard_normal((ids.size, d)).astype(np.float32)
    assert (ids == rows_n).sum() > 3
    want = jnp.asarray(table).at[jnp.asarray(ids)].set(jnp.asarray(rows),
                                                       mode="drop")
    np.testing.assert_array_equal(_port(table, ids, rows), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_wrapper_on_cpu_runs_the_plain_version(dtype):
    rng = np.random.default_rng(9)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    ids = np.array([3, 64, 10, -5, 2 ** 31 + 3 if dtype == np.int64 else 7],
                   dtype=dtype)
    rows = rng.standard_normal((5, 8)).astype(np.float32)
    before = row_set_cuda.launches
    got = _port(table, ids, rows, row_set_cuda)
    assert row_set_cuda.launches == before  # CPU tensors: no launch
    want = table.copy()
    for k, i in enumerate(ids.astype(np.int64)):
        if 0 <= i < 64:
            want[i] = rows[k]
    np.testing.assert_array_equal(got, want)


def test_no_rows_leaves_the_table():
    table = np.random.default_rng(10).standard_normal((16, 4)).astype(
        np.float32)
    got = _port(table, np.zeros(0, np.int32), np.zeros((0, 4), np.float32),
                row_set_cuda)
    np.testing.assert_array_equal(got, table)


@pytest.mark.parametrize("case,exc", [
    ("table_1d", ValueError), ("ids_2d", ValueError),
    ("ids_float", TypeError), ("rows_int", TypeError),
    ("rows_shape", ValueError), ("devices", ValueError)])
def test_wrapper_validates_its_inputs(case, exc):
    table = torch.zeros((8, 4))
    ids = torch.tensor([1, 2], dtype=torch.int32)
    rows = torch.ones((2, 4))
    if case == "table_1d":
        table = torch.zeros(8)
    elif case == "ids_2d":
        ids = ids.reshape(1, 2)
    elif case == "ids_float":
        ids = ids.float()
    elif case == "rows_int":
        rows = rows.int()
    elif case == "rows_shape":
        rows = torch.ones((3, 4))
    else:
        rows = rows.to("meta")
    with pytest.raises(exc):
        row_set_cuda(table, ids, rows)
