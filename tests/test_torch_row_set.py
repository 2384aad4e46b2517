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
the plain version and launches nothing.  What the wrapper decides for
the kernel, its launch plan (``row_set_plan``: the word, the lanes on a
row, the rows a warp pass covers, the grid), is pure Python and is
checked here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlrm_flexflow_tpu.ops.pallas_scatter import _row_set_pallas
from dlrm_flexflow_tpu_torch.ops.row_set_kernel import (BLOCKS_PER_SM,
                                                       row_set_cuda,
                                                       row_set_plan,
                                                       row_set_ref)
from dlrm_flexflow_tpu_torch.ops.slotting import slot_rows

#: the H100 SXM's streaming multiprocessors
H100_SMS = 132


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


def _bits(a):
    """The raw bits of an f32 or bf16 array, for exact compares."""
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype,d", [
    ("bfloat16", 64), ("bfloat16", 16), ("bfloat16", 1000),
    ("float32", 16), ("float32", 1000), ("bfloat16", 3), ("float32", 5)])
def test_plain_matches_interpret_kernel_on_bf16_and_wide_rows(dtype, d):
    """bf16 tables, rows of 64 B to 4,000 B and the odd widths that take
    the kernel's 2- and 4-byte words: ``row_set_ref`` against the
    interpret-mode kernel and ``.at[].set(mode="drop")``, bit for bit.
    Interpret mode takes every width here, so both references run."""
    rng = np.random.default_rng(d)
    rows_n, n = 300, 70
    np_dtype = jnp.dtype(dtype)
    table = rng.standard_normal((rows_n, d)).astype(np_dtype)
    ids = np.full((n,), rows_n, np.int32)
    ids[:50] = rng.choice(rows_n, size=50, replace=False)
    rng.shuffle(ids)
    rows = rng.standard_normal((n, d)).astype(np_dtype)
    t = torch.from_numpy(_bits(table).copy()).view(getattr(torch, dtype))
    v = torch.from_numpy(_bits(rows).copy()).view(getattr(torch, dtype))
    assert row_set_ref(t, torch.from_numpy(ids), v) is t
    port = t.view(torch.int16 if np_dtype.itemsize == 2
                  else torch.int32).numpy().view(_bits(table).dtype)
    np.testing.assert_array_equal(port, _bits(_interpret(table, ids, rows)))
    want = jnp.asarray(table).at[jnp.asarray(ids)].set(jnp.asarray(rows),
                                                       mode="drop")
    np.testing.assert_array_equal(port, _bits(want))


@pytest.mark.parametrize("d", [3, 5, 16, 64, 128, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_offset", [0, 1, 2])
def test_launch_plan(d, dtype, rows_offset):
    """The kernel's launch plan for rows that start 0, 1 or 2 elements
    into their storage: the widest word (16, 4, 2 bytes) that divides
    the row's bytes and both addresses, never one that does not; every
    lane of a warp on a pass of 32 words; one block per four 32-slot
    tiles, at most ``BLOCKS_PER_SM`` blocks an SM."""
    table = torch.zeros((64, d), dtype=dtype)
    rows = torch.zeros((40 * d + rows_offset,), dtype=dtype)[rows_offset:]
    rows = rows.view(40, d)
    row_bytes = d * table.element_size()
    ptrs = (table.data_ptr(), rows.data_ptr())
    for n, blocks in ((1, 1), (31, 1), (33, 1), (129, 2), (16_384, 128),
                      (131_072, H100_SMS * BLOCKS_PER_SM),
                      (131_071, H100_SMS * BLOCKS_PER_SM)):
        plan = row_set_plan(n, row_bytes, *ptrs, H100_SMS)
        assert plan.blocks == blocks
    want = max(w for w in (16, 4, 2)
               if row_bytes % w == 0 and all(p % w == 0 for p in ptrs))
    assert plan.word == want
    assert plan.words * plan.word == row_bytes
    assert plan.lanes_per_row == min(32, plan.words)
    assert plan.rows_per_pass * plan.words == 32
    if rows_offset == 0 and row_bytes % 16 == 0:
        assert plan.word == 16
    if rows_offset and dtype == torch.float32:
        assert plan.word == 4  # 4 or 8 bytes in, on a 4-byte row multiple
    if rows_offset == 1 and dtype == torch.bfloat16:
        assert plan.word == 2
    if d == 64 and rows_offset == 0:  # the main path: every lane works
        assert plan.lanes_per_row * plan.rows_per_pass == 32
        assert plan.rows_per_pass == (4 if dtype == torch.bfloat16 else 2)


@pytest.mark.parametrize("row_bytes,table_ptr,rows_ptr,word", [
    (256, 0x1000, 0x2000, 16), (256, 0x1000, 0x2004, 4),
    (256, 0x1004, 0x2000, 4), (256, 0x1002, 0x2000, 2),
    (6, 0x1000, 0x2000, 2), (20, 0x1000, 0x2000, 4),
    (4000, 0x1000, 0x2000, 16), (4000, 0x1000, 0x2008, 4)])
def test_launch_plan_word_divides_bytes_and_both_addresses(
        row_bytes, table_ptr, rows_ptr, word):
    plan = row_set_plan(100, row_bytes, table_ptr, rows_ptr, H100_SMS)
    assert plan.word == word
    assert row_bytes % word == table_ptr % word == rows_ptr % word == 0


@pytest.mark.parametrize("args", [(0, 256, 0, 0), (8, 0, 0, 0),
                                  (8, 3, 0, 0), (8, 256, 1, 0)])
def test_launch_plan_refuses_what_no_word_moves(args):
    with pytest.raises(ValueError):
        row_set_plan(*args, H100_SMS)
