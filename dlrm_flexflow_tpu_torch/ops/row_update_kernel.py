"""In-place sorted row update: the plain PyTorch version and the wrappers
of its two hand-written Hopper kernels.

Counterpart of ``sparse_row_update`` and ``_row_update_pallas`` in
``dlrm_flexflow_tpu/ops/pallas_scatter.py``:

    table[ids[k]] += scale * upd[k]          (duplicates accumulate)

in place.  The id contract is ``.at[].add``'s: an id in ``[-R, 0)`` wraps
to ``id + R``, any other id outside ``[0, R)`` is dropped.  Duplicates
accumulate in the ids' stable order starting from the row as it was,
``((t + u1) + u2) + ...``, so the result is deterministic and bit-equal
to ``.at[].add`` on the CPU and to the TPU kernel.  ``index_add_`` on the
card gives the same sum in an atomic order that changes from run to run,
so the port never calls it for this.

The scaled update ``u`` is ``f32(scale) * upd`` formed in f32 (f64 for
f64 updates) and rounded once to the update's own dtype, then cast to the
table's: what ``scale * upd`` gives for f32 updates, and for bf16 updates
with a float scale.  (ATen rounds a 0-dim CUDA tensor scale to a bf16
update's dtype before it multiplies; the port does not.)  The kernel takes
f32 and bf16 updates, the dtypes its callers pass.

Tables are f32 or bf16 (``FFConfig.embedding_dtype``).  On a bf16 table
the scaled update is rounded to bf16, as the JAX wrapper's
``(scale * updates).astype(table.dtype)`` rounds it, and each add of a
duplicate run is rounded to bf16, as the TPU kernel's bf16 accumulator
rounds it: the plain version's ``index_add_`` on a bf16 table adds in f32
and rounds once per add, and it adds a run's slots one rank at a time, so
it gives the same bits.  Any other table dtype raises on the card.

On the card ``row_update_cuda`` makes two launches: the prepare-and-sort
kernel (``csrc/row_update_prep.cu``), which applies the id contract and
sorts the ids stably, and the update kernel (``csrc/row_update.cu``),
which scales as it loads.  For tensors on the CPU it runs
``row_update_ref``; a CUDA tensor never reaches the plain version
through it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _cuda

#: the dtypes an embedding table is stored in; the row-update, bag and
#: row-set kernels each take a table of either
TABLE_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's code for a table or an update dtype
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def validate_row_update(table, ids, upd):
    """Validate shapes, dtypes and devices; return the flat ids ``(n,)``
    and the updates ``(n, d)``, views where the inputs are contiguous."""
    if table.dim() != 2:
        raise ValueError(f"expected a (R, d) table, got {tuple(table.shape)}")
    rows_n, dim = table.shape
    if rows_n >= 2 ** 31:
        raise ValueError(f"table of {rows_n} rows overflows int32 ids")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    devices = {table.device, ids.device, upd.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{sorted(map(str, devices))}")
    if upd.shape != ids.shape + (dim,):
        raise ValueError(f"updates {tuple(upd.shape)} do not match ids "
                         f"{tuple(ids.shape)} and d = {dim}")
    if ids.numel() >= 2 ** 31:
        raise ValueError(f"{ids.numel()} updates overflow int32")
    return ids.reshape(-1), upd.reshape(-1, dim)


def prepare_row_update_ref(ids, rows_n):
    """The plain version of the prepare-and-sort kernel: ``(keys, order)``,
    int32 both.  A key is the id with ``.at[].add``'s wrap applied, or
    ``rows_n`` for a dropped id; the keys are sorted stably (dropped slots
    last) and ``order`` is the slot each sorted key came from."""
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + rows_n, flat)
    live = (flat >= 0) & (flat < rows_n)
    keys = torch.where(live, flat, torch.full_like(flat, rows_n))
    keys, order = torch.sort(keys.to(torch.int32), stable=True)
    return keys, order.to(torch.int32)


def scaled_updates(upd, scale, dtype):
    """``scale * upd`` as the kernel forms it (module docstring), cast to
    ``dtype``: ``(n, d)`` contiguous."""
    work = torch.float64 if upd.dtype == torch.float64 else torch.float32
    return (upd.to(work) * scale).to(upd.dtype).to(dtype).contiguous()


def row_update_ref(table, ids, upd, scale=1.0):
    """The plain version, in place: ``table[ids] += scale * upd``.

    Deterministic on the CPU and on the card: after the stable sort each
    slot's rank within its run is computed, and for rank 0, 1, ... one
    ``index_add_`` adds the slots of that rank, whose ids are distinct.
    Returns ``table``."""
    flat, upd = validate_row_update(table, ids, upd)
    rows_n = table.shape[0]
    keys, order = prepare_row_update_ref(flat, rows_n)
    u = scaled_updates(upd, scale, table.dtype)
    n = keys.numel()
    if n == 0:
        return table
    pos = torch.arange(n, device=table.device)
    start = torch.ones(n, dtype=torch.bool, device=table.device)
    start[1:] = keys[1:] != keys[:-1]
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                         dim=0).values
    live = keys < rows_n
    rank, by_rank = torch.sort((pos - first)[live], stable=True)
    rows = keys[live].long()[by_rank]
    vals = u[order[live].long()[by_rank]]
    lo = 0
    with torch.no_grad():
        for count in torch.bincount(rank).tolist():  # one host sync
            table.index_add_(0, rows[lo:lo + count], vals[lo:lo + count])
            lo += count
    return table


# ------------------------------------------------------------------ kernels
_PREP_SIGNATURES = {
    "ff_row_update_prep": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_void_p] * 5),
    "ff_row_update_prep_tile": (ctypes.c_int, []),
    "ff_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_SIGNATURES = {
    "ff_row_update": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "ff_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_count_lock = threading.Lock()


def _raise_on(lib, err, what):
    if err:
        msg = lib.ff_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def prepare_row_update_cuda(ids, rows_n):
    """``prepare_row_update_ref``'s ``(keys, order)`` from the Hopper
    kernel (one launch, adding one to ``prepare_row_update_cuda.launches``)
    for CUDA ids; for CPU ids the plain version."""
    if ids.device.type == "cpu":
        return prepare_row_update_ref(ids, rows_n)
    if ids.device.type != "cuda":
        raise ValueError(f"no row_update_prep kernel for {ids.device}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    n = ids.numel()
    if not 0 <= rows_n < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{n} ids into {rows_n} rows overflow int32")
    flat = ids.reshape(-1).contiguous()
    keys = torch.empty(n, dtype=torch.int32, device=ids.device)
    order = torch.empty(n, dtype=torch.int32, device=ids.device)
    if n == 0:
        return keys, order
    lib = _cuda.load("row_update_prep", _PREP_SIGNATURES)
    keys_tmp = order_tmp = None
    if n > lib.ff_row_update_prep_tile():  # tiles over global scratch
        keys_tmp = torch.empty_like(keys)
        order_tmp = torch.empty_like(order)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ff_row_update_prep(
            flat.data_ptr(), int(flat.dtype == torch.int64), n, rows_n,
            keys.data_ptr(), order.data_ptr(),
            keys_tmp.data_ptr() if keys_tmp is not None else None,
            order_tmp.data_ptr() if order_tmp is not None else None, stream)
    _raise_on(lib, err, "row_update_prep")
    with _count_lock:
        prepare_row_update_cuda.launches += 1
    return keys, order


def _scale_args(scale, device):
    """(pointer, value) for the kernel: a 0-dim f32 tensor on ``device``
    is read there (no host sync); a number or a CPU 0-dim tensor is
    passed by value."""
    if not isinstance(scale, torch.Tensor):
        return None, float(scale)
    if scale.dim() != 0:
        raise ValueError(f"scale must be a number or a 0-dim tensor, got "
                         f"shape {tuple(scale.shape)}")
    if scale.device.type == "cpu":
        return None, float(scale)
    if scale.device != device or scale.dtype != torch.float32:
        raise TypeError(f"a tensor scale on the card must be f32 on "
                        f"{device}, got {scale.dtype} on {scale.device}")
    return scale.data_ptr(), 0.0


def _launch_args(table, n, scale):
    """The update kernel's limits, checked: its row offsets are 32-bit;
    returns ``_scale_args``."""
    if n * table.shape[1] >= 2 ** 32:
        raise ValueError(f"{n} updates of d = {table.shape[1]} overflow "
                         f"the kernel's 32-bit offsets")
    return _scale_args(scale, table.device)


def launch_row_update(table, keys, order, upd, scale) -> None:
    """Launch the update kernel on prepared keys and order (from the
    prepare-and-sort kernel) and the unscaled ``(n, d)`` updates in their
    original slot order, on the current stream, without counting it.
    ``row_update_cuda`` is the entry point; this is its launch step,
    exposed so that the kernel can be timed apart from the sort."""
    n = keys.numel()
    if n:
        _launch_update(table, keys, order, upd,
                       *_launch_args(table, n, scale))


def _launch_update(table, keys, order, upd, ptr, value) -> None:
    rows_n, dim = table.shape
    n = keys.numel()
    esize, tsize = upd.element_size(), table.element_size()
    vec = next(v for v in (4, 2, 1)
               if v == 1 or (dim >= 32 * v and dim % v == 0
                             and table.data_ptr() % (tsize * v) == 0
                             and upd.data_ptr() % (esize * v) == 0))
    lib = _cuda.load("row_update", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ff_row_update(table.data_ptr(),
                                _KERNEL_DTYPES[table.dtype], keys.data_ptr(),
                                order.data_ptr(), upd.data_ptr(),
                                _KERNEL_DTYPES[upd.dtype], ptr, value, n,
                                dim, rows_n, vec, stream)
    _raise_on(lib, err, "row_update")


def row_update_cuda(table, ids, upd, scale=1.0):
    """``table[ids] += scale * upd`` in place; returns ``table``.

    ``table`` (R, d) f32 or bf16 contiguous, ``ids`` (...) int32 or int64,
    ``upd`` (..., d) f32 or bf16; ``scale`` a number or a 0-dim tensor
    (f32 when on the card).  On CUDA tensors this launches the prepare-and-sort
    kernel and the update kernel (adding one to
    ``row_update_cuda.launches``) or raises; on CPU tensors it runs
    ``row_update_ref``."""
    if table.device.type == "cpu":
        return row_update_ref(table, ids, upd, scale)
    if table.device.type != "cuda":
        raise ValueError(f"no row_update kernel for {table.device}")
    if table.dtype not in TABLE_DTYPES or upd.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"row_update kernel takes an f32 or bf16 table and "
                        f"f32 or bf16 updates, got {table.dtype}, "
                        f"{upd.dtype}")
    if not table.is_contiguous():
        raise ValueError("row_update kernel updates a contiguous table")
    flat, upd = validate_row_update(table, ids, upd)
    args = _launch_args(table, flat.numel(), scale)  # before any launch
    if flat.numel() == 0:
        return table
    keys, order = prepare_row_update_cuda(flat, table.shape[0])
    _launch_update(table, keys, order, upd.contiguous(), *args)
    with _count_lock:
        row_update_cuda.launches += 1
    return table


prepare_row_update_cuda.launches = 0
row_update_cuda.launches = 0
