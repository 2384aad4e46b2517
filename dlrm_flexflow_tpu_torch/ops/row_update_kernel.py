"""In-place sorted row update: the plain PyTorch version and the wrapper
of its hand-written Hopper kernel.

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

``row_update_cuda`` launches the kernel (``csrc/row_update.cu``) for
tensors on a CUDA device and runs ``row_update_ref`` only for tensors on
the CPU; a CUDA tensor never reaches the plain version through it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _cuda


def prepare_row_update(table, ids, upd, scale):
    """Validate shapes and devices; return ``(sorted_ids, order, u)``:
    the int32 ids with the wrap applied and every dropped id at -1,
    sorted stably; the permutation that sorted them; and the scaled f32
    updates ``(n, d)`` in the original slot order."""
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
    flat = ids.reshape(-1).long()
    if upd.shape != ids.shape + (dim,):
        raise ValueError(f"updates {tuple(upd.shape)} do not match ids "
                         f"{tuple(ids.shape)} and d = {dim}")
    # the scaled updates exactly as sparse_row_update forms them
    u = (scale * upd.reshape(-1, dim)).to(table.dtype).contiguous()
    flat = torch.where(flat < 0, flat + rows_n, flat)
    live = (flat >= 0) & (flat < rows_n)
    gids = torch.where(live, flat, torch.full_like(flat, -1))
    sorted_ids, order = torch.sort(gids.to(torch.int32), stable=True)
    return sorted_ids, order, u


def row_update_ref(table, ids, upd, scale=1.0):
    """The plain version, in place: ``table[ids] += scale * upd``.

    Deterministic on the CPU and on the card: after the stable sort each
    slot's rank within its run is computed, and for rank 0, 1, ... one
    ``index_add_`` adds the slots of that rank, whose ids are distinct.
    Returns ``table``."""
    sorted_ids, order, u = prepare_row_update(table, ids, upd, scale)
    n = sorted_ids.numel()
    if n == 0:
        return table
    pos = torch.arange(n, device=table.device)
    start = torch.ones(n, dtype=torch.bool, device=table.device)
    start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                         dim=0).values
    live = sorted_ids >= 0
    rank, by_rank = torch.sort((pos - first)[live], stable=True)
    rows = sorted_ids[live].long()[by_rank]
    vals = u[order[live][by_rank]]
    lo = 0
    with torch.no_grad():
        for count in torch.bincount(rank).tolist():  # one host sync
            table.index_add_(0, rows[lo:lo + count], vals[lo:lo + count])
            lo += count
    return table


# ------------------------------------------------------------------ kernel
_SIGNATURES = {
    "ff_row_update": (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p]),
    "ff_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_count_lock = threading.Lock()


def launch_row_update(table, sorted_ids, order, u) -> None:
    """Launch the kernel on prepared inputs (``prepare_row_update``) on the
    current stream, without counting it.  ``row_update_cuda`` is the
    entry point; this is its launch step, exposed so that the kernel can
    be timed apart from the sort."""
    rows_n, dim = table.shape
    n = sorted_ids.numel()
    if n == 0:
        return
    vec4 = int(dim % 4 == 0 and table.data_ptr() % 16 == 0
               and u.data_ptr() % 16 == 0)
    lib = _cuda.load("row_update", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ff_row_update(table.data_ptr(), sorted_ids.data_ptr(),
                                order.data_ptr(), u.data_ptr(), n, dim,
                                rows_n, vec4, stream)
    if err:
        msg = lib.ff_cuda_error_string(err).decode()
        raise RuntimeError(f"row_update kernel launch failed: {msg}")


def row_update_cuda(table, ids, upd, scale=1.0):
    """``table[ids] += scale * upd`` in place; returns ``table``.

    ``table`` (R, d) f32 contiguous, ``ids`` (...) int32 or int64, ``upd``
    (..., d) float; ``scale`` a float or a 0-dim tensor on the table's
    device.  On CUDA tensors this sorts the ids, launches the Hopper
    kernel (adding one to ``row_update_cuda.launches``) or raises; on CPU
    tensors it runs ``row_update_ref``."""
    if table.device.type == "cpu":
        return row_update_ref(table, ids, upd, scale)
    if table.device.type != "cuda":
        raise ValueError(f"no row_update kernel for {table.device}")
    if table.dtype != torch.float32 or not upd.is_floating_point():
        raise TypeError(f"row_update kernel takes an f32 table and float "
                        f"updates, got {table.dtype}, {upd.dtype}")
    if not table.is_contiguous():
        raise ValueError("row_update kernel updates a contiguous table")
    sorted_ids, order, u = prepare_row_update(table, ids, upd, scale)
    if sorted_ids.numel() >= 2 ** 31:
        raise ValueError(f"{sorted_ids.numel()} updates overflow int32")
    if sorted_ids.numel() == 0:
        return table
    launch_row_update(table, sorted_ids, order, u)
    with _count_lock:
        row_update_cuda.launches += 1
    return table


row_update_cuda.launches = 0
