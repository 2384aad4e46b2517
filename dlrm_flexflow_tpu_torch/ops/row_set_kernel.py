"""In-place row set: the plain PyTorch version and the wrapper of its
hand-written Hopper kernel.

Counterpart of ``_row_set_pallas`` in
``dlrm_flexflow_tpu/ops/pallas_scatter.py``:

    table[ids[k]] = rows[k]          (distinct ids)

in place.  The id contract is the TPU kernel's own: an id ``< 0`` or
``>= R`` is dropped (neither read nor written).  That is not
``.at[].set(mode="drop")``, which wraps -1 to the last row; the two agree
on every id a caller produces (distinct rows in ``[0, R)`` and the
sentinel ``R``).  Distinct ids are the caller's contract: neither the
kernel nor the plain version checks it.

``row_set_cuda`` launches the kernel (``csrc/row_set.cu``) for tensors on
a CUDA device and runs ``row_set_ref`` only for tensors on the CPU; a
CUDA tensor never reaches the plain version through it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _cuda


def prepare_row_set(table, ids, rows):
    """Validate shapes, types and devices; return ``(ids, rows)`` as int32
    ids (an int64 id outside ``[0, R)`` becomes -1 before the narrowing,
    so it stays dropped) and ``(n, d)`` rows in the table's dtype."""
    if table.dim() != 2:
        raise ValueError(f"expected a (R, d) table, got {tuple(table.shape)}")
    rows_n, dim = table.shape
    if rows_n >= 2 ** 31:
        raise ValueError(f"table of {rows_n} rows overflows int32 ids")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if ids.dim() != 1:
        raise ValueError(f"expected (n,) ids, got {tuple(ids.shape)}")
    if not rows.is_floating_point():
        raise TypeError(f"rows must be floating point, got {rows.dtype}")
    if tuple(rows.shape) != (ids.shape[0], dim):
        raise ValueError(f"rows {tuple(rows.shape)} do not match ids "
                         f"{tuple(ids.shape)} and d = {dim}")
    devices = {table.device, ids.device, rows.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{sorted(map(str, devices))}")
    if ids.dtype == torch.int64:
        live = (ids >= 0) & (ids < rows_n)
        ids = torch.where(live, ids, torch.full_like(ids, -1)).to(torch.int32)
    return ids.contiguous(), rows.to(table.dtype).contiguous()


def row_set_ref(table, ids, rows):
    """The plain version, in place: ``table[ids] = rows`` over the live
    ids (``0 <= id < R``), each written once.  Returns ``table``."""
    ids, rows = prepare_row_set(table, ids, rows)
    live = (ids >= 0) & (ids < table.shape[0])
    with torch.no_grad():
        table[ids[live].long()] = rows[live]
    return table


# ------------------------------------------------------------------ kernel
_SIGNATURES = {
    "ff_row_set": (
        ctypes.c_int,
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p]),
    "ff_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_count_lock = threading.Lock()


def launch_row_set(table, ids, rows) -> None:
    """Launch the kernel on prepared inputs (``prepare_row_set``) on the
    current stream, without counting it.  ``row_set_cuda`` is the entry
    point; this is its launch step, exposed so that the kernel can be
    timed alone."""
    rows_n, dim = table.shape
    n = ids.numel()
    if n == 0:
        return
    vec4 = int(dim % 4 == 0 and table.data_ptr() % 16 == 0
               and rows.data_ptr() % 16 == 0)
    lib = _cuda.load("row_set", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ff_row_set(table.data_ptr(), ids.data_ptr(),
                             rows.data_ptr(), n, dim, rows_n, vec4, stream)
    if err:
        msg = lib.ff_cuda_error_string(err).decode()
        raise RuntimeError(f"row_set kernel launch failed: {msg}")


def row_set_cuda(table, ids, rows):
    """``table[ids] = rows`` in place for distinct ids, ids ``< 0`` or
    ``>= R`` dropped; returns ``table``.

    ``table`` (R, d) contiguous, ``ids`` (n,) int32 or int64, ``rows``
    (n, d) float.  On CUDA tensors this launches the Hopper kernel
    (adding one to ``row_set_cuda.launches``) or raises; on CPU tensors it
    runs ``row_set_ref``."""
    if table.device.type == "cpu":
        return row_set_ref(table, ids, rows)
    if table.device.type != "cuda":
        raise ValueError(f"no row_set kernel for {table.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"row_set kernel takes an f32 table, got "
                        f"{table.dtype}")
    if not table.is_contiguous():
        raise ValueError("row_set kernel sets rows of a contiguous table")
    ids, rows = prepare_row_set(table, ids, rows)
    if ids.numel() == 0:
        return table
    launch_row_set(table, ids, rows)
    with _count_lock:
        row_set_cuda.launches += 1
    return table


row_set_cuda.launches = 0
