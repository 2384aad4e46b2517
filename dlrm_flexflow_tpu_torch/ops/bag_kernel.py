"""Embedding bag: the plain PyTorch version and the wrapper of its
hand-written Hopper kernel.

Counterpart of ``embedding_bag_pallas`` in
``dlrm_flexflow_tpu/ops/pallas_embedding.py``: a ``(R, d)`` table and
``(B, bag)`` ids give ``(B, d)``, the rows of each bag summed in bag
order, ``((r0 + r1) + r2) + ...``, as the TPU kernel sums them; ``avg``
then divides the sum by the bag (a true division).  Ids follow
``jnp.take``'s rule, as the port's plain forward reads it
(``embedding.take_rows``): an id in ``[-R, 0)`` wraps, any other id
outside ``[0, R)`` reads a row of NaN.

``embedding_bag_cuda`` launches the kernel (``csrc/embedding_bag.cu``)
for tensors on a CUDA device and runs ``embedding_bag_ref`` only for
tensors on the CPU; a CUDA tensor never reaches the plain version
through it.  The backward (``ops/embedding.py::EmbeddingBagFn``) is the
row-update kernel applied to a zero table.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _cuda
from .fused_interact_kernel import divide

BAG_MODES = ("sum", "avg")


def _check(table, ids, mode):
    if mode not in BAG_MODES:
        raise ValueError(f"mode must be one of {BAG_MODES}, got {mode!r}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"expected table (R, d) and ids (B, bag), got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"inputs on different devices: {table.device}, "
                         f"{ids.device}")


def embedding_bag_ref(table, ids, mode: str = "sum"):
    """The plain version: ``(R, d)`` x ``(B, bag)`` -> ``(B, d)``, summed
    in bag order (a loop, not ``sum``, whose reduction order is not the
    bag's), divided by the bag for ``avg``."""
    from .embedding import take_rows
    _check(table, ids, mode)
    rows = take_rows(table, ids)                     # (B, bag, d)
    bsz, bag = ids.shape
    acc = (rows[:, 0] if bag else
           torch.zeros((bsz, table.shape[1]), dtype=table.dtype,
                       device=table.device))
    for j in range(1, bag):
        acc = acc + rows[:, j]
    return divide(acc, bag) if mode == "avg" else acc


# ------------------------------------------------------------------ kernel
_SIGNATURES = {
    "ff_embedding_bag": (
        ctypes.c_int,
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "ff_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_count_lock = threading.Lock()


def embedding_bag_cuda(table, ids, mode: str = "sum"):
    """The bag forward.  ``table`` (R, d) f32, ``ids`` (B, bag) int32 or
    int64; returns (B, d) f32.

    On CUDA tensors this launches the Hopper kernel (and adds one to
    ``embedding_bag_cuda.launches``) or raises; on CPU tensors it runs
    ``embedding_bag_ref``."""
    _check(table, ids, mode)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, mode)
    if table.device.type != "cuda":
        raise ValueError(f"no embedding_bag kernel for {table.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"embedding_bag kernel takes an f32 table, got "
                        f"{table.dtype}")
    if not table.is_contiguous():
        raise ValueError("embedding_bag kernel reads a contiguous table")
    rows_n, dim = table.shape
    bsz, bag = ids.shape
    ids = ids.long().contiguous()
    out = torch.empty((bsz, dim), dtype=torch.float32, device=table.device)
    if bsz == 0 or dim == 0:
        return out
    vec4 = int(dim % 4 == 0 and table.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    lib = _cuda.load("embedding_bag", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ff_embedding_bag(table.data_ptr(), ids.data_ptr(),
                                   out.data_ptr(), bsz, bag, dim, rows_n,
                                   int(mode == "avg"), vec4, stream)
    if err:
        msg = lib.ff_cuda_error_string(err).decode()
        raise RuntimeError(f"embedding_bag kernel launch failed: {msg}")
    with _count_lock:
        embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
