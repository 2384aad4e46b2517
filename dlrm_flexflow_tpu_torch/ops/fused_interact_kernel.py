"""Fused embedding-bag -> feature-interaction: the plain PyTorch version
and the wrapper of its hand-written Hopper kernel.

Counterpart of ``dlrm_flexflow_tpu/ops/pallas_fused_interact.py``.  The
DLRM hot path gathers per-table embedding rows, pools each bag, and meets
the pooled vectors with the bottom-MLP output in the interaction: ``cat``
(concat) or ``dot`` (pairwise dots).  The kernel
(``csrc/fused_interact.cu``) does all three in one pass without writing
the pooled intermediate to device memory.

Dropped-id rule: ``mask_local_ids`` maps every local id that is negative
or beyond its table's row count to -1; a -1 slot reads nothing and pools
as exact 0.0.  The kernel and the plain version share that encoding.

``fused_interact_cuda`` launches the kernel for tensors on a CUDA device
and runs ``fused_interact_ref`` only for tensors on the CPU; a CUDA tensor
never reaches the plain version through it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _cuda

BF16_NAMES = ("bfloat16", torch.bfloat16)


def mask_local_ids(idx, offsets, row_counts):
    """Per-table LOCAL ids ``(..., T, bag)`` -> flat global row ids, with
    every invalid entry (negative, or >= its table's row count) mapped to
    -1."""
    rc = torch.as_tensor(row_counts, dtype=idx.dtype,
                         device=idx.device)[:, None]
    off = torch.as_tensor(offsets, dtype=idx.dtype,
                          device=idx.device)[:, None]
    valid = (idx >= 0) & (idx < rc)
    return torch.where(valid, idx + off, torch.full_like(idx, -1))


def interact_width(interact: str, num_tables: int, dim: int,
                   bot_dim: int) -> int:
    """Output feature width of the fused op."""
    if interact == "cat":
        return bot_dim + num_tables * dim
    if interact == "dot":
        f = num_tables + 1
        return dim + f * f
    raise ValueError(f"unknown interaction op {interact!r}")


def pool_rows(rows, aggr: str, out_dtype):
    """Bag-pool gathered rows ``(B, T, bag, d)`` -> ``(B, T, d)``: the sum
    over the bag, divided by the bag for ``avg``.  An empty bag pools to
    exact 0.0 in both modes."""
    b, t, bag, d = rows.shape
    if bag == 0:
        return torch.zeros((b, t, d), dtype=out_dtype, device=rows.device)
    pooled = rows.sum(dim=2)
    if aggr == "avg":
        pooled = pooled / bag
    return pooled.to(out_dtype)


def _round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _pairwise_dots(z, compute_dtype):
    """``z @ z^T`` in f32.  Under ``compute_dtype='bfloat16'`` each
    operand is rounded to bf16 first; a product of two bf16 values is
    exact in f32, so this is bf16 operands with f32 accumulation."""
    zt = z.transpose(-1, -2)
    if compute_dtype in BF16_NAMES:
        z, zt = _round_bf16(z), _round_bf16(zt)
    return torch.matmul(z.float(), zt.float())


def interact_features(bottom, pooled, interact: str, compute_dtype=None):
    """The interaction on pooled per-table vectors.  ``bottom`` is
    ``(B, bot_dim)``, ``pooled`` ``(B, T, d)``."""
    b, t, d = pooled.shape
    if interact == "cat":
        return torch.cat([bottom, pooled.reshape(b, t * d)], dim=1)
    if interact == "dot":
        z = torch.cat([bottom[:, None, :], pooled], dim=1)
        zz = _pairwise_dots(z, compute_dtype).to(bottom.dtype)
        return torch.cat([bottom, zz.reshape(b, (t + 1) * (t + 1))], dim=1)
    raise ValueError(f"unknown interaction op {interact!r}")


def masked_pool_interact(rows, gids, bottom, interact: str, aggr: str,
                         out_dtype=torch.float32, compute_dtype=None):
    """Zero the dropped slots (``gids`` < 0), pool, interact."""
    rows = torch.where((gids >= 0)[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    pooled = pool_rows(rows, aggr, out_dtype)
    return interact_features(bottom.to(out_dtype), pooled, interact,
                             compute_dtype)


def fused_interact_ref(table, gids, bottom, *, interact: str = "cat",
                       aggr: str = "sum", out_dtype=torch.float32,
                       compute_dtype=None):
    """The plain version: masked gather -> pool -> interact.  ``gids``
    are pre-masked flat ids (invalid = -1, see ``mask_local_ids``).  Like
    the kernel, it also drops an id >= the table's row count, which
    ``mask_local_ids`` never produces."""
    live = (gids >= 0) & (gids < table.shape[0])
    gids = torch.where(live, gids, torch.full_like(gids, -1))
    rows = table[gids.clamp_min(0).long()]             # (B, T, bag, d)
    return masked_pool_interact(rows, gids, bottom, interact, aggr,
                                out_dtype, compute_dtype)


# ------------------------------------------------------------------ kernel
_SIGNATURES = {
    "ff_fused_interact_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "ff_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_count_lock = threading.Lock()


def fused_interact_cuda(table, gids, bottom, *, interact: str = "cat",
                        aggr: str = "sum", compute_dtype=None):
    """Run the fused forward.  ``table`` (R, d) f32, ``gids`` (B, T, bag)
    int32 pre-masked flat ids, ``bottom`` (B, bot_dim) f32; returns
    (B, width) f32.

    On CUDA tensors this launches the Hopper kernel (and adds one to
    ``fused_interact_cuda.launches``) or raises; on CPU tensors it runs
    ``fused_interact_ref``."""
    if interact not in ("cat", "dot"):
        raise ValueError(f"unknown interaction op {interact!r}")
    if aggr not in ("sum", "avg"):
        raise ValueError(f"unknown aggregation {aggr!r}")
    devices = {table.device, gids.device, bottom.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    if table.device.type == "cpu":
        return fused_interact_ref(table, gids, bottom, interact=interact,
                                  aggr=aggr, compute_dtype=compute_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"no fused_interact kernel for {table.device}")
    if (table.dtype != torch.float32 or bottom.dtype != torch.float32
            or gids.dtype != torch.int32):
        raise TypeError(
            f"fused_interact kernel takes an f32 table and bottom and int32 "
            f"ids, got {table.dtype}, {bottom.dtype}, {gids.dtype}")
    if table.dim() != 2 or gids.dim() != 3 or bottom.dim() != 2:
        raise ValueError(
            f"expected table (R, d), gids (B, T, bag), bottom (B, bot); got "
            f"{tuple(table.shape)}, {tuple(gids.shape)}, "
            f"{tuple(bottom.shape)}")
    if not (table.is_contiguous() and gids.is_contiguous()
            and bottom.is_contiguous()):
        raise ValueError("fused_interact kernel takes contiguous tensors")
    rows_n, dim = table.shape
    bsz, t, bag = gids.shape
    bot_dim = bottom.shape[1]
    if bottom.shape[0] != bsz:
        raise ValueError(f"bottom has {bottom.shape[0]} rows, ids {bsz}")
    if interact == "dot" and bot_dim != dim:
        raise ValueError(
            f"dot interaction needs bottom width {dim}, got {bot_dim}")
    if rows_n >= 2 ** 31:
        raise ValueError(f"table of {rows_n} rows overflows int32 ids")
    width = interact_width(interact, t, dim, bot_dim)
    out = torch.empty((bsz, width), dtype=torch.float32, device=table.device)
    if bsz == 0:
        return out
    lib = _cuda.load("fused_interact", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ff_fused_interact_fwd(
            table.data_ptr(), gids.data_ptr(), bottom.data_ptr(),
            out.data_ptr(), bsz, t, bag, dim, bot_dim, rows_n,
            int(interact == "dot"), int(aggr == "avg"),
            int(compute_dtype in BF16_NAMES), stream)
    if err:
        msg = lib.ff_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_interact kernel launch failed: {msg}")
    with _count_lock:
        fused_interact_cuda.launches += 1
    return out


fused_interact_cuda.launches = 0
