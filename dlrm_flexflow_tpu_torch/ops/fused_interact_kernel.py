"""Fused embedding-bag -> feature-interaction, forward and backward: the
plain PyTorch versions and the wrappers of their hand-written Hopper
kernels.

Counterpart of ``dlrm_flexflow_tpu/ops/pallas_fused_interact.py``.  The
DLRM hot path gathers per-table embedding rows, pools each bag, and meets
the pooled vectors with the bottom-MLP output in the interaction: ``cat``
(concat) or ``dot`` (pairwise dots).  The forward kernel
(``csrc/fused_interact.cu``) does all three in one pass without writing
the pooled intermediate to device memory; the backward kernel
(``csrc/fused_interact_bwd.cu``) turns the output cotangent into
``dbottom`` and per-slot row grads at f32.

Dropped-id rule: ``mask_local_ids`` maps every local id that is negative
or beyond its table's row count to -1; a -1 slot reads nothing and pools
as exact 0.0.  The kernel and the plain version share that encoding.

The op's forward calls ``fused_embed_interact_cuda``, which reads the
op's local ids and masks them inside the forward kernel's one launch
(writing the masked ids when the backward needs them);
``fused_interact_cuda`` takes pre-masked flat ids into the same kernel.
They and ``fused_interact_bwd_cuda`` launch their kernels for tensors on
a CUDA device and run the plain versions (``fused_embed_interact_ref``,
``fused_interact_ref``, ``fused_interact_bwd_ref``) only for tensors on
the CPU; a CUDA tensor never reaches a plain version through them.
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


def divide(x, n: int):
    """``x / n`` as a true division on every device.  ATen divides a CUDA
    tensor by a Python number as a multiply by its reciprocal, which can
    round one ulp away from the division that the kernels, the CPU and
    the JAX package's emitter path do; a 0-dim tensor on the same device
    as ``x`` is divided elementwise."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def pool_rows(rows, aggr: str, out_dtype):
    """Bag-pool gathered rows ``(B, T, bag, d)`` -> ``(B, T, d)``: the sum
    over the bag in bag order, ``((r0 + r1) + r2) + ...`` as the kernels
    sum (``sum`` reduces in an order of its own, and under bf16 ``dot``
    one ulp of a pooled value can flip its operand's rounding), divided by
    the bag for ``avg``.  An empty bag pools to exact 0.0 in both
    modes."""
    b, t, bag, d = rows.shape
    if bag == 0:
        return torch.zeros((b, t, d), dtype=out_dtype, device=rows.device)
    pooled = rows[:, :, 0]
    for j in range(1, bag):
        pooled = pooled + rows[:, :, j]
    if aggr == "avg":
        pooled = divide(pooled, bag)
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


def fused_embed_interact_ref(table, idx, offsets, row_counts, bottom, *,
                             interact: str = "cat", aggr: str = "sum",
                             compute_dtype=None, want_gids: bool = False):
    """The plain version of the folded call: ``mask_local_ids`` on the
    op's local ids ``(B, T, bag)``, then ``fused_interact_ref``.  Returns
    ``(out, gids)``, ``gids`` the masked int32 flat ids when
    ``want_gids``, else None."""
    gids = mask_local_ids(idx, offsets, row_counts).to(torch.int32)
    out = fused_interact_ref(table, gids, bottom, interact=interact,
                             aggr=aggr, compute_dtype=compute_dtype)
    return out, (gids if want_gids else None)


# ------------------------------------------------------------------ kernel
_SIGNATURES = {
    "ff_fused_interact_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p]),
    "ff_empty_kernel": (ctypes.c_int, [ctypes.c_void_p]),
    "ff_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_count_lock = threading.Lock()


def _check_fwd(table, ids, bottom, interact, aggr, *others):
    """The checks both forward entries share; ``ids`` is (B, T, bag)."""
    if interact not in ("cat", "dot"):
        raise ValueError(f"unknown interaction op {interact!r}")
    if aggr not in ("sum", "avg"):
        raise ValueError(f"unknown aggregation {aggr!r}")
    devices = {x.device for x in (table, ids, bottom, *others)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    if table.dim() != 2 or ids.dim() != 3 or bottom.dim() != 2:
        raise ValueError(
            f"expected table (R, d), ids (B, T, bag), bottom (B, bot); got "
            f"{tuple(table.shape)}, {tuple(ids.shape)}, "
            f"{tuple(bottom.shape)}")
    if bottom.shape[0] != ids.shape[0]:
        raise ValueError(f"bottom has {bottom.shape[0]} rows, ids "
                         f"{ids.shape[0]}")
    if interact == "dot" and bottom.shape[1] != table.shape[1]:
        raise ValueError(f"dot interaction needs bottom width "
                         f"{table.shape[1]}, got {bottom.shape[1]}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused_interact kernel for {table.device}")


def _launch_fwd(table, ids, offsets, row_counts, bottom, gids_out, interact,
                aggr, compute_dtype):
    """Check what the kernel takes and launch it once on CUDA tensors;
    ``offsets``/``row_counts`` None means ``ids`` are pre-masked flat
    ids.  Adds one to ``fused_interact_cuda.launches``, the count of
    this kernel whichever entry launched it."""
    if table.dtype != torch.float32 or bottom.dtype != torch.float32:
        raise TypeError(f"fused_interact kernel takes an f32 table and "
                        f"bottom, got {table.dtype}, {bottom.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()
            and bottom.is_contiguous()):
        raise ValueError("fused_interact kernel takes contiguous tensors")
    rows_n, dim = table.shape
    bsz, t, bag = ids.shape
    bot_dim = bottom.shape[1]
    if rows_n >= 2 ** 31:
        raise ValueError(f"table of {rows_n} rows overflows int32 ids")
    dot = interact == "dot"
    out = torch.empty((bsz, interact_width(interact, t, dim, bot_dim)),
                      dtype=torch.float32, device=table.device)
    if bsz == 0:
        return out
    vec4 = (dim % 4 == 0 and table.data_ptr() % 16 == 0
            and (dot or (bot_dim % 4 == 0 and out.data_ptr() % 16 == 0)))
    lib = _cuda.load("fused_interact", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ff_fused_interact_fwd(
            table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
            None if offsets is None else offsets.data_ptr(),
            None if row_counts is None else row_counts.data_ptr(),
            bottom.data_ptr(), out.data_ptr(),
            None if gids_out is None else gids_out.data_ptr(), bsz, t, bag,
            dim, bot_dim, rows_n, int(dot), int(aggr == "avg"),
            int(compute_dtype in BF16_NAMES), int(vec4), stream)
    if err:
        msg = lib.ff_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_interact kernel launch failed: {msg}")
    with _count_lock:
        fused_interact_cuda.launches += 1
    return out


def fused_interact_cuda(table, gids, bottom, *, interact: str = "cat",
                        aggr: str = "sum", compute_dtype=None):
    """Run the fused forward.  ``table`` (R, d) f32, ``gids`` (B, T, bag)
    int32 pre-masked flat ids, ``bottom`` (B, bot_dim) f32; returns
    (B, width) f32.

    On CUDA tensors this launches the Hopper kernel (and adds one to
    ``fused_interact_cuda.launches``) or raises; on CPU tensors it runs
    ``fused_interact_ref``."""
    _check_fwd(table, gids, bottom, interact, aggr)
    if table.device.type == "cpu":
        return fused_interact_ref(table, gids, bottom, interact=interact,
                                  aggr=aggr, compute_dtype=compute_dtype)
    if gids.dtype != torch.int32:
        raise TypeError(f"fused_interact kernel takes int32 flat ids, got "
                        f"{gids.dtype}")
    return _launch_fwd(table, gids, None, None, bottom, None, interact, aggr,
                       compute_dtype)


fused_interact_cuda.launches = 0


def fused_embed_interact_cuda(table, idx, offsets, row_counts, bottom, *,
                              interact: str = "cat", aggr: str = "sum",
                              compute_dtype=None, want_gids: bool = False):
    """The op's whole forward in one launch: ``mask_local_ids`` folded
    into the fused forward.  ``idx`` (B, T, bag) int32 or int64 local ids
    as the op receives them, ``offsets`` and ``row_counts`` (T,) int64
    (``RaggedStackedEmbedding.table_consts``), ``table`` and ``bottom``
    as ``fused_interact_cuda``.  Returns ``(out, gids)``: ``gids`` the
    masked int32 flat ids ``(B, T, bag)``, which the backward reads,
    when ``want_gids``, else None.

    On CUDA tensors this launches the Hopper kernel (and adds one to
    ``fused_interact_cuda.launches``) or raises; on CPU tensors it runs
    ``fused_embed_interact_ref``."""
    _check_fwd(table, idx, bottom, interact, aggr, offsets, row_counts)
    t = idx.shape[1]
    if offsets.shape != (t,) or row_counts.shape != (t,):
        raise ValueError(f"expected ({t},) offsets and row counts, got "
                         f"{tuple(offsets.shape)}, {tuple(row_counts.shape)}")
    if table.device.type == "cpu":
        return fused_embed_interact_ref(
            table, idx, offsets, row_counts, bottom, interact=interact,
            aggr=aggr, compute_dtype=compute_dtype, want_gids=want_gids)
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"fused_interact kernel takes int32 or int64 ids, "
                        f"got {idx.dtype}")
    if offsets.dtype != torch.int64 or row_counts.dtype != torch.int64:
        raise TypeError(f"fused_interact kernel takes int64 offsets and "
                        f"row counts, got {offsets.dtype}, "
                        f"{row_counts.dtype}")
    if not (offsets.is_contiguous() and row_counts.is_contiguous()):
        raise ValueError("fused_interact kernel takes contiguous tensors")
    gids = (torch.empty(idx.shape, dtype=torch.int32, device=idx.device)
            if want_gids else None)
    out = _launch_fwd(table, idx, offsets, row_counts, bottom, gids,
                      interact, aggr, compute_dtype)
    return out, gids


def empty_launch_cuda() -> None:
    """Launch the forward library's empty kernel (one warp, no work) on
    the current CUDA stream: the floor under any launch of the forward,
    for timing.  Counts nothing."""
    lib = _cuda.load("fused_interact", _SIGNATURES)
    err = lib.ff_empty_kernel(torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.ff_cuda_error_string(err).decode()
        raise RuntimeError(f"empty kernel launch failed: {msg}")


# ---------------------------------------------------------------- backward
def interact_backward(g, bottom, pooled, interact: str):
    """The VJP of ``interact_features`` at f32, formed as the JAX
    package's ``interact_backward`` forms it: ``cat`` is a slice of
    ``g``; ``dot``'s ``z z^T`` gives ``dz = G z + (z^T G)^T``.  Returns
    ``(dbottom, dpooled)``; ``pooled`` may be None for ``cat``."""
    if interact == "cat":
        bot_dim = bottom.shape[1]
        return g[:, :bot_dim], g[:, bot_dim:]  # dpooled (B, T*d) flat
    if interact != "dot":
        raise ValueError(f"unknown interaction op {interact!r}")
    b, dim, t = g.shape[0], bottom.shape[1], pooled.shape[1]
    f = t + 1
    gm = g[:, dim:].reshape(b, f, f)
    z = torch.cat([bottom[:, None, :], pooled], dim=1)  # (B, F, d)
    dz = (torch.matmul(gm, z)
          + torch.matmul(z.transpose(-1, -2), gm).transpose(-1, -2))
    return g[:, :dim] + dz[:, 0], dz[:, 1:]


def fused_interact_bwd_ref(table, gids, bottom, g, *, interact: str = "cat",
                           aggr: str = "sum", want_safe: bool = False):
    """The plain backward: ``interact_backward`` on the re-pooled rows,
    then the pooled grads broadcast over the bag (divided by the bag for
    ``avg``) and zeroed at dropped slots.  Returns ``(row_grads
    (B, T, bag, d), dbottom (B, bot))``, and with ``want_safe`` also the
    scatter's ids ``max(gids, 0)`` as int32 (the JAX package's ``safe``
    ids)."""
    b, t, bag = gids.shape
    dim = table.shape[1]
    live = (gids >= 0) & (gids < table.shape[0])
    pooled = None
    if interact == "dot":
        rows = table[torch.where(live, gids, torch.zeros_like(gids)).long()]
        rows = torch.where(live[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        pooled = pool_rows(rows, aggr, torch.float32)
    dbot, dpooled = interact_backward(g, bottom, pooled, interact)
    dpooled = dpooled.reshape(b, t, dim)
    if aggr == "avg":
        dpooled = divide(dpooled, bag)
    rowg = torch.where(live[..., None], dpooled[:, :, None, :],
                       torch.zeros((), dtype=dpooled.dtype,
                                   device=dpooled.device))
    out = (rowg.expand(b, t, bag, dim).contiguous(), dbot.contiguous())
    if want_safe:
        out += (gids.clamp_min(0).to(torch.int32),)
    return out


_BWD_SIGNATURES = {
    "ff_fused_interact_bwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "ff_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def fused_interact_bwd_cuda(table, gids, bottom, g, *, interact: str = "cat",
                            aggr: str = "sum", want_safe: bool = False):
    """Run the fused backward at f32.  Inputs as ``fused_interact_cuda``
    plus ``g`` (B, width) f32, the interaction's output cotangent.
    Returns ``(row_grads (B, T, bag, d), dbottom (B, bot))``, and with
    ``want_safe`` also the scatter's ids ``max(gids, 0)`` (B, T, bag)
    int32, written by the same launch.

    On CUDA tensors this launches the Hopper kernel (and adds one to
    ``fused_interact_bwd_cuda.launches``) or raises; on CPU tensors it
    runs ``fused_interact_bwd_ref``."""
    if interact not in ("cat", "dot"):
        raise ValueError(f"unknown interaction op {interact!r}")
    if aggr not in ("sum", "avg"):
        raise ValueError(f"unknown aggregation {aggr!r}")
    devices = {table.device, gids.device, bottom.device, g.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    if table.dim() != 2 or gids.dim() != 3 or bottom.dim() != 2:
        raise ValueError(
            f"expected table (R, d), gids (B, T, bag), bottom (B, bot); got "
            f"{tuple(table.shape)}, {tuple(gids.shape)}, "
            f"{tuple(bottom.shape)}")
    rows_n, dim = table.shape
    bsz, t, bag = gids.shape
    bot_dim = bottom.shape[1]
    if interact == "dot" and bot_dim != dim:
        raise ValueError(
            f"dot interaction needs bottom width {dim}, got {bot_dim}")
    width = interact_width(interact, t, dim, bot_dim)
    if bottom.shape[0] != bsz or tuple(g.shape) != (bsz, width):
        raise ValueError(f"bottom {tuple(bottom.shape)} and g "
                         f"{tuple(g.shape)} do not match ids "
                         f"{tuple(gids.shape)} (width {width})")
    if table.device.type == "cpu":
        return fused_interact_bwd_ref(table, gids, bottom, g,
                                      interact=interact, aggr=aggr,
                                      want_safe=want_safe)
    if table.device.type != "cuda":
        raise ValueError(f"no fused_interact_bwd kernel for {table.device}")
    if (table.dtype != torch.float32 or bottom.dtype != torch.float32
            or g.dtype != torch.float32 or gids.dtype != torch.int32):
        raise TypeError(
            f"fused_interact_bwd kernel takes f32 table, bottom and g and "
            f"int32 ids, got {table.dtype}, {bottom.dtype}, {g.dtype}, "
            f"{gids.dtype}")
    if not (table.is_contiguous() and gids.is_contiguous()
            and bottom.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_interact_bwd kernel takes contiguous tensors")
    if rows_n >= 2 ** 31:
        raise ValueError(f"table of {rows_n} rows overflows int32 ids")
    rowg = torch.empty((bsz, t, bag, dim), dtype=torch.float32,
                       device=table.device)
    dbot = torch.empty((bsz, bot_dim), dtype=torch.float32,
                       device=table.device)
    safe = (torch.empty(gids.shape, dtype=torch.int32, device=gids.device)
            if want_safe else None)
    out = (rowg, dbot) + ((safe,) if want_safe else ())
    if bsz == 0:
        return out
    dot = interact == "dot"
    aligned = (table,) if dot else (g, rowg, dbot)
    vec4 = (dim % 4 == 0 and (dot or bot_dim % 4 == 0)
            and all(x.data_ptr() % 16 == 0 for x in aligned))
    lib = _cuda.load("fused_interact_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ff_fused_interact_bwd(
            table.data_ptr(), gids.data_ptr(), bottom.data_ptr(),
            g.data_ptr(), rowg.data_ptr(), dbot.data_ptr(),
            None if safe is None else safe.data_ptr(), bsz, t, bag, dim,
            bot_dim, rows_n, int(dot), int(aggr == "avg"), int(vec4), stream)
    if err:
        msg = lib.ff_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_interact_bwd kernel launch failed: {msg}")
    with _count_lock:
        fused_interact_bwd_cuda.launches += 1
    return out


fused_interact_bwd_cuda.launches = 0
