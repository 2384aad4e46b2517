"""Ring attention: sequence-parallel attention around the ranks of the
mesh's "seq" axis (counterpart of
``dlrm_flexflow_tpu/parallel/ring_attention.py``).

Each rank keeps its query block and folds every K/V block with an online
softmax (flash-attention style running max and denominator), so the full
S x S score matrix is never formed; the K/V blocks move one rank along
the ring per step (``collectives.ppermute``, whose gradient is the
reverse step).  The products are ``ops/base.py::matmul``'s, as the port's
``sdpa``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.base import matmul
from .collectives import ppermute, relayout
from .mesh import DATA_AXIS, PartitionSpec


def _block_attn(q, k, v, scale, mask=None):
    """Unnormalized block attention: ``(acc, row_max, row_sum)``.
    ``row_max`` is the true block max (-inf for a fully masked row), so
    the merge can tell "saw nothing" from "saw logits near 0"."""
    s = matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)                        # -inf when fully masked
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    acc = matmul(p.to(v.dtype), v)
    return acc, m, p.sum(dim=-1)


def ring_attention(q, k, v, axis_name: str, causal: bool = False,
                   scale: Optional[float] = None,
                   q_offset: Optional[int] = None, *, mesh):
    """Attention where q, k and v hold only this rank's sequence block.

    ``q, k, v``: (B, H, S_local, D), this rank's blocks along ``axis_name``
    of ``mesh`` (the JAX body reads its axis from the ``shard_map``).
    ``causal`` masks by global positions; ``q_offset`` is the global start
    of this rank's q block (default: its index on the axis times
    S_local).  Returns (B, H, S_local, D)."""
    n = mesh.shape[axis_name]
    idx = mesh.axis_index((axis_name,))
    s_local = q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q_offset is None:
        q_offset = idx * s_local
    dev = q.device
    qpos = q_offset + torch.arange(s_local, device=dev)
    acc = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                      device=dev)
    m = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(n):
        # k block i came from rank (idx - i) mod n
        src = (idx - i) % n
        mask = None
        if causal:
            kpos = src * s_local + torch.arange(s_local, device=dev)
            mask = (qpos[:, None] >= kpos[None, :])[None, None]
        blk_acc, blk_m, blk_l = _block_attn(q, k_blk, v_blk, scale, mask)
        new_m = torch.maximum(m, blk_m)
        safe_new_m = torch.where(torch.isfinite(new_m), new_m, zero)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_new_m),
                            zero)
        beta = torch.where(torch.isfinite(blk_m),
                           torch.exp(blk_m - safe_new_m), zero)
        acc = acc * alpha[..., None] + blk_acc * beta[..., None]
        l = l * alpha + blk_l * beta
        m = new_m
        if i < n - 1:  # the JAX loop's last rotation feeds nothing
            k_blk = ppermute(k_blk, mesh, (axis_name,), 1)
            v_blk = ppermute(v_blk, mesh, (axis_name,), 1)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def _seq_spec(mesh, seq_axis):
    batch_axis = DATA_AXIS if DATA_AXIS in mesh.axis_names else None
    return PartitionSpec(batch_axis, None, seq_axis, None)


def ring_attention_sharded(q, k, v, mesh, seq_axis: str = "seq",
                           causal: bool = False):
    """The JAX wrapper's signature: q, k and v are global (B, H, S, D)
    tensors (the same on every rank); each rank attends its block (B over
    "data" when present, S over ``seq_axis``) and the global output is
    returned on every rank.  Differentiable: with each rank's loss scaled
    by one over the ranks and the input gradients summed over them, the
    gradient is the one-device gradient (``parallel/mesh.py``)."""
    spec = _seq_spec(mesh, seq_axis)
    blocks = [relayout(x, PartitionSpec(), spec, mesh) for x in (q, k, v)]
    out = ring_attention(*blocks, seq_axis, causal=causal, mesh=mesh)
    return relayout(out, spec, PartitionSpec(), mesh)
