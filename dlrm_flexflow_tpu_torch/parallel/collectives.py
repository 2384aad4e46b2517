"""The mesh's collectives, with the gradients JAX gives them.

Each collective that carries a gradient is an autograd function whose
backward is its exact transpose, as ``jax.grad`` transposes the
``shard_map`` collectives of the JAX package: an all-gather's backward is
a sum reduce-scatter, an all-to-all's the inverse all-to-all, a ring hop's
the reverse hop, a sum all-reduce's a sum all-reduce.  With those, and a
loss that every rank scales by one over the number of ranks
(``parallel/spmd.py``), every rank's gradient is that of the global loss.

Groups are a :class:`~.mesh.Mesh`'s: a collective over axes of total size
1 is the identity and calls nothing.  Only torch.distributed calls that
torch 2.11 and 2.13 both offer, undeprecated, are used: the list forms of
``all_gather``, ``reduce_scatter`` and ``all_to_all``, ``all_reduce`` and
``batch_isend_irecv``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import PartitionSpec, entry_axes


def _chunks(x, n: int, dim: int, what: str) -> List[torch.Tensor]:
    if x.shape[dim] % n:
        raise ValueError(f"{what}: dim {dim} of size {x.shape[dim]} does "
                         f"not divide over {n} ranks")
    return [c.contiguous() for c in x.chunk(n, dim)]


def gather_cat(x, mesh, axes: Sequence[str], dim: int = 0):
    """The blocks of every rank of ``axes`` concatenated along ``dim`` in
    the group's order (no gradient)."""
    pg, ranks, _ = mesh.group(axes)
    if len(ranks) == 1:
        return x
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(out, x, group=pg)
    return torch.cat(out, dim)


def reduce_scatter_sum(x, mesh, axes: Sequence[str], dim: int = 0):
    """This rank's block along ``dim`` of the sum over ``axes`` of ``x``
    (no gradient)."""
    pg, ranks, idx = mesh.group(axes)
    if len(ranks) == 1:
        return x
    parts = _chunks(x, len(ranks), dim, "reduce_scatter")
    out = torch.empty_like(parts[idx])
    dist.reduce_scatter(out, parts, group=pg)
    return out


def all_reduce_sum_(x, mesh, axes: Sequence[str]):
    """Sum ``x`` in place over ``axes`` (no gradient); every rank of the
    group gets the same bits."""
    pg, ranks, _ = mesh.group(axes)
    if len(ranks) > 1:
        dist.all_reduce(x, group=pg)
    return x


def all_to_all_tiled(x, mesh, axes: Sequence[str], split_dim: int,
                     concat_dim: int):
    """JAX's ``all_to_all(tiled=True)``: ``x`` split into n blocks along
    ``split_dim``, block j sent to the group's rank j, the received blocks
    concatenated along ``concat_dim`` in the senders' order (no
    gradient)."""
    pg, ranks, _ = mesh.group(axes)
    if len(ranks) == 1:
        return x
    ins = _chunks(x, len(ranks), split_dim, "all_to_all")
    outs = [torch.empty_like(ins[0]) for _ in ranks]
    dist.all_to_all(outs, ins, group=pg)
    return torch.cat(outs, concat_dim)


def ring_shift(x, mesh, axes: Sequence[str], shift: int = 1):
    """Each rank's ``x`` sent ``shift`` places along the group's ring
    (rank i to rank i + shift), the block of rank i - shift received (JAX
    ``ppermute`` with the perm ``[(i, (i + shift) % n)]``; no
    gradient)."""
    pg, ranks, idx = mesh.group(axes)
    n = len(ranks)
    if n == 1 or shift % n == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(idx + shift) % n], pg),
           dist.P2POp(dist.irecv, out, ranks[(idx - shift) % n], pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# ------------------------------------------------ the differentiable forms
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return gather_cat(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return reduce_scatter_sum(g.contiguous(), mesh, axes, dim), \
            None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return all_reduce_sum_(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce_sum_(g.clone(), mesh, axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return all_to_all_tiled(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (all_to_all_tiled(g, mesh, axes, concat_dim, split_dim),
                None, None, None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, shift):
        ctx.args = (mesh, axes, shift)
        return ring_shift(x, mesh, axes, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, shift = ctx.args
        return ring_shift(g, mesh, axes, -shift), None, None, None


def all_gather(x, mesh, axes: Sequence[str], dim: int = 0):
    """JAX ``all_gather(tiled=True)`` along ``dim`` over ``axes``; its
    gradient is the sum reduce-scatter."""
    axes = mesh.axes_key(axes)
    return _AllGather.apply(x, mesh, axes, dim) if axes else x


def psum(x, mesh, axes: Sequence[str]):
    """JAX ``psum``: the sum over ``axes`` on every rank."""
    axes = mesh.axes_key(axes)
    return _AllReduce.apply(x, mesh, axes) if axes else x


def all_to_all(x, mesh, axes: Sequence[str], split_dim: int,
               concat_dim: int):
    """JAX ``all_to_all(tiled=True)``; its gradient is the inverse
    all-to-all."""
    axes = mesh.axes_key(axes)
    if not axes:
        return x
    return _AllToAll.apply(x, mesh, axes, split_dim, concat_dim)


def ppermute(x, mesh, axes: Sequence[str], shift: int = 1):
    """JAX ``ppermute`` one ring step of ``shift``; its gradient is the
    reverse step."""
    axes = mesh.axes_key(axes)
    return _RingShift.apply(x, mesh, axes, shift) if axes else x


# ----------------------------------------------------------------- layouts
def normalize(spec, ndim: int) -> List[tuple]:
    """A spec as ``ndim`` tuples of axis names."""
    entries = [entry_axes(e) for e in tuple(spec)]
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return entries + [()] * (ndim - len(entries))


def relayout(x, src, dst, mesh):
    """``x`` (held in layout ``src``) in layout ``dst``, differentiably:
    for each dim, an all-gather over the axes it loses (those past the
    common prefix of the two entries), then a slice over the axes it
    gains.  Gathers run first, so an axis may move between dims."""
    ndim = x.dim()
    s_all = [mesh.axes_key(e) for e in normalize(src, ndim)]
    d_all = [mesh.axes_key(e) for e in normalize(dst, ndim)]
    if s_all == d_all:
        return x
    keep = []
    for i, (s, d) in enumerate(zip(s_all, d_all)):
        k = 0
        while k < min(len(s), len(d)) and s[k] == d[k]:
            k += 1
        keep.append(k)
        if s[k:]:
            x = all_gather(x, mesh, s[k:], dim=i)
    for i, d in enumerate(d_all):
        extra = d[keep[i]:]
        if extra:
            n = mesh.axis_size(extra)
            if x.shape[i] % n:
                raise ValueError(
                    f"dim {i} of size {x.shape[i]} does not divide over the "
                    f"{n}-way {extra} mesh axes (layout {PartitionSpec(*dst)})")
            step = x.shape[i] // n
            x = x.narrow(i, mesh.axis_index(extra) * step, step)
    return x


def local_block(x, spec, mesh):
    """This rank's block of a global tensor ``x`` under ``spec`` (a
    contiguous copy; no gradient)."""
    for i, axes in enumerate(normalize(spec, x.dim())):
        axes = mesh.axes_key(axes)
        if axes:
            n = mesh.axis_size(axes)
            if x.shape[i] % n:
                raise ValueError(
                    f"dim {i} of size {x.shape[i]} does not divide over the "
                    f"{n}-way {axes} mesh axes")
            step = x.shape[i] // n
            x = x.narrow(i, mesh.axis_index(axes) * step, step)
    return x.contiguous()


def global_value(x, spec, mesh):
    """The global tensor of a block ``x`` held in ``spec``, on every rank
    (no gradient)."""
    for i, axes in enumerate(normalize(spec, x.dim())):
        axes = mesh.axes_key(axes)
        if axes:
            x = gather_cat(x, mesh, axes, dim=i)
    return x


def replicated_axes(spec, ndim: int, mesh) -> tuple:
    """The mesh axes (of size > 1) that a layout does not shard over: the
    axes a parameter held in it is replicated on."""
    used = {a for e in normalize(spec, ndim) for a in e}
    return tuple(a for a in mesh.axis_names
                 if a not in used and mesh.shape[a] > 1)
