"""Host-placed embedding tables: the hetero strategy's CPU tables
(counterpart of ``dlrm_flexflow_tpu/ops/hetero.py``; reference
``ParallelConfig::device_type`` CPU, ``embedding_avx2.cc``,
``dlrm_strategy_hetero.cc``: embeddings in host memory, MLPs on the
accelerator, for tables that do not fit in device memory).

A table lives in a process-wide store of numpy arrays and never reaches
the card.  ``host_embedding_bag`` looks the bags up on the host with the
native kernels of ``native/ffruntime.cpp`` (``data/native.py``) and hands
the pooled rows to the model's device; its backward brings the
cotangent back to the host once and deposits the dense table gradient
under ``key + "/grad"``, which ``apply_host_sgd`` applies after the step
(``FFModel.train_step``).  The scalar ``handle`` (1.0 at init, a trained
parameter like any other) multiplies the output, as in the JAX package,
so the step's autograd reaches the host backward.

Each native call has its plain numpy version beside it
(``bag_numpy``, ``bag_grad_numpy``: the JAX package's fallback branches,
which sum in the native kernels' order) and takes it when the library
cannot be built.

**Across the ranks of a mesh** (:class:`HostComm`) the JAX package's
host callback runs once, on the process of mesh device 0, over the whole
global batch; the port keeps that contract with a leader.  Rank
``owner`` (the mesh's device 0, rank 0) alone holds each host table,
looks the global batch up and deposits its gradient, in global batch
order, and alone applies the host SGD step and saves the table; no
other rank keeps a copy.  :class:`HostBagMeshFn` is the bag across the
ranks: the ids of each batch block are gathered to the owner once (from
the first rank that holds the block), the owner's pooled rows go back to
every rank holding their block, and the backward gathers every rank's
share of the rows' cotangent (the step scales each rank's loss by one
over the ranks holding its rows), sums the shares of each block in rank
order and deposits the dense gradient of the global batch, exactly as
one process does.  These collectives carry host tensors over a gloo
group (``distributed.host_group``: the world's under gloo, a gloo group
of its own under NCCL), under the group's deadline.

``timing()`` turns on a wall-time split of the host side by part
(``PARTS``): the lookup, the host-to-device and device-to-host copies,
the gradient deposit and the update, and across ranks the ids' gather,
the rows' scatter and the cotangents' gather.  While it is on, each part
first waits for the card, so that the card's work lands outside the
parts.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data import native as _native

#: the host-side parts ``timing()`` splits the wall into
PARTS = ("lookup", "h2d", "d2h", "host_grad", "host_update", "id_gather",
         "rows_scatter", "grad_gather")
_times: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def timing():
    """``{part: seconds}`` summed over every hetero call inside the block
    (``PARTS``); each part synchronises with the card first."""
    global _times
    _times = dict.fromkeys(PARTS, 0.0)
    try:
        yield _times
    finally:
        _times = None


def _mark(device) -> float:
    if _times is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _add(part: str, t0: float, device) -> float:
    t1 = _mark(device)
    if _times is not None:
        _times[part] += t1 - t0
    return t1


class HostEmbeddingTable:
    """A table in host memory, registered in a process-wide store under an
    instance-unique key (``<op name>@<op id>``), so two models with an
    op of the same name never share a table.  ``array`` rebinds the
    store's entry (an f32 C-contiguous array); ``drop`` evicts the table
    and its deposited gradient."""

    _tables: Dict[str, np.ndarray] = {}

    def __init__(self, key: str, array: np.ndarray):
        self.key = key
        HostEmbeddingTable._tables[key] = np.ascontiguousarray(
            array, np.float32)

    @property
    def array(self) -> np.ndarray:
        return HostEmbeddingTable._tables[self.key]

    @array.setter
    def array(self, v):
        HostEmbeddingTable._tables[self.key] = np.ascontiguousarray(
            v, np.float32)

    @classmethod
    def drop(cls, key: str):
        """Evict a table and its deposited gradient from the store (the
        owning op's ``weakref.finalize``)."""
        cls._tables.pop(key, None)
        cls._tables.pop(key + "/grad", None)


def bag_numpy(table: np.ndarray, ids: np.ndarray, mode: str) -> np.ndarray:
    """The plain version of ``embedding_bag_cpu`` (JAX ``hetero.py:75-76``)."""
    rows = table[ids]
    return rows.sum(1) if mode == "sum" else rows.mean(1)


def bag_grad_numpy(table: np.ndarray, ids: np.ndarray, g: np.ndarray,
                   mode: str) -> np.ndarray:
    """The plain version of ``embedding_bag_cpu_grad``, in ``(b, j)`` order
    (JAX ``hetero.py:95-100``)."""
    gw = np.zeros_like(table)
    scale = 1.0 / ids.shape[1] if mode == "avg" else 1.0
    for b in range(ids.shape[0]):
        for j in range(ids.shape[1]):
            gw[ids[b, j]] += g[b] * scale
    return gw


def host_bag(table: np.ndarray, ids: np.ndarray, mode: str) -> np.ndarray:
    if _native.native_available():
        return _native.embedding_bag_cpu(table, ids, mode)
    return bag_numpy(table, ids, mode)


def host_bag_grad(table: np.ndarray, ids: np.ndarray, g: np.ndarray,
                  mode: str) -> np.ndarray:
    if _native.native_available():
        return _native.embedding_bag_cpu_grad(g, ids, table.shape[0], mode)
    return bag_grad_numpy(table, ids, g, mode)


def _host_ids(ids: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(ids.detach().cpu().numpy(), np.int64)


class HostBagFn(torch.autograd.Function):
    """The bag through a host table: the JAX ``custom_vjp`` of
    ``host_embedding_bag``.  Forward: the host lookup, copied to
    ``handle``'s device, times ``handle``.  Backward: ``g * handle``
    copied to the host and scattered into the table's dense gradient,
    deposited under ``key + "/grad"``; ``handle``'s gradient is
    ``sum(g * out) / handle`` (``handle`` 0 counts as 1), summed in f64
    and rounded once."""

    @staticmethod
    def forward(ctx, ids, handle, table_key, dim, mode):
        dev = handle.device
        t = _mark(dev)
        ids_np = _host_ids(ids)
        t = _add("d2h", t, dev) if ids.device.type != "cpu" else t
        pooled = host_bag(HostEmbeddingTable._tables[table_key], ids_np,
                          mode)
        t = _add("lookup", t, dev)
        raw = torch.from_numpy(pooled).to(dev)
        _add("h2d", t, dev)
        out = raw * handle
        ctx.save_for_backward(handle, out)
        ctx.host = (ids_np, table_key, mode)
        return out

    @staticmethod
    def backward(ctx, g):
        handle, out = ctx.saved_tensors
        ids_np, table_key, mode = ctx.host
        dev = g.device
        t = _mark(dev)
        g_np = (g * handle).detach().cpu().numpy()
        t = _add("d2h", t, dev)
        table = HostEmbeddingTable._tables[table_key]
        HostEmbeddingTable._tables[table_key + "/grad"] = host_bag_grad(
            table, ids_np, g_np, mode)
        _add("host_grad", t, dev)
        d_handle = ((g * out).double().sum().float()
                    / torch.where(handle != 0, handle, torch.ones_like(handle)))
        return None, d_handle, None, None, None


class HostComm:
    """The leader protocol of a mesh's host tables (module docstring):
    ``owner`` is the rank of the mesh's device 0, ``group`` the gloo
    group over the mesh's ranks (``distributed.host_group``; a
    collective to build: every rank builds it at ``compile``).  A batch
    block's index over axes is the row-major index of a rank's
    coordinates on them, as ``collectives.local_block`` cuts."""

    def __init__(self, mesh):
        from ..distributed import host_group
        self.mesh = mesh
        self.ranks = sorted(int(r) for r in mesh.devices.reshape(-1))
        self.owner = int(mesh.devices.reshape(-1)[0])
        self.is_owner = mesh.rank == self.owner
        big = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
        self.group = host_group(self.ranks, mesh.group(big)[0])

    def block(self, rank: int, axes) -> int:
        """The index of ``rank``'s batch block over ``axes``."""
        mesh = self.mesh
        where = np.argwhere(mesh.devices == rank)[0]
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + int(where[mesh.axis_names.index(a)])
        return idx

    def gather(self, t: torch.Tensor):
        """Every rank's host tensor ``t`` on the owner, ``{rank: t}``;
        None on the other ranks."""
        import torch.distributed as dist
        t = t.contiguous()
        bufs = ([torch.empty_like(t) for _ in self.ranks] if self.is_owner
                else None)
        dist.gather(t, bufs, dst=self.owner, group=self.group)
        return dict(zip(self.ranks, bufs)) if self.is_owner else None

    def scatter(self, parts, shape, dtype=torch.float32) -> torch.Tensor:
        """Each rank's ``parts[rank]`` (given on the owner) on that rank."""
        import torch.distributed as dist
        out = torch.empty(shape, dtype=dtype)
        dist.scatter(out, [parts[r] for r in self.ranks] if self.is_owner
                     else None, src=self.owner, group=self.group)
        return out

    def first_holders(self, got, axes) -> torch.Tensor:
        """The global batch from the gathered blocks: each block once,
        from the first rank holding it, in block order."""
        first: Dict[int, int] = {}
        for r in self.ranks:
            first.setdefault(self.block(r, axes), r)
        return torch.cat([got[first[k]] for k in range(len(first))])

    def summed(self, got, axes) -> torch.Tensor:
        """The global batch of gathered shares: the shares of the ranks
        holding each block summed in rank order, in block order."""
        sums: Dict[int, torch.Tensor] = {}
        for r in self.ranks:
            k = self.block(r, axes)
            sums[k] = got[r] if k not in sums else sums[k] + got[r]
        return torch.cat([sums[k] for k in range(len(sums))])

    def split(self, rows: torch.Tensor, axes) -> Dict[int, torch.Tensor]:
        """Each rank's block of the global ``rows`` over ``axes``."""
        n = rows.shape[0] // self.mesh.axis_size(axes)
        return {r: rows[self.block(r, axes) * n:
                        (self.block(r, axes) + 1) * n].contiguous()
                for r in self.ranks}


class HostBagMeshFn(torch.autograd.Function):
    """:class:`HostBagFn` across the ranks of a mesh (module docstring):
    ``ids`` are the rank's block over ``ids_axes``, the output its block
    over ``out_axes`` (either may be empty: every rank holds the whole
    batch).  Only the owner reads the table and holds the global ids;
    ``handle``'s gradient is the rank's own ``sum(g * out) / handle``,
    which the step sums over the ranks as any replicated parameter's."""

    @staticmethod
    def forward(ctx, ids, handle, table_key, dim, mode, comm, ids_axes,
                out_axes):
        dev = handle.device
        t = _mark(dev)
        ids_cpu = ids.detach().to("cpu", torch.int64)
        t = _add("d2h", t, dev) if ids.device.type != "cpu" else t
        got = comm.gather(ids_cpu)
        t = _add("id_gather", t, dev)
        mesh = comm.mesh
        n_out = (ids.shape[0] * mesh.axis_size(ids_axes)
                 // mesh.axis_size(out_axes))
        ids_all = parts = None
        if comm.is_owner:
            ids_all = np.ascontiguousarray(
                comm.first_holders(got, ids_axes).numpy())
            pooled = host_bag(HostEmbeddingTable._tables[table_key],
                              ids_all, mode)
            t = _add("lookup", t, dev)
            parts = comm.split(torch.from_numpy(
                np.ascontiguousarray(pooled, np.float32)), out_axes)
        raw = comm.scatter(parts, (n_out, dim))
        t = _add("rows_scatter", t, dev)
        raw = raw.to(dev)
        _add("h2d", t, dev)
        out = raw * handle
        ctx.save_for_backward(handle, out)
        ctx.host = (ids_all, table_key, mode, comm, out_axes)
        return out

    @staticmethod
    def backward(ctx, g):
        handle, out = ctx.saved_tensors
        ids_all, table_key, mode, comm, out_axes = ctx.host
        dev = g.device
        t = _mark(dev)
        share = g.detach().to("cpu", torch.float32)
        t = _add("d2h", t, dev)
        got = comm.gather(share)
        t = _add("grad_gather", t, dev)
        if comm.is_owner:
            g_np = (comm.summed(got, out_axes)
                    * handle.detach().cpu()).numpy()
            table = HostEmbeddingTable._tables[table_key]
            HostEmbeddingTable._tables[table_key + "/grad"] = host_bag_grad(
                table, ids_all, g_np, mode)
            _add("host_grad", t, dev)
        d_handle = ((g * out).double().sum().float()
                    / torch.where(handle != 0, handle, torch.ones_like(handle)))
        return None, d_handle, None, None, None, None, None, None


def host_embedding_bag(ids, handle, table_key: Optional[str], dim: int,
                       mode: str = "sum", *, comm: Optional[HostComm] = None,
                       ids_axes=(), out_axes=()):
    """``(B, bag)`` int ids -> ``(B, dim)`` f32 on ``handle``'s device,
    through the host table stored under ``table_key``, times the scalar
    parameter ``handle``.  With ``comm`` (a mesh of more than one rank),
    the leader's bag across the ranks (:class:`HostBagMeshFn`): ``ids``
    the rank's block over ``ids_axes``, the result its block over
    ``out_axes``; ``table_key`` is read on the owner only."""
    if comm is not None:
        return HostBagMeshFn.apply(ids, handle, table_key, dim, mode, comm,
                                   tuple(ids_axes), tuple(out_axes))
    return HostBagFn.apply(ids, handle, table_key, dim, mode)


def apply_host_sgd(table: HostEmbeddingTable, lr: float):
    """The host SGD step of a table, from the gradient its backward
    deposited: ``array - lr * grad``, a new array bound in the store (the
    old one is left as it was, so a caller holding it holds the table
    before the step)."""
    g = HostEmbeddingTable._tables.get(table.key + "/grad")
    if g is not None:
        t = time.perf_counter()
        table.array = table.array - lr * g
        if _times is not None:
            _times["host_update"] += time.perf_counter() - t
