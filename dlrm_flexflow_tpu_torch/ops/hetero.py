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

``timing()`` turns on a wall-time split of the host side by part
(``PARTS``): the lookup, the host-to-device and device-to-host copies,
the gradient deposit and the update.  While it is on, each part first
waits for the card, so that the card's work lands outside the parts.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data import native as _native

#: the host-side parts ``timing()`` splits the wall into
PARTS = ("lookup", "h2d", "d2h", "host_grad", "host_update")
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


def host_embedding_bag(ids, handle, table_key: str, dim: int,
                       mode: str = "sum"):
    """``(B, bag)`` int ids -> ``(B, dim)`` f32 on ``handle``'s device,
    through the host table stored under ``table_key``, times the scalar
    parameter ``handle``."""
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
