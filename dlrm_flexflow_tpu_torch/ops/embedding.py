"""Embedding (bag) operators (counterparts in
``dlrm_flexflow_tpu/ops/embedding.py``).

* ``Embedding``: one ``(R, d)`` table; ids ``(B,)`` or ``(B, bag)``.
* ``StackedEmbedding``: T same-size tables as one ``(T, R, d)`` weight;
  ids ``(B, T, bag)``.
* ``RaggedStackedEmbedding``: T tables of different row counts in ONE
  logical ``(R_total, d)`` row space with static per-table offsets,
  padded to the JAX package's alignment so that parameters cross between
  the packages with identical shapes (padding rows are never addressed).

Each op has the JAX package's row-sparse training seam: ``flat_ids``
(ids -> rows of the flat ``(rows, d)`` view), ``gather_rows`` (the
looked-up rows, gathered outside autograd) and ``scatter_apply``
(``table[ids] += scale * row_grads`` in place, through the row-update
kernel).  The forward takes injected ``rows__`` on that path.

``Embedding(use_pallas=True)`` pools its bags through the embedding-bag
kernel (``ops/bag_kernel.py``) under the JAX package's conditions, with
``EmbeddingBagFn`` as its gradient; such an op trains through the dense
table gradient, never the row-sparse path.

Id contracts, as in the JAX package: a gather reads ``jnp.take``'s way
(an id in ``[-R, 0)`` wraps, any other out-of-range id reads a NaN row);
the scatter follows ``.at[].add`` (an id in ``[-R, 0)`` wraps, any other
out-of-range id is dropped).  The JAX package's lane-packed storage and
CPU-placed tables are TPU or later-slice features with no counterpart
here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..initializers import UniformInitializer
from ..tensor import ParameterSpec
from .bag_kernel import embedding_bag_cuda
from .base import Op
from .fused_interact_kernel import divide
from .row_update_kernel import row_update_cuda

AGGR_MODES = ("sum", "avg", "none")


def lane_pack(dim: int) -> int:
    """Rows per 128-lane view row of the JAX package's packed storage
    (it sets the ragged row-space alignment, ``lane_pack(d) * 8``)."""
    if dim < 128 and 128 % dim == 0:
        return 128 // dim
    return 1


def take_rows(table, ids):
    """``jnp.take(table, ids, axis=0)`` in the JAX package's default mode:
    an id in ``[-R, 0)`` wraps to ``id + R``; any other id outside
    ``[0, R)`` reads a row of NaN.  Returns ``ids.shape + (d,)``."""
    r = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + r, ids)
    ok = (ids >= 0) & (ids < r)
    rows = table[torch.where(ok, ids, torch.zeros_like(ids))]
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


def pool(rows, aggr: str, dim: int):
    """Sum over the bag axis ``dim``, divided by the bag for ``avg``
    (a true division: ``torch.mean`` multiplies by the reciprocal and can
    round differently)."""
    pooled = rows.sum(dim=dim)
    if aggr == "avg":
        pooled = divide(pooled, rows.shape[dim])
    return pooled


def _f32_table(name, table_dtype):
    if table_dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: {table_dtype} tables are not ported yet (float32 "
            "only); bf16 and quantized tables come with the "
            "serving-extras slice in ROADMAP.md")
    return table_dtype


class EmbeddingBagFn(torch.autograd.Function):
    """The differentiable bag: the counterpart of the JAX package's
    ``embedding_bag`` custom VJP (``pallas_embedding.py``).

    Forward: the embedding-bag kernel.  Backward: the JAX ``_bwd``, the
    output grad divided by the bag for ``avg`` (a true division), repeated
    for every slot of its bag, and summed per row into a zero table by
    the row-update kernel, a deterministic scatter in the ids' order, as
    the fused dense gradient does (``index_add_`` would add duplicates in
    an atomic order that changes from run to run)."""

    @staticmethod
    def forward(ctx, table, ids, aggr):
        ctx.save_for_backward(ids)
        ctx.config = (table.shape, table.dtype, aggr)
        return embedding_bag_cuda(table, ids, aggr)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        shape, dtype, aggr = ctx.config
        bag = ids.shape[1]
        if aggr == "avg":
            g = divide(g, bag)
        flat_g = g.repeat_interleave(bag, dim=0)     # (B * bag, d)
        dtable = torch.zeros(shape, dtype=dtype, device=g.device)
        return row_update_cuda(dtable, ids.reshape(-1), flat_g, 1.0), None, None


class Embedding(Op):
    op_type = "Embedding"

    def __init__(self, name, input_tensor, num_entries: int, out_dim: int,
                 aggr: str = "sum", kernel_initializer=None,
                 dtype=torch.float32, use_pallas: bool = False,
                 table_dtype=torch.float32):
        super().__init__(name, [input_tensor])
        if aggr not in AGGR_MODES:
            raise ValueError(f"aggr must be one of {AGGR_MODES}, got {aggr!r}")
        self.num_entries = int(num_entries)
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.table_dtype = _f32_table(name, table_dtype)
        # the JAX package's flag and eligibility: the bag kernel's path
        # (the d % 128 rule is the TPU's lane tiling; the Hopper kernel
        # needs none of it, but the op must take the reference's path)
        self.use_pallas = use_pallas and out_dim % 128 == 0
        self.kernel_initializer = (kernel_initializer
                                   or UniformInitializer(-0.05, 0.05))
        ishape = input_tensor.shape
        if len(ishape) == 1:
            out_shape = (ishape[0], self.out_dim)
        elif aggr != "none":
            out_shape = (ishape[0], self.out_dim)
        else:
            out_shape = tuple(ishape) + (self.out_dim,)
        self.outputs = [self._make_output(out_shape, dtype)]

    def param_specs(self):
        return [ParameterSpec(self.name, "embedding",
                              (self.num_entries, self.out_dim),
                              dtype=self.table_dtype,
                              initializer=self.kernel_initializer)]

    def forward(self, params, xs):
        (idx,) = xs
        rows = params.get("rows__")
        if rows is None:
            # the JAX package's conditions for its bag kernel (no
            # quantization scale, which the port's tables never carry;
            # 2-D ids; sum or avg; B % 8 == 0, the TPU's sublane tile)
            if (self.use_pallas and idx.dim() == 2
                    and self.aggr in ("sum", "avg") and idx.shape[0] % 8 == 0):
                out = EmbeddingBagFn.apply(params["embedding"], idx,
                                           self.aggr)
                return [out.to(self.outputs[0].dtype)]
            rows = take_rows(params["embedding"], idx)
        if idx.dim() >= 2 and self.aggr != "none":
            rows = pool(rows, self.aggr, -2)
        return [rows.to(self.outputs[0].dtype)]

    def flat_ids(self, idx):
        """The identity: one table is its own flat row space."""
        return idx

    def gather_rows(self, table, idx):
        return take_rows(table, idx)

    def scatter_apply(self, table, idx, row_grads, scale):
        """``table[idx] += scale * row_grads`` in place (duplicates
        accumulate); returns the table."""
        return row_update_cuda(table, idx, row_grads, scale)


class StackedEmbedding(Op):
    """T same-shape tables as one ``(T, rows, dim)`` weight.  Input
    ``(batch, T, bag)`` ids, output ``(batch, T, dim)``."""

    op_type = "StackedEmbedding"

    def __init__(self, name, input_tensor, num_tables: int, num_entries: int,
                 out_dim: int, aggr: str = "sum", kernel_initializer=None,
                 dtype=torch.float32, table_dtype=torch.float32):
        super().__init__(name, [input_tensor])
        if aggr not in ("sum", "avg"):
            raise ValueError(f"aggr must be 'sum' or 'avg', got {aggr!r}")
        self.num_tables = int(num_tables)
        self.num_entries = int(num_entries)
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.table_dtype = _f32_table(name, table_dtype)
        self.kernel_initializer = (kernel_initializer
                                   or UniformInitializer(-0.05, 0.05))
        if input_tensor.shape[1] != num_tables:
            raise ValueError(f"expected (batch, {num_tables}, bag) ids, "
                             f"got {input_tensor.shape}")
        b = input_tensor.shape[0]
        self.outputs = [self._make_output((b, num_tables, out_dim), dtype)]

    def param_specs(self):
        return [ParameterSpec(self.name, "embedding",
                              (self.num_tables, self.num_entries,
                               self.out_dim),
                              dtype=self.table_dtype,
                              initializer=self.kernel_initializer)]

    def _offsets(self, idx):
        return (torch.arange(self.num_tables, dtype=idx.dtype,
                             device=idx.device)[:, None]
                * self.num_entries)

    def forward(self, params, xs):
        (idx,) = xs  # (batch, T, bag)
        rows = params.get("rows__")  # sparse-update path: (B, T, bag, d)
        if rows is None:
            # each table's own jnp.take (the JAX package vmaps one take
            # per table): wrap and drop per table, then one flat gather
            tables = params["embedding"]
            t, r, d = tables.shape
            local = torch.where(idx < 0, idx + r, idx)
            ok = (local >= 0) & (local < r)
            gids = torch.where(ok, local + self._offsets(idx),
                               torch.full_like(local, t * r))
            rows = take_rows(tables.reshape(t * r, d), gids)
        return [pool(rows, self.aggr, 2).to(self.outputs[0].dtype)]

    def flat_ids(self, idx):
        """``(..., T, bag)`` per-table ids -> rows of the flat
        ``(T*R, d)`` view."""
        return idx + self._offsets(idx)

    def gather_rows(self, tables, idx):
        """``(T, R, d)`` tables + ``(B, T, bag)`` ids -> ``(B, T, bag, d)``
        rows, read from the flat view by global row id."""
        t, r, d = tables.shape
        return take_rows(tables.reshape(t * r, d), self.flat_ids(idx))

    def scatter_apply(self, tables, idx, row_grads, scale):
        """The row-sparse step on the flat ``(T*R, d)`` view, in place;
        returns the tables."""
        t, r, d = tables.shape
        row_update_cuda(tables.view(t * r, d), self.flat_ids(idx),
                        row_grads, scale)
        return tables


class RaggedStackedEmbedding(Op):
    """Input ``(batch, T, bag)`` per-table local ids, output
    ``(batch, T, dim)`` pooled rows of the fused ``(R_total, d)`` row
    space."""

    op_type = "RaggedStackedEmbedding"

    def __init__(self, name, input_tensor, row_counts, out_dim: int,
                 aggr: str = "sum", kernel_initializer=None,
                 dtype=torch.float32, table_dtype=torch.float32):
        super().__init__(name, [input_tensor])
        if aggr not in ("sum", "avg"):
            raise ValueError(f"aggr must be 'sum' or 'avg', got {aggr!r}")
        self.row_counts = [int(r) for r in row_counts]
        self.num_tables = len(self.row_counts)
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.table_dtype = _f32_table(name, table_dtype)
        self.kernel_initializer = (kernel_initializer
                                   or UniformInitializer(-0.05, 0.05))
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.row_counts[:-1])]).astype(np.int64)
        total = int(sum(self.row_counts))
        align = lane_pack(self.out_dim) * 8
        self.total_rows = -(-total // align) * align  # padded row space
        if self.total_rows >= 2 ** 31:
            raise ValueError(
                f"fused ragged row space ({self.total_rows} rows) "
                "overflows int32 global ids; split the table set")
        if input_tensor.shape[1] != self.num_tables:
            raise ValueError(f"expected (batch, {self.num_tables}, bag) ids, "
                             f"got {input_tensor.shape}")
        b = input_tensor.shape[0]
        self.outputs = [self._make_output((b, self.num_tables, out_dim),
                                          dtype)]
        self._consts = {}  # device -> (offsets, row counts) int64 tensors

    def param_specs(self):
        return [ParameterSpec(self.name, "embedding",
                              (self.total_rows, self.out_dim),
                              dtype=self.table_dtype,
                              initializer=self.kernel_initializer)]

    def table_consts(self, device):
        """The per-table offsets and row counts as int64 tensors on
        ``device``, copied there once."""
        c = self._consts.get(device)
        if c is None:
            c = (torch.as_tensor(self.offsets, device=device),
                 torch.as_tensor(self.row_counts, dtype=torch.int64,
                                 device=device))
            self._consts[device] = c
        return c

    def forward(self, params, xs):
        (idx,) = xs
        rows = params.get("rows__")
        if rows is None:
            rows = self.gather_rows(params["embedding"], idx)
        return [pool(rows, self.aggr, 2).to(self.outputs[0].dtype)]

    def flat_ids(self, idx):
        """``(..., T, bag)`` per-table local ids -> global rows of the
        fused ``(R_total, d)`` space."""
        offsets, _ = self.table_consts(idx.device)
        return idx + offsets.to(idx.dtype)[:, None]

    def gather_rows(self, flat, idx):
        return take_rows(flat, self.flat_ids(idx))

    def scatter_apply(self, flat, idx, row_grads, scale):
        """The row-sparse step on the fused row space, in place; returns
        the table."""
        return row_update_cuda(flat, self.flat_ids(idx), row_grads, scale)
