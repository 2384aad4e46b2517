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
out-of-range id is dropped).  The JAX package's lane-packed storage is a
TPU feature with no counterpart here.

An ``Embedding`` placed on the host (``placement == "cpu"``, set by
``FFModel.compile`` from a strategy's ``"cpu"`` device type: the hetero
strategy) keeps its table in host memory (``ops/hetero.py``): its
params hold only the scalar ``handle``, ``init_params`` draws the table
on the host, and the forward pools bagged ``(B, bag)`` ids through
``host_embedding_bag``.  Across the ranks of a mesh (``_host_comm``, set
by ``compile``) only the owner rank holds the table (``host_owner``);
the forward called outside the mesh executor (a replica engine's whole
bucket on every rank) takes the leader's bag with every rank holding
the whole batch.

Tables are stored in ``table_dtype``, f32 or bf16
(``FFConfig.embedding_dtype``).  The forward follows the JAX package's
(``ops/embedding.py:120-148``): the rows are gathered in the table's
dtype, dequantized when the params carry an int8 serving table's scale
(``qscale__``, ``ops/quantized.py``), pooled, and cast to the op's
declared output dtype.  A bf16 bag is pooled as ``jnp.sum`` and
``jnp.mean`` pool it (``pool``); the bag kernel keeps the TPU kernel's
own bf16 sum.  An int8 table never takes the bag kernel, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..initializers import ConstantInitializer, UniformInitializer
from ..tensor import ParameterSpec
from .bag_kernel import embedding_bag_cuda
from .base import Op
from .fused_interact_kernel import divide
from .quantized import QSCALE_KEY, dequant_rows
from .row_update_kernel import TABLE_DTYPES, row_update_cuda

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
    ``[0, R)`` reads a row of NaN (of the integer dtype's minimum for an
    int8 table, ``jnp.take``'s fill).  Returns ``ids.shape + (d,)``."""
    r = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + r, ids)
    ok = (ids >= 0) & (ids < r)
    rows = table[torch.where(ok, ids, torch.zeros_like(ids))]
    fill = (float("nan") if table.is_floating_point()
            else torch.iinfo(table.dtype).min)
    return torch.where(ok[..., None], rows,
                       torch.full((), fill, dtype=table.dtype,
                                  device=table.device))


def pool(rows, aggr: str, dim: int):
    """``jnp.sum`` or ``jnp.mean`` over the bag axis ``dim``.  f32 rows
    sum in f32, ``avg`` divides the sum by the bag (a true division:
    ``torch.mean`` multiplies by the reciprocal and can round
    differently).  bf16 rows pool as JAX pools a low-precision bag: the
    sum in f32 in bag order, ``avg`` divided in f32, rounded to bf16
    once."""
    if rows.dtype != torch.bfloat16:
        pooled = rows.sum(dim=dim)
        return divide(pooled, rows.shape[dim]) if aggr == "avg" else pooled
    bag = rows.shape[dim]
    acc = (rows.select(dim, 0).float() if bag else
           rows.sum(dim=dim, dtype=torch.float32))
    for j in range(1, bag):
        acc = acc + rows.select(dim, j).float()
    if aggr == "avg":
        acc = divide(acc, bag)
    return acc.to(rows.dtype)


def check_table_dtype(name, table_dtype):
    """``table_dtype`` when the port stores tables in it (f32 or bf16),
    else TypeError."""
    if table_dtype not in TABLE_DTYPES:
        raise TypeError(f"{name}: embedding tables are float32 or "
                        f"bfloat16, got {table_dtype}")
    return table_dtype


def gather_dequant(table, qscale, gids):
    """``take_rows(table, gids)``, dequantized to f32 when ``qscale`` (an
    int8 serving table's scale column) is given."""
    rows = take_rows(table, gids)
    return rows if qscale is None else dequant_rows(rows, qscale, gids)


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
        self.table_dtype = check_table_dtype(name, table_dtype)
        # the JAX package's flag and eligibility: the bag kernel's path
        # (the d % 128 rule is the TPU's lane tiling; the Hopper kernel
        # needs none of it, but the op must take the reference's path)
        self.use_pallas = use_pallas and out_dim % 128 == 0
        # "tpu" (the accelerator, the strategy files' name for it) or
        # "cpu" (the table in host memory), set by compile
        self.placement = "tpu"
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
        if self.placement == "cpu":
            # the table is in host memory: the params hold the handle
            return [ParameterSpec(self.name, "handle", (),
                                  initializer=ConstantInitializer(1.0))]
        return [ParameterSpec(self.name, "embedding",
                              (self.num_entries, self.out_dim),
                              dtype=self.table_dtype,
                              initializer=self.kernel_initializer,
                              sharded_dim=1)]

    def init_params(self, generator):
        """The params (``Op.init_params``); a host-placed op also draws
        its f32 table on the host, from a CPU generator seeded as
        ``generator`` was, so the table is the same whatever device the
        params go to, and evicts it from the store when the op dies."""
        if self.placement == "cpu" and self.host_owner:
            host = torch.Generator().manual_seed(generator.initial_seed())
            self.set_host_table(self.kernel_initializer(
                host, (self.num_entries, self.out_dim)).numpy())
        return super().init_params(generator)

    @property
    def host_owner(self) -> bool:
        """Whether this process holds the op's host table: always off a
        mesh of more than one rank, else on the owner rank alone."""
        comm = getattr(self, "_host_comm", None)
        return comm is None or comm.is_owner

    def set_host_table(self, array) -> None:
        """Install ``array`` as this host-placed op's table: a new store
        entry at the first call (evicted when the op dies), a rebind
        after."""
        if getattr(self, "host_table", None) is not None:
            self.host_table.array = array
            return
        import weakref

        from .hetero import HostEmbeddingTable
        self.host_table = HostEmbeddingTable(f"{self.name}@{id(self)}",
                                             array)
        weakref.finalize(self, HostEmbeddingTable.drop, self.host_table.key)

    def forward(self, params, xs, *, training=False, rng=None):
        (idx,) = xs
        if self.placement == "cpu":
            from .hetero import host_embedding_bag
            if idx.dim() != 2:
                raise ValueError(f"{self.name}: a host-placed table takes "
                                 f"bagged (B, bag) ids, got {tuple(idx.shape)}")
            aggr = self.aggr if self.aggr != "none" else "sum"
            table = getattr(self, "host_table", None)
            out = host_embedding_bag(idx, params["handle"],
                                     table.key if table else None,
                                     self.out_dim, aggr,
                                     comm=getattr(self, "_host_comm", None))
            return [out.to(self.outputs[0].dtype)]
        rows = params.get("rows__")
        qscale = params.get(QSCALE_KEY)
        if rows is None:
            # the JAX package's conditions for its bag kernel (no
            # quantization scale; 2-D ids; sum or avg; B % 8 == 0, the
            # TPU's sublane tile)
            if (self.use_pallas and qscale is None and idx.dim() == 2
                    and self.aggr in ("sum", "avg") and idx.shape[0] % 8 == 0
                    and self._allow_kernel):
                out = EmbeddingBagFn.apply(params["embedding"], idx,
                                           self.aggr)
                return [out.to(self.outputs[0].dtype)]
            rows = gather_dequant(params["embedding"], qscale, idx)
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

    def flops(self, batch):
        bag = self.inputs[0].shape[1] if len(self.inputs[0].shape) > 1 else 1
        return batch * bag * self.out_dim  # bandwidth-bound; count adds


class StackedEmbedding(Op):
    """T same-shape tables as one ``(T, rows, dim)`` weight.  Input
    ``(batch, T, bag)`` ids, output ``(batch, T, dim)``.

    ``exchange_mode`` (set by ``compile`` from ``FFConfig.table_exchange``
    under a mesh with a ``"model"`` axis the tables divide) routes the
    lookup through the manual exchange (``parallel/table_exchange.py``):
    the params then hold the rank's T/mp tables and the ids its data
    shard, and the forward returns the rank's block of the output."""

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
        self.table_dtype = check_table_dtype(name, table_dtype)
        self.kernel_initializer = (kernel_initializer
                                   or UniformInitializer(-0.05, 0.05))
        # the manual exchange's mode (compile sets it), None: none
        self.exchange_mode = None
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
                              initializer=self.kernel_initializer,
                              sharded_dim=0)]

    def _offsets(self, idx):
        # one offset per table of ``idx`` (all T, or a rank's T/mp)
        return (torch.arange(idx.shape[-2], dtype=idx.dtype,
                             device=idx.device)[:, None]
                * self.num_entries)

    def forward(self, params, xs, *, training=False, rng=None):
        (idx,) = xs  # (batch, T, bag)
        rows = params.get("rows__")  # sparse-update path: (B, T, bag, d)
        qscale = params.get(QSCALE_KEY)
        if rows is None and self.exchange_mode:
            # the manual exchange (per-table pinning and a collective at
            # the interaction point, dlrm_strategy.cc:242-296); quantized
            # ids follow the in-table clamp contract
            from ..parallel.table_exchange import table_parallel_lookup
            if qscale is not None:
                idx = idx.clamp(0, self.num_entries - 1)
            out = table_parallel_lookup(params["embedding"], idx, self._mesh,
                                        self.aggr, self.exchange_mode,
                                        qscale=qscale)
            return [out.to(self.outputs[0].dtype)]
        if rows is None and qscale is not None:
            # an int8 serving table: local ids clamped into their own
            # table (int8 codes cannot read NaN, so a stray id must never
            # land on a neighbouring table's row), one flat gather, the
            # gathered rows dequantized
            tables = params["embedding"]
            t, r, d = tables.shape
            gids = self.flat_ids(idx.clamp(0, self.num_entries - 1))
            rows = dequant_rows(take_rows(tables.reshape(t * r, d), gids),
                                qscale, gids)
        elif rows is None:
            # each table's own jnp.take (the JAX package vmaps one take
            # per table): wrap and drop per table, then one flat gather.
            # r is the parameter's own row count, which a tiered engine's
            # hot tier (T, slots, d) makes smaller than num_entries
            tables = params["embedding"]
            t, r, d = tables.shape
            local = torch.where(idx < 0, idx + r, idx)
            ok = (local >= 0) & (local < r)
            offsets = torch.arange(t, dtype=idx.dtype,
                                   device=idx.device)[:, None] * r
            gids = torch.where(ok, local + offsets,
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

    def flops(self, batch):
        bag = self.inputs[0].shape[2] if len(self.inputs[0].shape) > 2 else 1
        return batch * self.num_tables * bag * self.out_dim


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
        self.table_dtype = check_table_dtype(name, table_dtype)
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
                              initializer=self.kernel_initializer,
                              sharded_dim=0)]

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

    def forward(self, params, xs, *, training=False, rng=None):
        (idx,) = xs
        rows = params.get("rows__")
        if rows is None:
            rows = gather_dequant(params["embedding"],
                                  params.get(QSCALE_KEY), self.flat_ids(idx))
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

    def flops(self, batch):
        bag = self.inputs[0].shape[2] if len(self.inputs[0].shape) > 2 else 1
        return batch * self.num_tables * bag * self.out_dim
