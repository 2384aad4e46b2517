"""Ragged stacked embedding (counterpart of ``RaggedStackedEmbedding`` in
``dlrm_flexflow_tpu/ops/embedding.py``).

T tables of different row counts and one dim live in ONE logical
``(R_total, d)`` row space with static per-table offsets.  The row space
is padded to the JAX package's alignment so that parameters cross between
the packages with identical shapes; padding rows are never addressed.
The JAX package's lane-packed storage is a TPU tiling workaround and has
no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..initializers import UniformInitializer
from ..tensor import ParameterSpec
from .base import Op


def lane_pack(dim: int) -> int:
    """Rows per 128-lane view row of the JAX package's packed storage
    (it sets the row-space alignment, ``lane_pack(d) * 8``)."""
    if dim < 128 and 128 % dim == 0:
        return 128 // dim
    return 1


class RaggedStackedEmbedding(Op):
    """Input ``(batch, T, bag)`` per-table local ids.  In this slice it
    is the base of ``FusedEmbedInteract`` (row space, offsets,
    ``flat_ids``); its own forward, ``(batch, T, dim)`` pooled rows, comes
    with the classic graph in slice 2."""

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
        self.table_dtype = table_dtype
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

    def flat_ids(self, idx):
        """``(..., T, bag)`` per-table local ids -> global rows of the
        fused ``(R_total, d)`` space."""
        offsets, _ = self.table_consts(idx.device)
        return idx + offsets.to(idx.dtype)[:, None]

