"""FusedEmbedInteract: embedding bags + feature interaction as ONE graph
node (counterpart of ``dlrm_flexflow_tpu/ops/fused_interact.py``).

Inputs ``[ids (B, T, bag) int, bottom (B, bot_dim)]``; the output is the
interaction itself, ``(B, bot_dim + T*d)`` for ``cat`` and
``(B, d + (T+1)^2)`` for ``dot``.  The tables are the fused flat
``(R_total, d)`` row space of ``RaggedStackedEmbedding``.

Dispatch: a table on a CUDA device runs the Hopper kernel at every batch
size; a table on the CPU runs the plain version.  The JAX package's cost
gate (``kernel_costs.fused_interact_wins``) holds TPU v5e constants and
is not carried over; re-measuring it on the H100 is queued in
ROADMAP.md.
"""

from __future__ import annotations

import torch

from .embedding import RaggedStackedEmbedding
from .fused_interact_kernel import (fused_interact_cuda, interact_width,
                                    mask_local_ids)


class FusedEmbedInteract(RaggedStackedEmbedding):
    op_type = "FusedEmbedInteract"

    def __init__(self, name, ids_tensor, bottom_tensor, row_counts,
                 out_dim: int, interact: str = "cat", aggr: str = "sum",
                 kernel_initializer=None, dtype=torch.float32,
                 table_dtype=torch.float32, compute_dtype=None):
        if table_dtype != torch.float32:
            raise NotImplementedError(
                "FusedEmbedInteract serves f32 tables; bf16 and quantized "
                "tables come with the quantized-serving slice (ROADMAP.md)")
        super().__init__(name, ids_tensor, row_counts, out_dim, aggr,
                         kernel_initializer, dtype, table_dtype)
        self.compute_dtype = compute_dtype  # the dot interaction's precision
        if interact not in ("cat", "dot"):
            raise ValueError(f"unknown interaction op {interact!r}")
        bot_dim = int(bottom_tensor.shape[1])
        if interact == "dot" and bot_dim != out_dim:
            raise ValueError(
                f"dot interaction needs bottom width {out_dim}, "
                f"got {bot_dim}")
        self.interact = interact
        self.bot_dim = bot_dim
        self.inputs = [ids_tensor, bottom_tensor]
        b = ids_tensor.shape[0]
        w = interact_width(interact, self.num_tables, out_dim, bot_dim)
        self.outputs = [self._make_output((b, w), dtype)]

    def forward(self, params, xs):
        idx, bottom = xs
        offsets, row_counts = self.table_consts(idx.device)
        gids = mask_local_ids(idx, offsets, row_counts)
        out = fused_interact_cuda(
            params["embedding"], gids.to(torch.int32).contiguous(),
            bottom.float().contiguous(), interact=self.interact,
            aggr=self.aggr, compute_dtype=self.compute_dtype)
        return [out.to(self.outputs[0].dtype)]

