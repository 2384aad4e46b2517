"""FusedEmbedInteract: embedding bags + feature interaction as ONE graph
node (counterpart of ``dlrm_flexflow_tpu/ops/fused_interact.py``).

Inputs ``[ids (B, T, bag) int, bottom (B, bot_dim)]``; the output is the
interaction itself, ``(B, bot_dim + T*d)`` for ``cat`` and
``(B, d + (T+1)^2)`` for ``dot``.  The tables are the fused flat
``(R_total, d)`` row space of ``RaggedStackedEmbedding``, so the
row-sparse training seam (``flat_ids``/``gather_rows``/``scatter_apply``)
is inherited unchanged.

Forward paths:

* injected ``rows__`` (the row-sparse training step): mask the dropped
  slots, pool and interact in plain PyTorch, differentiated by autograd
  with respect to the rows;
* otherwise ``FusedEmbedInteractFn``, the counterpart of the JAX
  package's ``fused_embed_interact`` custom VJP: the forward kernel at
  every batch size on the card, one launch that also masks the local
  ids (``fused_embed_interact_cuda``), the plain version on the CPU.
  The JAX package's cost gate (``kernel_costs.fused_interact_wins``)
  holds TPU v5e constants and is not carried over; re-measuring it on
  the H100 is queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from .embedding import RaggedStackedEmbedding
from .fused_interact_kernel import (BF16_NAMES, fused_embed_interact_cuda,
                                    fused_interact_bwd_cuda,
                                    fused_interact_ref, interact_width,
                                    mask_local_ids, masked_pool_interact)
from .row_update_kernel import row_update_cuda


class FusedEmbedInteractFn(torch.autograd.Function):
    """The differentiable fused gather -> pool -> interact, on the op's
    local ids ``(B, T, bag)`` and its per-table offsets and row counts.

    Forward: one launch that masks the ids, gathers, pools and
    interacts; when a gradient is wanted it also writes the masked int32
    flat ids, which the backward reads.

    Backward at f32: the fused backward kernel gives the per-slot row
    grads, ``dbottom`` and, in the same launch, the scatter's ids
    ``max(gids, 0)`` (the JAX package's ``safe`` ids; dropped slots carry
    exact 0.0); the dense table gradient is then ONE deterministic
    scatter of the row grads into a zero table through the row-update
    kernel.  ``index_add_`` would add duplicates in an atomic order that
    changes from run to run.

    Backward under bf16 compute: autograd of the plain formulation, as
    the JAX package's ``_bwd`` falls back to the emitter VJP there (the
    bf16 operand casts of ``dot`` have no backward kernel)."""

    @staticmethod
    def forward(ctx, table, bottom, idx, offsets, row_counts, interact,
                aggr, compute_dtype):
        out, gids = fused_embed_interact_cuda(
            table, idx, offsets, row_counts, bottom, interact=interact,
            aggr=aggr, compute_dtype=compute_dtype,
            want_gids=any(ctx.needs_input_grad[:2]))
        ctx.save_for_backward(table, bottom, gids)
        ctx.config = (interact, aggr, compute_dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        table, bottom, gids = ctx.saved_tensors
        interact, aggr, compute_dtype = ctx.config
        if compute_dtype in BF16_NAMES:
            with torch.enable_grad():
                t = table.detach().requires_grad_()
                b = bottom.detach().requires_grad_()
                out = fused_interact_ref(t, gids, b, interact=interact,
                                         aggr=aggr,
                                         compute_dtype=compute_dtype)
                dtable, dbottom = torch.autograd.grad(out, (t, b), g)
            return dtable, dbottom, None, None, None, None, None, None
        rowg, dbottom, safe = fused_interact_bwd_cuda(
            table, gids, bottom, g.contiguous(), interact=interact,
            aggr=aggr, want_safe=True)
        dtable = row_update_cuda(torch.zeros_like(table), safe, rowg, 1.0)
        return dtable, dbottom, None, None, None, None, None, None


class FusedEmbedInteract(RaggedStackedEmbedding):
    op_type = "FusedEmbedInteract"

    def __init__(self, name, ids_tensor, bottom_tensor, row_counts,
                 out_dim: int, interact: str = "cat", aggr: str = "sum",
                 kernel_initializer=None, dtype=torch.float32,
                 table_dtype=torch.float32, compute_dtype=None):
        if table_dtype != torch.float32:
            raise NotImplementedError(
                "FusedEmbedInteract runs f32 tables; bf16 and quantized "
                "tables come with the serving-extras slice (ROADMAP.md)")
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
        out_dtype = self.outputs[0].dtype
        offsets, row_counts = self.table_consts(idx.device)
        rows = params.get("rows__")  # the row-sparse step: (B, T, bag, d)
        if rows is not None:
            gids = mask_local_ids(idx, offsets, row_counts)
            # the rows came from gather_rows (jnp.take semantics); the
            # mask keeps the dropped-id rule in training too: a dropped
            # slot pools as 0.0, so its row grad is exact 0.0 and
            # scatter_apply leaves the addressed row as it was
            return [masked_pool_interact(rows, gids, bottom, self.interact,
                                         self.aggr, out_dtype,
                                         self.compute_dtype)]
        out = FusedEmbedInteractFn.apply(
            params["embedding"], bottom.float().contiguous(),
            idx.contiguous(), offsets, row_counts, self.interact, self.aggr,
            self.compute_dtype)
        return [out.to(out_dtype)]
