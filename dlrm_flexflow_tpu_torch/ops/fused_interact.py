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
* an f32 table with a non-empty bag and ``d % 8 == 0``
  (``kernel_eligible``): ``FusedEmbedInteractFn``, the counterpart of the
  JAX package's ``fused_embed_interact`` custom VJP: the forward kernel at
  every batch size on the card, one launch that also masks the local
  ids (``fused_embed_interact_cuda``), the plain version on the CPU;
* any other table (a bf16 training table, an int8 or bf16 serving
  table): the JAX package's emitter path in PyTorch, on every device:
  mask, gather, dequantize an int8 table's rows, ``masked_pool_interact``,
  differentiated by autograd.

The route is the JAX package's static rule (``_kernel_ok``,
``fused_interact.py:78-101``), decided from the table's dtype and the
op's shapes, never by catching an error.  Its cost gate
(``kernel_costs.fused_interact_wins``) holds TPU v5e constants and is not
carried over: on the card an eligible table always takes the kernel.
"""

from __future__ import annotations

import torch

from .embedding import RaggedStackedEmbedding
from .fused_interact_kernel import (BF16_NAMES, fused_embed_interact_cuda,
                                    fused_interact_bwd_cuda,
                                    fused_interact_ref, interact_width,
                                    mask_local_ids, masked_pool_interact)
from .quantized import QSCALE_KEY, dequant_rows
from .row_update_kernel import row_update_cuda


def kernel_eligible(table_dtype, dim: int, bag: int) -> bool:
    """The JAX package's static eligibility of the fused kernels
    (``pallas_fused_interact.py:271-278``): an f32 table, a non-empty bag
    and ``d % 8 == 0``.  bf16 and quantized tables take the emitter
    path."""
    return table_dtype == torch.float32 and bag > 0 and dim % 8 == 0


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
        table = params["embedding"]
        qscale = params.get(QSCALE_KEY)
        if qscale is None and kernel_eligible(table.dtype, self.out_dim,
                                              idx.shape[-1]):
            out = FusedEmbedInteractFn.apply(
                table, bottom.float().contiguous(), idx.contiguous(),
                offsets, row_counts, self.interact, self.aggr,
                self.compute_dtype)
            return [out.to(out_dtype)]
        # the emitter path: the same masked tail as fused_interact_ref,
        # forked only for the int8 table's per-row dequantization
        gids = mask_local_ids(idx, offsets, row_counts)
        safe = gids.clamp_min(0)
        rows = table[safe.long()]
        if qscale is not None:
            rows = dequant_rows(rows, qscale, safe)
        return [masked_pool_interact(rows, gids, bottom, self.interact,
                                     self.aggr, out_dtype,
                                     self.compute_dtype)]

    def flops(self, batch):
        bag = self.inputs[0].shape[2] if len(self.inputs[0].shape) > 2 else 1
        f = batch * self.num_tables * bag * self.out_dim  # gather + pool
        if self.interact == "dot":
            fdim = self.num_tables + 1
            f += 2 * batch * fdim * fdim * self.out_dim  # pairwise dots
        return f
