"""OverlappedEmbedBottom: the table-parallel embedding exchange and the
bottom-MLP dense stack as ONE graph node (counterpart of
``dlrm_flexflow_tpu/ops/overlap_embed.py``), so the exchange can run
beside the dense stack (``parallel/overlap.py``).

Outputs ``[emb (B, T, d), bottom (B, mlp_bot[-1])]``: the tensors the
classic graph's stacked embedding and final bottom Linear produce, so
``apps/dlrm.py`` swaps the chain for this node as a graph-shape switch
and the interaction is unchanged.

Dispatch (per call, from static shapes and knobs):

* **overlap**: the pipelined body, when the op was built with ``overlap
  != 'off'``, a manual exchange is engaged (``FFConfig.table_exchange``
  and a model axis of more than one rank), the rank's batch divides the
  microbatch count, and under ``'auto'`` the
  ``kernel_costs.exchange_overlap_wins`` gate says the hidden time pays
  for the extra microbatch boundaries.  ``FF_EXCHANGE_OVERLAP``
  overrides: ``auto`` (default) | ``on`` | ``off``, read at import.
* **serial**: the plain ``table_parallel_lookup`` exchange (or the
  stacked lookup with no exchange engaged) next to one full-batch dense
  stack: the classic graph's values bit for bit.

The dense layers are the ``Linear`` op's math (``ops/base.py::matmul``,
the bias, the activation in f64 rounded once), so both graph shapes give
the same bottoms.  Under the exchange the params are the rank's blocks:
the T/mp tables and the replicated bottom weights.
"""

from __future__ import annotations

import os

import torch

from ..initializers import DEFAULT_BIAS_INIT, DEFAULT_KERNEL_INIT
from ..tensor import ParameterSpec
from .base import activation_fn, matmul
from .embedding import StackedEmbedding

#: per-process dispatch override: "auto" consults the
#: exchange_overlap_wins gate per call, "on"/"off" force the pipeline or
#: the serial exchange
_IMPL = os.environ.get("FF_EXCHANGE_OVERLAP", "auto")

OVERLAP_MODES = ("off", "auto", "on")


class OverlappedEmbedBottom(StackedEmbedding):
    op_type = "OverlappedEmbedBottom"

    #: the row-sparse path must not adopt this op: its params carry the
    #: bottom-MLP weights beside the table
    sparse_path_ok = False

    def __init__(self, name, ids_tensor, dense_tensor, num_tables: int,
                 num_entries: int, out_dim: int, mlp_bot,
                 sigmoid_bot: int = -1, aggr: str = "sum",
                 overlap: str = "auto", microbatches: int = 2,
                 kernel_initializer=None, dtype=torch.float32,
                 table_dtype=torch.float32, compute_dtype=None):
        super().__init__(name, ids_tensor, num_tables, num_entries,
                         out_dim, aggr, kernel_initializer, dtype,
                         table_dtype)
        if overlap not in OVERLAP_MODES:
            raise ValueError(f"overlap must be one of {OVERLAP_MODES}, "
                             f"got {overlap!r}")
        self.mlp_bot = [int(x) for x in mlp_bot]
        if len(self.mlp_bot) < 2:
            raise ValueError("mlp_bot needs at least (in, out) widths")
        if int(dense_tensor.shape[1]) != self.mlp_bot[0]:
            raise ValueError(
                f"dense input width {dense_tensor.shape[1]} != "
                f"mlp_bot[0] {self.mlp_bot[0]}")
        self.sigmoid_bot = int(sigmoid_bot)
        self.overlap = overlap
        self.microbatches = int(microbatches)
        self.compute_dtype = compute_dtype
        self.inputs = [ids_tensor, dense_tensor]
        b = ids_tensor.shape[0]
        self.outputs = [
            self._make_output((b, num_tables, out_dim), dtype),
            self._make_output((b, self.mlp_bot[-1]), dtype, idx=1),
        ]

    # ---------------------------------------------------------- parameters
    def param_specs(self):
        specs = list(super().param_specs())  # the (T, R, d) table
        for i in range(len(self.mlp_bot) - 1):
            # sharded_dim=None: the bottom stack stays replicated under a
            # table-parallel strategy (the classic graph's DP MLP layout)
            specs.append(ParameterSpec(
                self.name, f"bot{i}_kernel",
                (self.mlp_bot[i], self.mlp_bot[i + 1]),
                initializer=DEFAULT_KERNEL_INIT))
            specs.append(ParameterSpec(
                self.name, f"bot{i}_bias", (self.mlp_bot[i + 1],),
                initializer=DEFAULT_BIAS_INIT))
        return specs

    # -------------------------------------------------------- dense stack
    def _bottom_apply(self, params, x):
        """The bottom MLP on ``x``, layer for layer the classic graph's
        Linear ops (matmul, bias, activation in f64 rounded once)."""
        out_dtype = self.outputs[1].dtype
        for i in range(len(self.mlp_bot) - 1):
            act = "sigmoid" if i == self.sigmoid_bot else "relu"
            y = matmul(x, params[f"bot{i}_kernel"], self.compute_dtype)
            y = y + params[f"bot{i}_bias"]
            x = activation_fn(act)(y.double()).to(out_dtype)
        return x

    def _bot_params(self, params):
        return {k: v for k, v in params.items() if k.startswith("bot")}

    def _dense_flops(self, batch: int) -> int:
        f = 0
        for i in range(len(self.mlp_bot) - 1):
            f += 2 * batch * self.mlp_bot[i] * self.mlp_bot[i + 1]
        return f

    # ----------------------------------------------------------- dispatch
    def _overlap_now(self, idx) -> bool:
        """Whether this call runs the pipelined body; ``idx`` is the
        rank's data shard of the ids."""
        if not self.exchange_mode or self._mesh is None:
            return False
        mode = self.overlap
        if _IMPL in ("on", "off"):
            mode = _IMPL
        if mode == "off":
            return False
        from ..parallel.mesh import MODEL_AXIS
        from ..parallel.overlap import microbatch_ok
        mp = self._mesh.shape.get(MODEL_AXIS, 1)
        local_b = int(idx.shape[0])
        if not microbatch_ok(local_b, mp, self.microbatches,
                             self.exchange_mode):
            return False
        if mode == "on":
            return True
        from .kernel_costs import exchange_overlap_wins
        # f32 rows ride the exchange whatever the storage dtype
        return exchange_overlap_wins(
            local_b, self.num_tables, self.out_dim, 4,
            mp, self._dense_flops(local_b), self.microbatches,
            self.exchange_mode)

    # ------------------------------------------------------------ forward
    def forward(self, params, xs, *, training=False, rng=None):
        idx, dense_in = xs
        out_dtype = self.outputs[0].dtype
        bot = self._bot_params(params)
        qscale = params.get("qscale__")
        if self.exchange_mode:
            table = params["embedding"]
            if qscale is not None:
                # quantized contract: in-table clamping
                idx = idx.clamp(0, self.num_entries - 1)
            if self._overlap_now(idx):
                from ..parallel.overlap import overlapped_embed_bottom
                emb, bottom = overlapped_embed_bottom(
                    table, idx, dense_in, self._mesh,
                    self._bottom_apply, bot,
                    aggr=self.aggr, mode=self.exchange_mode,
                    microbatches=self.microbatches, qscale=qscale)
                return [emb.to(out_dtype),
                        bottom.to(self.outputs[1].dtype)]
            from ..parallel.table_exchange import table_parallel_lookup
            emb = table_parallel_lookup(table, idx, self._mesh,
                                        self.aggr, self.exchange_mode,
                                        qscale=qscale)
            bottom = self._bottom_apply(bot, dense_in)
            if self.exchange_mode == "all_to_all":
                # the exchange keeps this model rank's chunk of the rows
                from ..parallel.mesh import MODEL_AXIS
                mp = self._mesh.shape.get(MODEL_AXIS, 1)
                n = bottom.shape[0] // mp
                j = self._mesh.axis_index((MODEL_AXIS,))
                bottom = bottom[j * n:(j + 1) * n]
            return [emb.to(out_dtype), bottom]
        # no exchange engaged: the parent's lookup next to one
        # full-batch dense stack
        tables = {k: v for k, v in params.items() if not k.startswith("bot")}
        emb = super().forward(tables, [idx], training=training, rng=rng)[0]
        bottom = self._bottom_apply(bot, dense_in)
        return [emb, bottom]

    # --------------------------------------------------------- cost hooks
    def flops(self, batch):
        bag = (self.inputs[0].shape[2]
               if len(self.inputs[0].shape) > 2 else 1)
        return (batch * self.num_tables * bag * self.out_dim
                + self._dense_flops(batch))

    def exchange_overlap_cost(self, machine, num_parts: int):
        """Overlap-aware analytic pricing (``sim/cost_model.py``): the
        exchange and the dense stack pay ``max`` per microbatch when the
        pipeline is engaged, their sum when serial.  ``overlapped``
        mirrors ``_overlap_now`` with what the simulator knows: the
        ``FF_EXCHANGE_OVERLAP`` override, the microbatch divisibility of
        the per-part batch and, under ``'auto'``, the same gate.  On an
        uncompiled probe model (no mesh) ``num_parts`` stands in for the
        model axis; on a compiled model without an engaged exchange the
        serial sum applies."""
        from ..parallel.mesh import MODEL_AXIS
        from ..parallel.overlap import microbatch_ok
        from ..sim.cost_model import overlapped_exchange_time
        np_ = max(num_parts, 1)
        b = self.outputs[0].shape[0]
        t, d = self.num_tables, self.out_dim
        bag = (self.inputs[0].shape[2]
               if len(self.inputs[0].shape) > 2 else 1)
        mp = (self._mesh.shape.get(MODEL_AXIS, 1)
              if self._mesh is not None else min(np_, t))
        itemsize = 4  # f32 rows ride the exchange (int8 dequants first)
        lookup_s = machine.memory_time(b * t * bag * d * itemsize / np_)
        ex_bytes = b * t * d * itemsize / np_
        ex_s = (machine.all_gather_time(ex_bytes, mp)
                if (self.exchange_mode or "allgather") == "allgather"
                else machine.all_to_all_time(ex_bytes, mp))
        dense_s = sum(
            machine.matmul_time(2.0 * b * self.mlp_bot[i]
                                * self.mlp_bot[i + 1] / np_,
                                str(self.compute_dtype or "float32"))
            for i in range(len(self.mlp_bot) - 1))
        mode = self.overlap
        if _IMPL in ("on", "off"):
            mode = _IMPL
        xmode = self.exchange_mode or "allgather"
        local_b = b // np_
        engaged = self.exchange_mode is not None or self._mesh is None
        overlapped = (mode != "off" and mp > 1 and engaged
                      and microbatch_ok(local_b, mp, self.microbatches,
                                        xmode))
        if overlapped and mode != "on":
            from .kernel_costs import exchange_overlap_wins
            overlapped = exchange_overlap_wins(
                local_b, t, d, 4, mp, self._dense_flops(local_b),
                self.microbatches, xmode)
        fwd = lookup_s + overlapped_exchange_time(
            machine, ex_s, dense_s, self.microbatches,
            overlapped=overlapped) + machine.kernel_launch_overhead
        # the backward mirrors the pipeline (dgrad + wgrad ~ 2x the dense
        # FLOPs)
        bwd = lookup_s + overlapped_exchange_time(
            machine, ex_s, 2.0 * dense_s, self.microbatches,
            overlapped=overlapped) + machine.kernel_launch_overhead
        return fwd, bwd
