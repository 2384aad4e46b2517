"""FFModel: the graph builder, its forward and its training loop.

Counterpart of ``dlrm_flexflow_tpu/model.py``.  The graph is a list of
ops built by the reference's factory API; ``compile`` fixes the loss,
metrics and optimizer and builds the forward; ``init`` or ``load_params``
places the parameters on a device.  PyTorch runs eagerly, so there is no
jit: the forward is one Python sweep over the ops, and no op bakes in the
batch size, so one graph serves every serving bucket.

Training follows the JAX package's step (``model.py:973-1055``).  Under
plain SGD with ``sparse_embedding_updates`` not "off", every embedding op
whose ids are a model input takes the row-sparse path: its looked-up rows
are gathered outside autograd, the loss is differentiated with respect to
those rows, the dense parameters take the SGD step, and
``scatter_apply(-lr)`` adds the row grads back into the table in place
(the row-update kernel on the card).  Otherwise every parameter, tables
included, takes the dense gradient.

``train_epoch``, ``train_epochs`` and ``fit``'s staged branch follow the
JAX package's scanned epoch (``model.py:1891-1928``, ``:2115-2254``,
``:2314-2566``): a Python loop takes the place of ``lax.scan``, and with
the epoch row cache active (``epoch_cache.py``) the row-sparse ops step
against a small cache of the epoch's rows, nested in the cache ladder,
with every writeback through the row-set kernel on the card.  A mesh
comes with the scale-out slice; checkpoints and resilient training with
the durability slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .config import FFConfig
from .device import resolve_device
from .epoch_cache import (build_cache, cache_fetch, cache_writeback,
                          ladder_arrays, ladder_meta, named_levels)
from .initializers import derive_seed
from .losses import get_loss
from .metrics import MetricsAccumulator, compute_metrics
from .ops import (BatchMatmul, Concat, Embedding, Flat, FusedEmbedInteract,
                  Linear, Op, RaggedStackedEmbedding, Reshape,
                  StackedEmbedding, Transpose)
from .ops.embedding import lane_pack
from .ops.row_update_kernel import row_update_cuda
from .optim import Optimizer, SGDOptimizer
from .tensor import Tensor, as_dtype, numpy_dtype

EMBEDDING_OPS = (Embedding, StackedEmbedding, RaggedStackedEmbedding)
_CCE = ("sparse_categorical_crossentropy", "sparse_crossentropy",
        "categorical_crossentropy", "crossentropy")
_DURABILITY = ("checkpointed and resilient training (checkpoint_manager, "
               "checkpoint cadences, resume, sentinel) is not ported yet: "
               "it comes with the durability slice in ROADMAP.md")
_CALLBACKS = ("fit(callbacks=...) is not ported yet: keras-style callbacks "
              "come with the optimizer, schedules and data item of "
              "ROADMAP.md (Queue A item 7)")
_MODES = ("auto", "on", "off")


@dataclass
class TrainState:
    """Parameters ``{op: {param: tensor}}``, the optimizer state (``step``,
    ``lr`` and, under momentum, ``v``) and the step count, on one device.

    ``FFModel.train_step`` consumes its input state, as the JAX package's
    donated step does: the tables and dense parameters are updated in
    place and the returned state holds the same tensors.  A state that
    must survive a step goes in with ``donate=False``, or is ``clone``d."""

    params: Dict[str, Dict[str, torch.Tensor]]
    opt_state: Dict[str, Any] = field(default_factory=dict)
    step: Optional[torch.Tensor] = None

    def clone(self) -> "TrainState":
        def copy(x):
            if isinstance(x, dict):
                return {k: copy(v) for k, v in x.items()}
            return x.clone() if isinstance(x, torch.Tensor) else x
        return TrainState(copy(self.params), copy(self.opt_state),
                          copy(self.step))


def params_device(params) -> torch.device:
    for d in params.values():
        for v in d.values():
            return v.device
    return torch.device("cpu")


class FFModel:
    """Graph builder with the reference's factory API."""

    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.layers: List[Op] = []
        self._inputs: List[Tensor] = []
        self._name_counts: Dict[str, int] = {}
        self._forward_fn = None
        # the device of the last init/load_params
        self.device: Optional[torch.device] = None
        # set by compile()
        self.optimizer: Optional[Optimizer] = None
        self.loss_type: Optional[str] = None
        self.metrics: Tuple[str, ...] = ()
        self._loss_fn = None
        self._sparse_ops: List[Op] = []
        # whether train_epoch(s) run the epoch row cache: resolved from
        # the tables' device by each epoch entry point (_resolve_cache)
        self._epoch_cache_active = False
        self._last_fit_used_scan = False
        self._last_metrics = MetricsAccumulator(())

    # ------------------------------------------------------------------ utils
    def _name(self, base: str, name: Optional[str] = None) -> str:
        if name is not None:
            return name
        n = self._name_counts.get(base, 0)
        self._name_counts[base] = n + 1
        return f"{base}_{n}" if n else base

    def _add(self, op: Op):
        self.layers.append(op)
        return op.outputs[0] if len(op.outputs) == 1 else op.outputs

    # ------------------------------------------------------- graph building
    def create_tensor(self, shape, dtype="float32", name: Optional[str] = None
                      ) -> Tensor:
        """Input placeholder; ``shape[0]`` is the batch size, which the
        forward does not fix."""
        t = Tensor(shape=tuple(shape), dtype=as_dtype(dtype),
                   name=self._name("input", name))
        self._inputs.append(t)
        return t

    def dense(self, input_tensor, out_dim, activation=None, use_bias=True,
              kernel_initializer=None, bias_initializer=None, name=None,
              compute_dtype=None):
        op = Linear(self._name("dense", name), input_tensor, out_dim,
                    activation, use_bias, kernel_initializer,
                    bias_initializer,
                    compute_dtype or self._op_compute_dtype())
        return self._add(op)

    def _table_dtype(self, table_dtype):
        if table_dtype is not None:
            return as_dtype(table_dtype)
        return as_dtype(getattr(self.config, "embedding_dtype", "float32"))

    def embedding(self, input_tensor, num_entries, out_dim, aggr="sum",
                  kernel_initializer=None, name=None, table_dtype=None):
        op = Embedding(self._name("embedding", name), input_tensor,
                       num_entries, out_dim, aggr, kernel_initializer,
                       table_dtype=self._table_dtype(table_dtype))
        return self._add(op)

    def stacked_embedding(self, input_tensor, num_tables, num_entries,
                          out_dim, aggr="sum", kernel_initializer=None,
                          name=None, table_dtype=None):
        op = StackedEmbedding(self._name("stacked_embedding", name),
                              input_tensor, num_tables, num_entries, out_dim,
                              aggr, kernel_initializer,
                              table_dtype=self._table_dtype(table_dtype))
        return self._add(op)

    def ragged_stacked_embedding(self, input_tensor, row_counts, out_dim,
                                 aggr="sum", kernel_initializer=None,
                                 name=None, table_dtype=None):
        """T different-sized tables fused into one row space."""
        op = RaggedStackedEmbedding(
            self._name("ragged_stacked_embedding", name), input_tensor,
            row_counts, out_dim, aggr, kernel_initializer,
            table_dtype=self._table_dtype(table_dtype))
        return self._add(op)

    def fused_embed_interact(self, ids_tensor, bottom_tensor, row_counts,
                             out_dim, interact="cat", aggr="sum",
                             kernel_initializer=None, name=None,
                             table_dtype=None):
        """Embedding bags + DLRM feature interaction as ONE node over the
        fused flat row space (ops/fused_interact.py)."""
        op = FusedEmbedInteract(
            self._name("fused_embed_interact", name), ids_tensor,
            bottom_tensor, row_counts, out_dim, interact, aggr,
            kernel_initializer, table_dtype=self._table_dtype(table_dtype),
            compute_dtype=self._op_compute_dtype())
        return self._add(op)

    def concat(self, tensors, axis, name=None):
        return self._add(Concat(self._name("concat", name), tensors, axis))

    def reshape(self, input_tensor, shape, name=None):
        return self._add(Reshape(self._name("reshape", name), input_tensor,
                                 shape))

    def transpose(self, input_tensor, perm=None, name=None):
        return self._add(Transpose(self._name("transpose", name),
                                   input_tensor, perm))

    def flat(self, input_tensor, name=None):
        return self._add(Flat(self._name("flat", name), input_tensor))

    def batch_matmul(self, a, b, trans_a=False, trans_b=False, name=None):
        return self._add(BatchMatmul(self._name("batch_matmul", name), a, b,
                                     trans_a, trans_b,
                                     self._op_compute_dtype()))

    def _op_compute_dtype(self):
        cd = self.config.compute_dtype
        return cd if cd != "float32" else None

    def get_op(self, name: str) -> Op:
        for op in self.layers:
            if op.name == name:
                return op
        raise KeyError(name)

    @property
    def final_tensor(self) -> Tensor:
        return self.layers[-1].outputs[0]

    def _output_is_softmaxed(self) -> bool:
        """Whether the graph output is already probabilities: a layer
        with a softmax activation, followed only by shape ops."""
        for op in reversed(self.layers):
            if getattr(op, "activation", None) == "softmax":
                return True
            if not isinstance(op, (Reshape, Transpose, Flat)):
                return False
        return False

    # --------------------------------------------------------------- forward
    def _apply(self, params, input_values: Dict[str, torch.Tensor]):
        """Run the graph: every op once, in build order."""
        values: Dict[int, torch.Tensor] = {}
        for t in self._inputs:
            if t.name in input_values:
                values[t.uid] = input_values[t.name]
        for op in self.layers:
            xs = [values[t.uid] for t in op.inputs]
            outs = op.forward(params.get(op.name, {}), xs)
            for o, t in zip(outs, op.outputs):
                values[t.uid] = o
        return values

    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type="mean_squared_error", metrics=("accuracy",),
                mesh=None):
        """Fix the optimizer (default: SGD at the config's learning rate
        and weight decay), the loss and the metrics; choose the row-sparse
        embedding ops; build the forward.  ``mesh`` may be None or False
        (one device); a mesh comes with the scale-out slice in
        ROADMAP.md."""
        if mesh not in (None, False):
            raise NotImplementedError(
                "a device mesh is not ported yet: it comes with the "
                "scale-out slice in ROADMAP.md")
        act = getattr(self.config, "activation_dtype", "float32")
        if act != "float32":
            raise NotImplementedError(
                f"activation_dtype={act!r} is not ported yet (float32 only)")
        for name in ("sparse_embedding_updates", "epoch_row_cache"):
            mode = getattr(self.config, name)
            if mode not in _MODES:
                raise ValueError(f"{name} must be 'auto'|'on'|'off', "
                                 f"got {mode!r}")
        self.optimizer = optimizer or SGDOptimizer(
            lr=self.config.learning_rate,
            weight_decay=self.config.weight_decay)
        self.loss_type = (loss_type if isinstance(loss_type, str)
                          else getattr(loss_type, "__name__", "custom"))
        self._loss_fn = get_loss(loss_type)
        if self.loss_type in _CCE and not self._output_is_softmaxed():
            # a graph ending in raw logits trains with the stable fused
            # softmax + CCE form
            base = ("sparse_categorical_crossentropy"
                    if "sparse" in self.loss_type
                    else "categorical_crossentropy")
            self._loss_fn = get_loss(base + "_from_logits")
        self.metrics = tuple(metrics)
        out = self.final_tensor
        final_uid, final_dtype = out.uid, out.dtype

        opt = self.optimizer
        plain_sgd = (isinstance(opt, SGDOptimizer) and opt.momentum == 0.0
                     and opt.weight_decay == 0.0)
        input_uids = {t.uid for t in self._inputs}
        sparse_ok = (self.config.sparse_embedding_updates != "off"
                     and plain_sgd)
        # the bag-kernel ops (use_pallas) keep the dense gradient, as the
        # JAX package's _device_table_op leaves them out
        self._sparse_ops = [op for op in self.layers
                            if sparse_ok and isinstance(op, EMBEDDING_OPS)
                            and not getattr(op, "use_pallas", False)
                            and op.inputs[0].uid in input_uids]

        def forward(params, inputs):
            with torch.inference_mode():
                return self._apply(params, inputs)[final_uid].to(final_dtype)

        self._forward_fn = forward
        return self

    # ------------------------------------------------------------ parameters
    def _place_opt_state(self, opt_state, dev):
        def place(x):
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))
            return x.to(dev)
        return place(opt_state)

    def init(self, seed: Optional[int] = None, *, device=None
             ) -> TrainState:
        """Draw every op's parameters on ``device`` (default: the CUDA
        card; raises without one) from generators seeded by ``seed`` and
        the op's position, and the optimizer's initial state."""
        dev = resolve_device(device)
        seed = self.config.seed if seed is None else seed
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, op in enumerate(self.layers):
            if not op.param_specs():
                continue
            gen = torch.Generator(device=dev).manual_seed(
                derive_seed(seed, i, op.name))
            params[op.name] = op.init_params(gen)
        self.device = dev
        return self._state(params, None, dev)

    def _state(self, params, opt_state, dev) -> TrainState:
        if opt_state is None:
            opt_state = (self.optimizer.init(params)
                         if self.optimizer is not None else {})
        else:
            opt_state = self._place_opt_state(opt_state, dev)
        return TrainState(params, opt_state,
                          torch.zeros((), dtype=torch.int32, device=dev))

    def load_params(self, params, device=None, opt_state=None) -> TrainState:
        """Install ``{op: {param: array or tensor}}`` (for example
        ``bridge.params_from_jax`` of a JAX model's params) on ``device``
        (default: this model's device, else the CUDA card).  Names, shapes
        and dtypes must match the graph's parameter specs exactly.
        ``opt_state`` (for example ``bridge.opt_state_from_jax``) is
        placed beside them; by default the optimizer starts afresh."""
        dev = resolve_device(device if device is not None else self.device)
        expected = {op.name: {s.param_name: s for s in op.param_specs()}
                    for op in self.layers if op.param_specs()}
        if set(params) != set(expected):
            raise KeyError(f"params name ops {sorted(params)}, the graph "
                           f"has {sorted(expected)}")
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for op_name, specs in expected.items():
            got = params[op_name]
            if set(got) != set(specs):
                raise KeyError(f"{op_name}: params {sorted(got)}, expected "
                               f"{sorted(specs)}")
            out[op_name] = {}
            for pname, spec in specs.items():
                v = got[pname]
                if not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(np.array(v))
                if tuple(v.shape) != spec.shape or v.dtype != spec.dtype:
                    raise ValueError(
                        f"{op_name}/{pname}: got {tuple(v.shape)} {v.dtype}, "
                        f"expected {spec.shape} {spec.dtype}")
                out[op_name][pname] = v.to(dev).contiguous()
        self.device = dev
        return self._state(out, opt_state, dev)

    def get_weights(self, state: TrainState, op_name: str, param_name: str
                    ) -> np.ndarray:
        return state.params[op_name][param_name].detach().cpu().numpy()

    def set_weights(self, state: TrainState, op_name: str, param_name: str,
                    value) -> TrainState:
        """A new state with one parameter replaced (same shape, dtype and
        device); ``state`` is left as it was."""
        tgt = state.params[op_name][param_name]
        arr = torch.as_tensor(np.asarray(value)).to(
            device=tgt.device, dtype=tgt.dtype).reshape(tgt.shape)
        params = dict(state.params)
        params[op_name] = {**params[op_name], param_name: arr}
        return TrainState(params, state.opt_state, state.step)

    # ------------------------------------------------------------- inference
    def _place_inputs(self, inputs, device) -> Dict[str, torch.Tensor]:
        placed = {}
        for t in self._inputs:
            if t.name not in inputs:
                raise ValueError(f"inputs missing {t.name!r} (model inputs: "
                                 f"{[i.name for i in self._inputs]})")
            v = inputs[t.name]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.asarray(v, dtype=numpy_dtype(t.dtype)))
            placed[t.name] = v.to(device=device, dtype=t.dtype)
        return placed

    def _place_labels(self, labels, device) -> torch.Tensor:
        if not isinstance(labels, torch.Tensor):
            labels = torch.from_numpy(np.asarray(labels))
        if "sparse" in (self.loss_type or ""):
            return labels.to(device=device, dtype=torch.int64)
        return labels.to(device=device, dtype=self.final_tensor.dtype)

    def predict(self, params_or_state, inputs) -> torch.Tensor:
        """Labels-free inference: the public forward for serving.
        ``params_or_state`` is a :class:`TrainState` or a bare params
        dict; ``inputs`` maps input names to arrays or tensors, which are
        moved to the parameters' device.  Rows are independent, so the
        first n rows of a padded batch equal the unpadded forward."""
        if self._forward_fn is None:
            raise ValueError("model must be compile()d before predict")
        params = getattr(params_or_state, "params", params_or_state)
        return self._forward_fn(
            params, self._place_inputs(inputs, params_device(params)))

    def forward(self, state: TrainState, inputs) -> torch.Tensor:
        return self.predict(state, inputs)

    # -------------------------------------------------------------- training
    def _require_compiled(self):
        if self._loss_fn is None:
            raise ValueError("model must be compile()d before training")

    def _loss_and_preds(self, values, labels):
        final = self.final_tensor
        preds = values[final.uid].to(final.dtype)
        return self._loss_fn(preds, labels), preds

    def train_step(self, state: TrainState, inputs, labels,
                   donate: bool = True, *, slot_override=None):
        """One forward, backward and SGD step; returns ``(new_state,
        metrics)`` with the batch's metric sums and ``loss`` as 0-dim
        tensors on the device (no host sync).

        ``donate=True`` consumes ``state`` like the JAX package's donated
        step: the dense parameters and the tables are updated in place,
        and the returned state holds the same tensors.  ``donate=False``
        leaves ``state`` as it was: the step runs on
        ``TrainState.clone()`` of it (every parameter, whole tables
        included, the optimizer state and the step), and returns the same
        new state as the donated step.

        ``slot_override`` (the epoch row cache) maps an op name to this
        batch's cache slots: the op's "embedding" then holds its cache,
        the rows are gathered from it by slot, and the row-sparse step
        lands in it through the row-update kernel."""
        self._require_compiled()
        if not donate:
            state = state.clone()
        params = state.params
        dev = params_device(params)
        inputs = self._place_inputs(inputs, dev)
        labels = self._place_labels(labels, dev)
        slot_override = slot_override or {}
        sparse_names = {op.name for op in self._sparse_ops}
        leaves = {op: {k: v.detach().requires_grad_() for k, v in d.items()}
                  for op, d in params.items() if op not in sparse_names}
        run = dict(leaves)
        rows = {}
        for op in self._sparse_ops:
            table = params[op.name]["embedding"]
            slots = slot_override.get(op.name)
            with torch.no_grad():
                r = (op.gather_rows(table, inputs[op.inputs[0].name])
                     if slots is None else table[slots.long()])
            rows[op.name] = r.requires_grad_()
            run[op.name] = {"embedding": table, "rows__": rows[op.name]}
        flat = [(op, k) for op, d in leaves.items() for k in d]
        with torch.enable_grad():
            loss, preds = self._loss_and_preds(self._apply(run, inputs),
                                               labels)
            wrt = [leaves[op][k] for op, k in flat] + list(rows.values())
            # a parameter the loss does not reach gets a zero gradient,
            # as jax.grad gives it
            grads = torch.autograd.grad(loss, wrt, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            dgrads: Dict[str, Dict[str, torch.Tensor]] = {}
            for (op, k), g in zip(flat, grads):
                dgrads.setdefault(op, {})[k] = g
            _, opt_state = self.optimizer.update(params, dgrads,
                                                 state.opt_state)
            neg_lr = -state.opt_state.get("lr", self.optimizer.lr)
            for op, g in zip(self._sparse_ops, grads[len(flat):]):
                table = params[op.name]["embedding"]
                slots = slot_override.get(op.name)
                if slots is None:
                    op.scatter_apply(table, inputs[op.inputs[0].name], g,
                                     neg_lr)
                else:
                    row_update_cuda(table, slots, g, neg_lr)
            mets = compute_metrics(preds.detach(), labels, self.metrics,
                                   self.loss_type)
            mets["loss"] = loss.detach()
        step = (state.step + 1 if state.step is not None
                else torch.ones((), dtype=torch.int32, device=dev))
        return TrainState(params, opt_state, step), mets

    def eval_step(self, state: TrainState, inputs, labels):
        """Forward-only metrics and loss on one batch."""
        self._require_compiled()
        dev = params_device(state.params)
        inputs = self._place_inputs(inputs, dev)
        labels = self._place_labels(labels, dev)
        with torch.no_grad():
            loss, preds = self._loss_and_preds(
                self._apply(state.params, inputs), labels)
            mets = compute_metrics(preds, labels, self.metrics,
                                   self.loss_type)
            mets["loss"] = loss
        return mets

    # ------------------------------------------------- the epoch row cache
    def _resolve_cache(self, dev: torch.device) -> None:
        """Set ``_epoch_cache_active`` for tables on ``dev``: "on" anywhere,
        "auto" on the CUDA card (config.py says why the port departs from
        the JAX package's TPU-only rule), "off" never; always with at
        least one row-sparse op."""
        mode = self.config.epoch_row_cache
        self._epoch_cache_active = bool(self._sparse_ops) and (
            mode == "on" or (mode == "auto" and dev.type == "cuda"))

    def cache_prologue(self, state: TrainState, inputs):
        """Per row-sparse op, map the epoch's ids to unique cache slots and
        pull the touched rows in (JAX ``cache_prologue``, shared slots).
        Returns ``(state with the caches, slots, writebacks, originals)``;
        an op whose cache would not be smaller than its table stays on
        the per-step path."""
        params = dict(state.params)
        slots_ep, writebacks, originals = {}, [], {}
        cache_ops = self._sparse_ops if self._epoch_cache_active else ()
        for op in cache_ops:
            ids = inputs[op.inputs[0].name].to(torch.int32)
            tb = params[op.name]["embedding"]
            flat = tb.view(-1, tb.shape[-1])
            built = build_cache(flat, op.flat_ids(ids), lane_pack(op.out_dim))
            if built is None:
                continue
            cache, slots, rowof = built
            originals[op.name] = tb
            params[op.name] = {"embedding": cache}
            slots_ep[op.name] = slots
            writebacks.append((op.name, rowof))
        return (TrainState(params, state.opt_state, state.step), slots_ep,
                writebacks, originals)

    def ladder_plan(self, state: TrainState, slots_ep, nb: int):
        """``(meta, arrays)`` of the ladder (JAX ``ladder_plan``), or
        ``([], None)``."""
        if not slots_ep:
            return [], None
        rows0 = {name: state.params[name]["embedding"].shape[0]
                 for name in slots_ep}
        op_pack = {op.name: lane_pack(op.out_dim) for op in self._sparse_ops}
        meta = ladder_meta(self.config, nb, slots_ep, rows0, op_pack)
        if not meta:
            return [], None
        return meta, ladder_arrays(slots_ep, meta, rows0)

    def ladder_scan(self, state: TrainState, inputs, labels, meta, arrs,
                    mets: List[Dict[str, torch.Tensor]]) -> TrainState:
        """The steps of ``labels.shape[0]`` batches down the ladder (JAX
        ``ladder_scan``): each level pulls its block's rows from the parent
        cache, recurses against the block cache and sets the final rows
        back, in place; the innermost level runs ``train_step`` by slot.
        Appends each step's metrics to ``mets``."""
        if not meta:
            slots = arrs["slots"]
            for i in range(labels.shape[0]):
                state, m = self.train_step(
                    state, {k: v[i] for k, v in inputs.items()}, labels[i],
                    slot_override={n: s[i] for n, s in slots.items()})
                mets.append(m)
            return state
        (size, part), rest = meta[0], meta[1:]
        for k, blk in enumerate(arrs["blocks"]):
            lo, hi = k * size, (k + 1) * size
            params = dict(state.params)
            parents = {}
            for name in part:
                parents[name] = params[name]["embedding"]
                params[name] = {"embedding": cache_fetch(
                    parents[name], blk["rowof"][name])}
            state = self.ladder_scan(
                TrainState(params, state.opt_state, state.step),
                {n: v[lo:hi] for n, v in inputs.items()}, labels[lo:hi],
                rest, blk["next"], mets)
            params = dict(state.params)
            for name, parent in parents.items():
                cache_writeback(parent, blk["rowof"][name],
                                params[name]["embedding"])
                params[name] = {"embedding": parent}
            state = TrainState(params, state.opt_state, state.step)
        return state

    def epoch_scan(self, state: TrainState, inputs, labels, slots_ep, meta,
                   arrs):
        """One epoch's steps against the (cached) tables (JAX
        ``epoch_scan``); returns ``(state, folded)``: the metric sums over
        the epoch and the mean ``loss``."""
        mets: List[Dict[str, torch.Tensor]] = []
        if not meta:
            arrs = {"slots": slots_ep}
        state = self.ladder_scan(state, inputs, labels, meta, arrs, mets)
        folded = {}
        for k in (mets[0] if mets else ()):
            vals = torch.stack([m[k] for m in mets])
            folded[k] = vals.mean() if k == "loss" else vals.sum()
        return state, folded

    def cache_epilogue(self, state: TrainState, writebacks, originals
                       ) -> TrainState:
        """Set each op's final cache rows back into its table, every live
        slot once (JAX ``cache_epilogue``), and put the tables back in
        the state."""
        if not writebacks:
            return state
        params = dict(state.params)
        for name, rowof in writebacks:
            cache_writeback(originals[name], rowof,
                            params[name]["embedding"])
            params[name] = {"embedding": originals[name]}
        return TrainState(params, state.opt_state, state.step)

    # ------------------------------------------------------------- epochs
    def _train_epoch(self, state: TrainState, inputs, labels):
        """One epoch over placed ``(num_batches, batch, ...)`` tensors:
        the JAX package's scanned ``train_epoch`` program."""
        state, slots_ep, writebacks, orig = self.cache_prologue(state, inputs)
        meta, arrs = self.ladder_plan(state, slots_ep, labels.shape[0])
        state, folded = self.epoch_scan(state, inputs, labels, slots_ep,
                                        meta, arrs)
        return self.cache_epilogue(state, writebacks, orig), folded

    def _train_epochs(self, state: TrainState, inputs, labels,
                      n_epochs: int):
        """``n_epochs`` passes with the cache live across all of them: one
        prologue, one ladder plan and one epilogue (the JAX package's
        ``train_epochs`` program).  Bit-identical to repeated
        ``_train_epoch``, whose writeback and re-fetch between epochs are
        the identity on the cached rows."""
        state, slots_ep, writebacks, orig = self.cache_prologue(state, inputs)
        meta, arrs = self.ladder_plan(state, slots_ep, labels.shape[0])
        mets = []
        for _ in range(int(n_epochs)):
            state, m = self.epoch_scan(state, inputs, labels, slots_ep, meta,
                                       arrs)
            mets.append(m)
        return self.cache_epilogue(state, writebacks, orig), _stack(mets)

    def place_dataset(self, inputs, labels, device):
        """Place a stacked ``(num_batches, batch, ...)`` dataset on
        ``device`` once."""
        return (self._place_inputs(inputs, device),
                self._place_labels(labels, device))

    def train_epoch(self, state: TrainState, inputs, labels):
        """``train_step`` over the leading ``(num_batches, batch, ...)``
        axis of ``inputs`` and ``labels``, which are placed on the device
        once.  Returns ``(state, folded)``: the JAX package's folded
        metrics, the sums over the epoch and the mean ``loss``.

        With the epoch row cache active the steps run against the cache
        and its ladder; an epoch that no ladder level divides is
        dispatched in chunks of ``epoch_cache_chunk`` steps
        (``_run_epoch_chunks``)."""
        self._require_compiled()
        dev = params_device(state.params)
        inputs, labels = self.place_dataset(inputs, labels, dev)
        self._resolve_cache(dev)
        bounds = self._epoch_chunk_bounds(labels.shape[0])
        if bounds is None:
            return self._train_epoch(state, inputs, labels)
        return self._run_epoch_chunks(state, inputs, labels, bounds)

    def train_epochs(self, state: TrainState, inputs, labels, epochs: int):
        """``epochs`` passes over the stacked batches, with one cache
        prologue and epilogue for all of them when the epoch is unchunked,
        else chunked epoch by epoch.  The folded metrics are stacked on a
        leading ``(epochs,)`` axis."""
        self._require_compiled()
        dev = params_device(state.params)
        inputs, labels = self.place_dataset(inputs, labels, dev)
        self._resolve_cache(dev)
        bounds = self._epoch_chunk_bounds(labels.shape[0])
        if bounds is None:
            return self._train_epochs(state, inputs, labels, epochs)
        mets = []
        for _ in range(int(epochs)):
            state, m = self._run_epoch_chunks(state, inputs, labels, bounds)
            mets.append(m)
        return state, _stack(mets)

    def _epoch_chunk_bounds(self, nb: int):
        """``(lo, hi)`` chunk slices for a chunked epoch, or None when
        chunking does not apply (JAX ``_epoch_chunk_bounds``): only with
        the cache active and ``nb > epoch_cache_chunk``, and not when a
        ladder level engages over the whole epoch.  Chunks are whole
        inner blocks where possible, with at most one short tail."""
        chunk = int(self.config.epoch_cache_chunk)
        if not (self._epoch_cache_active and chunk > 0 and nb > chunk):
            return None
        inner = int(self.config.epoch_cache_inner)
        named = named_levels(self.config)
        if named is None and (nb % chunk == 0
                              or (inner > 1 and nb % inner == 0)):
            return None
        if named and any(0 < s < nb and nb % s == 0 for s in named):
            return None
        if inner > 1 and chunk > inner:
            q, r = divmod(nb, inner)
            per = chunk // inner                   # blocks per chunk
            k = max(-(-q // per), 1)
            bq, br = divmod(q, k)                  # equalized blocks
            sizes = [(bq + (1 if i < br else 0)) * inner for i in range(k)]
            if r:
                sizes.append(r)
        else:
            k = -(-nb // chunk)
            base = nb // k
            sizes = [base] * k
            sizes[-1] += nb - base * k
        bounds, lo = [], 0
        for s in sizes:
            bounds.append((lo, lo + s))
            lo += s
        return bounds

    def _run_epoch_chunks(self, state: TrainState, inputs, labels, bounds):
        """One epoch as consecutive chunk epochs, each with its own cache
        prologue and epilogue; the loss is the step-weighted mean of the
        chunks' means, the other metrics their sums."""
        sums, loss_num, n_steps = {}, 0.0, 0
        for lo, hi in bounds:
            state, mets = self._train_epoch(
                state, {k: v[lo:hi] for k, v in inputs.items()},
                labels[lo:hi])
            w = hi - lo
            for k, v in mets.items():
                if k == "loss":
                    loss_num = loss_num + v * w
                else:
                    sums[k] = sums.get(k, 0.0) + v
            n_steps += w
        sums["loss"] = loss_num / n_steps
        return state, sums

    def get_perf_metrics(self) -> MetricsAccumulator:
        """Running metrics of the current or last ``fit`` epoch."""
        return self._last_metrics

    def _stage_scan_dataset(self, dataloader, device):
        """The whole dataset stacked as ``(num_batches, batch, ...)`` and
        placed on ``device`` for fit's staged branch (JAX
        ``_stage_scan_dataset``), or None when fit keeps the per-batch
        loop: a loader that is not array-backed, shuffles, keeps a last
        short batch, is empty, or holds more than ``fit_scan_max_bytes``."""
        cap = self.config.fit_scan_max_bytes
        if not (cap > 0
                and getattr(dataloader, "inputs", None) is not None
                and getattr(dataloader, "drop_last", False)
                and not getattr(dataloader, "shuffle", True)
                and dataloader.num_batches > 0
                and (sum(v.nbytes for v in dataloader.inputs.values())
                     + dataloader.labels.nbytes) <= cap):
            return None
        nb, bsz = dataloader.num_batches, dataloader.batch_size
        used = nb * bsz
        stacked_in = {k: np.asarray(v[:used]).reshape((nb, bsz) + v.shape[1:])
                      for k, v in dataloader.inputs.items()}
        stacked_lab = np.asarray(dataloader.labels[:used]).reshape(
            (nb, bsz) + dataloader.labels.shape[1:])
        return self.place_dataset(stacked_in, stacked_lab, device)

    def fit(self, state: TrainState, dataloader, epochs: Optional[int] = None,
            verbose: bool = True, callbacks=None, warmup: bool = True,
            show_throughput: bool = True, checkpoint_manager=None,
            checkpoint_every_n_steps: Optional[int] = None,
            checkpoint_every_n_epochs: Optional[int] = None,
            resume: bool = False, sentinel=None):
        """The epoch loop: an optional warmup step on the first batch (a
        real update, the reference's untimed epoch 0), then every epoch,
        with the metrics accumulated and reported per epoch.  Returns
        ``(state, samples_per_second)`` over the timed epochs, measured up
        to a device synchronise.

        An array-backed, unshuffled, ``drop_last`` loader within
        ``fit_scan_max_bytes`` is staged on the device once and trained by
        whole epochs, as the JAX package's scanned fast path does: several
        epochs as one ``train_epochs`` (one cache prologue and epilogue),
        one epoch as ``train_epoch``, a chunked epoch by chunks.
        ``_last_fit_used_scan`` says which branch ran; every other loader
        takes ``train_step`` batch by batch.

        ``callbacks`` stands where the JAX package's ``fit`` takes it;
        any value but None raises until callbacks are ported."""
        if callbacks is not None:
            raise NotImplementedError(_CALLBACKS)
        if (checkpoint_manager is not None or checkpoint_every_n_steps
                or checkpoint_every_n_epochs or resume
                or sentinel is not None):
            raise NotImplementedError(_DURABILITY)
        self._require_compiled()
        epochs = epochs or self.config.epochs
        acc = MetricsAccumulator(self.metrics)
        self._last_metrics = acc
        dev = params_device(state.params)
        scan_data = self._stage_scan_dataset(dataloader, dev)
        self._last_fit_used_scan = scan_data is not None
        if warmup:
            if dev.type == "cuda":
                # a kernel first reached inside an epoch (the row set at
                # the cache's writebacks) must not build in the timed window
                _cuda.build()
            first = dataloader.peek()
            state, _ = self.train_step(state, first[0], first[1])
            _synchronize(dev)

        def report(epoch, mets):
            acc.reset()
            acc.update({k: v for k, v in mets.items() if k != "loss"})
            if verbose:
                print(f"epoch {epoch}: {acc.report()}")

        t0 = time.perf_counter()
        samples = 0
        if scan_data is not None:
            self._resolve_cache(dev)
            bounds = self._epoch_chunk_bounds(scan_data[1].shape[0])
            samples = epochs * dataloader.num_batches * dataloader.batch_size
            if bounds is None and epochs > 1:
                state, stacked = self._train_epochs(state, *scan_data, epochs)
                for epoch in range(epochs):
                    report(epoch, {k: v[epoch] for k, v in stacked.items()})
            else:
                for epoch in range(epochs):
                    state, mets = (self._train_epoch(state, *scan_data)
                                   if bounds is None else
                                   self._run_epoch_chunks(state, *scan_data,
                                                          bounds))
                    report(epoch, mets)
        else:
            for epoch in range(epochs):
                acc.reset()
                for inputs, labels in dataloader:
                    state, mets = self.train_step(state, inputs, labels)
                    samples += int(labels.shape[0])
                    acc.update({k: v for k, v in mets.items()
                                if k != "loss"})
                if verbose:
                    print(f"epoch {epoch}: {acc.report()}")
        _synchronize(dev)
        elapsed = time.perf_counter() - t0
        thpt = samples / max(elapsed, 1e-9)
        if verbose and show_throughput:
            print(f"ELAPSED TIME = {elapsed:.4f}s, "
                  f"THROUGHPUT = {thpt:.2f} samples/s")
        return state, thpt


def _stack(mets):
    """Per-epoch folded metrics stacked on a leading ``(epochs,)`` axis."""
    return {k: torch.stack([m[k] for m in mets])
            for k in (mets[0] if mets else ())}


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
