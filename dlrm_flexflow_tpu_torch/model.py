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
included, takes the dense gradient.  A mesh comes with the scale-out
slice; checkpoints and resilient training with the durability slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import FFConfig
from .device import resolve_device
from .initializers import derive_seed
from .losses import get_loss
from .metrics import MetricsAccumulator, compute_metrics
from .ops import (BatchMatmul, Concat, Embedding, Flat, FusedEmbedInteract,
                  Linear, Op, RaggedStackedEmbedding, Reshape,
                  StackedEmbedding, Transpose)
from .optim import Optimizer, SGDOptimizer
from .tensor import Tensor, as_dtype, numpy_dtype

EMBEDDING_OPS = (Embedding, StackedEmbedding, RaggedStackedEmbedding)
_CCE = ("sparse_categorical_crossentropy", "sparse_crossentropy",
        "categorical_crossentropy", "crossentropy")
_DURABILITY = ("checkpointed and resilient training (checkpoint_manager, "
               "checkpoint cadences, resume, sentinel) is not ported yet: "
               "it comes with the durability slice in ROADMAP.md")


@dataclass
class TrainState:
    """Parameters ``{op: {param: tensor}}``, the optimizer state (``step``,
    ``lr`` and, under momentum, ``v``) and the step count, on one device.

    ``FFModel.train_step`` consumes its input state, as the JAX package's
    donated step does: the tables and dense parameters are updated in
    place and the returned state holds the same tensors.  ``clone`` a
    state that must survive a step."""

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
        mode = getattr(self.config, "sparse_embedding_updates", "auto")
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"sparse_embedding_updates must be "
                             f"'auto'|'on'|'off', got {mode!r}")
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
        self._sparse_ops = [op for op in self.layers
                            if sparse_ok and isinstance(op, EMBEDDING_OPS)
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

    def init(self, seed: Optional[int] = None, device=None) -> TrainState:
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

    def train_step(self, state: TrainState, inputs, labels):
        """One forward, backward and SGD step; returns ``(new_state,
        metrics)`` with the batch's metric sums and ``loss`` as 0-dim
        tensors on the device (no host sync).

        Consumes ``state`` like the JAX package's donated step: the dense
        parameters and the tables are updated in place, and the returned
        state holds the same tensors.  Clone a state that must survive
        (``TrainState.clone``)."""
        self._require_compiled()
        params = state.params
        dev = params_device(params)
        inputs = self._place_inputs(inputs, dev)
        labels = self._place_labels(labels, dev)
        sparse_names = {op.name for op in self._sparse_ops}
        leaves = {op: {k: v.detach().requires_grad_() for k, v in d.items()}
                  for op, d in params.items() if op not in sparse_names}
        run = dict(leaves)
        rows = {}
        for op in self._sparse_ops:
            table = params[op.name]["embedding"]
            with torch.no_grad():
                rows[op.name] = op.gather_rows(
                    table, inputs[op.inputs[0].name]).requires_grad_()
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
                op.scatter_apply(params[op.name]["embedding"],
                                 inputs[op.inputs[0].name], g, neg_lr)
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

    def train_epoch(self, state: TrainState, inputs, labels):
        """``train_step`` over the leading ``(num_batches, batch, ...)``
        axis of ``inputs`` and ``labels``, which are placed on the device
        once.  Returns ``(state, folded)``: the JAX package's folded
        metrics, the sums over the epoch and the mean ``loss``."""
        dev = params_device(state.params)
        placed = self._place_inputs(inputs, dev)
        labels = self._place_labels(labels, dev)
        steps = []
        for i in range(labels.shape[0]):
            state, m = self.train_step(
                state, {k: v[i] for k, v in placed.items()}, labels[i])
            steps.append(m)
        folded = {}
        for k in (steps[0] if steps else ()):
            vals = torch.stack([m[k] for m in steps])
            folded[k] = vals.mean() if k == "loss" else vals.sum()
        return state, folded

    def train_epochs(self, state: TrainState, inputs, labels, epochs: int):
        """``epochs`` passes of ``train_epoch``; the folded metrics are
        stacked on a leading ``(epochs,)`` axis."""
        mets = []
        for _ in range(int(epochs)):
            state, m = self.train_epoch(state, inputs, labels)
            mets.append(m)
        return state, {k: torch.stack([m[k] for m in mets])
                       for k in (mets[0] if mets else ())}

    def get_perf_metrics(self) -> MetricsAccumulator:
        """Running metrics of the current or last ``fit`` epoch."""
        return self._last_metrics

    def fit(self, state: TrainState, dataloader, epochs: Optional[int] = None,
            verbose: bool = True, warmup: bool = True,
            show_throughput: bool = True, checkpoint_manager=None,
            checkpoint_every_n_steps: Optional[int] = None,
            checkpoint_every_n_epochs: Optional[int] = None,
            resume: bool = False, sentinel=None):
        """The plain epoch loop: an optional warmup step on the first
        batch (a real update, the reference's untimed epoch 0), then
        ``train_step`` over every batch of every epoch, with the metrics
        accumulated and reported per epoch.  Returns ``(state,
        samples_per_second)`` over the timed epochs, measured up to a
        device synchronise."""
        if (checkpoint_manager is not None or checkpoint_every_n_steps
                or checkpoint_every_n_epochs or resume
                or sentinel is not None):
            raise NotImplementedError(_DURABILITY)
        epochs = epochs or self.config.epochs
        acc = MetricsAccumulator(self.metrics)
        self._last_metrics = acc
        dev = params_device(state.params)
        if warmup:
            first = dataloader.peek()
            state, _ = self.train_step(state, first[0], first[1])
            _synchronize(dev)
        t0 = time.perf_counter()
        samples = 0
        for epoch in range(epochs):
            acc.reset()
            for inputs, labels in dataloader:
                state, mets = self.train_step(state, inputs, labels)
                samples += int(labels.shape[0])
                acc.update({k: v for k, v in mets.items() if k != "loss"})
            if verbose:
                print(f"epoch {epoch}: {acc.report()}")
        _synchronize(dev)
        elapsed = time.perf_counter() - t0
        thpt = samples / max(elapsed, 1e-9)
        if verbose and show_throughput:
            print(f"ELAPSED TIME = {elapsed:.4f}s, "
                  f"THROUGHPUT = {thpt:.2f} samples/s")
        return state, thpt


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
