"""FFModel: the graph builder, its forward and its training loop.

Counterpart of ``dlrm_flexflow_tpu/model.py``.  The graph is a list of
ops built by the reference's factory API; ``compile`` fixes the loss,
metrics and optimizer and builds the forward; ``init`` or ``load_params``
places the parameters on a device.  The forward is one Python sweep over
the ops, and no op bakes in the batch size, so one graph serves every
serving bucket; ``predict`` runs it eagerly, and the serving engine
replays it as one CUDA graph per bucket (``serving/engine.py``).

Training follows the JAX package's step (``model.py:973-1055``).  Under
plain SGD, or an optimizer built with ``lazy_embeddings=True``, with
``sparse_embedding_updates`` not "off", every embedding op whose ids are
a model input takes the row-sparse path: its looked-up rows are gathered
outside autograd, the loss is differentiated with respect to those rows,
the dense parameters take the optimizer's step, and the rows' step lands
in the table in place through the row-update kernel on the card:
``scatter_apply(-lr)`` under plain SGD, ``_lazy_update`` (momentum,
weight decay or Adam on the touched rows and their slot rows) in lazy
mode.  Otherwise every parameter, tables included, takes the dense
gradient.

The donated step is compiled, as the JAX package jits it
(``model.py:1932-1942``): ``_step`` captures ``_step_body`` in a CUDA
graph (``graphs.py``) at its second call for a batch signature and
state, and replays it after that.

``train_epoch``, ``train_epochs`` and ``fit``'s staged branch follow the
JAX package's scanned epoch (``model.py:1891-1928``, ``:2115-2254``,
``:2314-2566``): a Python loop takes the place of ``lax.scan`` and
replays the captured step, and with the epoch row cache active
(``epoch_cache.py``) the row-sparse ops step against a small cache of
the epoch's rows, nested in the cache ladder, with every writeback
through the row-set kernel on the card; in lazy mode the optimizer's
slot tables of a cached op are cached beside it, at the same slots.
The caches are buffers the model keeps, so the one captured step serves
every block, chunk and epoch of a shape: ``fit(epochs=2)`` of the run_random.sh CLI (64 staged
batches) captures once.  The prologue, the block fetches and writebacks
and the epilogue stay eager.  A mesh comes with the scale-out slice.

Checkpoints and resilient training are the durability slice
(``checkpoint.py``, ``resilience/``, ``data/prefetch.py``): ``fit``
hands any of its checkpoint, resume or sentinel options, and installed
faults, to ``resilience.loop.resilient_fit``.

Tables are stored in ``FFConfig.embedding_dtype`` (f32 or bf16) through
every path above: a bf16 table's row-sparse step, cache writebacks and
bag go through the row-update, row-set and bag kernels on bf16 storage.

Telemetry follows the JAX package's trainer (``model.py:2506-2686``):
with an event log active, ``train_epoch(s)`` and ``fit`` emit ``step``
events (and ``fit``'s per-batch loop ``phase_time`` events), ``fit``
opens the span chain ``train.fit`` -> ``train.epoch`` ->
``train.dispatch``, samples row frequencies and memory, and each capture
of the step is a ``compile`` event; the train metrics
(``telemetry/metrics.py``) update after every ``fit``.  All of it runs on
the host around the step, never inside ``_step_body``, and with no log
active it costs a global read per call and nothing that allocates or
synchronises.  ``compile`` starts the ``/metrics`` endpoint when
``FFConfig.metrics_port`` is set.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .config import EMBEDDING_DTYPES, FFConfig
from .device import resolve_device
from .epoch_cache import (build_cache, cache_fetch, cache_writeback,
                          ladder_arrays, ladder_meta, named_levels)
from .graphs import (GraphRunner, StaleGraphError, flatten, run_eager,
                     state_key)
from .initializers import derive_seed
from .losses import get_loss
from .metrics import MetricsAccumulator, compute_metrics
from .ops import (BatchMatmul, Concat, Embedding, Flat, FusedEmbedInteract,
                  Linear, Op, RaggedStackedEmbedding, Reshape,
                  StackedEmbedding, Transpose)
from .ops.embedding import lane_pack, take_rows
from .ops.quantized import QUANT_MODES
from .ops.row_update_kernel import row_update_cuda
from .ops.slotting import slot_rows
from .data.prefetch import BatchPlacer, PrefetchLoader
from .optim import Optimizer, SGDOptimizer
from .parallel.parallel_config import Strategy
from .telemetry import active_log, sample_memory
from .telemetry import metrics as _tmetrics
from .telemetry import rowfreq as _rowfreq
from .telemetry.torch_hooks import record_compile
from .telemetry.trace import NULL_SPAN, start_span
from .tensor import Tensor, as_dtype, numpy_dtype

EMBEDDING_OPS = (Embedding, StackedEmbedding, RaggedStackedEmbedding)
_CCE = ("sparse_categorical_crossentropy", "sparse_crossentropy",
        "categorical_crossentropy", "crossentropy")
_MODES = ("auto", "on", "off")


@dataclass
class TrainState:
    """Parameters ``{op: {param: tensor}}``, the optimizer state (``step``,
    ``lr`` and the slot tables: ``v`` under momentum, ``m`` and ``v``
    under Adam), the batch-norm state, the PRNG key
    and the step count, on one device: the JAX package's fields in its
    order (``model.py:76-84``), so a checkpoint holds the same leaves.

    ``bn_state`` is ``{}`` for every graph the port builds (batch norm
    comes with the op set, ROADMAP.md Queue A item 9).  ``rng`` is an
    opaque uint32 ``(2,)`` key the port carries and checkpoints but never
    draws from until dropout is ported: a step leaves it as it was, as the
    JAX step does for a graph with no stochastic op (``model.py:979-981``).

    ``FFModel.train_step`` consumes its input state, as the JAX package's
    donated step does: the tables and dense parameters are updated in
    place and the returned state holds the same tensors.  A state that
    must survive a step goes in with ``donate=False``, or is ``clone``d."""

    params: Dict[str, Dict[str, torch.Tensor]]
    opt_state: Dict[str, Any]
    bn_state: Dict[str, Any]
    rng: Optional[torch.Tensor]
    step: Optional[torch.Tensor]

    def clone(self) -> "TrainState":
        def copy(x):
            if isinstance(x, dict):
                return {k: copy(v) for k, v in x.items()}
            return x.clone() if isinstance(x, torch.Tensor) else x
        return TrainState(copy(self.params), copy(self.opt_state),
                          copy(self.bn_state), copy(self.rng),
                          copy(self.step))


def initial_rng(seed: int, device) -> torch.Tensor:
    """The uint32 ``(2,)`` key ``init`` puts in a state: ``[0, seed]``,
    the layout of ``jax.random.PRNGKey(seed)``.  It is not the key the JAX
    package's ``init`` keeps (that one is split from it); nothing in the
    port draws from it."""
    key = np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)
    return torch.from_numpy(key).to(device)


def params_device(params) -> torch.device:
    for d in params.values():
        for v in d.values():
            return v.device
    return torch.device("cpu")


class FFModel:
    """Graph builder with the reference's factory API."""

    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        # the SOAP strategy, op name -> ParallelConfig (compile sets it;
        # empty means data-parallel everywhere)
        self.strategy = Strategy()
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
        # lazy mode (compile): the optimizer slot tables updated on touch
        self._lazy_slots: Tuple[str, ...] = ()
        self._lazy_mode = False
        self._donate_state = True
        # fit's hooks: a rate a callback scheduled for the next epoch, and
        # the state as of the last finished epoch (ModelCheckpoint's)
        self._pending_lr: Optional[float] = None
        self._fit_state: Optional["TrainState"] = None
        # whether train_epoch(s) run the epoch row cache: resolved from
        # the tables' device by each epoch entry point (_resolve_cache)
        self._epoch_cache_active = False
        self._last_fit_used_scan = False
        self._last_metrics = MetricsAccumulator(())
        # the compiled step (_step): a runner per batch signature, the
        # state key of the eager call that precedes each capture, one
        # graph pool and one lock for all of the model's step graphs
        self._step_graphs: Dict[Tuple, GraphRunner] = {}
        self._step_seen: Dict[Tuple, Tuple] = {}
        self._graph_pool = None
        self._graph_lock = threading.Lock()
        self.graph_captures = 0
        self.graph_replays = 0
        self._metric_layout: Tuple = ()
        # the epoch and block caches, one buffer per (op, level, shape)
        # (_cache_buffer), so one epoch's step graph serves the next
        self._cache_buffers: Dict[Tuple, torch.Tensor] = {}

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
        dt = getattr(self.config, "embedding_dtype", "float32")
        if dt not in EMBEDDING_DTYPES:
            raise ValueError(f"embedding_dtype must be one of "
                             f"{EMBEDDING_DTYPES}, got {dt!r}")
        return as_dtype(dt)

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
                mesh=None, strategy: Optional[Strategy] = None, *,
                donate_state: bool = True):
        """Fix the optimizer (default: SGD at the config's learning rate
        and weight decay), the loss and the metrics; choose the row-sparse
        embedding ops; build the forward.  ``mesh`` may be None or False
        (one device); a mesh comes with the scale-out slice in
        ROADMAP.md.

        ``strategy`` (a :class:`Strategy`) becomes ``self.strategy``; as
        in the JAX package, ``FFConfig.import_strategy_file`` replaces it,
        and ``search_budget > 0`` with no strategy runs ``mcmc_search``
        over ``resolved_num_devices()`` devices (exported to
        ``export_strategy_file`` when set).  Each op named in the
        strategy gets its ``parallel_config``.  On one device, without a
        mesh, a strategy changes no value: the model computes as it
        would without one.  A ``"cpu"`` placement (tables in host memory)
        raises: it comes with ``ops/hetero.py`` (ROADMAP.md item 9).

        ``donate_state=False`` (JAX ``compile``'s flag) keeps every input
        state: ``train_step`` then steps a clone whatever its ``donate``,
        and ``train_epoch(s)`` and ``fit`` train a clone of their input
        state, taken once at entry."""
        if mesh not in (None, False):
            raise NotImplementedError(
                "a device mesh is not ported yet: it comes with the "
                "scale-out slice in ROADMAP.md")
        self._resolve_strategy(strategy)
        act = getattr(self.config, "activation_dtype", "float32")
        if act != "float32":
            raise NotImplementedError(
                f"activation_dtype={act!r} is not ported yet (float32 only)")
        for name in ("sparse_embedding_updates", "epoch_row_cache"):
            mode = getattr(self.config, name)
            if mode not in _MODES:
                raise ValueError(f"{name} must be 'auto'|'on'|'off', "
                                 f"got {mode!r}")
        quantize = getattr(self.config, "serve_quantize", "off")
        if quantize not in QUANT_MODES:
            raise ValueError(f"serve_quantize must be one of {QUANT_MODES}, "
                             f"got {quantize!r}")
        # the opt-in live-metrics endpoint: one process-wide /metrics and
        # /healthz server, started at most once (compile is the gate
        # every training and serving path passes)
        if int(getattr(self.config, "metrics_port", 0) or 0):
            from .telemetry.exporter import start_metrics_server
            start_metrics_server(int(self.config.metrics_port))
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
        # lazy mode: momentum, weight decay or Adam keep the row-sparse
        # path by updating the rows' slots on touch (JAX model.py:815-838)
        self._lazy_mode = (not plain_sgd
                           and getattr(opt, "lazy_embeddings", False))
        self._lazy_slots = (tuple(opt.slot_names()) if self._lazy_mode
                            else ())
        self._donate_state = bool(donate_state)
        input_uids = {t.uid for t in self._inputs}
        sparse_ok = (self.config.sparse_embedding_updates != "off"
                     and (plain_sgd or self._lazy_mode))
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
        # the step graphs baked in the old loss, metrics and optimizer
        self._step_graphs.clear()
        self._step_seen.clear()
        return self

    def _resolve_strategy(self, strategy: Optional[Strategy]) -> None:
        """``compile``'s strategy: the argument, the imported file, or a
        search at compile (reference model.cc:1010-1016, the
        STRATEGY_SEARCH task and ``FFModel::optimize``), then each op's
        ``parallel_config``."""
        if strategy is not None:
            self.strategy = strategy
        if self.config.import_strategy_file:
            self.strategy = Strategy.load(self.config.import_strategy_file)
        elif self.config.search_budget > 0 and not self.strategy.configs:
            from .sim.search import mcmc_search
            n = self.config.resolved_num_devices()
            self.strategy = mcmc_search(
                self, n, budget=self.config.search_budget,
                alpha=self.config.search_alpha, verbose=True)
            if self.config.export_strategy_file:
                self.strategy.save(self.config.export_strategy_file)
        for op in self.layers:
            pc = self.strategy.configs.get(op.name)
            if pc is not None and pc.device_type == "cpu":
                raise NotImplementedError(
                    f"{op.name}: a 'cpu' placement (the table in host "
                    "memory, updated on the host) comes with "
                    "ops/hetero.py, ROADMAP.md item 9")
        for op in self.layers:
            if op.name in self.strategy:
                op.parallel_config = self.strategy[op.name]

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
        return self._state(params, None, dev, seed)

    def _state(self, params, opt_state, dev, seed) -> TrainState:
        if opt_state is None:
            opt_state = (self.optimizer.init(params)
                         if self.optimizer is not None else {})
        else:
            opt_state = self._place_opt_state(opt_state, dev)
        return TrainState(params, opt_state, {}, initial_rng(seed, dev),
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
        return self._state(out, opt_state, dev, self.config.seed)

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
        return TrainState(params, state.opt_state, state.bn_state, state.rng,
                          state.step)

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

    def shard_batch(self, arr) -> torch.Tensor:
        """One array of a batch as a tensor on the model's device (the JAX
        package's ``shard_batch``; the port has no mesh to shard over):
        the ``place_fn`` a caller may hand a ``PrefetchLoader``."""
        dev = self.device if self.device is not None else resolve_device()
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.asarray(arr))
        return arr.to(dev)

    def batch_placer(self) -> BatchPlacer:
        """The placement ``fit`` gives its own ``PrefetchLoader``: a whole
        batch cast to the graph's input and label dtypes on the host and
        copied to the model's device, on the card through pinned staging
        buffers on a stream of its own (``data/prefetch.py``)."""
        self._require_compiled()
        dev = self.device if self.device is not None else resolve_device()
        labels = (torch.int64 if "sparse" in (self.loss_type or "")
                  else self.final_tensor.dtype)
        return BatchPlacer(dev, {t.name: t.dtype for t in self._inputs},
                           labels)

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

        ``donate=True`` consumes ``state`` like the JAX package's donated,
        jitted step: the dense parameters, the tables, the optimizer
        state and the step count are updated in place, and the returned
        state holds the same tensors.  The step is compiled as the JAX
        package jits it (``_step``): the first call at a given batch
        signature and state runs eagerly, the second captures a CUDA graph
        and replays it, later calls replay it.

        ``donate=False`` leaves ``state`` as it was: the step runs eagerly
        on ``TrainState.clone()`` of it (every parameter, whole tables
        included, the optimizer state and the step) and returns the same
        new state as the donated step.  The clone has fresh addresses on
        every call, so this step is never captured; it runs the same
        kernels on the same device.

        ``slot_override`` (the epoch row cache) maps an op name to this
        batch's cache slots: the op's "embedding" (and in lazy mode each
        of its slot tables) then holds its cache, the rows are gathered
        from it by slot, and the row-sparse step lands in it through the
        row-update kernel.

        A model compiled with ``donate_state=False`` steps a clone even
        when ``donate`` is True."""
        return self._train_step(state, inputs, labels,
                                donate and self._donate_state, slot_override)

    def _train_step(self, state: TrainState, inputs, labels, donate: bool,
                    slot_override=None):
        """``train_step`` with ``donate`` as given: the epoch entry points
        and ``fit`` step the state they own (a clone of the input under
        ``donate_state=False``) through it."""
        self._require_compiled()
        if not donate:
            state = state.clone()
        dev = params_device(state.params)
        step = (state.step if state.step is not None
                else torch.zeros((), dtype=torch.int32, device=dev))
        batch = {"inputs": self._place_inputs(inputs, dev),
                 "labels": self._place_labels(labels, dev),
                 "slots": dict(slot_override or {})}
        carried = (state.params, state.opt_state, step)
        packed = (self._step(batch, carried) if donate
                  else self._step_body(batch, carried))
        return (TrainState(state.params, state.opt_state, state.bn_state,
                           state.rng, step),
                self._unpack_metrics(packed))

    def _step(self, batch, carried):
        """The donated step through a :class:`~.graphs.GraphRunner`, the
        counterpart of the JAX package's ``jax.jit(train_step,
        donate_argnums=...)``.

        A step is keyed by its batch signature (every input's, the
        labels' and the ``slot_override`` slots' name, shape, dtype and
        device) and, through the runner's state check, by the addresses
        of the carried tensors.  The first call at a key runs
        ``_step_body`` eagerly (``graphs.run_eager``: a real step, on a
        side stream on the card, and the warm-up a capture needs); the
        second captures it, in the model's one graph pool, and replays
        it; later calls replay it.  Capture runs no kernel, so no step is
        applied twice.  A carried tensor that moved (a parameter replaced,
        a new state) makes the runner raise; the model then drops that
        runner and starts over: an eager step, then a new capture.  One
        runner is kept per signature."""
        sig = tuple((p, tuple(t.shape), t.dtype, t.device)
                    for p, t in flatten(batch))
        runner = self._step_graphs.get(sig)
        if runner is not None:
            try:
                out = runner.run(batch, carried)
                self.graph_replays += 1
                return out
            except StaleGraphError:
                del self._step_graphs[sig]
        key = state_key(carried)
        dev = carried[2].device
        if self._step_seen.pop(sig, None) != key:
            self._step_seen[sig] = key
            return run_eager(self._step_body, batch, carried, device=dev)
        if dev.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        tc = time.perf_counter()
        runner = GraphRunner(self._step_body, batch, carried,
                             pool=self._graph_pool, lock=self._graph_lock)
        # the capture is the step's AOT compile (JAX model.py:2460-2470):
        # one event, its wall and the donated state
        record_compile("aot", time.perf_counter() - tc, fn="train_step",
                       donated_args=1, backend=dev.type)
        self._step_graphs[sig] = runner
        self.graph_captures += 1
        out = runner.run(batch, carried)
        self.graph_replays += 1
        return out

    def _step_body(self, batch, carried):
        """One step on placed tensors (``batch``: inputs, labels and
        slots; ``carried``: params, optimizer state and step count), every
        carried tensor updated in place; the body that ``_step``
        captures.  Nothing here synchronises with the host or reads a
        value on it.  Returns the metrics packed into one vector
        (``_unpack_metrics``), so a replay's result is one small copy."""
        params, opt_state, step = carried
        inputs, labels = batch["inputs"], batch["labels"]
        slot_override = batch["slots"]
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
            lazy = self._lazy_mode and self._sparse_ops
            if lazy:
                # the lazy rows step at the step count and rate from
                # before the dense update, which moves both in place (the
                # JAX step hands lazy_update the input opt_state): copies
                pre = {k: opt_state[k].clone() for k in ("step", "lr")
                       if isinstance(opt_state.get(k), torch.Tensor)}
            self.optimizer.update(params, dgrads, opt_state)
            neg_lr = -opt_state.get("lr", self.optimizer.lr)
            for op, g in zip(self._sparse_ops, grads[len(flat):]):
                table = params[op.name]["embedding"]
                slots = slot_override.get(op.name)
                if lazy:
                    ids = (op.flat_ids(inputs[op.inputs[0].name])
                           if slots is None else slots)
                    self._lazy_update(op, table, ids, rows[op.name].detach(),
                                      g, opt_state, pre)
                elif slots is None:
                    op.scatter_apply(table, inputs[op.inputs[0].name], g,
                                     neg_lr)
                else:
                    row_update_cuda(table, slots, g, neg_lr)
            mets = compute_metrics(preds.detach(), labels, self.metrics,
                                   self.loss_type)
            mets["loss"] = loss.detach()
            step.add_(1)
            self._metric_layout = tuple((k, v.dtype) for k, v in mets.items())
            dtype = functools.reduce(torch.promote_types,
                                     (v.dtype for v in mets.values()))
            return torch.stack([v.to(dtype) for v in mets.values()])

    def _lazy_update(self, op, table, ids, w_rows, g_rows, opt_state, pre):
        """The row-lazy optimizer step of one op, in place (JAX
        ``lazy_update``, ``model.py:873-970``): ``ids`` are the rows'
        flat ids into ``table`` (its slots when cached), ``w_rows`` the
        rows the forward read, ``g_rows`` their gradients, ``pre`` the
        step count and rate from before this step.

        Duplicate ids' gradients are summed per row (in occurrence order,
        through the row-update kernel: ``index_add_`` sums in an atomic
        order), the optimizer's row math runs on every occurrence, and
        each update lands as a delta masked to the row's first
        occurrence, so one add reaches each row.  The ORDER is a
        correctness contract: the slot tables are updated first and the
        weight delta is computed from slot rows gathered again from them
        (``optim.SGDOptimizer.lazy_weight_delta``)."""
        d = op.out_dim
        space = table.view(-1, d)
        sl = ids.reshape(-1)
        n = sl.numel()
        dev = space.device
        occ = slot_rows(sl, space.shape[0])[1].reshape(-1).long()
        g_row = row_update_cuda(
            torch.zeros((n, d), dtype=torch.float32, device=dev), occ,
            g_rows.reshape(-1, d).float(), 1.0)[occ]
        # each run's first occurrence: the least position of its rank
        pos = torch.arange(n, device=dev)
        least = torch.full_like(pos, n).scatter_reduce_(0, occ, pos, "amin")
        first = (pos == least[occ])[:, None]
        tabs = {sn: opt_state[sn][op.name]["embedding"].view(-1, d)
                for sn in self._lazy_slots}
        cur = {sn: take_rows(t, sl) for sn, t in tabs.items()}
        w = w_rows.reshape(-1, d).float()
        new = self.optimizer.lazy_slot_rows(w, g_row, cur, pre)
        for sn, t in tabs.items():
            row_update_cuda(t, sl, torch.where(first, new[sn] - cur[sn], 0.0),
                            1.0)
        fresh = {sn: take_rows(t, sl) for sn, t in tabs.items()}
        delta = self.optimizer.lazy_weight_delta(w, g_row, fresh, pre)
        row_update_cuda(space, sl, torch.where(first, delta, 0.0), 1.0)

    def _unpack_metrics(self, packed) -> Dict[str, torch.Tensor]:
        """The metrics dict of a packed step result: views of ``packed``
        in each metric's own dtype."""
        return {k: packed[i].to(dt)
                for i, (k, dt) in enumerate(self._metric_layout)}

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
        the per-step path.  In lazy mode each slot table of a cached op
        is cached too, with the same ``rowof`` and slots (its original
        under ``(slot name, op)``).  The caches are the model's buffers
        (``_cache_buffer``), valid until the next prologue."""
        params = dict(state.params)
        opt_state = state.opt_state
        slots_ep, writebacks, originals = {}, [], {}
        cache_ops = self._sparse_ops if self._epoch_cache_active else ()
        for op in cache_ops:
            ids = inputs[op.inputs[0].name].to(torch.int32)
            tb = params[op.name]["embedding"]
            flat = tb.view(-1, tb.shape[-1])
            built = build_cache(flat, op.flat_ids(ids), lane_pack(op.out_dim),
                                out=functools.partial(self._cache_buffer,
                                                      ("epoch", op.name),
                                                      like=flat))
            if built is None:
                continue
            cache, slots, rowof = built
            originals[op.name] = tb
            params[op.name] = {"embedding": cache}
            for sn in self._lazy_slots:
                table = opt_state[sn][op.name]["embedding"]
                originals[(sn, op.name)] = table
                buf = self._cache_buffer(("epoch", sn, op.name),
                                         rowof.numel(), like=table)
                opt_state = _swap_slot(opt_state, sn, op.name,
                                       cache_fetch(table, rowof, out=buf))
            slots_ep[op.name] = slots
            writebacks.append((op.name, rowof))
        return (TrainState(params, opt_state, state.bn_state, state.rng,
                           state.step), slots_ep, writebacks, originals)

    def _cache_buffer(self, role, rows: int, like) -> torch.Tensor:
        """The model's ``(rows, d)`` cache buffer for ``role`` (the epoch
        cache of an op, or a ladder level's block cache of an op), in the
        dtype and on the device of ``like``: allocated at its first use,
        then the same tensor for every epoch of that shape.  The step
        graph reads its caches by address, so this is what lets one
        capture serve every block, chunk and epoch."""
        shape = (int(rows), like.shape[-1])
        key = (role, shape, like.dtype, like.device)
        buf = self._cache_buffers.get(key)
        if buf is None:
            buf = self._cache_buffers[key] = torch.empty(
                shape, dtype=like.dtype, device=like.device)
        return buf

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
        Every block of a level is fetched into that level's one buffer
        (``_cache_buffer``), so the innermost step sees the same tensors
        in every block and one captured step serves them all.  Appends
        each step's metrics to ``mets``."""
        if not meta:
            slots = arrs["slots"]
            for i in range(labels.shape[0]):
                state, m = self._train_step(
                    state, {k: v[i] for k, v in inputs.items()}, labels[i],
                    True, {n: s[i] for n, s in slots.items()})
                mets.append(m)
            return state
        (size, part), rest = meta[0], meta[1:]
        for k, blk in enumerate(arrs["blocks"]):
            lo, hi = k * size, (k + 1) * size
            params, opt_state = dict(state.params), state.opt_state
            parents = {}
            for name, m in part.items():
                rowof = blk["rowof"][name]
                parents[name] = parent = params[name]["embedding"]
                buf = self._cache_buffer(("block", len(meta), name), m,
                                         like=parent)
                params[name] = {"embedding": cache_fetch(parent, rowof,
                                                         out=buf)}
                for sn in self._lazy_slots:
                    sp = opt_state[sn][name]["embedding"]
                    parents[(sn, name)] = sp
                    buf = self._cache_buffer(("block", len(meta), sn, name),
                                             m, like=sp)
                    opt_state = _swap_slot(opt_state, sn, name,
                                           cache_fetch(sp, rowof, out=buf))
            state = self.ladder_scan(
                TrainState(params, opt_state, state.bn_state,
                           state.rng, state.step),
                {n: v[lo:hi] for n, v in inputs.items()}, labels[lo:hi],
                rest, blk["next"], mets)
            state = self._write_back(state, parents, blk["rowof"])
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
        return self._write_back(state, originals, dict(writebacks))

    def _write_back(self, state: TrainState, parents, rowofs) -> TrainState:
        """Set each cached op's final rows, and in lazy mode its slot
        tables' rows, back into the ``parents`` (keyed by op name, and by
        ``(slot name, op)``) at ``rowofs[op]``, and put the parents back
        in the state."""
        params, opt_state = dict(state.params), state.opt_state
        for name, rowof in rowofs.items():
            cache_writeback(parents[name], rowof, params[name]["embedding"])
            params[name] = {"embedding": parents[name]}
            for sn in self._lazy_slots:
                parent = parents[(sn, name)]
                cache_writeback(parent, rowof,
                                opt_state[sn][name]["embedding"])
                opt_state = _swap_slot(opt_state, sn, name, parent)
        return TrainState(params, opt_state, state.bn_state, state.rng,
                          state.step)

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

    def place_dataset(self, inputs, labels, *, device=None):
        """Place a stacked ``(num_batches, batch, ...)`` dataset on
        ``device`` once (default: the model's device, ``model.device``,
        or the card when the model was never placed)."""
        if device is None:
            device = self.device
        device = resolve_device(device)
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
        state = self._owned(state)
        dev = params_device(state.params)
        inputs, labels = self.place_dataset(inputs, labels, device=dev)
        log = active_log()
        t0 = time.perf_counter()
        self._resolve_cache(dev)
        bounds = self._epoch_chunk_bounds(labels.shape[0])
        if bounds is None:
            out = self._train_epoch(state, inputs, labels)
        else:
            out = self._run_epoch_chunks(state, inputs, labels, bounds)
        if log is not None:
            # a dispatch wall (fenced=False): the steps return before the
            # card finishes, and no device value is read here
            nb = int(labels.shape[0])
            log.emit("step", wall_s=time.perf_counter() - t0,
                     samples=nb * int(labels.shape[1]), steps=nb,
                     fenced=False, phase="train_epoch")
            sample_memory(phase="train_epoch", log=log)
        return out

    def train_epochs(self, state: TrainState, inputs, labels, epochs: int):
        """``epochs`` passes over the stacked batches, with one cache
        prologue and epilogue for all of them when the epoch is unchunked,
        else chunked epoch by epoch.  The folded metrics are stacked on a
        leading ``(epochs,)`` axis."""
        self._require_compiled()
        state = self._owned(state)
        dev = params_device(state.params)
        inputs, labels = self.place_dataset(inputs, labels, device=dev)
        log = active_log()
        t0 = time.perf_counter()
        self._resolve_cache(dev)
        bounds = self._epoch_chunk_bounds(labels.shape[0])
        if bounds is None:
            out = self._train_epochs(state, inputs, labels, epochs)
        else:
            mets = []
            for _ in range(int(epochs)):
                state, m = self._run_epoch_chunks(state, inputs, labels,
                                                  bounds)
                mets.append(m)
            out = (state, _stack(mets))
        if log is not None:
            nb = int(labels.shape[0])
            log.emit("step", wall_s=time.perf_counter() - t0,
                     samples=int(epochs) * nb * int(labels.shape[1]),
                     steps=nb, epochs=int(epochs), fenced=False,
                     phase="train_epochs")
            sample_memory(phase="train_epochs", log=log)
        return out

    def _owned(self, state: TrainState) -> TrainState:
        """The state an entry point may update in place: ``state`` itself,
        or a clone of it under ``compile(donate_state=False)``."""
        return state if self._donate_state else state.clone()

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

    def set_learning_rate(self, state: TrainState, lr: float) -> TrainState:
        """A state with the optimizer's learning rate set to ``lr`` (JAX
        ``model.py:2292-2302``), and ``optimizer.lr`` synced.  The rate is
        written into the state's ``opt_state["lr"]`` tensor in place: a
        captured step (``_step``) reads that tensor by address, so its
        next replay runs at the new rate with no new capture.  The input
        state therefore sees the new rate too (``clone`` it first to keep
        the old one).  A state without the key (an older checkpoint)
        gains it here."""
        opt = dict(state.opt_state)
        cur = opt.get("lr")
        if (isinstance(cur, torch.Tensor) and cur.dtype == torch.float32
                and cur.dim() == 0):
            cur.fill_(float(lr))
        else:
            opt["lr"] = torch.tensor(float(lr), dtype=torch.float32,
                                     device=params_device(state.params))
        if self.optimizer is not None:
            self.optimizer.lr = float(lr)
        return TrainState(state.params, opt, state.bn_state, state.rng,
                          state.step)

    def schedule_learning_rate(self, lr: float):
        """Ask for ``lr`` at the next epoch boundary of a running ``fit``
        (the hook ``LearningRateScheduler`` calls; JAX
        ``model.py:2304-2307``): ``fit`` applies it through
        ``set_learning_rate`` before the epoch's first step."""
        self._pending_lr = float(lr)

    def _apply_pending_lr(self, state: TrainState) -> TrainState:
        if self._pending_lr is not None:
            state = self.set_learning_rate(state, self._pending_lr)
            self._pending_lr = None
        return state

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
        return self.place_dataset(stacked_in, stacked_lab, device=device)

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
        takes ``train_step`` batch by batch, behind a ``PrefetchLoader``
        when ``FFConfig.prefetch_depth`` > 0 (a worker thread places the
        next batches on the device while the current step runs).

        Resilience (JAX ``model.py:2377-2403``): a ``checkpoint_manager``
        (a ``resilience.CheckpointManager`` or a directory path) with a
        ``checkpoint_every_n_steps`` / ``checkpoint_every_n_epochs``
        cadence, ``resume=True``, a ``sentinel``
        (``resilience.NaNSentinel``) or installed faults (``FF_FAULTS``,
        ``FFConfig.faults``) route training through
        ``resilience.loop.resilient_fit``: batch by batch, with a host
        decision point at every step; ``warmup`` is skipped there.

        ``callbacks``: keras-style objects (``frontends.keras_callbacks``)
        with the JAX package's hook order (``model.py:2404-2425``):
        ``set_model`` and ``on_train_begin``, ``on_epoch_begin(0)`` before
        the warmup step, then the rate a callback scheduled
        (``schedule_learning_rate``) applied through ``set_learning_rate``;
        ``on_batch_begin``/``on_batch_end`` around every step,
        ``on_epoch_end(epoch, logs)`` with the epoch's metric means (True
        stops early), ``on_train_end`` last.  Callbacks force the
        per-batch loop, as in JAX; the resilient loop takes them too."""
        epochs = epochs or self.config.epochs
        from .resilience import faultinject
        faultinject.install_from_env()
        if (checkpoint_manager is not None or checkpoint_every_n_steps
                or checkpoint_every_n_epochs or resume
                or sentinel is not None or faultinject.active()
                or getattr(self.config, "faults", "")):
            from .resilience.loop import resilient_fit
            from .resilience.manager import CheckpointManager
            if isinstance(checkpoint_manager, str):
                checkpoint_manager = CheckpointManager(checkpoint_manager)
            if resume and checkpoint_manager is None:
                raise ValueError(
                    "fit(resume=True) needs a checkpoint_manager "
                    "(instance or directory path) to restore from")
            if (checkpoint_every_n_steps or checkpoint_every_n_epochs) \
                    and checkpoint_manager is None:
                raise ValueError(
                    "a checkpoint cadence needs a checkpoint_manager "
                    "(instance or directory path)")
            return resilient_fit(
                self, state, dataloader, epochs=epochs, verbose=verbose,
                callbacks=callbacks, manager=checkpoint_manager,
                every_n_steps=checkpoint_every_n_steps,
                every_n_epochs=checkpoint_every_n_epochs, resume=resume,
                sentinel=sentinel, show_throughput=show_throughput)
        self._require_compiled()
        state = self._owned(state)
        acc = MetricsAccumulator(self.metrics)
        self._last_metrics = acc
        self._pending_lr = None
        self._fit_state = state
        cbs = list(callbacks or [])
        for cb in cbs:
            if getattr(cb, "model", None) is None:
                cb.set_model(self)
            cb.on_train_begin()
        if epochs > 0:
            # a scheduled epoch-0 rate governs the warmup step too
            for cb in cbs:
                cb.on_epoch_begin(0)
            state = self._apply_pending_lr(state)
        dev = params_device(state.params)
        scan_data = (None if cbs
                     else self._stage_scan_dataset(dataloader, dev))
        self._last_fit_used_scan = scan_data is not None
        depth = int(getattr(self.config, "prefetch_depth", 0) or 0)
        own_prefetch = None
        if (scan_data is None and depth > 0
                and not isinstance(dataloader, PrefetchLoader)):
            # snapshot=False: this wrap never checkpoints, so the worker
            # skips the per-fetch copy of the loader's resume state
            own_prefetch = PrefetchLoader(dataloader, depth=depth,
                                          place_fn=self.batch_placer(),
                                          snapshot=False)
            dataloader = own_prefetch
        try:
            state, thpt = self._fit(state, dataloader, epochs, verbose,
                                    warmup, show_throughput, acc, dev,
                                    scan_data, cbs)
        finally:
            if own_prefetch is not None:
                own_prefetch.close()
        # the trained state stays reachable if a callback raises
        self._fit_state = state
        err = None
        for cb in cbs:
            try:
                cb.on_train_end()
            except Exception as e:  # run every hook, re-raise the first
                err = err or e
        if err is not None:
            raise err
        return state, thpt

    def _fit(self, state, dataloader, epochs, verbose, warmup,
             show_throughput, acc, dev, scan_data, cbs):
        """``fit``'s staged and per-batch loops, after its routing."""
        if warmup:
            if dev.type == "cuda":
                # a kernel first reached inside an epoch (the row set at
                # the cache's writebacks) must not build in the timed window
                _cuda.build()
            first = dataloader.peek()
            state, _ = self._train_step(state, first[0], first[1], True)
            _synchronize(dev)

        def report(epoch, mets):
            acc.reset()
            acc.update({k: v for k, v in mets.items() if k != "loss"})
            if verbose:
                print(f"epoch {epoch}: {acc.report()}")

        if scan_data is not None:
            # row frequencies of the staged ids, sampled once, outside
            # the timed window (no-op while telemetry is off)
            _rowfreq.observe_dataset(scan_data[0])
        # the span chain: train.fit covers the timed region, each epoch
        # and each dispatched step or epoch program is a child; parents
        # are explicit, and with telemetry off every span is the null one
        fit_span = start_span("train.fit", attrs={"epochs": int(epochs)})
        t0 = time.perf_counter()
        samples = 0
        pstep = 0                 # the per-batch loop's host step count
        last_iter_t = t0
        stall_s = 0.0             # host wall waiting on the dataloader
        dispatch_s = 0.0          # host wall issuing the steps
        last_loss = None          # the final epoch's loss (step event)
        epochs_run = int(epochs)  # an early stop shortens the epoch loop
        fused = False
        if scan_data is not None:
            self._resolve_cache(dev)
            bounds = self._epoch_chunk_bounds(scan_data[1].shape[0])
            samples = epochs * dataloader.num_batches * dataloader.batch_size
            fused = bounds is None and epochs > 1
        if fused:
            # every epoch in one train_epochs: one cache prologue and
            # epilogue for the whole run
            dspan = start_span("train.dispatch", parent=fit_span,
                               attrs={"epochs": int(epochs), "fused": True})
            state, stacked = self._train_epochs(state, *scan_data, epochs)
            dspan.end()
            last_loss = stacked["loss"][-1] if "loss" in stacked else None
            for epoch in range(epochs):
                report(epoch, {k: v[epoch] for k, v in stacked.items()})
            self._fit_state = state
        for epoch in range(epochs) if not fused else ():
            ep_span = start_span("train.epoch", parent=fit_span,
                                 attrs={"epoch": epoch})
            if epoch > 0:
                for cb in cbs:
                    cb.on_epoch_begin(epoch)
                state = self._apply_pending_lr(state)
            if scan_data is not None:
                dspan = start_span("train.dispatch", parent=ep_span,
                                   attrs={"epoch": epoch})
                state, mets = (self._train_epoch(state, *scan_data)
                               if bounds is None else
                               self._run_epoch_chunks(state, *scan_data,
                                                      bounds))
                dspan.end()
                last_loss = mets.get("loss", last_loss)
                report(epoch, mets)
            else:
                acc.reset()
                batches = iter(dataloader)
                it = -1
                while True:
                    ts = time.perf_counter()
                    try:
                        inputs, labels = next(batches)
                    except StopIteration:
                        break
                    bstall = time.perf_counter() - ts
                    stall_s += bstall
                    it += 1
                    _rowfreq.observe_batch(inputs)
                    for cb in cbs:
                        cb.on_batch_begin(it)
                    # the null ep_span (no event log at the epoch's
                    # start) keeps the step free of span work
                    dspan = (start_span("train.dispatch", parent=ep_span,
                                        attrs={"epoch": epoch, "it": it})
                             if ep_span else NULL_SPAN)
                    td = time.perf_counter()
                    state, mets = self._train_step(state, inputs, labels,
                                                   True)
                    dwall = time.perf_counter() - td
                    dispatch_s += dwall
                    dspan.end()
                    pstep += 1
                    log = active_log()
                    if log is not None:
                        # per-step phase attribution, no device sync: the
                        # final fence's wall lands on the summary below
                        now = time.perf_counter()
                        log.emit("phase_time", step=pstep, phase="step",
                                 step_wall_ms=(now - last_iter_t) * 1e3,
                                 data_wait_ms=bstall * 1e3,
                                 dispatch_ms=dwall * 1e3,
                                 samples=int(labels.shape[0]))
                        last_iter_t = now
                    samples += int(labels.shape[0])
                    acc.update({k: v for k, v in mets.items()
                                if k != "loss"})
                    last_loss = mets.get("loss", last_loss)
                    for cb in cbs:
                        cb.on_batch_end(it)
                if verbose:
                    print(f"epoch {epoch}: {acc.report()}")
            self._fit_state = state
            logs = acc.finalized_means() if cbs else None
            stop = False
            for cb in cbs:
                if cb.on_epoch_end(epoch, logs) is True:
                    stop = True
            ep_span.end()
            if stop:
                print(f"Accuracy reached, early stop, epoch: {epoch}")
                epochs_run = epoch + 1
                break
        tf = time.perf_counter()
        _synchronize(dev)
        fence_s = time.perf_counter() - tf
        elapsed = time.perf_counter() - t0
        thpt = samples / max(elapsed, 1e-9)
        fit_span.set_attr("samples", int(samples))
        fit_span.end()
        self._fit_telemetry(scan_data is None, dataloader, epochs_run,
                            elapsed, thpt, samples, acc, last_loss, stall_s,
                            dispatch_s, fence_s, pstep)
        if verbose and show_throughput:
            print(f"ELAPSED TIME = {elapsed:.4f}s, "
                  f"THROUGHPUT = {thpt:.2f} samples/s")
        return state, thpt

    def _fit_telemetry(self, per_batch, dataloader, epochs, elapsed, thpt,
                       samples, acc, last_loss, stall_s, dispatch_s,
                       fence_s, pstep) -> None:
        """``fit``'s closing metrics and events (JAX ``model.py:2636-2686``),
        after its final device synchronise: the train gauges and step
        counter always; with an event log active, the fenced ``step``
        event, the per-batch loop's ``phase_time`` summary, the row
        frequencies and a memory sample."""
        _tmetrics.TRAIN_SAMPLES_PER_S.set(thpt)
        if per_batch:
            _tmetrics.DATA_STALL_PCT.set(100.0 * stall_s / max(elapsed, 1e-9))
        nb = getattr(dataloader, "num_batches", None)
        if nb:
            _tmetrics.TRAIN_STEPS.inc(int(epochs) * int(nb))
        log = active_log()
        if log is None:
            return
        pipeline = ({"data_stall_ms": round(stall_s * 1e3, 3),
                     "dispatch_ms": round(dispatch_s * 1e3, 3)}
                    if per_batch else {})
        log.emit("step", wall_s=elapsed, samples=int(samples),
                 samples_per_s=thpt, epochs=int(epochs), fenced=True,
                 phase="fit", metrics=acc.finalized_means(),
                 loss=(float(last_loss) if last_loss is not None else None),
                 **pipeline)
        if per_batch:
            # the per-batch loop runs ahead of the card, so the final
            # synchronise's wall is the device work the host did not hide
            exposed = 100.0 * fence_s / max(elapsed, 1e-9)
            log.emit("phase_time", step=pstep, phase="fit", steps=pstep,
                     step_wall_ms=elapsed * 1e3, data_wait_ms=stall_s * 1e3,
                     dispatch_ms=dispatch_s * 1e3,
                     sync_wait_ms=fence_s * 1e3, exposed_comm_pct=exposed,
                     samples=int(samples))
            _tmetrics.EXPOSED_COMM_PCT.set(exposed)
        _rowfreq.emit_all(log)
        sample_memory(phase="fit", log=log)


def _swap_slot(opt_state, sn: str, name: str, table):
    """``opt_state`` with slot ``sn``'s table of op ``name`` replaced by
    ``table``: new dicts, the input left as it was."""
    return {**opt_state, sn: {**opt_state[sn], name: {"embedding": table}}}


def _stack(mets):
    """Per-epoch folded metrics stacked on a leading ``(epochs,)`` axis."""
    return {k: torch.stack([m[k] for m in mets])
            for k in (mets[0] if mets else ())}


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
