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
and the epilogue stay eager.

``compile(mesh=make_mesh(...))`` runs the model across the ranks of a
mesh, one process per rank (``parallel/mesh.py`` states the execution
model, ``parallel/spmd.py`` executes it): each op's ``parallel_config``
sets its output's layout and its parameters' shards, every rank passes
the global batch (or a ``distributed.GlobalArray`` of its rows) and keeps
its rows, and a step's gradients are the global loss's.  Under a mesh of
more than one rank no hand-written kernel runs and no step is captured
(both later speed work, ROADMAP item 1), the epoch row cache is off, and
``train_epoch(s)`` and ``fit``'s staged branch step batch by batch.  A
mesh whose axes are all of size 1 runs exactly the program of no mesh,
kernels and capture included.

A model with host-placed tables (the hetero strategy: ``compile``'s
``"cpu"`` placements, ``ops/hetero.py``) runs every step eagerly, since
a host round trip cannot sit inside a CUDA graph, and after each step
applies the host SGD step to its tables at ``optimizer.lr``
(``apply_host_sgd``, whatever optimizer the device parameters take, as
in the JAX package).  The ids that feed those tables alone stay in host
memory.  Under a mesh of more than one rank the owner rank (the mesh's
device 0) alone holds, looks up, updates and saves each host table, over
the global batch (``ops/hetero.py::HostComm``); a mixed placement keeps
its card tables on the mesh's layouts.  Such a model takes no staged
epoch, epoch cache or ladder: ``fit`` runs batch by batch, as the JAX
package's does, and
``train_epoch(s)`` steps batch by batch with the host update after each
step (the JAX scanned epoch never applies it: ROADMAP.md Queue C).

Checkpoints and resilient training are the durability slice
(``checkpoint.py``, ``resilience/``, ``data/prefetch.py``): ``fit``
hands any of its checkpoint, resume or sentinel options, and installed
faults, to ``resilience.loop.resilient_fit``.

Every training path runs the ops in training mode.  Batch norm's running
statistics ride in the state's ``bn_state`` and each step writes them in
place; dropout's masks are hashed on the device from the state's key and
step (``ops/softmax.py``).  Both therefore live inside the captured step,
and a replay draws new masks.  A graph ending in a Softmax op trains on
the softmax's input through the from-logits loss, as the JAX package
does.

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
from .ops import (LSTM, BatchMatmul, BatchNorm, Concat, Conv2D, Dropout,
                  ElementBinary, ElementUnary, Embedding, Flat,
                  FusedEmbedInteract, Linear, MixtureOfExperts,
                  MultiHeadAttention, Op, OverlappedEmbedBottom, Pool2D,
                  RaggedStackedEmbedding,
                  Reshape, Reverse, Softmax, Split, StackedEmbedding,
                  Transpose)
from .ops.embedding import lane_pack, take_rows
from .ops.hetero import apply_host_sgd
from .ops.quantized import QUANT_MODES
from .ops.row_update_kernel import row_update_cuda, row_update_ref
from .ops.slotting import slot_rows
from .ops.softmax import fold_in
from .data.prefetch import BatchPlacer, PrefetchLoader
from .optim import Optimizer, SGDOptimizer
from .parallel.mesh import (MODEL_AXIS, Mesh, effective_config, entry_axes,
                            make_mesh, param_pspec, sharding)
from .parallel.parallel_config import Strategy
from .telemetry import active_log, sample_memory
from .telemetry import metrics as _tmetrics
from .telemetry import fleet as _fleet
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

    ``bn_state`` maps each batch-norm op to its running ``mean`` and
    ``var`` (``{}`` for a graph without one); a training step writes the
    new statistics into those tensors in place.  ``rng`` is the run's
    uint32 ``(2,)`` key and ``step`` the count of steps taken.  A step
    never advances ``rng`` (the JAX step splits it): the port's dropout
    masks are a counter-based hash (``ops/softmax.py``) of the key
    ``fold_in(fold_in(rng, step), op index)``, with the op's ``seed``
    folded in when nonzero, so each step's masks depend on ``rng`` and
    the step count alone, and a run resumed from a checkpoint draws the
    masks of the run it was cut from.

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
            if not isinstance(x, torch.Tensor):
                return x
            y = x.clone()
            if hasattr(x, "_ff_layout"):  # a mesh block (parallel/spmd.py)
                y._ff_layout = x._ff_layout
            return y
        return TrainState(copy(self.params), copy(self.opt_state),
                          copy(self.bn_state), copy(self.rng),
                          copy(self.step))


def initial_rng(seed: int, device) -> torch.Tensor:
    """The uint32 ``(2,)`` key ``init`` puts in a state: ``[0, seed]``,
    the layout of ``jax.random.PRNGKey(seed)``.  It is not the key the JAX
    package's ``init`` keeps (that one is split from it); the port's
    dropout masks are hashed from it (``TrainState``)."""
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
        # the mesh (compile), and the executor of a mesh of more than one
        # rank (parallel/spmd.py), None on one device
        self.mesh: Optional[Mesh] = None
        self._spmd = None
        # kernels allowed (compile clears it under a mesh of more than one
        # rank) and the row update that follows from it
        self._allow_kernel = True
        self._row_update = row_update_cuda
        # set by compile()
        self.optimizer: Optional[Optimizer] = None
        self.loss_type: Optional[str] = None
        self.metrics: Tuple[str, ...] = ()
        self._loss_fn = None
        self._sparse_ops: List[Op] = []
        # the hetero ops (compile): tables in host memory, updated on the
        # host after each step, and the inputs that feed them alone,
        # which stay in host memory
        self._hetero_ops: List[Op] = []
        self._host_inputs: frozenset = frozenset()
        # lazy mode (compile): the optimizer slot tables updated on touch
        self._lazy_slots: Tuple[str, ...] = ()
        self._lazy_mode = False
        self._donate_state = True
        # fit's hooks: a rate a callback scheduled for the next epoch, and
        # the state as of the last finished epoch (ModelCheckpoint's)
        self._pending_lr: Optional[float] = None
        self._fit_state: Optional["TrainState"] = None
        # whether train_epoch(s) run the epoch row cache: resolved from
        # the config by each epoch entry point (_resolve_cache)
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
        # the activation_dtype rewrite's original output dtypes, by uid
        self._orig_out_dtypes: Dict[int, torch.dtype] = {}
        # bumped by every compile: a serving engine rebuilds its bucket
        # graphs when the model it captured was compiled again
        self.compile_generation = 0

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

    def overlapped_embed_bottom(self, ids_tensor, dense_tensor, num_tables,
                                num_entries, out_dim, mlp_bot,
                                sigmoid_bot=-1, aggr="sum", overlap="auto",
                                microbatches=2, kernel_initializer=None,
                                name=None, table_dtype=None):
        """Stacked embedding and bottom-MLP dense stack as ONE node
        (``ops/overlap_embed.py``): under a manual table exchange
        (``FFConfig.table_exchange`` and a "model" mesh axis) the forward
        runs the microbatched pipeline of ``parallel/overlap.py``, each
        microbatch's exchange beside its dense slice.  Returns ``(emb,
        bottom)`` tensors."""
        op = OverlappedEmbedBottom(
            self._name("overlapped_embed_bottom", name), ids_tensor,
            dense_tensor, num_tables, num_entries, out_dim, mlp_bot,
            sigmoid_bot, aggr, overlap, microbatches, kernel_initializer,
            table_dtype=self._table_dtype(table_dtype),
            compute_dtype=self._op_compute_dtype())
        self.layers.append(op)
        return op.outputs

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

    def conv2d(self, input_tensor, out_channels, kernel_h, kernel_w,
               stride_h, stride_w, padding_h, padding_w, activation=None,
               use_bias=True, groups=1, kernel_initializer=None,
               bias_initializer=None, name=None):
        op = Conv2D(self._name("conv2d", name), input_tensor, out_channels,
                    kernel_h, kernel_w, stride_h, stride_w, padding_h,
                    padding_w, activation, use_bias, groups,
                    kernel_initializer, bias_initializer,
                    self._op_compute_dtype())
        return self._add(op)

    def pool2d(self, input_tensor, kernel_h, kernel_w, stride_h, stride_w,
               padding_h, padding_w, pool_type="max", activation=None,
               name=None):
        op = Pool2D(self._name("pool2d", name), input_tensor, kernel_h,
                    kernel_w, stride_h, stride_w, padding_h, padding_w,
                    pool_type, activation)
        return self._add(op)

    def batch_norm(self, input_tensor, relu=False, name=None):
        return self._add(BatchNorm(self._name("batch_norm", name),
                                   input_tensor, relu))

    def split(self, input_tensor, sizes, axis, name=None):
        """The pieces as a list, one tensor per size."""
        op = Split(self._name("split", name), input_tensor, sizes, axis)
        self.layers.append(op)
        return op.outputs

    def reverse(self, input_tensor, axis, name=None):
        return self._add(Reverse(self._name("reverse", name), input_tensor,
                                 axis))

    def softmax(self, input_tensor, axis=-1, name=None):
        return self._add(Softmax(self._name("softmax", name), input_tensor,
                                 axis))

    def lstm(self, input_tensor, hidden_dim, return_sequences=True,
             reverse=False, initial_state=None, return_state=False,
             name=None):
        """The output sequence (or last state); with ``return_state``,
        ``[output, h, c]``."""
        op = LSTM(self._name("lstm", name), input_tensor, hidden_dim,
                  return_sequences, reverse, initial_state=initial_state,
                  return_state=return_state,
                  compute_dtype=self._op_compute_dtype())
        self.layers.append(op)
        return op.outputs if return_state else op.outputs[0]

    def moe(self, input_tensor, num_experts, hidden_dim, top_k=2,
            activation="relu", name=None):
        return self._add(MixtureOfExperts(
            self._name("moe", name), input_tensor, num_experts, hidden_dim,
            top_k, activation))

    def dropout(self, input_tensor, rate=0.5, seed=0, name=None):
        return self._add(Dropout(self._name("dropout", name), input_tensor,
                                 rate, seed))

    def multihead_attention(self, query, key, value, embed_dim, num_heads,
                            causal=False, seq_parallel=False, name=None):
        return self._add(MultiHeadAttention(
            self._name("attention", name), query, key, value, embed_dim,
            num_heads, causal, seq_parallel=seq_parallel,
            compute_dtype=self._op_compute_dtype()))

    # elementwise binary (reference model.h add/subtract/multiply/divide)
    def _binary(self, fn, a, b, name):
        return self._add(ElementBinary(self._name(fn, name), a, b, fn))

    def add(self, a, b, name=None):
        return self._binary("add", a, b, name)

    def subtract(self, a, b, name=None):
        return self._binary("sub", a, b, name)

    def multiply(self, a, b, name=None):
        return self._binary("mul", a, b, name)

    def divide(self, a, b, name=None):
        return self._binary("div", a, b, name)

    # elementwise unary (reference model.h exp/relu/... and scalar_*)
    def _unary(self, fn, x, name, scalar=None):
        return self._add(ElementUnary(self._name(fn, name), x, fn, scalar))

    def exp(self, x, name=None):
        return self._unary("exp", x, name)

    def relu(self, x, name=None):
        return self._unary("relu", x, name)

    def sigmoid(self, x, name=None):
        return self._unary("sigmoid", x, name)

    def tanh(self, x, name=None):
        return self._unary("tanh", x, name)

    def elu(self, x, name=None):
        return self._unary("elu", x, name)

    def gelu(self, x, name=None):
        return self._unary("gelu", x, name)

    def identity(self, x, name=None):
        return self._unary("identity", x, name)

    def scalar_add(self, x, scalar, name=None):
        return self._unary("scalar_add", x, name, scalar)

    def scalar_sub(self, x, scalar, name=None):
        return self._unary("scalar_sub", x, name, scalar)

    def scalar_multiply(self, x, scalar, name=None):
        return self._unary("scalar_mul", x, name, scalar)

    def scalar_truediv(self, x, scalar, name=None):
        return self._unary("scalar_truediv", x, name, scalar)

    def pow(self, x, exponent, name=None):
        return self._unary("pow", x, name, exponent)

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
        """Whether the graph output is already probabilities: a Softmax
        op or a layer with a softmax activation, followed only by
        value-preserving shape ops."""
        for op in reversed(self.layers):
            if isinstance(op, Softmax):
                return True
            if getattr(op, "activation", None) == "softmax":
                return True
            if not isinstance(op, (Reshape, Transpose, Reverse, Flat)):
                return False
        return False

    @property
    def has_stochastic(self) -> bool:
        """Whether a training step draws randomness (a dropout op with a
        nonzero rate)."""
        return any(isinstance(op, Dropout) and op.rate > 0.0
                   for op in self.layers)

    # --------------------------------------------------------------- forward
    def _apply(self, params, input_values: Dict[str, torch.Tensor], *,
               training: bool = False, rng=None, bn_state=None):
        """Run the graph: every op once, in build order.  ``rng`` is the
        step's key (``fold_in(state.rng, step)``): the dropout op at
        position ``i`` draws from ``fold_in(rng, i)``.  A stateful op
        (batch norm) reads its entry of ``bn_state``.  Returns the values
        by tensor uid and the stateful ops' new state.  Under a mesh of
        more than one rank the values are the rank's blocks, each in the
        plan's layout (``parallel/spmd.py``)."""
        if self._spmd is not None:
            return self._spmd.apply(params, input_values, training=training,
                                    rng=rng, bn_state=bn_state)
        return self._apply_plain(params, input_values, training=training,
                                 rng=rng, bn_state=bn_state)

    def _apply_plain(self, params, input_values, *, training: bool = False,
                     rng=None, bn_state=None):
        """``_apply``'s one-device program on whole parameters and the
        whole batch, under a mesh too (a replicated serving engine runs
        it on every rank)."""
        values: Dict[int, torch.Tensor] = {}
        for t in self._inputs:
            if t.name in input_values:
                values[t.uid] = input_values[t.name]
        new_bn: Dict[str, Any] = {}
        for i, op in enumerate(self.layers):
            xs = [values[t.uid] for t in op.inputs]
            kw = {}
            stateful = getattr(op, "has_state", False)
            if stateful:
                kw["state"] = bn_state.get(op.name) if bn_state else None
            op_rng = (fold_in(rng, i) if isinstance(op, Dropout) and training
                      and rng is not None else None)
            outs = op.forward(params.get(op.name, {}), xs,
                              training=training, rng=op_rng, **kw)
            if stateful:
                new_bn[op.name] = op._last_state
            for o, t in zip(outs, op.outputs):
                values[t.uid] = o
        return values, new_bn

    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type="mean_squared_error", metrics=("accuracy",),
                mesh=None, strategy: Optional[Strategy] = None,
                donate_state: bool = True):
        """Fix the optimizer (default: SGD at the config's learning rate
        and weight decay), the loss and the metrics; choose the row-sparse
        embedding ops; build the forward.

        ``mesh`` (JAX ``model.py:504-578``): False means no mesh; a
        :class:`~.parallel.mesh.Mesh` is used as given; None keeps the
        model's mesh, or, with none and a process group of more than one
        rank, builds ``make_mesh(config.mesh_shape)``.  Every op gets
        ``_mesh``.  ``FFConfig.table_exchange`` ("off" | "allgather" |
        "all_to_all") sets each ``StackedEmbedding``'s ``exchange_mode``
        where the mesh's "model" axis has more than one rank and divides
        its tables, else warns (``RuntimeWarning``) and leaves it off.  A
        strategy whose configs a named-axis mesh cannot execute exactly
        (a device list other than ``range(n)``, a degree other than the
        axis size) warns once with the ops it narrows.

        ``strategy`` (a :class:`Strategy`) becomes ``self.strategy``; as
        in the JAX package, ``FFConfig.import_strategy_file`` replaces it,
        and ``search_budget > 0`` with no strategy runs ``mcmc_search``
        over ``resolved_num_devices()`` devices (exported to
        ``export_strategy_file`` when set).  Each op named in the
        strategy gets its ``parallel_config``.  On one device, without a
        mesh, a strategy changes no value: the model computes as it
        would without one.  A ``"cpu"`` device type places an op that
        has a ``placement`` (the per-table ``Embedding``) on the host:
        its table lives in host memory (``ops/hetero.py``), and the op
        joins ``_hetero_ops``; on any other op it is ignored, as in the
        JAX package (``model.py:493-503``).

        ``donate_state=False`` (JAX ``compile``'s flag) keeps every input
        state: ``train_step`` then steps a clone whatever its ``donate``,
        and ``train_epoch(s)`` and ``fit`` train a clone of their input
        state, taken once at entry."""
        if mesh not in (None, False) and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh),"
                            f" None or False, got {type(mesh).__name__}")
        self._resolve_strategy(strategy)
        self._resolve_mesh(mesh)
        act_dtype = getattr(self.config, "activation_dtype", "float32")
        if act_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"activation_dtype must be 'float32'|'bfloat16', "
                f"got {act_dtype!r}")
        for name in ("sparse_embedding_updates", "epoch_row_cache",
                     "packed_tables", "epoch_cache_view",
                     "epoch_cache_segmented"):
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
        # the tensor the loss reads (predictions and metrics read the
        # final output): for a graph ending in a Softmax op, the softmax's
        # input through the stable from-logits form, as the JAX package
        # fuses softmax and CCE (model.py:455-475); a graph ending in raw
        # logits takes the from-logits form on its output
        self._loss_uid = self.final_tensor.uid
        if self.loss_type in _CCE:
            base = ("sparse_categorical_crossentropy"
                    if "sparse" in self.loss_type
                    else "categorical_crossentropy")
            last = self.layers[-1]
            if isinstance(last, Softmax):
                self._loss_uid = last.inputs[0].uid
                self._loss_fn = get_loss(base + "_from_logits")
            elif not self._output_is_softmaxed():
                self._loss_fn = get_loss(base + "_from_logits")
        self.metrics = tuple(metrics)
        out = self.final_tensor
        final_uid, final_dtype = out.uid, out.dtype
        self._rewrite_activation_dtype(act_dtype, final_uid)

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
        # the bag-kernel ops (use_pallas) keep the dense gradient and
        # host-placed ops their host update, as the JAX package's
        # _device_table_op leaves both out
        # and, as there, the manual exchange and an op whose params carry
        # more than its table; under a mesh a table sharded over "model"
        # keeps the row-sparse path only as stacked tables (whole tables
        # per rank)
        shards = self._param_shardings() if self._spmd_mesh() else {}

        def sparse_eligible(op):
            spec = shards.get(op.name, {}).get("embedding")
            return (spec is None or isinstance(op, StackedEmbedding)
                    or not any(self.mesh.axes_key(entry_axes(e))
                               for e in spec.spec))

        self._sparse_ops = [op for op in self.layers
                            if sparse_ok and isinstance(op, EMBEDDING_OPS)
                            and not getattr(op, "use_pallas", False)
                            and getattr(op, "placement", "tpu") != "cpu"
                            and not getattr(op, "exchange_mode", None)
                            and getattr(op, "sparse_path_ok", True)
                            and sparse_eligible(op)
                            and op.inputs[0].uid in input_uids]
        self._spmd = None
        if self._spmd_mesh():
            from .parallel.spmd import SpmdPlan
            self._spmd = SpmdPlan(self, self.mesh)
        self._place_host_tables()

        def forward(params, inputs, bn_state=None):
            with torch.inference_mode():
                if self._spmd is not None:
                    from .parallel.spmd import forward_values
                    values, _ = forward_values(self, params, inputs,
                                               bn_state or {})
                    out = self._spmd.global_output(values[final_uid],
                                                   self.final_tensor)
                    return out.to(final_dtype)
                values, _ = self._apply(params, inputs,
                                        bn_state=bn_state or {})
                return values[final_uid].to(final_dtype)

        self._forward_fn = forward
        self.compile_generation += 1
        # the step graphs baked in the old loss, metrics, optimizer and
        # activation dtypes
        self._step_graphs.clear()
        self._step_seen.clear()
        self._drop_pool_if_empty()
        return self

    def _place_host_tables(self) -> None:
        """The host tables' owner across the ranks of a mesh (JAX runs
        the host callback on mesh device 0's process): every host-placed
        op gets the leader protocol (``ops/hetero.py::HostComm``, whose
        gloo group every rank builds here), and a rank other than the
        owner drops any table it holds, so only the owner looks up,
        updates and saves it.  Off such a mesh each op keeps its own."""
        from .ops.hetero import HostComm, HostEmbeddingTable
        comm = (HostComm(self.mesh) if self._hetero_ops
                and self._spmd_mesh() else None)
        for op in self._hetero_ops:
            op._host_comm = comm
            table = getattr(op, "host_table", None)
            if table is not None and not op.host_owner:
                HostEmbeddingTable.drop(table.key)
                op.host_table = None

    def _spmd_mesh(self) -> bool:
        """Whether the model runs across more than one rank."""
        return self.mesh is not None and not self.mesh.trivial

    def _resolve_mesh(self, mesh) -> None:
        """``compile``'s mesh, each op's ``_mesh`` and ``exchange_mode``,
        and the narrowing warning (JAX ``model.py:504-578``)."""
        import warnings

        import torch.distributed as dist
        if mesh is False:  # explicit single-device request
            self.mesh = None
        elif mesh is not None:
            self.mesh = mesh
        elif (self.mesh is None and dist.is_available()
              and dist.is_initialized() and dist.get_world_size() > 1):
            self.mesh = make_mesh(self.config.mesh_shape)
        # the one decision on kernels: none under a mesh of more than one
        # rank (JAX allow_kernel=mesh is None; a mesh of size-1 axes is
        # the no-mesh program), read by each op and by the row updates
        self._allow_kernel = not self._spmd_mesh()
        self._row_update = (row_update_cuda if self._allow_kernel
                            else row_update_ref)
        for op in self.layers:
            op._mesh = self.mesh
            op._allow_kernel = self._allow_kernel
        xmode = getattr(self.config, "table_exchange", "off")
        if xmode not in ("off", "allgather", "all_to_all"):
            raise ValueError(
                f"table_exchange must be 'off'|'allgather'|'all_to_all', "
                f"got {xmode!r}")
        for op in self.layers:
            if not isinstance(op, StackedEmbedding):
                continue
            engage = xmode != "off"
            if engage:
                # only where the exchange can run: else the op would lose
                # the row-sparse path and take the plain lookup
                mp = (self.mesh.shape.get("model", 1)
                      if self.mesh is not None else 1)
                if mp <= 1 or op.num_tables % mp != 0:
                    warnings.warn(
                        f"table_exchange={xmode!r} requested but "
                        f"{op.name} cannot engage it (model axis {mp}, "
                        f"{op.num_tables} tables); using the automatic "
                        "SPMD path instead", RuntimeWarning)
                    engage = False
            op.exchange_mode = xmode if engage else None
        if self.mesh is None:
            return
        narrowed = []
        for op in self.layers:
            pc = op.parallel_config
            if (pc is None or getattr(op, "exchange_mode", None)
                    or hasattr(op, "output_pspec")
                    or pc.device_type == "cpu" or pc.device_ids is None):
                continue
            eff, exact = effective_config(pc, op.outputs[0].ndim, self.mesh)
            if not exact:
                narrowed.append((op.name, tuple(pc.dims), pc.device_ids,
                                 eff))
        if narrowed:
            head = ", ".join(
                f"{n}: dims {d} devices {i} -> executes as "
                f"axis-sharded {e}" for n, d, i, e in narrowed[:5])
            warnings.warn(
                f"{len(narrowed)} op(s) have ParallelConfigs not "
                f"expressible as mesh-axis sharding; executing the "
                f"nearest axis-sharded approximation ({head}"
                f"{', ...' if len(narrowed) > 5 else ''}). Explicit "
                f"per-device placement (reference mapper.cc:62-95) "
                f"is narrowed to named-axis sharding on TPU.",
                stacklevel=3)

    def _param_shardings(self):
        """Per-parameter ``NamedSharding`` from each op's strategy:
        replicated for data parallelism, sharded over "model" on the
        spec's ``sharded_dim`` where the op is tensor-parallel (JAX
        ``model.py:1971-2012``)."""
        assert self.mesh is not None
        shardings = {}
        for op in self.layers:
            specs = op.param_specs()
            if not specs:
                continue
            pc = op.parallel_config
            tp = pc is not None and any(d > 1 for d in pc.dims[1:])
            if tp:
                msize = self.mesh.shape.get(MODEL_AXIS, 1)
                for s in specs:
                    if s.sharded_dim is not None and msize > 1 \
                            and s.shape[s.sharded_dim] % msize != 0:
                        raise ValueError(
                            f"{op.name}: parameter dim {s.sharded_dim} "
                            f"({s.shape[s.sharded_dim]}) does not divide "
                            f"the {msize}-way '{MODEL_AXIS}' mesh axis")
            shardings[op.name] = {
                s.param_name: sharding(self.mesh, param_pspec(
                    s.sharded_dim, len(s.shape), self.mesh, tp))
                for s in specs}
        return shardings

    def _shard_params(self, params):
        """The rank's blocks of global ``{op: {param: tensor}}`` under the
        plan's parameter layouts; a sharded block remembers its layout
        (``_ff_layout``), which ``get_weights`` and
        ``bridge.params_to_numpy`` gather by."""
        from .parallel.collectives import local_block
        plan = self._spmd
        out = {}
        for op_name, d in params.items():
            out[op_name] = {}
            for k, v in d.items():
                spec = plan.params.get(op_name, {}).get(k)
                if spec is None or not any(plan.mesh.axes_key(
                        entry_axes(e)) for e in spec):
                    out[op_name][k] = v
                    continue
                blk = local_block(v, spec, plan.mesh)
                blk._ff_layout = (plan.mesh, spec)
                out[op_name][k] = blk
        return out

    def _rewrite_activation_dtype(self, act_dtype: str, final_uid: int
                                  ) -> None:
        """``FFConfig.activation_dtype`` (JAX ``model.py:630-700``):
        "bfloat16" declares every intermediate f32 output tensor bf16;
        the final output and the loss input (the pre-softmax logits on
        the fused softmax and CCE path) stay f32.  The original dtypes
        are remembered, so a recompile is idempotent: "float32" restores
        them, and a tensor that only now became exempt is restored
        first."""
        exempt = (final_uid, self._loss_uid)
        orig = self._orig_out_dtypes
        for op in self.layers:
            for t in op.outputs:
                if t.uid in exempt:
                    if t.uid in orig:
                        t.dtype = orig.pop(t.uid)
                    continue
                if act_dtype == "bfloat16":
                    if t.dtype == torch.float32:
                        orig.setdefault(t.uid, t.dtype)
                        t.dtype = torch.bfloat16
                elif t.uid in orig:
                    t.dtype = orig.pop(t.uid)

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
        self._hetero_ops = []
        for op in self.layers:
            if op.name in self.strategy:
                op.parallel_config = self.strategy[op.name]
            pc = op.parallel_config
            if (pc is not None and pc.device_type == "cpu"
                    and hasattr(op, "placement")):
                # the hetero placement (JAX model.py:493-503): the table
                # in host memory, updated on the host after each step;
                # a "cpu" config on an op without a placement is ignored
                op.placement = "cpu"
                self._hetero_ops.append(op)
        # the ids that feed host-placed ops only stay in host memory
        consumers: Dict[int, List[Op]] = {}
        for op in self.layers:
            for t in op.inputs:
                consumers.setdefault(t.uid, []).append(op)
        self._host_inputs = frozenset(
            t.name for t in self._inputs if consumers.get(t.uid) and all(
                getattr(op, "placement", "tpu") == "cpu"
                for op in consumers[t.uid]))

    # ------------------------------------------------------------ parameters
    def _place_opt_state(self, opt_state, dev):
        def place(x):
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))
            return x.to(dev, copy=True)  # as load_params' params
        return place(opt_state)

    def init(self, seed: Optional[int] = None, *, device=None
             ) -> TrainState:
        """Draw every op's parameters on ``device`` (default: the CUDA
        card; raises without one) from generators seeded by ``seed`` and
        the op's position, and the optimizer's initial state.  Under a
        mesh every rank draws the global values and keeps its blocks."""
        dev = resolve_device(device)
        seed = self.config.seed if seed is None else seed
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, op in enumerate(self.layers):
            if not op.param_specs():
                continue
            gen = torch.Generator(device=dev).manual_seed(
                derive_seed(seed, i, op.name))
            params[op.name] = op.init_params(gen)
        if self._spmd is not None:
            params = self._shard_params(params)
        self.device = dev
        return self._state(params, None, dev, seed)

    def _state(self, params, opt_state, dev, seed) -> TrainState:
        """A fresh state: the optimizer's initial state unless given, the
        stateful ops' initial state (``op.init_state``), the key of
        ``seed`` and step 0, all on ``dev``."""
        if opt_state is None:
            opt_state = (self.optimizer.init(params)
                         if self.optimizer is not None else {})
            # a slot table of a sharded parameter is that block's: it
            # carries the layout the gathers read (bridge.state_to_numpy)
            for slots in opt_state.values():
                if not isinstance(slots, dict):
                    continue
                for op_name, d in slots.items():
                    for k, t in d.items():
                        src = params.get(op_name, {}).get(k)
                        if hasattr(src, "_ff_layout"):
                            t._ff_layout = src._ff_layout
        else:
            opt_state = self._place_opt_state(opt_state, dev)
            if self._spmd is not None:
                # the slot tables mirror their parameters' blocks
                opt_state = {k: (self._shard_params(v) if isinstance(v, dict)
                                 else v) for k, v in opt_state.items()}
        bn_state = {op.name: op.init_state(device=dev) for op in self.layers
                    if getattr(op, "has_state", False)}
        return TrainState(params, opt_state, bn_state,
                          initial_rng(seed, dev),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def load_params(self, params, device=None, opt_state=None, *,
                    host_tables=None) -> TrainState:
        """Install copies of ``{op: {param: array or tensor}}`` (for
        example ``bridge.params_from_jax`` of a JAX model's params) on
        ``device`` (default: this model's device, else the CUDA card), so
        a later in-place step leaves the caller's values as they were.
        Names, shapes and dtypes must match the graph's parameter specs
        exactly.
        ``opt_state`` (for example ``bridge.opt_state_from_jax``) is
        placed beside them; by default the optimizer starts afresh.  Each
        batch norm starts at its ``init_state`` (a whole state, running
        statistics included, crosses with ``bridge.state_from_jax`` or
        an npz checkpoint).

        ``host_tables`` (``{op name: (R, d) array}``, for example
        ``bridge.host_tables_from_jax`` of a JAX hetero model) become the
        host-placed ops' tables, copied; a host-placed op that gets none
        keeps the table it has, and one without a table raises.  Across
        the ranks of a mesh only the owner rank installs them (the others
        ignore them)."""
        host_tables = dict(host_tables or {})
        for op in self._hetero_ops:
            if not op.host_owner:
                # across ranks the owner alone holds the table
                host_tables.pop(op.name, None)
                continue
            if op.name in host_tables:
                arr = np.asarray(host_tables.pop(op.name))
                if arr.shape != (op.num_entries, op.out_dim):
                    raise ValueError(
                        f"{op.name}: host table {arr.shape}, expected "
                        f"{(op.num_entries, op.out_dim)}")
                op.set_host_table(np.array(arr, dtype=np.float32))
            elif getattr(op, "host_table", None) is None:
                raise ValueError(f"{op.name} is placed on the host and has "
                                 "no table: pass it in host_tables, or "
                                 "init the model first")
        if host_tables:
            raise KeyError(f"host_tables name {sorted(host_tables)}, which "
                           "are not host-placed ops of this model")
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
                out[op_name][pname] = v.to(dev, copy=True).contiguous()
        if self._spmd is not None:
            out = self._shard_params(out)
        self.device = dev
        return self._state(out, opt_state, dev, self.config.seed)

    def get_weights(self, state: TrainState, op_name: str, param_name: str
                    ) -> np.ndarray:
        """A host copy of one parameter: a later in-place step (a
        donated ``train_step``) leaves it as it was, as the JAX package's
        array is.  A parameter sharded over a mesh is gathered: the
        global value, on every rank."""
        from .parallel.spmd import global_param
        return global_param(state.params[op_name][param_name]).detach().to(
            "cpu", copy=True).numpy()

    def set_weights(self, state: TrainState, op_name: str, param_name: str,
                    value) -> TrainState:
        """A new state with one parameter replaced (same shape, dtype and
        device), from a numpy array or a tensor on any device; ``state``
        is left as it was.  The parameter is a copy: a later in-place
        step (a donated ``train_step``) leaves ``value`` as it was, as
        the JAX package's immutable array does."""
        tgt = state.params[op_name][param_name]
        src = (value.detach() if isinstance(value, torch.Tensor)
               else torch.as_tensor(np.asarray(value)))
        layout = getattr(tgt, "_ff_layout", None)
        if layout is not None:  # a global value onto a mesh block
            from .parallel.collectives import local_block
            src = local_block(src.to(tgt.device), layout[1], layout[0])
        arr = torch.empty_like(tgt).copy_(src.reshape(tgt.shape))
        if layout is not None:
            arr._ff_layout = layout
        params = dict(state.params)
        params[op_name] = {**params[op_name], param_name: arr}
        return TrainState(params, state.opt_state, state.bn_state, state.rng,
                          state.step)

    # ------------------------------------------------------------- inference
    def _place_inputs(self, inputs, device, shard: bool = True
                      ) -> Dict[str, torch.Tensor]:
        """Every model input as a tensor of its dtype on ``device``, but
        the ids that feed host-placed ops only (``_host_inputs``), which
        stay in host memory: the host lookup reads them there.  Under a
        mesh of more than one rank (and ``shard``) each input is the
        rank's block of the global batch (``SpmdPlan.place``)."""
        from .distributed import GlobalArray
        placed = {}
        for t in self._inputs:
            if t.name not in inputs:
                raise ValueError(f"inputs missing {t.name!r} (model inputs: "
                                 f"{[i.name for i in self._inputs]})")
            v = inputs[t.name]
            if isinstance(v, GlobalArray):
                loc = v.local.to(device=device, dtype=t.dtype)
                placed[t.name] = (loc if self._spmd is None else
                                  self._spmd.place(t, GlobalArray(
                                      loc, v.shape, v.spec, v.mesh)))
                continue
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.asarray(v, dtype=numpy_dtype(t.dtype)))
            dev = "cpu" if t.name in self._host_inputs else device
            if self._spmd is not None and shard:
                v = self._spmd.place(t, v)
            placed[t.name] = v.to(device=dev, dtype=t.dtype)
        return placed

    def _place_labels(self, labels, device, shard: bool = True
                      ) -> torch.Tensor:
        from .distributed import GlobalArray
        dtype = (torch.int64 if "sparse" in (self.loss_type or "")
                 else self.final_tensor.dtype)
        if isinstance(labels, GlobalArray):
            loc = labels.local.to(device=device, dtype=dtype)
            if self._spmd is None:
                return loc
            return self._spmd.labels_for(GlobalArray(
                loc, labels.shape, labels.spec, labels.mesh),
                self.final_tensor)
        if not isinstance(labels, torch.Tensor):
            labels = torch.from_numpy(np.asarray(labels))
        if self._spmd is not None and shard:
            labels = self._spmd.labels_for(labels, self.final_tensor)
        return labels.to(device=device, dtype=dtype)

    def shard_batch(self, arr):
        """One array of a batch on the model's device (the JAX package's
        ``shard_batch``): the ``place_fn`` a caller may hand a
        ``PrefetchLoader``.  Under a mesh of more than one rank it is the
        rank's data-axis block, as a ``distributed.GlobalArray``."""
        dev = self.device if self.device is not None else resolve_device()
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.asarray(arr))
        if self._spmd is None or arr.dim() == 0:
            return arr.to(dev)
        from .distributed import GlobalArray
        from .parallel.collectives import local_block
        from .parallel.spmd import _spec
        plan = self._spmd
        plan.check_batch(arr.shape[0])
        spec = _spec(plan.data_axes, arr.dim())
        return GlobalArray(local_block(arr, spec, plan.mesh).to(dev),
                           tuple(arr.shape), spec, plan.mesh)

    def batch_placer(self) -> BatchPlacer:
        """The placement ``fit`` gives its own ``PrefetchLoader``: a whole
        batch cast to the graph's input and label dtypes on the host and
        copied to the model's device, on the card through pinned staging
        buffers on a stream of its own (``data/prefetch.py``), but the
        ids of host-placed tables, which stay on the host."""
        self._require_compiled()
        dev = self.device if self.device is not None else resolve_device()
        labels = (torch.int64 if "sparse" in (self.loss_type or "")
                  else self.final_tensor.dtype)
        return BatchPlacer(dev, {t.name: t.dtype for t in self._inputs},
                           labels, host=self._host_inputs)

    def predict(self, params_or_state, inputs) -> torch.Tensor:
        """Labels-free inference: the public forward for serving.
        ``params_or_state`` is a :class:`TrainState` or a bare params
        dict; ``inputs`` maps input names to arrays or tensors, which are
        moved to the parameters' device.  Rows are independent, so the
        first n rows of a padded batch equal the unpadded forward."""
        if self._forward_fn is None:
            raise ValueError("model must be compile()d before predict")
        params = getattr(params_or_state, "params", params_or_state)
        bn_state = getattr(params_or_state, "bn_state", None) or {}
        if not bn_state and any(getattr(op, "has_state", False)
                                for op in self.layers):
            # bare params would run batch norm on the batch's statistics:
            # rows would leak into each other
            raise ValueError(
                "model has BatchNorm state; predict needs a TrainState "
                "(or any object with .params/.bn_state) so eval runs on "
                "running statistics, not a bare params dict")
        return self._forward_fn(
            params, self._place_inputs(inputs, params_device(params)),
            bn_state)

    def forward(self, state: TrainState, inputs) -> torch.Tensor:
        return self.predict(state, inputs)

    # -------------------------------------------------------------- training
    def _require_compiled(self):
        if self._loss_fn is None:
            raise ValueError("model must be compile()d before training")

    def _loss_and_preds(self, values, labels):
        final = self.final_tensor
        preds = values[final.uid].to(final.dtype)
        loss_in = values[self._loss_uid].to(final.dtype)
        return self._loss_fn(loss_in, labels), preds

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
        # the key only where a dropout op draws from it, so a graph
        # without one never depends on where the key lives
        carried = (state.params, state.opt_state, step, state.bn_state,
                   state.rng if self.has_stochastic else None)
        # a host round trip cannot be captured: a model with host tables
        # steps eagerly, and its tables take the host SGD step after it
        # (JAX model.py:2075-2085); a step across ranks runs eagerly too
        if self._spmd is not None:
            from .parallel.spmd import step_body
            packed = step_body(self, batch, carried)
        elif donate and not self._hetero_ops:
            packed = self._step(batch, carried)
        else:
            packed = self._step_body(batch, carried)
        if self._hetero_ops:
            # the owner's tables only, across the ranks of a mesh
            lr = getattr(self.optimizer, "lr", 0.01)
            for op in self._hetero_ops:
                if getattr(op, "host_table", None) is not None:
                    apply_host_sgd(op.host_table, lr)
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
                self._drop_pool_if_empty()
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

    def _drop_pool_if_empty(self) -> None:
        """Forget the graph pool once no step graph holds it.  A pool
        dies with its last graph, and a capture into a dead pool's handle
        fails (the caching allocator asserts the pool's use count), so
        the next capture takes a new handle."""
        if not self._step_graphs:
            self._graph_pool = None

    def _step_body(self, batch, carried):
        """One step on placed tensors (``batch``: inputs, labels and
        slots; ``carried``: params, optimizer state, step count, batch
        norm state and the key), every carried tensor updated in place;
        the body that ``_step`` captures.  The ops run in training mode:
        dropout draws from ``fold_in(key, step)`` (a replay reads the
        step by address, so each replay draws new masks), and batch
        norm's new running statistics are copied into ``bn_state``.
        Nothing here synchronises with the host or reads a value on it.
        Returns the metrics packed into one vector (``_unpack_metrics``),
        so a replay's result is one small copy."""
        params, opt_state, step, bn_state, key = carried
        if self.has_stochastic:
            if key is None:
                raise ValueError("a graph with dropout trains from a "
                                 "state with an rng key")
            key = fold_in(key, step)
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
            values, new_bn = self._apply(run, inputs, training=True,
                                         rng=key, bn_state=bn_state)
            loss, preds = self._loss_and_preds(values, labels)
            wrt = [leaves[op][k] for op, k in flat] + list(rows.values())
            # a parameter the loss does not reach gets a zero gradient,
            # as jax.grad gives it
            grads = torch.autograd.grad(loss, wrt, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            for name, new in new_bn.items():
                for k, v in new.items():
                    bn_state[name][k].copy_(v)
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
                    self._row_update(table, slots, g, neg_lr)
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
        (``optim.SGDOptimizer.lazy_weight_delta``).  The row update is
        ``compile``'s (the plain ``row_update_ref`` under a mesh)."""
        d = op.out_dim
        space = table.view(-1, d)
        sl = ids.reshape(-1)
        n = sl.numel()
        dev = space.device
        occ = slot_rows(sl, space.shape[0])[1].reshape(-1).long()
        g_row = self._row_update(
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
            self._row_update(t, sl, torch.where(first, new[sn] - cur[sn],
                                                0.0), 1.0)
        fresh = {sn: take_rows(t, sl) for sn, t in tabs.items()}
        delta = self.optimizer.lazy_weight_delta(w, g_row, fresh, pre)
        self._row_update(space, sl, torch.where(first, delta, 0.0), 1.0)

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
            if self._spmd is not None:
                from .parallel.spmd import forward_values, reduce_metrics
                values, _ = forward_values(self, state.params, inputs,
                                           state.bn_state)
            else:
                values, _ = self._apply(state.params, inputs,
                                        bn_state=state.bn_state)
            loss, preds = self._loss_and_preds(values, labels)
            mets = compute_metrics(preds, labels, self.metrics,
                                   self.loss_type)
            if self._spmd is not None:
                return reduce_metrics(self._spmd, self.final_tensor, mets,
                                      loss, self.loss_type)
            mets["loss"] = loss
        return mets

    # ------------------------------------------------- the epoch row cache
    def _resolve_cache(self) -> None:
        """Set ``_epoch_cache_active``: only under "on", on any device,
        with at least one row-sparse op and no host tables.  "auto" is
        off, as the JAX package's "auto" is off the TPU (config.py says
        why)."""
        self._epoch_cache_active = (
            bool(self._sparse_ops) and not self._hetero_ops
            and self._spmd is None
            and self.config.epoch_row_cache == "on")

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
        if cache_ops and self.config.epoch_cache_regions not in _MODES:
            # where the JAX package checks it: at a prologue with cache ops
            raise ValueError(
                f"epoch_cache_regions must be 'auto'|'on'|'off', "
                f"got {self.config.epoch_cache_regions!r}")
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
        or the card when the model was never placed).  Under a mesh of
        more than one rank the global batches are kept whole, and each
        step keeps the rank's rows of its batch."""
        if device is None:
            device = self.device
        device = resolve_device(device)
        shard = self._spmd is None
        return (self._place_inputs(inputs, device, shard=shard),
                self._place_labels(labels, device, shard=shard))

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
        self._resolve_cache()
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
        self._resolve_cache()
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
        loop: a model with host tables (as in JAX), or a loader that is
        not array-backed, shuffles, keeps a last short batch, is empty, or
        holds more than ``fit_scan_max_bytes``."""
        cap = self.config.fit_scan_max_bytes
        if not (cap > 0 and not self._hetero_ops
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
            self._resolve_cache()
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
            # beside the cost model's price of the grad all-reduce (None
            # on one rank, and then no field)
            pred = _fleet.predicted_sync_ms(
                getattr(self._fit_state, "params", None))
            log.emit("phase_time", step=pstep, phase="fit", steps=pstep,
                     step_wall_ms=elapsed * 1e3, data_wait_ms=stall_s * 1e3,
                     dispatch_ms=dispatch_s * 1e3,
                     sync_wait_ms=fence_s * 1e3, exposed_comm_pct=exposed,
                     predicted_sync_ms=(None if pred is None
                                        else pred * max(pstep, 1)),
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
