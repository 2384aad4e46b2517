"""Reference-compatible imperative binding over the port's model
(counterpart of ``flexflow/core/flexflow_binding.py``).

Reference: python/flexflow/core/flexflow_cbinding.py (FFConfig :346-378,
Tensor :380-527, Parameter :529-562, FFModel :564-875, optimizers
:877-900, initializers :902-960, PerfMetrics/NetConfig/DataLoaders
:961-1067).  The reference drives a C++ Legion runtime through cffi with
imperative verbs (``forward``/``zero_gradients``/``backward``/``update``)
and dataloaders that copy batches into mapped regions.  Here the same
surface drives :class:`dlrm_flexflow_tpu_torch.model.FFModel`:
dataloaders stash the current host batch, ``forward`` runs the graph in
eval mode for the values ``get_array`` reads, ``backward`` and
``update`` are the two halves of the model's own training step
(``FFModel._step_grads`` and ``_step_apply``; ``backward`` also folds
the training metrics, as the reference computes them on the backward
pass, src/runtime/model.cc:961-966), and ``train()`` runs the model's
``fit`` (its staged epochs over the card when the loaders allow, the
captured step otherwise).

Where the port's semantics differ from the JAX package's, the verbs
follow the port's:

* the state is updated in place and keeps its identity (a donated
  ``train_step``), so ``forward``'s memo is keyed on the state object,
  its step count and the inputs' contents, never on identities alone;
* a step never advances ``rng``: dropout hashes ``(rng, step)``, so
  ``backward`` draws the masks ``train_step`` draws at the same step and
  ``update`` advances ``step``, as the step does;
* the weights go to the scope's device (``scope.py``; None: the card);
* a DLRM's tables take the row-sparse path in the verbs as in the step:
  under plain SGD each table's rows land through the row-update kernel
  on the card, never a dense table gradient.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ... import initializers as _init
from ... import optim as _optim
from ...config import FFConfig as _CoreConfig
from ...data.loader import ArrayDataLoader
from ...distributed import topology
from ...metrics import MetricsAccumulator, compute_metrics
from ...model import FFModel as _CoreModel
from ...model import TrainState, params_device
from ...ops.hetero import apply_host_sgd
from ...tensor import Tensor as _CoreTensor
from ..scope import current_device
from ..type import (ActiMode, AggrMode, DataType, LossType, MetricsType,
                    OpType, PoolType, enum_to_int, int_to_enum)

__all__ = [
    "ActiMode", "AggrMode", "DataType", "LossType", "MetricsType", "OpType",
    "PoolType", "enum_to_int", "int_to_enum",
    "FFConfig", "FFModel", "Tensor", "Parameter", "Op",
    "SGDOptimizer", "AdamOptimizer",
    "Initializer", "GlorotUniformInitializer", "ZeroInitializer",
    "UniformInitializer", "NormInitializer", "ConstantInitializer",
    "PerfMetrics", "NetConfig", "SingleDataLoader", "DataLoader2D",
    "DataLoader4D", "RegionNdarray",
    # typed layer handles (reference flexflow_cbinding.py:85-340)
    "Exp", "Add", "Subtract", "Multiply", "Divide", "Conv2D", "Pool2D",
    "Linear", "Flat", "Softmax", "Embedding", "Concat", "MSELoss", "Relu",
    "Sigmoid", "Tanh", "Elu", "Dropout", "Batch_Norm", "Batch_Matmul",
    "BatchNorm", "BatchMatmul", "Split", "Reshape", "Transpose", "Reverse",
    "convert_op_handle_to_op",
]


# ------------------------------------------------------------- enum mapping
_ACTI = {ActiMode.AC_MODE_NONE: None, ActiMode.AC_MODE_RELU: "relu",
         ActiMode.AC_MODE_SIGMOID: "sigmoid", ActiMode.AC_MODE_TANH: "tanh"}
_AGGR = {AggrMode.AGGR_MODE_NONE: "none", AggrMode.AGGR_MODE_SUM: "sum",
         AggrMode.AGGR_MODE_AVG: "avg"}
_POOL = {PoolType.POOL_MAX: "max", PoolType.POOL_AVG: "avg"}
_DTYPE = {DataType.DT_FLOAT: "float32", DataType.DT_DOUBLE: "float64",
          DataType.DT_INT32: "int32", DataType.DT_INT64: "int64",
          DataType.DT_BOOLEAN: "bool"}
_TORCH_TO_DT = {torch.float32: DataType.DT_FLOAT,
                torch.float64: DataType.DT_DOUBLE,
                torch.int32: DataType.DT_INT32,
                torch.int64: DataType.DT_INT64,
                torch.bool: DataType.DT_BOOLEAN}
_LOSS = {
    LossType.LOSS_CATEGORICAL_CROSSENTROPY: "categorical_crossentropy",
    LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        "sparse_categorical_crossentropy",
    # the reference's avg- vs sum-reduce differ by the 1/batch scale the
    # backward applies (loss_functions.cu:146); the core loss is avg-reduce
    LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE: "mean_squared_error",
    LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE: "mean_squared_error_sum_reduce",
}
_METRIC = {
    MetricsType.METRICS_ACCURACY: "accuracy",
    MetricsType.METRICS_CATEGORICAL_CROSSENTROPY: "categorical_crossentropy",
    MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
        "sparse_categorical_crossentropy",
    MetricsType.METRICS_MEAN_SQUARED_ERROR: "mean_squared_error",
    MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR: "root_mean_squared_error",
    MetricsType.METRICS_MEAN_ABSOLUTE_ERROR: "mean_absolute_error",
}


def _acti(a):
    if a is None or isinstance(a, str):
        return a
    return _ACTI[a]


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a value; bf16 as ``ml_dtypes.bfloat16``, as the
    JAX binding's arrays are."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ------------------------------------------------------------------ FFConfig
class FFConfig:
    """reference flexflow_cbinding.py:346-378."""

    def __init__(self):
        self._cfg = _CoreConfig()

    def parse_args(self, argv: Optional[List[str]] = None):
        self._cfg = _CoreConfig.parse_args(
            list(sys.argv[1:] if argv is None else argv))

    def get_batch_size(self):
        return self._cfg.batch_size

    def get_workers_per_node(self):
        return self._cfg.resolved_num_devices()

    def get_num_nodes(self):
        """The processes of the running group (one without a group)."""
        return max(1, topology()["process_count"])

    def get_epochs(self):
        return self._cfg.epochs

    def get_current_time(self):
        """Microseconds, like Legion's get_current_time usage."""
        return time.perf_counter_ns() // 1000

    def begin_trace(self, trace_id):
        """Legion tracing is a no-op here: the captured step plays that
        role."""

    def end_trace(self, trace_id):
        pass

    # convenience passthroughs (several reference scripts poke these)
    @property
    def batch_size(self):
        return self._cfg.batch_size

    @property
    def epochs(self):
        return self._cfg.epochs


# -------------------------------------------------------------------- Tensor
class Tensor:
    """reference flexflow_cbinding.py:380-527 — metadata + numpy attach.

    There are no Legion regions to map; ``attach_numpy_array`` pins a host
    array to the tensor (``get_array`` returns that very object) and
    ``inline_map``/``inline_unmap`` flip the ``mapped`` flag for API
    compatibility.
    """

    def __init__(self, core_tensor, ffmodel: Optional["FFModel"] = None,
                 owner_op: Optional["Op"] = None):
        self._t = core_tensor
        self._ffmodel = ffmodel
        self._array: Optional[np.ndarray] = None
        self.owner_op = owner_op
        self.mapped = False

    @property
    def num_dims(self):
        return len(self._t.shape)

    @property
    def dims(self):
        return tuple(int(d) for d in self._t.shape)

    # some reference-era scripts use .shape; keep both
    shape = dims

    @property
    def data_type(self):
        return _TORCH_TO_DT.get(self._t.dtype, DataType.DT_FLOAT)

    def inline_map(self, ffconfig):
        self.mapped = True

    def inline_unmap(self, ffconfig):
        self.mapped = False

    def attach_numpy_array(self, ffconfig, np_array: np.ndarray):
        assert tuple(np_array.shape) == self.dims, (
            f"attach shape {np_array.shape} != tensor dims {self.dims}")
        self._array = np_array
        self.mapped = True
        if self._ffmodel is not None:
            name = self._t.name
            # attaching to a graph input makes it the tensor's standing value
            if name in self._ffmodel._input_names():
                self._ffmodel._pending[name] = np_array

    def detach_numpy_array(self, ffconfig):
        self.mapped = False

    def is_mapped(self):
        return self.mapped

    def get_array(self, ffconfig, data_type=None):
        """Current host view: the attached array, the pending batch, or —
        for an op output — a host copy of the value from the last
        ``forward()`` (a device read: never inside a capture)."""
        if self._array is not None:
            return self._array
        if self._ffmodel is not None:
            name = self._t.name
            if name in self._ffmodel._pending:
                return np.asarray(self._ffmodel._pending[name])
            val = self._ffmodel._last_values.get(self._t.uid)
            if val is not None:
                # in the tensor's DECLARED dtype, as the model's forward
                # clamps its final output
                return _host(val.to(self._t.dtype))
        raise RuntimeError("tensor has no attached or computed value")

    def get_flat_array(self, ffconfig, data_type=None):
        return self.get_array(ffconfig, data_type).reshape(-1)


class Parameter(Tensor):
    """reference flexflow_cbinding.py:529-562 (Parameter::set/get_weights).

    Weight layouts are the port's natural ones (dense kernel is (in,
    out)); the torch/onnx importers handle layout conversion.  Both verbs
    copy (``FFModel.get_weights``/``set_weights``): a later in-place step
    leaves a returned array, and a given one, as they were.
    """

    def __init__(self, ffmodel: "FFModel", op_name: str, param_name: str,
                 shape, dtype=torch.float32):
        self._ffmodel = ffmodel
        self._op_name = op_name
        self._param_name = param_name
        self._shape = tuple(int(s) for s in shape)
        self._dtype = dtype
        self._array = None
        self.owner_op = None
        self.mapped = True

    @property
    def num_dims(self):
        return len(self._shape)

    @property
    def dims(self):
        return self._shape

    shape = dims

    @property
    def data_type(self):
        return _TORCH_TO_DT.get(self._dtype, DataType.DT_FLOAT)

    def get_weights(self, ffmodel: "FFModel") -> np.ndarray:
        state = ffmodel._require_state()
        return ffmodel._core.get_weights(state, self._op_name,
                                         self._param_name)

    def set_weights(self, ffmodel: "FFModel", np_array: np.ndarray):
        state = ffmodel._require_state()
        ffmodel._state = ffmodel._core.set_weights(
            state, self._op_name, self._param_name, np_array)

    def get_array(self, ffconfig, data_type=None):
        return self.get_weights(self._ffmodel)


# ----------------------------------------------------------------------- Op
class Op:
    """reference flexflow_cbinding.py:52-84 — layer handle with parameter
    access (flexflow_op_get_parameter_by_id)."""

    def __init__(self, ffmodel: "FFModel", core_op, op_type: OpType,
                 idx: int, name: Optional[str]):
        self._ffmodel = ffmodel
        self._core_op = core_op
        self.op_type = op_type
        self.idx = idx
        self.name = name or core_op.name

    def _params(self):
        return self._core_op.param_specs()

    def get_number_parameters(self):
        return len(self._params())

    def get_parameter_by_id(self, id: int) -> Parameter:
        spec = self._params()[id]
        return Parameter(self._ffmodel, self._core_op.name, spec.param_name,
                         spec.shape, spec.dtype)

    _get_parameter_tensor_by_id = get_parameter_by_id

    def get_weight_tensor(self) -> Parameter:
        return self.get_parameter_by_id(0)

    def get_bias_tensor(self) -> Parameter:
        return self.get_parameter_by_id(1)

    def get_input_tensor(self) -> Tensor:
        return Tensor(self._core_op.inputs[0], self._ffmodel)

    def _get_input_tensor_by_id(self, id: int) -> Tensor:
        return Tensor(self._core_op.inputs[id], self._ffmodel)

    def get_output_tensor(self) -> Tensor:
        return Tensor(self._core_op.outputs[0], self._ffmodel)

    def init(self, model: "FFModel"):
        """reference flexflow_op_init — per-op init task.  Weights here are
        initialized for the whole model at once; ensure that happened."""
        model._require_state()

    def forward(self, model: "FFModel"):
        """reference flexflow_op_forward — runs the op's forward task.  The
        model runs the whole graph; per-op stepping scripts read the same
        outputs from its values (``FFModel.forward``'s memo runs it once
        per state and batch)."""
        model.forward()


# Typed layer-handle classes (reference flexflow_cbinding.py:85-287 —
# trivial named subclasses returned by convert_op_handle_to_op:289-340).
class Exp(Op):
    pass


class Add(Op):
    pass


class Subtract(Op):
    pass


class Multiply(Op):
    pass


class Divide(Op):
    pass


class Conv2D(Op):
    pass


class Pool2D(Op):
    pass


class Linear(Op):
    pass


class Flat(Op):
    pass


class Softmax(Op):
    pass


class Embedding(Op):
    pass


class Concat(Op):
    pass


class MSELoss(Op):
    pass


class Relu(Op):
    pass


class Sigmoid(Op):
    pass


class Tanh(Op):
    pass


class Elu(Op):
    pass


class Dropout(Op):
    pass


class Batch_Norm(Op):
    pass


class Batch_Matmul(Op):
    pass


class Split(Op):
    pass


class Reshape(Op):
    pass


class Transpose(Op):
    pass


class Reverse(Op):
    pass


BatchNorm = Batch_Norm
BatchMatmul = Batch_Matmul

_OP_CLASS = {
    OpType.CONV2D: Conv2D, OpType.POOL2D: Pool2D, OpType.LINEAR: Linear,
    OpType.EMBEDDING: Embedding, OpType.FLAT: Flat, OpType.CONCAT: Concat,
    OpType.SOFTMAX: Softmax, OpType.EXP: Exp, OpType.ADD: Add,
    OpType.SUBTRACT: Subtract, OpType.MULTIPLY: Multiply,
    OpType.DIVIDE: Divide, OpType.MSELOSS: MSELoss, OpType.RELU: Relu,
    OpType.SIGMOID: Sigmoid, OpType.TANH: Tanh, OpType.ELU: Elu,
    OpType.DROPOUT: Dropout, OpType.BATCH_NORM: Batch_Norm,
    OpType.BATCH_MATMUL: Batch_Matmul, OpType.SPLIT: Split,
    OpType.RESHAPE: Reshape, OpType.TRANSPOSE: Transpose,
    OpType.REVERSE: Reverse,
}


def convert_op_handle_to_op(op_type: OpType, handle, idx=None, name=None):
    """reference flexflow_cbinding.py:289-340 — wrap a layer handle in its
    typed Op subclass.  ``handle`` here is the (ffmodel, core_op) pair the
    binding uses instead of an opaque C pointer."""
    ffmodel, core_op = handle
    cls = _OP_CLASS.get(op_type, Op)
    return cls(ffmodel, core_op, op_type, idx, name)


_CORE_OP_TYPE = {
    "Dense": OpType.LINEAR, "Conv2D": OpType.CONV2D,
    "Pool2D": OpType.POOL2D, "BatchNorm": OpType.BATCH_NORM,
    "Embedding": OpType.EMBEDDING, "StackedEmbedding": OpType.EMBEDDING,
    "Concat": OpType.CONCAT, "Split": OpType.SPLIT,
    "Reshape": OpType.RESHAPE, "Transpose": OpType.TRANSPOSE,
    "Reverse": OpType.REVERSE, "Flat": OpType.FLAT,
    "BatchMatmul": OpType.BATCH_MATMUL, "Softmax": OpType.SOFTMAX,
    "Dropout": OpType.DROPOUT,
}
_UNARY_OP_TYPE = {"exp": OpType.EXP, "relu": OpType.RELU,
                  "sigmoid": OpType.SIGMOID, "tanh": OpType.TANH,
                  "elu": OpType.ELU}
# the core's fn names (``sub``, ``mul``, ``div``) and the reference's
_BINARY_OP_TYPE = {"add": OpType.ADD, "sub": OpType.SUBTRACT,
                   "subtract": OpType.SUBTRACT, "mul": OpType.MULTIPLY,
                   "multiply": OpType.MULTIPLY, "div": OpType.DIVIDE,
                   "divide": OpType.DIVIDE}


def op_type_of_core_op(core_op) -> OpType:
    """Map a core graph op to the compat OpType enum (ElementUnary/Binary
    resolve through their ``fn`` kind)."""
    kind = getattr(core_op, "op_type", "op")
    if kind == "ElementUnary":
        return _UNARY_OP_TYPE.get(core_op.fn, OpType.OUTPUT)
    if kind == "ElementBinary":
        return _BINARY_OP_TYPE.get(core_op.fn, OpType.OUTPUT)
    return _CORE_OP_TYPE.get(kind, OpType.OUTPUT)


def track_core_layers(ffmodel: "FFModel", nb_before: int):
    """Wrap core layers created outside the factory methods (torch/onnx
    importers) in typed Op handles, like ``_track`` does for factories."""
    for core_op in ffmodel._core.layers[nb_before:]:
        ffmodel._layers[ffmodel._nb_layers] = convert_op_handle_to_op(
            op_type_of_core_op(core_op), (ffmodel, core_op),
            ffmodel._nb_layers, core_op.name)
        ffmodel._nb_layers += 1


# ------------------------------------------------------------------- FFModel
class FFModel:
    """reference flexflow_cbinding.py:564-875."""

    def __init__(self, ffconfig: FFConfig):
        self._ffconfig = ffconfig
        self._core = _CoreModel(ffconfig._cfg)
        self._layers: Dict[int, Op] = {}
        self._nb_layers = 0
        self._state: Optional[TrainState] = None
        self._pending: Dict[str, np.ndarray] = {}
        self._constants: Dict[str, np.ndarray] = {}
        self._last_values: Dict[int, torch.Tensor] = {}
        self._acc = MetricsAccumulator(())
        self._opt_compat = None
        self._label: Optional[Tensor] = None
        # forward()'s memo: (state, step count, the inputs it read)
        self._fwd_memo = None
        # backward()'s result, which update() applies: (state, batch,
        # batch norm's new statistics, gradients)
        self._backward = None

    # ------------------------------------------------------------- helpers
    def _input_names(self):
        return {t.name for t in self._core._inputs}

    def _require_state(self) -> TrainState:
        if self._state is None:
            self.init_layers()
        return self._state

    def _track(self, out, op_type: OpType, name: Optional[str]):
        core_op = self._core.layers[-1]
        self._layers[self._nb_layers] = convert_op_handle_to_op(
            op_type, (self, core_op), self._nb_layers, name)
        self._nb_layers += 1
        if isinstance(out, (list, tuple)):
            return [Tensor(t, self, self._layers[self._nb_layers - 1])
                    for t in out]
        return Tensor(out, self, self._layers[self._nb_layers - 1])

    # ------------------------------------------------------ tensor creation
    def create_tensor(self, dims, data_type=DataType.DT_FLOAT,
                      create_grad=True, name=None) -> Tensor:
        t = self._core.create_tensor(tuple(dims), _DTYPE[data_type],
                                     name=name)
        return Tensor(t, self)

    def create_constant(self, dims, value, data_type=DataType.DT_FLOAT):
        t = self.create_tensor(dims, data_type)
        arr = np.full(tuple(dims), value, dtype=_DTYPE[data_type])
        self._constants[t._t.name] = arr
        self._pending[t._t.name] = arr
        return t

    # ----------------------------------------------------------- factories
    def exp(self, x, name=None):
        return self._track(self._core.exp(x._t, name=name), OpType.EXP, name)

    def add(self, x, y, name=None):
        return self._track(self._core.add(x._t, y._t, name=name),
                           OpType.ADD, name)

    def subtract(self, x, y, name=None):
        return self._track(self._core.subtract(x._t, y._t, name=name),
                           OpType.SUBTRACT, name)

    def multiply(self, x, y, name=None):
        return self._track(self._core.multiply(x._t, y._t, name=name),
                           OpType.MULTIPLY, name)

    def divide(self, x, y, name=None):
        return self._track(self._core.divide(x._t, y._t, name=name),
                           OpType.DIVIDE, name)

    def conv2d(self, input, out_channels, kernel_h, kernel_w, stride_h,
               stride_w, padding_h, padding_w,
               activation=ActiMode.AC_MODE_NONE, use_bias=True,
               shared_op=None, kernel_initializer=None, bias_initializer=None,
               name=None):
        out = self._core.conv2d(
            input._t, out_channels, kernel_h, kernel_w, stride_h, stride_w,
            padding_h, padding_w, activation=_acti(activation),
            use_bias=use_bias,
            kernel_initializer=_unwrap_init(kernel_initializer),
            bias_initializer=_unwrap_init(bias_initializer), name=name)
        return self._track(out, OpType.CONV2D, name)

    def embedding(self, input, num_entires, out_dim,
                  aggr=AggrMode.AGGR_MODE_SUM, shared_op=None,
                  kernel_initializer=None, name=None):
        out = self._core.embedding(
            input._t, num_entires, out_dim,
            aggr=_AGGR[aggr] if isinstance(aggr, AggrMode) else aggr,
            kernel_initializer=_unwrap_init(kernel_initializer), name=name)
        return self._track(out, OpType.EMBEDDING, name)

    def pool2d(self, input, kernel_h, kernel_w, stride_h, stride_w,
               padding_h, padding_w, pool_type=PoolType.POOL_MAX,
               activation=ActiMode.AC_MODE_NONE, name=None):
        out = self._core.pool2d(
            input._t, kernel_h, kernel_w, stride_h, stride_w, padding_h,
            padding_w,
            pool_type=_POOL[pool_type] if isinstance(pool_type, PoolType)
            else pool_type,
            activation=_acti(activation), name=name)
        return self._track(out, OpType.POOL2D, name)

    def batch_norm(self, input, relu=True, name=None):
        return self._track(self._core.batch_norm(input._t, relu=relu,
                                                 name=name),
                           OpType.BATCH_NORM, name)

    def batch_matmul(self, A, B, name=None):
        return self._track(self._core.batch_matmul(A._t, B._t, name=name),
                           OpType.BATCH_MATMUL, name)

    def dense(self, input, out_dim, activation=ActiMode.AC_MODE_NONE,
              use_bias=True, shared_op=None, kernel_initializer=None,
              bias_initializer=None, name=None):
        out = self._core.dense(
            input._t, out_dim, activation=_acti(activation),
            use_bias=use_bias,
            kernel_initializer=_unwrap_init(kernel_initializer),
            bias_initializer=_unwrap_init(bias_initializer), name=name)
        return self._track(out, OpType.LINEAR, name)

    def concat(self, tensors, axis, name=None):
        assert isinstance(tensors, list), "tensors should be a list"
        out = self._core.concat([t._t for t in tensors], axis, name=name)
        return self._track(out, OpType.CONCAT, name)

    def split(self, input, sizes, axis, name=None):
        if not isinstance(sizes, list):
            dim = input.dims[axis]
            assert dim % sizes == 0, "Split dimension is not divisible"
            sizes = [dim // sizes] * sizes
        outs = self._core.split(input._t, sizes, axis, name=name)
        return self._track(list(outs), OpType.SPLIT, name)

    def flat(self, input, name=None):
        return self._track(self._core.flat(input._t, name=name),
                           OpType.FLAT, name)

    def softmax(self, input, name=None):
        return self._track(self._core.softmax(input._t, name=name),
                           OpType.SOFTMAX, name)

    def reshape(self, input, shape, name=None):
        return self._track(self._core.reshape(input._t, tuple(shape),
                                              name=name),
                           OpType.RESHAPE, name)

    def transpose(self, input, perm, name=None):
        return self._track(self._core.transpose(input._t, perm, name=name),
                           OpType.TRANSPOSE, name)

    def reverse(self, input, axis, name=None):
        return self._track(self._core.reverse(input._t, axis, name=name),
                           OpType.REVERSE, name)

    def relu(self, input, name=None):
        return self._track(self._core.relu(input._t, name=name),
                           OpType.RELU, name)

    def sigmoid(self, input, name=None):
        return self._track(self._core.sigmoid(input._t, name=name),
                           OpType.SIGMOID, name)

    def tanh(self, input, name=None):
        return self._track(self._core.tanh(input._t, name=name),
                           OpType.TANH, name)

    def elu(self, input, name=None):
        return self._track(self._core.elu(input._t, name=name),
                           OpType.ELU, name)

    def dropout(self, input, rate, seed, name=None):
        return self._track(self._core.dropout(input._t, rate, seed,
                                              name=name),
                           OpType.DROPOUT, name)

    # ------------------------------------------------------------ optimizer
    def set_sgd_optimizer(self, optimizer):
        self._opt_compat = optimizer

    def set_adam_optimizer(self, optimizer):
        self._opt_compat = optimizer

    # -------------------------------------------------------------- compile
    def compile(self, optimizer=None, loss_type=None, metrics=None,
                comp_mode=None):
        if optimizer is not None:
            self._opt_compat = optimizer
        # unwrap compat optimizers; pass core optimizers straight through
        # (never silently drop to the default-SGD fallback)
        core_opt = getattr(self._opt_compat, "_core", self._opt_compat)
        loss = _LOSS[loss_type] if isinstance(loss_type, LossType) \
            else (loss_type or "mean_squared_error")
        mets = tuple(_METRIC[m] if isinstance(m, MetricsType) else m
                     for m in (metrics or ()))
        core = self._core
        core.compile(optimizer=core_opt, loss_type=loss, metrics=mets)
        self._acc = MetricsAccumulator(mets)
        # the label tensor the reference's compile creates (the JAX
        # model's label_tensor): class ids for a sparse loss, else the
        # output's shape and dtype
        out = core.final_tensor
        if "sparse" in core.loss_type:
            shape, dtype = tuple(out.shape[:-1]) + (1,), torch.int32
        else:
            shape, dtype = out.shape, out.dtype
        self._label = Tensor(_CoreTensor(shape, dtype, name="label"), self)
        return self

    def get_label_tensor(self) -> Tensor:
        assert self._label is not None, "compile() first"
        return self._label

    # ----------------------------------------------------- imperative verbs
    def init_layers(self):
        """reference FFModel::init_layers — weight init, on the scope's
        device (``scope.current_device``; None: the card)."""
        self._state = self._core.init(device=current_device())
        self._fwd_memo = None
        self._backward = None

    def _label_name(self):
        return self._label._t.name if self._label is not None else None

    def _batch_inputs(self):
        """The pending arrays of the inputs some op reads (a full
        dataset's attached tensor is an input no op reads), and the
        labels."""
        core = self._core
        read = {t.uid for op in core.layers for t in op.inputs}
        names = {t.name for t in core._inputs if t.uid in read}
        label_name = self._label_name()
        inputs = {k: v for k, v in self._pending.items()
                  if k in names and k != label_name}
        labels = self._pending.get(label_name)
        return inputs, labels

    def _one_rank(self):
        if self._core._spmd is not None:
            raise NotImplementedError(
                "the imperative verbs run on one rank; under a mesh of "
                "more than one rank train() with fit's loop instead")

    def forward(self):
        """The graph in eval mode on the pending batch; ``get_array`` of
        an op output reads its value.  Memoized per (state, step count,
        input contents): a script that steps its layers one by one calls
        every ``Op.forward``, which funnels here, and must not run the
        whole graph once per layer.  The state is updated in place by a
        step, so its step count is part of the key (a host read), and an
        attached buffer can be refilled in place, so the inputs' contents
        are compared with the copies the memo keeps."""
        state = self._require_state()
        self._one_rank()
        inputs, _ = self._batch_inputs()
        step = None if state.step is None else int(state.step)
        memo = self._fwd_memo
        if (memo is not None and memo[0] is state and memo[1] == step
                and memo[2].keys() == inputs.keys()
                and all(np.array_equal(memo[2][k], np.asarray(v))
                        for k, v in inputs.items())):
            return
        core = self._core
        placed = core._place_inputs(inputs, params_device(state.params))
        with torch.no_grad():
            self._last_values, _ = core._apply(
                state.params, placed, training=False, bn_state=state.bn_state)
        self._fwd_memo = (state, step, {k: np.array(v)
                                        for k, v in inputs.items()})

    def _step_args(self, state):
        """The training step's placed batch and carried state
        (``FFModel._train_step``'s)."""
        core = self._core
        inputs, labels = self._batch_inputs()
        assert labels is not None, (
            f"no dataloader feeds the label tensor {self._label_name()!r}")
        dev = params_device(state.params)
        batch = {"inputs": core._place_inputs(inputs, dev),
                 "labels": core._place_labels(labels, dev), "slots": {}}
        carried = (state.params, state.opt_state, state.step,
                   state.bn_state, state.rng if core.has_stochastic else None)
        return batch, carried

    def zero_gradients(self):
        """Gradients are fresh values each backward — nothing to zero."""

    def backward(self):
        """The training step's first half (``FFModel._step_grads``) on the
        pending batch: the training forward, with dropout's masks of the
        state's key and step count, the loss and its gradients, which
        ``update`` applies; the batch's training metrics are folded."""
        state = self._require_state()
        self._one_rank()
        batch, carried = self._step_args(state)
        core = self._core
        loss, preds, new_bn, grads = core._step_grads(batch, carried)
        self._backward = (state, batch, carried, new_bn, grads)
        self._acc.update(compute_metrics(preds, batch["labels"],
                                         core.metrics, core.loss_type))

    def update(self):
        """The training step's second half (``FFModel._step_apply``), in
        place: batch norm's statistics, the optimizer's step (the tables'
        rows through the row update) and ``step + 1``; then, as
        ``train_step`` does, the host tables' SGD step."""
        assert self._backward is not None, "backward() before update()"
        state, batch, carried, new_bn, grads = self._backward
        assert state is self._state, "the state changed since backward()"
        core = self._core
        core._step_apply(batch, carried, new_bn, grads)
        lr = getattr(core.optimizer, "lr", 0.01)
        for op in core._hetero_ops:
            if getattr(op, "host_table", None) is not None:
                apply_host_sgd(op.host_table, lr)
        self._backward = None

    def compute_metrics(self):
        _, labels = self._batch_inputs()
        final = self._core.final_tensor
        preds = self._last_values[final.uid].to(final.dtype)
        labels = self._core._place_labels(labels, preds.device)
        self._acc.update(compute_metrics(preds, labels, self._core.metrics,
                                         self._core.loss_type))

    def reset_metrics(self):
        self._acc.reset()

    def prefetch(self):
        pass

    # ------------------------------------------------------------ the loops
    def train(self, dataloaders, epochs=1, batch_size=64):
        """reference flexflow_cbinding.py:789-812 — same loop shape, the
        body the model's captured train step.

        When every dataloader is a Single/Pair loader over attached host
        arrays, the whole run goes through the model's ``fit``, whose
        staged epochs place the data on the device once and replay the
        captured step (``warmup=False`` and no throughput line: the exact
        step count and stdout of the per-batch loop below)."""
        state = self._require_state()
        num_samples = dataloaders[0].get_num_samples()
        batch = self._ffconfig.get_batch_size()
        label_name = self._label_name()
        core = self._core

        singles = []
        for d in dataloaders:
            if isinstance(d, _PairDataLoader):
                singles.extend([d._input, d._label])
            elif isinstance(d, SingleDataLoader):
                singles.append(d)
            else:
                singles = None
                break
        if singles is not None:
            n = min(s.num_samples for s in singles)
            inputs, labels = {}, None
            for s in singles:
                if s._target == label_name:
                    labels = s._data[:n]
                else:
                    inputs[s._target] = s._data[:n]
            # the loaders must feed EVERY op-consumed graph input (a graph
            # with extra attached tensors — constants staged via _pending —
            # keeps the general per-batch loop)
            consumed = {t.uid for op in core.layers for t in op.inputs}
            required = {t.name for t in core._inputs if t.uid in consumed}
            if (labels is not None and inputs and n >= batch
                    and epochs > 0 and set(inputs) >= required):
                loader = ArrayDataLoader(inputs, labels, batch)
                state, _ = core.fit(state, loader, epochs=epochs,
                                    verbose=True, warmup=False,
                                    show_throughput=False)
                self._state = state
                self._acc = core._last_metrics
                return

        for epoch in range(epochs):
            for d in dataloaders:
                d.reset()
            self.reset_metrics()
            for _ in range(int(num_samples / batch)):
                for d in dataloaders:
                    d.next_batch(self)
                inputs, labels = self._batch_inputs()
                assert labels is not None, (
                    f"no dataloader feeds the label tensor {label_name!r}")
                state, mets = core.train_step(state, inputs, labels)
                self._acc.update({k: v for k, v in mets.items()
                                  if k != "loss"})
            self._state = state
            print(f"epoch {epoch}: {self._acc.report()}")

    def eval(self, dataloaders):
        state = self._require_state()
        num_samples = dataloaders[0].get_num_samples()
        batch = self._ffconfig.get_batch_size()
        for d in dataloaders:
            d.reset()
        self.reset_metrics()
        for _ in range(int(num_samples / batch)):
            for d in dataloaders:
                d.next_batch(self)
            inputs, labels = self._batch_inputs()
            mets = self._core.eval_step(state, inputs, labels)
            self._acc.update({k: v for k, v in mets.items() if k != "loss"})

    # ----------------------------------------------------------- inspection
    def get_layers(self):
        return self._layers

    def get_layer_by_id(self, layer_id) -> Op:
        return self._layers[layer_id]

    def get_layer_by_name(self, layer_name) -> Op:
        for op in self._layers.values():
            if op.name == layer_name or op._core_op.name == layer_name:
                return op
        raise KeyError(f"no layer named {layer_name}")

    def add_layer(self, op_type: OpType, name=None):
        """reference flexflow_cbinding.py:579-583 — wrap the next untracked
        core layer in its typed Op handle (used by frontends that build
        layers through the core graph rather than the factory methods)."""
        core_op = self._core.layers[self._nb_layers]
        self._layers[self._nb_layers] = convert_op_handle_to_op(
            op_type, (self, core_op), self._nb_layers, name)
        self._nb_layers += 1

    def get_tensor_by_id(self, id) -> Parameter:
        """reference flexflow_model_get_parameter_by_id: flat index over all
        parameters in layer order."""
        flat = [(op.name, spec) for op in self._core.layers
                for spec in op.param_specs()]
        op_name, spec = flat[id]
        return Parameter(self, op_name, spec.param_name, spec.shape,
                         spec.dtype)

    def get_perf_metrics(self) -> "PerfMetrics":
        return PerfMetrics(self._acc)

    def print_layers(self, id=-1):
        for i, op in self._layers.items():
            if id in (-1, i):
                core = op._core_op
                outs = ", ".join(str(t.shape) for t in core.outputs)
                print(f"layer {i}: {core.name} ({op.op_type.name}) -> {outs}")


def _unwrap_init(initializer):
    if initializer is None:
        return None
    return getattr(initializer, "_core", initializer)


# --------------------------------------------------------------- optimizers
class SGDOptimizer:
    """reference flexflow_cbinding.py:877-888."""

    def __init__(self, ffmodel, lr=0.01, momentum=0.0, nesterov=False,
                 weight_decay=0.0):
        self._ffmodel = ffmodel
        self._core = _optim.SGDOptimizer(lr=lr, momentum=momentum,
                                         nesterov=nesterov,
                                         weight_decay=weight_decay)

    def set_learning_rate(self, learning_rate):
        self._core.lr = float(learning_rate)
        m = self._ffmodel
        if m is not None and m._state is not None:
            m._state = m._core.set_learning_rate(m._state, learning_rate)


class AdamOptimizer:
    """reference flexflow_cbinding.py:890-900."""

    def __init__(self, ffmodel, alpha=0.001, beta1=0.9, beta2=0.999,
                 weight_decay=0.0, epsilon=1e-8):
        self._ffmodel = ffmodel
        self._core = _optim.AdamOptimizer(lr=alpha, beta1=beta1, beta2=beta2,
                                          weight_decay=weight_decay,
                                          epsilon=epsilon)

    def set_learning_rate(self, learning_rate):
        self._core.lr = float(learning_rate)
        m = self._ffmodel
        if m is not None and m._state is not None:
            m._state = m._core.set_learning_rate(m._state, learning_rate)


# -------------------------------------------------------------- initializers
class Initializer:
    _core = None


class GlorotUniformInitializer(Initializer):
    def __init__(self, seed=0):
        self._core = _init.GlorotUniform()
        self.seed = seed


class ZeroInitializer(Initializer):
    def __init__(self):
        self._core = _init.ZeroInitializer()


class UniformInitializer(Initializer):
    def __init__(self, seed=0, minv=-0.05, maxv=0.05):
        self._core = _init.UniformInitializer(minval=minv, maxval=maxv,
                                              seed=seed)


class NormInitializer(Initializer):
    def __init__(self, seed=0, meanv=0.0, stddev=1.0):
        self._core = _init.NormInitializer(mean=meanv, stddev=stddev,
                                           seed=seed)


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self._core = _init.ConstantInitializer(value=value)


# -------------------------------------------------------------- PerfMetrics
class PerfMetrics:
    """reference flexflow_cbinding.py:961-969 (accuracy in percent)."""

    def __init__(self, acc: MetricsAccumulator):
        self._acc = acc

    def get_accuracy(self) -> float:
        return self._acc.get_accuracy()


# ----------------------------------------------------------------- NetConfig
class NetConfig:
    """reference flexflow_cbinding.py:974-983 — carries the --dataset path
    from the command line."""

    def __init__(self):
        self.dataset_path = ""
        argv = sys.argv
        for i, a in enumerate(argv):
            if a == "--dataset" and i + 1 < len(argv):
                self.dataset_path = argv[i + 1]


# --------------------------------------------------------------- dataloaders
class SingleDataLoader:
    """reference flexflow_cbinding.py:1028-1048: one (batch_tensor,
    full_tensor) pair; ``next_batch`` stages the next slice for the model's
    imperative verbs (the reference scatters into the mapped region via a
    custom GPU task, python/flexflow_dataloader.cc)."""

    def __init__(self, ffmodel: FFModel, input: Tensor, full_input: Tensor,
                 num_samples: int, data_type=None):
        assert full_input._array is not None, \
            "attach_numpy_array the full tensor first"
        self._ffmodel = ffmodel
        self._target = input._t.name
        self._data = np.asarray(full_input._array)
        self.num_samples = int(num_samples)
        self._idx = 0

    def set_num_samples(self, samples):
        self.num_samples = int(samples)

    def get_num_samples(self):
        return self.num_samples

    def next_batch(self, ffmodel: FFModel):
        b = ffmodel._ffconfig.get_batch_size()
        if self._idx + b > self.num_samples:
            self._idx = 0
        sl = self._data[self._idx:self._idx + b]
        self._idx += b
        ffmodel._pending[self._target] = sl

    def reset(self):
        self._idx = 0


class _PairDataLoader:
    """input+label pair loaders (reference DataLoader2D/4D,
    flexflow_cbinding.py:985-1026)."""

    def __init__(self, ffmodel, input, label, full_input=0, full_label=0,
                 num_samples=0, ffnetconfig=0):
        self._input = SingleDataLoader(ffmodel, input, full_input,
                                       num_samples)
        self._label = SingleDataLoader(ffmodel, label, full_label,
                                       num_samples)
        self.num_samples = int(num_samples)

    def set_num_samples(self, samples):
        self.num_samples = int(samples)
        self._input.set_num_samples(samples)
        self._label.set_num_samples(samples)

    def get_num_samples(self):
        return self.num_samples

    def next_batch(self, ffmodel):
        self._input.next_batch(ffmodel)
        self._label.next_batch(ffmodel)

    def reset(self):
        self._input.reset()
        self._label.reset()


class DataLoader2D(_PairDataLoader):
    pass


class DataLoader4D(_PairDataLoader):
    pass


# ------------------------------------------------------------- RegionNdarray
class RegionNdarray:
    """reference flexflow_cbinding.py:1050-1067 — numpy array-interface
    shim.  Kept for scripts that construct it directly."""

    __slots__ = ["__array_interface__"]

    def __init__(self, shape, data_type, base_ptr, strides, read_only):
        if data_type == DataType.DT_FLOAT:
            field_type = "<f4"
        elif data_type == DataType.DT_INT32:
            field_type = "<i4"
        else:
            raise AssertionError("unknown data type")
        self.__array_interface__ = {
            "version": 3,
            "shape": shape,
            "typestr": field_type,
            "data": (base_ptr, read_only),
            "strides": strides,
        }
