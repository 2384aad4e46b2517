"""Keras-compatible frontend: Sequential and functional Model
(counterpart of ``dlrm_flexflow_tpu/frontends/keras.py``, with the same
classes, names and positional API).

The reference Keras frontend (reference: python/flexflow/keras/ —
BaseModel/Sequential/functional Model keras/models/base_model.py:30-509,
model.py:54 (BFS over the layer DAG at compile); layer classes keras/layers/: Dense, Flatten, Embedding,
Activation, Dropout, Reshape, Conv2D, Concatenate, Add, Subtract,
Multiply, BatchNormalization, MaxPooling2D, AveragePooling2D; optimizer/
loss/metric string resolution; fit/evaluate driving the dataloader loop
base_model.py:367+).

Layers here are thin declarative records; ``compile`` lowers the DAG onto
an FFModel graph (the same lowering the reference does by calling the C++
factories, with the JAX package's op names, so weights cross between the
packages through ``bridge``) and defers execution to the port's step.
``compile(..., device=)`` places the weights: the CUDA card unless the
caller asks for ``"cpu"``.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import FFConfig
from ..model import FFModel, TrainState
from ..optim import AdamOptimizer, Optimizer, SGDOptimizer
from ..data.loader import ArrayDataLoader

# --------------------------------------------------------------------- layers


class Layer:
    """Declarative layer node; ``lower(model, inputs)`` emits core ops.

    ``input_shape`` on the first layer of a Sequential replaces an explicit
    Input (reference keras/layers/base_layer accepts it the same way).
    """

    def __init__(self, name: Optional[str] = None,
                 input_shape: Optional[Tuple[int, ...]] = None,
                 dtype: str = "float32", **_ignored):
        self.name = name
        self.input_shape = tuple(input_shape) if input_shape else None
        self.input_dtype = dtype
        self._inbound: List["Layer"] = []
        self._node: Optional[object] = None  # symbolic KTensor
        # filled in at lowering time by BaseModel._emit: per owning keras
        # model, the core Op(s) this layer produced there — what makes
        # layer.get_weights/set_weights (reference net2net examples, e.g.
        # seq_mnist_mlp_net2net.py) work, including when the same layer
        # object ends up lowered into several models (teacher + composed).
        # id(owner) -> [owner, ops, build_gen]
        self._bindings: Dict[int, list] = {}

    def __call__(self, *inputs):
        return KTensor(self, _flatten_ktensors(inputs))

    def lower(self, model: FFModel, xs):
        raise NotImplementedError

    def output_steps(self):  # number of core tensors produced
        return 1

    # ---- weight transfer (reference layer.get_weights/set_weights, used by
    # the net2net examples: seq_mnist_mlp_net2net.py:39-72) ------------------
    def _built_op(self, ffmodel=None):
        """Resolve (owning keras model, core op) for weight access.

        ``ffmodel`` — a core FFModel or keras BaseModel — selects among
        owners when this layer is bound into several models (the reference
        passes ``teacher_model.ffmodel`` explicitly for exactly this
        reason); without it the most recently bound owner wins.
        """
        cands = []
        for ref, ops, gen in self._bindings.values():
            owner = ref()
            if owner is None:  # model was garbage-collected
                continue
            real = [o for o in ops if o is not _NESTED_MARKER]
            if not real or owner.state is None or gen != owner._build_gen:
                continue
            cands.append((owner, real[0]))
        if ffmodel is not None:
            for owner, op in cands:
                if owner is ffmodel or owner.ffmodel is ffmodel:
                    return owner, op
            raise ValueError(
                f"layer {self.name or type(self).__name__} is not part of "
                "the given model — pass the model that contains it (or no "
                "model at all for the most recent binding)")
        if not cands:
            raise ValueError(
                f"layer {self.name or type(self).__name__} has no built "
                "weights — compile the model that contains it first")
        return cands[-1]

    def get_weights(self, ffmodel=None) -> Tuple[np.ndarray, ...]:
        """Return this layer's weights as numpy arrays (kernel, bias, ...).

        ``ffmodel`` follows the reference signature
        (``dense.get_weights(model.ffmodel)``) and disambiguates which
        model's TrainState to read when the layer is part of several.
        """
        owner, op = self._built_op(ffmodel)
        # core get_weights returns LOGICAL shapes (packed-storage
        # embedding tables unpack at the host boundary)
        return tuple(owner.ffmodel.get_weights(owner.state, op.name,
                                               s.param_name)
                     for s in op.param_specs())

    def set_weights(self, *args):
        """Overwrite this layer's weights.

        Accepts the reference form ``set_weights(ffmodel, kernel, bias)``
        and the keras form ``set_weights([kernel, bias])``.
        """
        arrays: List[np.ndarray] = []
        target = None
        for a in args:
            if isinstance(a, (BaseModel, FFModel)):
                target = a  # reference passes model.ffmodel first
            elif isinstance(a, (list, tuple)):
                arrays.extend(a)
            else:
                arrays.append(a)
        owner, op = self._built_op(target)
        specs = op.param_specs()
        if len(arrays) != len(specs):
            raise ValueError(f"expected {len(specs)} arrays "
                             f"({[s.param_name for s in specs]}), "
                             f"got {len(arrays)}")
        st = owner.state
        for spec, arr in zip(specs, arrays):
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(
                    f"weight {op.name}/{spec.param_name}: expected shape "
                    f"{tuple(spec.shape)}, got {tuple(arr.shape)}")
            st = owner.ffmodel.set_weights(st, op.name, spec.param_name, arr)
        owner.state = st


#: placeholder recorded in a nested model's ``_ops`` to mark "lowered in
#: this build" without pretending the model itself owns a single core Op
_NESTED_MARKER = object()


def _flatten_ktensors(inputs) -> List["KTensor"]:
    ins: List[KTensor] = []
    for i in inputs:
        ins.extend(i if isinstance(i, (list, tuple)) else [i])
    return ins


class KTensor:
    """Symbolic output of a keras layer call (functional API edge)."""

    def __init__(self, layer: Layer, inputs: List["KTensor"]):
        self.layer = layer
        self.inputs = inputs


class Input(Layer):
    def __init__(self, shape: Tuple[int, ...], dtype="float32",
                 name: Optional[str] = None):
        super().__init__(name)
        self.shape = tuple(shape)  # per-sample shape (no batch dim)
        self.dtype = dtype

    def __call__(self):
        # one symbolic node per Input layer, so Model(inputs=the_layer, ...)
        # and the DAG built from the_layer() agree on node identity
        if self._node is None:
            self._node = KTensor(self, [])
        return self._node


def InputTensor(shape, dtype="float32", name=None):
    """keras.Input equivalent: returns the symbolic tensor directly."""
    return Input(shape, dtype, name)()


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias=True,
                 kernel_initializer=None, bias_initializer=None,
                 name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer

    def lower(self, model, xs):
        return model.dense(xs[0], self.units, activation=self.activation,
                           use_bias=self.use_bias,
                           kernel_initializer=self.kernel_initializer,
                           bias_initializer=self.bias_initializer,
                           name=self.name)


class Flatten(Layer):
    def lower(self, model, xs):
        return model.flat(xs[0], name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def lower(self, model, xs):
        return model.embedding(xs[0], self.input_dim, self.output_dim,
                               aggr="none", name=self.name)


class Activation(Layer):
    def __init__(self, fn: str, name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.fn = fn

    def lower(self, model, xs):
        if self.fn == "softmax":
            return model.softmax(xs[0], name=self.name)
        return model._unary(self.fn, xs[0], self.name)


class Dropout(Layer):
    def __init__(self, rate: float, name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.rate = rate

    def lower(self, model, xs):
        return model.dropout(xs[0], self.rate, name=self.name)


class Reshape(Layer):
    def __init__(self, target_shape, name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.target_shape = tuple(target_shape)

    def lower(self, model, xs):
        b = xs[0].shape[0]
        return model.reshape(xs[0], (b,) + self.target_shape, name=self.name)


class Conv2D(Layer):
    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, use_bias=True,
                 kernel_initializer=None, bias_initializer=None,
                 name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.filters = filters
        self.kernel = (kernel_size if isinstance(kernel_size, (tuple, list))
                       else (kernel_size, kernel_size))
        self.strides = (strides if isinstance(strides, (tuple, list))
                        else (strides, strides))
        self.padding = padding
        self.activation = activation
        self.use_bias = use_bias

    def lower(self, model, xs):
        kh, kw = self.kernel
        if self.padding == "same":
            ph, pw = kh // 2, kw // 2
        elif self.padding == "valid":
            ph = pw = 0
        else:
            ph, pw = self.padding
        return model.conv2d(xs[0], self.filters, kh, kw, self.strides[0],
                            self.strides[1], ph, pw,
                            activation=self.activation,
                            use_bias=self.use_bias,
                            kernel_initializer=self.kernel_initializer,
                            bias_initializer=self.bias_initializer,
                            name=self.name)


class _Pool2D(Layer):
    pool_type = "max"

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.pool = (pool_size if isinstance(pool_size, (tuple, list))
                     else (pool_size, pool_size))
        strides = strides or self.pool
        self.strides = (strides if isinstance(strides, (tuple, list))
                        else (strides, strides))
        self.padding = padding

    def lower(self, model, xs):
        kh, kw = self.pool
        if self.padding == "same":
            ph, pw = kh // 2, kw // 2
        elif self.padding == "valid":
            ph = pw = 0
        else:
            ph, pw = self.padding
        return model.pool2d(xs[0], kh, kw, self.strides[0], self.strides[1],
                            ph, pw, pool_type=self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    pool_type = "max"


class AveragePooling2D(_Pool2D):
    pool_type = "avg"


class BatchNormalization(Layer):
    def lower(self, model, xs):
        return model.batch_norm(xs[0], name=self.name)


class Concatenate(Layer):
    def __init__(self, axis: int = 1, name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def lower(self, model, xs):
        return model.concat(xs, self.axis, name=self.name)


class Add(Layer):
    def lower(self, model, xs):
        return model.add(xs[0], xs[1], name=self.name)


class Subtract(Layer):
    def lower(self, model, xs):
        return model.subtract(xs[0], xs[1], name=self.name)


class Multiply(Layer):
    def lower(self, model, xs):
        return model.multiply(xs[0], xs[1], name=self.name)


# --------------------------------------------------------------------- models

_OPTIMIZERS = {
    "sgd": lambda: SGDOptimizer(lr=0.01),
    "adam": lambda: AdamOptimizer(lr=0.001),
}

_LOSSES = {
    "categorical_crossentropy": "categorical_crossentropy",
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "mean_squared_error": "mean_squared_error",
    "mse": "mean_squared_error",
}


class BaseModel:
    """Shared compile/fit/evaluate (reference base_model.py:30-509)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.ffmodel: Optional[FFModel] = None
        self.state: Optional[TrainState] = None
        self._input_names: List[str] = []
        self.batch_size: Optional[int] = None
        # layer-protocol fields, present because a model can be nested as a
        # layer inside another model
        self._bindings: Dict[int, list] = {}
        self._sym = None
        self._build_gen: int = 0  # bumped per compile; invalidates stale ops
        self._emitted_layers: List[Layer] = []  # plain layers, per build

    # built by subclasses: populate self.ffmodel + self._input_names
    def _build(self, batch_size: int):
        raise NotImplementedError

    # ---- composition: a model is also a layer (reference nested examples:
    # func_cifar10_cnn_nested.py model2(model1(x)), seq_mnist_cnn_nested.py
    # Sequential().add(model1)) ----------------------------------------------
    def __call__(self, *inputs) -> "KTensor":
        return KTensor(self, _flatten_ktensors(inputs))

    def _claim(self, layer) -> list:
        """Bind ``layer`` to this model for the current build generation and
        return its [owner weakref, ops, gen] binding record.  Owners are
        held weakly and dead entries pruned, so binding a layer never pins
        discarded models (and their TrainStates) in memory."""
        for key in [k for k, (r, _, _) in layer._bindings.items()
                    if r() is None]:
            del layer._bindings[key]
        b = layer._bindings.get(id(self))
        if b is None or b[0]() is not self or b[2] != self._build_gen:
            b = [weakref.ref(self), [], self._build_gen]
            # pop-then-insert so a rebind (recompile) moves this owner to
            # the END of the dict: "most recently bound" resolution in
            # _built_op / _adopt_reused_layer_weights relies on insertion
            # order reflecting binding recency
            layer._bindings.pop(id(self), None)
            layer._bindings[id(self)] = b
        return b

    def _emit(self, layer, xs):
        """Lower one layer (or nested model) into self.ffmodel, recording
        the produced core Op on the layer for weight access."""
        b = self._claim(layer)
        if isinstance(layer, BaseModel):
            if b[1]:
                raise NotImplementedError(
                    "using the same nested model on multiple inputs "
                    "(weight sharing) is not supported — build a second "
                    "model instance instead")
            out = layer._lower_into(self, xs)
            b[1].append(_NESTED_MARKER)  # mark as lowered this build
            return out
        # re-lowering a layer WITH weights would silently create a second,
        # unshared weight set; stateless layers (Activation/Flatten/...)
        # can be reused freely — each use just emits a fresh op
        if any(o is not _NESTED_MARKER and o.param_specs() for o in b[1]):
            raise NotImplementedError(
                f"layer {layer.name or type(layer).__name__} was already "
                "used in this model — shared layers (one weighted layer "
                "called on multiple inputs) are not supported; create a "
                "new layer instance per call site")
        t = layer.lower(self.ffmodel, xs)
        op = getattr(t, "owner_op", None)
        if op is not None:
            b[1].append(op)
            if layer not in self._emitted_layers:
                self._emitted_layers.append(layer)
        return t

    def _lower_into(self, outer: "BaseModel", xs):
        """Replay this model's layers into ``outer``'s graph (nested use).
        Implemented by subclasses."""
        raise NotImplementedError

    def _input_signature_hint(self) -> Tuple[Tuple[int, ...], str]:
        """(per-sample shape, dtype) of this model's first input."""
        raise NotImplementedError

    # ---- symbolic accessors (reference base_model.py:67-97: model.input /
    # model.output / get_layer) ----------------------------------------------
    @property
    def input(self) -> List["KTensor"]:
        return self._symbolic()[0]

    @property
    def output(self) -> "KTensor":
        return self._symbolic()[1]

    def _symbolic(self):
        """(input KTensors, output KTensor) of this model's own DAG."""
        raise NotImplementedError

    def _keras_layers(self) -> List[Layer]:
        raise NotImplementedError

    def get_layer(self, name: Optional[str] = None,
                  index: Optional[int] = None) -> Layer:
        """reference base_model.py:90 — look up a layer by name or index."""
        layers = self._keras_layers()
        if name is not None:
            for l in layers:
                if getattr(l, "name", None) == name:
                    return l
            raise ValueError(f"no layer named {name!r}")
        if index is not None:
            return layers[index]
        raise ValueError("pass name= or index=")

    def compile(self, optimizer="sgd", loss="categorical_crossentropy",
                metrics=("accuracy",), batch_size: int = 32, *, device=None):
        if isinstance(optimizer, str):
            optimizer = _OPTIMIZERS[optimizer.lower()]()
        assert isinstance(optimizer, Optimizer)
        self.batch_size = batch_size
        self._build_gen += 1  # invalidates layer->op bindings of prior builds
        self._emitted_layers = []
        self._build(batch_size)
        # keras loss/metric marker objects carry their registry name
        loss = getattr(loss, "name", None) or loss
        metrics = tuple(getattr(m, "name", None) or m for m in metrics)
        loss = _LOSSES.get(loss, loss)
        self.ffmodel.compile(optimizer=optimizer, loss_type=loss,
                             metrics=tuple(metrics))
        self.state = self.ffmodel.init(device=device)
        self._adopt_reused_layer_weights()
        return self

    def _adopt_reused_layer_weights(self):
        """A layer object that already carries trained weights in another
        live model keeps them here, keras-style, instead of being silently
        re-initialized.  Covers every composition path — model(x) nesting,
        Sequential.add(model), and symbolic m.output/m.input reuse — because
        it keys on the layer objects actually lowered into this build.  Of
        several source models the most recently bound one wins (a parent
        that trained the layer was bound after the sub-model that first
        owned it)."""
        for layer in self._emitted_layers:
            mine = layer._bindings.get(id(self))
            if mine is None or mine[2] != self._build_gen:
                continue
            source = None
            for ref, ops, gen in layer._bindings.values():
                owner = ref()
                if (owner is None or owner is self or owner.state is None
                        or gen != owner._build_gen):
                    continue
                source = (owner, ops)
            if source is None:
                continue
            src_owner, src_ops = source
            s_real = [o for o in src_ops if o is not _NESTED_MARKER]
            d_real = [o for o in mine[1] if o is not _NESTED_MARKER]
            for s_op, d_op in zip(s_real, d_real):
                d_specs = {sp.param_name: sp for sp in d_op.param_specs()}
                for spec in s_op.param_specs():
                    dsp = d_specs.get(spec.param_name)
                    if dsp is None or tuple(dsp.shape) != tuple(spec.shape):
                        continue  # architectures diverged; keep fresh init
                    val = src_owner.ffmodel.get_weights(
                        src_owner.state, s_op.name, spec.param_name)
                    self.state = self.ffmodel.set_weights(
                        self.state, d_op.name, spec.param_name, val)

    def _as_input_dict(self, x) -> Dict[str, np.ndarray]:
        if isinstance(x, dict):
            return x
        if isinstance(x, (list, tuple)):
            assert len(x) == len(self._input_names)
            return dict(zip(self._input_names, x))
        return {self._input_names[0]: x}

    def fit(self, x, y, epochs: int = 1, verbose: bool = True,
            callbacks=None):
        """reference base_model.py:194 fit -> _train loop :367 (callback
        hooks included)."""
        inputs = self._as_input_dict(x)
        loader = ArrayDataLoader(inputs, np.asarray(y), self.batch_size)
        for cb in callbacks or []:
            cb.set_model(self)  # callbacks see the keras-level model
        try:
            self.state, thpt = self.ffmodel.fit(self.state, loader,
                                                epochs=epochs,
                                                verbose=verbose,
                                                callbacks=callbacks)
        except Exception:
            # keep the trained weights even when a verify callback raises
            if self.ffmodel._fit_state is not None:
                self.state = self.ffmodel._fit_state
            raise
        return thpt

    def set_learning_rate(self, lr: float):
        """Apply a new learning rate to the held training state (used by
        LearningRateScheduler outside a running fit)."""
        self.state = self.ffmodel.set_learning_rate(self.state, lr)

    def evaluate(self, x, y):
        inputs = self._as_input_dict(x)
        loader = ArrayDataLoader(inputs, np.asarray(y), self.batch_size)
        from ..metrics import MetricsAccumulator
        acc = MetricsAccumulator(self.ffmodel.metrics)
        losses = []
        for binputs, blabels in loader:
            mets = self.ffmodel.eval_step(self.state, binputs, blabels)
            losses.append(float(mets.pop("loss")))
            acc.update(mets)
        print(acc.report())
        return float(np.mean(losses))

    def predict(self, x):
        inputs = self._as_input_dict(x)
        return self.ffmodel.forward(self.state, inputs).cpu().numpy()

    def summary(self) -> str:
        if self.ffmodel is None:
            # pre-compile summary (reference prints sub-model summaries
            # before the composed model is compiled)
            lines = [f"Model: {self.name or type(self).__name__} "
                     "(not compiled)"]
            for l in self._keras_layers():
                lines.append(f"  {l.name or type(l).__name__}")
            return "\n".join(lines)
        lines = [f"Model: {self.name or type(self).__name__}"]
        for op in self.ffmodel.layers:
            lines.append(f"  {op.name:24s} {op.op_type:16s} "
                         f"out={op.outputs[0].shape}")
        return "\n".join(lines)


class Sequential(BaseModel):
    """reference keras/models/sequential API."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None, name=None):
        super().__init__(name)
        self._layers: List[Layer] = list(layers or [])

    def add(self, layer: Layer):
        self._layers.append(layer)
        self._sym = None  # invalidate cached symbolic chain

    def _split_input(self):
        assert self._layers, "Sequential model has no layers"
        first = self._layers[0]
        if isinstance(first, Input):
            return first, self._layers[1:]
        if isinstance(first, BaseModel):
            shape, dtype = first._input_signature_hint()
        else:
            # reference-style: first layer carries input_shape
            shape, dtype = first.input_shape, first.input_dtype
        assert shape is not None, (
            "Sequential model needs an Input layer or input_shape= on "
            "the first layer")
        return Input(shape, dtype), self._layers

    def _build(self, batch_size: int):
        inp, rest = self._split_input()
        self.ffmodel = FFModel(FFConfig(batch_size=batch_size))
        t = self.ffmodel.create_tensor((batch_size,) + inp.shape, inp.dtype,
                                       name=inp.name or "input")
        self._input_names = [t.name]
        for layer in rest:
            t = self._emit(layer, [t])

    def _lower_into(self, outer: BaseModel, xs):
        assert len(xs) == 1, (
            f"nested Sequential takes 1 input, got {len(xs)}")
        t = xs[0]
        _, rest = self._split_input()
        for layer in rest:
            t = outer._emit(layer, [t])
        return t

    def _input_signature_hint(self):
        inp, _ = self._split_input()
        return inp.shape, inp.dtype

    def _symbolic(self):
        if getattr(self, "_sym", None) is None:
            inp, rest = self._split_input()
            kt = inp()
            out = kt
            for layer in rest:
                out = layer(out)
            self._sym = ([kt], out)
        return self._sym

    def _keras_layers(self):
        return [l for l in self._layers if not isinstance(l, Input)]


class Model(BaseModel):
    """Functional model over KTensor DAG (reference model.py:54 BFS)."""

    def __init__(self, inputs, outputs, name=None):
        super().__init__(name)
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        # tolerate Input layer objects in place of their symbolic tensors
        self._inputs = [i() if isinstance(i, Input) else i for i in ins]
        self._outputs = (outputs if isinstance(outputs, (list, tuple))
                         else [outputs])

    def _build(self, batch_size: int):
        self.ffmodel = FFModel(FFConfig(batch_size=batch_size))
        lowered: Dict[int, object] = {}
        self._input_names = []

        # declared inputs first, so multi-input fit([x1, x2], y) binds
        # arrays to tensors in the user's declared order, not DAG-traversal
        # order (non-Input declared tensors — a model rooted at an
        # intermediate tensor — are left for visit() to lower upstream)
        for kt in self._inputs:
            if not isinstance(kt.layer, Input):
                continue
            t = self.ffmodel.create_tensor(
                (batch_size,) + kt.layer.shape, kt.layer.dtype,
                name=kt.layer.name)
            lowered[id(kt)] = t
            self._input_names.append(t.name)

        def visit(kt: KTensor):
            key = id(kt)
            if key in lowered:
                return lowered[key]
            if isinstance(kt.layer, Input):
                t = self.ffmodel.create_tensor(
                    (batch_size,) + kt.layer.shape, kt.layer.dtype,
                    name=kt.layer.name)
                self._input_names.append(t.name)
            else:
                xs = [visit(i) for i in kt.inputs]
                t = self._emit(kt.layer, xs)
            lowered[key] = t
            return t

        for out in self._outputs:
            visit(out)

    def _lower_into(self, outer: BaseModel, xs):
        assert len(xs) == len(self._inputs), (
            f"nested model takes {len(self._inputs)} inputs, got {len(xs)}")
        lowered = {id(kt): x for kt, x in zip(self._inputs, xs)}

        def visit(kt: KTensor):
            key = id(kt)
            if key in lowered:
                return lowered[key]
            assert not isinstance(kt.layer, Input), (
                "nested model input not bound")
            t = outer._emit(kt.layer, [visit(i) for i in kt.inputs])
            lowered[key] = t
            return t

        outs = [visit(o) for o in self._outputs]
        return outs[0] if len(outs) == 1 else outs

    def _input_signature_hint(self):
        return self._inputs[0].layer.shape, self._inputs[0].layer.dtype

    def _symbolic(self):
        ins = list(self._inputs)
        outs = self._outputs
        return ins, (outs[0] if len(outs) == 1 else outs)

    def _keras_layers(self):
        seen_nodes, seen_layers, order = set(), set(), []

        def visit(kt: KTensor):
            if id(kt) in seen_nodes:
                return
            seen_nodes.add(id(kt))
            for i in kt.inputs:
                visit(i)
            if not isinstance(kt.layer, Input) and id(kt.layer) not in seen_layers:
                seen_layers.add(id(kt.layer))
                order.append(kt.layer)

        for out in self._outputs:
            visit(out)
        return order


# ---------------------------------------------------------------- submodules
# keras-style namespaces (reference python/flexflow/keras/{callbacks,
# datasets, preprocessing, utils}) so user code reads the same:
#   keras.callbacks.LearningRateScheduler, keras.datasets.mnist.load_data,
#   keras.preprocessing.sequence.pad_sequences, keras.utils.to_categorical
import types as _types

from . import keras_callbacks as callbacks  # noqa: E402
from . import keras_datasets as datasets  # noqa: E402
from . import keras_utils as utils  # noqa: E402

preprocessing = _types.SimpleNamespace(
    sequence=_types.SimpleNamespace(pad_sequences=utils.pad_sequences),
    text=_types.SimpleNamespace(Tokenizer=utils.Tokenizer))
