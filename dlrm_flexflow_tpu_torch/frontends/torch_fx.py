"""PyTorch frontend: torch.fx symbolic trace -> FFModel graph (counterpart
of ``dlrm_flexflow_tpu/frontends/torch_fx.py``, the same lowering and op
names).

The reference torch frontend (reference: python/flexflow/torch/fx.py:44-198 — symbolic_trace the module,
serialize node list, replay module/function calls as FFModel ops;
python/flexflow/torch/model.py:18-149 PyTorchModel.apply).

Unlike the reference (which round-trips through a text file), the fx
graph is lowered directly and the torch weights are imported into the
TrainState, so converted models agree numerically with the source module.
The port's parameters are torch tensors already: ``import_weights`` hands
the module's tensors (transposed or permuted views) to ``set_weights``,
on whatever device either side lives, with no numpy copy.
"""

from __future__ import annotations

import operator
from typing import Dict, Optional

import torch
import torch.fx
import torch.nn as nn
import torch.nn.functional as F

from ..config import FFConfig
from ..model import FFModel, TrainState


class PyTorchModel:
    """Convert a ``torch.nn.Module`` to an FFModel (reference fx.py:68)."""

    def __init__(self, module):
        self.module = module
        self.graph = torch.fx.symbolic_trace(module).graph

    # ------------------------------------------------------------------ apply
    def apply(self, ffconfig: FFConfig, input_shapes: Dict[str, tuple],
              dtypes: Optional[Dict[str, str]] = None) -> FFModel:
        """Build the FFModel graph.  ``input_shapes`` maps placeholder name
        -> per-sample shape (batch prepended automatically)."""
        model = FFModel(ffconfig)
        b = ffconfig.batch_size
        bound: Dict[str, object] = {}
        for node in self.graph.nodes:
            if node.op == "placeholder":
                shape = input_shapes[node.name]
                dt = (dtypes or {}).get(node.name, "float32")
                bound[node.name] = model.create_tensor(
                    (b,) + tuple(shape), dt, name=node.name)
        self.lower_onto(model, bound)
        return model

    def placeholder_names(self):
        return [n.name for n in self.graph.nodes if n.op == "placeholder"]

    def lower_onto(self, model: FFModel, bound_inputs: Dict[str, object]):
        """Replay the fx graph onto an existing model, with placeholders
        pre-bound to core tensors (the reference's PyTorchModel.apply
        replays its op list onto a user-supplied ffmodel the same way,
        torch/model.py:18-149).  Returns the output tensors."""
        env: Dict[str, object] = dict(bound_inputs)
        mods = dict(self.module.named_modules())
        self._name_of: Dict[str, str] = {}  # fx node -> op name
        outputs = []

        def as_tensor(a):
            return env[a.name] if hasattr(a, "name") else a

        for node in self.graph.nodes:
            if node.op == "placeholder":
                assert node.name in env, (
                    f"placeholder {node.name!r} not bound; have "
                    f"{sorted(bound_inputs)}")
            elif node.op == "call_module":
                m = mods[node.target]
                x = as_tensor(node.args[0])
                env[node.name] = self._lower_module(model, m, x, node)
            elif node.op == "call_function" or node.op == "call_method":
                env[node.name] = self._lower_function(model, node, as_tensor)
            elif node.op == "output":
                arg = node.args[0]
                args = arg if isinstance(arg, (tuple, list)) else [arg]
                outputs = [as_tensor(x) for x in args]
                env[node.name] = outputs[0]
            elif node.op == "get_attr":
                raise NotImplementedError(
                    f"get_attr {node.target} not supported")
        return outputs

    # ---------------------------------------------------------------- modules
    def _lower_module(self, model: FFModel, m, x, node):
        name = node.target.replace(".", "_")
        self._name_of[node.name] = name
        if isinstance(m, nn.Linear):
            return model.dense(x, m.out_features, use_bias=m.bias is not None,
                               name=name)
        if isinstance(m, nn.Conv2d):
            return model.conv2d(x, m.out_channels, m.kernel_size[0],
                                m.kernel_size[1], m.stride[0], m.stride[1],
                                m.padding[0], m.padding[1],
                                use_bias=m.bias is not None,
                                groups=m.groups, name=name)
        if isinstance(m, nn.MaxPool2d):
            k = m.kernel_size if isinstance(m.kernel_size, tuple) else \
                (m.kernel_size, m.kernel_size)
            s = m.stride if isinstance(m.stride, tuple) else \
                (m.stride, m.stride)
            p = m.padding if isinstance(m.padding, tuple) else \
                (m.padding, m.padding)
            return model.pool2d(x, k[0], k[1], s[0], s[1], p[0], p[1],
                                name=name)
        if isinstance(m, nn.AvgPool2d):
            k = m.kernel_size if isinstance(m.kernel_size, tuple) else \
                (m.kernel_size, m.kernel_size)
            s = m.stride if isinstance(m.stride, tuple) else \
                (m.stride, m.stride)
            p = m.padding if isinstance(m.padding, tuple) else \
                (m.padding, m.padding)
            return model.pool2d(x, k[0], k[1], s[0], s[1], p[0], p[1],
                                pool_type="avg", name=name)
        if isinstance(m, nn.BatchNorm2d):
            return model.batch_norm(x, name=name)
        if isinstance(m, nn.Dropout):
            return model.dropout(x, m.p, name=name)
        if isinstance(m, nn.Embedding):
            return model.embedding(x, m.num_embeddings, m.embedding_dim,
                                   aggr="none", name=name)
        if isinstance(m, nn.Flatten):
            return model.flat(x, name=name)
        if isinstance(m, nn.ReLU):
            return model.relu(x, name=name)
        if isinstance(m, nn.Sigmoid):
            return model.sigmoid(x, name=name)
        if isinstance(m, nn.Tanh):
            return model.tanh(x, name=name)
        if isinstance(m, nn.GELU):
            return model.gelu(x, name=name)
        if isinstance(m, nn.Softmax):
            return model.softmax(x, name=name)
        if isinstance(m, nn.Identity):
            return x
        raise NotImplementedError(f"torch module {type(m).__name__}")

    # -------------------------------------------------------------- functions
    def _lower_function(self, model: FFModel, node, as_tensor):
        t = node.target
        a = [as_tensor(x) for x in node.args
             if not isinstance(x, (int, float, tuple, list, type(None)))]
        if t in (operator.add, torch.add, "add"):
            return model.add(a[0], a[1])
        if t in (operator.sub, torch.sub, "sub"):
            return model.subtract(a[0], a[1])
        if t in (operator.mul, torch.mul, "mul"):
            return model.multiply(a[0], a[1])
        if t in (operator.truediv, torch.div, "div"):
            return model.divide(a[0], a[1])
        if t in (F.relu, torch.relu, "relu"):
            return model.relu(a[0])
        if t in (torch.sigmoid, F.sigmoid, "sigmoid"):
            return model.sigmoid(a[0])
        if t in (torch.tanh, F.tanh, "tanh"):
            return model.tanh(a[0])
        if t in (F.softmax, torch.softmax, "softmax"):
            return model.softmax(a[0])
        if t in (torch.cat, "cat"):
            tensors = node.args[0]
            dim = node.kwargs.get("dim", node.args[1]
                                  if len(node.args) > 1 else 0)
            return model.concat([as_tensor(x) for x in tensors], dim)
        if t in (torch.flatten, "flatten"):
            return model.flat(a[0])
        if t in ("view", "reshape", torch.reshape):
            shape = [s if isinstance(s, int) else -1
                     for s in node.args[1:]]
            if len(shape) == 1 and isinstance(node.args[1], (tuple, list)):
                shape = list(node.args[1])
            b = a[0].shape[0]
            if shape and shape[0] == -1:
                shape[0] = b
            return model.reshape(a[0], shape)
        if t in (torch.transpose, "transpose"):
            return model.transpose(a[0])
        raise NotImplementedError(f"torch function {t}")

    # ---------------------------------------------------------------- weights
    def import_weights(self, model: FFModel, state: TrainState) -> TrainState:
        """Copy torch parameters into the TrainState (the reference's
        Parameter::set_weights path, model.py:18-149)."""
        mods = dict(self.module.named_modules())
        for tname, m in mods.items():
            name = tname.replace(".", "_")
            if name not in state.params:
                continue
            if isinstance(m, nn.Linear):
                state = model.set_weights(state, name, "kernel",
                                          m.weight.detach().t())
                if m.bias is not None:
                    state = model.set_weights(state, name, "bias", m.bias)
            elif isinstance(m, nn.Conv2d):
                # OIHW -> HWIO
                state = model.set_weights(state, name, "kernel",
                                          m.weight.detach().permute(
                                              2, 3, 1, 0))
                if m.bias is not None:
                    state = model.set_weights(state, name, "bias", m.bias)
            elif isinstance(m, nn.Embedding):
                state = model.set_weights(state, name, "embedding",
                                          m.weight)
            elif isinstance(m, nn.BatchNorm2d):
                state = model.set_weights(state, name, "scale", m.weight)
                state = model.set_weights(state, name, "bias", m.bias)
        return state
