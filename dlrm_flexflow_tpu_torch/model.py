"""FFModel: the graph builder and its forward (serving subset).

Counterpart of ``dlrm_flexflow_tpu/model.py``.  The graph is a list of
ops built by the reference's factory API; ``compile`` builds the forward
and ``init`` or ``load_params`` places the parameters on a device.
PyTorch runs eagerly, so there is no jit: the forward is one Python
sweep over the ops.  No op bakes in the batch size, so one graph serves
every serving bucket.

Training (losses, optimizers, ``train_step``/``fit``) comes with slice 2
in ROADMAP.md; a mesh comes with the scale-out slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import FFConfig
from .device import resolve_device
from .initializers import derive_seed
from .ops import FusedEmbedInteract, Linear, Op
from .tensor import Tensor, as_dtype, numpy_dtype

_TRAINING = ("training is not ported yet: it comes with slice 2, the "
             "training main path, in ROADMAP.md")


@dataclass
class TrainState:
    """Parameters ``{op: {param: tensor}}`` on one device.  The optimizer
    state and step arrive with the training slice."""

    params: Dict[str, Dict[str, torch.Tensor]]


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

    def compile(self, optimizer=None, loss_type="mean_squared_error",
                metrics=("accuracy",), mesh=None):
        """Build the forward.  ``mesh`` may be None or False (one device);
        a mesh comes with the scale-out slice in ROADMAP.md.  The
        optimizer, loss and metrics are accepted for the reference's call
        signature and unused until the training slice."""
        if mesh not in (None, False):
            raise NotImplementedError(
                "a device mesh is not ported yet: it comes with the "
                "scale-out slice in ROADMAP.md")
        act = getattr(self.config, "activation_dtype", "float32")
        if act != "float32":
            raise NotImplementedError(
                f"activation_dtype={act!r} is not ported yet (float32 only)")
        out = self.final_tensor
        final_uid, final_dtype = out.uid, out.dtype

        def forward(params, inputs):
            with torch.inference_mode():
                return self._apply(params, inputs)[final_uid].to(final_dtype)

        self._forward_fn = forward
        return self

    # ------------------------------------------------------------ parameters
    def init(self, seed: Optional[int] = None, device=None) -> TrainState:
        """Draw every op's parameters on ``device`` (default: the CUDA
        card; raises without one) from generators seeded by ``seed`` and
        the op's position."""
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
        return TrainState(params)

    def load_params(self, params, device=None) -> TrainState:
        """Install ``{op: {param: array or tensor}}`` (for example
        ``bridge.params_from_jax`` of a JAX model's params) on ``device``
        (default: this model's device, else the CUDA card).  Names, shapes
        and dtypes must match the graph's parameter specs exactly."""
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
        return TrainState(out)

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
        return TrainState(params)

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
    def train_step(self, state, inputs, labels):
        raise NotImplementedError(_TRAINING)

    def train_epoch(self, state, inputs, labels):
        raise NotImplementedError(_TRAINING)

    def fit(self, state, dataloader, epochs=None):
        raise NotImplementedError(_TRAINING)
