"""Weights from the JAX package to the port.

The JAX package keeps parameters as ``{op: {param: array}}``; the port
uses the same names, shapes and layouts (a Linear kernel stays
``(in, out)``, an embedding table ``(R_total, d)``), so the bridge only
changes the container.  On the JAX side, take host copies with
``jax.tree.map(np.asarray, state.params)``; then

    state = model.load_params(params_from_jax(np_params), device=...,
                              opt_state=opt_state_from_jax(np_opt_state))

installs them, and the optimizer state (``jax.tree.map(np.asarray,
state.opt_state)``, SGD's or Adam's), on the port model's device.
Stacked ``(T, R, d)`` tables and per-table ``(R, d)`` tables cross like
any other parameter.

bf16 tables arrive as numpy arrays of ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` does not take: they cross bit for bit as their
``uint16`` view.  ``params_to_numpy`` is the way back (the tests feed its
arrays to ``jnp.asarray``).

A hetero model's host tables (the JAX ``op.host_table.array`` of each
CPU-placed op) are outside its state: ``host_tables_from_jax(jax_model)``
copies them, keyed by op name, and ``load_params(...,
host_tables=...)`` installs them in the port model's host-placed ops.

A whole training state crosses the same way: ``state_from_jax`` takes a
JAX ``TrainState`` (or any object with its five fields, leaves anything
``np.asarray`` reads) and returns the port's :class:`TrainState` of CPU
tensors, ``state_to_numpy`` gives the five fields back as host arrays.
The npz checkpoints (``checkpoint.py``) are the other way across.  This
module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .model import TrainState


def _tensor(name, value) -> torch.Tensor:
    arr = np.array(value)  # a copy: JAX host arrays are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"{name}: unsupported dtype {arr.dtype}")
    return torch.from_numpy(arr)


def _array(t: torch.Tensor) -> np.ndarray:
    """A host copy; a tensor sharded over a mesh is gathered first (the
    global value, on every rank: a collective)."""
    from .parallel.spmd import global_param
    t = global_param(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the JAX package's bf16 numpy dtype
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Mapping[str, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """``{op: {param: tensor}}`` -> ``{op: {param: numpy array}}`` on the
    host, bf16 as ``ml_dtypes.bfloat16`` bit for bit: the reverse of
    ``params_from_jax``.  A parameter sharded over a mesh is returned
    whole (gathered); ``FFModel.load_params`` takes the global arrays of
    ``params_from_jax`` and keeps each rank's blocks."""
    return {op_name: {pname: _array(v) for pname, v in p.items()}
            for op_name, p in params.items()}


def params_from_jax(np_params: Mapping[str, Mapping[str, object]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{op: {param: numpy array}}`` -> ``{op: {param: CPU tensor}}``
    with identical names, shapes, dtypes and values (each array is
    copied, so the result owns its memory)."""
    return {op_name: {pname: _tensor(f"{op_name}/{pname}", value)
                      for pname, value in params.items()}
            for op_name, params in np_params.items()}


def host_tables_from_jax(jax_model) -> Dict[str, np.ndarray]:
    """A JAX hetero model's host tables, ``{op name: f32 (R, d) array}``
    (copies of each CPU-placed op's ``host_table.array``), for
    ``FFModel.load_params(..., host_tables=)``; ``{}`` for a model
    without host tables."""
    return {op.name: np.array(op.host_table.array, dtype=np.float32)
            for op in getattr(jax_model, "_hetero_ops", [])
            if getattr(op, "host_table", None) is not None}


def opt_state_from_jax(np_opt_state: Mapping[str, object]) -> Dict[str, object]:
    """The JAX package's SGD or Adam state ``{"step", "lr"[, "m"][, "v"]}``
    (slots ``{op: {param: array}}``) as host arrays -> the same tree of
    CPU tensors, keys in the input's order (``step`` int32 and ``lr`` f32
    0-dim, the slots f32)."""
    unknown = set(np_opt_state) - {"step", "lr", "m", "v"}
    if unknown:
        raise KeyError(f"not an SGD or Adam optimizer state: "
                       f"{sorted(unknown)}")
    return {k: (params_from_jax(v) if k in ("m", "v") else _tensor(k, v))
            for k, v in np_opt_state.items()}


def _tree(fn, tree, name=""):
    if isinstance(tree, Mapping):
        return {k: _tree(fn, v, f"{name}/{k}") for k, v in tree.items()}
    return fn(name, tree)


def state_from_jax(jax_state) -> TrainState:
    """A JAX ``TrainState`` (fields ``params, opt_state, bn_state, rng,
    step``; leaves JAX or numpy arrays) -> the port's :class:`TrainState`
    of CPU tensors with the same names, dtypes and values (bf16 bit for
    bit, the key as uint32).  Place it with ``model.load_params(
    state.params, device=..., opt_state=state.opt_state)`` or move its
    tensors yourself."""
    def conv(name, leaf):
        return None if leaf is None else _tensor(name, leaf)
    return TrainState(_tree(conv, jax_state.params, "params"),
                      _tree(conv, jax_state.opt_state, "opt_state"),
                      _tree(conv, jax_state.bn_state or {}, "bn_state"),
                      conv("rng", jax_state.rng), conv("step", jax_state.step))


def state_to_numpy(state: TrainState) -> Dict[str, Any]:
    """The five fields of a port :class:`TrainState` as host numpy trees,
    in the JAX package's field order (``params``, ``opt_state``,
    ``bn_state``, ``rng``, ``step``), bf16 as ``ml_dtypes.bfloat16``:
    ``TrainState(*(jax.tree.map(jnp.asarray, v) for v in
    state_to_numpy(s).values()))`` is the JAX state."""
    def conv(_name, leaf):
        return _array(leaf) if isinstance(leaf, torch.Tensor) else leaf
    return {"params": _tree(conv, state.params),
            "opt_state": _tree(conv, state.opt_state),
            "bn_state": _tree(conv, state.bn_state or {}),
            "rng": conv("rng", state.rng),
            "step": conv("step", state.step)}
