"""Weights from the JAX package to the port.

The JAX package keeps parameters as ``{op: {param: array}}``; the port
uses the same names, shapes and layouts (a Linear kernel stays
``(in, out)``, an embedding table ``(R_total, d)``), so the bridge only
changes the container.  On the JAX side, take host copies with
``jax.tree.map(np.asarray, state.params)``; then

    state = model.load_params(params_from_jax(np_params), device=...,
                              opt_state=opt_state_from_jax(np_opt_state))

installs them, and the SGD state (``jax.tree.map(np.asarray,
state.opt_state)``), on the port model's device.  Stacked ``(T, R, d)``
tables and per-table ``(R, d)`` tables cross like any other parameter.
This module imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(name, value) -> torch.Tensor:
    arr = np.array(value)  # a copy: JAX host arrays are read-only
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"{name}: unsupported dtype {arr.dtype}")
    return torch.from_numpy(arr)


def params_from_jax(np_params: Mapping[str, Mapping[str, object]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{op: {param: numpy array}}`` -> ``{op: {param: CPU tensor}}``
    with identical names, shapes, dtypes and values (each array is
    copied, so the result owns its memory)."""
    return {op_name: {pname: _tensor(f"{op_name}/{pname}", value)
                      for pname, value in params.items()}
            for op_name, params in np_params.items()}


def opt_state_from_jax(np_opt_state: Mapping[str, object]) -> Dict[str, object]:
    """The JAX package's SGD state ``{"step", "lr"[, "v": {op: {param:
    array}}]}`` as host arrays -> the same tree of CPU tensors (``step``
    int32 and ``lr`` f32 0-dim, the momentum buffers f32)."""
    unknown = set(np_opt_state) - {"step", "lr", "v"}
    if unknown:
        raise KeyError(f"not an SGD optimizer state: {sorted(unknown)}")
    out: Dict[str, object] = {k: _tensor(k, np_opt_state[k])
                              for k in ("step", "lr") if k in np_opt_state}
    if "v" in np_opt_state:
        out["v"] = params_from_jax(np_opt_state["v"])
    return out
