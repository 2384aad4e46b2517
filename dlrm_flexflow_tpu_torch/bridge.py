"""Weights from the JAX package to the port.

The JAX package keeps parameters as ``{op: {param: array}}``; the port
uses the same names, shapes and layouts (a Linear kernel stays
``(in, out)``, an embedding table ``(R_total, d)``), so the bridge only
changes the container.  On the JAX side, take host copies with
``jax.tree.map(np.asarray, state.params)``; then

    state = model.load_params(params_from_jax(np_params), device=...)

installs them on the port model's device.  This module imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(np_params: Mapping[str, Mapping[str, object]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{op: {param: numpy array}}`` -> ``{op: {param: CPU tensor}}``
    with identical names, shapes, dtypes and values (each array is
    copied, so the result owns its memory)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for op_name, params in np_params.items():
        out[op_name] = {}
        for pname, value in params.items():
            arr = np.array(value)  # a copy: JAX host arrays are read-only
            if arr.dtype.kind not in "fiub":
                raise TypeError(f"{op_name}/{pname}: unsupported dtype "
                                f"{arr.dtype}")
            out[op_name][pname] = torch.from_numpy(arr)
    return out
