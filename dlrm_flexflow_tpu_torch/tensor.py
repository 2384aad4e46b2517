"""Symbolic tensors of the graph-builder API.

Counterpart of ``dlrm_flexflow_tpu/tensor.py``: a tensor is metadata
(shape, dtype, the op that produced it); storage lives in the parameter
dictionaries and in the values ``FFModel`` computes.  Batch-first shapes.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

_counter = itertools.count()

DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}

_NUMPY = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.bool: np.bool_,
}


def as_dtype(dt) -> torch.dtype:
    if isinstance(dt, str):
        return DTYPES[dt]
    if isinstance(dt, torch.dtype):
        return dt
    raise TypeError(f"not a dtype: {dt!r}")


def numpy_dtype(dt: torch.dtype):
    """The numpy dtype a request array is coerced to for a model input."""
    return _NUMPY[dt]


@dataclass
class Tensor:
    """A node edge in the op graph; ``owner_op``/``owner_idx`` name the
    op output that produces it."""

    shape: Tuple[int, ...]
    dtype: object = torch.float32
    owner_op: Optional[object] = None
    owner_idx: int = 0
    name: Optional[str] = None
    uid: int = field(default_factory=lambda: next(_counter))

    def __post_init__(self):
        self.shape = tuple(int(d) for d in self.shape)
        self.dtype = as_dtype(self.dtype)
        if self.name is None:
            self.name = f"tensor_{self.uid}"

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def __hash__(self):
        return self.uid

    def __eq__(self, other):
        return isinstance(other, Tensor) and other.uid == self.uid

    def __repr__(self):
        return f"Tensor({self.name}, shape={self.shape}, dtype={self.dtype})"


@dataclass
class ParameterSpec:
    """Weight metadata, keyed by ``(op_name, param_name)`` in the params
    dictionary; ``sharded_dim`` is the dim a tensor-parallel strategy
    splits over the mesh's "model" axis (the out-channel of a Linear
    weight, the table axis of stacked tables), as in the JAX package."""

    op_name: str
    param_name: str
    shape: Tuple[int, ...]
    dtype: object = torch.float32
    initializer: Optional[object] = None
    sharded_dim: Optional[int] = None

    def __post_init__(self):
        self.shape = tuple(int(d) for d in self.shape)
        self.dtype = as_dtype(self.dtype)
