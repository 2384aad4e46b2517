"""Elementwise unary and binary operators (counterparts of
``dlrm_flexflow_tpu/ops/elementwise.py``; reference
src/ops/element_unary.cu and element_binary.cu).

Each is one ATen pointwise call (a CUDA kernel of PyTorch's on the card),
as the JAX package leaves them to XLA; autograd gives the backward.  A
scalar division divides by a 0-dim tensor, a true division on every
device, as XLA divides (ATen turns a CUDA tensor divided by a Python
number into a multiply by the reciprocal).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import Op, rect_of_part


def _identity(x):
    return x


_UNARY = {
    "exp": torch.exp,
    "log": torch.log,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": _identity,
    "rsqrt": torch.rsqrt,
    "sqrt": torch.sqrt,
    "negative": torch.negative,
}

_SCALAR = ("scalar_add", "scalar_sub", "scalar_mul", "scalar_truediv",
           "pow")

_BINARY = {
    "add": torch.add,
    "sub": torch.subtract,
    "subtract": torch.subtract,
    "mul": torch.multiply,
    "multiply": torch.multiply,
    "div": torch.divide,
    "divide": torch.divide,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _scalar(x, value):
    """``value`` as a 0-dim tensor of ``x``'s dtype on its device."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


class ElementUnary(Op):
    """Unary pointwise op; ``scalar`` parameterises the scalar forms
    (``scalar_add``, ``scalar_sub``, ``scalar_mul``, ``scalar_truediv``)
    and ``pow``'s exponent."""

    op_type = "ElementUnary"

    def __init__(self, name, input_tensor, fn: str, scalar: float = None,
                 inplace: bool = True):
        super().__init__(name, [input_tensor])
        if fn not in _UNARY and fn not in _SCALAR:
            raise ValueError(f"unknown unary fn {fn!r}")
        self.fn = fn
        self.scalar = scalar
        self.outputs = [self._make_output(input_tensor.shape,
                                          input_tensor.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        (x,) = xs
        if self.fn == "scalar_add":
            return [x + self.scalar]
        if self.fn == "scalar_sub":
            return [x - self.scalar]
        if self.fn == "scalar_mul":
            return [x * self.scalar]
        if self.fn == "scalar_truediv":
            return [x / _scalar(x, self.scalar)]
        if self.fn == "pow":
            return [torch.pow(x, self.scalar)]
        return [_UNARY[self.fn](x)]

    def input_rect(self, pc, input_idx, part_idx):
        """Pointwise: each part reads exactly its own rectangle."""
        return rect_of_part(pc, self.inputs[0].shape, part_idx)


class ElementBinary(Op):
    """Binary pointwise op, with NumPy broadcasting as in the JAX
    package (the reference requires equal shapes)."""

    op_type = "ElementBinary"

    def __init__(self, name, a, b, fn: str):
        super().__init__(name, [a, b])
        if fn not in _BINARY:
            raise ValueError(f"unknown binary fn {fn!r}")
        self.fn = fn
        out_shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
        self.outputs = [self._make_output(out_shape, a.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        a, b = xs
        return [_BINARY[self.fn](a, b)]

    def input_rect(self, pc, input_idx, part_idx):
        """Same-shape elementwise: each part reads its own rectangle of
        the input (a broadcast input takes the default batch rule)."""
        if self.inputs[input_idx].shape != self.outputs[0].shape:
            return super().input_rect(pc, input_idx, part_idx)
        return rect_of_part(pc, self.inputs[input_idx].shape, part_idx)
