"""Dense / Linear operator (counterpart of ``dlrm_flexflow_tpu/ops/linear.py``).

The weight keeps the JAX package's ``(in, out)`` layout, so parameters
cross between the packages unchanged.  The matmul is a plain
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves it to
XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

from ..initializers import DEFAULT_BIAS_INIT, DEFAULT_KERNEL_INIT
from ..tensor import ParameterSpec
from .base import Op, activation_fn, matmul


class Linear(Op):
    op_type = "Dense"

    def __init__(self, name, input_tensor, out_dim: int,
                 activation: Optional[str] = None, use_bias: bool = True,
                 kernel_initializer=None, bias_initializer=None,
                 compute_dtype=None):
        super().__init__(name, [input_tensor])
        if len(input_tensor.shape) < 2:
            raise ValueError("Linear expects (batch, ..., in_dim)")
        self.in_dim = input_tensor.shape[-1]
        self.out_dim = int(out_dim)
        self.activation = activation
        self._act = activation_fn(activation)
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer or DEFAULT_KERNEL_INIT
        self.bias_initializer = bias_initializer or DEFAULT_BIAS_INIT
        self.compute_dtype = compute_dtype
        out_shape = tuple(input_tensor.shape[:-1]) + (self.out_dim,)
        self.outputs = [self._make_output(out_shape, input_tensor.dtype)]

    def param_specs(self):
        specs = [ParameterSpec(self.name, "kernel", (self.in_dim, self.out_dim),
                               initializer=self.kernel_initializer)]
        if self.use_bias:
            specs.append(ParameterSpec(self.name, "bias", (self.out_dim,),
                                       initializer=self.bias_initializer))
        return specs

    def forward(self, params, xs):
        (x,) = xs
        y = matmul(x, params["kernel"], self.compute_dtype)
        if self.use_bias:
            y = y + params["bias"]
        # The activation runs in f64 and rounds once, like the matmul: on
        # the CPU, ATen computes the full vectors of a tensor with the
        # vectorized op and the tail with the scalar op, which differ in
        # the last bit for sigmoid, so an f32 result would depend on the
        # row's position in the batch.
        return [self._act(y.double()).to(self.outputs[0].dtype)]

    def flops(self, batch):
        rows = batch
        for d in self.inputs[0].shape[1:-1]:
            rows *= d
        return 2 * rows * self.in_dim * self.out_dim
