"""Conv2D, Pool2D and BatchNorm (counterparts of
``dlrm_flexflow_tpu/ops/conv.py``; reference src/ops/conv_2d.cu,
pool_2d.cu, batch_norm.cu).

Activations are NCHW, as in the reference's factories.  The convolution
kernel keeps the JAX package's HWIO layout in the parameters, so
checkpoints and the bridge carry it unchanged, and is turned to OIHW
only inside ``Conv2D.forward``.  Convolution and pooling are cuDNN's and
ATen's on the card (the dense math the JAX package leaves to XLA).

Under f32 compute a convolution is a full f32 convolution, as
``lax.conv_general_dilated`` with an f32 result is: TF32, on by default
for cuDNN convolutions, would round the operands to 10 mantissa bits.
``_Conv2dFn`` runs the forward and its backward with TF32 off and with
deterministic cuDNN algorithms (a graphed step must equal the eager one
bit for bit), under ``torch.backends.cudnn.flags`` around those two calls
only, so no setting changes for code outside the op.  Under bf16 compute
both operands are rounded to bf16 and the bf16 result is widened to f32,
as the JAX op does, unless the output is declared bf16 (activation
storage, ``FFConfig.activation_dtype``): then the bias and activation run
in bf16.  Under bf16 storage batch norm keeps f32 statistics and applies
them in bf16, and average pooling sums in f32.

The max-pool backward routes a tied window's gradient to one element
(ATen's, the first maximum), which is ``select_and_scatter``'s rule, the
JAX op's default.  ``F.max_pool2d`` and ``F.avg_pool2d`` refuse a pad
above half the kernel, which ``reduce_window`` takes; such a pool pads
explicitly (-inf for max, 0 for avg) and pools unpadded.

Under a mesh, an attribute (H/W) partition of a convolution or a pool
runs as the mesh executor's generic op (``parallel/spmd.py``): the
kernel gathered over "model", whole images of the rank's batch shard,
then the rank's tile of the output kept; JAX's values.  A halo exchange,
which would compute only the tile, is later speed work (ROADMAP item
1).  Batch norm under a mesh computes its statistics over the whole
batch, as the one-device op does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..initializers import (DEFAULT_BIAS_INIT, DEFAULT_KERNEL_INIT,
                            ConstantInitializer)
from ..tensor import ParameterSpec
from .base import Op, activation_fn, rect_of_part


def _out_dim(size, kernel, stride, pad):
    return (size + 2 * pad - kernel) // stride + 1


def _exact_cudnn():
    """cuDNN without TF32 and with deterministic algorithms, for the
    duration of one convolution call."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=False,
        deterministic=True, allow_tf32=False)


class _Conv2dFn(torch.autograd.Function):
    """``aten.convolution`` and its backward, each under
    ``_exact_cudnn``: the backward runs when autograd reaches it, outside
    the forward's scope, so it sets the flags itself."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        with _exact_cudnn():
            return torch.ops.aten.convolution(
                x, w, None, list(stride), list(padding), [1, 1], False,
                [0, 0], groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        with _exact_cudnn():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, None, list(stride), list(padding),
                [1, 1], False, [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None


class Conv2D(Op):
    op_type = "Conv2D"

    def __init__(self, name, input_tensor, out_channels: int,
                 kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                 padding_h: int, padding_w: int,
                 activation: Optional[str] = None, use_bias: bool = True,
                 groups: int = 1, kernel_initializer=None,
                 bias_initializer=None, compute_dtype=None):
        super().__init__(name, [input_tensor])
        n, c, h, w = input_tensor.shape
        if c % groups or int(out_channels) % groups:
            raise ValueError(f"{name}: channels {c} -> {out_channels} do "
                             f"not divide into {groups} groups")
        self.in_channels = c
        self.out_channels = int(out_channels)
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.groups = groups
        self.activation = activation
        self._act = activation_fn(activation)
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer or DEFAULT_KERNEL_INIT
        self.bias_initializer = bias_initializer or DEFAULT_BIAS_INIT
        self.compute_dtype = compute_dtype
        oh = _out_dim(h, kernel_h, stride_h, padding_h)
        ow = _out_dim(w, kernel_w, stride_w, padding_w)
        self.outputs = [self._make_output((n, self.out_channels, oh, ow),
                                          input_tensor.dtype)]

    def param_specs(self):
        kh, kw = self.kernel
        # HWIO, the JAX package's layout
        specs = [ParameterSpec(self.name, "kernel",
                               (kh, kw, self.in_channels // self.groups,
                                self.out_channels),
                               initializer=self.kernel_initializer,
                               sharded_dim=3)]
        if self.use_bias:
            specs.append(ParameterSpec(self.name, "bias",
                                       (self.out_channels,),
                                       initializer=self.bias_initializer,
                                       sharded_dim=0))
        return specs

    def forward(self, params, xs, *, training=False, rng=None):
        (x,) = xs
        k = params["kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        mixed = self.compute_dtype in ("bfloat16", torch.bfloat16)
        if mixed:
            x, k = x.to(torch.bfloat16), k.to(torch.bfloat16)
        y = _Conv2dFn.apply(x.contiguous(), k.contiguous(), self.stride,
                            self.padding, self.groups)
        out_dtype = self.outputs[0].dtype
        # under bf16 compute with a bf16 output (bf16 activation storage)
        # the bias and the activation run in bf16, as the JAX op's
        # epilogue does; otherwise the result is widened first
        if not (mixed and out_dtype == torch.bfloat16):
            y = y.float()
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)[None, :, None, None]
        return [self._act(y).to(out_dtype)]

    def flops(self, batch):
        _, co, oh, ow = self.outputs[0].shape
        kh, kw = self.kernel
        return (2 * batch * co * oh * ow * kh * kw * self.in_channels
                // self.groups)

    def input_rect(self, pc, input_idx, part_idx):
        """Spatial parts read kernel halos; a conv part reads every input
        channel."""
        return _spatial_input_rect(self, pc, part_idx,
                                   channels_map_through=False)


def _spatial_input_rect(op, pc, part_idx, channels_map_through):
    """The (N, C, H, W) input rectangle of one output part: the batch maps
    through; channels map through for pooling (depthwise) and are read
    in full by a convolution; H and W extend by the kernel's footprint,
    clipped to the input (reference conv_2d.cu partitions)."""
    lo, hi = rect_of_part(pc, op.outputs[0].shape, part_idx)
    ishape = op.inputs[0].shape
    if channels_map_through:
        clo, chi = lo[1], hi[1]
    else:
        clo, chi = 0, ishape[1]
    kh, kw = op.kernel
    sh, sw = op.stride
    ph, pw = op.padding
    return ((lo[0], clo,
             max(lo[2] * sh - ph, 0),
             max(lo[3] * sw - pw, 0)),
            (hi[0], chi,
             min((hi[2] - 1) * sh - ph + kh, ishape[2]),
             min((hi[3] - 1) * sw - pw + kw, ishape[3])))


class Pool2D(Op):
    op_type = "Pool2D"

    def __init__(self, name, input_tensor, kernel_h: int, kernel_w: int,
                 stride_h: int, stride_w: int, padding_h: int, padding_w: int,
                 pool_type: str = "max", activation: Optional[str] = None):
        super().__init__(name, [input_tensor])
        if pool_type not in ("max", "avg"):
            raise ValueError(f"pool_type must be 'max' or 'avg', got "
                             f"{pool_type!r}")
        n, c, h, w = input_tensor.shape
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.pool_type = pool_type
        self.activation = activation
        self._act = activation_fn(activation)
        oh = _out_dim(h, kernel_h, stride_h, padding_h)
        ow = _out_dim(w, kernel_w, stride_w, padding_w)
        self.outputs = [self._make_output((n, c, oh, ow), input_tensor.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        (x,) = xs
        (kh, kw), (ph, pw) = self.kernel, self.padding
        pad = self.padding
        if 2 * ph > kh or 2 * pw > kw:
            fill = float("-inf") if self.pool_type == "max" else 0.0
            x = F.pad(x, (pw, pw, ph, ph), value=fill)
            pad = (0, 0)
        if self.pool_type == "max":
            y = F.max_pool2d(x, self.kernel, self.stride, pad)
        else:
            # summed in f32 and divided by the whole window, padding
            # included, as reduce_window's sum / (kh * kw)
            y = F.avg_pool2d(x.float(), self.kernel, self.stride, pad,
                             count_include_pad=True)
        return [self._act(y).to(self.outputs[0].dtype)]

    def input_rect(self, pc, input_idx, part_idx):
        """Pooling is depthwise: the channel range maps through; H and W
        read kernel halos."""
        return _spatial_input_rect(self, pc, part_idx,
                                   channels_map_through=True)


class BatchNorm(Op):
    """Batch normalization over (N, H, W) per channel (cuDNN's
    BATCHNORM_SPATIAL in the reference).  The statistics are f32; the
    variance is the biased one; in training the running statistics
    become ``m * old + (1 - m) * new`` (the JAX op's rule, not
    ``F.batch_norm``'s, whose momentum is the other weight and whose
    running variance is unbiased).  The new running statistics are left
    in ``_last_state`` for the model to write back."""

    op_type = "BatchNorm"
    has_state = True

    def __init__(self, name, input_tensor, relu: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(name, [input_tensor])
        self.relu = relu
        self.momentum = momentum
        self.eps = eps
        self.num_channels = input_tensor.shape[1]
        self._last_state = None
        self.outputs = [self._make_output(input_tensor.shape,
                                          input_tensor.dtype)]

    def param_specs(self):
        c = self.num_channels
        return [ParameterSpec(self.name, "scale", (c,),
                              initializer=ConstantInitializer(1.0)),
                ParameterSpec(self.name, "bias", (c,),
                              initializer=ConstantInitializer(0.0))]

    def init_state(self, *, device=None):
        c = self.num_channels
        return {"mean": torch.zeros((c,), device=device),
                "var": torch.ones((c,), device=device)}

    def forward(self, params, xs, *, training=False, rng=None, state=None):
        (x,) = xs
        xf = x.float()
        if training or state is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            new_state = None
            if state is not None:
                m = self.momentum
                new_state = {"mean": m * state["mean"] + (1 - m) * mean,
                             "var": m * state["var"] + (1 - m) * var}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        inv = torch.rsqrt(var + self.eps)
        out_dtype = self.outputs[0].dtype
        if x.dtype == out_dtype and x.dtype != torch.float32:
            # bf16 activation storage: the apply runs in the storage
            # dtype subtract-first, (x - mean) * k + bias with k = inv *
            # scale in f32 (JAX ops/conv.py:332-352); (x - mean) of two
            # nearby bf16 values is exact or nearly, where a folded
            # x * k + (bias - mean * k) would cancel two large terms
            k = inv * params["scale"]
            y = (x - mean.to(x.dtype)[None, :, None, None]) \
                * k.to(x.dtype)[None, :, None, None] \
                + params["bias"].to(x.dtype)[None, :, None, None]
        else:
            y = (xf - mean[None, :, None, None]) * inv[None, :, None, None]
            y = y * params["scale"][None, :, None, None] \
                + params["bias"][None, :, None, None]
        if self.relu:
            y = torch.relu(y)
        self._last_state = new_state
        return [y.to(out_dtype)]
