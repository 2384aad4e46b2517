"""Shape and layout operators: Concat, Split, Reshape, Transpose,
Reverse, Flat and BatchMatmul (counterparts in
``dlrm_flexflow_tpu/ops/shape_ops.py``).

They are plain PyTorch calls whose backward is autograd's.  Reshape (when
it keeps the batch dim) and Flat are batch-polymorphic, as in the JAX
package, so one graph serves every batch size.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Op, matmul, rect_of_part


class Concat(Op):
    op_type = "Concat"

    def __init__(self, name, tensors, axis: int):
        super().__init__(name, tensors)
        ndim = tensors[0].ndim
        axis = axis % ndim
        self.axis = axis
        for t in tensors[1:]:
            if t.ndim != ndim or any(
                    t.shape[d] != tensors[0].shape[d]
                    for d in range(ndim) if d != axis):
                raise ValueError(f"concat mismatch: {t.shape} vs "
                                 f"{tensors[0].shape} on axis {axis}")
        out = list(tensors[0].shape)
        out[axis] = sum(t.shape[axis] for t in tensors)
        self.outputs = [self._make_output(tuple(out), tensors[0].dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        return [torch.cat(xs, dim=self.axis)]

    def input_rect(self, pc, input_idx, part_idx):
        """Output rect shifted by the input's offset on the concat axis
        and clipped to its extent (an empty rect moves no bytes)."""
        lo, hi = rect_of_part(pc, self.outputs[0].shape, part_idx)
        off = sum(t.shape[self.axis] for t in self.inputs[:input_idx])
        ext = self.inputs[input_idx].shape[self.axis]
        lo, hi = list(lo), list(hi)
        a = max(lo[self.axis] - off, 0)
        b = max(min(hi[self.axis] - off, ext), a)
        lo[self.axis], hi[self.axis] = a, b
        return tuple(lo), tuple(hi)


class Split(Op):
    """Cut one tensor into ``len(sizes)`` along ``axis``; one output per
    piece."""

    op_type = "Split"

    def __init__(self, name, input_tensor, sizes, axis: int):
        super().__init__(name, [input_tensor])
        axis = axis % input_tensor.ndim
        self.axis = axis
        self.sizes = [int(s) for s in sizes]
        if sum(self.sizes) != input_tensor.shape[axis]:
            raise ValueError(f"split sizes {self.sizes} do not add up to "
                             f"{input_tensor.shape[axis]} on axis {axis}")
        for i, s in enumerate(self.sizes):
            shape = list(input_tensor.shape)
            shape[axis] = s
            self.outputs.append(self._make_output(tuple(shape),
                                                  input_tensor.dtype, idx=i))

    def forward(self, params, xs, *, training=False, rng=None):
        return list(torch.split(xs[0], self.sizes, dim=self.axis))


class Reshape(Op):
    op_type = "Reshape"

    def __init__(self, name, input_tensor, shape):
        super().__init__(name, [input_tensor])
        shape = tuple(int(s) for s in shape)
        numel = int(np.prod(input_tensor.shape))
        if -1 in shape:  # one numpy-style wildcard
            known = -int(np.prod(shape))
            shape = tuple(numel // known if s == -1 else s for s in shape)
        if int(np.prod(shape)) != numel:
            raise ValueError(f"reshape {input_tensor.shape} -> {shape}")
        self.outputs = [self._make_output(shape, input_tensor.dtype)]
        # a reshape that keeps dim 0 stays polymorphic in the batch
        self._batch_poly = shape[0] == input_tensor.shape[0]

    def forward(self, params, xs, *, training=False, rng=None):
        (x,) = xs
        if self._batch_poly:
            return [x.reshape((x.shape[0],) + self.outputs[0].shape[1:])]
        return [x.reshape(self.outputs[0].shape)]


class Transpose(Op):
    """Default: swap the last two dims; a full permutation is accepted."""

    op_type = "Transpose"

    def __init__(self, name, input_tensor, perm=None):
        super().__init__(name, [input_tensor])
        n = input_tensor.ndim
        if perm is None:
            perm = list(range(n - 2)) + [n - 1, n - 2]
        self.perm = tuple(int(p) for p in perm)
        out_shape = tuple(input_tensor.shape[p] for p in self.perm)
        self.outputs = [self._make_output(out_shape, input_tensor.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        return [xs[0].permute(self.perm)]

    def input_rect(self, pc, input_idx, part_idx):
        """Output rect mapped through the permutation: output dim i reads
        input dim perm[i]."""
        lo, hi = rect_of_part(pc, self.outputs[0].shape, part_idx)
        n = len(self.perm)
        ilo, ihi = [0] * n, [0] * n
        for i, p in enumerate(self.perm):
            ilo[p], ihi[p] = lo[i], hi[i]
        return tuple(ilo), tuple(ihi)


class Reverse(Op):
    op_type = "Reverse"

    def __init__(self, name, input_tensor, axis: int):
        super().__init__(name, [input_tensor])
        self.axis = axis % input_tensor.ndim
        self.outputs = [self._make_output(input_tensor.shape,
                                          input_tensor.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        return [torch.flip(xs[0], dims=(self.axis,))]

    def input_rect(self, pc, input_idx, part_idx):
        """Output rect mirrored on the reversed axis."""
        lo, hi = rect_of_part(pc, self.outputs[0].shape, part_idx)
        ext = self.inputs[0].shape[self.axis]
        lo, hi = list(lo), list(hi)
        lo[self.axis], hi[self.axis] = ext - hi[self.axis], ext - lo[self.axis]
        return tuple(lo), tuple(hi)


class Flat(Op):
    """(batch, ...) -> (batch, prod(...)) for any batch."""

    op_type = "Flat"

    def __init__(self, name, input_tensor):
        super().__init__(name, [input_tensor])
        rest = int(np.prod(input_tensor.shape[1:]))
        self.outputs = [self._make_output((input_tensor.shape[0], rest),
                                          input_tensor.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        (x,) = xs
        return [x.reshape(x.shape[0], -1)]


class BatchMatmul(Op):
    """(b, m, k) x (b, k, n) -> (b, m, n) with optional transposes.  The
    product is ``ops/base.py::matmul``: bf16 operands under bf16 compute,
    accumulation in f64, one rounding to an f32 result, so a sample's
    output does not depend on the batch it rides in."""

    op_type = "BatchMatmul"

    def __init__(self, name, a, b, trans_a: bool = False,
                 trans_b: bool = False, compute_dtype=None):
        super().__init__(name, [a, b])
        if not a.ndim == b.ndim >= 3:
            raise ValueError(f"batch_matmul needs rank >= 3 operands of "
                             f"one rank, got {a.shape} x {b.shape}")
        sa, sb = list(a.shape), list(b.shape)
        if trans_a:
            sa[-1], sa[-2] = sa[-2], sa[-1]
        if trans_b:
            sb[-1], sb[-2] = sb[-2], sb[-1]
        if sa[-1] != sb[-2] or sa[:-2] != sb[:-2]:
            raise ValueError(f"batch_matmul shapes: {a.shape} x {b.shape}")
        self.trans_a, self.trans_b = trans_a, trans_b
        self.compute_dtype = compute_dtype
        self.outputs = [self._make_output(tuple(sa[:-1] + [sb[-1]]),
                                          a.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        a, b = xs
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        out = matmul(a, b, self.compute_dtype)
        return [out.to(self.outputs[0].dtype)]

    def input_rect(self, pc, input_idx, part_idx):
        """A (b, m, n) part reads A's (b, m, :) rows and B's (b, :, n)
        columns (positions swapped under the trans flags); the contracted
        dim is read in full."""
        ishape = self.inputs[input_idx].shape
        olo, ohi = rect_of_part(pc, self.outputs[0].shape, part_idx)
        nd = len(ishape)
        lo, hi = [0] * nd, list(ishape)
        # leading batch dims map through 1:1
        for d in range(nd - 2):
            lo[d], hi[d] = olo[d], ohi[d]
        if input_idx == 0:   # A: m lives at -2 (or -1 when trans_a)
            d = nd - 1 if self.trans_a else nd - 2
            lo[d], hi[d] = olo[-2], ohi[-2]
        else:                # B: n lives at -1 (or -2 when trans_b)
            d = nd - 2 if self.trans_b else nd - 1
            lo[d], hi[d] = olo[-1], ohi[-1]
        return tuple(lo), tuple(hi)

    def flops(self, batch):
        m, k = self.inputs[0].shape[-2], self.inputs[0].shape[-1]
        n = self.outputs[0].shape[-1]
        nb = 1
        for d in self.inputs[0].shape[:-2]:
            nb *= d
        return 2 * nb * m * k * n
