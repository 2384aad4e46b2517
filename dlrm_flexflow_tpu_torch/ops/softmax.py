"""Softmax and Dropout (counterparts of ``dlrm_flexflow_tpu/ops/softmax.py``;
reference src/ops/softmax.cu, src/ops/dropout.cu).

A dropout mask cannot carry the JAX package's bits: ``jax.random`` is
not replayable in torch.  The port draws it from a counter-based hash
instead: 32-bit integer mixing (murmur3's finaliser) of the element's
index under a two-word key, in plain int64 tensor arithmetic, so the
mask is a pure function of the key.  The model derives each dropout op's
key on the device from the state's ``rng`` and ``step`` and the op's
index (``fold_in``), and the op folds in its own ``seed``.  A mask
therefore depends on (``rng``, ``step``, op index, seed) and nothing
else: the CPU and the card draw the same mask, a resumed run the masks
of the run it was cut from, and a captured step, which reads ``step``
by address, a new mask on every replay.  No generator is involved, so
nothing is frozen at capture.
"""

from __future__ import annotations

import torch

from .base import Op, rect_of_part

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(h, m: int):
    """``(h * m) mod 2**32`` for int64 ``h`` in [0, 2**32) and a 32-bit
    constant ``m``, in two 16-bit halves of ``m`` so that no product
    leaves int64."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """murmur3's 32-bit finaliser: a bijection of [0, 2**32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def as_key(rng) -> torch.Tensor:
    """A ``(2,)`` key (the state's uint32 ``rng``, or a key already made
    by :func:`fold_in`) as int64 words in [0, 2**32).  A uint32 key is
    read through its int32 view: a widening cast of uint32 is not
    implemented on every device."""
    if rng.dtype == torch.uint32:
        rng = rng.view(torch.int32)
    return rng.to(torch.int64) & _M32


def fold_in(key, data) -> torch.Tensor:
    """A new ``(2,)`` int64 key from ``key`` and ``data`` (a Python int or
    an integer tensor of one element, such as the state's step), computed
    where ``key`` lives."""
    key = as_key(key)
    if isinstance(data, torch.Tensor):
        d = data.reshape(()).to(torch.int64) & _M32
    else:
        d = int(data) & _M32
    t = _fmix32((d + _GOLDEN) & _M32)
    k0 = _fmix32(key[0] ^ t)
    k1 = _fmix32((key[1] + _mul32(t, 0x85EBCA6B) + k0) & _M32)
    return torch.stack([k0, k1])


def random_bits(key, shape) -> torch.Tensor:
    """int64 words in [0, 2**32), one per element of ``shape``: element
    ``i`` (row-major) is ``fmix(fmix(i ^ k0) + k1)``, each ``fmix`` a
    bijection, so the words are distinct within one call."""
    key = as_key(key)
    n = 1
    for s in shape:
        n *= int(s)
    if n > _M32:
        raise ValueError(f"{n} elements: the index must fit 32 bits")
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    x = _fmix32(i ^ key[0])
    x = _fmix32((x + key[1]) & _M32)
    return x.reshape(tuple(shape))


def dropout_keep(key, shape, keep: float) -> torch.Tensor:
    """The boolean keep mask of ``shape``: an element is kept when its
    word is below ``keep * 2**32``."""
    threshold = min(int(round(keep * 2.0 ** 32)), 2 ** 32)
    return random_bits(key, shape) < threshold


class Softmax(Op):
    op_type = "Softmax"

    def __init__(self, name, input_tensor, axis: int = -1):
        super().__init__(name, [input_tensor])
        self.axis = axis
        self.outputs = [self._make_output(input_tensor.shape,
                                          input_tensor.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        # in f32 whatever the input's dtype, then the declared dtype
        y = torch.softmax(xs[0].float(), dim=self.axis)
        return [y.to(self.outputs[0].dtype)]

    def input_rect(self, pc, input_idx, part_idx):
        """Pointwise over the non-softmax dims (parts never split the
        softmax axis in practice)."""
        return rect_of_part(pc, self.inputs[0].shape, part_idx)


class Dropout(Op):
    """Training-mode dropout: keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``; the
    identity outside training.  ``rng`` is the op's key from the model
    (``fold_in`` of the step's key and the op's index); a nonzero
    ``seed`` is folded into it, as the JAX op folds its seed."""

    op_type = "Dropout"

    def __init__(self, name, input_tensor, rate: float = 0.5, seed: int = 0):
        super().__init__(name, [input_tensor])
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate
        self.seed = seed
        self.outputs = [self._make_output(input_tensor.shape,
                                          input_tensor.dtype)]

    def forward(self, params, xs, *, training=False, rng=None):
        (x,) = xs
        if not training or self.rate == 0.0:
            return [x]
        if rng is None:
            raise ValueError("training-mode dropout needs an rng key")
        if self.seed:
            rng = fold_in(rng, self.seed)
        keep = 1.0 - self.rate
        mask = dropout_keep(rng.to(x.device), x.shape, keep)
        scaled = x / torch.full((), keep, dtype=x.dtype, device=x.device)
        return [torch.where(mask, scaled, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))]

    def input_rect(self, pc, input_idx, part_idx):
        """Pointwise: each part reads exactly its own rectangle."""
        return rect_of_part(pc, self.inputs[0].shape, part_idx)
