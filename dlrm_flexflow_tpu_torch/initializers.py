"""Weight initializers drawing from an explicit ``torch.Generator``.

Counterpart of ``dlrm_flexflow_tpu/initializers.py``: the same
distributions, but torch's generator gives other numbers than JAX's PRNG
from the same seed, so tests transfer weights instead of re-drawing
them (``bridge.params_from_jax``).  Each initializer draws on the
generator's device.
"""

from __future__ import annotations

import hashlib
import math

import torch


def derive_seed(*parts) -> int:
    """A 63-bit seed from any hashable parts (stable across processes)."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


class Initializer:
    def __call__(self, generator: torch.Generator, shape,
                 dtype=torch.float32):
        raise NotImplementedError


class GlorotUniform(Initializer):
    """Xavier/Glorot uniform: fan-in/fan-out from the last two dims of the
    (in, out) weight, receptive field from the others."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, generator, shape, dtype=torch.float32):
        if len(shape) >= 2:
            receptive = 1
            for d in shape[:-2]:
                receptive *= d
            fan_in = shape[-2] * receptive
            fan_out = shape[-1] * receptive
        else:
            fan_in = fan_out = shape[0]
        limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=dtype, device=generator.device
                           ).uniform_(-limit, limit, generator=generator)


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=generator.device)


def seeded(generator: torch.Generator, seed: int) -> torch.Generator:
    """``generator`` itself for seed 0; otherwise a new generator on its
    device whose seed hashes ``seed`` with ``generator``'s current state,
    the counterpart of ``jax.random.fold_in(key, seed)``: the draw
    depends on both, and ``generator`` is not advanced."""
    if not seed:
        return generator
    state = bytes(generator.get_state().tolist())
    return torch.Generator(device=generator.device).manual_seed(
        derive_seed(state, int(seed)))


class UniformInitializer(Initializer):
    """Uniform in [minval, maxval); a nonzero ``seed`` is folded into the
    generator (``seeded``), as the JAX initializer folds it into its
    key."""

    def __init__(self, minval: float = -0.05, maxval: float = 0.05,
                 seed: int = 0):
        self.minval = minval
        self.maxval = maxval
        self.seed = seed

    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=generator.device
                           ).uniform_(self.minval, self.maxval,
                                      generator=seeded(generator, self.seed))


class NormInitializer(Initializer):
    """Gaussian: ``mean + stddev * N(0, 1)``, a nonzero ``seed`` folded in
    as in ``UniformInitializer``."""

    def __init__(self, mean: float = 0.0, stddev: float = 1.0,
                 seed: int = 0):
        self.mean = mean
        self.stddev = stddev
        self.seed = seed

    def __call__(self, generator, shape, dtype=torch.float32):
        z = torch.empty(shape, dtype=dtype, device=generator.device
                        ).normal_(generator=seeded(generator, self.seed))
        return self.mean + self.stddev * z


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.full(shape, self.value, dtype=dtype,
                          device=generator.device)


# glorot for kernels, zero for biases
DEFAULT_KERNEL_INIT = GlorotUniform()
DEFAULT_BIAS_INIT = ZeroInitializer()
