"""reference python/flexflow/keras/initializers.py — keras-named
initializers over the core ones."""

from ... import initializers as _init


class GlorotUniform(_init.GlorotUniform):
    def __init__(self, seed=None):
        super().__init__()
        self.seed = seed


class Zeros(_init.ZeroInitializer):
    pass


class RandomUniform(_init.UniformInitializer):
    def __init__(self, minval=-0.05, maxval=0.05, seed=None):
        super().__init__(minval=minval, maxval=maxval, seed=seed or 0)


class RandomNormal(_init.NormInitializer):
    def __init__(self, mean=0.0, stddev=0.05, seed=None):
        super().__init__(mean=mean, stddev=stddev, seed=seed or 0)


class Constant(_init.ConstantInitializer):
    pass


class DefaultInitializer:
    """Marker for 'let the layer pick' (reference initializers.py:26)."""


Initializer = _init.Initializer

__all__ = ["Initializer", "DefaultInitializer", "GlorotUniform", "Zeros",
           "RandomUniform", "RandomNormal", "Constant"]
