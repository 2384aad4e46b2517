"""reference python/flexflow/keras/models/ — Model, Sequential, Input.

``compile`` places the weights on the scope's device
(``scope.current_device``; None: the card) unless given ``device=``."""

from ...frontends import keras as _keras
from ...frontends.keras import BaseModel, Input
from ..scope import current_device


class _ScopedCompile:
    def compile(self, *args, device=None, **kwargs):
        return super().compile(*args, device=current_device(device),
                               **kwargs)


class Sequential(_ScopedCompile, _keras.Sequential):
    pass


class Model(_ScopedCompile, _keras.Model):
    pass


__all__ = ["BaseModel", "Model", "Sequential", "Input"]
