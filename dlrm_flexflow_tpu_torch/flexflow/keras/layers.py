"""reference python/flexflow/keras/layers/ — layer classes.

``concatenate``/``add``/``subtract``/``multiply`` lowercase functional
forms (reference layers/merge.py) are included.
"""

from ...frontends.keras import (Activation, Add, AveragePooling2D,
                                BatchNormalization, Concatenate, Conv2D,
                                Dense, Dropout, Embedding, Flatten)
from ...frontends.keras import Input as InputLayer
from ...frontends.keras import (InputTensor, Layer, MaxPooling2D, Multiply,
                                Reshape, Subtract)


def Input(shape, dtype="float32", name=None):
    """Functional-API input (reference layers/input_layer.py: returns the
    symbolic tensor, ready to be consumed by layer calls)."""
    return InputTensor(shape, dtype, name)


def concatenate(tensors, axis=1, name=None):
    return Concatenate(axis=axis, name=name)(tensors)


def add(tensors, name=None):
    return Add(name=name)(tensors)


def subtract(tensors, name=None):
    return Subtract(name=name)(tensors)


def multiply(tensors, name=None):
    return Multiply(name=name)(tensors)


__all__ = ["Layer", "Input", "InputLayer", "Dense", "Flatten", "Embedding",
           "Activation", "Dropout", "Reshape", "Conv2D", "MaxPooling2D",
           "AveragePooling2D", "BatchNormalization", "Concatenate", "Add",
           "Subtract", "Multiply", "concatenate", "add", "subtract",
           "multiply"]
