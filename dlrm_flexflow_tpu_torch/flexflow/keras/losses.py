"""reference python/flexflow/keras/losses.py — loss marker classes; the
``name`` feeds the core loss registry."""


class Loss:
    name = None


class CategoricalCrossentropy(Loss):
    name = "categorical_crossentropy"


class SparseCategoricalCrossentropy(Loss):
    name = "sparse_categorical_crossentropy"


class MeanSquaredError(Loss):
    name = "mean_squared_error"


__all__ = ["Loss", "CategoricalCrossentropy",
           "SparseCategoricalCrossentropy", "MeanSquaredError"]
