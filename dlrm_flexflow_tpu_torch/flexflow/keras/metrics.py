"""reference python/flexflow/keras/metrics.py — metric marker classes."""


class Metric:
    name = None


class Accuracy(Metric):
    name = "accuracy"


class CategoricalCrossentropy(Metric):
    name = "categorical_crossentropy"


class SparseCategoricalCrossentropy(Metric):
    name = "sparse_categorical_crossentropy"


class MeanSquaredError(Metric):
    name = "mean_squared_error"


class RootMeanSquaredError(Metric):
    name = "root_mean_squared_error"


class MeanAbsoluteError(Metric):
    name = "mean_absolute_error"


__all__ = ["Metric", "Accuracy", "CategoricalCrossentropy",
           "SparseCategoricalCrossentropy", "MeanSquaredError",
           "RootMeanSquaredError", "MeanAbsoluteError"]
