"""reference python/flexflow/keras/backend/flexflow_backend.py —
get/set_value over parameters plus the data-format query."""

import numpy as np


def image_data_format():
    """The reference is channels-first (NCHW) throughout (conv_2d.cu)."""
    return "channels_first"


def get_value(x):
    return np.asarray(x)


def set_value(x, value):
    raise NotImplementedError(
        "set_value on raw arrays does not reach a model's state; "
        "use Parameter.set_weights / FFModel.set_weights")


__all__ = ["image_data_format", "get_value", "set_value"]
