"""reference python/flexflow/torch/ — PyTorch import frontend
(counterpart of ``flexflow/torch/``)."""

from . import fx, model  # noqa: F401
