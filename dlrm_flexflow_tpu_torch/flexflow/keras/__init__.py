"""Reference-compatible ``flexflow.keras`` package (reference:
python/flexflow/keras/__init__.py) backed by
:mod:`dlrm_flexflow_tpu_torch.frontends.keras` (counterpart of
``flexflow/keras/``)."""

from . import (backend, callbacks, datasets, initializers, layers, losses,
               metrics, models, optimizers, preprocessing, utils)

__all__ = ["backend", "callbacks", "datasets", "initializers", "layers",
           "losses", "metrics", "models", "optimizers", "preprocessing",
           "utils"]
