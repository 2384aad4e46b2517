"""reference python/flexflow/torch/model.py — PyTorchModel(file).apply(
ffmodel, input_tensors) replays a torch model onto a compat FFModel."""

from typing import List

import torch

from ...frontends.torch_fx import PyTorchModel as _CorePTM
from ..core.flexflow_binding import FFModel, Tensor, track_core_layers


class PyTorchModel:
    """reference torch/model.py:18-149."""

    def __init__(self, filename_or_module):
        if isinstance(filename_or_module, str):
            module = torch.load(filename_or_module, weights_only=False)
        else:
            module = filename_or_module
        self._ptm = _CorePTM(module)

    def apply(self, ffmodel, input_tensors: List):
        """Replay onto the compat ``ffmodel``; ``input_tensors`` bind the
        traced placeholders in order.  Returns compat output tensors."""
        assert isinstance(ffmodel, FFModel), \
            "apply expects a flexflow.core FFModel"
        names = self._ptm.placeholder_names()
        assert len(names) == len(input_tensors), (
            f"model has {len(names)} inputs, got {len(input_tensors)}")
        nb_before = len(ffmodel._core.layers)
        bound = {n: t._t for n, t in zip(names, input_tensors)}
        outs = self._ptm.lower_onto(ffmodel._core, bound)
        # register the newly created core ops as typed compat layers
        track_core_layers(ffmodel, nb_before)
        return [Tensor(t, ffmodel) for t in outs]

    def import_weights(self, ffmodel):
        """Copy the torch module's weights into the model state (the
        reference does this per-Parameter via set_weights)."""
        state = ffmodel._require_state()
        ffmodel._state = self._ptm.import_weights(ffmodel._core, state)


__all__ = ["PyTorchModel"]
