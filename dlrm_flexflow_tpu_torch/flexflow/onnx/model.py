"""reference python/flexflow/onnx/model.py — ONNXModel(filename).apply(
ffmodel, {input_name: tensor})."""

from ...frontends.onnx_model import ONNXModel as _CoreOnnx
from ..core.flexflow_binding import FFModel, Tensor, track_core_layers


class ONNXModel:
    """reference onnx/model.py:23."""

    def __init__(self, filename_or_model):
        self._om = _CoreOnnx(filename_or_model)

    def apply(self, ffmodel, input_dict):
        assert isinstance(ffmodel, FFModel), \
            "apply expects a flexflow.core FFModel"
        nb_before = len(ffmodel._core.layers)
        bound = {name: t._t for name, t in input_dict.items()}
        outs = self._om.lower_onto(ffmodel._core, bound)
        track_core_layers(ffmodel, nb_before)
        wrapped = [Tensor(t, ffmodel) for t in outs]
        return wrapped[0] if len(wrapped) == 1 else wrapped


__all__ = ["ONNXModel"]
