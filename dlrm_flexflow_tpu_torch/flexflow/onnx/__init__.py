"""reference python/flexflow/onnx/ — ONNX import frontend (counterpart of
``flexflow/onnx/``; ``ONNXModel`` needs the ``onnx`` package)."""

from . import model  # noqa: F401
