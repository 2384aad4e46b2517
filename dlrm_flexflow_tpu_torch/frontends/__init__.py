"""Frontends (counterpart of ``dlrm_flexflow_tpu/frontends/``): the
keras-style models (``keras``, with ``keras_utils``, ``keras_datasets``
and the training callbacks ``fit`` drives, ``keras_callbacks``), the
torch.fx importer (``torch_fx.PyTorchModel``) and the ONNX importer
(``onnx_model.ONNXModel``, which needs the ``onnx`` package)."""
