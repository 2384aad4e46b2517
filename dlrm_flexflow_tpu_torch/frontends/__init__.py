"""Frontends (counterpart of ``dlrm_flexflow_tpu/frontends/``): so far the
keras-style training callbacks ``fit`` drives.  The keras, torch.fx and
ONNX model frontends come with the op set (ROADMAP.md Queue A item 9)."""
