"""dlrm_flexflow_tpu_torch: the PyTorch and CUDA port of dlrm_flexflow_tpu
for NVIDIA Hopper.

The JAX package ``dlrm_flexflow_tpu`` is the reference; this package
mirrors its module layout, imports no JAX, and replaces each Pallas
kernel with a hand-written CUDA kernel (``csrc/``), built with ``nvcc``
at first use.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from .config import FFConfig
from .model import FFModel, TrainState
from .serving import (DynamicBatcher, InferenceEngine, LatencyStats,
                      parse_buckets)
from .tensor import ParameterSpec, Tensor

__all__ = ["FFConfig", "FFModel", "TrainState", "DynamicBatcher",
           "InferenceEngine", "LatencyStats", "parse_buckets",
           "ParameterSpec", "Tensor"]
