"""dlrm_flexflow_tpu_torch: the PyTorch and CUDA port of dlrm_flexflow_tpu
for NVIDIA Hopper.

The JAX package ``dlrm_flexflow_tpu`` is the reference; this package
mirrors its module layout, imports no JAX, and replaces each Pallas
kernel with a hand-written CUDA kernel (``csrc/``), built with ``nvcc``
at first use.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from .config import FFConfig
from .data import ArrayDataLoader, SyntheticDLRMLoader, ZipfDLRMLoader
from .initializers import (ConstantInitializer, GlorotUniform,
                           NormInitializer, UniformInitializer,
                           ZeroInitializer)
from .losses import get_loss
from .metrics import MetricsAccumulator, compute_metrics
from .model import FFModel, TrainState
from .optim import AdamOptimizer, SGDOptimizer
from .parallel.mesh import make_mesh
from .parallel.parallel_config import ParallelConfig, Strategy
from .serving import (DeadlineExceeded, DynamicBatcher, InferenceEngine,
                      LatencyStats, Rejected, parse_buckets)
from .tensor import ParameterSpec, Tensor

__version__ = "0.1.0"

__all__ = ["FFConfig", "FFModel", "TrainState", "Tensor", "SGDOptimizer",
           "AdamOptimizer", "ParallelConfig", "Strategy", "make_mesh",
           "GlorotUniform",
           "ZeroInitializer", "UniformInitializer", "NormInitializer",
           "ConstantInitializer", "get_loss", "compute_metrics",
           "MetricsAccumulator", "InferenceEngine", "DynamicBatcher",
           "LatencyStats", "Rejected", "DeadlineExceeded",
           "ArrayDataLoader", "SyntheticDLRMLoader", "ZipfDLRMLoader",
           "parse_buckets", "ParameterSpec"]
