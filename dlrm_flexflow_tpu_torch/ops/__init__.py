"""The port's operators (counterparts of ``dlrm_flexflow_tpu/ops``)."""

from .base import Op, activation_fn, matmul
from .embedding import RaggedStackedEmbedding
from .fused_interact import FusedEmbedInteract
from .linear import Linear

__all__ = ["Op", "activation_fn", "matmul", "RaggedStackedEmbedding",
           "FusedEmbedInteract", "Linear"]
