"""The port's operators (counterparts of ``dlrm_flexflow_tpu/ops``)."""

from .base import Op, activation_fn, matmul
from .embedding import Embedding, RaggedStackedEmbedding, StackedEmbedding
from .fused_interact import FusedEmbedInteract
from .linear import Linear
from .shape_ops import BatchMatmul, Concat, Flat, Reshape, Transpose

__all__ = ["Op", "activation_fn", "matmul", "Embedding",
           "RaggedStackedEmbedding", "StackedEmbedding", "FusedEmbedInteract",
           "Linear", "BatchMatmul", "Concat", "Flat", "Reshape", "Transpose"]
