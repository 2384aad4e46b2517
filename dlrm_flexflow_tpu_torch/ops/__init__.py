"""The port's operators (counterparts of ``dlrm_flexflow_tpu/ops``)."""

from .base import Op, activation_fn, matmul
from .linear import Linear
from .embedding import Embedding, RaggedStackedEmbedding, StackedEmbedding
from .fused_interact import FusedEmbedInteract
from .elementwise import ElementBinary, ElementUnary
from .shape_ops import (BatchMatmul, Concat, Flat, Reshape, Reverse, Split,
                        Transpose)
from .conv import BatchNorm, Conv2D, Pool2D
from .softmax import Dropout, Softmax
from .attention import MultiHeadAttention, sdpa
from .rnn import LSTM
from .moe import MixtureOfExperts
from .overlap_embed import OverlappedEmbedBottom

__all__ = ["Op", "activation_fn", "matmul", "Linear", "Embedding",
           "StackedEmbedding", "RaggedStackedEmbedding", "FusedEmbedInteract",
           "ElementBinary", "ElementUnary", "BatchMatmul", "Concat", "Flat",
           "Reshape", "Reverse", "Split", "Transpose", "BatchNorm", "Conv2D",
           "Pool2D", "Dropout", "Softmax", "MultiHeadAttention", "sdpa",
           "LSTM", "MixtureOfExperts", "OverlappedEmbedBottom"]
