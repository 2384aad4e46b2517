"""reference python/flexflow/keras/preprocessing/ — sequence + text tools."""

from . import sequence, text
from .sequence import pad_sequences
from .text import Tokenizer

__all__ = ["sequence", "text", "pad_sequences", "Tokenizer"]
