"""reference python/flexflow/keras/preprocessing/text.py."""

from ....frontends.keras_utils import Tokenizer

__all__ = ["Tokenizer"]
