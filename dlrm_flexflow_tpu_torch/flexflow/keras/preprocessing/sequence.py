"""reference python/flexflow/keras/preprocessing/sequence.py."""

from ....frontends.keras_utils import pad_sequences

__all__ = ["pad_sequences"]
