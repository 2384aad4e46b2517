"""Data loaders of the port (NumPy only) and the asynchronous prefetch
wrapper."""

from .loader import (ArrayDataLoader, SyntheticDLRMLoader, ZipfDLRMLoader,
                     zipf_ids)
from .prefetch import BatchPlacer, PrefetchLoader

__all__ = ["ArrayDataLoader", "SyntheticDLRMLoader", "ZipfDLRMLoader",
           "zipf_ids", "BatchPlacer", "PrefetchLoader"]
