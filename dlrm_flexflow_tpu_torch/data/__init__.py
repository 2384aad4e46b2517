"""Data loaders of the port (NumPy only) and the asynchronous prefetch
wrapper."""

from .loader import (ArrayDataLoader, SyntheticDLRMLoader, ZipfDLRMLoader,
                     load_criteo_h5, preprocess_criteo_npz, zipf_ids)
from .prefetch import BatchPlacer, PrefetchLoader

__all__ = ["ArrayDataLoader", "SyntheticDLRMLoader", "ZipfDLRMLoader",
           "load_criteo_h5", "preprocess_criteo_npz", "zipf_ids",
           "BatchPlacer", "PrefetchLoader"]
