"""Data loaders of the port (NumPy only)."""

from .loader import (ArrayDataLoader, SyntheticDLRMLoader, ZipfDLRMLoader,
                     zipf_ids)

__all__ = ["ArrayDataLoader", "SyntheticDLRMLoader", "ZipfDLRMLoader",
           "zipf_ids"]
