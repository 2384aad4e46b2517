"""Tiered embedding storage: serve and train tables bigger than the
card's memory (counterpart of ``dlrm_flexflow_tpu/storage``).

Hot rows live in a fixed tensor on the card, cold rows in host memory;
lookups remap id -> slot on the host and the unchanged forward gathers
from the hot tier, with misses copied up through pinned staging and
installed by the row-set kernel.  Admission and eviction are pluggable
(LFU over the row-frequency counters by default; clock and LRU), the
``kernel_costs.tiered_storage_wins`` gate prices the predicted hit rate
against streaming every row, and ``save_tiered``/``load_tiered``
checkpoint the cold tier with a manifest of which tier owns which rows.
"""

from .checkpoint import load_tiered, save_tiered
from .policy import (ClockPolicy, EvictionPolicy, LFUPolicy, LRUPolicy,
                     POLICY_NAMES, make_policy)
from .tiered import (StorageError, TieredEmbeddingTable,
                     default_table_keys, predicted_hit_rate,
                     storage_override, tiered_decision)

__all__ = [
    "ClockPolicy", "EvictionPolicy", "LFUPolicy", "LRUPolicy",
    "POLICY_NAMES", "StorageError", "TieredEmbeddingTable",
    "default_table_keys", "load_tiered", "make_policy",
    "predicted_hit_rate", "save_tiered", "storage_override",
    "tiered_decision",
]
