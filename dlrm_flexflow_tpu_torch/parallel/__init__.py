"""Strategies and their execution across ranks: per-op
``ParallelConfig``, the ``Strategy`` map and its reference ``.pb`` codec,
the device mesh and its layouts (``mesh``), the mesh executor (``spmd``)
and the manual-collective modules (the table exchange, its overlapped
pipeline, the SPMD pipeline, ring and Ulysses attention)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, apply_partition_rules,
                   constrain, make_mesh, match_partition_rule, param_pspec,
                   partition_rules, pspec_for_config, sharding)
from .overlap import microbatch_ok, overlapped_embed_bottom
from .parallel_config import ParallelConfig, Strategy
from .ring_attention import ring_attention, ring_attention_sharded
from .strategy_pb import dlrm_strategy, load_strategy_pb, save_strategy_pb
from .table_exchange import table_parallel_lookup
from .ulysses import ulysses_attention, ulysses_attention_sharded

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS",
    "make_mesh", "pspec_for_config", "param_pspec", "sharding", "constrain",
    "partition_rules", "match_partition_rule", "apply_partition_rules",
    "ParallelConfig", "Strategy",
    "ring_attention", "ring_attention_sharded",
    "table_parallel_lookup",
    "microbatch_ok", "overlapped_embed_bottom",
    "ulysses_attention", "ulysses_attention_sharded",
    "dlrm_strategy", "load_strategy_pb", "save_strategy_pb",
]
