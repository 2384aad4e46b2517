"""Strategies of the port: per-op ``ParallelConfig``, the ``Strategy``
map and its reference ``.pb`` codec.  The mesh, the table exchange,
overlap, pipelining and sequence parallelism come with the scale-out
slice (ROADMAP.md item 8)."""

from .parallel_config import ParallelConfig, Strategy
from .strategy_pb import dlrm_strategy, load_strategy_pb, save_strategy_pb

__all__ = ["ParallelConfig", "Strategy", "dlrm_strategy",
           "load_strategy_pb", "save_strategy_pb"]
