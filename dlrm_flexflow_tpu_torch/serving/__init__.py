"""Online serving (counterpart of ``dlrm_flexflow_tpu/serving``): the
bucketed InferenceEngine (resident or tiered tables), the DynamicBatcher
in front of it, the ReplicaRouter over N of them, and their latency
statistics."""

from .batcher import DeadlineExceeded, DynamicBatcher, Rejected, ServeFuture
from .engine import DEFAULT_BUCKETS, InferenceEngine, parse_buckets
from .router import ReplicaDead, ReplicaRouter
from .stats import LatencyStats

__all__ = ["DeadlineExceeded", "DynamicBatcher", "Rejected", "ServeFuture",
           "DEFAULT_BUCKETS", "InferenceEngine", "parse_buckets",
           "LatencyStats", "ReplicaDead", "ReplicaRouter"]
