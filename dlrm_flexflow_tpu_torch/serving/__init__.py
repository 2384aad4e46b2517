"""Online serving (counterpart of ``dlrm_flexflow_tpu/serving``): the
bucketed InferenceEngine, the DynamicBatcher in front of it, and their
latency statistics."""

from .batcher import DeadlineExceeded, DynamicBatcher, Rejected, ServeFuture
from .engine import DEFAULT_BUCKETS, InferenceEngine, parse_buckets
from .stats import LatencyStats

__all__ = ["DeadlineExceeded", "DynamicBatcher", "Rejected", "ServeFuture",
           "DEFAULT_BUCKETS", "InferenceEngine", "parse_buckets",
           "LatencyStats"]
