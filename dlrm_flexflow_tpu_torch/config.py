"""Runtime configuration and CLI flag parsing.

Counterpart of ``dlrm_flexflow_tpu/config.py``: the same field names,
defaults and flags for the fields the serving slice reads.  The other
fields arrive with the slices that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    # per-op matmul precision: "bfloat16" = bf16 operands, f32 accumulation
    compute_dtype: str = "float32"
    # embedding-table storage dtype (the fused kernel serves float32)
    embedding_dtype: str = "float32"
    # inter-op activation storage dtype (float32 only in this slice)
    activation_dtype: str = "float32"
    # --- online serving (serving/) ---------------------------------------
    # batch-size buckets the InferenceEngine warms up; requests pad up to
    # the enclosing bucket (comma-separated, sorted/deduped at parse)
    serve_buckets: str = "1,8,64,256"
    # DynamicBatcher: rows per micro-batch (0 = the top bucket), the max
    # wait of the oldest queued request before a partial batch
    # dispatches, the bounded queue depth, and the default per-request
    # deadline (0 = none)
    serve_max_batch: int = 0
    serve_max_wait_us: float = 2000.0
    serve_queue_depth: int = 256
    serve_timeout_us: float = 0.0
    # "off" only in this slice (quantized tables come later)
    serve_quantize: str = "off"
    # "resident" only in this slice (tiered storage comes later)
    serve_storage: str = "resident"
    seed: int = 0

    @staticmethod
    def parse_args(argv: Sequence[str]) -> "FFConfig":
        """Parse the reference-compatible flags of these fields; other
        flags are ignored."""
        cfg = FFConfig()
        flags = {
            ("-b", "--batch-size"): ("batch_size", int),
            ("--seed",): ("seed", int),
            ("--compute-dtype",): ("compute_dtype", str),
            ("--embedding-dtype",): ("embedding_dtype", str),
            ("--serve-buckets",): ("serve_buckets", str),
            ("--serve-max-batch",): ("serve_max_batch", int),
            ("--serve-max-wait-us",): ("serve_max_wait_us", float),
            ("--serve-queue-depth",): ("serve_queue_depth", int),
            ("--serve-timeout-us",): ("serve_timeout_us", float),
            ("--serve-quantize",): ("serve_quantize", str),
            ("--serve-storage",): ("serve_storage", str),
        }
        by_flag = {f: v for names, v in flags.items() for f in names}
        argv = list(argv)
        i = 0
        while i < len(argv):
            hit = by_flag.get(argv[i])
            if hit is not None and i + 1 < len(argv):
                field, conv = hit
                setattr(cfg, field, conv(argv[i + 1]))
                i += 1
            i += 1
        return cfg
