"""Runtime configuration and CLI flag parsing.

Counterpart of ``dlrm_flexflow_tpu/config.py``: the same field names,
defaults and flags for the fields the serving and training slices (the
staged epoch and its row cache included) read.
The other fields arrive with the slices that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class FFConfig:
    epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    # per-op matmul precision: "bfloat16" = bf16 operands, f32 accumulation
    compute_dtype: str = "float32"
    # embedding-table storage dtype (the port's tables are float32)
    embedding_dtype: str = "float32"
    # Row-sparse embedding updates under plain SGD ("auto"|"on"|"off"):
    # gather the looked-up rows outside autograd, differentiate with
    # respect to those rows, and add -lr * row_grad back into the table
    # in place (the row-update kernel).  "off" trains through the dense
    # table gradient.
    sparse_embedding_updates: str = "auto"
    # Epoch row cache ("auto"|"on"|"off"): train_epoch(s) pull the rows
    # the epoch's ids touch into a small cache, step against the cache
    # by slot, and write the final rows back once (model.py,
    # epoch_cache.py).  The same adds hit the same values in the same
    # order, so the result is bit-identical to the uncached epoch.
    # "auto" engages for tables on the CUDA card and stays off on the CPU;
    # "on" forces it on any device; "off" disables it.  Here the port
    # departs from the JAX package, whose "auto" engages on the TPU only
    # (its CPU/GPU scatter is already per row): on the card the cache is
    # the training CLI's path, so the row-set kernel runs on it (PERF.md
    # section 7 names the workload that must show it paying).
    epoch_row_cache: str = "auto"
    # Scan steps per dispatched chunk when the cache is active and no
    # ladder level divides the epoch (0 disables chunking); with
    # epoch_cache_inner <= 1 it also sizes a single ladder level.
    epoch_cache_chunk: int = 256
    # The innermost ladder level: every epoch_cache_inner steps pull their
    # rows from the parent cache into a block cache (0 disables).
    epoch_cache_inner: int = 8
    # Ladder shape: "auto", "off" (no in-graph levels) or explicit block
    # sizes, outermost first ("16,8").
    epoch_cache_levels: str = "auto"
    # fit() stages an array-backed, unshuffled, drop_last dataset of at
    # most this many bytes on the device and trains it by whole epochs
    # (0 keeps every fit on the per-batch loop)
    fit_scan_max_bytes: int = 2 * 1024 * 1024 * 1024
    # inter-op activation storage dtype (float32 only in the port)
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
    # "off" only in the port so far (quantized tables come later)
    serve_quantize: str = "off"
    # "resident" only in the port so far (tiered storage comes later)
    serve_storage: str = "resident"
    seed: int = 0

    @staticmethod
    def parse_args(argv: Sequence[str]) -> "FFConfig":
        """Parse the reference-compatible flags of these fields; other
        flags are ignored."""
        cfg = FFConfig()
        flags = {
            ("-e", "--epochs"): ("epochs", int),
            ("-b", "--batch-size"): ("batch_size", int),
            ("--lr", "--learning-rate"): ("learning_rate", float),
            ("--wd", "--weight-decay"): ("weight_decay", float),
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
            ("--epoch-row-cache",): ("epoch_row_cache", str),
            ("--fit-scan-max-bytes",): ("fit_scan_max_bytes", int),
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
