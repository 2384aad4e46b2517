"""Runtime configuration and CLI flag parsing.

Counterpart of ``dlrm_flexflow_tpu/config.py``: the same field names,
defaults and flags for the fields the serving and training slices (the
staged epoch and its row cache included), the durability slice
(``prefetch_depth``, ``faults``) and tiered storage
(``serve_storage``, ``storage_hot_rows``) read.
The other fields arrive with the slices that read them.

The SOAP fields (``num_devices``, ``search_*`` and the strategy files)
are the JAX package's, read by ``FFModel.compile`` and the search.

``iterations`` and ``simulator_work_space_size`` are accepted and read
nowhere, as in the JAX package.  The TPU lane-layout switches
(``packed_tables``, ``epoch_cache_view``, ``epoch_cache_segmented``,
``epoch_cache_regions``) are validated where the JAX package validates
them and change no value on Hopper: the port stores every table as its
logical ``(R, d)`` and has no packed view, segmented slots or region
plans (the JAX ``(R/pack, 128)`` storage answers the TPU's lane tiling).

Only ``epochs`` and ``batch_size`` are positional, in the JAX order.
Every later field is keyword-only: the port orders some of its fields
differently from the JAX class, so a positional call written for the JAX
class would bind its values to other fields here; it raises instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

#: the table storage dtypes ``embedding_dtype`` takes
EMBEDDING_DTYPES = ("float32", "bfloat16")
#: the TPU lane-layout switches: validated, no effect on Hopper
LAYOUT_FIELDS = ("packed_tables", "epoch_cache_view",
                 "epoch_cache_segmented", "epoch_cache_regions")


@dataclasses.dataclass
class FFConfig:
    epochs: int = 1
    batch_size: int = 64
    _: dataclasses.KW_ONLY
    # the reference's iterations and simulator work space (config.h:65-103,
    # :95): accepted, read nowhere (as in the JAX package)
    iterations: int = 1
    simulator_work_space_size: int = 2 * 1024 * 1024 * 1024
    # SOAP: the device count the search and the strategy target (None:
    # every visible CUDA card, resolved_num_devices), the MCMC budget and
    # temperature (search_budget > 0 searches at compile), the simulated
    # weight sync overlapped with backward, and the strategy files
    # imported at compile or exported after a search (.json or .pb)
    num_devices: Optional[int] = None
    # the mesh compile builds on its own when the process group holds
    # more than one rank and no mesh is given (parallel/mesh.py
    # make_mesh; None: every rank on "data"), e.g. {"data": 4, "model": 2}
    mesh_shape: Optional[dict] = None
    search_budget: int = 0
    search_alpha: float = 0.05
    search_overlap_backward_update: bool = False
    import_strategy_file: Optional[str] = None
    export_strategy_file: Optional[str] = None
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    # per-op matmul precision: "bfloat16" = bf16 operands, f32 accumulation
    compute_dtype: str = "float32"
    # per-op forward timing printed after fit (the reference's
    # --profiling; profiling.OpTimer)
    profiling: bool = False
    # embedding-table storage dtype (EMBEDDING_DTYPES): bf16 tables halve
    # the table bytes and train through the row-update, bag and row-set
    # kernels on bf16 storage
    embedding_dtype: str = "float32"
    # Row-sparse embedding updates under plain SGD, or an optimizer with
    # lazy_embeddings=True ("auto"|"on"|"off"): gather the looked-up rows
    # outside autograd, differentiate with respect to those rows, and
    # add the rows' step back into the table in place (the row-update
    # kernel).  "off" trains through the dense table gradient.
    sparse_embedding_updates: str = "auto"
    # Epoch row cache ("auto"|"on"|"off"): train_epoch(s) pull the rows
    # the epoch's ids touch into a small cache, step against the cache
    # by slot, and write the final rows back once (model.py,
    # epoch_cache.py).  The same adds hit the same values in the same
    # order, so the result is bit-identical to the uncached epoch.
    # "auto" is off on the CUDA card and on the CPU, as the JAX package's
    # "auto" is off the TPU: on an H100 the staged cached epoch ran slower
    # than the uncached one (PERF.md, section 7).  "on" forces the cache
    # on any device; "off" disables it.
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
    # The JAX package's TPU lane-layout switches ("auto"|"on"|"off"; its
    # lane-packed (R/pack, 128) tables, the view-row cache transport,
    # first-touch-segmented slots and block-major cache regions).
    # Validated as the JAX package validates them, and no value changes
    # on Hopper, where a table is its logical (R, d) and a cached row is
    # a logical row.
    packed_tables: str = "auto"
    epoch_cache_view: str = "auto"
    epoch_cache_segmented: str = "auto"
    epoch_cache_regions: str = "auto"
    # fit() stages an array-backed, unshuffled, drop_last dataset of at
    # most this many bytes on the device and trains it by whole epochs
    # (0 keeps every fit on the per-batch loop)
    fit_scan_max_bytes: int = 2 * 1024 * 1024 * 1024
    # Inter-op activation storage dtype ("float32"|"bfloat16").
    # "bfloat16" declares every intermediate f32 output tensor bf16 at
    # compile (ops emit their declared dtype; each consumer casts to its
    # compute dtype), halving the bytes between ops.  The final output and
    # the loss input stay f32, so losses and metrics keep their dtype.
    # Batch norm's statistics and average pooling's sums stay f32.
    # Orthogonal to compute_dtype; the loss trajectory tracks the
    # f32-activation run within a tolerance, not bit for bit.
    activation_dtype: str = "float32"
    # Manual table-parallel exchange for StackedEmbedding under a mesh
    # ("off"|"allgather"|"all_to_all"): each model rank looks up its own
    # tables and one explicit collective exchanges the pooled rows
    # (parallel/table_exchange.py).  Dense-path only (the row-sparse path
    # is off for an exchanged op).  "off": the table-sharded lookup
    # gathers its output over "model" as the op's layout asks.
    table_exchange: str = "off"
    # Asynchronous input prefetch for fit's per-batch loops
    # (data/prefetch.py): a worker thread slices and places the next
    # prefetch_depth batches on the device while the current step runs.
    # 0 = the synchronous loop.  The numbers are bit-identical either way,
    # and a checkpoint's loader cursor stays the last batch consumed.
    prefetch_depth: int = 0
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
    # serving-table quantization at InferenceEngine load (ops/quantized.py):
    # "off" serves the training tables as they are, "int8" as int8 codes
    # plus a per-row f32 scale, "bf16" as bf16 rows; training is untouched
    serve_quantize: str = "off"
    # Tiered embedding storage (storage/): "resident" serves whole tables
    # on the card; "tiered" keeps the hottest storage_hot_rows rows of
    # each table on the card and the rest in host memory, streaming
    # misses in.  The storage/tiered.py gate may still refuse and serve
    # resident (InferenceEngine.storage records why); quantize and
    # tiering are mutually exclusive.
    serve_storage: str = "resident"
    storage_hot_rows: int = 4096
    # port of the process-wide Prometheus /metrics + /healthz endpoint
    # (telemetry/exporter.py), started once by FFModel.compile; 0 = off
    metrics_port: int = 0
    # Fault-injection spec (resilience/faultinject.py), e.g.
    # "nan_grads@step=3,preempt@step=7": drives the recovery paths end to
    # end; also settable via the FF_FAULTS environment variable.  Empty =
    # no injected faults.
    faults: str = ""
    seed: int = 0

    @staticmethod
    def parse_args(argv: Sequence[str]) -> "FFConfig":
        """Parse the reference-compatible flags of these fields; other
        flags are ignored."""
        cfg = FFConfig()
        flags = {
            ("-e", "--epochs"): ("epochs", int),
            ("-b", "--batch-size"): ("batch_size", int),
            ("-i", "--iterations"): ("iterations", int),
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
            ("--storage-hot-rows",): ("storage_hot_rows", int),
            ("--epoch-row-cache",): ("epoch_row_cache", str),
            ("--fit-scan-max-bytes",): ("fit_scan_max_bytes", int),
            ("--metrics-port",): ("metrics_port", int),
            ("--prefetch",): ("prefetch_depth", int),
            ("--faults",): ("faults", str),
            ("--budget", "--search-budget"): ("search_budget", int),
            ("--alpha", "--search-alpha"): ("search_alpha", float),
            ("--import",): ("import_strategy_file", str),
            ("--export",): ("export_strategy_file", str),
            # the reference's -ll:gpu N: N workers; here the device count
            ("-d", "--devices", "-ll:gpu"): ("num_devices", int),
        }
        switches = {"--profiling": "profiling",
                    "--overlap": "search_overlap_backward_update"}
        by_flag = {f: v for names, v in flags.items() for f in names}
        argv = list(argv)
        i = 0
        while i < len(argv):
            if argv[i] in switches:
                setattr(cfg, switches[argv[i]], True)
            hit = by_flag.get(argv[i])
            if hit is not None and i + 1 < len(argv):
                field, conv = hit
                setattr(cfg, field, conv(argv[i + 1]))
                i += 1
            i += 1
        return cfg

    def resolved_num_devices(self) -> int:
        """``num_devices``, else the CUDA cards visible, else 1."""
        if self.num_devices is not None:
            return self.num_devices
        import torch

        if torch.cuda.is_available():
            return torch.cuda.device_count()
        return 1
