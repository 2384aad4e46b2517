"""Static dispatch gates priced on the H100 (counterpart of
``dlrm_flexflow_tpu/ops/kernel_costs.py``).

The JAX package prices each hand-written kernel against the XLA path
that computes the same values, and the tiered store against streaming
every looked-up row over the host link, with machine constants measured
on its chip.  The port keeps the same functions and the same formulas and
replaces every constant with one measured on an NVIDIA H100 by
``chip_smoke.py`` phase 20(a) (``measure_cost_constants``), which also
prints each gate's decision at the served shapes.  Each constant records
the card and power limit it was read on; a re-measurement updates one
line.

The port launches the row-set kernel (B5) and the fused forward (B3) on
the card unconditionally; ``row_set_wins`` and ``fused_interact_wins``
say where the JAX package's gates would put the flip on this card
(PERF.md lists the shapes).  ``tiered_storage_wins`` is live: the tiered
store's ``tiered_decision`` calls it.  ``exchange_overlap_wins`` is live
too (``ops/overlap_embed.py``), but its two constants, the NVLink rate
and the dense rate, are the H100 SXM data sheet's: a rank-to-rank link
cannot be measured on a machine with one card.  Both are marked
unmeasured.
"""

from __future__ import annotations

#: per-row time of the row-set kernel (ns): B5 installing 2048 missed
#: rows of 256 B into a (32768, 64) f32 hot tier, one launch in a CUDA
#: graph of many (chip_smoke.py phase 20(a); NVIDIA H100 80GB HBM3,
#: 700.00 W).
SET_KERNEL_NS_PER_ROW = 1.6047

#: the library call's rate in the JAX formula's terms (GB/s): 2 x the
#: (8M, 64) f32 parent's bytes over the time of ``index_copy_`` of 2048
#: rows into it.  Not a sweep rate: ``index_copy_`` writes only its rows
#: (0.24 ns a row plus 2.4 us a call between 2048 and 131,072 rows in the
#: same phase), so the JAX ``row_set_wins`` model does not describe it on
#: this card and its answer holds at this one shape only (chip_smoke.py
#: phase 20(a); NVIDIA H100 80GB HBM3, 700.00 W).
EMITTER_SWEEP_GBPS = 1429967.9

#: per-row time of the ``StackedEmbedding`` gather (ns): the slope of a
#: least-squares line through its time at the serving buckets, 8 to 2048
#: rows of 256 B from the (8, 1M, 64) f32 tables.  The line's intercept,
#: the call's fixed cost, is 31.4 us; the formulas charge it to neither
#: side, since both the tiered and the streaming path gather once
#: (chip_smoke.py phase 20(a); NVIDIA H100 80GB HBM3, 700.00 W).
GATHER_NS_PER_ROW = 2.3389

#: rate of a device-to-device ``copy_`` of 64 MiB (GB/s, read + write
#: counted once each), what an intermediate bounced between two ops pays
#: (chip_smoke.py phase 20(a); NVIDIA H100 80GB HBM3, 700.00 W).
HBM_GBPS = 2858.0

#: fixed cost of one more device operation (ns): an empty kernel's
#: launch in a CUDA graph of many (chip_smoke.py phase 20(a); NVIDIA
#: H100 80GB HBM3, 700.00 W).
OP_BOUNDARY_NS = 977.5

#: a kernel must beat the other path by this factor before dispatch
#: flips (a policy, the JAX package's, not a measurement).
DISPATCH_MARGIN = 2.0

#: NVLink bandwidth a GPU sends at in one direction (GB/s): 900 GB/s
#: over both directions of its 18 NVLink 4 links, from NVIDIA's H100
#: Tensor Core GPU data sheet (SXM5); the machine model's
#: ``nvlink_bandwidth`` (sim/cost_model.py), mirrored here because this
#: module sits below sim.  UNMEASURED: the card machine has one card.
NVLINK_GBPS = 450.0

#: effective dense rate of the bottom stack's f64-accumulated GEMMs
#: (FLOP/ns): the data sheet's 67 TFLOP/s FP64 tensor-core rate at the
#: machine model's 60% utilisation.  UNMEASURED (a data-sheet figure).
DENSE_FLOPS_PER_NS = 67e3 * 0.6

#: pinned host-to-device rate of a miss block (GB/s): the slope of a
#: least-squares line through one non_blocking H2D of 1 to 2048 rows of
#: 256 B (chip_smoke.py phase 20(a); NVIDIA H100 80GB HBM3, 700.00 W).
HOST_LINK_GBPS = 54.88

#: fixed cost of starting that copy (ns): the same line's intercept
#: (chip_smoke.py phase 20(a); NVIDIA H100 80GB HBM3, 700.00 W).
HOST_LINK_LATENCY_NS = 2941.6


def row_set_wins(parent_rows: int, dim: int, n: int,
                 itemsize: int) -> bool:
    """The JAX package's gate for the row-set kernel against the library
    path: the kernel pays ``SET_KERNEL_NS_PER_ROW`` a row (times the
    margin), the library path a sweep of the parent at
    ``EMITTER_SWEEP_GBPS``.  ``n`` is the padded row count."""
    kernel_ns = n * SET_KERNEL_NS_PER_ROW * DISPATCH_MARGIN
    sweep_ns = parent_rows * dim * itemsize * 2.0 / EMITTER_SWEEP_GBPS
    return kernel_ns < sweep_ns


def fused_interact_wins(batch: int, num_tables: int, bag: int, dim: int,
                        itemsize: int, interact: str = "cat") -> bool:
    """The JAX package's gate for the fused embedding-bag->interaction
    kernel against the unfused chain (gather -> pool -> reshape/concat
    [-> batched matmul -> flat -> concat]).

    Kernel: ``SET_KERNEL_NS_PER_ROW`` per looked-up row, times the
    margin.  Chain: the gather (``GATHER_NS_PER_ROW`` a row), the pooled
    ``(batch, num_tables, dim)`` intermediate written and read at
    ``HBM_GBPS`` (for ``dot`` also the ``(batch, F, F)`` product), and
    ``OP_BOUNDARY_NS`` per operation boundary (3 for ``cat``, 5 for
    ``dot``)."""
    rows = batch * num_tables * bag
    kernel_ns = rows * SET_KERNEL_NS_PER_ROW * DISPATCH_MARGIN
    inter_bytes = 2.0 * batch * num_tables * dim * itemsize
    boundaries = 3
    if interact == "dot":
        f = num_tables + 1
        inter_bytes += 2.0 * batch * f * f * itemsize
        boundaries = 5
    emitter_ns = (rows * GATHER_NS_PER_ROW
                  + inter_bytes / HBM_GBPS
                  + boundaries * OP_BOUNDARY_NS)
    return kernel_ns < emitter_ns


def exchange_overlap_wins(local_batch: int, num_tables: int, dim: int,
                          itemsize: int, model_parallel: int,
                          dense_flops: int, microbatches: int,
                          mode: str = "allgather") -> bool:
    """The JAX package's gate for the microbatched exchange/compute
    pipeline (``parallel/overlap.py``) against the serial exchange.

    The pipeline hides ``min(exchange, dense)`` of the step behind the
    other rail, but K microbatches cost K-1 more collective launches and
    K-1 more dense launches, each ``OP_BOUNDARY_NS``.  Overlap wins when
    the hidden time beats that added cost by ``DISPATCH_MARGIN``.
    ``local_batch`` is the per-data-shard batch (the rows one exchange
    moves); ``dense_flops`` the bottom stack's forward FLOPs at that
    batch.  K = 1 and a single model rank never overlap."""
    mp = max(int(model_parallel), 1)
    k = max(int(microbatches), 1)
    if mp <= 1 or k <= 1:
        return False
    ex_bytes = float(local_batch) * num_tables * dim * itemsize
    if mode == "all_to_all":
        ex_bytes /= mp  # each rank exchanges ~1/mp of allgather's bytes
    ex_ns = ex_bytes * (mp - 1) / mp / NVLINK_GBPS
    dense_ns = float(dense_flops) / DENSE_FLOPS_PER_NS
    hidden_ns = min(ex_ns, dense_ns)
    boundary_ns = 2.0 * (k - 1) * OP_BOUNDARY_NS
    return hidden_ns > DISPATCH_MARGIN * boundary_ns


def tiered_storage_wins(num_rows: int, dim: int, itemsize: int,
                        hot_rows: int, lookups: int,
                        hit_rate: float) -> bool:
    """The gate for the tiered embedding store (``storage/tiered.py``)
    against streaming every looked-up row over the host link.

    Tiered, per dispatch: every lookup gathers from the hot tier
    (``GATHER_NS_PER_ROW``), and the predicted ``(1 - hit_rate) *
    lookups`` misses pay one link latency, then each its bytes over the
    link and the row-set kernel's install.  Streaming: the link latency,
    then every lookup its bytes over the link and the gather.

    Refusals by construction, as in the JAX package: a table that fits
    the budget (``hot_rows >= num_rows``); a budget below one batch's
    worst-case working set (``hot_rows < lookups``); and, through the 2x
    margin, traffic without skew."""
    if hot_rows >= num_rows:
        return False  # fits on device: resident always wins
    if lookups <= 0 or hot_rows <= 0:
        return False
    if hot_rows < lookups:
        return False  # cannot pin one batch's worst-case working set
    hit = min(max(float(hit_rate), 0.0), 1.0)
    row_link_ns = float(dim) * itemsize / HOST_LINK_GBPS
    misses = (1.0 - hit) * lookups
    tiered_ns = lookups * GATHER_NS_PER_ROW
    if misses > 0:
        tiered_ns += HOST_LINK_LATENCY_NS \
            + misses * (row_link_ns + SET_KERNEL_NS_PER_ROW)
    stream_ns = HOST_LINK_LATENCY_NS \
        + lookups * (row_link_ns + GATHER_NS_PER_ROW)
    return tiered_ns * DISPATCH_MARGIN < stream_ns
