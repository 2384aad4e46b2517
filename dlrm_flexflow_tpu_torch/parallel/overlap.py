"""The overlapped embedding exchange: a microbatched comm/compute pipeline
(counterpart of ``dlrm_flexflow_tpu/parallel/overlap.py``).

The table-parallel exchange and the bottom MLP are dataflow-independent,
yet one monolithic collective leaves nothing to hide it behind.  This
module splits the rank's batch into K microbatches and pipelines them at
lag 1: microbatch k's exchange is issued, then microbatch k's slice of
the bottom MLP computes, then the next microbatch's lookup and exchange.
On the card the collectives are NCCL kernels on the communicator's
stream, so microbatch k's exchange can run beside microbatch k's dense
slice; on the CPU (gloo) the collectives are synchronous and the
pipeline only changes the order.  The values differ from the serial
exchange's only by the reordered sums (tests hold them at rtol 1e-5).

Both exchange modes pipeline:

- ``allgather``: microbatch i is a contiguous batch slice, and
  concatenating the exchanged slices restores the serial row order;
- ``all_to_all``: each rank keeps only its batch-chunk of every
  microbatch, so microbatch i takes sub-slice i of each of the mp chunks
  (a strided split), and the rank's concatenated output is the
  contiguous rows the serial all-to-all emits.

The arguments are the rank's blocks (``parallel/table_exchange.py``).
"""

from __future__ import annotations

import torch

from .collectives import all_gather, all_to_all
from .mesh import DATA_AXIS, MODEL_AXIS
from .table_exchange import _local_lookup, _rank_ids


def microbatch_ok(local_batch: int, mp: int, microbatches: int,
                  mode: str) -> bool:
    """Whether the per-data-shard batch admits a K-way pipeline: every
    microbatch must be equal-sized, and ``all_to_all`` additionally
    chunks each microbatch mp ways (the strided split above)."""
    k = int(microbatches)
    if k <= 1 or local_batch <= 0:
        return False
    if mode == "all_to_all":
        return local_batch % (mp * k) == 0
    return local_batch % k == 0


def overlapped_embed_bottom(tables, ids, dense_in, mesh, dense_fn,
                            dense_params, aggr: str = "sum",
                            mode: str = "allgather",
                            microbatches: int = 2, qscale=None):
    """Pipelined table-parallel lookup and bottom-MLP compute.

    ``tables`` the rank's (T/mp, R, d) block; ``ids`` its (B/dp, T, bag)
    data shard; ``dense_in`` its (B/dp, f) data shard of the bottom MLP's
    input; ``dense_fn(dense_params, x)`` the dense stack on one microbatch
    slice ((n, f) -> (n, bot_out)); ``qscale`` the rank's block of an int8
    table's flat (T*R, 1) scale column (rows dequantized before the
    exchange).

    Returns ``(emb, bottom)``, the rank's blocks of the serial path's
    outputs: ``emb`` (B, T, d) and ``bottom`` (B, bot_out), batch-sharded
    over "data" (``allgather``) or over ("data", "model")
    (``all_to_all``)."""
    assert mode in ("allgather", "all_to_all")
    mp = mesh.shape.get(MODEL_AXIS, 1)
    k = int(microbatches)
    assert mp > 1, "overlap needs a model axis to exchange over"
    t = tables.shape[0] * mp
    assert t % mp == 0, f"{t} tables over {mp} model ranks"
    ids_loc = _rank_ids(tables, ids, mesh)
    b_loc = ids_loc.shape[0]
    exchanged, bottoms = [], []
    if mode == "allgather":
        mb = b_loc // k
        # lag-1 pipeline: mb i's exchange, then mb i's dense slice
        for i in range(k):
            look = _local_lookup(tables, ids_loc[i * mb:(i + 1) * mb], aggr,
                                 qscale=qscale)
            exchanged.append(all_gather(look, mesh, (MODEL_AXIS,), dim=1))
            bottoms.append(dense_fn(dense_params,
                                    dense_in[i * mb:(i + 1) * mb]))
        return torch.cat(exchanged, 0), torch.cat(bottoms, 0)

    dp = mesh.shape.get(DATA_AXIS, 1)
    b = ids.shape[0] * dp
    assert (b // max(dp, 1)) % (mp * k) == 0, (
        f"all_to_all overlap needs the per-data-shard batch "
        f"({b}//{dp}) divisible by model axis * microbatches "
        f"({mp}*{k})")
    j = mesh.axis_index((MODEL_AXIS,))
    csz = b_loc // mp          # the chunk each rank keeps
    ssz = csz // k             # one microbatch's share of a chunk
    # strided split: mb i = sub-slice i of each of the mp chunks
    ids_r = ids_loc.reshape(mp, k, ssz, *ids_loc.shape[1:])
    for i in range(k):
        ids_mb = ids_r[:, i].reshape(mp * ssz, *ids_loc.shape[1:])
        look = _local_lookup(tables, ids_mb, aggr, qscale=qscale)
        exchanged.append(all_to_all(look, mesh, (MODEL_AXIS,), split_dim=0,
                                    concat_dim=1))          # (ssz, T, d)
        lo = j * csz + i * ssz
        bottoms.append(dense_fn(dense_params, dense_in[lo:lo + ssz]))
    return torch.cat(exchanged, 0), torch.cat(bottoms, 0)
