"""The manual table-parallel embedding exchange (counterpart of
``dlrm_flexflow_tpu/parallel/table_exchange.py``).

Each model rank owns T/mp whole stacked tables (the reference pins each
table to one device and exchanges at the interaction point,
dlrm_strategy.cc:242-296), looks them up for its data shard of the batch,
and one explicit collective exchanges the pooled rows:

- ``mode="allgather"``: one all-gather over ``"model"`` assembles the
  ``(B/dp, T, d)`` interaction input on every model rank (replicated over
  ``"model"``, the layout the data-parallel MLPs consume);
- ``mode="all_to_all"``: the exchange swaps table-chunks for batch-chunks,
  so each rank ends with all T tables for ``B/(dp*mp)`` rows: the output
  is batch-sharded over both axes, and each rank moves about 1/mp of the
  all-gather's bytes.

The arguments are the rank's blocks, as the JAX ``shard_map`` body sees
them: ``tables`` the rank's ``(T/mp, R, d)`` tables, ``ids`` its data
shard ``(B/dp, T, bag)``.  The backward is the mirrored exchange (a
reduce-scatter, the inverse all-to-all: ``parallel/collectives.py``).
"""

from __future__ import annotations

import torch

from ..ops.embedding import pool, take_rows
from .collectives import all_gather, all_to_all
from .mesh import DATA_AXIS, MODEL_AXIS


def _local_lookup(tables, ids, aggr, qscale=None):
    """(T_loc, R, d) x (B_loc, T_loc, bag) -> (B_loc, T_loc, d).

    ``qscale`` (T_loc*R, 1) f32: this rank's slice of a per-row
    quantization scale column (``ops/quantized.py`` int8 serving tables):
    the gathered rows dequantize here, before the exchange, so f32 rows
    ride the collective and the int8 table is never expanded.  None =
    plain tables (training)."""
    t, r, d = tables.shape
    flat = tables.reshape(t * r, d)
    gids = ids + (torch.arange(t, dtype=ids.dtype,
                               device=ids.device)[:, None] * r)
    rows = take_rows(flat, gids)                 # (B, T_loc, bag, d)
    if qscale is not None:
        rows = rows.float() * take_rows(qscale, gids)
    return pool(rows, "avg" if aggr == "avg" else "sum", 2)


def qscale_operand(qscale, t: int, r: int):
    """The JAX package's qscale threading contract: the flat (T*R, 1)
    scale column rides as a (T, R, 1) view with the tables' sharding, so
    a rank's block is its tables' rows.  Returns ``(extra_in_specs,
    extra_args)``, both empty without a scale.  The port's bodies take
    the rank's block of the column; this is the JAX view for a caller
    that holds the global column."""
    if qscale is None:
        return (), ()
    from .mesh import PartitionSpec
    return (PartitionSpec(MODEL_AXIS, None, None),), (qscale.reshape(t, r, 1),)


def rank_qscale(qs):
    """Body-side twin of :func:`qscale_operand`: the tuple holding this
    rank's (T_loc, R, 1) block -> the flat (T_loc*R, 1) column, or
    None."""
    return qs[0].reshape(-1, 1) if qs else None


def _rank_ids(tables, ids, mesh):
    """This model rank's tables' columns of ``ids``."""
    mp = mesh.shape.get(MODEL_AXIS, 1)
    t_loc = tables.shape[0]
    t = t_loc * mp
    assert ids.shape[1] == t, f"{ids.shape[1]} tables over {mp} model ranks"
    j = mesh.axis_index((MODEL_AXIS,))
    return ids[:, j * t_loc:(j + 1) * t_loc]


def table_parallel_lookup(tables, ids, mesh, aggr: str = "sum",
                          mode: str = "allgather", qscale=None):
    """Bagged lookup of model-axis-sharded stacked tables with an explicit
    exchange.

    ``tables``: the rank's (T/mp, R, d) block of the tables sharded
    P("model", None, None).  ``ids``: the rank's (B/dp, T, bag) block of
    the ids, batch-sharded over "data".  Returns the rank's block of the
    (B, T, d) output: batch-sharded over "data" and replicated over
    "model" for ``allgather``; sharded over ("data", "model") on the
    batch dim for ``all_to_all``.

    ``qscale``: the rank's (T/mp*R, 1) block of the flat f32 per-row
    scale of an int8-quantized table (``ops/quantized.py``): each rank
    dequantizes its gathered rows before the exchange.  Quantized ids
    follow the in-table clamp contract (callers clamp to [0, R))."""
    assert mode in ("allgather", "all_to_all")
    mp = mesh.shape.get(MODEL_AXIS, 1)
    if mp == 1:  # no table axis to exchange over
        return _local_lookup(tables, ids, aggr, qscale=qscale)
    t = tables.shape[0] * mp
    assert t % mp == 0, f"{t} tables over {mp} model ranks"
    ids_loc = _rank_ids(tables, ids, mesh)
    out_loc = _local_lookup(tables, ids_loc, aggr, qscale=qscale)
    if mode == "allgather":
        # every model rank assembles all table-chunks (the interaction
        # input is consumed data-parallel)
        return all_gather(out_loc, mesh, (MODEL_AXIS,), dim=1)
    dp = mesh.shape.get(DATA_AXIS, 1)
    b = ids.shape[0] * dp
    assert (b // max(dp, 1)) % mp == 0, (
        f"all_to_all exchange needs the per-data-shard batch "
        f"({b}//{dp}) divisible by the model axis ({mp})")
    # swap table-chunks for batch-chunks: each rank then holds all tables
    # for B_loc/mp rows
    return all_to_all(out_loc, mesh, (MODEL_AXIS,), split_dim=0,
                      concat_dim=1)
