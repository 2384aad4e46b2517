"""Sort-position slot assignment for the epoch row cache (counterpart of
``dlrm_flexflow_tpu/ops/slotting.py::slot_rows``).

Every id occurrence of an epoch (or of a ladder block) gets a cache slot
such that all occurrences of one row share ONE slot, so cross-step
updates stay coherent, and ``rowof`` maps each slot back to its row for
the cache fill and the writeback.  The cache is sized by the occurrence
count n, so the ranks come from sorts alone:

  s, perm = sort(ids)                  # keys and their positions
  flag[k] = s[k] != s[k-1]             # run starts
  rank    = cumsum(flag) - 1           # dense rank of position k's run
  slots   = rank in original order     # slots[perm] = rank
  rowof   = sort(where(flag, s, sentinel))
                                       # distinct rows ascending, then
                                       # the sentinel holes

``rowof`` is non-decreasing: distinct rows first, then the sentinel.
The JAX package's region and first-touch-segmented planners serve its
packed table storage only, which the port does not carry.
"""

from __future__ import annotations

import torch


def slot_rows(ids, num_rows: int):
    """``(rowof, slots)`` for ``ids`` over the row space ``[0, num_rows)``.

    ``rowof``: ``(n,)`` int32, n = ``ids.numel()``; ``rowof[p]`` is the
    row cached in slot p for p below the distinct count, else the
    sentinel ``num_rows``.  ``slots``: ``ids.shape`` int32, the slot of
    each occurrence, with ``rowof[slots] == ids`` everywhere.  Requires
    ``0 <= ids < num_rows``.  Every result is an integer and equals the
    JAX package's bit for bit."""
    flat = ids.reshape(-1).long()
    n = flat.numel()
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=ids.device)
        return empty, empty.reshape(ids.shape)
    s, perm = torch.sort(flat, stable=True)
    flag = torch.ones(n, dtype=torch.bool, device=flat.device)
    flag[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(flag, 0) - 1
    slots = torch.empty_like(rank).scatter_(0, perm, rank)
    rowof = torch.sort(torch.where(flag, s, torch.full_like(s, num_rows)))[0]
    return rowof.to(torch.int32), slots.to(torch.int32).reshape(ids.shape)
