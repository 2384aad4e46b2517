"""The epoch row cache's tensor and shape pieces (counterparts of the
closures of the same names in ``dlrm_flexflow_tpu/model.py::compile``,
``:1095-1721``).

An epoch knows all of its ids up front.  The rows they touch are pulled
into a small cache (``build_cache``), every occurrence of a row is given
the one slot of that row (``ops/slotting.py``), the steps gather and
update the cache by slot, and the final rows are set back once
(``cache_writeback``).  The in-graph ladder nests block caches inside the
epoch cache: every ``size`` steps pull their rows from the parent cache
and set them back when the block ends.  Every distinct parent row has one
slot in its block cache, so the same adds hit the same values in the same
order at every level, and a cached epoch equals the uncached one bit for
bit.

The JAX package's view-row transport, packed storage, regions and
first-touch segmentation answer XLA:TPU's layouts and are not carried:
the port's tables and caches hold logical rows, as the JAX package's do
off the TPU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .ops.row_set_kernel import row_set_cuda
from .ops.slotting import slot_rows

# [(block size, {op name: block cache rows}), ...], outermost first
LadderMeta = List[Tuple[int, Dict[str, int]]]


def cache_fetch(parent, rowof, out=None):
    """Rows of the flattened ``parent`` at ``rowof`` (JAX ``_cache_fetch``,
    ``mode="clip"``): a sentinel hole reads the last row, which no slot
    addresses.  Takes a ``(T, R, d)`` table or an ``(R, d)`` cache; fills
    ``out`` (``(len(rowof), d)``) in place when given."""
    flat = parent.reshape(-1, parent.shape[-1])
    return torch.index_select(flat, 0,
                              rowof.long().clamp(0, flat.shape[0] - 1),
                              out=out)


def build_cache(flat, ids, pack: int, out=None):
    """The shared-slot cache of the rows ``ids`` touch in the ``(R, d)``
    source ``flat`` (JAX ``build_cache``, logical-row branch):
    ``(cache, slots, rowof)``, or None when the cache, sized by the
    occurrence count and padded to a multiple of the lane pack, would not
    be smaller than the source.  ``rowof`` is padded with the sentinel
    ``R``, which the fetch clips and the writeback drops.  ``out``, when
    given, maps the cache's row count to the buffer it is fetched
    into."""
    size = ids.numel()
    sentinel = flat.shape[0]
    m = -(-size // pack) * pack
    if m >= flat.shape[0]:
        return None
    rowof, slots = slot_rows(ids, sentinel)
    if m > size:
        rowof = torch.cat([rowof, rowof.new_full((m - size,), sentinel)])
    cache = cache_fetch(flat, rowof, out=None if out is None else out(m))
    return cache, slots, rowof


def cache_writeback(parent, rowof, cache_final):
    """Set the live rows of ``cache_final`` back into ``parent`` in place,
    each once, sentinel holes dropped (JAX ``_cache_writeback``): the
    row-set kernel on the card, ``row_set_ref`` on the CPU.  Every
    ``rowof`` names distinct rows, as the kernel requires.  Returns
    ``parent``."""
    flat = parent.view(-1, parent.shape[-1])
    row_set_cuda(flat, rowof, cache_final.reshape(-1, flat.shape[1]))
    return parent


def named_levels(config) -> Optional[List[int]]:
    """The ladder sizes ``epoch_cache_levels`` names, outermost first:
    None for "auto", ``[]`` for "off" (no ladder), else the comma list."""
    levels = config.epoch_cache_levels
    if levels == "auto":
        return None
    if levels in ("off", "", None):
        return []
    if isinstance(levels, str):
        return [int(s) for s in levels.split(",") if s.strip()]
    return [int(s) for s in levels]


def ladder_sizes(config, nb: int) -> List[int]:
    """Block sizes of the ladder for an ``nb``-step epoch, outermost first
    (JAX ``ladder_sizes`` without regions, which need packed storage).
    "auto" is ``[8 * inner, inner]`` when 8 * inner divides nb, else a
    single ``inner`` level, with a geometric mid level once nb / inner
    exceeds 8; with ``epoch_cache_inner`` <= 1 (or not engaging) a
    chunk-sized level.  Otherwise the sizes ``named_levels`` gives."""
    named = named_levels(config)
    if named is not None:
        return named
    inner = int(config.epoch_cache_inner)
    if 0 < inner < nb:
        top = inner * 8
        if top < nb and nb % top == 0:
            return [top, inner]
        if nb % inner == 0:
            sizes = []
            if nb // inner > 8:
                target = math.isqrt(nb * inner)
                cands = [s for s in range(inner + 1, nb)
                         if nb % s == 0 and s % inner == 0]
                if cands:
                    sizes.append(min(cands, key=lambda s: abs(s - target)))
            sizes.append(inner)
            return sizes
    chunk = int(config.epoch_cache_chunk)
    if 0 < chunk < nb and nb % chunk == 0:
        return [chunk]
    return []


def ladder_meta(config, nb: int, slots_ep, rows0, op_pack) -> LadderMeta:
    """The static ladder plan (JAX ``ladder_meta``): at each level every
    op whose block cache, padded to its lane pack, would be smaller than
    its current parent cache takes part; a level nobody joins is
    dropped."""
    meta, rows, cur = [], dict(rows0), nb
    for size in ladder_sizes(config, nb):
        if not (0 < size < cur and cur % size == 0):
            continue
        part = {}
        for name, sl in slots_ep.items():
            per_step = int(np.prod(sl.shape[1:]))
            pack = op_pack[name]
            m = -(-(size * per_step) // pack) * pack
            if m < rows[name]:
                part[name] = m
        if part:
            meta.append((size, part))
            rows.update(part)
            cur = size
    return meta


def ladder_arrays(slots, meta: LadderMeta, rows):
    """The ladder's slot plans, computed once before any step (JAX
    ``ladder_arrays``; under ``train_epochs`` once for all epochs).  A
    level is ``{"blocks": [{"rowof": {op: (m,)}, "next": level}, ...]}``;
    the innermost carries ``{"slots": {op: (steps, ...)}}``, each op's
    per-step slots into its innermost cache."""
    if not meta:
        return {"slots": slots}
    (size, part), rest = meta[0], meta[1:]
    nb = next(iter(slots.values())).shape[0]
    blocks = []
    for k in range(nb // size):
        rowof_d, slots_d = {}, {}
        for name, s in slots.items():
            b = s[k * size:(k + 1) * size]
            if name not in part:
                slots_d[name] = b
                continue
            rowof, sl = slot_rows(b, rows[name])
            m, n = part[name], b.numel()
            if m > n:
                rowof = torch.cat([rowof, rowof.new_full((m - n,),
                                                         rows[name])])
            rowof_d[name], slots_d[name] = rowof, sl
        blocks.append({"rowof": rowof_d,
                       "next": ladder_arrays(slots_d, rest,
                                             {**rows, **part})})
    return {"blocks": blocks}
