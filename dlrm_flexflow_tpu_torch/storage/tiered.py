"""Two-tier embedding tables: hot rows on the card, cold rows in host
memory (counterpart of ``dlrm_flexflow_tpu/storage/tiered.py``).

DLRM id traffic is power-law: a small hot head takes almost every
lookup.  :class:`TieredEmbeddingTable` keeps that head resident on the
card and streams the misses in.

* **Hot tier**: ONE fixed ``(H_total, dim)`` tensor on the device,
  holding up to ``hot_rows`` rows per table in contiguous per-table
  regions at ``hot_off[t]`` (viewed ``(T, slots, dim)`` for a stacked
  table).  It is written in place and never reallocated, because the
  serving engine's CUDA graphs read it by address.  Lookups are remapped
  id -> slot on the host, and the unchanged forward gathers from the hot
  tier exactly as it would from a resident table: the same rows, the same
  bits.
* **Cold tier**: the full table in host memory (numpy), the ground truth
  for every row.  Misses are admitted by copying cold rows up; dirty rows
  (sparse training updates) are written back on eviction.  numpy has no
  bf16 without ``ml_dtypes``, which the card's machine lacks, so a bf16
  table's cold tier holds its 16-bit patterns as ``uint16``: staging and
  writeback move the same bytes, and the rows cross to torch as bf16
  views of them.

A miss block is installed in three steps, all on the caller's current
stream: the missed cold rows (and their hot slots) are gathered on the
host into a pinned staging buffer, one ``non_blocking`` host-to-device
copy moves them, and the row-set kernel (``ops/row_set_kernel.py``,
the hot slots are distinct) writes them into the hot tier.  A staging
buffer is rewritten only after its copy's CUDA event has completed (two
alternate).  Dirty rows update in place through the row-update kernel,
and a writeback is one device-to-host copy of the dirty slots.  On the
CPU the same steps run the kernels' plain versions on CPU tensors.

Where the JAX store swaps functional copies of the hot buffer, so that a
captured buffer stays consistent while other threads evict, the port's
store writes in place: a caller that reads the hot tier after a remap
must enqueue that read before another remap's install.  The serving
engine does so by holding one lock across remap, install, graph replay
and output copy (``serving/engine.py``).

The miss stall is the device time of the copy and the install, taken
from a pair of CUDA events and read after the caller's own fence
(``_note``), so timing adds no synchronisation on the serving path.  The
store sets ``dlrm_embed_cache_hit_pct`` and
``dlrm_embed_cache_miss_stall_us`` and emits its ``storage`` events
(``miss``, ``evict``, ``admit``) outside its lock, as the JAX store
does.

Admission and eviction are pluggable (``policy.py``): LFU over the
row-frequency counters by default.  Whether tiering pays at all is priced
by ``ops/kernel_costs.py::tiered_storage_wins`` through
:func:`tiered_decision`, with the JAX package's ``FF_TIERED_STORAGE``
override (``auto`` | ``on`` | ``off``).

Tables are f32 or bf16 on the card (f16 and f64 too on the CPU).  A
bf16 table's update follows the JAX store's ``.at[].add`` of
``bfloat16(scale) * grads``: bf16 grads round the product and every add
to bf16 (the row-update kernel on the hot tier); f32 grads are added in
f32 and each touched row rounds once (the row-update kernel on an f32
copy of the touched rows, then the row-set kernel puts them back).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.embedding import take_rows
from ..ops.row_set_kernel import row_set_cuda
from ..ops.row_update_kernel import row_update_cuda
from ..telemetry import emit
from ..telemetry import metrics as _metrics
from ..telemetry import rowfreq
from .policy import EvictionPolicy, make_policy


class StorageError(RuntimeError):
    """A tiered-storage invariant was violated (id out of range, or a
    single batch's working set exceeds the hot tier)."""


def storage_override() -> str:
    """``FF_TIERED_STORAGE`` = ``auto`` (cost gate decides, default),
    ``on`` (skip the gate; structural checks still apply), ``off``
    (always fully-resident)."""
    v = os.environ.get("FF_TIERED_STORAGE", "auto").strip().lower()
    return v if v in ("auto", "on", "off") else "auto"


def default_table_keys(name: str, tables: int) -> List[str]:
    """RowFreqCounter keys for the sparse input ``name``: per-table
    ``name[t]`` streams when the input carries a table axis, the bare
    input name otherwise (``telemetry/rowfreq.py::_tables``)."""
    if tables > 1:
        return [f"{name}[{t}]" for t in range(tables)]
    return [name]


def predicted_hit_rate(table_keys: Sequence[str],
                       rows_per_table: Sequence[int],
                       hot_per_table: Sequence[int]
                       ) -> Tuple[float, bool]:
    """(predicted hit rate, any observed traffic) for the gate: per
    table, the share of everything its RowFreqCounter saw that landed in
    the hottest ``h`` ids; without observed traffic the uniform floor
    ``h / rows`` (which the gate refuses: a cache wins only on skew it
    has evidence for)."""
    rates: List[float] = []
    observed = False
    for key, rows, h in zip(table_keys, rows_per_table, hot_per_table):
        head, seen = rowfreq.head_mass(key, h)
        if seen > 0:
            rates.append(head / seen)
            observed = True
        else:
            rates.append(min(1.0, h / max(1, rows)))
    if not rates:
        return 0.0, False
    return sum(rates) / len(rates), observed


def tiered_decision(*, num_rows: int, dim: int, itemsize: int,
                    hot_rows: int, lookups: int,
                    hit_rate: float) -> Tuple[bool, str]:
    """Should this table serve tiered?  Applies the FF_TIERED_STORAGE
    override, the fits-in-budget short circuit, and the
    kernel_costs.tiered_storage_wins price."""
    mode = storage_override()
    if mode == "off":
        return False, "disabled by FF_TIERED_STORAGE=off"
    if hot_rows >= num_rows:
        return False, "table fits the hot budget — staying resident"
    if mode == "on":
        return True, "forced by FF_TIERED_STORAGE=on"
    from ..ops.kernel_costs import tiered_storage_wins
    if tiered_storage_wins(num_rows=num_rows, dim=dim,
                           itemsize=itemsize, hot_rows=hot_rows,
                           lookups=lookups, hit_rate=hit_rate):
        return True, (f"cost gate: predicted hit rate {hit_rate:.2f} "
                      "beats streaming every row")
    return False, (f"cost gate: predicted hit rate {hit_rate:.2f} "
                   "loses — staying resident")


class _Tier:
    """One table's slot bookkeeping inside the shared hot tier."""

    __slots__ = ("rows", "base", "hot_off", "slots", "slot_of",
                 "id_at", "free", "policy", "key")

    def __init__(self, rows: int, base: int, hot_off: int, slots: int,
                 policy: EvictionPolicy, key: str):
        self.rows = rows          # cold rows this table owns
        self.base = base          # this table's first cold flat row
        self.hot_off = hot_off    # this table's first global hot slot
        self.slots = slots        # hot slots budgeted to this table
        self.slot_of: Dict[int, int] = {}   # id -> local slot
        self.id_at = np.full(slots, -1, dtype=np.int64)
        self.free = list(range(slots - 1, -1, -1))  # pop() -> 0,1,2…
        self.policy = policy
        self.key = key            # RowFreqCounter name


class _Stage:
    """A pinned staging buffer and the event of its last copy out."""

    __slots__ = ("buf", "event")

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.event: Optional[torch.cuda.Event] = None


def _host_table(cold) -> Tuple[np.ndarray, torch.dtype]:
    """An owned numpy copy of ``cold`` (a numpy array or a tensor on any
    device), the cold tier, and the table's torch dtype.  A bf16 table
    (a bf16 tensor, or the 2-byte voids ``np.savez`` writes for one) is
    kept as its ``uint16`` bits."""
    if isinstance(cold, torch.Tensor):
        t = cold.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.cpu().numpy()
        # a tensor off the CPU came over as a fresh copy already
        arr = arr.copy() if cold.device.type == "cpu" else arr
        if cold.dtype == torch.bfloat16:
            return arr.view(np.uint16), torch.bfloat16
        return arr, cold.dtype
    arr = np.array(cold)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return arr.view(np.uint16), torch.bfloat16
    if arr.dtype.kind != "f":
        raise StorageError(f"tiered tables are float32 or bfloat16 "
                           f"(float16 and float64 on the CPU), got "
                           f"{arr.dtype}")
    return arr, torch.from_numpy(arr[:0]).dtype


def _as_rows(bits: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Cold rows as a CPU tensor of the table's dtype (bf16 from its
    ``uint16`` bits, sharing their memory)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(bits)


def _as_bits(rows: torch.Tensor) -> np.ndarray:
    """Rows of the hot tier as the cold tier's numpy values (a bf16
    row's bits as ``uint16``)."""
    rows = rows.cpu()
    if rows.dtype == torch.bfloat16:
        return rows.view(torch.int16).numpy().view(np.uint16)
    return rows.numpy()


def _align16(n: int) -> int:
    return -(-n // 16) * 16


class TieredEmbeddingTable:
    """Hot cache on the card over host memory, for one embedding
    parameter.

    ``cold`` is the full table: ``(rows, dim)`` (one table),
    ``(tables, rows, dim)`` (stacked), or flat ``(total_rows, dim)``
    with ``row_counts`` (ragged); a numpy array or a tensor, copied to the
    host.  ``hot_rows`` is the per-table budget: each table gets
    ``min(hot_rows, rows_t)`` slots in the shared hot tier, which lives on
    ``device`` (default: the card).

    :meth:`remap_with_param` is the serving surface: it takes raw ids
    shaped like the op input, makes every touched row resident, and
    returns (remapped ids, hot parameter) such that the unchanged
    forward reads exactly the rows the raw ids name.  :meth:`gather_rows`
    and :meth:`scatter_apply` are the sparse training surface; dirty rows
    stay in the hot tier until eviction or :meth:`writeback` pushes them
    down to cold.
    """

    def __init__(self, name: str, cold, hot_rows: int, *,
                 row_counts: Optional[Sequence[int]] = None,
                 policy: str = "lfu",
                 table_keys: Optional[Sequence[str]] = None,
                 device=None):
        self.name = str(name)
        self.policy_name = (policy or "lfu").strip().lower() or "lfu"
        arr, dtype = _host_table(cold)  # own host copy = the cold tier
        if arr.ndim == 3:
            self.kind = "stacked"
            tables, rows, dim = arr.shape
            counts = [rows] * tables
            arr = arr.reshape(tables * rows, dim)
        elif arr.ndim == 2 and row_counts is not None:
            self.kind = "ragged"
            counts = [int(r) for r in row_counts]
            # the ragged op pads its flat row space to an alignment; pad
            # rows past the per-table counts are unreachable and never
            # get hot
            if sum(counts) > arr.shape[0]:
                raise StorageError(
                    f"row_counts sum {sum(counts)} > rows {arr.shape[0]}")
        elif arr.ndim == 2:
            self.kind = "single"
            counts = [arr.shape[0]]
        else:
            raise StorageError(f"cold table must be 2-D or 3-D, "
                               f"got shape {arr.shape}")
        self.cold = arr
        self.dim = int(arr.shape[1])
        self.tables = len(counts)
        self.hot_rows = int(hot_rows)
        if self.hot_rows < 1:
            raise StorageError("hot_rows must be >= 1")
        keys = list(table_keys) if table_keys is not None \
            else default_table_keys(self.name, self.tables)
        if len(keys) != self.tables:
            raise StorageError(f"{len(keys)} table_keys for "
                               f"{self.tables} tables")
        self.tiers: List[_Tier] = []
        base = hot_off = 0
        for t, rows in enumerate(counts):
            slots = min(self.hot_rows, rows)
            self.tiers.append(_Tier(rows, base, hot_off, slots,
                                    make_policy(self.policy_name, slots),
                                    keys[t]))
            base += rows
            hot_off += slots
        self.total_rows = base
        self.hot_slots = hot_off
        self.device = resolve_device(device)
        # the hot tier: allocated once, written in place, never replaced
        self._hot = torch.zeros((self.hot_slots, self.dim), dtype=dtype,
                                device=self.device)
        self._stages = [_Stage(), _Stage()]  # pinned, used in turn
        self._next_stage = 0
        self._block: Optional[torch.Tensor] = None  # the miss block, on the card
        self._dirty: set = set()   # global hot slots with unsynced rows
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._lookups = 0
        self._evictions = 0
        self._writebacks = 0
        self._admitted = 0
        self._stall_us_total = 0.0
        self._stall_us_last = 0.0

    # ------------------------------------------------------ internals

    def _writeback_locked(self, gslots: Sequence[int]) -> int:
        """Push the given DIRTY global slots' rows down to cold (caller
        holds the lock and has checked membership in self._dirty)."""
        if not gslots:
            return 0
        gs = np.asarray(sorted(gslots), dtype=np.int64)
        src = np.empty(gs.size, dtype=np.int64)
        bounds = np.asarray([t.hot_off for t in self.tiers], np.int64)
        which = np.searchsorted(bounds, gs, side="right") - 1
        for i, (g, t) in enumerate(zip(gs.tolist(), which.tolist())):
            tier = self.tiers[t]
            src[i] = tier.base + int(tier.id_at[g - tier.hot_off])
        # one device-to-host copy of the dirty slots (ordered after every
        # update enqueued so far on this stream)
        idx = torch.from_numpy(gs).to(self.device)
        self.cold[src] = _as_bits(self._hot[idx])
        for g in gs.tolist():
            self._dirty.discard(g)
        self._writebacks += gs.size
        return int(gs.size)

    def _stage(self, nbytes: int) -> _Stage:
        """The next pinned staging buffer, at least ``nbytes``, once its
        last copy to the card has completed."""
        st = self._stages[self._next_stage]
        self._next_stage = 1 - self._next_stage
        if st.event is not None:
            st.event.synchronize()
        if st.buf is None or st.buf.numel() < nbytes:
            st.buf = torch.empty(_align16(max(nbytes, 4096)),
                                 dtype=torch.uint8, pin_memory=True)
        return st

    def reserve(self, rows: int) -> None:
        """Allocate the staging and miss-block buffers for a miss block
        of ``rows`` rows now, off the serving path (a larger block grows
        them when it comes)."""
        if self.device.type != "cuda" or rows <= 0:
            return
        nbytes = _align16(4 * rows) + rows * self.dim * self._hot.element_size()
        with self._lock:
            for _ in self._stages:
                self._stage(nbytes)
            if self._block is None or self._block.numel() < nbytes:
                self._block = torch.empty(_align16(nbytes), dtype=torch.uint8,
                                          device=self.device)

    def _install_locked(self, miss_g: List[int], miss_src: List[int]):
        """``hot[miss_g] = cold[miss_src]``: the rows gathered into pinned
        staging, one non_blocking copy to the card, one row-set launch,
        all enqueued on the current stream (caller holds the lock).
        Returns the timing handle ``_note`` reads: (start, end) CUDA
        events, or the install's wall in µs on the CPU."""
        n = len(miss_g)
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            row_set_cuda(self._hot, torch.as_tensor(miss_g, dtype=torch.int64),
                         _as_rows(self.cold[np.asarray(miss_src)],
                                  self._hot.dtype))
            return (time.perf_counter() - t0) * 1e6
        row_off = _align16(4 * n)
        nbytes = row_off + n * self.dim * self._hot.element_size()
        st = self._stage(nbytes)
        host = st.buf.numpy()
        host[:4 * n].view(np.int32)[:] = miss_g
        np.take(self.cold, np.asarray(miss_src, dtype=np.int64), axis=0,
                out=host[row_off:nbytes].view(self.cold.dtype).reshape(
                    n, self.dim))
        if self._block is None or self._block.numel() < nbytes:
            self._block = torch.empty(_align16(nbytes), dtype=torch.uint8,
                                      device=self.device)
        stream = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        self._block[:nbytes].copy_(st.buf[:nbytes], non_blocking=True)
        if st.event is None:
            st.event = torch.cuda.Event()
        st.event.record(stream)  # staging may be rewritten after this
        ids = self._block[:4 * n].view(torch.int32)
        rows = self._block[row_off:nbytes].view(self._hot.dtype).view(
            n, self.dim)
        row_set_cuda(self._hot, ids, rows)
        end.record(stream)
        return start, end

    def _remap_locked(self, a: np.ndarray) -> Tuple[np.ndarray,
                                                    np.ndarray, dict]:
        """Make every id in ``a`` resident; return (op-adjusted ids,
        global hot slots, info).  The misses' install is enqueued here;
        ``_note`` reads its time outside the lock."""
        out = np.empty(a.shape, dtype=np.int64)
        gout = np.empty(a.shape, dtype=np.int64)
        miss_g: List[int] = []
        miss_src: List[int] = []
        hits = misses = evicted = admitted = 0
        for t in range(self.tables):
            tier = self.tiers[t]
            col = a[:, t] if self.tables > 1 else a
            flat = col.reshape(-1)
            if flat.size == 0:
                continue
            uniq, ucnt = np.unique(flat, return_counts=True)
            if int(uniq[0]) < 0 or int(uniq[-1]) >= tier.rows:
                raise StorageError(
                    f"{self.name}[{t}]: id out of range "
                    f"[{int(uniq[0])}, {int(uniq[-1])}] for "
                    f"{tier.rows} rows")
            if uniq.size > tier.slots:
                raise StorageError(
                    f"{self.name}[{t}]: batch working set {uniq.size} "
                    f"exceeds hot tier ({tier.slots} slots) — raise "
                    "storage_hot_rows or shrink the batch")
            slot_of = tier.slot_of
            resident = np.fromiter((i in slot_of for i in uniq.tolist()),
                                   dtype=bool, count=uniq.size)
            hits += int(ucnt[resident].sum())
            misses += int(ucnt[~resident].sum())
            pinned = {slot_of[i] for i in uniq[resident].tolist()}
            miss_ids = uniq[~resident].tolist()
            miss_cnt = ucnt[~resident].tolist()
            need = len(miss_ids)
            nvict = need - len(tier.free)
            if nvict > 0:
                # free slots are not victims (nothing to displace): the
                # policy ranks only occupied, unpinned slots
                vics = tier.policy.victims(nvict,
                                           pinned | set(tier.free))
                if len(vics) < nvict:
                    raise StorageError(
                        f"{self.name}[{t}]: eviction starved "
                        f"({len(vics)}/{nvict} victims)")
                wb = [tier.hot_off + v for v in vics
                      if (tier.hot_off + v) in self._dirty]
                self._writeback_locked(wb)
                for v in vics:
                    old = int(tier.id_at[v])
                    del slot_of[old]
                    tier.id_at[v] = -1
                    tier.free.append(v)
                evicted += nvict
            for mid, mcnt in zip(miss_ids, miss_cnt):
                s = tier.free.pop()
                slot_of[mid] = s
                tier.id_at[s] = mid
                tier.policy.fill(s, seed=int(mcnt))
                pinned.add(s)
                miss_g.append(tier.hot_off + s)
                miss_src.append(tier.base + mid)
            admitted += need
            for i in uniq[resident].tolist():
                tier.policy.touch(slot_of[i])
            gmap = np.fromiter(
                (tier.hot_off + slot_of[i] for i in uniq.tolist()),
                dtype=np.int64, count=uniq.size)
            gcol = gmap[np.searchsorted(uniq, flat)].reshape(col.shape)
            if self.kind == "ragged":
                ocol = gcol - tier.base
            elif self.kind == "stacked":
                ocol = gcol - tier.hot_off
            else:
                ocol = gcol
            if self.tables > 1:
                out[:, t] = ocol
                gout[:, t] = gcol
            else:
                out[...] = ocol
                gout[...] = gcol
        timing = self._install_locked(miss_g, miss_src) if miss_g else None
        self._hits += hits
        self._misses += misses
        self._lookups += hits + misses
        self._evictions += evicted
        self._admitted += admitted
        info = {"hits": hits, "misses": misses, "evicted": evicted,
                "admitted": admitted, "timing": timing,
                "hit_pct": 100.0 * self._hits / max(1, self._lookups)}
        return out, gout, info

    def _note(self, info: dict) -> None:
        """Post-remap accounting outside the lock: the miss stall (the
        install's device time: its end event has completed once the
        caller fenced, else this waits for it), the gauges, and the
        storage events."""
        stall_us = 0.0
        if info["misses"]:
            timing = info["timing"]
            if isinstance(timing, tuple):
                start, end = timing
                end.synchronize()
                stall_us = start.elapsed_time(end) * 1e3
            else:
                stall_us = float(timing)
            with self._lock:
                self._stall_us_total += stall_us
                self._stall_us_last = stall_us
            _metrics.EMBED_CACHE_MISS_STALL_US.set(stall_us)
        _metrics.EMBED_CACHE_HIT_PCT.set(info["hit_pct"])
        if info["misses"]:
            emit("storage", phase="miss", table=self.name,
                 misses=info["misses"], stall_us=stall_us,
                 hits=info["hits"], hit_pct=info["hit_pct"],
                 admitted=info["admitted"])
        if info["evicted"]:
            emit("storage", phase="evict", table=self.name,
                 evicted=info["evicted"], policy=self.policy_name)

    def _check_shape(self, a: np.ndarray) -> None:
        if self.tables > 1 and (a.ndim < 2 or a.shape[1] != self.tables):
            raise StorageError(
                f"{self.name}: expected a table axis of {self.tables} "
                f"at dim 1, got shape {a.shape}")

    def _remap_deferred(self, ids) -> Tuple[np.ndarray, dict]:
        """The serving engine's remap: (remapped ids, info) with the
        install enqueued and ``_note`` left to the caller, which holds a
        lock of its own across this, its forward's enqueue and its
        output copy's, and calls ``_note(info)`` after its fence."""
        a = np.asarray(ids)
        self._check_shape(a)
        with self._lock:
            out, _, info = self._remap_locked(a)
        return out, info

    # ------------------------------------------------- serving surface

    def remap(self, ids) -> np.ndarray:
        """Remapped ids (same shape, int64) for the forward, after making
        every touched row hot-resident."""
        return self.remap_with_param(ids)[0]

    def remap_with_param(self, ids) -> Tuple[np.ndarray, Any]:
        """(remapped ids, hot parameter).  The parameter is the hot tier
        itself, written in place: its rows at the returned slots hold
        the ids' rows until another remap evicts them (the engine keeps
        the two in one critical section)."""
        out, info = self._remap_deferred(ids)
        self._note(info)
        return out, self._shape_param(self._hot)

    def _shape_param(self, hot) -> Any:
        if self.kind == "stacked":
            return hot.view(self.tables, self.tiers[0].slots, self.dim)
        return hot

    def hot_param(self) -> Any:
        """The hot tier, shaped like the op's ``embedding`` parameter (no
        residency changes).  The same tensor for the store's whole
        life."""
        return self._shape_param(self._hot)

    # ------------------------------------------------ training surface

    def gather_rows(self, ids) -> Any:
        """Embedding rows for ``ids`` (shape ``ids.shape + (dim,)``)
        through the hot tier: the sparse-training read path.  The
        gather is enqueued under the lock, before any later install."""
        a = np.asarray(ids)
        with self._lock:
            _, gout, info = self._remap_locked(a)
            rows = take_rows(self._hot, torch.from_numpy(
                gout.reshape(-1)).to(self.device))
        self._note(info)
        return rows.reshape(a.shape + (self.dim,))

    def scatter_apply(self, ids, row_grads, scale=1.0) -> None:
        """Apply ``rows__``-style sparse updates: row ``ids[...]`` gets
        ``scale * row_grads[...]`` added in place by the row-update
        kernel (duplicate ids accumulate in order).  Updated rows stay in
        the hot tier, marked dirty; eviction or :meth:`writeback` pushes
        them down to cold."""
        a = np.asarray(ids)
        g = torch.as_tensor(row_grads).to(self.device).reshape(-1, self.dim)
        bf16 = self._hot.dtype == torch.bfloat16
        if bf16:
            # the JAX store adds bfloat16(scale) * grads
            scale = float(torch.tensor(float(scale), dtype=torch.bfloat16))
        if not (bf16 and g.dtype == torch.bfloat16):
            g = g.float() if bf16 else g.to(self._hot.dtype)
        with self._lock:
            _, gout, info = self._remap_locked(a)
            flat = gout.reshape(-1)
            uniq, local = np.unique(flat, return_inverse=True)
            if bf16 and g.dtype == torch.float32:
                # f32 grads into a bf16 table: the JAX store's add runs
                # in f32 (its scatter promotes the table) and rounds each
                # touched row once, so the rows are updated in an f32
                # scratch and set back
                dst = torch.from_numpy(uniq).to(self.device)
                rows = take_rows(self._hot, dst).float()
                row_update_cuda(rows, torch.from_numpy(local.reshape(
                    -1)).to(self.device), g, scale)
                row_set_cuda(self._hot, dst, rows.to(torch.bfloat16))
            else:
                # bf16 grads: each product and each add rounded to the
                # table's dtype, as the JAX store's bf16 scatter-add
                row_update_cuda(self._hot, torch.from_numpy(flat).to(
                    self.device), g, scale)
            self._dirty.update(int(x) for x in uniq)
        self._note(info)

    def writeback(self) -> int:
        """Flush every dirty hot row down to cold; returns the number
        of rows written back."""
        with self._lock:
            n = self._writeback_locked(list(self._dirty))
        return n

    def cold_full(self):
        """The full table (writeback first), shaped like the original
        parameter: the bit-exactness and checkpoint ground truth.  A
        numpy array, or for a bf16 table a CPU bf16 tensor (numpy has no
        bf16 of its own)."""
        self.writeback()
        with self._lock:
            arr = self.cold.copy()
        if self.kind == "stacked":
            arr = arr.reshape(self.tables, self.tiers[0].rows, self.dim)
        if self._hot.dtype == torch.bfloat16:
            return _as_rows(arr, torch.bfloat16)
        return arr

    # ----------------------------------------------- admission warmup

    def warm_start(self, per_table: Sequence[Sequence[Tuple[int, int]]]
                   ) -> int:
        """Admit known-hot ids before traffic: ``per_table[t]`` is
        (id, count) pairs, hottest first (the
        ``telemetry.rowfreq.hot_rows`` snapshot shape); counts seed the
        LFU ranking.  Returns rows admitted."""
        miss_g: List[int] = []
        miss_src: List[int] = []
        timing = None
        with self._lock:
            for t, pairs in enumerate(per_table):
                if t >= self.tables:
                    break
                tier = self.tiers[t]
                for rid, cnt in pairs:
                    rid = int(rid)
                    if not tier.free:
                        break
                    if not (0 <= rid < tier.rows) or rid in tier.slot_of:
                        continue
                    s = tier.free.pop()
                    tier.slot_of[rid] = s
                    tier.id_at[s] = rid
                    tier.policy.fill(s, seed=int(cnt))
                    miss_g.append(tier.hot_off + s)
                    miss_src.append(tier.base + rid)
            if miss_g:
                timing = self._install_locked(miss_g, miss_src)
            self._admitted += len(miss_g)
        if isinstance(timing, tuple):
            timing[1].synchronize()
        if miss_g:
            emit("storage", phase="admit", table=self.name,
                 admitted=len(miss_g), policy=self.policy_name,
                 rows=self.total_rows, slots=self.hot_slots)
        return len(miss_g)

    def warm_from_rowfreq(self) -> int:
        """Warm-start from the process RowFreqCounters under this
        store's table keys (the LFU admission default)."""
        return self.warm_start([rowfreq.hot_rows(t.key, t.slots)
                                for t in self.tiers])

    # ------------------------------------------------------- inspection

    def resident_ids(self, table: int = 0) -> List[int]:
        """Sorted ids currently hot-resident for ``table``."""
        with self._lock:
            return sorted(self.tiers[table].slot_of)

    def hot_manifest(self) -> List[List[Tuple[int, int]]]:
        """Per-table [(id, seed), ...] of hot-resident rows, most
        retainable first: what the checkpoint manifest records as the
        device tier's ownership, and what :meth:`warm_start` accepts
        back.  Seeds carry the policy's ranking signal (LFU counts, LRU
        recency rank), so a reload under a smaller budget re-admits the
        hottest prefix."""
        out: List[List[Tuple[int, int]]] = []
        with self._lock:
            for tier in self.tiers:
                pairs = list(tier.slot_of.items())  # (id, slot)
                score = getattr(tier.policy, "_count", None)
                if score is None:
                    score = getattr(tier.policy, "_stamp", None)
                if score is not None:
                    pairs.sort(key=lambda p: (-score[p[1]], p[0]))
                    out.append([(int(i), max(1, int(score[s])))
                                for i, s in pairs])
                else:  # clock keeps no ranking: retention rank only
                    pairs.sort(key=lambda p: p[0])
                    n = len(pairs)
                    out.append([(int(i), n - r)
                                for r, (i, _) in enumerate(pairs)])
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lk = self._lookups
            return {
                "table": self.name, "kind": self.kind,
                "tables": self.tables, "rows": self.total_rows,
                "hot_slots": self.hot_slots, "dim": self.dim,
                "policy": self.policy_name, "lookups": lk,
                "hits": self._hits, "misses": self._misses,
                "hit_pct": 100.0 * self._hits / max(1, lk),
                "evictions": self._evictions,
                "admitted": self._admitted,
                "writebacks": self._writebacks,
                "dirty": len(self._dirty),
                "stall_us_total": self._stall_us_total,
                "stall_us_last": self._stall_us_last,
            }

    def describe(self) -> str:
        s = self.stats()
        return (f"{s['table']}: {s['kind']} {s['rows']}x{s['dim']} "
                f"({s['tables']} tables), hot {s['hot_slots']} slots, "
                f"policy {s['policy']}, hit {s['hit_pct']:.1f}% "
                f"({s['hits']}/{s['lookups']}), "
                f"{s['evictions']} evictions")
