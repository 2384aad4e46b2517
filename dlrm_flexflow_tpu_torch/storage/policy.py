"""Admission and eviction policies for the tiered embedding store
(counterpart of ``dlrm_flexflow_tpu/storage/policy.py``, pure Python,
copied so that the port imports nothing of the JAX package).

A policy owns the ranking question only: which resident slot to give up
when a miss needs one.  The mechanics (slot maps, dirty tracking,
writeback) live in ``tiered.py``.  All three policies are deterministic:
score ties break toward the lowest slot index, so a replayed id stream
gives the same cache state, and the same victims in the same order as
the JAX package's.

* ``lfu`` (default): least-frequently-used; slot scores are access
  counts, seedable from the ``telemetry.rowfreq.hot_rows`` admission
  snapshot so a warm-started cache ranks observed traffic above an
  unknown id.
* ``lru``: least-recently-used through a monotone touch clock.
* ``clock``: second-chance FIFO, one reference bit per slot and a
  sweeping hand.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Type


class EvictionPolicy:
    """Rank ``slots`` resident slots for eviction.  The store calls
    :meth:`fill` when a row is admitted into a slot, :meth:`touch` on
    every hit, and :meth:`victims` when misses need slots — ``pinned``
    slots (the current batch's working set) are never returned."""

    name = "base"

    def __init__(self, slots: int):
        self.slots = int(slots)

    def fill(self, slot: int, seed: int = 0) -> None:
        raise NotImplementedError

    def touch(self, slot: int) -> None:
        raise NotImplementedError

    def victims(self, k: int, pinned: Set[int]) -> List[int]:
        raise NotImplementedError


class LFUPolicy(EvictionPolicy):
    """Least-frequently-used.  ``seed`` lets admission warm-starts
    carry observed row frequencies in, so a row the RowFreqCounter
    ranked hot outlives a burst of one-shot cold ids."""

    name = "lfu"

    def __init__(self, slots: int):
        super().__init__(slots)
        self._count = [0] * self.slots

    def fill(self, slot: int, seed: int = 0) -> None:
        self._count[slot] = int(seed)

    def touch(self, slot: int) -> None:
        self._count[slot] += 1

    def victims(self, k: int, pinned: Set[int]) -> List[int]:
        order = sorted(
            (s for s in range(self.slots) if s not in pinned),
            key=lambda s: (self._count[s], s))
        return order[:k]


class LRUPolicy(EvictionPolicy):
    """Least-recently-used via a monotone clock: every fill/touch
    stamps the slot; the stalest unpinned stamps evict first."""

    name = "lru"

    def __init__(self, slots: int):
        super().__init__(slots)
        self._tick = 0
        self._stamp = [0] * self.slots

    def _bump(self, slot: int) -> None:
        self._tick += 1
        self._stamp[slot] = self._tick

    def fill(self, slot: int, seed: int = 0) -> None:
        self._bump(slot)

    def touch(self, slot: int) -> None:
        self._bump(slot)

    def victims(self, k: int, pinned: Set[int]) -> List[int]:
        order = sorted(
            (s for s in range(self.slots) if s not in pinned),
            key=lambda s: (self._stamp[s], s))
        return order[:k]


class ClockPolicy(EvictionPolicy):
    """Second-chance FIFO: one reference bit per slot, a hand sweeping
    the ring — a touched slot survives one pass (bit cleared), an
    untouched one evicts.  O(1) state per touch where LRU pays a
    stamp; the classic big-cache compromise."""

    name = "clock"

    def __init__(self, slots: int):
        super().__init__(slots)
        self._ref = [False] * self.slots
        self._hand = 0

    def fill(self, slot: int, seed: int = 0) -> None:
        self._ref[slot] = True

    def touch(self, slot: int) -> None:
        self._ref[slot] = True

    def victims(self, k: int, pinned: Set[int]) -> List[int]:
        out: List[int] = []
        sweeps = 0
        # <= 2 full sweeps always suffice: the first clears ref bits,
        # the second must find unreferenced slots (pinned slots are
        # skipped without clearing, so they never starve the hand)
        while len(out) < k and sweeps < 2 * self.slots + k:
            s = self._hand
            self._hand = (self._hand + 1) % self.slots
            sweeps += 1
            if s in pinned or s in out:
                continue
            if self._ref[s]:
                self._ref[s] = False
            else:
                out.append(s)
        return out


_POLICIES: Dict[str, Type[EvictionPolicy]] = {
    p.name: p for p in (LFUPolicy, LRUPolicy, ClockPolicy)}

POLICY_NAMES = tuple(sorted(_POLICIES))


def make_policy(name: Optional[str], slots: int) -> EvictionPolicy:
    """Policy instance for ``name`` ("lfu" default; "lru", "clock")."""
    key = (name or "lfu").strip().lower() or "lfu"
    cls = _POLICIES.get(key)
    if cls is None:
        raise ValueError(
            f"unknown eviction policy {name!r} (known: {POLICY_NAMES})")
    return cls(slots)
