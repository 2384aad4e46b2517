"""Data loading (counterpart of ``dlrm_flexflow_tpu/data/loader.py``).

NumPy only: the full dataset lives in host memory and each batch is a
slice of it; ``FFModel.train_step`` moves a batch to the parameters'
device.  For the same seed these loaders yield arrays identical to the
JAX package's.  ``load_criteo_h5`` needs ``h5py`` and comes with the
optimizer and data slice in ROADMAP.md.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class ArrayDataLoader:
    """Batched iterator over in-host-memory arrays.

    ``inputs`` maps input-tensor name -> full array (num_samples, ...).
    Mirrors SingleDataLoader/ImgDataLoader semantics: sequential batches,
    wrap at epoch end (reference flexflow_dataloader.h:26-107).
    """

    def __init__(self, inputs: Dict[str, np.ndarray], labels: np.ndarray,
                 batch_size: int, drop_last: bool = True, shuffle: bool = False,
                 seed: int = 0):
        self.inputs = inputs
        self.labels = labels
        self.batch_size = int(batch_size)
        n = labels.shape[0]
        for k, v in inputs.items():
            if v.shape[0] != n:
                raise ValueError(f"input {k} has {v.shape[0]} != {n} samples")
        self.num_samples = n
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        # resume bookkeeping (state_dict/load_state_dict): the shuffle
        # RNG state at the CURRENT epoch's start (re-shuffling from it
        # regenerates the same order), the batches-yielded cursor, and
        # the batch to start from after a restore
        self._epoch_start_rng: Optional[dict] = None
        self._cursor = 0
        self._resume_batch = 0

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def peek(self):
        idx = np.arange(min(self.batch_size, self.num_samples))
        return ({k: v[idx] for k, v in self.inputs.items()}, self.labels[idx])

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        start, self._resume_batch = self._resume_batch, 0
        # entering an epoch (fresh or restored mid-epoch), the RNG holds
        # the epoch-start state: remember it so a checkpoint taken at
        # any batch can replay this epoch's exact order
        self._epoch_start_rng = copy.deepcopy(self._rng.bit_generator.state)
        order = np.arange(self.num_samples)
        if self.shuffle:
            self._rng.shuffle(order)
        for b in range(start, self.num_batches):
            self._cursor = b + 1
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield ({k: v[idx] for k, v in self.inputs.items()},
                   self.labels[idx])
        self._cursor = 0

    # ------------------------------------------------- resume (checkpointing)
    def state_dict(self) -> dict:
        """Shuffle RNG state + epoch/batch cursor, JSON-serializable —
        enough for a restored loader to REPLAY the exact remaining batch
        sequence.  Mid-epoch, the captured RNG
        state is the epoch-START state and ``batch`` the next batch to
        yield; between epochs it is the current state with ``batch`` 0.
        The EPOCH position is deliberately not here: the training loop
        owns it."""
        mid = 0 < self._cursor < self.num_batches
        rng_state = (self._epoch_start_rng if mid
                     else self._rng.bit_generator.state)
        return {"rng_state": copy.deepcopy(rng_state),
                "batch": self._cursor if mid else 0}

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`: the next ``__iter__`` re-shuffles
        with the restored RNG (regenerating the interrupted epoch's
        order) and resumes from the saved batch cursor."""
        self._rng.bit_generator.state = sd["rng_state"]
        self._resume_batch = int(sd.get("batch", 0))
        self._cursor = self._resume_batch

    def __len__(self):
        return self.num_batches


class SyntheticDLRMLoader(ArrayDataLoader):
    """Random Criteo-like data (reference dlrm.cc "synthetic" mode,
    run_random.sh) — dense float features, per-table int64 multi-hot ids,
    binary labels.

    Input names follow the DLRM app: "dense" (B, num_dense), "sparse"
    (B, T, bag) for the stacked-table path or "sparse_<i>" per table, and
    labels (B, 1) float.

    ``id_dist`` picks the sparse-id law: ``"uniform"`` (default — every
    row equally likely) or ``"zipf"`` (power-law skew via
    :func:`zipf_ids`, exponent ``zipf_alpha``).
    """

    def __init__(self, num_samples: int, num_dense: int, table_sizes,
                 bag_size: int, batch_size: int, stacked: bool = True,
                 seed: int = 0, id_dist: str = "uniform",
                 zipf_alpha: float = 1.05):
        if id_dist not in ("uniform", "zipf"):
            raise ValueError(
                f"id_dist must be 'uniform' or 'zipf', got {id_dist!r}")
        rng = np.random.default_rng(seed)
        dense = rng.standard_normal((num_samples, num_dense), dtype=np.float32)

        def ids(rows):
            if id_dist == "zipf":
                return zipf_ids(rng, int(rows), (num_samples, bag_size),
                                a=zipf_alpha)
            return rng.integers(0, int(rows),
                                size=(num_samples, bag_size),
                                dtype=np.int64)

        inputs = {"dense": dense}
        if stacked:
            # per-column id ranges: column t draws from [0, rows_t) — the
            # same (B, T, bag) layout serves uniform (StackedEmbedding)
            # and ragged (RaggedStackedEmbedding) table sets
            inputs["sparse"] = np.stack(
                [ids(rows) for rows in table_sizes], axis=1)
        else:
            for i, rows in enumerate(table_sizes):
                inputs[f"sparse_{i}"] = ids(rows)
        labels = rng.integers(0, 2, size=(num_samples, 1)).astype(np.float32)
        super().__init__(inputs, labels, batch_size)


def zipf_ids(rng, num_rows: int, size, a: float = 1.05,
             dtype=np.int64) -> np.ndarray:
    """Zipf-distributed ids over [0, num_rows) — the skew shape of real
    Criteo categorical columns (a handful of hot values takes most of
    the mass; the reference trains on exactly such data,
    examples/cpp/DLRM/run_criteo_kaggle.sh).  Bounded rejection sampling
    keeps the exact Zipf(a) law truncated to the table; the id space is
    then permuted so hot rows are scattered across the table instead of
    clustered at 0 (as after Criteo's frequency-agnostic hashing)."""
    a = float(a)
    if a <= 1.0:
        raise ValueError("zipf exponent must be > 1")
    flat = int(np.prod(size))
    out = np.empty(flat, dtype=np.int64)
    have = 0
    while have < flat:
        draw = rng.zipf(a, size=max(flat - have, 1024))
        draw = draw[draw <= num_rows]
        take = min(draw.size, flat - have)
        out[have:have + take] = draw[:take] - 1
        have += take
    # mix the hot head over the row space (deterministic given rng)
    mult = 0x9E3779B1 % num_rows
    while np.gcd(mult, num_rows) != 1:
        mult = (mult + 1) % num_rows
    out = (out * mult + 12345) % num_rows
    return out.reshape(size).astype(dtype)


class ZipfDLRMLoader(ArrayDataLoader):
    """Synthetic DLRM loader with Zipf-skewed sparse ids — the fallback
    the Criteo example trains on when no real dataset file is present.
    Same layout contract as SyntheticDLRMLoader; labels correlate with a
    hidden weighting of the hot ids so the training signal is learnable
    (loss decreases), unlike pure-noise labels."""

    def __init__(self, num_samples: int, num_dense: int, table_sizes,
                 bag_size: int, batch_size: int, stacked: bool = True,
                 a: float = 1.05, seed: int = 0):
        rng = np.random.default_rng(seed)
        dense = rng.standard_normal((num_samples, num_dense),
                                    dtype=np.float32)
        cols = [zipf_ids(rng, int(rows), (num_samples, bag_size), a)
                for rows in table_sizes]
        inputs = {"dense": dense}
        if stacked:
            inputs["sparse"] = np.stack(cols, axis=1)
        else:
            for i, c in enumerate(cols):
                inputs[f"sparse_{i}"] = c
        # learnable labels: a sparse signal carried by the hot ids
        signal = sum(np.sin(c[:, 0] * 0.7 + i) for i, c in enumerate(cols))
        signal = signal + dense[:, 0]
        labels = (signal > np.median(signal)).astype(np.float32)[:, None]
        super().__init__(inputs, labels, batch_size)
