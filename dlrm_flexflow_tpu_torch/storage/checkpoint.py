"""Checkpoints of tiered embedding tables (counterpart of
``dlrm_flexflow_tpu/storage/checkpoint.py``, the same two files, keys
and format, so a save of either package loads in the other).

A tiered table checkpoints as two files:

* ``cold.npz``: the full table, the host tier's ground truth, written
  after a writeback of the dirty rows, so sparse updates riding the hot
  tier are never lost;
* ``tiered_manifest.json``: the device tier's ownership set: per table,
  the hot-resident ids in retention order with their policy seeds, and
  the budget, policy and shape the store is rebuilt from.

The cold tier is complete, so the manifest is advisory: a restore under
a different hot budget re-admits the recorded hottest prefix that fits,
and a larger budget leaves the extra slots to live traffic.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .tiered import StorageError, TieredEmbeddingTable

MANIFEST_NAME = "tiered_manifest.json"
COLD_NAME = "cold.npz"


def save_tiered(path: str, store: TieredEmbeddingTable) -> str:
    """Write ``store`` under directory ``path`` (created if needed):
    writeback -> cold.npz + tiered_manifest.json.  Returns the manifest
    path."""
    os.makedirs(path, exist_ok=True)
    wrote_back = store.writeback()
    manifest = {
        "version": 1,
        "name": store.name,
        "kind": store.kind,
        "dim": store.dim,
        "policy": store.policy_name,
        "hot_rows": store.hot_rows,
        "row_counts": [t.rows for t in store.tiers],
        "table_keys": [t.key for t in store.tiers],
        "wrote_back": wrote_back,
        "hot_ids": [[[int(i), int(c)] for i, c in pairs]
                    for pairs in store.hot_manifest()],
    }
    cold = store.cold_full()
    if isinstance(cold, torch.Tensor):
        # a bf16 table: its bits as the 2-byte voids the JAX package's
        # np.savez of an ml_dtypes.bfloat16 array writes
        cold = cold.view(torch.int16).numpy().view(np.dtype("V2"))
    np.savez(os.path.join(path, COLD_NAME), cold=cold)
    mpath = os.path.join(path, MANIFEST_NAME)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, mpath)
    return mpath


def load_tiered(path: str, *, hot_rows: Optional[int] = None,
                policy: Optional[str] = None,
                device=None) -> TieredEmbeddingTable:
    """Rebuild a tiered table from :func:`save_tiered` output, its hot
    tier on ``device`` (default: the card).  ``hot_rows`` and ``policy``
    override the recorded budget and policy: a smaller budget re-admits
    the recorded hottest prefix that fits."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise StorageError(f"no tiered manifest at {mpath}")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("version") != 1:
        raise StorageError(
            f"unknown tiered manifest version {manifest.get('version')}")
    with np.load(os.path.join(path, COLD_NAME)) as z:
        cold = z["cold"]
    kind = manifest["kind"]
    store = TieredEmbeddingTable(
        manifest["name"], cold,
        int(hot_rows if hot_rows is not None else manifest["hot_rows"]),
        row_counts=manifest["row_counts"] if kind == "ragged" else None,
        policy=policy or manifest["policy"],
        table_keys=manifest["table_keys"], device=device)
    store.warm_start([[(int(i), int(c)) for i, c in pairs]
                      for pairs in manifest.get("hot_ids", [])])
    return store
