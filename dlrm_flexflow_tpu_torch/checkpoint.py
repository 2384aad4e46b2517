"""Checkpoint and resume (counterpart of ``dlrm_flexflow_tpu/checkpoint.py``,
its single-process npz format).

A checkpoint directory holds ``state.npz`` and ``meta.json`` exactly as
the JAX package writes them with ``use_orbax=False``: the flat keys
``params/<op>/<param>``, ``opt_state/...``, ``bn_state/...``, ``rng`` and
``step`` (``/``-joined, ``%2F``/``%25`` escaped), the same dtypes, and
``{"step": ..., "format": "npz"}`` plus ``"mesh": {}`` when a model is
given.  So either package restores the other's checkpoints.

Host-placed tables (the hetero strategy, ``ops/hetero.py``) live outside
the state: ``save_checkpoint(..., model=)`` writes each as
``host_tables/<op name>`` beside the state, as the JAX package does, and
``restore_checkpoint(..., model=)`` puts each back into its op's live
table, warning about any that has no such op to land in.

bf16 leaves: the JAX package's ``np.asarray`` of a bf16 array is an
``ml_dtypes.bfloat16`` array, which ``np.savez`` stores as raw 2-byte
voids (``|V2``).  The port writes the same bytes without ``ml_dtypes``
(the table's 16-bit patterns viewed as ``|V2``) and reads any 2-byte
void leaf back as bf16 bits.  (The JAX package's own restore rejects
that payload, ``checkpoint.py:501``; ROADMAP.md Queue C.)

What the port does not have raises :class:`CheckpointError` naming the way
out: an orbax checkpoint (re-save it with ``use_orbax=False``), the
multi-host ``podshard`` format and a restore across mesh topologies
(ROADMAP.md item 8, part 2).  The port has no mesh and no packed table
storage, so its topology is ``{}`` and leaves pass through unreshaped.

Transfers move whole tensors: ``.cpu()`` on save (which returns once the
device has produced the values, so a save never holds a later step's
rows), and onto the model's device on restore.
"""

from __future__ import annotations

import json
import os
import warnings
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .model import TrainState
# topologies are {axis: size} dicts; size-1 axes replicate, so they
# compare equal to no mesh
from .parallel.mesh import format_topology, mesh_topology, same_topology

#: where the unported checkpoint paths are queued
_ITEM8 = ("ROADMAP.md item 8, part 2 (scale-out: the multi-host save, the "
          "pod shards and the reshard restore)")


class CheckpointError(Exception):
    """A checkpoint directory that cannot be restored: missing, partially
    written, truncated, or failing manifest verification; or one in a
    format the port does not read.  Raised with the offending path and
    what exactly is wrong."""


def _esc(k) -> str:
    """Escape one tree key for the ``/``-joined flat form: an unescaped
    ``/`` in an op or param name would re-split into another tree."""
    return str(k).replace("%", "%25").replace("/", "%2F")


def _unesc(k: str) -> str:
    return k.replace("%2F", "/").replace("%25", "%")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_esc(k)}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = [_unesc(p) for p in key.split("/")]
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


# ----------------------------------------------------------- leaf transfer
def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array the JAX package would save: a tensor's
    values on the host, bf16 as its bits viewed as ``|V2``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A saved leaf as a CPU tensor, a 2-byte void (bf16 written by
    either package) as bf16 bits."""
    arr = np.array(arr)  # own, writable memory
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree


def _host_tables_of(model) -> dict:
    """A model's host-placed tables, ``{op name: array}`` (the arrays
    themselves, not copies); ``{}`` without a model."""
    return {op.name: op.host_table.array
            for op in getattr(model, "_hetero_ops", [])
            if getattr(op, "host_table", None) is not None}


def _flat_state(state: TrainState, host_tables: Optional[dict] = None
                ) -> dict:
    """The flat key -> leaf map of a state and a model's host tables, in
    the JAX package's order."""
    flat = {}
    flat.update({f"params/{k}": v
                 for k, v in _flatten(state.params).items()})
    flat.update({f"opt_state/{k}": v
                 for k, v in _flatten(state.opt_state).items()})
    flat.update({f"bn_state/{k}": v
                 for k, v in _flatten(state.bn_state or {}).items()})
    flat.update({f"host_tables/{_esc(k)}": v
                 for k, v in (host_tables or {}).items()})
    flat["rng"] = state.rng
    flat["step"] = state.step
    return flat


def save_checkpoint(path: str, state: TrainState, step: Optional[int] = None,
                    use_orbax: Optional[bool] = None, model=None,
                    multihost: bool = False) -> str:
    """Write a checkpoint directory in the npz format; returns the path.

    ``model`` records its topology (``{}``: one device) in ``meta.json``,
    as the JAX package does, so a restore onto another fleet shape is
    detected, and adds its host-placed tables (``host_tables/<op>``).
    ``use_orbax`` may be None or False: the port writes npz only.
    ``multihost=True`` (the pod format) is not ported."""
    if multihost:
        raise NotImplementedError(
            f"the multi-host (podshard) checkpoint is not ported: {_ITEM8}")
    if getattr(model, "_spmd", None) is not None or any(
            hasattr(v, "_ff_layout") for d in state.params.values()
            for v in d.values()):
        raise NotImplementedError(
            f"a checkpoint of a model across the ranks of a mesh is not "
            f"ported: {_ITEM8}")
    if use_orbax:
        raise NotImplementedError(
            "the port writes npz checkpoints only (use_orbax=None or False)")
    os.makedirs(path, exist_ok=True)
    meta = {"step": int(state.step) if step is None else step,
            "format": "npz"}
    if model is not None:
        meta["mesh"] = mesh_topology(getattr(model, "mesh", None))
    flat = _flat_state(state, _host_tables_of(model))
    np.savez(os.path.join(path, "state.npz"),
             **{k: _host(v) for k, v in flat.items() if v is not None})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def saved_topology(path: str) -> Optional[dict]:
    """The ``{axis: size}`` mesh topology recorded in a checkpoint's
    ``meta.json`` (``{}`` = saved single-device), or None when it was
    saved model-less.  Raises :class:`CheckpointError` for a missing or
    corrupt meta.json."""
    meta_path = os.path.join(path, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            f"{path!r} has no meta.json — not a checkpoint directory"
        ) from None
    except json.JSONDecodeError as e:
        raise CheckpointError(
            f"{meta_path!r} is truncated or corrupt ({e})") from e
    return meta.get("mesh")


def restore_checkpoint(path: str, model=None, inference_only: bool = False,
                       on_mesh_change: str = "error", *,
                       device=None) -> TrainState:
    """Read a checkpoint back into a :class:`TrainState` of tensors on
    ``device`` (default: the model's device when a model is given, the
    CUDA card for a model never placed, and the CPU without a model).

    ``on_mesh_change`` is checked as in the JAX package; a checkpoint
    saved on another topology raises :class:`CheckpointError` in either
    mode, since the reshard restore is not ported.

    ``inference_only=True`` loads params (and BN state) without requiring
    optimizer slots: present slots are skipped unread, and the state
    carries ``opt_state={}``.  A training restore (the default) requires
    them, and an archive without them raises :class:`CheckpointError`.

    The checkpoint's host tables go into ``model``'s host-placed ops
    (``op.host_table.array`` rebound); any without such an op, or read
    without a model, is dropped with a ``RuntimeWarning``.

    Raises :class:`CheckpointError` (naming the path and what is missing
    or corrupt) for a nonexistent directory, an absent or truncated
    ``meta.json``, a missing or unreadable ``state.npz``, and a format the
    port does not read (orbax, podshard)."""
    if on_mesh_change not in ("error", "reshard"):
        raise ValueError(
            f"on_mesh_change must be 'error' or 'reshard', "
            f"got {on_mesh_change!r}")
    if not os.path.isdir(path):
        raise CheckpointError(
            f"checkpoint directory {path!r} does not exist")
    meta_path = os.path.join(path, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            f"{path!r} has no meta.json — not a checkpoint directory, "
            f"or the save was killed before its metadata was written"
        ) from None
    except json.JSONDecodeError as e:
        raise CheckpointError(
            f"{meta_path!r} is truncated or corrupt ({e}) — the save "
            f"was likely killed mid-write") from e
    # the topology guard runs on meta.json alone, before the payload
    if model is not None:
        saved_topo = meta.get("mesh")
        want_topo = mesh_topology(getattr(model, "mesh", None))
        if saved_topo is not None and not same_topology(saved_topo,
                                                        want_topo):
            raise CheckpointError(
                f"{path!r} was saved on mesh topology "
                f"[{format_topology(saved_topo)}] but the restoring "
                f"model runs [{format_topology(want_topo)}] — the fleet "
                f"shape changed.  Restoring across topologies "
                f"(on_mesh_change={on_mesh_change!r}) is not ported: "
                f"{_ITEM8}")
    fmt = meta.get("format")
    if fmt == "orbax":
        raise CheckpointError(
            f"{path!r} is an orbax checkpoint, which the port does not "
            f"read: re-save it with the JAX package's "
            f"save_checkpoint(..., use_orbax=False) (or "
            f"CheckpointManager(use_orbax=False)) to get the npz format")
    if fmt == "podshard":
        raise CheckpointError(
            f"{path!r} is a multi-host (podshard) checkpoint, which the "
            f"port does not read: {_ITEM8}")
    npz_path = os.path.join(path, "state.npz")
    try:
        data = np.load(npz_path)
    except FileNotFoundError:
        raise CheckpointError(
            f"{path!r} has no state.npz (meta.json says format="
            f"'npz') — the save was killed before the state was "
            f"written") from None
    except (ValueError, OSError, zipfile.BadZipFile) as e:
        raise CheckpointError(
            f"{npz_path!r} is unreadable ({e}) — truncated or "
            f"corrupt state payload") from e
    groups: dict = {"params": {}, "opt_state": {}, "bn_state": {},
                    "host_tables": {}}
    rng = step = None
    try:
        for k in data.files:
            if k == "rng":
                rng = _tensor(data[k])
            elif k == "step":
                step = _tensor(data[k])
            else:
                head, rest = k.split("/", 1)
                if inference_only and head == "opt_state":
                    continue  # slots skipped unread
                groups[head][rest] = (np.array(data[k])
                                      if head == "host_tables"
                                      else _tensor(data[k]))
    except (ValueError, OSError, zipfile.BadZipFile) as e:
        raise CheckpointError(
            f"{npz_path!r} is unreadable ({e}) — truncated or "
            f"corrupt state payload") from e
    finally:
        data.close()
    state = TrainState(_unflatten(groups["params"]),
                       _unflatten(groups["opt_state"]),
                       _unflatten(groups["bn_state"]), rng, step)
    if not inference_only and not state.opt_state:
        raise CheckpointError(
            f"{path!r} holds no optimizer slots — it cannot seed a "
            f"training resume (the optimizer would silently restart "
            f"from scratch).  Pass inference_only=True to load params "
            f"for serving")
    # host-placed tables go back into the model's live ones
    host_tables = {_unesc(k): v for k, v in groups["host_tables"].items()}
    restored = set()
    for op in getattr(model, "_hetero_ops", ()):
        if op.name in host_tables and getattr(op, "host_table",
                                              None) is not None:
            op.host_table.array = host_tables[op.name]
            restored.add(op.name)
    dropped = set(host_tables) - restored
    if dropped:
        warnings.warn(
            f"checkpoint holds host tables {sorted(dropped)} but the "
            "model has no matching initialized hetero op; call "
            "model.init() before restore or the CPU-placed weights are "
            "lost", RuntimeWarning)
    if device is None:
        if model is None:
            return state
        device = getattr(model, "device", None)
    dev = resolve_device(device)
    return TrainState(_to_device(state.params, dev),
                      _to_device(state.opt_state, dev),
                      _to_device(state.bn_state, dev),
                      None if rng is None else rng.to(dev),
                      None if step is None else step.to(dev))
