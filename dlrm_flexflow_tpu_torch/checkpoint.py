"""Checkpoint and resume (counterpart of ``dlrm_flexflow_tpu/checkpoint.py``:
its npz format, the multi-host ``podshard`` format and the reshard
restore).

A checkpoint directory holds ``state.npz`` and ``meta.json`` exactly as
the JAX package writes them with ``use_orbax=False``: the flat keys
``params/<op>/<param>``, ``opt_state/...``, ``bn_state/...``, ``rng`` and
``step`` (``/``-joined, ``%2F``/``%25`` escaped), the same dtypes, and
``{"step": ..., "format": "npz"}`` plus the model's topology under
``"mesh"`` (``{}``: one device) when a model is given.  So either
package restores the other's checkpoints.

**Ranks.**  The JAX package runs one process per host; the port runs one
process per rank (``parallel/mesh.py``).  So in the port a process is a
rank: ``process_index`` is the rank and ``process_count`` the world size
(``distributed.topology``).

* **The pod format** (``save_checkpoint(..., multihost=True)``,
  :func:`save_pod_shards`): every rank writes ``shard-pNNN.npz`` and its
  index ``shard-pNNN.json`` into one shared directory, byte-compatible
  with the JAX layout: a sharded leaf's block as ``<key>@@0`` with its
  ``lo``/``hi`` rectangle of the global shape, every leaf that no mesh
  shards (and every leaf of a model on one rank) as a plain key written
  by rank 0 alone.  A sharded block is written by the lowest rank among
  those holding the identical block (JAX writes the ``replica_id == 0``
  shard), so the shard files tile every leaf with no overlap.  Rank 0
  writes ``meta.json`` (``{"step", "format": "podshard",
  "process_count", "mesh"}``).  No collective runs: the directory and the
  manager's file barriers (``resilience/manager.py``) are the only
  coordination, since a group whose peer died may be wedged.
* **The gathered save** (``multihost=False`` of a model across more than
  one rank) is a collective: every rank joins the gather of each sharded
  leaf, and rank 0 writes the same ``state.npz`` and ``meta.json`` that
  the JAX package writes for its one-process mesh model, with the
  topology under ``"mesh"``.  This is the choice because in every parity
  test a rank group stands in for JAX's one process of 8 devices; the
  other ranks write nothing.

**The restore** reads npz and podshard directories alike: a podshard is
reassembled from every shard file into whole host arrays, and partial
coverage raises :class:`CheckpointError` naming the array.  A checkpoint
saved on another topology than the restoring model's raises with the JAX
package's text unless ``on_mesh_change="reshard"``; either way the
host-logical arrays are re-placed under the restoring model's
``parallel/mesh.py::partition_rules`` (each rank keeps its blocks), or as
whole tensors without a mesh.  The restored tensors are copies: no
parameter aliases a numpy buffer.

Host-placed tables (the hetero strategy, ``ops/hetero.py``) live outside
the state: ``save_checkpoint(..., model=)`` writes each as
``host_tables/<op name>`` beside the state, as the JAX package does, and
``restore_checkpoint(..., model=)`` puts each back into its op's live
table, warning about any that has no such op to land in.

bf16 leaves: the JAX package's ``np.asarray`` of a bf16 array is an
``ml_dtypes.bfloat16`` array, which ``np.savez`` stores as raw 2-byte
voids (``|V2``).  The port writes the same bytes without ``ml_dtypes``
(the table's 16-bit patterns viewed as ``|V2``, in the npz and in pod
blocks alike, whose index names the dtype ``"bfloat16"`` as JAX's does)
and reads any 2-byte void leaf back as bf16 bits.  (The JAX package's
own restore rejects that payload, ``checkpoint.py:501``; ROADMAP.md
Queue C.)

An orbax checkpoint raises :class:`CheckpointError` naming the re-save
that makes it readable.  The port has no packed table storage, so leaves
pass through unreshaped.
"""

from __future__ import annotations

import glob
import json
import os
import time
import warnings
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .distributed import _identity
from .model import TrainState
# topologies are {axis: size} dicts; size-1 axes replicate, so they
# compare equal to no mesh
from .parallel.mesh import format_topology, mesh_topology, same_topology
from .telemetry.trace import current_span, record_span, span


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


def _tensor(arr: np.ndarray, copy: bool = True) -> torch.Tensor:
    """A saved leaf as a CPU tensor, a 2-byte void (bf16 written by
    either package) as bf16 bits: of its own memory, or with ``copy=False``
    over ``arr``'s (an array no one else holds, read from a file)."""
    arr = np.array(arr) if copy else np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtype_name(leaf) -> str:
    """The dtype string the JAX package's pod index records for a leaf
    (``str(np.dtype(...))``: ``"float32"``, ``"bfloat16"``, ...)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _np_dtype(name: str) -> np.dtype:
    """An index's dtype string as the numpy dtype a block is read as
    (bf16 as ``|V2``, readable without ``ml_dtypes``)."""
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def _host_tables_of(model) -> dict:
    """A model's host-placed tables, ``{op name: array}`` (the arrays
    themselves, not copies); ``{}`` without a model."""
    return {op.name: op.host_table.array
            for op in getattr(model, "_hetero_ops", [])
            if getattr(op, "host_table", None) is not None}


def _flat_state(state: TrainState, host_tables: Optional[dict] = None
                ) -> dict:
    """The one flat key -> leaf map both checkpoint writers share, in the
    JAX package's order."""
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


#: the JAX package's host copy of a replicated leaf's value: with one
#: device a rank it is :func:`_host` (a sharded leaf goes through the
#: shard path or :func:`host_gather`)
_local_value = _host


def _sharded(leaf) -> bool:
    """Whether a leaf is the rank's block of a parameter (or slot table)
    sharded over a mesh of more than one rank (``_ff_layout``)."""
    return getattr(leaf, "_ff_layout", None) is not None


def host_gather(tree):
    """Every array leaf of a (nested-dict) tree pulled to a host-logical
    numpy array — shard layouts (any mesh, or none) erased, values
    untouched (bf16 as its bits viewed as ``|V2``).  A leaf sharded over
    a mesh is gathered from every rank of its layout, a collective: every
    rank calls this with the same tree, in the same order.  The 'gather'
    half of the reshard restore (re-exported by ``elastic.reshard``)."""
    if isinstance(tree, dict):
        return {k: host_gather(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        from .parallel.spmd import global_param
        return _host(global_param(tree))
    if hasattr(tree, "__array__"):
        return np.asarray(tree)
    return tree


def _stage(name: str, t0: float, dur_s: float) -> None:
    """One stage of ``dur_s`` seconds, begun at ``t0``
    (``time.perf_counter``), as a span under the current one: a no-op
    with tracing off."""
    record_span(name, time.time() - (time.perf_counter() - t0),
                dur_s * 1e6, parent=current_span())


# ------------------------------------------------------- pod shard format
#
# The multi-host layout: every rank writes ONE ``shard-pNNN.npz`` holding
# exactly the array blocks it owns (plus a ``shard-pNNN.json`` index
# mapping each block to its rectangle of the global shape), rank 0 adds
# ``meta.json`` (format="podshard") and, through CheckpointManager, the
# manifest.  Together the shard files cover every leaf completely, so a
# restore needs only the DIRECTORY, not the fleet that wrote it.

def _norm_rect(index, shape):
    """A block's ``index`` (tuple of slices) as JSON-able lo/hi lists."""
    lo, hi = [], []
    for s, dim in zip(index, shape):
        lo.append(int(s.start) if s.start is not None else 0)
        hi.append(int(s.stop) if s.stop is not None else int(dim))
    return lo, hi


def _block_index(leaf):
    """``(index, global shape, owner rank)`` of a sharded leaf's block on
    this rank: the slices of the global array it holds (row-major block
    order over each dim's axes, as ``collectives.local_block`` cuts), and
    the lowest rank holding the identical block."""
    from .parallel.collectives import normalize
    mesh, spec = leaf._ff_layout
    index, gshape, fixed = [], [], {}
    for i, axes in enumerate(normalize(spec, leaf.dim())):
        axes = mesh.axes_key(axes)
        size = int(leaf.shape[i])
        n = mesh.axis_size(axes)
        j = mesh.axis_index(axes)
        index.append(slice(j * size, (j + 1) * size))
        gshape.append(size * n)
        for a in axes:
            fixed[a] = mesh.coords[a]
    holders = [int(r) for r, c in zip(
        mesh.devices.reshape(-1),
        np.ndindex(*mesh.devices.shape))
        if all(c[mesh.axis_names.index(a)] == v for a, v in fixed.items())]
    return tuple(index), tuple(gshape), min(holders)


def save_pod_shards(path: str, state: TrainState,
                    host_tables: Optional[dict] = None) -> list:
    """Write THIS rank's shard file pair into ``path``; returns the
    relative filenames written (for the manager's fsync).  Ownership: a
    sharded block is written by the lowest rank holding it, every other
    leaf (replicated, or any leaf of a model on one rank) once, by rank
    0 — so the union of all shard files tiles every leaf with no
    overlap.  No collective.  The blocks' device-to-host copies and the
    writes are the ``ckpt.d2h`` and ``ckpt.write`` spans."""
    pidx, n = _identity()
    data: dict = {}
    parts = []
    arrays = {}
    with span("ckpt.d2h"):
        for key, leaf in sorted(_flat_state(state,
                                            host_tables or {}).items()):
            if leaf is None:
                continue
            if not _sharded(leaf):
                if pidx == 0:
                    data[key] = _host(leaf)
                continue
            index, gshape, owner = _block_index(leaf)
            arrays[key] = {"shape": [int(d) for d in gshape],
                           "dtype": _dtype_name(leaf)}
            if owner != pidx:
                continue
            lo, hi = _norm_rect(index, gshape)
            # one device a rank: its one block is the JAX package's shard 0
            data[f"{key}@@0"] = _host(leaf)
            parts.append({"key": key, "npz": f"{key}@@0", "lo": lo,
                          "hi": hi})
    npz = f"shard-p{pidx:03d}.npz"
    idx = f"shard-p{pidx:03d}.json"
    with span("ckpt.write"):
        np.savez(os.path.join(path, npz), **data)
        with open(os.path.join(path, idx), "w") as f:
            json.dump({"process_index": pidx, "process_count": n,
                       "arrays": arrays, "parts": parts}, f)
    return [npz, idx]


def _load_pod_shards(path: str) -> dict:
    """Reassemble the flat key -> full host-logical numpy array map from
    EVERY shard file pair in a podshard checkpoint (either package's);
    raises :class:`CheckpointError` when the union of rectangles does not
    cover an array, naming it (a writer's shard file is missing).
    Reading the blocks and copying them into the whole arrays are the
    ``ckpt.read`` and ``ckpt.reassemble`` spans (each its summed wall)."""
    idx_paths = sorted(glob.glob(os.path.join(path, "shard-p*.json")))
    if not idx_paths:
        raise CheckpointError(
            f"{path!r} holds no shard-p*.json index files (meta.json "
            f"says format='podshard') — the save was killed before any "
            f"shard landed")
    flat: dict = {}
    covered: dict = {}
    shapes: dict = {}
    read_s = place_s = 0.0
    t_load = time.perf_counter()
    for ip in idx_paths:
        try:
            with open(ip) as f:
                idx = json.load(f)
            npz = np.load(ip[:-len(".json")] + ".npz")
        except (OSError, ValueError, json.JSONDecodeError) as e:
            raise CheckpointError(
                f"{ip!r}: unreadable shard file pair ({e})") from e
        try:
            for key, meta in idx.get("arrays", {}).items():
                if key not in flat:
                    shapes[key] = tuple(int(d) for d in meta["shape"])
                    flat[key] = np.empty(shapes[key],
                                         dtype=_np_dtype(meta["dtype"]))
                    covered[key] = 0
            for part in idx.get("parts", []):
                key = part["key"]
                rect = tuple(slice(int(a), int(b))
                             for a, b in zip(part["lo"], part["hi"]))
                t0 = time.perf_counter()
                block = npz[part["npz"]]
                t1 = time.perf_counter()
                flat[key][rect] = block
                place_s += time.perf_counter() - t1
                read_s += t1 - t0
                covered[key] += int(np.prod([b - a for a, b in
                                             zip(part["lo"], part["hi"])]))
            t0 = time.perf_counter()
            for k in npz.files:
                if "@@" not in k:
                    flat[k] = npz[k]
            read_s += time.perf_counter() - t0
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            raise CheckpointError(
                f"{ip!r}: unreadable shard file pair ({e})") from e
        finally:
            npz.close()
    for key, want in shapes.items():
        if covered.get(key, 0) != int(np.prod(want)):
            raise CheckpointError(
                f"{path!r}: array {key!r} is only partially covered by "
                f"the shard files ({covered.get(key, 0)} of "
                f"{int(np.prod(want))} elements) — a writer's shard "
                f"file is missing")
    _stage("ckpt.read", t_load, read_s)
    _stage("ckpt.reassemble", t_load, place_s)
    return flat


# ------------------------------------------------------------------- save
def save_checkpoint(path: str, state: TrainState, step: Optional[int] = None,
                    use_orbax: Optional[bool] = None, model=None,
                    multihost: bool = False) -> str:
    """Write a checkpoint directory; returns the path written.

    ``model`` records its topology (``{}``: one device) in ``meta.json``,
    as the JAX package does, so a restore onto another fleet shape is
    detected, and adds its host-placed tables (``host_tables/<op>``).
    ``use_orbax`` may be None or False: the port writes npz only.

    ``multihost=True`` is the pod format: EVERY rank calls this on a
    shared directory and writes only the blocks it owns
    (:func:`save_pod_shards`); rank 0 alone writes ``meta.json``.  The
    caller (``resilience.CheckpointManager``) owns the barriers around
    the call.  ``multihost=False`` on a state sharded over a mesh of more
    than one rank is a collective (every rank gathers each sharded leaf)
    and rank 0 alone writes ``state.npz`` and ``meta.json``."""
    if use_orbax:
        raise NotImplementedError(
            "the port writes npz checkpoints only (use_orbax=None or False)")
    rank, world = _identity()
    if multihost:
        os.makedirs(path, exist_ok=True)
        save_pod_shards(path, state, _host_tables_of(model))
        if rank == 0:
            meta = {"step": int(state.step)
                    if step is None else step,
                    "format": "podshard",
                    "process_count": world}
            if model is not None:
                meta["mesh"] = mesh_topology(getattr(model, "mesh", None))
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f)
        return path
    flat = _flat_state(state, _host_tables_of(model))
    # the gathered save: every rank joins each sharded leaf's gather, in
    # the flat order, and rank 0 writes
    host = {k: (host_gather(v) if _sharded(v) else
                (_host(v) if rank == 0 else None))
            for k, v in flat.items() if v is not None}
    if rank != 0:
        return path
    os.makedirs(path, exist_ok=True)
    meta = {"step": int(state.step) if step is None else step,
            "format": "npz"}
    if model is not None:
        meta["mesh"] = mesh_topology(getattr(model, "mesh", None))
    np.savez(os.path.join(path, "state.npz"), **host)
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


# -------------------------------------------------------------- placement
def _whole(tree, dev):
    """Every leaf of a tree as a whole tensor copied onto ``dev`` (numpy
    leaves, as :func:`host_gather` returns them, too)."""
    if isinstance(tree, dict):
        return {k: _whole(v, dev) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return _tensor(tree).to(dev)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True)
    return tree


def _place_state(state: TrainState, model, dev) -> TrainState:
    """A host-logical state (whole CPU tensors) placed for ``model`` on
    ``dev``: under a mesh of more than one rank each parameter and each
    optimizer slot table is the rank's block under the model's
    ``partition_rules`` (the slots mirror their parameters' rules; a
    block marks its layout), every other leaf whole; without one, every
    leaf whole.  Every leaf is a copy."""
    if getattr(model, "_spmd", None) is None:
        return TrainState(_whole(state.params, dev),
                          _whole(state.opt_state, dev),
                          _whole(state.bn_state, dev),
                          _whole(state.rng, dev), _whole(state.step, dev))
    from .parallel.mesh import (apply_partition_rules, partition_rules,
                                to_device)
    mesh = model.mesh
    rules = partition_rules(model)

    def place(tree):
        # the rank's block of each whole leaf (numpy leaves, as
        # host_gather returns them, as tensors first), then its copy
        tree = {op: {k: _tensor(v) if isinstance(v, np.ndarray) else v
                     for k, v in d.items()} for op, d in tree.items()}
        blocks = apply_partition_rules(rules, tree, mesh)
        return {op: {k: to_device(v, dev, copy=True) for k, v in d.items()}
                for op, d in blocks.items()}

    opt = {k: (place(v) if isinstance(v, dict) else _whole(v, dev))
           for k, v in state.opt_state.items()}
    return TrainState(place(state.params), opt,
                      _whole(state.bn_state, dev), _whole(state.rng, dev),
                      _whole(state.step, dev))


# ---------------------------------------------------------------- restore
def restore_checkpoint(path: str, model=None, inference_only: bool = False,
                       on_mesh_change: str = "error", *,
                       device=None) -> TrainState:
    """Read a checkpoint (npz or podshard) back into a :class:`TrainState`
    of tensors on ``device`` (default: the model's device when a model is
    given, the CUDA card for a model never placed, and the CPU without a
    model); under a model across the ranks of a mesh, each rank's blocks.

    ``on_mesh_change`` decides what happens when the checkpoint's
    recorded topology differs from the restoring ``model``'s:
    ``"error"`` (default) raises :class:`CheckpointError` naming both
    topologies; ``"reshard"`` is the elastic path
    (``elastic.reshard_restore``): every leaf, reassembled to a
    host-logical array, is re-placed under the restoring model's own
    partition rules — table-parallel rows re-split on the new ``model``
    axis, optimizer slots re-sharded alongside their parameters.

    ``inference_only=True`` loads params (and BN state) without requiring
    optimizer slots: present slots are skipped, and the state carries
    ``opt_state={}``.  A training restore (the default) requires them,
    and an archive without them raises :class:`CheckpointError`.

    The checkpoint's host tables go into ``model``'s host-placed ops
    (``op.host_table.array`` rebound); any without such an op, or read
    without a model, is dropped with a ``RuntimeWarning``.  The stages
    are spans: ``ckpt.read`` (and a podshard's ``ckpt.reassemble``) and
    ``ckpt.h2d`` (the placement).

    Raises :class:`CheckpointError` (naming the path and what is missing
    or corrupt) for a nonexistent directory, an absent or truncated
    ``meta.json``, a missing or unreadable payload, a podshard whose
    files do not cover an array, and an orbax checkpoint."""
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
        known_change = (saved_topo is not None
                        and not same_topology(saved_topo, want_topo))
        if known_change and on_mesh_change == "error":
            raise CheckpointError(
                f"{path!r} was saved on mesh topology "
                f"[{format_topology(saved_topo)}] but the restoring "
                f"model runs [{format_topology(want_topo)}] — the "
                f"fleet shape changed.  Restore across topologies "
                f"through dlrm_flexflow_tpu_torch.elastic.reshard_restore "
                f"(docs/elastic.md), which gathers the saved shards "
                f"to host-logical arrays and re-places them under "
                f"the new mesh's partition rules")
    fmt = meta.get("format")
    if fmt == "orbax":
        raise CheckpointError(
            f"{path!r} is an orbax checkpoint, which the port does not "
            f"read: re-save it with the JAX package's "
            f"save_checkpoint(..., use_orbax=False) (or "
            f"CheckpointManager(use_orbax=False)) to get the npz format")
    t0 = time.perf_counter()
    if fmt == "podshard":
        # reassembled from EVERY rank's shard file: the directory is
        # self-contained, so any fleet shape restores it
        data = _load_pod_shards(path)
        files, close = sorted(data), (lambda: None)
    else:
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
        files, close = data.files, data.close
    groups: dict = {"params": {}, "opt_state": {}, "bn_state": {},
                    "host_tables": {}}
    rng = step = None
    try:
        for k in files:
            # each array is read fresh from the file (or reassembled), so
            # its tensor owns it; the placement below copies it again
            if k == "rng":
                rng = _tensor(data[k], copy=False)
            elif k == "step":
                step = _tensor(data[k], copy=False)
            else:
                head, rest = k.split("/", 1)
                if inference_only and head == "opt_state":
                    continue  # slots skipped
                groups[head][rest] = (np.array(data[k])
                                      if head == "host_tables"
                                      else _tensor(data[k], copy=False))
    except (ValueError, OSError, zipfile.BadZipFile) as e:
        raise CheckpointError(
            f"{path!r}: the state payload is unreadable ({e}) — truncated "
            f"or corrupt") from e
    finally:
        close()
    del data
    if fmt != "podshard":
        _stage("ckpt.read", t0, time.perf_counter() - t0)
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
    with span("ckpt.h2d"):
        placed = _place_state(state, model, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return placed
