"""Reshard on restore: any checkpoint onto any mesh (counterpart of
``dlrm_flexflow_tpu/elastic/reshard.py``).

A checkpoint records the topology it was saved under (``meta.json``
``mesh``); a plain restore onto another shape refuses
(:class:`~..checkpoint.CheckpointError`).  This module is the sanctioned
crossing: **gather, then re-place** —

1. every saved leaf becomes one host-logical array: a podshard's blocks
   reassembled from every rank's shard file, an npz's leaves as they are
   (:func:`host_gather` gathers a live state's blocks, a collective);
2. the restoring model's own ``parallel/mesh.py:partition_rules()`` (the
   rules its training placement uses) names each leaf's spec, and each
   rank keeps its block: table-parallel rows re-split on the new
   ``model`` axis, optimizer slot tables ride the rules of the
   parameters they shadow, a leaf whose dim no longer divides the new
   axis is replicated instead.  Without a mesh every leaf lands whole on
   the model's device.

Values never change, only placement does: the restored state equals the
saved one bit for bit, and a run resumed across a reshape tracks the
never-killed one to the tolerance of the new reduction order.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Tuple

from ..checkpoint import (_place_state, host_gather, restore_checkpoint,
                          saved_topology)
from ..model import TrainState
from ..parallel.mesh import format_topology, mesh_topology, same_topology
from ..resilience.manager import EXTRA, CheckpointManager, latest_checkpoint
from ..telemetry import emit
from ..telemetry import metrics as _tmetrics


def gather_state(state: TrainState) -> TrainState:
    """The whole TrainState as host-logical numpy leaves (bf16 as its
    bits viewed as ``|V2``); a collective when any leaf is sharded over a
    mesh: every rank calls it."""
    return TrainState(host_gather(state.params),
                      host_gather(state.opt_state),
                      host_gather(state.bn_state),
                      host_gather(state.rng), host_gather(state.step))


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def reshard_state(state: TrainState, model, *, device=None) -> TrainState:
    """Re-place a live TrainState under ``model``'s current mesh: gather
    every leaf to the host (a collective when the state is sharded), then
    keep each rank's block under the spec its first matching partition
    rule names; optimizer slot tables go under the SAME rules as the
    parameters they shadow, every other leaf is replicated.  Without a
    mesh every leaf lands whole.  On ``device`` (default: the model's
    device, else the CUDA card)."""
    from ..device import resolve_device
    g = gather_state(state)
    dev = resolve_device(device if device is not None
                         else getattr(model, "device", None))
    return _place_state(g, model, dev)


def reshard_restore(manager, model, mesh=None,
                    inference_only: bool = False, *, device=None
                    ) -> Tuple[TrainState, Dict[str, Any], str]:
    """Restore the newest valid checkpoint onto ``model`` REGARDLESS of
    the topology it was saved under: the elastic resume.  ``manager`` is
    a :class:`~..resilience.CheckpointManager`, a manager directory, or
    one committed checkpoint directory.  ``model`` must already be
    compiled under the TARGET mesh; pass ``mesh`` to assert which one (a
    mismatch raises ValueError: the model, not the argument, places the
    state).  ``device`` as ``restore_checkpoint``'s.
    Returns ``(state, extra, path)`` like
    ``CheckpointManager.restore_latest``.

    Emits one ``elastic`` ``phase="reshard"`` event naming the saved and
    restored topologies and bumps ``dlrm_elastic_reshard_total``.
    Same-topology calls degrade to a plain restore (no elastic event:
    nothing was resharded)."""
    if mesh is not None and not same_topology(
            mesh_topology(mesh), mesh_topology(getattr(model, "mesh",
                                                       None))):
        raise ValueError(
            f"model is compiled under "
            f"[{format_topology(mesh_topology(model.mesh))}] but the "
            f"target mesh is [{format_topology(mesh_topology(mesh))}] — "
            f"compile the model under the target mesh first "
            f"(model.compile(mesh=...)), then reshard_restore")
    t0 = time.perf_counter()
    if isinstance(manager, str):
        if latest_checkpoint(manager) is not None:
            manager = CheckpointManager(manager)
        else:
            # one committed checkpoint directory (or garbage, which
            # restore_checkpoint names loudly)
            path = manager
            state = restore_checkpoint(path, model=model,
                                       inference_only=inference_only,
                                       on_mesh_change="reshard",
                                       device=device)
            extra: Dict[str, Any] = {}
            epath = os.path.join(path, EXTRA)
            if os.path.isfile(epath):
                with open(epath) as f:
                    extra = json.load(f)
            return _finish(state, extra, path, model, t0)
    state, extra, path = manager.restore_latest(
        model=model, inference_only=inference_only,
        on_mesh_change="reshard", device=device)
    return _finish(state, extra, path, model, t0)


def _finish(state: TrainState, extra: Dict[str, Any], path: str, model,
            t0: float) -> Tuple[TrainState, Dict[str, Any], str]:
    saved = saved_topology(path)
    to_topo = mesh_topology(getattr(model, "mesh", None))
    if saved is not None and same_topology(saved, to_topo):
        return state, extra, path  # nothing was resharded
    leaves = _count_leaves(state.params) + _count_leaves(state.opt_state)
    emit("elastic", phase="reshard",
         from_mesh=format_topology(saved) if saved is not None
         else "unknown",
         to_mesh=format_topology(to_topo),
         step=int(state.step), leaves=leaves,
         duration_s=time.perf_counter() - t0)
    _tmetrics.ELASTIC_RESHARDS.inc()
    return state, extra, path
