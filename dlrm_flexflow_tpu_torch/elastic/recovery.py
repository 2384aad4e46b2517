"""Survivor recovery after a rank is lost (counterpart of
``dlrm_flexflow_tpu/elastic/recovery.py``).

The detection half lives in ``resilience/watchdog.py`` (heartbeat ages,
the step stall watchdog) and ``resilience/manager.py`` (the deadlined
podshard barrier, :class:`~..resilience.FleetBarrierTimeout`); this
module is what the survivors DO once a peer is declared dead: leave the
old process group, join a new one at the reduced world size, and resume
from the last committed checkpoint through
:func:`~.reshard.reshard_restore`.  A podshard checkpoint restores on any
fleet shape by design, so losing a rank costs the steps since the last
save, never the run.

A launcher's shape:

    try:
        model.fit(...)                       # dies loudly on rank loss
    except (FleetBarrierTimeout, SystemExit):
        pass
    model, state, extra, path = recover_and_resume(
        ckpt_dir, build_model,
        coordinator_address=..., num_processes=len(survivors),
        process_id=new_rank)
    model.fit(...)                           # on at the reduced shape
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from ..telemetry import emit
from .reshard import reshard_restore


def recover_and_resume(manager_or_dir, build_model,
                       *, coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       inference_only: bool = False, device=None
                       ) -> Tuple[Any, Any, Dict[str, Any], str]:
    """Re-bootstrap the surviving ranks and resume from the last committed
    checkpoint.  Returns ``(model, state, extra, path)``.

    * ``manager_or_dir`` — a ``CheckpointManager`` or its directory
      (anything :func:`~.reshard.reshard_restore` accepts).
    * ``build_model`` — a zero-argument callable returning a model
      compiled under the SURVIVOR topology (or an already compiled
      model).  A callable, because the model (its mesh, its process
      groups) must be built AFTER the new group exists.
    * ``num_processes`` / ``coordinator_address`` / ``process_id`` —
      the REDUCED group; when ``num_processes`` > 1,
      ``distributed.initialize`` joins the new one at a NEW address (the
      old store may still hold the dead group's keys).  Survivors must
      agree on contiguous new ranks, e.g. the sorted surviving old ranks,
      index = new rank.  ``device`` goes to ``initialize``
      (``device="cpu"``: gloo) and to the restore.

    Every survivor, a single one too, first leaves the old group
    (``distributed.shutdown``, under ``distributed.SHUTDOWN_TIMEOUT_S``,
    since a group whose peer died mid-collective may hang in its
    teardown) and raises ``RuntimeError`` when the teardown is still
    blocked past that deadline: a survivor left in the old group would
    build its model's mesh over the dead ranks.

    Emits one ``recovery`` ``phase="resume"`` event naming the new
    process count and the checkpoint it resumed from; the restore is the
    elastic reshard path, whose ``elastic`` event and counter fire when
    the topology changed."""
    from .. import distributed as _dist
    t0 = time.perf_counter()
    if not _dist.shutdown(_dist.SHUTDOWN_TIMEOUT_S):
        raise RuntimeError(
            f"recover_and_resume: the old process group's teardown is "
            f"still blocked after {_dist.SHUTDOWN_TIMEOUT_S} s "
            f"(distributed.SHUTDOWN_TIMEOUT_S); this process cannot join "
            f"the survivors' group — restart it")
    if num_processes is not None and int(num_processes) > 1:
        _dist.initialize(coordinator_address=coordinator_address,
                         num_processes=int(num_processes),
                         process_id=process_id, device=device)
    model = build_model() if callable(build_model) else build_model
    state, extra, path = reshard_restore(manager_or_dir, model,
                                         inference_only=inference_only,
                                         device=device)
    emit("recovery", phase="resume",
         process_count=int(_dist.topology()["process_count"]), path=path,
         step=int(state.step), duration_s=time.perf_counter() - t0)
    return model, state, extra, path
