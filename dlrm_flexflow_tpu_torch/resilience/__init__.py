"""Fault-tolerant training (counterpart of ``dlrm_flexflow_tpu/resilience``).

The survival layer over ``checkpoint.py`` and ``FFModel.fit``: a run
killed at step k restarts from its last atomic checkpoint and continues
bit for bit, and a NaN batch cannot silently destroy the run.

* :class:`CheckpointManager` — atomic commits (tmp dir + fsync + one
  rename), per-file SHA-256 manifests verified on restore, ``keep_n``
  retention + GC of killed-save debris, retry-with-backoff on transient
  I/O errors; a failed save logs telemetry and never aborts the run.
  Under more than one rank, the pod commit (every rank's shard files,
  rank 0's manifest, deadlined file barriers).  Its directories and the
  JAX package's are interchangeable.
* :func:`latest_checkpoint` / :func:`verify_checkpoint` — discovery
  that skips partial and corrupt entries.
* :class:`NaNSentinel` — per-dispatch NaN/Inf detection with rollback +
  skip or lr-backoff policies, bounded by ``max_rollbacks``
  (:class:`TrainingDiverged` past it).
* :mod:`.faultinject` — deterministic fault injection
  (``nan_grads@step=K``, ``io_error@save=N``, ``preempt@step=K``,
  ``preempt@save``, ``preempt+reshape@step=K:mesh=DxM``,
  ``host_crash@step=K``, ``host_hang@step=K``); :class:`Preemption` is
  the injected kill, :class:`Reshape` the kill after which the fleet
  returns with another topology, :class:`HostLost` a hung host waking
  after the fleet declared it dead.
* :mod:`.watchdog` — :func:`heartbeat_ages` / :class:`HostWatchdog` age
  the shared-filesystem heartbeat files and flag dead peers by name;
  :class:`StallWatchdog` turns a silent training stall into a flight
  dump + loud abort; :class:`FleetBarrierTimeout` is the pod commit
  barrier's death, after which the survivors resume through
  ``elastic.recover_and_resume``.

Wired through ``FFModel.fit(checkpoint_manager=..., resume=True,
checkpoint_every_n_steps=..., sentinel=NaNSentinel(...))`` (a checkpoint
of another topology resumes through ``elastic.reshard_restore``); recovery
actions emit ``checkpoint`` / ``anomaly`` / ``fault`` telemetry events.
"""

from .faultinject import HostLost, Preemption, Reshape
from .manager import CheckpointManager, latest_checkpoint, verify_checkpoint
from .sentinel import NaNSentinel, TrainingDiverged
from .watchdog import (FleetBarrierTimeout, HostWatchdog, StallWatchdog,
                       heartbeat_ages)

__all__ = [
    "CheckpointManager", "latest_checkpoint", "verify_checkpoint",
    "NaNSentinel", "TrainingDiverged", "Preemption", "Reshape",
    "HostLost", "FleetBarrierTimeout", "HostWatchdog", "StallWatchdog",
    "heartbeat_ages",
]
