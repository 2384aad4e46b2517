"""Elastic topology: the fleet's shape is a runtime variable (counterpart
of ``dlrm_flexflow_tpu/elastic``, its names and events).

Everything below this package treats the mesh as a run constant:
training places state under ``parallel/mesh.py:partition_rules()``, the
serving engine runs under it, checkpoints restore bit for bit onto it.
A preempted or shrunken fleet breaks that assumption; this package
absorbs the change on both halves of the stack:

* :func:`reshard_restore` / :func:`reshard_state` (``reshard.py``) —
  restore ANY checkpoint (npz or podshard) onto ANY mesh shape: the
  saved leaves are reassembled to host-logical arrays and re-placed under
  the new mesh's partition rules (table-parallel rows re-split on the new
  ``model`` axis, optimizer slots alongside their parameters).  The
  training loop routes resumes through it when the checkpoint's topology
  differs from the model's (``resilience/loop.py``; a
  ``preempt+reshape@step=K:mesh=DxM`` kill names the shape to relaunch
  on).  The values move and never change, so a resumed run tracks the
  never-killed one to the tolerance of the new topology's reduction
  order.
* :class:`ElasticController` / :func:`regate_strategy`
  (``controller.py``) — live serving scale over the port's
  ``ReplicaRouter.scale_to``/``rebuild`` (no accepted request dropped
  across a resize), with the topology-scoped incumbent strategy re-gated
  through ``sim/tune.py`` at every resize; ``heal()`` ejects dead
  replicas and rebuilds capacity.
* :func:`recover_and_resume` (``recovery.py``) — survivor recovery
  after a rank is lost: the survivors tear the process group down, join
  a new one at the reduced world size and resume from the last committed
  checkpoint through :func:`reshard_restore`.

Telemetry: ``elastic`` events (phases ``reshard``/``scale``/``regate``),
``recovery`` ``phase="resume"``, the ``dlrm_elastic_reshard_total``
counter and the ``dlrm_serve_replicas`` gauge.
"""

from .controller import ElasticController, regate_strategy
from .recovery import recover_and_resume
from .reshard import gather_state, host_gather, reshard_restore, reshard_state

__all__ = [
    "ElasticController", "regate_strategy", "gather_state", "host_gather",
    "recover_and_resume", "reshard_restore", "reshard_state",
]
