"""ffcheck pass catalog of the PyTorch port.

The JAX package's 13 passes in its order, each on the port's own idiom
where the hazard has one (finding codes kept where the hazard is the
same):

* ``lock-discipline``   — telemetry emits / future completion under a
  held lock, and inconsistent pairwise lock acquisition order;
* ``blocking-under-lock`` — torch host syncs (``.item()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, ``.synchronize()``), sleeps,
  queue/event waits, raw ``torch.distributed`` collectives, and
  file/socket I/O while any lock is held;
* ``thread-lifecycle``  — class-owned threads/servers need a reachable
  join/shutdown+server_close on the close path;
* ``bounded-growth``    — ``self.X.append/+=`` reachable from
  serve/train/monitor loops with no cap/prune/rotate on the class;
* ``trace-purity``      — host syncs, side effects, telemetry emits and
  host clock reads inside functions a CUDA graph captures
  (``graphs.GraphRunner``/``run_eager`` functions, ``torch.cuda.graph``
  bodies, op forwards, the autograd Functions they apply);
* ``trace-staleness``   — Python state (self attrs, rebindable
  globals, ``os.environ``) read inside captured code and mutated
  outside it: the mutation silently no-ops on every replay;
* ``shared-state``      — attributes shared between thread bodies and
  the public API with no common lock;
* ``recompile-hazard``  — ``GraphRunner``s kept under no signature, or
  under a key derived from tensor values: re-capture storms;
* ``donation-safety``   — the state donated to ``train_step`` read
  again after the call (it now holds the new values);
* ``import-layering``   — module-level imports that climb the port's
  subsystem DAG upward;
* ``collective-divergence`` — collectives (``torch.distributed``, the
  ``parallel/collectives.py`` wrappers, the podshard fence) reachable
  only under rank-divergent control flow;
* ``mesh-axis``         — axis names the mesh does not declare, and raw
  ``torch.distributed`` collectives outside ``parallel/collectives.py``
  and ``distributed.py``;
* ``barrier-protocol``  — podshard fence lifecycle: unswept fences,
  retry loops around the single-attempt barrier, non-rank-0 writes to
  cross-host singleton files.

Adding a pass: subclass AnalysisPass in a new module here, set
``name``/``description``, implement ``run``, append to ``PASSES``.
Build on the shared surfaces (``engine.get_callgraph`` /
``engine.get_value_taint``, ``_entries.py`` for captures, ``_spmd.py``
for collectives, ``_threads.py``/``_locked.py`` for concurrency)
instead of re-walking.
"""

from .barrier import BarrierProtocolPass
from .blocking import BlockingUnderLockPass
from .divergence import CollectiveDivergencePass
from .donation import DonationSafetyPass
from .growth import BoundedGrowthPass
from .layering import ImportLayeringPass
from .lifecycle import ThreadLifecyclePass
from .locks import LockDisciplinePass
from .meshaxis import MeshAxisPass
from .purity import TracePurityPass
from .recompile import RecompileHazardPass
from .sharedstate import SharedStatePass
from .staleness import TraceStalenessPass

PASSES = [
    LockDisciplinePass,
    BlockingUnderLockPass,
    TracePurityPass,
    TraceStalenessPass,
    SharedStatePass,
    ThreadLifecyclePass,
    BoundedGrowthPass,
    RecompileHazardPass,
    DonationSafetyPass,
    ImportLayeringPass,
    CollectiveDivergencePass,
    MeshAxisPass,
    BarrierProtocolPass,
]

__all__ = ["PASSES", "LockDisciplinePass", "BlockingUnderLockPass",
           "TracePurityPass", "TraceStalenessPass", "SharedStatePass",
           "ThreadLifecyclePass", "BoundedGrowthPass",
           "RecompileHazardPass", "DonationSafetyPass",
           "ImportLayeringPass", "CollectiveDivergencePass",
           "MeshAxisPass", "BarrierProtocolPass"]
