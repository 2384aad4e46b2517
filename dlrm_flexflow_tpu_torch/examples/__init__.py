"""The repo's example scripts (``examples/*.py``) on the port.

One module per script, under the script's name, each run as ``python -m
dlrm_flexflow_tpu_torch.examples.<name>`` with the script's command line
and printing the script's lines, with the port's numbers.  Only
``dlrm_criteo`` parses arguments and ``dlrm_synthetic`` forwards them to
``apps/dlrm.py::run``; the others, like their scripts, read none.

Each module's entry point is ``main(argv=None, *, device=None)``:
``device`` None means the CUDA card, and without one ``main`` raises
(``device.resolve_device``) before it builds anything; tests pass
``device="cpu"``.  The three scripts that read JAX's device count
(``dlrm_hybrid_strategy``, ``dlrm_kaggle_ragged``,
``long_context_ring_attention``) read the world size of the rank group
instead (:func:`rank_group`): started under ``python -m
torch.distributed.run --nproc_per_node=N``, each rank joins the group
and builds its mesh over all of them; without a launcher the world is 1
and the script takes its one-device branch.
"""

from __future__ import annotations

import contextlib
import os

from ..distributed import initialize
from ..parallel.mesh import PartitionSpec


@contextlib.contextmanager
def rank_group(device):
    """The launcher's rank group, joined and left as ``apps/dlrm.py::run``
    joins and leaves it (``distributed.initialize`` when ``WORLD_SIZE``
    or ``NUM_PROCESSES`` is above 1, ``destroy_process_group`` at the
    end); yields the world size, 1 without a launcher."""
    import torch.distributed as dist
    group = int(os.environ.get("NUM_PROCESSES",
                               os.environ.get("WORLD_SIZE", "1"))) > 1
    if group:
        initialize(device=device)
    try:
        yield dist.get_world_size() if group else 1
    finally:
        if group:
            dist.destroy_process_group()


def block_spec(t) -> PartitionSpec:
    """The ``PartitionSpec`` of a parameter as the port records it on a
    mesh block (``_ff_layout``); a parameter held whole is replicated,
    as JAX's ``.sharding.spec`` then reads."""
    layout = getattr(t, "_ff_layout", None)
    return layout[1] if layout is not None else PartitionSpec(
        *([None] * t.dim()))
