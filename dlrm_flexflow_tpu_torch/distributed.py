"""Multi-process execution (counterpart of
``dlrm_flexflow_tpu/distributed.py``).

The JAX package runs one process per host, each seeing its chips as part
of one global device set.  The port runs one process per rank, each on
one device: a "host" here is a rank.  :func:`initialize` bootstraps the
``torch.distributed`` process group from the JAX package's environment
variables (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``):
NCCL on the card, gloo for ``device="cpu"``.  The coordinator address is
``host:port`` (a ``tcp://`` rendezvous) or any ``torch.distributed``
init URL (``file:///path`` for a shared-file store).  A rank group may
also be started with ``python -m torch.distributed.run``: ``initialize``
then reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
when the JAX variables are absent.

Per-rank data feeding: :func:`host_local_batch` is the rank's slice of
the global batch, :func:`make_global_array` wraps it as a
:class:`GlobalArray` (the rank's rows, in the layout of the rank order),
and :class:`HostShardLoader` yields such batches from any loader, so each
process keeps only its share; ``FFModel.train_step`` takes them as it
takes a global batch.  :func:`launch` starts a group of rank processes
with a deadline (the tests and ``chip_smoke.py`` use it), and
:func:`shutdown` leaves a group under a deadline (``elastic/recovery.py``
joins a smaller one after it).
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

#: the collective and rendezvous deadline of a group that ``initialize``
#: creates: a rank that skips a collective fails the others after this
#: many seconds instead of hanging them
DEFAULT_TIMEOUT_S = 120.0

#: the deadline of :func:`shutdown`'s teardown of a group
SHUTDOWN_TIMEOUT_S = 30.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device=None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join the process group (one call per rank, before any collective).

    Arguments default from ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
    ``PROCESS_ID`` (else torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``).  ``device`` None means the card: the rank
    takes ``cuda:<rank % cards>`` and NCCL; ``device="cpu"`` takes gloo.
    ``backend`` overrides the choice (gloo on the card, two ranks on one
    card).  With one process and no address nothing is initialized.  A
    group already up is kept when its world size is ``num_processes``,
    and raises otherwise (a survivor whose old group never tore down
    must not run in it).  Returns the topology and emits one
    ``distributed`` ``phase="init"`` event."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("NUM_PROCESSES",
                                    env.get("WORLD_SIZE", "1")))
    if process_id is None:
        process_id = int(env.get("PROCESS_ID", env.get("RANK", "0")))
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    import torch.distributed as dist
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: distributed.initialize runs on the card "
                "unless the caller passes device='cpu'")
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != int(num_processes):
            raise RuntimeError(
                f"distributed.initialize: a process group of "
                f"{dist.get_world_size()} ranks is still up, and "
                f"{int(num_processes)} were asked for; leave it first "
                f"(distributed.shutdown)")
    elif num_processes > 1 or coordinator_address is not None:
        url = coordinator_address or "tcp://127.0.0.1:29500"
        if "://" not in url:
            url = f"tcp://{url}"
        dist.init_process_group(
            backend or ("gloo" if cpu else "nccl"), init_method=url,
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=float(timeout_s)))
    info = topology()
    from .telemetry import emit
    emit("distributed", phase="init", **info)
    return info


def shutdown(timeout_s: float = SHUTDOWN_TIMEOUT_S) -> bool:
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``): ``destroy_process_group`` under a
    deadline, best effort.  A group whose peer died mid-collective may
    hang in its teardown, or abort it, so the teardown runs on a daemon
    thread and its errors are swallowed.  Returns True when no group is
    left (none was up, or it was destroyed within ``timeout_s``); False
    when the teardown is still blocked, and then the process cannot join
    another group."""
    import threading

    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return True

    def teardown():
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — a dead peer's group, best effort
            pass

    t = threading.Thread(target=teardown, name="ff-pg-shutdown",
                         daemon=True)
    t.start()
    t.join(float(timeout_s))
    return not dist.is_initialized()


def _identity():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


def topology() -> dict:
    """Process and device layout: every rank is one process with one
    device (``local_devices`` 1); ``slices`` is the two-level shape's top
    level (:func:`pod_topology`)."""
    rank, world = _identity()
    return {
        "process_index": rank,
        "process_count": world,
        "global_devices": world,
        "local_devices": 1,
        "slices": pod_topology().num_slices,
    }


def pod_topology():
    """The running group's two-level shape as a ``sim.cost_model.
    PodTopology``.  A group of several processes is priced as one node
    per process, as the JAX package prices a multi-process fleet off the
    TPU (the process boundary is the slow-link boundary); one process is
    one flat node of its visible cards."""
    from .sim.cost_model import PodTopology
    rank, world = _identity()
    if world > 1:
        return PodTopology(world, 1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return PodTopology(1, max(cards, 1))


def host_local_batch(global_batch: int) -> slice:
    """This rank's slice of the global batch (contiguous first-dim blocks
    in rank order).

    The global batch must divide the process count: a remainder would be
    dropped silently, so it raises."""
    rank, n = _identity()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} does not divide over "
            f"{n} host processes ({global_batch % n} rows would be "
            f"silently dropped) — pad the batch or choose a "
            f"process-count-divisible global batch "
            f"(docs/distributed.md)")
    per_host = global_batch // n
    lo = rank * per_host
    return slice(lo, lo + per_host)


@dataclass
class GlobalArray:
    """The rank's block of a global array: ``local`` holds the rows of
    this rank in ``spec`` (a layout of ``mesh``), ``shape`` the global
    shape.  ``FFModel`` places it by a layout change, never by slicing a
    global copy."""

    local: torch.Tensor
    shape: tuple
    spec: object
    mesh: object


def make_global_array(host_shard, mesh, pspec) -> GlobalArray:
    """The global array whose rank blocks are each rank's ``host_shard``
    (the multi-host form of ``FFModel.shard_batch``): the blocks are in
    rank order, which on a mesh of ``range(world)`` ranks is the layout
    with dim 0 over every mesh axis (``pspec``, the JAX package's target
    sharding, is where the model will hold it and is not needed here)."""
    from .parallel.mesh import PartitionSpec, spec_entry
    rank, n = _identity()
    if not np.array_equal(np.asarray(mesh.devices).reshape(-1),
                          np.arange(mesh.size)) or mesh.size != n:
        raise ValueError("make_global_array needs a mesh over every rank in "
                         "rank order (make_mesh's default devices)")
    local = host_shard if isinstance(host_shard, torch.Tensor) else \
        torch.from_numpy(np.asarray(host_shard))
    axes = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    shape = (local.shape[0] * n,) + tuple(local.shape[1:])
    return GlobalArray(local, shape,
                       PartitionSpec(spec_entry(axes),
                                     *([None] * (local.dim() - 1))), mesh)


class HostShardLoader:
    """Per-rank view of a global-batch loader: wraps any loader yielding
    ``(inputs_dict, labels)`` batches of the global batch size; each rank
    keeps only its :func:`host_local_batch` rows, as a
    :class:`GlobalArray`.  The wrapped loader yields the full global batch
    on every rank (deterministic across processes: every rank runs the
    same loader with the same seed).  Resume (``state_dict`` /
    ``load_state_dict``) and the shape attributes proxy the inner
    loader."""

    def __init__(self, loader, mesh, pspec=None):
        from .parallel.mesh import PartitionSpec
        self._inner = loader
        self.mesh = mesh
        self.pspec = pspec if pspec is not None else PartitionSpec("data")

    def _global(self, arr):
        sl = host_local_batch(int(arr.shape[0]))
        return make_global_array(np.asarray(arr[sl]), self.mesh, self.pspec)

    def __iter__(self):
        for inputs, labels in self._inner:
            yield ({k: self._global(v) for k, v in inputs.items()},
                   self._global(labels))

    def peek(self):
        inputs, labels = self._inner.peek()
        return ({k: self._global(v) for k, v in inputs.items()},
                self._global(labels))

    def state_dict(self):
        sd = getattr(self._inner, "state_dict", None)
        return sd() if callable(sd) else None

    def load_state_dict(self, sd) -> None:
        self._inner.load_state_dict(sd)

    @property
    def num_batches(self) -> int:
        return self._inner.num_batches

    @property
    def batch_size(self) -> int:
        return self._inner.batch_size

    @property
    def inputs(self):
        return getattr(self._inner, "inputs", None)

    @property
    def labels(self):
        return getattr(self._inner, "labels", None)

    @property
    def drop_last(self):
        return getattr(self._inner, "drop_last", False)

    @property
    def shuffle(self):
        return getattr(self._inner, "shuffle", False)

    def __len__(self):
        return len(self._inner)


# ------------------------------------------------------------ rank groups
def _rank_main() -> None:
    """A rank process's body (:func:`launch`): join the group, run the
    target, leave the group.  A rank whose target returned exits through
    ``os._exit(0)`` once its output is flushed: gloo's teardown during
    the interpreter's own exit, after the group is destroyed, sometimes
    aborts the process (``std::terminate``, torch 2.13, about one group
    in twelve under load), which would fail a group whose work is
    done."""
    import importlib

    import torch.distributed as dist
    torch.set_num_threads(int(os.environ.get("FF_RANK_THREADS", "1")))
    mod, fn = os.environ["FF_RANK_TARGET"].split(":")
    kwargs = json.loads(os.environ.get("FF_RANK_ARGS", "{}"))
    dev = os.environ.get("FF_RANK_DEVICE") or None
    initialize(device=dev, backend=os.environ.get("FF_RANK_BACKEND") or None,
               timeout_s=float(os.environ.get("FF_RANK_TIMEOUT",
                                              DEFAULT_TIMEOUT_S)))
    try:
        getattr(importlib.import_module(mod), fn)(**kwargs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def launch(target: str, world: int, *, kwargs: Optional[dict] = None,
           device=None, backend: Optional[str] = None,
           timeout_s: float = 300.0, pythonpath: Sequence[str] = (),
           threads: int = 1) -> List[str]:
    """Run ``target`` (``"module:function"``, called with ``kwargs``) in
    ``world`` rank processes joined by a ``file://`` store, and wait at
    most ``timeout_s``.  Returns each rank's output (stdout and stderr).
    A rank that fails, or a group past its deadline, kills every rank and
    raises ``RuntimeError`` with the ranks' last lines: a group never
    outlives its deadline.  ``pythonpath`` adds import roots (the repo
    root always leads)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tempfile.mkdtemp(prefix="ffrank-")
    store = os.path.join(tmp, "store")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, *pythonpath] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    env.update(COORDINATOR_ADDRESS=f"file://{store}",
               NUM_PROCESSES=str(world), FF_RANK_TARGET=target,
               FF_RANK_ARGS=json.dumps(kwargs or {}),
               FF_RANK_DEVICE="" if device is None else str(device),
               FF_RANK_BACKEND=backend or "",
               FF_RANK_TIMEOUT=str(min(float(timeout_s), DEFAULT_TIMEOUT_S)),
               FF_RANK_THREADS=str(int(threads)))
    logs = [os.path.join(tmp, f"rank{i}.log") for i in range(world)]
    procs = []
    for i in range(world):
        with open(logs[i], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "from dlrm_flexflow_tpu_torch.distributed import "
                 "_rank_main; _rank_main()"],
                env={**env, "PROCESS_ID": str(i)}, stdout=out,
                stderr=subprocess.STDOUT, cwd=repo))
    import time
    deadline = time.monotonic() + float(timeout_s)
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = f"past its {timeout_s:.0f} s deadline"
                break
            bad = [i for i, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].poll()}"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [i for i, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    import shutil
    texts = []
    for path in logs:
        with open(path, errors="replace") as f:
            texts.append(f.read())
    shutil.rmtree(tmp, ignore_errors=True)
    if failed is not None:
        tails = "\n".join(f"--- rank {i} ---\n{t[-3000:]}"
                          for i, t in enumerate(texts))
        raise RuntimeError(f"rank group {target} x{world}: {failed}\n{tails}")
    return texts
