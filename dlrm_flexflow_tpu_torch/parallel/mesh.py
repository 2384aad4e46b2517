"""The device mesh and the ParallelConfig -> PartitionSpec translation
(counterpart of ``dlrm_flexflow_tpu/parallel/mesh.py``).

The execution model.  The JAX package is single-controller: one process
holds global arrays, each op's output is constrained to the
``PartitionSpec`` its ``ParallelConfig`` translates to, and XLA SPMD
inserts the collectives.  The port follows the torch idiom instead:

* **one process per rank** (``distributed.initialize``: NCCL on the card,
  gloo for ``device="cpu"``), every rank running the same program;
* a :class:`Mesh` over the ranks with the JAX axis names (``"data"``,
  ``"model"``, ``"seq"``, any other), backed by a
  ``torch.distributed.device_mesh.DeviceMesh`` with those
  ``mesh_dim_names`` and one process group per set of axes;
* **explicit collectives in the op bodies** (``parallel/collectives.py``),
  each one that carries a gradient an autograd function whose backward
  is its exact transpose: all-gather <-> reduce-scatter (sum), all-to-all
  <-> the inverse all-to-all, a ring hop <-> the reverse hop, a sum
  all-reduce <-> a sum all-reduce.

The contracts, each the JAX package's:

* **Global values.**  A sharded state is numerically the single-device
  state: ``init(seed)`` draws the global value from the same generator on
  every rank and keeps the rank's shard; ``load_params`` takes global
  arrays and shards them; ``get_weights`` and ``bridge.params_to_numpy``
  gather.  A rank's shard of a dim sharded over axes ``(a, b)`` is the
  block at the row-major index of its coordinates on those axes, as a
  ``NamedSharding`` lays blocks out.
* **Layouts.**  Every op's output is held in ``pspec_for_config``'s
  layout of its config, or the op's ``output_pspec``, or for an op without
  a config the data-parallel layout (the batch over ``"data"``, or the
  finer batch sharding an input already has, as XLA propagates it).
  Between a producer and a consumer the executor (``parallel/spmd.py``)
  does the layout change that ``constrain`` leaves to XLA: an all-gather
  over the axes a dim loses, then a slice over the axes it gains.
* **Batches.**  Every rank passes the same global batch to the model (the
  JAX API), and the model keeps the rank's rows; a ``GlobalArray`` from
  ``distributed.make_global_array`` (a ``HostShardLoader`` batch) already
  holds them.  The global batch must divide the data axis.
* **Gradients.**  Each rank differentiates its local loss (the mean over
  its rows) scaled by one over the number of ranks, through the exact
  transposes above, and every parameter's gradient is summed over the
  mesh axes its layout replicates it on.  That is the gradient of the
  global mean loss: for a data-parallel parameter it is the mean over
  ``"data"`` of the ranks' gradients, and after an ``all_to_all`` table
  exchange, whose output is batch-sharded over both axes, the mean over
  ``"data"`` and ``"model"``.
* **A mesh whose axes are all of size 1** runs the same program as no
  mesh, bit for bit, kernels and CUDA-graph capture included (the JAX
  package's ``{"data": 1}`` contract): the model treats it as no mesh.
"""

from __future__ import annotations

import itertools
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .parallel_config import ParallelConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), an axis name, or a
    tuple of axis names (the dim sharded over their product, the first
    axis major).  Equal by value, so ``tuple(spec)`` reads as the JAX
    ``PartitionSpec``'s."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first (``()`` for None)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_entry(axes: Sequence[str]):
    """The inverse of :func:`entry_axes`: None, a name, or a tuple."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


class Mesh:
    """A named grid of ranks: ``devices`` is the ndarray of global ranks
    (the JAX ``Mesh.devices``' shape), ``axis_names`` its names, ``shape``
    the ``{name: size}`` dict.  ``coords`` is this process's coordinate
    on each axis, or None on a rank outside the mesh.

    Built collectively: every rank of the default process group must
    construct the same mesh in the same order (``make_mesh``), since it
    creates the process groups of every set of axes.  A mesh of one rank
    needs no process group at all, and ``groups=False`` builds a layout-
    only mesh (shapes and specs, no collective) in any process."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 groups: bool = True):
        import torch.distributed as dist

        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D mesh")
        self.shape = {n: int(s) for n, s in
                      zip(self.axis_names, self.devices.shape)}
        self.size = int(self.devices.size)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.devices == self.rank)
        self.coords = ({n: int(c) for n, c in zip(self.axis_names, where[0])}
                       if len(where) else None)
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._group_ranks: Dict[Tuple[str, ...], List[int]] = {}
        if self.size > 1 and groups:
            self._build_groups()

    # ------------------------------------------------------------ groups
    def _build_groups(self) -> None:
        """The DeviceMesh (one group per axis) and a group per set of two
        or more axes, each created by every rank in one order."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {self.size} ranks needs a process group: call "
                "distributed.initialize() on every rank first")
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = DeviceMesh(dev, torch.as_tensor(self.devices),
                                      mesh_dim_names=self.axis_names)
        names = self.axis_names
        big = [n for n in names if self.shape[n] > 1]
        for k in range(1, len(big) + 1):
            for subset in itertools.combinations(big, k):
                others = [n for n in names if n not in subset]
                for fixed in itertools.product(
                        *[range(self.shape[n]) for n in others]):
                    ranks = self._ranks_of(subset, dict(zip(others, fixed)))
                    if k == 1:
                        pg = (self.device_mesh.get_group(subset[0])
                              if self.coords is not None
                              and self._on(others, fixed) else None)
                    else:
                        pg = dist.new_group(ranks)
                    if self.coords is not None and self._on(others, fixed):
                        self._groups[subset] = pg
                        self._group_ranks[subset] = ranks

    def _on(self, others, fixed) -> bool:
        return all(self.coords[n] == f for n, f in zip(others, fixed))

    def _ranks_of(self, subset, fixed) -> List[int]:
        """The ranks of one group over ``subset``, row-major over the
        subset's axes in mesh order (the order a gather concatenates)."""
        out = []
        for idx in itertools.product(*[range(self.shape[n])
                                       for n in subset]):
            at = dict(fixed)
            at.update(zip(subset, idx))
            out.append(int(self.devices[tuple(at[n]
                                              for n in self.axis_names)]))
        return out

    def axes_key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` without size-1 axes, in mesh order (raises for axes
        given out of mesh order: a gather over them would concatenate in
        another order than the spec means)."""
        axes = tuple(a for a in axes if self.shape.get(a, 1) > 1)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def group(self, axes: Sequence[str]):
        """``(process group, its ranks, this rank's index in them)`` over
        ``axes``; ``(None, [rank], 0)`` when they hold one rank."""
        key = self.axes_key(axes)
        if not key:
            return None, [self.rank], 0
        ranks = self._group_ranks[key]
        return self._groups[key], ranks, ranks.index(self.rank)

    def axis_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (major first)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + (
                self.coords.get(a, 0) if self.coords else 0)
        return idx

    @property
    def trivial(self) -> bool:
        """Every axis of size 1: the program is the no-mesh one."""
        return self.size == 1

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a named mesh.  Default: all devices on the "data" axis.

    ``shape`` e.g. {"data": 4, "model": 2}. Axis sizes must multiply to the
    device count used.  ``devices`` are global ranks (default: every rank
    of the process group, or rank 0 alone without one); the mesh takes the
    first ``prod(shape)`` of them.  Every rank must call it alike."""
    import torch.distributed as dist

    if devices is None:
        devices = list(range(dist.get_world_size()
                             if dist.is_initialized() else 1))
    devices = list(devices)
    if shape is None:
        shape = {DATA_AXIS: len(devices)}
    names = tuple(shape.keys())
    sizes = tuple(int(shape[n]) for n in names)
    n = int(np.prod(sizes))
    assert n <= len(devices), f"mesh {shape} needs {n} devices, have {len(devices)}"
    return Mesh(np.array(devices[:n]).reshape(sizes), names)


def pspec_for_config(pc: Optional[ParallelConfig], ndim: int,
                     mesh: Mesh) -> PartitionSpec:
    """Translate an op's output ParallelConfig into a PartitionSpec (the
    JAX package's rules):
      dims[0]   > 1  -> shard batch dim over "data"      (sample parallel)
      dims[-1]  > 1  -> shard last dim over "model"      (channel parallel)
      dims[i] > 1 for middle dims -> "seq" axis if present, else "model"
                        (attribute/spatial parallelism, conv h/w parts)
    Unpartitioned dims -> None (replicated)."""
    if pc is None:
        return PartitionSpec(DATA_AXIS, *([None] * (ndim - 1)))
    axes = [None] * ndim
    dims = list(pc.dims) + [1] * (ndim - len(pc.dims))
    have = set(mesh.axis_names)
    if dims[0] > 1 and DATA_AXIS in have:
        axes[0] = DATA_AXIS
    used_model = False
    for i in range(1, ndim):
        if dims[i] > 1:
            if i == ndim - 1 and MODEL_AXIS in have and not used_model:
                axes[i] = MODEL_AXIS
                used_model = True
            elif SEQ_AXIS in have and axes.count(SEQ_AXIS) == 0:
                axes[i] = SEQ_AXIS
            elif MODEL_AXIS in have and not used_model:
                axes[i] = MODEL_AXIS
                used_model = True
    return PartitionSpec(*axes)


def effective_config(pc: Optional[ParallelConfig], ndim: int, mesh: Mesh):
    """What the mesh ACTUALLY executes for ``pc``: ``(executed_dims,
    exact)``.  Execution shards by named mesh axis, so a partition degree
    is coerced to the axis size and an explicit device list other than
    ``range(n)`` is not routable; ``exact`` is False when either
    narrowing fires (compile warns with the op list)."""
    if pc is None:
        return None, True
    spec = pspec_for_config(pc, ndim, mesh)
    sizes = dict(mesh.shape)
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    eff = tuple(int(sizes.get(ax, 1)) if ax is not None else 1
                for ax in entries)
    req = tuple(pc.dims) + (1,) * (ndim - len(pc.dims))
    n_eff = int(np.prod(eff))
    ids = pc.device_ids
    ids_canonical = ids is None or list(ids) == list(range(n_eff)) or (
        n_eff == 1 and len(ids) == 1 and ids[0] == 0)
    return eff, (eff == req and ids_canonical)


def param_pspec(sharded_dim: Optional[int], ndim: int, mesh: Mesh,
                tensor_parallel: bool) -> PartitionSpec:
    """Weight sharding: replicated for DP; sharded over "model" on
    ``sharded_dim`` when the owning op is tensor-parallel."""
    axes = [None] * ndim
    if tensor_parallel and sharded_dim is not None and MODEL_AXIS in mesh.axis_names:
        axes[sharded_dim] = MODEL_AXIS
    return PartitionSpec(*axes)


class NamedSharding:
    """A layout on a mesh: the JAX ``NamedSharding``'s two fields."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def sharding(mesh: Mesh, spec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, spec)


# ------------------------------------------------------------- topology ids
# Topologies are plain {axis: size} dicts so they survive a JSON round
# trip; comparison drops size-1 axes (a {"data": 1} mesh and no mesh run
# the same program).

def mesh_topology(mesh: Optional[Mesh]) -> Dict[str, int]:
    """``{axis_name: size}`` of a mesh; ``{}`` for no mesh (single
    device).  JSON-able: the form checkpoints record."""
    if mesh is None:
        return {}
    return {str(n): int(s)
            for n, s in zip(mesh.axis_names, mesh.devices.shape)}


def _effective_topology(topo: Optional[Dict[str, int]]) -> Dict[str, int]:
    return {k: int(v) for k, v in (topo or {}).items() if int(v) > 1}


def same_topology(a: Optional[Dict[str, int]],
                  b: Optional[Dict[str, int]]) -> bool:
    """Whether two topology dicts execute the same partitioning.
    Size-1 axes (and None/{}) are equivalent: they replicate."""
    return _effective_topology(a) == _effective_topology(b)


def format_topology(topo: Optional[Dict[str, int]]) -> str:
    """``"data=2,model=4"``, or ``"single"`` when nothing is actually
    partitioned."""
    eff = _effective_topology(topo)
    if not eff:
        return "single"
    return ",".join(f"{k}={v}" for k, v in sorted(eff.items()))


def constrain(x, mesh: Optional[Mesh], spec: PartitionSpec, *, src=None):
    """The layout change the JAX ``constrain`` leaves to XLA: ``x``, held
    in layout ``src`` (default: the data-parallel layout of its rank),
    returned in ``spec``; the identity without a mesh."""
    if mesh is None or mesh.trivial:
        return x
    from .collectives import relayout
    if src is None:
        src = PartitionSpec(DATA_AXIS, *([None] * (x.dim() - 1)))
    return relayout(x, src, spec, mesh)


# ------------------------------------------------- spec-driven partition rules
# An ordered (regex, PartitionSpec) list over "op/param" paths, derived
# once from a compiled model and applicable to any structurally
# compatible params tree; first match wins, and the trailing (".*",
# replicated) rule makes the set total.

PartitionRules = List[Tuple[str, PartitionSpec]]


def partition_rules(model) -> PartitionRules:
    """Ordered ``(path-regex, PartitionSpec)`` rules for ``model``'s
    param tree, one exact-path rule per parameter plus a replicated
    catch-all.  Paths are ``"<op>/<param>"``.  Requires a compiled model
    with an active mesh."""
    assert model.mesh is not None, "partition_rules needs a mesh"
    rules: PartitionRules = []
    for op_name, by_param in model._param_shardings().items():
        for param_name, shd in by_param.items():
            path = f"{re.escape(op_name)}/{re.escape(param_name)}"
            rules.append((f"^{path}$", shd.spec))
    rules.append((".*", PartitionSpec()))
    return rules


def match_partition_rule(rules: PartitionRules, path: str) -> PartitionSpec:
    """The first rule whose regex matches ``path``; ``ValueError`` only
    when nothing matches and the set has no catch-all."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    raise ValueError(f"no partition rule matches {path!r}")


def apply_partition_rules(rules: PartitionRules, tree: Dict[str, dict],
                          mesh: Mesh) -> Dict[str, dict]:
    """This rank's shard of every leaf of a ``{op: {param: global
    tensor}}`` tree under the spec its first matching rule names.  A
    sharded rule whose axis does not divide the leaf's dim falls back to
    replicated, as in the JAX package."""
    import torch

    from .collectives import local_block
    out: Dict[str, dict] = {}
    for op_name, by_param in tree.items():
        placed = {}
        for param_name, leaf in by_param.items():
            spec = match_partition_rule(rules, f"{op_name}/{param_name}")
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(np.asarray(leaf))
            ndim = leaf.dim()
            entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
            ok = all(ax is None
                     or (i < ndim and leaf.shape[i]
                         % mesh.axis_size(entry_axes(ax)) == 0)
                     for i, ax in enumerate(entries))
            spec = PartitionSpec(*entries[:ndim]) if ok else PartitionSpec()
            placed[param_name] = local_block(leaf, spec, mesh)
        out[op_name] = placed
    return out
