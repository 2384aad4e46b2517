"""The mesh executor: a compiled model's forward and training step across
the ranks of a mesh (the contracts are in ``parallel/mesh.py``).

:class:`SpmdPlan` is built by ``FFModel.compile`` under a mesh of more
than one rank.  It fixes one layout (a :class:`~.mesh.PartitionSpec`) for
every tensor of the graph and every parameter, and runs each op on the
rank's blocks:

* **Natively sharded ops** compute on their own shards: a channel-parallel
  ``Linear`` (its weight's columns), a table-sharded ``StackedEmbedding``
  (its T/mp tables, the pooled rows gathered over ``"model"`` as the op's
  layout asks; an int8 serving table reads its T/mp tables' rows of the
  replicated scale column), a host-placed ``Embedding`` (the hetero
  strategy: the owner rank's lookup over the global batch,
  ``ops/hetero.py::HostBagMeshFn``), an exchange-mode
  ``StackedEmbedding`` or ``OverlappedEmbedBottom``
  (``parallel/table_exchange.py``, ``parallel/overlap.py``), a
  ``MixtureOfExperts`` whose experts are
  sharded (its experts, the combined output summed over ``"model"``), and
  a ``MultiHeadAttention(seq_parallel=True)`` over a ``"seq"`` axis (ring
  attention).
* **Every other op** runs generically: its sharded parameters are
  gathered, its inputs brought to "the output's batch sharding, every
  other dim whole", the op's own forward computes the rank's rows, and
  the output's layout is sliced out.  A spatial (H/W) partition of a
  conv or pool therefore computes whole images of the rank's batch shard
  and keeps its tile: JAX's values.  A halo exchange, which would compute
  only the tile, is later speed work (ROADMAP item 1).  An op that mixes
  batch rows (batch norm's statistics, dropout's masks, which hash the
  global position, a concat, split, softmax or flip over dim 0, a
  transpose or reshape of dim 0) computes the whole batch on every rank.

The training step (:func:`step_body`) differentiates the rank's local
loss scaled by ``1 / (the number of ranks that hold each row)``, times
``1 / (the number of row shards)`` for a mean loss, through the exact
transposes of ``parallel/collectives.py``, and sums each parameter's
gradient over the axes its layout replicates it on: the gradient of the
global loss.  A row-sparse table (``FFModel._sparse_ops``) gathers its
rows for the rank's ids as the forward's leaf; after the backward every
rank gathers the ids and row gradients of every rank holding a replica
of its table (or of its T/mp tables), in rank order, which is the global
batch's order, and applies the same update, so the replicas stay equal
bit for bit.

Under a mesh no hand-written kernel runs, as in the JAX package
(``allow_kernel=mesh is None``): ``compile`` clears every op's
``_allow_kernel`` and sets the model's row update to the plain
``row_update_ref``, so the bag and the fused interaction take their plain
paths.  A rank-local kernel under a mesh is later speed work (ROADMAP
item 1).  The step runs eagerly: a CUDA graph cannot capture the gloo
collectives, and capturing NCCL ones is later work (ROADMAP item 1).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch

from .collectives import (all_gather, all_reduce_sum_, gather_cat,
                          local_block, normalize, psum, relayout,
                          replicated_axes)
from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PartitionSpec,
                   entry_axes, pspec_for_config, spec_entry)


def _spec(batch_axes, ndim: int) -> PartitionSpec:
    """The layout with dim 0 over ``batch_axes`` and every other dim
    whole."""
    if ndim == 0:
        return PartitionSpec()
    return PartitionSpec(spec_entry(batch_axes), *([None] * (ndim - 1)))


def _batch_coupled(op) -> bool:
    """Whether the op mixes batch rows, so that it must see the whole
    batch."""
    from ..ops import (BatchNorm, Concat, Dropout, Reshape, Reverse,
                       Softmax, Split, Transpose)
    if isinstance(op, (BatchNorm, Dropout)):
        return True
    if isinstance(op, (Concat, Split, Reverse, Softmax)):
        nd = op.inputs[0].ndim
        return op.axis % nd == 0
    if isinstance(op, Transpose):
        return op.perm[0] != 0
    if isinstance(op, Reshape):
        return op.outputs[0].shape[0] != op.inputs[0].shape[0]
    return False


class SparseRows:
    """The row-sparse leaves of one step: for each sparse op the flat
    table it reads, the flat ids of the rank's rows and the rows leaf."""

    def __init__(self, names):
        self.names = set(names)
        self.entries: List[tuple] = []

    def take(self, op, flat, gids):
        from ..ops.embedding import take_rows
        with torch.no_grad():
            rows = take_rows(flat, gids)
        rows.requires_grad_()
        self.entries.append((op, flat, gids, rows))
        return rows


class SpmdPlan:
    """The layouts of a compiled model's tensors and parameters on
    ``mesh``, and the executor that runs them."""

    def __init__(self, model, mesh):
        self.mesh = mesh
        self.model = model
        self.batch = (model._inputs[0].shape[0] if model._inputs else None)
        has = set(mesh.axis_names)
        self.data_axes = ((DATA_AXIS,) if DATA_AXIS in has
                          and mesh.shape[DATA_AXIS] > 1 else ())
        specs: Dict[int, PartitionSpec] = {}
        for t in model._inputs:
            specs[t.uid] = (_spec(self.data_axes, t.ndim) if self._aligned(t)
                            else PartitionSpec())
        for op in model.layers:
            for t, s in zip(op.outputs, self._out_specs(op, specs)):
                specs[t.uid] = s
        self.specs = specs
        self.params: Dict[str, Dict[str, PartitionSpec]] = {
            op: {k: v.spec for k, v in d.items()}
            for op, d in model._param_shardings().items()}

    # ------------------------------------------------------------ layouts
    def _aligned(self, t) -> bool:
        return t.ndim >= 1 and t.shape[0] == self.batch

    def _default(self, op, t, specs) -> PartitionSpec:
        """An output without a config: the finest batch sharding over
        ``"data"`` among its inputs (as XLA propagates it), else the
        data-parallel layout."""
        if not self._aligned(t):
            return PartitionSpec()
        best = self.data_axes
        for x in op.inputs:
            if self._aligned(x) and x.uid in specs:
                b = self.mesh.axes_key(entry_axes(tuple(specs[x.uid])[0]))
                if b[:1] == self.data_axes[:1] and len(b) > len(best):
                    best = b
        return _spec(best, t.ndim)

    def _out_specs(self, op, specs) -> List[PartitionSpec]:
        xmode = getattr(op, "exchange_mode", None)
        if xmode:
            b = ((DATA_AXIS, MODEL_AXIS) if xmode == "all_to_all"
                 else (DATA_AXIS,))
            b = self.mesh.axes_key(tuple(a for a in b
                                         if a in self.mesh.axis_names))
            return [_spec(b, t.ndim) for t in op.outputs]
        pc = op.parallel_config
        out = [self._default(op, t, specs) for t in op.outputs]
        if pc is not None and pc.device_type != "cpu":
            ndim = op.outputs[0].ndim
            if hasattr(op, "output_pspec"):
                out[0] = op.output_pspec(pc, self.mesh)
            else:
                out[0] = pspec_for_config(pc, ndim, self.mesh)
        return out

    def param_spec(self, op, name) -> PartitionSpec:
        return self.params.get(op.name, {}).get(name, PartitionSpec())

    def sharded(self, op, name) -> bool:
        spec = self.param_spec(op, name)
        return any(self.mesh.axes_key(e) for e in normalize(spec, len(spec)))

    def full_param(self, op, name, value):
        """The global value of a parameter, gathered differentiably from
        the rank's block."""
        for i, axes in enumerate(normalize(self.param_spec(op, name),
                                           value.dim())):
            value = all_gather(value, self.mesh, axes, dim=i)
        return value

    # ----------------------------------------------------------- executor
    def apply(self, params, input_values, *, training: bool, rng=None,
              bn_state=None, sparse: Optional[SparseRows] = None):
        """The graph on the rank's blocks: values by tensor uid, each in
        ``self.specs[uid]``, and the stateful ops' new state."""
        from ..ops import Dropout
        from ..ops.softmax import fold_in
        model = self.model
        values: Dict[int, torch.Tensor] = {}
        for t in model._inputs:
            if t.name in input_values:
                values[t.uid] = input_values[t.name]
        new_bn: Dict[str, Any] = {}
        for i, op in enumerate(model.layers):
            xs = [values[t.uid] for t in op.inputs]
            kw = {}
            stateful = getattr(op, "has_state", False)
            if stateful:
                kw["state"] = bn_state.get(op.name) if bn_state else None
            op_rng = (fold_in(rng, i) if isinstance(op, Dropout) and training
                      and rng is not None else None)
            outs = self.run_op(op, params.get(op.name, {}), xs,
                               training=training, rng=op_rng, sparse=sparse,
                               **kw)
            if stateful:
                new_bn[op.name] = op._last_state
            for o, t in zip(outs, op.outputs):
                values[t.uid] = o
        return values, new_bn

    def run_op(self, op, p, xs, *, training, rng, sparse, **kw):
        in_specs = [self.specs[t.uid] for t in op.inputs]
        out_specs = [self.specs[t.uid] for t in op.outputs]
        native = _NATIVE.get(type(op).__name__)
        if native is not None:
            outs = native(self, op, p, xs, in_specs, out_specs,
                          training=training, rng=rng, sparse=sparse, **kw)
            if outs is not None:
                return outs
        b = (() if _batch_coupled(op) or not self._aligned(op.outputs[0])
             else self.mesh.axes_key(entry_axes(tuple(out_specs[0])[0])))
        xs_c = [relayout(x, s, _spec(b, x.dim()) if self._aligned(t)
                         else PartitionSpec(), self.mesh)
                for x, s, t in zip(xs, in_specs, op.inputs)]
        if sparse is not None and op.name in sparse.names:
            table = p["embedding"]
            rows = sparse.take(op, table.view(-1, table.shape[-1]),
                               op.flat_ids(xs_c[0]))
            p = {"embedding": table, "rows__": rows}
        else:
            p = {k: self.full_param(op, k, v) for k, v in p.items()}
        outs = op.forward(p, xs_c, training=training, rng=rng, **kw)
        return [relayout(o, _spec(b, o.dim()) if self._aligned(t)
                         else PartitionSpec(), s, self.mesh)
                for o, t, s in zip(outs, op.outputs, out_specs)]

    # ---------------------------------------------------- batches, values
    def place(self, t, value):
        """The rank's block of a model input: a ``GlobalArray`` already
        holds it; a global batch is sliced (the batch must divide the
        data axis)."""
        from ..distributed import GlobalArray
        spec = self.specs[t.uid]
        if isinstance(value, GlobalArray):
            return relayout(value.local, value.spec, spec, self.mesh)
        self.check_batch(value.shape[0] if value.dim() else 0)
        return local_block(value, spec, self.mesh)

    def check_batch(self, b: int) -> None:
        dp = self.mesh.axis_size(self.data_axes)
        if dp > 1 and b % dp:
            raise ValueError(
                f"global batch {b} does not divide over the {dp}-way "
                f"'{DATA_AXIS}' mesh axis ({b % dp} rows would be silently "
                f"dropped) — pad the batch or choose a data-axis-divisible "
                f"global batch")

    def labels_for(self, labels, final):
        """The labels in the final output's layout."""
        from ..distributed import GlobalArray
        spec = self.specs[final.uid]
        if isinstance(labels, GlobalArray):
            return relayout(labels.local, labels.spec, spec, self.mesh)
        self.check_batch(labels.shape[0])
        return local_block(labels, spec, self.mesh)

    def batch_axes(self, t) -> tuple:
        """The axes a tensor's rows are sharded over (the loss's shards)."""
        spec = self.specs[t.uid]
        return self.mesh.axes_key(entry_axes(tuple(spec)[0])) if len(
            spec) else ()

    def global_output(self, value, t):
        """A tensor's global value on every rank."""
        return relayout(value, self.specs[t.uid], PartitionSpec(), self.mesh)


# ------------------------------------------------------------ native ops
def _linear(plan, op, p, xs, in_specs, out_specs, **_):
    """Channel parallel: the op's own forward on the kernel's columns (and
    the bias's entries) of each model rank; the output's last dim comes
    out sharded over ``"model"``.  A softmax reads the whole last dim, so
    it takes the generic path."""
    if op.activation == "softmax" or not plan.sharded(op, "kernel"):
        return None
    mesh = plan.mesh
    kspec = normalize(plan.param_spec(op, "kernel"), 2)
    if kspec[0] or not kspec[1]:
        return None
    (x,), (s,) = xs, in_specs
    b = mesh.axes_key(entry_axes(tuple(out_specs[0])[0]))
    x = relayout(x, s, _spec(b, x.dim()), mesh)
    (y,) = op.forward(p, [x])
    held = list(_spec(b, y.dim()))
    held[-1] = spec_entry(kspec[1])
    return [relayout(y, PartitionSpec(*held), out_specs[0], mesh)]


def _rank_scale(plan, op, p):
    """``p`` with an int8 table's scale column cut to the rank's tables'
    rows: the serving engine places the global column replicated, as the
    JAX package does, and a table sharded over its first dim reads only
    its T/mp tables (local flat ids)."""
    from ..ops.quantized import QSCALE_KEY
    qs = p.get(QSCALE_KEY)
    if qs is None or not plan.sharded(op, "embedding"):
        return p
    table = p["embedding"]
    axes = plan.mesh.axes_key(normalize(plan.param_spec(op, "embedding"),
                                        table.dim())[0])
    n = table.shape[0] * table.shape[1]
    j = plan.mesh.axis_index(axes)
    return {**p, QSCALE_KEY: qs[j * n:(j + 1) * n]}


def _stacked(plan, op, p, xs, in_specs, out_specs, training=False,
             sparse=None, **_):
    """Exchange mode: the op's forward runs the table exchange on the
    rank's tables and data shard.  Tables sharded over ``"model"`` without
    an exchange: the op's own forward looks the rank's T/mp tables up for
    the output's batch sharding, and the pooled rows are brought to the
    output's layout.  Replicated tables take the generic path."""
    mesh = plan.mesh
    if getattr(op, "exchange_mode", None):
        xs = [relayout(x, s, _spec(plan.data_axes, x.dim()), mesh)
              for x, s in zip(xs, in_specs)]
        return op.forward(_rank_scale(plan, op, p), xs, training=training)
    if type(op).__name__ != "StackedEmbedding" or not plan.sharded(
            op, "embedding"):
        return None
    axes = mesh.axes_key(normalize(plan.param_spec(op, "embedding"), 3)[0])
    (ids,), (s,) = xs, in_specs
    b = mesh.axes_key(entry_axes(tuple(out_specs[0])[0]))
    ids = relayout(ids, s, _spec(b, ids.dim()), mesh)
    table = p["embedding"]
    t_loc = table.shape[0]
    j = mesh.axis_index(axes)
    local = ids[:, j * t_loc:(j + 1) * t_loc]
    from ..ops.quantized import QSCALE_KEY
    q = {k: v for k, v in _rank_scale(plan, op, p).items()
         if k in ("embedding", QSCALE_KEY)}
    if sparse is not None and op.name in sparse.names:
        q["rows__"] = sparse.take(op, table.view(-1, table.shape[-1]),
                                  op.flat_ids(local))
    (out,) = op.forward(q, [local], training=training)
    held = PartitionSpec(spec_entry(b), spec_entry(axes), None)
    return [relayout(out, held, out_specs[0], mesh)]


def _host_embedding(plan, op, p, xs, in_specs, out_specs, **_):
    """A host-placed table (the hetero strategy): the leader's bag
    (``ops/hetero.py::HostBagMeshFn``) on the ids as the rank holds them,
    its pooled rows returned in the output's batch sharding.  A table on
    the card takes the generic path."""
    if getattr(op, "placement", "tpu") != "cpu":
        return None
    from ..ops.hetero import host_embedding_bag
    mesh = plan.mesh
    (ids,), (s,) = xs, in_specs
    if ids.dim() != 2:
        raise ValueError(f"{op.name}: a host-placed table takes bagged "
                         f"(B, bag) ids, got {tuple(ids.shape)}")
    held = mesh.axes_key(entry_axes(tuple(s)[0])) if len(s) else ()
    b = mesh.axes_key(entry_axes(tuple(out_specs[0])[0]))
    table = getattr(op, "host_table", None)
    out = host_embedding_bag(ids, p["handle"], table.key if table else None,
                             op.out_dim,
                             op.aggr if op.aggr != "none" else "sum",
                             comm=op._host_comm, ids_axes=held, out_axes=b)
    out = out.to(op.outputs[0].dtype)
    return [relayout(out, _spec(b, out.dim()), out_specs[0], mesh)]


def _moe(plan, op, p, xs, in_specs, out_specs, **_):
    """Expert parallel: each model rank runs its E/mp experts on the
    batch shard and weighs them by their gates (the op's own expert sum);
    the weighted sums are added over ``"model"`` in f64 and rounded once,
    as the op's sum over every expert rounds once."""
    if not plan.sharded(op, "w_in"):
        return None
    mesh = plan.mesh
    axes = mesh.axes_key(normalize(plan.param_spec(op, "w_in"), 3)[0])
    (x,), (s,) = xs, in_specs
    b = mesh.axes_key(entry_axes(tuple(out_specs[0])[0]))
    x = relayout(x, s, _spec(b, x.dim()), mesh)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    gates = op._gates(xf, p["router"])
    e_loc = p["w_in"].shape[0]
    j = mesh.axis_index(axes)
    part = op._expert_sum(xf, gates[:, j * e_loc:(j + 1) * e_loc], p)
    out = psum(part, mesh, axes).float()
    op._last_aux_loss = op._load_balance_loss(gates)
    out = out.reshape(lead + (x.shape[-1],)).to(op.outputs[0].dtype)
    return [relayout(out, _spec(b, out.dim()), out_specs[0], mesh)]


def _attention(plan, op, p, xs, in_specs, out_specs, training=False, **_):
    """Sequence parallel: q, k and v sharded over ``"seq"`` on their
    sequence dim, the op's forward running ring attention on the rank's
    blocks (parameters gathered if sharded)."""
    mesh = plan.mesh
    if not (op.seq_parallel and mesh.shape.get(SEQ_AXIS, 1) > 1):
        return None
    b = mesh.axes_key(entry_axes(tuple(out_specs[0])[0]))
    if SEQ_AXIS in b:
        return None
    held = PartitionSpec(spec_entry(b), SEQ_AXIS, None)
    xs = [relayout(x, s, held, mesh) for x, s in zip(xs, in_specs)]
    p = {k: plan.full_param(op, k, v) for k, v in p.items()}
    (out,) = op.forward(p, xs, training=training)
    return [relayout(out, held, out_specs[0], mesh)]


_NATIVE = {
    "Linear": _linear,
    "Embedding": _host_embedding,
    "StackedEmbedding": _stacked,
    "OverlappedEmbedBottom": _stacked,
    "MixtureOfExperts": _moe,
    "MultiHeadAttention": _attention,
}


# ----------------------------------------------------------- the step
def loss_scale(plan, final, loss_type: str) -> float:
    """The factor on a rank's local loss whose gradient, summed over the
    ranks, is the global loss's: one over the ranks holding each row, and
    for a mean loss one over the row shards too."""
    shards = plan.mesh.axis_size(plan.batch_axes(final))
    replicas = plan.mesh.size // shards
    mean = not str(loss_type).endswith("sum_reduce")
    return 1.0 / (replicas * (shards if mean else 1))


def reduce_metrics(plan, final, mets, loss, loss_type: str):
    """The global metric sums and loss from the rank's: summed over the
    row shards (the other ranks hold the same rows), the loss averaged
    over them for a mean loss."""
    axes = plan.batch_axes(final)
    out = {k: all_reduce_sum_(v.clone(), plan.mesh, axes)
           for k, v in mets.items()}
    total = all_reduce_sum_(loss.detach().clone(), plan.mesh, axes)
    if not str(loss_type).endswith("sum_reduce"):
        total = total / plan.mesh.axis_size(axes)
    out["loss"] = total
    return out


def forward_values(model, params, inputs, bn_state, *, training=False,
                   rng=None, sparse=None):
    """The plan's forward, and the loss input held in the final output's
    layout."""
    plan = model._spmd
    values, new_bn = plan.apply(params, inputs, training=training, rng=rng,
                                bn_state=bn_state, sparse=sparse)
    final = model.final_tensor
    loss_t = next(t for op in model.layers for t in op.outputs
                  if t.uid == model._loss_uid)
    values[model._loss_uid] = relayout(values[model._loss_uid],
                                       plan.specs[loss_t.uid],
                                       plan.specs[final.uid], plan.mesh)
    return values, new_bn


def step_body(model, batch, carried):
    """``FFModel._step_body`` across the mesh: the same step, the same
    state updated in place, the same packed metrics (module docstring)."""
    from ..metrics import compute_metrics
    from ..ops.softmax import fold_in
    plan = model._spmd
    mesh = plan.mesh
    params, opt_state, step, bn_state, key = carried
    if model.has_stochastic:
        if key is None:
            raise ValueError("a graph with dropout trains from a "
                             "state with an rng key")
        key = fold_in(key, step)
    inputs, labels = batch["inputs"], batch["labels"]
    sparse = SparseRows(op.name for op in model._sparse_ops)
    leaves = {op: {k: v.detach().requires_grad_() for k, v in d.items()}
              for op, d in params.items() if op not in sparse.names}
    run = dict(leaves)
    for op in model._sparse_ops:
        run[op.name] = {"embedding": params[op.name]["embedding"]}
    flat = [(op, k) for op, d in leaves.items() for k in d]
    final = model.final_tensor
    with torch.enable_grad():
        values, new_bn = forward_values(model, run, inputs, bn_state,
                                        training=True, rng=key,
                                        sparse=sparse)
        loss, preds = model._loss_and_preds(values, labels)
        wrt = [leaves[op][k] for op, k in flat] + [
            e[3] for e in sparse.entries]
        scale = loss_scale(plan, final, model.loss_type)
        grads = torch.autograd.grad(loss * scale, wrt, allow_unused=True,
                                    materialize_grads=True)
    with torch.no_grad():
        for name, new in new_bn.items():
            for k, v in new.items():
                bn_state[name][k].copy_(v)
        dgrads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (op, k), g in zip(flat, grads):
            spec = plan.params.get(op, {}).get(k, PartitionSpec())
            dgrads.setdefault(op, {})[k] = all_reduce_sum_(
                g, mesh, replicated_axes(spec, g.dim(), mesh))
        lazy = model._lazy_mode and model._sparse_ops
        if lazy:
            pre = {k: opt_state[k].clone() for k in ("step", "lr")
                   if isinstance(opt_state.get(k), torch.Tensor)}
        model.optimizer.update(params, dgrads, opt_state)
        neg_lr = -opt_state.get("lr", model.optimizer.lr)
        for (op, tflat, gids, rows), g in zip(sparse.entries,
                                              grads[len(flat):]):
            table = params[op.name]["embedding"]
            axes = replicated_axes(plan.param_spec(op, "embedding"),
                                   table.dim(), mesh)
            d = tflat.shape[-1]
            ids_all = gather_cat(gids.reshape(-1).contiguous(), mesh, axes)
            g_all = gather_cat(g.reshape(-1, d).contiguous(), mesh, axes)
            if lazy:
                w_all = gather_cat(rows.detach().reshape(-1, d).contiguous(),
                                   mesh, axes)
                model._lazy_update(op, table, ids_all, w_all, g_all,
                                   opt_state, pre)
            else:
                model._row_update(tflat, ids_all, g_all, neg_lr)
        mets = compute_metrics(preds.detach(), labels, model.metrics,
                               model.loss_type)
        mets = reduce_metrics(plan, final, mets, loss, model.loss_type)
        step.add_(1)
        model._metric_layout = tuple((k, v.dtype) for k, v in mets.items())
        dtype = functools.reduce(torch.promote_types,
                                 (v.dtype for v in mets.values()))
        return torch.stack([v.to(dtype) for v in mets.values()])


def global_param(t):
    """A parameter's global value: gathered when it is a mesh block
    (``FFModel._shard_params`` marks those), else itself."""
    layout = getattr(t, "_ff_layout", None)
    if layout is None:
        return t
    from .collectives import global_value
    mesh, spec = layout
    return global_value(t, spec, mesh)
