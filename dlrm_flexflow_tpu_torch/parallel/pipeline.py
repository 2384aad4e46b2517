"""Pipeline parallelism: a GPipe-style microbatched pipeline over the
ranks of a mesh axis (counterpart of
``dlrm_flexflow_tpu/parallel/pipeline.py``).

Stage s's parameters live on the rank at coordinate s of the "pipe" axis
(the stacked per-stage parameters sharded on their leading stage axis:
``place_stage_params``).  Every rank runs the same loop of M + S - 1
ticks: stage 0 takes microbatch t, every other stage the activation the
previous stage sent one hop along the ring at the last tick
(``collectives.ppermute``, a ring send and receive whose gradient is the
reverse hop), and the last stage keeps its results.  The last stage's
outputs then reach every rank by a sum over the axis of the outputs
masked to that stage.  Every rank builds the same autograd graph (the
stage choices are tensor selects, not branches), so the backward's ring
hops pair up across the ranks.

Requires homogeneous stages (the same activation shape in and out).
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import all_reduce_sum_, local_block, ppermute, psum
from .mesh import PartitionSpec

PIPE_AXIS = "pipe"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def spmd_pipeline(stage_fn: Callable, mesh, num_microbatches: int,
                  axis: str = PIPE_AXIS):
    """Build a pipelined apply: ``(stage_params, x) -> y``.

    ``stage_fn(params_s, x) -> y`` is one stage's computation; activations
    keep one shape across stages.  ``stage_params`` is this rank's block of
    the stacked parameters (leading stage axis of size 1,
    ``place_stage_params``); ``x`` the (M, mb, ...) microbatched input,
    the same on every rank.  Returns the (M, mb, ...) outputs on every
    rank."""
    s = mesh.shape[axis]

    def apply(stage_params, x):
        params = _tree_map(lambda p: p[0], stage_params)
        stage = mesh.axis_index((axis,))
        dev = x.device
        first = torch.tensor(stage == 0, device=dev)
        last = torch.tensor(stage == s - 1, device=dev)
        m = x.shape[0]
        buf = torch.zeros_like(x[0])
        outs = [None] * m
        for t in range(m + s - 1):
            feed = t if t < m else 0
            x_in = torch.where(first, x[feed], buf)
            y = stage_fn(params, x_in)
            out_idx = t - (s - 1)
            if out_idx >= 0:
                outs[out_idx] = y
            if t < m + s - 2:  # the last hop feeds nothing
                buf = ppermute(y, mesh, (axis,), 1)
        staged = torch.stack(outs) * last.to(x.dtype)
        return psum(staged, mesh, (axis,))

    return apply


def place_stage_params(stacked_params, mesh, axis: str = PIPE_AXIS):
    """This rank's block of the stacked per-stage parameters (every leaf's
    leading stage axis sharded over ``axis``)."""
    def put(p):
        spec = PartitionSpec(axis, *([None] * (p.dim() - 1)))
        return local_block(p, spec, mesh)

    return _tree_map(put, stacked_params)


def pipeline_loss_and_grad(stage_fn, loss_fn, mesh, num_microbatches: int,
                           axis: str = PIPE_AXIS):
    """``(stage_params, x_mb, y_mb) -> (loss, grads)``: the mean loss over
    the microbatches through the pipeline and its gradient with respect to
    this rank's stage parameters (the rank's block of the stacked
    gradient), summed over the other mesh axes."""
    fwd = spmd_pipeline(stage_fn, mesh, num_microbatches, axis)
    others = tuple(a for a in mesh.axis_names
                   if a != axis and mesh.shape[a] > 1)

    def value_and_grad(stage_params, x_mb, y_mb):
        leaves = _leaves(stage_params)
        run = [p.detach().requires_grad_() for p in leaves]
        it = iter(run)
        tree = _tree_map(lambda _: next(it), stage_params)
        with torch.enable_grad():
            loss = loss_fn(fwd(tree, x_mb), y_mb)
            grads = torch.autograd.grad(loss / mesh.size, run,
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = [all_reduce_sum_(g, mesh, others) for g in grads]
        it = iter(grads)
        return loss.detach(), _tree_map(lambda _: next(it), stage_params)

    return value_and_grad
