"""A function over fixed shapes replayed as one CUDA graph: the port's
counterpart of the JAX package's ``jax.jit`` and ``lower(...).compile()``
over fixed shapes (``serving/engine.py::_ensure``, ``model.py``'s jitted
step).

A :class:`GraphRunner` owns static input buffers for one shape signature
and the function ``fn(static_inputs, state)`` that runs on them; on the
card it owns one ``torch.cuda.CUDAGraph`` of that function.  ``run``
copies the caller's tensors or arrays into the static buffers, replays
the graph, and returns clones of the outputs: the graph's own outputs are
overwritten by the next replay, so a caller never sees them.

``state`` is every tensor the function reads or updates in place that is
not a static input: parameters, tables, the learning rate, caches.  The
graph holds their addresses, so the runner records ``data_ptr()``, shape
and dtype of each at construction and checks them before every run: a
tensor that moved (a parameter replaced rather than written in place)
makes ``run`` raise :class:`StaleGraphError` before anything is copied
or launched.  The runner never re-captures; an owner that wants a new
graph builds a new runner (``FFModel._step`` does).

On the CPU there is no capture: ``run`` calls the same function on the
same static buffers, so the CPU tests exercise the bookkeeping the card
depends on (static inputs, in-place state, cloned outputs, address
checks).  On the card a capture or instantiation failure raises; there is
no eager fallback.  A runner built with ``capture=False`` runs eagerly
on the card too (the serving engine's ``aot=False``).

``run`` holds the runner's lock; ``run_locked`` is the same step for a
caller that already holds it and must enqueue work of its own before the
replay in the same critical section (the tiered engine's remap and
install).

The kernel wrappers count their launches in Python (``.launches``), and
a replay runs no Python.  So the runner takes back what the wrappers
counted while it captured (capture runs no kernel) and adds that much
again on every replay.  Counts are exact when no other thread launches a
counted kernel during a capture.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .ops.bag_kernel import embedding_bag_cuda
from .ops.fused_interact_kernel import (fused_interact_bwd_cuda,
                                        fused_interact_cuda)
from .ops.row_set_kernel import row_set_cuda
from .ops.row_update_kernel import prepare_row_update_cuda, row_update_cuda

#: the kernel wrappers whose ``launches`` a replay adds to
COUNTED = (fused_interact_cuda, fused_interact_bwd_cuda, row_update_cuda,
           prepare_row_update_cuda, row_set_cuda, embedding_bag_cuda)


class StaleGraphError(RuntimeError):
    """A state tensor is not the one the graph was captured against."""


def flatten(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs of nested dicts, lists and tuples, dict keys
    in sorted order (so two dicts with the same items flatten alike)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree, key=str)
                for kv in flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, path + (i,))]
    return [(path, tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def state_key(state) -> Tuple:
    """What a graph depends on in ``state``: every tensor's path,
    address, shape, dtype and device."""
    return tuple((p, t.data_ptr(), tuple(t.shape), t.dtype, t.device)
                 for p, t in flatten(state) if isinstance(t, torch.Tensor))


def run_eager(fn: Callable, *args, device: torch.device):
    """``fn(*args)`` outside any graph.  On the card it runs on a side
    stream, ordered after and before the current stream's work: the
    warm-up PyTorch asks for before a capture (it builds and loads the
    kernels, sets their attributes, and warms cuBLAS and the
    allocator)."""
    if device.type != "cuda":
        return fn(*args)
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn(*args)
    current.wait_stream(side)
    return out


def _launch_counts() -> List[int]:
    return [w.launches for w in COUNTED]


class GraphRunner:
    """``fn(static_inputs, state)`` over the shapes of ``inputs`` (nested
    dicts of tensors, copied into the static buffers), captured once on
    the card and replayed by ``run``.

    The caller has run ``fn`` once eagerly at these shapes before (see
    :func:`run_eager`).  ``pool`` is a ``torch.cuda.graph_pool_handle()``
    shared by an owner's graphs; they must never replay concurrently, so
    the owner passes one ``lock`` to all of them.  Every replay goes on
    the caller's current stream.  Captures run in ``thread_local`` mode,
    so another thread's synchronising call (a ``model.predict`` and its
    ``.cpu()``, a batcher's dispatch) cannot break a capture."""

    def __init__(self, fn: Callable, inputs, state=(), *, pool=None,
                 lock: Optional[threading.Lock] = None,
                 capture: bool = True):
        leaves = [t for _, t in flatten(inputs)]
        if not leaves:
            raise ValueError("a graph needs at least one static input")
        self.device = leaves[0].device
        for _, t in flatten(state):
            if isinstance(t, torch.Tensor) and t.device != self.device:
                raise ValueError(f"state on {t.device}, inputs on "
                                 f"{self.device}")
        self.static = _map(
            lambda t: t.to(device=self.device, copy=True).contiguous(),
            inputs)
        self.state_key = state_key(state)
        #: whether the runner captures its function on the card (on the
        #: CPU nothing is captured either way)
        self.capture = bool(capture)
        self.replays = 0
        self._lock = lock or threading.Lock()
        self._fn: Optional[Callable] = fn
        self._graph = None
        self._out = None
        self._added = [0] * len(COUNTED)
        if self.capture and self.device.type == "cuda":
            self._capture(state, pool)

    def _capture(self, state, pool) -> None:
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self._out = self._fn(self.static, state)
        finally:
            # capture ran no kernel: take back what the wrappers counted
            for i, (w, b) in enumerate(zip(COUNTED, before)):
                self._added[i] = w.launches - b
                w.launches = b
        self._graph = graph
        # the graph replaces the closure on the card (and dropping it
        # keeps an owner the closure refers to out of a reference cycle)
        self._fn = None

    def run(self, inputs, state=()):
        """Copy ``inputs`` (the structure and shapes of the static inputs;
        tensors on any device, or arrays) into the static buffers, replay
        (on the CPU: call ``fn``), and return clones of the outputs.
        Raises :class:`StaleGraphError` when ``state`` is not what the
        graph was captured against, and ``ValueError`` on another input
        structure or shape."""
        with self._lock:
            return self.run_locked(inputs, state)

    def run_locked(self, inputs, state=()):
        """:meth:`run` for a caller that holds the runner's lock."""
        if state_key(state) != self.state_key:
            raise StaleGraphError(
                "a state tensor moved since the capture (replaced, not "
                "updated in place): this graph would read the old one")
        dst = flatten(self.static)
        src = flatten(inputs)
        if [p for p, _ in src] != [p for p, _ in dst]:
            raise ValueError(f"inputs {[p for p, _ in src]} do not match "
                             f"the static inputs {[p for p, _ in dst]}")
        for (p, d), (_, s) in zip(dst, src):
            if not isinstance(s, torch.Tensor):
                s = torch.from_numpy(np.asarray(s))
            if tuple(s.shape) != tuple(d.shape):
                raise ValueError(f"input {p}: shape {tuple(s.shape)}, "
                                 f"the graph's is {tuple(d.shape)}")
            d.copy_(s)
        if self._graph is None:
            out = self._fn(self.static, state)
        else:
            self._graph.replay()
            out = self._out
            for w, n in zip(COUNTED, self._added):
                w.launches += n
        self.replays += 1
        return _map(torch.Tensor.clone, out)
