"""Rank bodies of ``tests/test_torch_examples.py``: the three examples
that build a mesh over the rank group (``dlrm_hybrid_strategy``,
``dlrm_kaggle_ragged``, ``long_context_ring_attention``), each run
through its ``main`` in every process of a gloo group started by
``dlrm_flexflow_tpu_torch.distributed.launch``.

Imports neither JAX nor the JAX package: the test runs the JAX scripts
in the pytest process and hands the ranks each script's initial weights
as one ``.npz`` file.  Each rank writes ``<out>.rank<i>.npz``: every example's
printed lines and its parameters after training, gathered.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import time

import numpy as np
import torch.distributed as dist

from dlrm_flexflow_tpu_torch.apps.dlrm import KAGGLE_TABLES, DLRMConfig
from dlrm_flexflow_tpu_torch.bridge import params_from_jax, params_to_numpy
from dlrm_flexflow_tpu_torch.model import FFModel

#: the examples run here, in this order
MESH_EXAMPLES = ("dlrm_hybrid_strategy", "dlrm_kaggle_ragged",
                 "long_context_ring_attention")
#: the cut table sizes: dlrm_hybrid_strategy's 8 tables of 100,000 rows
#: become 8 of HYBRID_ROWS; each of the 26 Kaggle tables keeps at most
#: KAGGLE_ROWS rows (still 26 unequal tables in one ragged row space)
HYBRID_ROWS = 1000
KAGGLE_ROWS = 2000
KAGGLE_CUT = [min(r, KAGGLE_ROWS) for r in KAGGLE_TABLES]


def hybrid_config(config_cls):
    """``config_cls`` with every table cut to HYBRID_ROWS rows (patched
    over the script's ``DLRMConfig``, on both sides)."""
    def make(**kw):
        kw["embedding_size"] = [HYBRID_ROWS] * len(kw["embedding_size"])
        return config_cls(**kw)
    return make


def unflatten(npz, prefix):
    out = {}
    for key in npz.files:
        if key.startswith(prefix):
            op, p = key[len(prefix):].split("/", 1)
            out.setdefault(op, {})[p] = npz[key]
    return out


def flat(params, prefix):
    return {f"{prefix}{op}/{k}": v for op, d in params.items()
            for k, v in d.items()}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def carried(weights, res, name):
    """``FFModel.init`` loads ``weights`` (the JAX script's initial
    parameters) instead of drawing; after ``fit`` or ``train_step`` the
    parameters (and Adam's first moments), gathered over the mesh, go
    into ``res``."""
    init, fit, step = FFModel.init, FFModel.fit, FFModel.train_step

    def load(self, seed=None, *, device=None):
        return self.load_params(params_from_jax(weights), device=device)

    def record(state):
        res.update(flat(params_to_numpy(state.params), f"{name}/p_end/"))
        if "m" in state.opt_state:
            res.update(flat(params_to_numpy(state.opt_state["m"]),
                            f"{name}/m_end/"))

    def fit_and_record(self, state, *a, **k):
        state, thpt = fit(self, state, *a, **k)
        record(state)
        return state, thpt

    def step_and_record(self, state, *a, **k):
        state, mets = step(self, state, *a, **k)
        record(state)
        return state, mets

    with _patched(FFModel, "init", load), \
            _patched(FFModel, "fit", fit_and_record), \
            _patched(FFModel, "train_step", step_and_record):
        yield


def run_examples(inputs, out, stores):
    """Each of MESH_EXAMPLES through ``main([], device="cpu")`` at the cut
    table sizes, from the JAX script's initial weights, which the test
    writes to ``<inputs>/<name>.npz`` while the group waits (the
    launch's deadline bounds the wait).  ``main`` joins the group
    (already up for the first) and leaves it at its end, so each later
    example joins a new group at a store of its own under ``stores``."""
    rank = dist.get_rank()
    res = {}
    for n, name in enumerate(MESH_EXAMPLES):
        path = os.path.join(inputs, f"{name}.npz")
        while not os.path.exists(path):
            time.sleep(0.05)
        d = np.load(path)
        if n:
            os.environ["COORDINATOR_ADDRESS"] = f"file://{stores}/{name}"
        mod = importlib.import_module(
            f"dlrm_flexflow_tpu_torch.examples.{name}")
        buf = io.StringIO()
        with contextlib.ExitStack() as stack:
            if name == "dlrm_hybrid_strategy":
                stack.enter_context(_patched(mod, "DLRMConfig",
                                             hybrid_config(DLRMConfig)))
            elif name == "dlrm_kaggle_ragged":
                stack.enter_context(_patched(mod, "KAGGLE_TABLES",
                                             KAGGLE_CUT))
            stack.enter_context(carried(unflatten(d, ""), res, name))
            stack.enter_context(contextlib.redirect_stdout(buf))
            mod.main([], device="cpu")
        res[f"{name}/stdout"] = np.array(buf.getvalue())
        res[f"{name}/left"] = np.array(not dist.is_initialized())
    np.savez(f"{out}.rank{rank}.npz", **res)
