"""Rank bodies of ``tests/test_torch_leave.py``: a mesh engine's leader
that leaves without its stop, and the followers that must leave after
it.  No JAX here."""

from __future__ import annotations

import json
import time

import numpy as np
import torch.distributed as dist

from dlrm_flexflow_tpu_torch import distributed as fdist
from dlrm_flexflow_tpu_torch.parallel import make_mesh
from dlrm_flexflow_tpu_torch.serving import InferenceEngine
from torch_elastic_ranks import two_proc_model


def serve_then_leave(out, how, requests, silent_s):
    """The table-parallel test DLRM on {"model": 2} served by a mesh
    engine: the leader answers ``requests`` requests, then leaves
    without ``close()``, at once (``how="exits"``: its process ends) or
    after ``silent_s`` seconds alive and silent (``"silent"``); each
    follower records how its ``follow()`` ended and when."""
    rank = dist.get_rank()
    model = two_proc_model(make_mesh({"model": 2}))
    engine = InferenceEngine(model, model.init(seed=0, device="cpu"),
                             device="cpu")
    res = {"rank": rank, "collective_timeout_s": fdist._timeout_s}
    if engine.is_leader:
        rng = np.random.default_rng(5)
        for n in rng.integers(1, 20, size=requests):
            engine.predict({"dense": rng.standard_normal(
                                (int(n), 4)).astype(np.float32),
                            "sparse": rng.integers(0, 64, (int(n), 4, 2))})
        res["last_answer_at"] = time.time()
        if how == "silent":
            time.sleep(silent_s)
    else:
        try:
            res["followed"] = engine.follow()
            res["error"] = None
        except RuntimeError as e:
            res["error"], res["cause"] = str(e), repr(e.__cause__)
        res["left_at"] = time.time()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)
