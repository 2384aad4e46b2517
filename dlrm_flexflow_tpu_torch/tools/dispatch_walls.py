"""Host walls of the port's serving dispatch and per-batch training step
with no event log active, on one CUDA card, for this checkout or another
one.

    python dlrm_flexflow_tpu_torch/tools/dispatch_walls.py [--root DIR]
        [--rounds 5]

Imports ``dlrm_flexflow_tpu_torch`` from ``--root`` (default: the checkout
that holds this file) and calls only entry points that every version of
the port since its CUDA graphs has, so that two versions can be measured
in one call on one card, in turns (A B B A).  The run_random.sh model at
full width (8 tables of 1M x 64 f32, bottom 64-512-512-64, top
576-1024-1024-1024-1, bf16 compute, random weights from seed 0):

- ``dispatch_us``: one-row ``InferenceEngine.predict`` on the fused graph
  (buckets 1, 8, 64, 256; the bucket-1 graph), the wall per call over
  200 calls, ``--rounds`` windows;
- ``step_us``: ``fit`` batch by batch (``fit_scan_max_bytes = 0``) over
  16 synthetic batches of 256 on the classic graph, SGD at lr 0.01, the
  wall per step, ``--rounds`` one-epoch fits after a first one that
  captures the step.

Prints the card's name and power limit, then one JSON line with every
window and the medians.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TABLES, ROWS, BATCH, BATCHES, CALLS = 8, 1_000_000, 256, 16, 200


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose dlrm_flexflow_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from dlrm_flexflow_tpu_torch import (FFConfig, SGDOptimizer,
                                         SyntheticDLRMLoader)
    from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.serving import InferenceEngine

    if not torch.cuda.is_available():
        print("dispatch_walls: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    model = build_dlrm(
        DLRMConfig(embedding_size=[ROWS] * TABLES, fused_interaction="on"),
        FFConfig(batch_size=BATCH, compute_dtype="bfloat16",
                 serve_buckets="1,8,64,256")).compile()
    engine = InferenceEngine(model, model.init(seed=0))
    rng = np.random.default_rng(0)
    one = {"dense": rng.standard_normal((1, 64)).astype(np.float32),
           "sparse": rng.integers(0, ROWS, size=(1, TABLES, 1),
                                  dtype=np.int64)}
    engine.predict(one)
    dispatch = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            engine.predict(one)
        dispatch.append((time.perf_counter() - t0) * 1e6 / CALLS)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()

    model = build_dlrm(
        DLRMConfig(embedding_size=[ROWS] * TABLES),
        FFConfig(batch_size=BATCH, compute_dtype="bfloat16",
                 fit_scan_max_bytes=0)).compile(
        optimizer=SGDOptimizer(lr=0.01), loss_type="mean_squared_error",
        metrics=("accuracy", "mean_squared_error"))
    loader = SyntheticDLRMLoader(BATCHES * BATCH, 64, [ROWS] * TABLES, 1,
                                 BATCH, seed=0)
    state, _ = model.fit(model.init(seed=0), loader, epochs=1,
                         verbose=False)
    step = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = model.fit(state, loader, epochs=1, verbose=False,
                             warmup=False)
        step.append((time.perf_counter() - t0) * 1e6 / BATCHES)
    print(json.dumps({
        "root": root, "dispatch_us": dispatch,
        "dispatch_us_median": statistics.median(dispatch),
        "step_us": step, "step_us_median": statistics.median(step),
        "per_batch": not model._last_fit_used_scan}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
