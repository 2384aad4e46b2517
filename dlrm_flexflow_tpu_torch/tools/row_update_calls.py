"""Time and count the port's whole row-update call on one CUDA card, for
this checkout or another one.

    python dlrm_flexflow_tpu_torch/tools/row_update_calls.py [--root DIR]
        [--dtype float32|bfloat16]

Imports ``dlrm_flexflow_tpu_torch`` from ``--root`` (default: the checkout
that holds this file), so that two versions of the port can be measured
in one call on one card, in turns (A B B A), with the same script.  Only
the entry point every version has is called: ``row_update_cuda(table,
ids, upd, scale)`` at the training step's shape (n = 256 * 8 updates of
d = 64 into the 8M x 64 stacked table, both in ``--dtype``, default f32;
scale a 0-dim f32 tensor), at uniform ids and at zipf ids (a = 1.05), 64
id sets each.  For each it prints one JSON line: the whole call's device
time from a CUDA graph of the 64 calls (``cuda_timing.graph_ms``), its
host-issued wall per call (``cuda_timing.wall_ms``), and the device
kernels per call from torch.profiler (``cuda_timing.launches_per_call``).
The first line is the card's name and power limit; then, when this call
built the update kernel, ptxas's register and spill lines for it.  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SETS = 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose dlrm_flexflow_tpu_torch is timed")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the table's and the updates' dtype")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    from cuda_timing import graph_ms, launches_per_call, wall_ms
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from dlrm_flexflow_tpu_torch import _cuda
    from dlrm_flexflow_tpu_torch.data.loader import zipf_ids
    from dlrm_flexflow_tpu_torch.ops.row_update_kernel import row_update_cuda

    if not torch.cuda.is_available():
        print("row_update_calls: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _cuda.build()
    for line in _cuda.build_log.get("row_update", (0, ""))[1].splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            print(line.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    rows, dim, n = 8 * 1_000_000, 64, 256 * 8
    dtype = getattr(torch, args.dtype)
    table = (torch.rand((rows, dim), generator=gen, device="cuda")
             - 0.5).to(dtype)
    for kind in ("uniform", "zipf"):
        sets = []
        for _ in range(SETS):
            ids = (torch.randint(0, rows, (n,), generator=gen, device="cuda")
                   if kind == "uniform" else
                   torch.from_numpy(zipf_ids(rng, rows, (n,), a=1.05)).cuda())
            sets.append((table, ids,
                         torch.randn((n, dim), generator=gen,
                                     device="cuda").to(dtype),
                         torch.tensor(-0.01, device="cuda")))
        ms = graph_ms(row_update_cuda, sets)
        call_ms = wall_ms(row_update_cuda, sets)
        launches, kernels = launches_per_call(row_update_cuda, sets)
        print(json.dumps({
            "root": root, "dtype": args.dtype, "ids": kind, "n": n,
            "d": dim, "rows": rows,
            "ms": ms, "call_ms": call_ms, "launches_per_call": launches,
            "kernels_per_call": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
