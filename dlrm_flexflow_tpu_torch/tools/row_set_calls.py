"""Time and count the port's row-set call on one CUDA card, for this
checkout or another one.

    python dlrm_flexflow_tpu_torch/tools/row_set_calls.py [--root DIR]

Imports ``dlrm_flexflow_tpu_torch`` from ``--root`` (default: the checkout
that holds this file), so that two versions of the port can be measured
in one call on one card, in turns (A B B A), with the same script.  Only
entry points every version has are called: ``launch_row_set`` (the
kernel alone, on inputs ``prepare_row_set`` made) and ``row_set_cuda``
(the whole call), each from a CUDA graph of the calls
(``cuda_timing.graph_ms``), and ``index_copy_`` on the live ids, at the
two shapes of the epoch cache's writebacks on the run_random.sh model
(64 uniform batches of B = 256, 8 tables of 1M rows, bag 1):

* epilogue: the epoch cache's n = 131,072 rows into the 8M x 64 table;
* block: a ladder block's n = 16,384 rows into the 131,072-row cache;

with the table and the rows in f32 and in bf16.  For each it prints one
JSON line: the times, the bytes bound (each live row read and written
once, plus the n int32 ids) and the kernel's share of it, a contiguous
``copy_`` of the live rows' bytes timed the same way (what the card
takes to move those bytes with no ids and no scatter), and the device
operations per call from torch.profiler
(``cuda_timing.launches_per_call``).  The first line is the card's name
and power limit; then, when this call built the kernel, ptxas's register
and spill lines for it.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SETS = 8
TABLES, ROWS, DIM, BATCH, BATCHES = 8, 1_000_000, 64, 256, 64
# H100 SXM HBM3 bandwidth (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose dlrm_flexflow_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
    from cuda_timing import graph_ms, launches_per_call
    sys.path.insert(0, root)
    import torch

    from dlrm_flexflow_tpu_torch import _cuda
    from dlrm_flexflow_tpu_torch.ops.row_set_kernel import (launch_row_set,
                                                           prepare_row_set,
                                                           row_set_cuda)
    from dlrm_flexflow_tpu_torch.ops.slotting import slot_rows

    if not torch.cuda.is_available():
        print("row_set_calls: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _cuda.build(["row_set"])
    for line in _cuda.build_log.get("row_set", (0, ""))[1].splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            print(line.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(14)
    offsets = torch.arange(TABLES, device="cuda")[:, None] * ROWS
    plans = {"epilogue": [], "block": []}
    for _ in range(SETS):
        ids = torch.randint(0, ROWS, (BATCHES, BATCH, TABLES, 1),
                            generator=gen, device="cuda") + offsets
        rowof, slots = slot_rows(ids, TABLES * ROWS)
        plans["epilogue"].append(rowof)
        plans["block"].append(slot_rows(slots[:8], rowof.numel())[0])
    big = torch.rand((TABLES * ROWS, DIM), generator=gen,
                     device="cuda") - 0.5
    for dtype in (torch.float32, torch.bfloat16):
        for shape, rowofs in plans.items():
            table = (big if shape == "epilogue"
                     else big[:BATCHES * BATCH * TABLES]).to(dtype)
            arg_sets = [(table, r, torch.randn(
                (r.numel(), DIM), generator=gen, device="cuda").to(dtype))
                for r in rowofs]
            prepared = [(t,) + prepare_row_set(t, i, v)
                        for t, i, v in arg_sets]
            lib_sets, copy_sets = [], []
            for t, i, v in arg_sets:
                hit = i < t.shape[0]
                lib_sets.append((t, i[hit].long(), v[hit].contiguous()))
                copy_sets.append((torch.empty_like(lib_sets[-1][2]),
                                  lib_sets[-1][2]))
            n = rowofs[0].numel()
            live = sum(int(a[1].numel()) for a in lib_sets) / SETS
            nbytes = 2 * live * DIM * table.element_size() + 4 * n
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ms = graph_ms(launch_row_set, prepared)
            launches, kernels = launches_per_call(row_set_cuda,
                                                  arg_sets * 8)
            print(json.dumps({
                "root": root, "call": "row_set", "shape": shape,
                "table_dtype": str(dtype).split(".")[-1], "n": n, "d": DIM,
                "rows": table.shape[0], "live_rows": live, "bytes": nbytes,
                "bound_ms": bound_ms, "ms": ms,
                "share_of_bound": bound_ms / ms,
                "wrapper_ms": graph_ms(row_set_cuda, arg_sets),
                "library_ms": graph_ms(
                    lambda t, i, v: t.index_copy_(0, i, v), lib_sets),
                "copy_ms": graph_ms(lambda dst, src: dst.copy_(src),
                                    copy_sets),
                "launches_per_call": launches,
                "kernels_per_call": kernels}), flush=True)
            del table, arg_sets, prepared, lib_sets, copy_sets
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
