"""Time and count the port's fused forward and embedding-bag calls on one
CUDA card, for this checkout or another one.

    python dlrm_flexflow_tpu_torch/tools/forward_calls.py [--root DIR]

Imports ``dlrm_flexflow_tpu_torch`` from ``--root`` (default: the checkout
that holds this file), so that two versions of the port can be measured
in one call on one card, in turns (A B B A), with the same script.  Only
entry points every version has are called:

* ``fused_interact_cuda(table, gids, bottom)`` (``cat``, ``sum``, bag 1,
  pre-masked int32 flat ids) on the run_random.sh table (8 x 1M x 64 f32)
  at every serving bucket (1, 8, 64, 256);
* ``FFModel.predict`` at bucket 1 on the full-width run_random.sh DLRM
  with the fused interaction (bf16 compute, random weights from seed 0),
  its inputs already on the card, so the call is the op's forward and
  the MLPs;
* ``embedding_bag_cuda(table, ids, "sum")`` on a 1M x 128 f32 table,
  B = 256, bag 8, int64 ids.

For each it prints one JSON line: the device time per call from a CUDA
graph of 64 calls (``cuda_timing.graph_ms``; not for ``predict``), the
host-issued wall per call (``cuda_timing.wall_ms``), and the device
operations per call from torch.profiler
(``cuda_timing.launches_per_call``).  The first line is
the card's name and power limit.  Needs a CUDA card.
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
TABLES, ROWS, DIM = 8, 1_000_000, 64
BUCKETS = (1, 8, 64, 256)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose dlrm_flexflow_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
    from cuda_timing import graph_ms, launches_per_call, wall_ms
    sys.path.insert(0, root)
    import torch

    from dlrm_flexflow_tpu_torch import FFConfig, _cuda
    from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.ops.bag_kernel import embedding_bag_cuda
    from dlrm_flexflow_tpu_torch.ops.fused_interact_kernel import \
        fused_interact_cuda

    if not torch.cuda.is_available():
        print("forward_calls: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _cuda.build()

    def report(call, bsz, fn, arg_sets, graph=True):
        launches, kernels = launches_per_call(fn, arg_sets)
        print(json.dumps({
            "root": root, "call": call, "B": bsz,
            "ms": graph_ms(fn, arg_sets) if graph else "not measured",
            "call_ms": wall_ms(fn, arg_sets), "launches_per_call": launches,
            "kernels_per_call": kernels}), flush=True)

    model = build_dlrm(
        DLRMConfig(embedding_size=[ROWS] * TABLES, fused_interaction="on"),
        FFConfig(batch_size=BUCKETS[-1], compute_dtype="bfloat16",
                 serve_buckets=",".join(map(str, BUCKETS)))).compile()
    state = model.init(seed=0)
    table = state.params["emb"]["embedding"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    offsets = torch.arange(TABLES, device="cuda")[None, :, None] * ROWS
    for bsz in BUCKETS:
        sets = [(table, (torch.randint(0, ROWS, (bsz, TABLES, 1),
                                       generator=gen, device="cuda")
                         + offsets).to(torch.int32),
                 torch.rand((bsz, DIM), generator=gen, device="cuda"))
                for _ in range(SETS)]
        report("fused_interact_cuda", bsz, fused_interact_cuda, sets)
    requests = [({"dense": torch.randn((1, 64), generator=gen,
                                       device="cuda"),
                  "sparse": torch.randint(0, ROWS, (1, TABLES, 1),
                                          generator=gen, device="cuda")},)
                for _ in range(SETS)]
    with torch.inference_mode():
        report("FFModel.predict", 1, lambda r: model.predict(state, r),
               requests, graph=False)
    del model, state, table
    torch.cuda.empty_cache()
    bag_table = torch.rand((ROWS, 128), generator=gen, device="cuda") - 0.5
    sets = [(bag_table, torch.randint(0, ROWS, (256, 8), generator=gen,
                                      device="cuda")) for _ in range(SETS)]
    report("embedding_bag_cuda", 256, embedding_bag_cuda, sets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
