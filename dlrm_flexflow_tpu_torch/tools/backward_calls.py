"""Time and count the port's fused interaction backward on one CUDA card,
for this checkout or another one.

    python dlrm_flexflow_tpu_torch/tools/backward_calls.py [--root DIR]

Imports ``dlrm_flexflow_tpu_torch`` from ``--root`` (default: the checkout
that holds this file), so that two versions of the port can be measured
in one call on one card, in turns (A B B A), with the same script.  Only
entry points every version has are called:

* ``fused_interact_bwd_cuda(table, gids, bottom, g, interact=...)``
  (``cat`` and ``dot``, ``sum``, bag 1, pre-masked int32 flat ids) on a
  run_random.sh-sized table (8 x 1M x 64 f32, bottom 64) at B = 1, 8,
  64, 256;
* the op's whole backward, ``FusedEmbedInteractFn.backward`` as autograd
  calls it at f32 (the zero table gradient, the backward kernel, the
  scatter's ids, the row update), on a context holding what the forward
  saved, at B = 256, ``cat`` and ``dot``.

For each it prints one JSON line: the device time per call from a CUDA
graph (``cuda_timing.graph_ms``; 64 calls, or 8 for the op's backward,
each of which zero-fills the 2.05 GB table gradient), the host-issued
wall per call (``cuda_timing.wall_ms``), and the device operations per
call from torch.profiler (``cuda_timing.launches_per_call``).  The first
line is the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SETS, OP_SETS = 64, 8
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

    from dlrm_flexflow_tpu_torch import _cuda
    from dlrm_flexflow_tpu_torch.ops.fused_interact import \
        FusedEmbedInteractFn
    from dlrm_flexflow_tpu_torch.ops.fused_interact_kernel import (
        fused_interact_bwd_cuda, interact_width)

    if not torch.cuda.is_available():
        print("backward_calls: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _cuda.build()

    def report(call, interact, bsz, fn, arg_sets):
        launches, kernels = launches_per_call(fn, arg_sets)
        print(json.dumps({
            "root": root, "call": call, "interact": interact, "B": bsz,
            "ms": graph_ms(fn, arg_sets), "call_ms": wall_ms(fn, arg_sets),
            "launches_per_call": launches, "kernels_per_call": kernels}),
            flush=True)

    gen = torch.Generator(device="cuda").manual_seed(6)
    table = torch.rand((TABLES * ROWS, DIM), generator=gen,
                       device="cuda") - 0.5
    offsets = torch.arange(TABLES, device="cuda")[None, :, None] * ROWS
    for interact in ("cat", "dot"):
        width = interact_width(interact, TABLES, DIM, DIM)
        for bsz in BUCKETS:
            sets = [(table, (torch.randint(0, ROWS, (bsz, TABLES, 1),
                                           generator=gen, device="cuda")
                             + offsets).to(torch.int32),
                     torch.rand((bsz, DIM), generator=gen, device="cuda"),
                     torch.randn((bsz, width), generator=gen, device="cuda"))
                    for _ in range(SETS)]

            def kern(t, gi, b, g, interact=interact):
                return fused_interact_bwd_cuda(t, gi, b, g,
                                               interact=interact)

            report("fused_interact_bwd_cuda", interact, bsz, kern, sets)

        def op_backward(t, gi, b, g, interact=interact):
            ctx = SimpleNamespace(saved_tensors=(t, b, gi),
                                  config=(interact, "sum", None))
            return FusedEmbedInteractFn.backward(ctx, g)

        report("FusedEmbedInteractFn.backward", interact, BUCKETS[-1],
               op_backward, sets[:OP_SETS])
    return 0


if __name__ == "__main__":
    sys.exit(main())
