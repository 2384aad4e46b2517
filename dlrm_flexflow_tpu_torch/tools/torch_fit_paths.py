"""Samples/s of the port's training CLI on each of fit's three paths, on
one CUDA card.

    python dlrm_flexflow_tpu_torch/tools/torch_fit_paths.py [--epochs 1,2] [--rounds 2] [--profile]

Runs ``dlrm_flexflow_tpu_torch.apps.dlrm.run`` at ``-b 256 --wd 0
--data-size 16384`` (the run_random.sh model, 64 batches of synthetic
data) three ways:

- ``staged_cached``: ``--epoch-row-cache on``, the staged epochs with the
  epoch row cache;
- ``staged_uncached``: ``--epoch-row-cache off``, the staged epochs
  without it (the CLI's default path on the card, "auto");
- ``per_batch``: ``--fit-scan-max-bytes 0``, ``train_step`` batch by batch.

Within one process, for each epoch count, the paths run in the order
A B C, then C B A, ``--rounds`` times over, so drift of the host's speed
falls on every path alike.  Prints the card's name and power limit, one
JSON line per run (``fit``'s samples/s) and a summary line with the
median per path.  ``--profile`` adds, per path, one one-epoch ``fit``
under ``torch.profiler``: kernels and device busy time per step, the
profiled wall, and the host operators with the most self CPU time.
Needs a CUDA card.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from dlrm_flexflow_tpu_torch.apps.dlrm import run  # noqa: E402

BASE = ["-b", "256", "--wd", "0", "--data-size", "16384"]
PATHS = {"staged_cached": ["--epoch-row-cache", "on"],
         "staged_uncached": ["--epoch-row-cache", "off"],
         "per_batch": ["--fit-scan-max-bytes", "0"]}
STEPS = 16384 // 256


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def one_run(path: str, epochs: int) -> float:
    thpt = run(BASE + ["-e", str(epochs)] + PATHS[path])
    gc.collect()
    torch.cuda.empty_cache()
    return thpt


def profile_run(path: str) -> None:
    """One one-epoch fit of ``path`` under torch.profiler (warmup step
    and staging included in the window, so per-step figures are over the
    fit's 65 steps)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(BASE + ["-e", "1"] + PATHS[path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    host = sorted((e for e in events
                   if not str(e.device_type).endswith("CUDA")),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    steps = STEPS + 1
    log({"phase": "profile", "path": path, "epochs": 1,
         "profiled_wall_s (init and staging included)": wall,
         "kernels_per_step": sum(e.count for e in kernels) / steps,
         "device_busy_us_per_step": (
             sum(e.self_device_time_total for e in kernels) / steps
             if kernels else "not measured"),
         "top_host_ops": [{"name": e.key[:60],
                           "self_cpu_us_per_step":
                               e.self_cpu_time_total / steps,
                           "calls_per_step": e.count / steps}
                          for e in host]})
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", default="1,2")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fit_paths: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout else
        "nvidia-smi: not available")
    names = list(PATHS)
    for p in names:  # warms each path up (and builds the kernels); not counted
        one_run(p, 1)
    summary = {}
    for epochs in (int(e) for e in args.epochs.split(",")):
        got = {p: [] for p in names}
        for r in range(args.rounds):
            for p in (names if r % 2 == 0 else names[::-1]):
                thpt = one_run(p, epochs)
                got[p].append(thpt)
                log({"phase": "run", "path": p, "epochs": epochs,
                     "round": r, "samples_per_s": thpt})
        summary[f"epochs={epochs}"] = {
            p: {"median_samples_per_s": statistics.median(v), "runs": v}
            for p, v in got.items()}
    if args.profile:
        for p in names:
            profile_run(p)
    log({"phase": "summary", "config": " ".join(BASE), **summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
