"""Standalone simulator and strategy search CLI (counterpart of
``dlrm_flexflow_tpu/sim/__main__.py``; reference scripts/simulator.cc,
an offline event simulator for exploring placements without a cluster).
It runs on the host: analytic costs on the H100 machine model, the
SimTask event simulation and the MCMC search need no card.

    python -m dlrm_flexflow_tpu_torch.sim --app dlrm --devices 8 \\
        --budget 500 --export strategy.json

``--measure`` times the ops on the CUDA card instead.  The DLRM app is
the one ported; the others come with their ops (ROADMAP.md item 9).
"""

from __future__ import annotations

import argparse
import sys
import time

APPS = ["dlrm", "alexnet", "resnet", "inception", "candle_uno", "nmt"]


def build_app(app: str, batch: int):
    from ..config import FFConfig

    fc = FFConfig(batch_size=batch)
    if app == "dlrm":
        from ..apps.dlrm import DLRMConfig, build_dlrm
        return build_dlrm(DLRMConfig(), fc)
    if app in APPS:
        raise NotImplementedError(
            f"--app {app}: its ops (conv, pooling, batchnorm, LSTM, "
            "attention, softmax) come with the op-set slice, ROADMAP.md "
            "item 9")
    raise SystemExit(f"unknown app {app!r}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m dlrm_flexflow_tpu_torch.sim",
        description="offline per-op-strategy simulator + MCMC search")
    p.add_argument("--app", default="dlrm", choices=APPS)
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--budget", type=int, default=200,
                   help="MCMC iterations (reference --budget)")
    p.add_argument("--alpha", type=float, default=0.05,
                   help="annealing temperature (reference --alpha)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export", default=None,
                   help="write the best strategy to this file "
                        "(.json, or .pb in the reference wire format)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "native", "python"],
                   help="search engine: C++ (native/ffsim.cpp) or python")
    p.add_argument("--measure", action="store_true",
                   help="time real kernels on the CUDA card instead of "
                        "the analytic roofline")
    args = p.parse_args(argv)

    model = build_app(args.app, args.batch_size)
    print(f"{args.app}: {len(model.layers)} ops, batch {args.batch_size}, "
          f"{args.devices} devices")

    from .cost_model import CostModel
    from .search import data_parallel_strategy, mcmc_search
    from .simulator import Simulator

    costs = CostModel(measure=args.measure)
    sim = Simulator(model, args.devices, cost_model=costs)

    # data-parallel baseline (the reference's search start, model.cc:1102)
    dp = data_parallel_strategy(model, args.devices)
    t_dp = sim.simulate(dp)
    print(f"data-parallel baseline: {t_dp * 1e3:.3f} ms/iter (simulated)")

    t0 = time.perf_counter()
    best = mcmc_search(model, args.devices, budget=args.budget,
                       alpha=args.alpha, seed=args.seed,
                       simulator=sim if args.measure else None,
                       backend=args.backend, verbose=False)
    wall = time.perf_counter() - t0
    t_best = sim.simulate(best)
    print(f"searched strategy:      {t_best * 1e3:.3f} ms/iter (simulated), "
          f"{args.budget} iters in {wall:.2f}s wall")
    if t_best > 0:
        print(f"simulated speedup vs DP: {t_dp / t_best:.3f}x")

    if args.export:
        best.save(args.export)
        print(f"exported strategy -> {args.export}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
