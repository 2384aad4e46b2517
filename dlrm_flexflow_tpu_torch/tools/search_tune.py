"""Closed-loop SOAP tuning tool (``sim/tune.py``; counterpart of the
JAX package's ``scripts/search_tune.py``).

Ingest a recorded run's ``op_time`` telemetry, fit per-op-class
correction factors into the analytic H100 cost model, re-run the MCMC
strategy search under the recalibrated simulator, persist the winner as
a versioned strategy artifact with its provenance, and promote it over
the incumbent only when the regress gate passes:

    python dlrm_flexflow_tpu_torch/tools/search_tune.py \\
        --telemetry artifacts/telemetry_dlrm.jsonl [--devices 4] \\
        [--budget 300] [--seed 0] [--tolerance 5] [--bench sim|real] \\
        [--artifacts artifacts] [--tiny] [--device cuda|cpu]

Every phase emits ``search``/``calibration`` telemetry into the tune sink
(default ``<artifacts>/telemetry_tune.jsonl``, appended to, so the report
CLI's ``== tuning ==`` section sees the whole strategy lineage across
runs) and the run prints ONE JSON line: version, verdict, simulated step
time, calibration error before and after.

``--bench sim`` (default) prices candidate and incumbent under the
recalibrated simulator, deterministic and card-free; ``--bench real``
prices each strategy artifact on the card: a fresh model compiled under
the strategy (``compile(strategy=)``), two warm steps (the eager one and
the capture), then three fenced windows of ``--bench-batches`` graphed
``train_step`` replays, the best window's step time.  On one card
strategies execute alike (a mesh of one rank is the no-mesh program), so
the two differ there only by noise; the pod form (``--pod``) is ROADMAP.md
item 8, part 2, item 5.  The tool
runs on the CUDA card unless ``--device cpu`` is given; without a card
it exits with code 2.  ``--fused-interaction on`` selects the fused
graph, whose ``op_time`` telemetry names the fused op.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def build_model(args):
    """The DLRM under tuning: the run_random.sh architecture by default
    (with ``--fused-interaction``'s graph), or the CPU-scale tiny config
    (``--tiny``, what the tests drive).  Returns ``(config, model)``."""
    from dlrm_flexflow_tpu_torch import FFConfig
    from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm

    if args.tiny:
        cfg = DLRMConfig(sparse_feature_size=8,
                         embedding_size=[args.rows or 64] * 2,
                         embedding_bag_size=2, mlp_bot=[4, 8, 8],
                         mlp_top=[8 * 2 + 8, 8, 1],
                         fused_interaction=args.fused_interaction)
    else:
        cfg = DLRMConfig(fused_interaction=args.fused_interaction)
        if args.rows:
            cfg.embedding_size = [args.rows] * len(cfg.embedding_size)
    return cfg, build_dlrm(cfg, FFConfig(batch_size=args.batch))


def real_step_bench(args):
    """``--bench real``: ``bench(artifact_doc) -> step seconds`` on
    ``args.device``: the model compiled under the artifact's strategy,
    two warm steps, then the best of three fenced windows of
    ``args.bench_batches`` steps."""
    import numpy as np
    import torch

    def fence():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    def bench(doc: dict) -> float:
        from dlrm_flexflow_tpu_torch import SGDOptimizer
        from dlrm_flexflow_tpu_torch.sim.tune import strategy_from_artifact
        from dlrm_flexflow_tpu_torch.telemetry import suppressed

        cfg, model = build_model(args)
        model.compile(optimizer=SGDOptimizer(lr=0.01),
                      loss_type="mean_squared_error", metrics=(),
                      strategy=strategy_from_artifact(doc))
        state = model.init(seed=0, device=args.device)
        nb = args.bench_batches
        rng = np.random.default_rng(0)
        inputs = {
            "dense": rng.standard_normal(
                (nb, args.batch, cfg.mlp_bot[0])).astype(np.float32),
            "sparse": rng.integers(
                0, min(cfg.embedding_size),
                size=(nb, args.batch, len(cfg.embedding_size),
                      cfg.embedding_bag_size), dtype=np.int64),
        }
        labels = rng.integers(
            0, 2, size=(nb, args.batch, 1)).astype(np.float32)
        inputs, labels = model.place_dataset(inputs, labels,
                                             device=args.device)

        def step(state, i):
            return model.train_step(
                state, {k: v[i] for k, v in inputs.items()}, labels[i])[0]

        with suppressed():  # emission must not land inside the walls
            for i in range(2):  # the eager step, then the capture
                state = step(state, i % nb)
            fence()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for i in range(nb):
                    state = step(state, i)
                fence()
                best = min(best, time.perf_counter() - t0)
        del model, state, inputs, labels
        return best / nb

    return bench


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python dlrm_flexflow_tpu_torch/tools/search_tune.py",
        description=__doc__.split("\n")[0])
    p.add_argument("--telemetry", required=True,
                   help="op_time JSONL of a recorded run (OpTimer under "
                        "an active EventLog)")
    p.add_argument("--artifacts", default=os.path.join(REPO, "artifacts"),
                   help="artifact dir for calibration/strategy versions "
                        "and the incumbent pointer")
    p.add_argument("--devices", type=int, default=0,
                   help="device count the strategy targets (default: the "
                        "CUDA cards present, 1 on --device cpu)")
    p.add_argument("--budget", type=int, default=300,
                   help="MCMC iteration budget")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--tolerance", type=float, default=5.0,
                   help="promotion gate tolerance, percent")
    p.add_argument("--bench", choices=("sim", "real"), default="sim",
                   help="candidate-vs-incumbent pricing: recalibrated "
                        "simulator (deterministic) or graphed steps on "
                        "the device")
    p.add_argument("--bench-batches", type=int, default=4,
                   help="steps per fenced window (--bench real)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--rows", type=int, default=0,
                   help="embedding rows per table (0 = config default)")
    p.add_argument("--tiny", action="store_true",
                   help="CPU-scale DLRM (the tests' config)")
    p.add_argument("--fused-interaction", choices=("off", "on"),
                   default="off",
                   help="the DLRM graph: classic (off) or the fused "
                        "gather-pool-interaction op (on)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where --bench real runs (default the card)")
    p.add_argument("--sink", default=None,
                   help="tune-run telemetry JSONL (default "
                        "<artifacts>/telemetry_tune.jsonl; 'off' "
                        "disables)")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The loop for parsed arguments: ``search_tune``'s summary dict
    (``main`` refuses ``--device cuda`` without a card)."""
    import torch

    from dlrm_flexflow_tpu_torch.sim.tune import search_tune
    from dlrm_flexflow_tpu_torch.telemetry import event_log

    num_devices = args.devices or (torch.cuda.device_count()
                                   if args.device == "cuda" else 1)
    _cfg, model = build_model(args)
    bench_fn = real_step_bench(args) if args.bench == "real" else None

    sink = args.sink
    if sink is None:
        os.makedirs(args.artifacts, exist_ok=True)
        sink = os.path.join(args.artifacts, "telemetry_tune.jsonl")
    # append, never truncate: the report's strategy-lineage line reads
    # the promote events of past runs from this same sink
    ctx = (contextlib.nullcontext()
           if sink.strip().lower() in ("off", "none", "0")
           else event_log(path=sink, mode="a"))
    with ctx:
        return search_tune(
            model, num_devices, args.telemetry, args.artifacts,
            app="dlrm", budget=args.budget, seed=args.seed,
            alpha=args.alpha, bench_fn=bench_fn,
            tolerance_pct=args.tolerance)


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("search_tune: no CUDA device; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    result = run(args)
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in result.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
