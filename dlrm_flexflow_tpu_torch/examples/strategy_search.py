"""SOAP strategy search on the DLRM graph: simulate, anneal, export
(reference: --budget N --export file path through FFModel::optimize).
The costs are the analytic ones of the port's H100 machine model."""

from __future__ import annotations

import os
import tempfile

from ..apps.dlrm import DLRMConfig, build_dlrm
from ..config import FFConfig
from ..device import resolve_device
from ..parallel.parallel_config import ParallelConfig, Strategy
from ..sim import Simulator, mcmc_search

#: where the searched strategy goes: ``EXPORT_STEM + ".json"`` and the
#: reference's wire format ``EXPORT_STEM + ".pb"`` (the JAX script's
#: ``/tmp/dlrm_searched_strategy``, under the process's temp directory)
EXPORT_STEM = os.path.join(tempfile.gettempdir(), "dlrm_searched_strategy")


def main(argv=None, *, device=None):
    resolve_device(device)
    cfg = DLRMConfig(sparse_feature_size=64, embedding_size=[1000000] * 8,
                     embedding_bag_size=1, mlp_bot=[13, 512, 64],
                     mlp_top=[64 * 8 + 64, 512, 1])
    model = build_dlrm(cfg, FFConfig(batch_size=1024))

    num_devices = 8
    sim = Simulator(model, num_devices)
    dp = Strategy()
    for op in model.layers:
        dp[op.name] = ParallelConfig.data_parallel(op.outputs[0].ndim,
                                                   num_devices)
    print(f"data-parallel: {sim.simulate(dp) * 1e3:.3f} ms/iter (simulated)")

    best = mcmc_search(model, num_devices, budget=500, seed=0, simulator=sim,
                       verbose=True)
    print(f"searched     : {best.best_simulated_time * 1e3:.3f} ms/iter")
    best.save(EXPORT_STEM + ".json")
    best.save(EXPORT_STEM + ".pb")  # reference wire format
    print(f"exported {EXPORT_STEM}.{{json,pb}}")


if __name__ == "__main__":
    main()
