"""DLRM with the hybrid table-parallel strategy on a data x model mesh
(the reference's dlrm_strategy.cc placement: tables spread over devices,
MLPs data-parallel), on the port.

Runs on any number of ranks, one card each:

    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        -m dlrm_flexflow_tpu_torch.examples.dlrm_hybrid_strategy

and in one process without the launcher.
"""

from __future__ import annotations

from ..apps.dlrm import DLRMConfig, build_dlrm
from ..config import FFConfig
from ..data.loader import SyntheticDLRMLoader
from ..device import resolve_device
from ..optim import SGDOptimizer
from ..parallel.mesh import make_mesh
from . import block_spec, rank_group


def main(argv=None, *, device=None):
    dev = resolve_device(device)
    with rank_group(device) as n_dev:
        model_ax = 2 if n_dev % 2 == 0 and n_dev >= 2 else 1
        mesh = make_mesh({"data": n_dev // model_ax, "model": model_ax})
        print("mesh:", dict(mesh.shape))

        cfg = DLRMConfig(sparse_feature_size=64, embedding_size=[100000] * 8,
                         embedding_bag_size=1, mlp_bot=[13, 512, 64],
                         mlp_top=[64 * 8 + 64, 512, 1])
        fc = FFConfig(batch_size=256)
        model = build_dlrm(cfg, fc, table_parallel=model_ax > 1)
        model.compile(optimizer=SGDOptimizer(0.01),
                      loss_type="mean_squared_error",
                      metrics=("accuracy", "mean_squared_error"), mesh=mesh)
        state = model.init(device=dev)
        print("embedding sharding:",
              block_spec(state.params["emb"]["embedding"]))

        loader = SyntheticDLRMLoader(8 * 256, 13, cfg.embedding_size, 1, 256)
        state, thpt = model.fit(state, loader, epochs=2)


if __name__ == "__main__":
    main()
