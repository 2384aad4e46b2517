"""Criteo-Kaggle DLRM with 26 NON-uniform tables fused into one ragged
row space, distributed table-parallel over a data x model mesh — the
per-table placement story of the reference's flagship dataset
(dlrm_strategy.cc:251-256 pins each different-sized table to one GPU;
run_criteo_kaggle.sh), on the port: the fused (R_total, d) row space
shards over "model" in contiguous per-rank row ranges (more balanced
than whole-table pinning) and the 26 per-table gathers run as ONE
batched gather.

Runs on any number of ranks, one card each:

    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        -m dlrm_flexflow_tpu_torch.examples.dlrm_kaggle_ragged

and in one process without the launcher (no mesh).
"""

from __future__ import annotations

from ..apps.dlrm import KAGGLE_TABLES, DLRMConfig, build_dlrm
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
        mesh = (make_mesh({"data": n_dev // model_ax, "model": model_ax})
                if n_dev > 1 else False)

        cfg = DLRMConfig(sparse_feature_size=16,
                         embedding_size=list(KAGGLE_TABLES),
                         embedding_bag_size=1,
                         mlp_bot=[13, 512, 256, 64, 16],
                         mlp_top=[432, 512, 256, 1])
        fc = FFConfig(batch_size=128)
        model = build_dlrm(cfg, fc, table_parallel=model_ax > 1)
        model.compile(optimizer=SGDOptimizer(0.01),
                      loss_type="mean_squared_error",
                      metrics=("accuracy", "mean_squared_error"), mesh=mesh)
        state = model.init(device=dev)

        emb = model.get_op("emb")
        # the row-sparse ops by name (JAX's model._sparse_emb_ops)
        print(f"26 tables ({sum(KAGGLE_TABLES):,} rows) fused into a "
              f"{emb.total_rows:,}-row space; "
              f"sparse fast path: {[op.name for op in model._sparse_ops]}")
        if mesh is not False:
            print("row-space sharding:",
                  block_spec(state.params["emb"]["embedding"]))

        loader = SyntheticDLRMLoader(16 * fc.batch_size, cfg.mlp_bot[0],
                                     cfg.embedding_size,
                                     cfg.embedding_bag_size, fc.batch_size,
                                     stacked=True)
        state, thpt = model.fit(state, loader, epochs=2)


if __name__ == "__main__":
    main()
