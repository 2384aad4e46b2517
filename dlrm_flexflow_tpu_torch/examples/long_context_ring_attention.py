"""Long-context training with ring attention: the sequence axis sharded
over the mesh, K/V streaming around the ring of ranks (absent in the
reference; first-class here), on the port.

Runs on any number of ranks, one card each:

    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        -m dlrm_flexflow_tpu_torch.examples.long_context_ring_attention

and in one process without the launcher (a ring of one).
"""

from __future__ import annotations

import numpy as np

from ..config import FFConfig
from ..device import resolve_device
from ..model import FFModel
from ..optim import AdamOptimizer
from ..parallel.mesh import make_mesh
from . import rank_group


def main(argv=None, *, device=None):
    dev = resolve_device(device)
    with rank_group(device) as n:
        seq_shards = max(n // 2, 1)
        mesh = make_mesh({"data": n // seq_shards, "seq": seq_shards})
        print("mesh:", dict(mesh.shape))

        B, S, E, H = 4, 128 * seq_shards, 256, 8
        model = FFModel(FFConfig(batch_size=B))
        x = model.create_tensor((B, S, E), name="tokens")
        h = model.multihead_attention(x, x, x, embed_dim=E, num_heads=H,
                                      causal=True, seq_parallel=True)
        model.dense(h, E)
        model.compile(optimizer=AdamOptimizer(1e-3),
                      loss_type="mean_squared_error", metrics=(), mesh=mesh)
        state = model.init(device=dev)

        rng = np.random.default_rng(0)
        xs = rng.standard_normal((B, S, E)).astype(np.float32)
        ys = rng.standard_normal((B, S, E)).astype(np.float32)
        state, mets = model.train_step(state, {"tokens": xs}, ys)
        print(f"seq {S} over {seq_shards} shards: "
              f"loss={float(mets['loss']):.4f}")


if __name__ == "__main__":
    main()
