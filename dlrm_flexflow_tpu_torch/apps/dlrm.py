"""DLRM — the deep learning recommendation model (counterpart of
``dlrm_flexflow_tpu/apps/dlrm.py``).

Bottom MLP over the dense features, one embedding bag per sparse feature,
the feature interaction (``cat`` or ``dot``), top MLP with a sigmoid.
Two graph shapes: the fused graph (``fused_interaction="on"``), whose
embedding bags and interaction are ONE ``FusedEmbedInteract`` op run by
the hand-written Hopper kernels on the card, and the classic graph
(stacked, ragged or per-table embeddings -> reshape -> concat or
batch_matmul).

    python -m dlrm_flexflow_tpu_torch.apps.dlrm -b 256 -e 2 --wd 0 --data-size 16384

trains the run_random.sh model on the CUDA card: ``fit`` stages the 64
batches on the card and runs both epochs as one ``train_epochs`` with the
epoch row cache.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from ..config import FFConfig
from ..data.loader import SyntheticDLRMLoader
from ..model import FFModel
from ..optim import SGDOptimizer


@dataclass
class DLRMConfig:
    """Flag parity with the reference's dlrm.cc flags."""

    sparse_feature_size: int = 64          # --arch-sparse-feature-size
    embedding_size: List[int] = field(     # --arch-embedding-size "1000000-..."
        default_factory=lambda: [1000000] * 8)
    embedding_bag_size: int = 1            # --embedding-bag-size
    mlp_bot: List[int] = field(default_factory=lambda: [64, 512, 512, 64])
    mlp_top: List[int] = field(default_factory=lambda: [576, 1024, 1024, 1024, 1])
    arch_interaction_op: str = "cat"       # --arch-interaction-op {cat,dot}
    fused_interaction: str = "off"         # --fused-interaction {off,auto,on}
    exchange_overlap: str = "off"          # --exchange-overlap {off,auto,on}
    exchange_microbatches: int = 2         # --exchange-microbatches
    loss_threshold: float = 0.0            # --loss-threshold
    sigmoid_bot: int = -1                  # -1 = no sigmoid in bottom MLP
    sigmoid_top: int = -1                  # -1 = sigmoid on the last top layer
    dataset: Optional[str] = None          # --dataset (HDF5 path) or None=synthetic
    data_size: int = -1                    # --data-size

    @staticmethod
    def parse_args(argv: Sequence[str]) -> "DLRMConfig":
        c = DLRMConfig()
        ints = lambda s: [int(x) for x in s.split("-")]  # noqa: E731
        flags = {
            "--arch-sparse-feature-size": ("sparse_feature_size", int),
            "--arch-embedding-size": ("embedding_size", ints),
            "--embedding-bag-size": ("embedding_bag_size", int),
            "--arch-mlp-bot": ("mlp_bot", ints),
            "--arch-mlp-top": ("mlp_top", ints),
            "--arch-interaction-op": ("arch_interaction_op", str),
            "--fused-interaction": ("fused_interaction", str),
            "--exchange-overlap": ("exchange_overlap", str),
            "--exchange-microbatches": ("exchange_microbatches", int),
            "--loss-threshold": ("loss_threshold", float),
            "--dataset": ("dataset", str),
            "--data-size": ("data_size", int),
        }
        argv = list(argv)
        i = 0
        while i < len(argv):
            hit = flags.get(argv[i])
            if hit is not None and i + 1 < len(argv):
                name, conv = hit
                setattr(c, name, conv(argv[i + 1]))
                i += 1
            i += 1
        return c


KAGGLE_TABLES = [1396, 550, 1761917, 507795, 290, 21, 11948, 608, 3, 58176,
                 5237, 1497287, 3127, 26, 12153, 1068715, 10, 4836, 2085, 4,
                 1312273, 17, 15, 110946, 91, 72655]
# ^ the 26 Criteo-Kaggle categorical cardinalities
#   (reference examples/cpp/DLRM/run_criteo_kaggle.sh)


def criteo_kaggle_config() -> DLRMConfig:
    """The Criteo-Kaggle model shape: 26 ragged tables of dim 16, with the
    consistent top width 16 + 26*16 = 432 for the cat interaction."""
    return DLRMConfig(sparse_feature_size=16,
                      embedding_size=list(KAGGLE_TABLES),
                      embedding_bag_size=1,
                      mlp_bot=[13, 512, 256, 64, 16],
                      mlp_top=[16 + 26 * 16, 512, 256, 1])


def _create_mlp(model: FFModel, x, layer_sizes, sigmoid_layer: int,
                prefix: str):
    """relu everywhere, sigmoid at ``sigmoid_layer``."""
    t = x
    for i in range(len(layer_sizes) - 1):
        act = "sigmoid" if i == sigmoid_layer else "relu"
        t = model.dense(t, layer_sizes[i + 1], activation=act,
                        name=f"{prefix}_{i}")
    return t


def _interact_features(model: FFModel, bottom_out, emb_out,
                       cfg: DLRMConfig):
    """The classic graph's interaction: ``cat`` concatenates the bottom
    output and the embeddings; ``dot`` forms z = [bottom; embeddings]
    (B, F, d), the pairwise dots z z^T by one batch_matmul, and
    concatenates the bottom output with their flat form."""
    if cfg.arch_interaction_op == "cat":
        return model.concat([bottom_out] + emb_out, axis=1)
    if cfg.arch_interaction_op == "dot":
        d = cfg.sparse_feature_size
        feats = [model.reshape(bottom_out, (bottom_out.shape[0], 1, d))]
        for e in emb_out:
            # 2-D (B, T*d) -> (B, T, d); 3-D already (B, T, d)
            feats.append(model.reshape(e, (e.shape[0], e.shape[1] // d, d))
                         if e.ndim == 2 else e)
        z = model.concat(feats, axis=1)                 # (B, F, d)
        zz = model.batch_matmul(z, model.transpose(z))  # (B, F, F)
        return model.concat([bottom_out, model.flat(zz)], axis=1)
    raise ValueError(f"unknown interaction op {cfg.arch_interaction_op!r}")


def build_dlrm(cfg: DLRMConfig, ffconfig: Optional[FFConfig] = None,
               stacked_embeddings: Optional[bool] = None,
               table_parallel: bool = False) -> FFModel:
    """Build the DLRM graph with the JAX package's op names and parameter
    shapes.

    ``fused_interaction`` "on" builds ``bot_*`` Linear ops, ``emb`` (one
    FusedEmbedInteract over the (B, T, bag) ``sparse`` ids and the bottom
    output) and ``top_*``.  "off" (and "auto", which engages only on a
    single TPU in the JAX package) builds the classic graph: with
    ``stacked_embeddings`` (the default) one ``emb`` op, a
    StackedEmbedding for same-size tables or a RaggedStackedEmbedding
    otherwise, reshaped to (B, T*d); without it one Embedding
    ``emb_<i>`` per table over its own ``sparse_<i>`` ids; then the
    ``cat`` or ``dot`` interaction.  The table-parallel and
    overlapped-exchange graphs come with the scale-out slice."""
    ffconfig = ffconfig or FFConfig()
    fmode = getattr(cfg, "fused_interaction", "off")
    if fmode not in ("off", "auto", "on"):
        raise ValueError(
            f"fused_interaction must be 'off'|'auto'|'on', got {fmode!r}")
    if stacked_embeddings is None:
        stacked_embeddings = True
    if fmode == "on" and not stacked_embeddings:
        raise ValueError(
            "fused_interaction='on' needs the stacked input convention "
            "(one (B, T, bag) ids tensor); per-table inputs "
            "(stacked_embeddings=False) cannot feed the fused op")
    if table_parallel or getattr(cfg, "exchange_overlap", "off") == "on":
        raise NotImplementedError(
            "table-parallel and overlapped-exchange graphs come with the "
            "scale-out slice in ROADMAP.md")
    model = FFModel(ffconfig)
    b = ffconfig.batch_size
    t = len(cfg.embedding_size)
    d = cfg.sparse_feature_size
    dense_in = model.create_tensor((b, cfg.mlp_bot[0]), "float32", name="dense")
    bottom = _create_mlp(model, dense_in, cfg.mlp_bot, cfg.sigmoid_bot, "bot")
    if fmode == "on":
        ids = model.create_tensor((b, t, cfg.embedding_bag_size), "int64",
                                  name="sparse")
        z = model.fused_embed_interact(
            ids, bottom, list(cfg.embedding_size), d,
            interact=cfg.arch_interaction_op, aggr="sum", name="emb")
    elif stacked_embeddings:
        ids = model.create_tensor((b, t, cfg.embedding_bag_size), "int64",
                                  name="sparse")
        if len(set(cfg.embedding_size)) == 1:
            stacked = model.stacked_embedding(ids, t, cfg.embedding_size[0],
                                              d, aggr="sum", name="emb")
        else:
            stacked = model.ragged_stacked_embedding(
                ids, cfg.embedding_size, d, aggr="sum", name="emb")
        flat = model.reshape(stacked, (b, t * d), name="emb_flat")
        z = _interact_features(model, bottom, [flat], cfg)
    else:
        emb_out = []
        for i, rows in enumerate(cfg.embedding_size):
            ids = model.create_tensor((b, cfg.embedding_bag_size), "int64",
                                      name=f"sparse_{i}")
            emb_out.append(model.embedding(ids, rows, d, aggr="sum",
                                           name=f"emb_{i}"))
        z = _interact_features(model, bottom, emb_out, cfg)
    if z.shape[1] != cfg.mlp_top[0]:
        raise ValueError(
            f"interaction width {z.shape[1]} != mlp_top[0] {cfg.mlp_top[0]}")
    sig = cfg.sigmoid_top if cfg.sigmoid_top >= 0 else len(cfg.mlp_top) - 2
    _create_mlp(model, z, cfg.mlp_top, sig, "top")
    return model


def cli_loader(cfg: DLRMConfig, ffconfig: FFConfig) -> SyntheticDLRMLoader:
    """The CLI's synthetic data, built as the JAX CLI builds it:
    ``--data-size`` samples (default 16 batches) of stacked ids, at the
    loader's own default seed.  ``--seed`` seeds ``init`` only, so the
    two CLIs train on the same batches at any seed."""
    n = cfg.data_size if cfg.data_size > 0 else 16 * ffconfig.batch_size
    return SyntheticDLRMLoader(n, cfg.mlp_bot[0], cfg.embedding_size,
                               cfg.embedding_bag_size, ffconfig.batch_size,
                               stacked=True)


def run(argv: Sequence[str] = ()) -> float:
    """The reference app's CLI: MSE loss with accuracy and MSE metrics,
    SGD at the config's learning rate and weight decay, synthetic data
    (``cli_loader``), trained by ``fit`` on the CUDA card.  Returns
    samples/s.  ``--embedding-dtype bfloat16`` stores the tables in bf16;
    ``--serve-quantize`` is the model config's default for an
    ``InferenceEngine`` built on it; ``--metrics-port`` starts the
    ``/metrics`` endpoint at ``compile``; ``--profiling`` prints each op's
    forward and backward times after training.  The SOAP flags reach
    ``compile`` through the config, as in the JAX CLI: ``--import FILE``
    loads a strategy, ``--budget N`` (``--alpha``, ``--overlap``,
    ``-d``/``--devices``) searches one at compile and ``--export FILE``
    writes it; on one card a strategy changes no value."""
    ffconfig = FFConfig.parse_args(argv)
    cfg = DLRMConfig.parse_args(argv)
    if cfg.dataset:
        raise NotImplementedError(
            "--dataset (Criteo HDF5) needs h5py: load_criteo_h5 comes with "
            "the optimizer and data slice in ROADMAP.md")
    model = build_dlrm(cfg, ffconfig)
    model.compile(optimizer=SGDOptimizer(ffconfig.learning_rate, 0.0, False,
                                         ffconfig.weight_decay),
                  loss_type="mean_squared_error",
                  metrics=("accuracy", "mean_squared_error"))
    state = model.init()
    state, thpt = model.fit(state, cli_loader(cfg, ffconfig),
                            epochs=ffconfig.epochs)
    if ffconfig.profiling:
        # the reference's --profiling: per-op times after training
        from ..profiling import OpTimer
        timer = OpTimer(model)
        print(timer.report(timer.profile(state, None)))
    return thpt


if __name__ == "__main__":
    import sys

    run(sys.argv[1:])
