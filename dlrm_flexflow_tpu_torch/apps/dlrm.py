"""DLRM — the deep learning recommendation model (counterpart of
``dlrm_flexflow_tpu/apps/dlrm.py``).

Bottom MLP over the dense features, one embedding bag per sparse feature,
the feature interaction (``cat`` or ``dot``), top MLP with a sigmoid.
This slice builds the fused graph (``fused_interaction`` "on" or
"auto"): the embedding bags and the interaction are ONE
``FusedEmbedInteract`` op, whose forward is the hand-written Hopper
kernel on the card.  The classic graph (stacked embedding -> reshape ->
concat/batch_matmul) needs the shape ops and comes with slice 2 in
ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from ..config import FFConfig
from ..model import FFModel


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


def build_dlrm(cfg: DLRMConfig, ffconfig: Optional[FFConfig] = None,
               stacked_embeddings: Optional[bool] = None,
               table_parallel: bool = False) -> FFModel:
    """Build the fused DLRM graph: ``bot_0..`` Linear ops, ``emb``
    (FusedEmbedInteract over the (B, T, bag) ``sparse`` ids and the
    bottom output), ``top_0..`` Linear ops — the same op names and
    parameter shapes as the JAX package's fused graph."""
    ffconfig = ffconfig or FFConfig()
    fmode = getattr(cfg, "fused_interaction", "off")
    if fmode not in ("off", "auto", "on"):
        raise ValueError(
            f"fused_interaction must be 'off'|'auto'|'on', got {fmode!r}")
    if fmode == "off" or stacked_embeddings is False:
        raise NotImplementedError(
            "the classic DLRM graph (per-table or stacked embeddings, then "
            "reshape and concat/batch_matmul) needs the shape ops: it comes "
            "with slice 2 in ROADMAP.md; build with fused_interaction='on'")
    if table_parallel or getattr(cfg, "exchange_overlap", "off") == "on":
        raise NotImplementedError(
            "table-parallel and overlapped-exchange graphs come with the "
            "scale-out slice in ROADMAP.md")
    model = FFModel(ffconfig)
    b = ffconfig.batch_size
    t = len(cfg.embedding_size)
    dense_in = model.create_tensor((b, cfg.mlp_bot[0]), "float32", name="dense")
    bottom = _create_mlp(model, dense_in, cfg.mlp_bot, cfg.sigmoid_bot, "bot")
    ids = model.create_tensor((b, t, cfg.embedding_bag_size), "int64",
                              name="sparse")
    z = model.fused_embed_interact(
        ids, bottom, list(cfg.embedding_size), cfg.sparse_feature_size,
        interact=cfg.arch_interaction_op, aggr="sum", name="emb")
    if z.shape[1] != cfg.mlp_top[0]:
        raise ValueError(
            f"interaction width {z.shape[1]} != mlp_top[0] {cfg.mlp_top[0]}")
    sig = cfg.sigmoid_top if cfg.sigmoid_top >= 0 else len(cfg.mlp_top) - 2
    _create_mlp(model, z, cfg.mlp_top, sig, "top")
    return model
