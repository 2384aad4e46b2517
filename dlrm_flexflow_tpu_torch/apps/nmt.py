"""NMT: the LSTM sequence-to-sequence model (counterpart of
``dlrm_flexflow_tpu/apps/nmt.py``; reference nmt/nmt.cc:32-70): a
2-layer encoder and a 2-layer decoder LSTM at 2048, embeddings of 2048
over a 20,480-word vocabulary, the decoder started from the encoder's
final state, a dense projection to the vocabulary; SGD with sparse CCE.

Both embeddings take ids straight from the model's inputs, so under SGD
they train on the row-sparse path: each step's rows land in the tables
through the row-update kernel (two calls a step on the card).

    python -m dlrm_flexflow_tpu_torch.apps.nmt -b 64 -e 1

trains it on the CUDA card on the CLI's synthetic data (``cli_loader``).
``seq_shards > 1`` sets the LSTMs' time-sharded ``ParallelConfig`` (the
reference's per-block placement, rnn.h:58-63); on one card it changes no
value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..config import FFConfig
from ..data.loader import ArrayDataLoader
from ..model import FFModel
from ..optim import SGDOptimizer
from ..parallel.parallel_config import ParallelConfig

LOSS = "sparse_categorical_crossentropy"
METRICS = ("accuracy", "sparse_categorical_crossentropy")


@dataclass
class NMTConfig:
    """Defaults from nmt/nmt.cc:36-50."""

    vocab_size: int = 20 * 1024
    embed_size: int = 2048
    hidden_size: int = 2048
    num_layers: int = 2
    src_len: int = 40
    tgt_len: int = 40


def build_nmt(cfg: Optional[NMTConfig] = None,
              ffconfig: Optional[FFConfig] = None,
              seq_shards: int = 1) -> FFModel:
    """Encoder-decoder predicting the target tokens."""
    cfg = cfg or NMTConfig()
    ffconfig = ffconfig or FFConfig()
    model = FFModel(ffconfig)
    b = ffconfig.batch_size

    src = model.create_tensor((b, cfg.src_len), "int32", name="src")
    tgt = model.create_tensor((b, cfg.tgt_len), "int32", name="tgt_in")

    enc = model.embedding(src, cfg.vocab_size, cfg.embed_size, aggr="none",
                          name="src_embed")
    h = c = None
    for l in range(cfg.num_layers):
        enc, h, c = model.lstm(enc, cfg.hidden_size, return_sequences=True,
                               return_state=True, name=f"enc_lstm_{l}")

    dec = model.embedding(tgt, cfg.vocab_size, cfg.embed_size, aggr="none",
                          name="tgt_embed")
    for l in range(cfg.num_layers):
        # each decoder layer starts from the encoder's final state
        dec = model.lstm(dec, cfg.hidden_size, return_sequences=True,
                         initial_state=(h, c), name=f"dec_lstm_{l}")
    model.dense(dec, cfg.vocab_size, name="proj")

    if seq_shards > 1:
        for l in range(cfg.num_layers):
            for side in ("enc", "dec"):
                model.get_op(f"{side}_lstm_{l}").parallel_config = \
                    ParallelConfig(dims=(1, seq_shards, 1))
    return model


def cli_loader(cfg: NMTConfig, ffconfig: FFConfig,
               batches: int = 4) -> ArrayDataLoader:
    """The JAX CLI's data: uniform source, target and label tokens from
    ``default_rng(0)``."""
    n = batches * ffconfig.batch_size
    rng = np.random.default_rng(0)
    src = rng.integers(0, cfg.vocab_size, size=(n, cfg.src_len),
                       dtype=np.int32)
    tgt_in = rng.integers(0, cfg.vocab_size, size=(n, cfg.tgt_len),
                          dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(n, cfg.tgt_len, 1),
                          dtype=np.int32)
    return ArrayDataLoader({"src": src, "tgt_in": tgt_in}, labels,
                           ffconfig.batch_size)


def run(argv: Sequence[str] = ()):
    """The reference app's CLI on the CUDA card; returns samples/s."""
    ffconfig = FFConfig.parse_args(argv)
    cfg = NMTConfig()
    model = build_nmt(cfg, ffconfig)
    model.compile(optimizer=SGDOptimizer(lr=ffconfig.learning_rate),
                  loss_type=LOSS, metrics=METRICS)
    state = model.init()
    state, thpt = model.fit(state, cli_loader(cfg, ffconfig),
                            epochs=ffconfig.epochs)
    return thpt


if __name__ == "__main__":
    import sys

    run(sys.argv[1:])
