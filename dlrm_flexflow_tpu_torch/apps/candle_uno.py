"""Candle-Uno, the cancer drug-response multi-input MLP (counterpart of
``dlrm_flexflow_tpu/apps/candle_uno.py``; reference
examples/cpp/candle_uno/candle_uno.cc): the cell and drug features each
through a feature MLP (3 x 1000), the doses passed through, concat, a deep
MLP (3 x 1000), dense 1; Adam with MSE.

    python -m dlrm_flexflow_tpu_torch.apps.candle_uno -b 64 -e 1

trains it on the CUDA card on the CLI's synthetic data (``cli_loader``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import FFConfig
from ..data.loader import ArrayDataLoader
from ..model import FFModel
from ..optim import AdamOptimizer

LOSS = "mean_squared_error"
METRICS = ("mean_squared_error",)


@dataclass
class CandleConfig:
    """Defaults from candle_uno.cc:27-45."""

    dense_layers: List[int] = field(default_factory=lambda: [1000] * 3)
    dense_feature_layers: List[int] = field(default_factory=lambda: [1000] * 3)
    feature_shapes: Dict[str, int] = field(default_factory=lambda: {
        "dose": 1, "cell.rnaseq": 942, "drug.descriptors": 5270,
        "drug.fingerprints": 2048})
    input_features: Dict[str, str] = field(default_factory=lambda: {
        "dose1": "dose", "dose2": "dose", "cell.rnaseq": "cell.rnaseq",
        "drug1.descriptors": "drug.descriptors",
        "drug1.fingerprints": "drug.fingerprints"})


def build_candle_uno(cfg: Optional[CandleConfig] = None,
                     ffconfig: Optional[FFConfig] = None) -> FFModel:
    cfg = cfg or CandleConfig()
    ffconfig = ffconfig or FFConfig()
    model = FFModel(ffconfig)
    b = ffconfig.batch_size
    # the feature types with an encoder MLP: cell.* and drug.*
    # (candle_uno.cc:93-101)
    encoded_types = {ft for ft in cfg.feature_shapes
                     if "." in ft and ft.split(".")[0] in ("cell", "drug")}
    encoded = []
    for in_name, fea_type in cfg.input_features.items():
        shape = cfg.feature_shapes[fea_type]
        t = model.create_tensor((b, shape), "float32", name=in_name)
        if fea_type in encoded_types:
            for i, w in enumerate(cfg.dense_feature_layers):
                t = model.dense(t, w, activation="relu",
                                name=f"feat_{in_name}_{i}")
        encoded.append(t)
    out = model.concat(encoded, axis=1)
    for i, w in enumerate(cfg.dense_layers):
        out = model.dense(out, w, activation="relu", name=f"dense_{i}")
    model.dense(out, 1, name="out")
    return model


def cli_loader(cfg: CandleConfig, ffconfig: FFConfig,
               batches: int = 4) -> ArrayDataLoader:
    """The JAX CLI's data: standard-normal features and labels from
    ``default_rng(0)``."""
    n = batches * ffconfig.batch_size
    rng = np.random.default_rng(0)
    inputs = {name: rng.standard_normal(
        (n, cfg.feature_shapes[ft])).astype(np.float32)
        for name, ft in cfg.input_features.items()}
    labels = rng.standard_normal((n, 1)).astype(np.float32)
    return ArrayDataLoader(inputs, labels, ffconfig.batch_size)


def run(argv: Sequence[str] = ()):
    """The reference app's CLI on the CUDA card; returns samples/s."""
    ffconfig = FFConfig.parse_args(argv)
    cfg = CandleConfig()
    model = build_candle_uno(cfg, ffconfig)
    model.compile(optimizer=AdamOptimizer(lr=ffconfig.learning_rate),
                  loss_type=LOSS, metrics=METRICS)
    state = model.init()
    state, thpt = model.fit(state, cli_loader(cfg, ffconfig),
                            epochs=ffconfig.epochs)
    return thpt


if __name__ == "__main__":
    import sys

    run(sys.argv[1:])
