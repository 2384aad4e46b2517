"""AlexNet (counterpart of ``dlrm_flexflow_tpu/apps/alexnet.py``; reference
examples/cpp/AlexNet/alexnet.cc:54-88): conv 64/11x11/s4/p2 + relu, pool
3x3/s2, conv 192/5x5/p2, pool, conv 384/3x3/p1, conv 256/3x3/p1, conv
256/3x3/p1, pool, flat, dense 4096 relu x2, dense 10, softmax; SGD at
0.001 with sparse CCE; input (B, 3, 229, 229).

    python -m dlrm_flexflow_tpu_torch.apps.alexnet -b 64 -e 1

trains it on the CUDA card on the CLI's synthetic data (``cli_loader``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import FFConfig
from ..data.loader import ArrayDataLoader
from ..model import FFModel
from ..optim import SGDOptimizer

#: the CLI's loss and metrics (alexnet.cc)
LOSS = "sparse_categorical_crossentropy"
METRICS = ("accuracy", "sparse_categorical_crossentropy")


def build_alexnet(ffconfig: Optional[FFConfig] = None,
                  num_classes: int = 10, image_size: int = 229) -> FFModel:
    ffconfig = ffconfig or FFConfig()
    model = FFModel(ffconfig)
    b = ffconfig.batch_size
    x = model.create_tensor((b, 3, image_size, image_size), "float32",
                            name="input")
    t = model.conv2d(x, 64, 11, 11, 4, 4, 2, 2, activation="relu")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation="relu")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation="relu")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu")
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.flat(t)
    t = model.dense(t, 4096, activation="relu")
    t = model.dense(t, 4096, activation="relu")
    t = model.dense(t, num_classes)
    model.softmax(t)
    return model


def cli_loader(ffconfig: FFConfig, batches: int = 4) -> ArrayDataLoader:
    """The JAX CLI's data: ``batches`` batches of standard-normal images
    and uniform labels from ``default_rng(0)``."""
    n = batches * ffconfig.batch_size
    rng = np.random.default_rng(0)
    return ArrayDataLoader(
        {"input": rng.standard_normal((n, 3, 229, 229)).astype(np.float32)},
        rng.integers(0, 10, size=(n, 1)).astype(np.int32),
        ffconfig.batch_size)


def run(argv: Sequence[str] = ()):
    """The reference app's CLI on the CUDA card; returns samples/s."""
    ffconfig = FFConfig.parse_args(argv)
    model = build_alexnet(ffconfig)
    model.compile(optimizer=SGDOptimizer(lr=0.001), loss_type=LOSS,
                  metrics=METRICS)
    state = model.init()
    state, thpt = model.fit(state, cli_loader(ffconfig),
                            epochs=ffconfig.epochs)
    return thpt


if __name__ == "__main__":
    import sys

    run(sys.argv[1:])
