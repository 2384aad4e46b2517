"""Inception-v3 (counterpart of ``dlrm_flexflow_tpu/apps/inception.py``;
reference examples/cpp/InceptionV3/inception.cc): blocks A (:26-41), B
(:43-54), C (:56-73), D (:75-88) and E (:90-108) after the stem
(:152-174); input (B, 3, 299, 299), avg pool 8x8, flat, dense 10,
softmax; SGD at 0.001 with sparse CCE.

    python -m dlrm_flexflow_tpu_torch.apps.inception -b 64 -e 1

trains it on the CUDA card on the CLI's synthetic data (``cli_loader``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import FFConfig
from ..data.loader import ArrayDataLoader
from ..model import FFModel
from ..optim import SGDOptimizer

LOSS = "sparse_categorical_crossentropy"
METRICS = ("accuracy", "sparse_categorical_crossentropy")


def inception_a(m: FFModel, x, pool_features: int):
    t1 = m.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation="relu")
    t2 = m.conv2d(x, 48, 1, 1, 1, 1, 0, 0, activation="relu")
    t2 = m.conv2d(t2, 64, 5, 5, 1, 1, 2, 2, activation="relu")
    t3 = m.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation="relu")
    t3 = m.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation="relu")
    t3 = m.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation="relu")
    t4 = m.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    t4 = m.conv2d(t4, pool_features, 1, 1, 1, 1, 0, 0, activation="relu")
    return m.concat([t1, t2, t3, t4], axis=1)


def inception_b(m: FFModel, x):
    t1 = m.conv2d(x, 384, 3, 3, 2, 2, 0, 0)
    t2 = m.conv2d(x, 64, 1, 1, 1, 1, 0, 0)
    t2 = m.conv2d(t2, 96, 3, 3, 1, 1, 1, 1)
    t2 = m.conv2d(t2, 96, 3, 3, 2, 2, 0, 0)
    t3 = m.pool2d(x, 3, 3, 2, 2, 0, 0)
    return m.concat([t1, t2, t3], axis=1)


def inception_c(m: FFModel, x, channels: int):
    t1 = m.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t2 = m.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    t2 = m.conv2d(t2, channels, 1, 7, 1, 1, 0, 3)
    t2 = m.conv2d(t2, 192, 7, 1, 1, 1, 3, 0)
    t3 = m.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    t3 = m.conv2d(t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = m.conv2d(t3, channels, 1, 7, 1, 1, 0, 3)
    t3 = m.conv2d(t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = m.conv2d(t3, 192, 1, 7, 1, 1, 0, 3)
    t4 = m.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    t4 = m.conv2d(t4, 192, 1, 1, 1, 1, 0, 0)
    return m.concat([t1, t2, t3, t4], axis=1)


def inception_d(m: FFModel, x):
    t1 = m.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t1 = m.conv2d(t1, 320, 3, 3, 2, 2, 0, 0)
    t2 = m.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t2 = m.conv2d(t2, 192, 1, 7, 1, 1, 0, 3)
    t2 = m.conv2d(t2, 192, 7, 1, 1, 1, 3, 0)
    t2 = m.conv2d(t2, 192, 3, 3, 2, 2, 0, 0)
    t3 = m.pool2d(x, 3, 3, 2, 2, 0, 0)
    return m.concat([t1, t2, t3], axis=1)


def inception_e(m: FFModel, x):
    t1 = m.conv2d(x, 320, 1, 1, 1, 1, 0, 0)
    t2i = m.conv2d(x, 384, 1, 1, 1, 1, 0, 0)
    t2 = m.conv2d(t2i, 384, 1, 3, 1, 1, 0, 1)
    t3 = m.conv2d(t2i, 384, 3, 1, 1, 1, 1, 0)
    t3i = m.conv2d(x, 448, 1, 1, 1, 1, 0, 0)
    t3i = m.conv2d(t3i, 384, 3, 3, 1, 1, 1, 1)
    t4 = m.conv2d(t3i, 384, 1, 3, 1, 1, 0, 1)
    t5 = m.conv2d(t3i, 384, 3, 1, 1, 1, 1, 0)
    t6 = m.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    t6 = m.conv2d(t6, 192, 1, 1, 1, 1, 0, 0)
    return m.concat([t1, t2, t3, t4, t5, t6], axis=1)


def build_inception(ffconfig: Optional[FFConfig] = None,
                    num_classes: int = 10, image_size: int = 299) -> FFModel:
    ffconfig = ffconfig or FFConfig()
    m = FFModel(ffconfig)
    b = ffconfig.batch_size
    x = m.create_tensor((b, 3, image_size, image_size), "float32",
                        name="input")
    t = m.conv2d(x, 32, 3, 3, 2, 2, 0, 0, activation="relu")
    t = m.conv2d(t, 32, 3, 3, 1, 1, 0, 0, activation="relu")
    t = m.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu")
    t = m.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = m.conv2d(t, 80, 1, 1, 1, 1, 0, 0, activation="relu")
    t = m.conv2d(t, 192, 3, 3, 1, 1, 1, 1, activation="relu")
    t = m.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = inception_a(m, t, 32)
    t = inception_a(m, t, 64)
    t = inception_a(m, t, 64)
    t = inception_b(m, t)
    t = inception_c(m, t, 128)
    t = inception_c(m, t, 160)
    t = inception_c(m, t, 160)
    t = inception_c(m, t, 192)
    t = inception_d(m, t)
    t = inception_e(m, t)
    t = inception_e(m, t)
    t = m.pool2d(t, 8, 8, 1, 1, 0, 0, pool_type="avg")
    t = m.flat(t)
    t = m.dense(t, num_classes)
    m.softmax(t)
    return m


def cli_loader(ffconfig: FFConfig, batches: int = 2) -> ArrayDataLoader:
    """The JAX CLI's data: ``batches`` batches of standard-normal images
    and uniform labels from ``default_rng(0)``."""
    n = batches * ffconfig.batch_size
    rng = np.random.default_rng(0)
    return ArrayDataLoader(
        {"input": rng.standard_normal((n, 3, 299, 299)).astype(np.float32)},
        rng.integers(0, 10, size=(n, 1)).astype(np.int32),
        ffconfig.batch_size)


def run(argv: Sequence[str] = ()):
    """The reference app's CLI on the CUDA card; returns samples/s."""
    ffconfig = FFConfig.parse_args(argv)
    model = build_inception(ffconfig)
    model.compile(optimizer=SGDOptimizer(lr=0.001), loss_type=LOSS,
                  metrics=METRICS)
    state = model.init()
    state, thpt = model.fit(state, cli_loader(ffconfig),
                            epochs=ffconfig.epochs)
    return thpt


if __name__ == "__main__":
    import sys

    run(sys.argv[1:])
