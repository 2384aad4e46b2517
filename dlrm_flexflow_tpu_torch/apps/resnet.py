"""ResNet-50 (counterpart of ``dlrm_flexflow_tpu/apps/resnet.py``; reference
examples/cpp/ResNet/resnet.cc): bottleneck blocks (1x1, 3x3 with the
stride, 1x1 at 4x; a projection shortcut when the stride or the width
changes; add, relu), stem conv 64/7x7/s2/p3 and pool, stages 3/4/6/3 at
64/128/256/512, avg pool over the last map, flat, dense 10, softmax; SGD
at 0.001 with sparse CCE; input (B, 3, 224, 224).

    python -m dlrm_flexflow_tpu_torch.apps.resnet -b 64 -e 1

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


def bottleneck_block(model: FFModel, t, out_channels: int, stride: int):
    inp = t
    in_channels = t.shape[1]
    t = model.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0)
    t = model.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1)
    t = model.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0)
    if stride > 1 or in_channels != 4 * out_channels:
        inp = model.conv2d(inp, 4 * out_channels, 1, 1, stride, stride, 0, 0)
    t = model.add(inp, t)
    return model.relu(t)


def build_resnet(ffconfig: Optional[FFConfig] = None,
                 num_classes: int = 10, image_size: int = 224,
                 stages=(3, 4, 6, 3)) -> FFModel:
    ffconfig = ffconfig or FFConfig()
    model = FFModel(ffconfig)
    b = ffconfig.batch_size
    x = model.create_tensor((b, 3, image_size, image_size), "float32",
                            name="input")
    t = model.conv2d(x, 64, 7, 7, 2, 2, 3, 3)
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1)
    widths = (64, 128, 256, 512)
    for si, (n_blocks, w) in enumerate(zip(stages, widths)):
        for i in range(n_blocks):
            stride = 2 if (si > 0 and i == 0) else 1
            t = bottleneck_block(model, t, w, stride)
    t = model.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, pool_type="avg")
    t = model.flat(t)
    t = model.dense(t, num_classes)
    model.softmax(t)
    return model


def cli_loader(ffconfig: FFConfig, batches: int = 2) -> ArrayDataLoader:
    """The JAX CLI's data: ``batches`` batches of standard-normal images
    and uniform labels from ``default_rng(0)``."""
    n = batches * ffconfig.batch_size
    rng = np.random.default_rng(0)
    return ArrayDataLoader(
        {"input": rng.standard_normal((n, 3, 224, 224)).astype(np.float32)},
        rng.integers(0, 10, size=(n, 1)).astype(np.int32),
        ffconfig.batch_size)


def run(argv: Sequence[str] = ()):
    """The reference app's CLI on the CUDA card; returns samples/s."""
    ffconfig = FFConfig.parse_args(argv)
    model = build_resnet(ffconfig)
    model.compile(optimizer=SGDOptimizer(lr=0.001), loss_type=LOSS,
                  metrics=METRICS)
    state = model.init()
    state, thpt = model.fit(state, cli_loader(ffconfig),
                            epochs=ffconfig.epochs)
    return thpt


if __name__ == "__main__":
    import sys

    run(sys.argv[1:])
