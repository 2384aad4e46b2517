"""Import a PyTorch module via torch.fx and keep training it on the port
(reference: flexflow/torch/fx.py path)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..config import FFConfig
from ..device import resolve_device
from ..frontends.torch_fx import PyTorchModel
from ..optim import SGDOptimizer


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(32, 64)
        self.fc2 = nn.Linear(64, 10)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def main(argv=None, *, device=None):
    dev = resolve_device(device)
    torch_model = Net()
    conv = PyTorchModel(torch_model)
    model = conv.apply(FFConfig(batch_size=64), {"x": (32,)})
    model.compile(optimizer=SGDOptimizer(0.01),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=("accuracy",))
    state = model.init(device=dev)
    state = conv.import_weights(model, state)  # numerics now match torch

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    out = model.forward(state, {"x": x})
    ref = torch_model(torch.from_numpy(x)).detach().numpy()
    print("max |port - torch| =",
          float(np.max(np.abs(out.cpu().numpy() - ref))))

    y = rng.integers(0, 10, size=(64, 1)).astype(np.int32)
    state, mets = model.train_step(state, {"x": x}, y)
    print("one train step, loss =", float(mets["loss"]))


if __name__ == "__main__":
    main()
