"""Keras-frontend MLP (the reference's keras example shape, synthetic data
standing in for MNIST — this environment has no dataset egress)."""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..frontends import keras as K


def main(argv=None, *, device=None):
    dev = resolve_device(device)
    model = K.Sequential([
        K.Input((784,), name="pixels"),
        K.Dense(256, activation="relu"),
        K.Dropout(0.2),
        K.Dense(64, activation="relu"),
        K.Dense(10),
        K.Activation("softmax"),
    ])
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=("accuracy",), batch_size=128, device=dev)
    print(model.summary())

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, 784)).astype(np.float32)
    w = rng.standard_normal((784, 10)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).reshape(-1, 1).astype(np.int32)  # learnable
    model.fit(x, y, epochs=3)
    model.evaluate(x, y)


if __name__ == "__main__":
    main()
