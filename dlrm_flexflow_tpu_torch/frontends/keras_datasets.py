"""Keras-compatible dataset loaders: mnist, cifar10, reuters (counterpart
of ``dlrm_flexflow_tpu/frontends/keras_datasets.py``, the same code and
the same arrays for the same call).

The reference's dataset modules (reference:
python/flexflow/keras/datasets/{mnist,cifar10,reuters,cifar}.py)
download from the network; these never do: each loader reads the
standard local keras cache when present and otherwise falls back to a
DETERMINISTIC synthetic dataset with the real shapes and dtypes
(announced on stdout), so examples and tests run anywhere.

Usage matches keras:  ``from dlrm_flexflow_tpu_torch.frontends.keras_datasets
import mnist; (x, y), (xt, yt) = mnist.load_data()``.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np

from .keras_utils import pad_sequences  # noqa: F401  (re-export surface)

_CACHE = os.path.join(os.path.expanduser("~"), ".keras", "datasets")


def _announce_synthetic(name):
    print(f"[keras.datasets.{name}] no local cache in {_CACHE}; "
          f"using deterministic synthetic data (no download)")


# ------------------------------------------------------------------- mnist
def _mnist_load(path="mnist.npz"):
    """reference datasets/mnist.py:11-36: returns (x_train, y_train),
    (x_test, y_test) with x uint8 (n, 28, 28), y uint8."""
    full = os.path.join(_CACHE, path)
    if os.path.exists(full):
        with np.load(full, allow_pickle=True) as f:
            return ((f["x_train"], f["y_train"]),
                    (f["x_test"], f["y_test"]))
    _announce_synthetic("mnist")
    rng = np.random.default_rng(0)
    x_train = rng.integers(0, 256, size=(60000, 28, 28), dtype=np.uint8)
    y_train = rng.integers(0, 10, size=(60000,), dtype=np.uint8)
    x_test = rng.integers(0, 256, size=(10000, 28, 28), dtype=np.uint8)
    y_test = rng.integers(0, 10, size=(10000,), dtype=np.uint8)
    return (x_train, y_train), (x_test, y_test)


# ----------------------------------------------------------------- cifar10
def _cifar10_load(num_samples=40000):
    """reference datasets/cifar10.py:13-42: channels-first uint8
    (n, 3, 32, 32) train slice of ``num_samples`` + 10k test."""
    dirname = os.path.join(_CACHE, "cifar-10-batches-py")
    if os.path.isdir(dirname):
        import pickle

        def load_batch(fpath):
            with open(fpath, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data = d[b"data"].reshape(-1, 3, 32, 32)
            labels = np.asarray(d[b"labels"], dtype=np.uint8)
            return data, labels

        xs, ys = [], []
        # enough batches to cover num_samples (each file holds 10000)
        nbatches = min(5, -(-num_samples // 10000))
        for i in range(1, max(nbatches, 1) + 1):
            x, y = load_batch(os.path.join(dirname, f"data_batch_{i}"))
            xs.append(x)
            ys.append(y)
        x_train = np.concatenate(xs)[:num_samples]
        y_train = np.concatenate(ys)[:num_samples]
        x_test, y_test = load_batch(os.path.join(dirname, "test_batch"))
        return ((x_train, y_train.reshape(-1, 1)),
                (x_test, y_test.reshape(-1, 1)))
    _announce_synthetic("cifar10")
    rng = np.random.default_rng(0)
    x_train = rng.integers(0, 256, size=(num_samples, 3, 32, 32),
                           dtype=np.uint8)
    y_train = rng.integers(0, 10, size=(num_samples, 1), dtype=np.uint8)
    x_test = rng.integers(0, 256, size=(10000, 3, 32, 32), dtype=np.uint8)
    y_test = rng.integers(0, 10, size=(10000, 1), dtype=np.uint8)
    return (x_train, y_train), (x_test, y_test)


# ----------------------------------------------------------------- reuters
def _reuters_load(path="reuters.npz", num_words=None, skip_top=0,
                  maxlen=None, test_split=0.2, seed=113, start_char=1,
                  oov_char=2, index_from=3, **_kw):
    """reference datasets/reuters.py:15-89: newswire word-id sequences +
    46-topic labels."""
    full = os.path.join(_CACHE, path)
    if os.path.exists(full):
        with np.load(full, allow_pickle=True) as f:
            xs, labels = f["x"], f["y"]
        rng = np.random.RandomState(seed)
        indices = np.arange(len(xs))
        rng.shuffle(indices)
        xs, labels = xs[indices], labels[indices]
    else:
        _announce_synthetic("reuters")
        rng = np.random.default_rng(seed)
        n, vocab = 11228, 30980
        lengths = rng.integers(10, 200, size=n)
        xs = np.array([[start_char] + list(rng.integers(
            index_from, vocab, size=m)) for m in lengths], dtype=object)
        labels = rng.integers(0, 46, size=n)
    if num_words is not None:
        xs = np.array([[w if skip_top <= w < num_words else oov_char
                        for w in x] for x in xs], dtype=object)
    if maxlen is not None:
        keep = [i for i, x in enumerate(xs) if len(x) < maxlen]
        xs, labels = xs[keep], labels[keep]
    split = int(len(xs) * (1 - test_split))
    return ((xs[:split], labels[:split]), (xs[split:], labels[split:]))


def _reuters_word_index(path="reuters_word_index.json"):
    """reference datasets/reuters.py:91-105."""
    full = os.path.join(_CACHE, path)
    if os.path.exists(full):
        with open(full) as f:
            return json.load(f)
    _announce_synthetic("reuters")
    return {f"word{i}": i for i in range(3, 30980)}


# Real module objects (not SimpleNamespace), registered in sys.modules,
# so ``import ...keras_datasets.mnist`` and attribute access name one
# object and monkeypatching either is seen by both.
mnist = types.ModuleType(__name__ + ".mnist")
mnist.load_data = _mnist_load
cifar10 = types.ModuleType(__name__ + ".cifar10")
cifar10.load_data = _cifar10_load
reuters = types.ModuleType(__name__ + ".reuters")
reuters.load_data = _reuters_load
reuters.get_word_index = _reuters_word_index
for _m in (mnist, cifar10, reuters):
    sys.modules[_m.__name__] = _m
