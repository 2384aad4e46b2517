"""Train DLRM on Criteo-format data end-to-end.

The reference's flagship path loads Criteo HDF5 into zero-copy regions
and trains on it (reference examples/cpp/DLRM/dlrm.cc:266-382,
run_criteo_kaggle.sh, preprocess_hdf.py).  This example mirrors it:

  python -m dlrm_flexflow_tpu_torch.examples.dlrm_criteo --dataset path/to/criteo.h5
  python -m dlrm_flexflow_tpu_torch.examples.dlrm_criteo --npz raw.npz   # preprocess first
  python -m dlrm_flexflow_tpu_torch.examples.dlrm_criteo                 # no file: Zipf fallback

Without a dataset file it trains on Zipf-skewed synthetic ids — the
realistic stand-in for Criteo's heavy-hitter distribution (a handful of
hot categorical values carries most of the traffic).  Skew is exactly
the regime the epoch row-cache is built for: the epoch touches far
fewer distinct rows than it has lookups, so the cache (sized by
occurrences, filled by distinct rows) turns almost every table access
into a small-cache hit.  The script prints that ratio alongside the
per-epoch metrics.  This is the JAX script ``examples/dlrm_criteo.py``
on the port (its command line, its lines); the HDF5 files need h5py.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..apps.dlrm import build_dlrm, criteo_kaggle_config
from ..config import FFConfig
from ..data.loader import (ArrayDataLoader, ZipfDLRMLoader, load_criteo_h5,
                           preprocess_criteo_npz)
from ..device import resolve_device
from ..optim import SGDOptimizer


def main(argv=None, *, device=None):
    dev = resolve_device(device)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", help="Criteo HDF5 (X_int/X_cat/y)")
    p.add_argument("--npz", help="raw Criteo .npz to preprocess into HDF5")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--samples", type=int, default=4096,
                   help="synthetic-fallback dataset size")
    p.add_argument("--zipf", type=float, default=1.05,
                   help="synthetic-fallback skew exponent")
    args = p.parse_args(argv)

    dataset = args.dataset
    if args.npz:
        dataset = args.npz.rsplit(".", 1)[0] + ".h5"
        preprocess_criteo_npz(args.npz, dataset)
        print(f"preprocessed {args.npz} -> {dataset}")

    cfg = criteo_kaggle_config()  # the shared benched architecture
    fc = FFConfig(batch_size=args.batch, compute_dtype="bfloat16")
    model = build_dlrm(cfg, fc)
    model.compile(optimizer=SGDOptimizer(lr=0.05),
                  loss_type="mean_squared_error",
                  metrics=("accuracy", "mean_squared_error"))

    if dataset:
        inputs, labels = load_criteo_h5(dataset, stacked=True)
        loader = ArrayDataLoader(inputs, labels, args.batch)
        print(f"loaded {labels.shape[0]} samples from {dataset}")
    else:
        loader = ZipfDLRMLoader(num_samples=args.samples, num_dense=13,
                                table_sizes=cfg.embedding_size, bag_size=1,
                                batch_size=args.batch, a=args.zipf)
        print(f"no dataset file: Zipf(a={args.zipf}) synthetic fallback, "
              f"{args.samples} samples")

    ids = loader.inputs["sparse"]
    distinct = len(np.unique(ids + np.cumsum([0] + cfg.embedding_size[:-1],
                                             dtype=np.int64)[None, :, None]))
    print(f"epoch row-cache premise under this distribution: "
          f"{distinct} distinct rows / {ids.size} lookups "
          f"({distinct / ids.size:.2f}); cache active: "
          f"{model._epoch_cache_active}")

    # stack whole epochs and train each on the device (the zero-copy
    # attached dataset + Legion-traced iteration of the reference,
    # dlrm.cc:266-382)
    nb = loader.num_batches
    stacked = {k: v[:nb * args.batch].reshape((nb, args.batch) + v.shape[1:])
               for k, v in loader.inputs.items()}
    labels = loader.labels[:nb * args.batch].reshape(nb, args.batch, 1)
    state = model.init(seed=0, device=dev)
    losses, accs = [], []
    for ep in range(args.epochs):
        state, mets = model.train_epoch(state, stacked, labels)
        loss = float(mets["loss"])
        acc = float(mets.get("train_correct", 0.0)) / (nb * args.batch)
        losses.append(loss)
        accs.append(acc)
        print(f"epoch {ep}: loss {loss:.4f}  accuracy {acc:.2%}")
    if losses[-1] < losses[0]:
        print("loss decreased: training works on this distribution")
    return 0


if __name__ == "__main__":
    sys.exit(main())
