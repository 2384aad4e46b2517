"""DLRM on synthetic data (reference run_random.sh config), on the port.

Usage: python -m dlrm_flexflow_tpu_torch.examples.dlrm_synthetic \
           [-b 256] [-e 2] [--data-size 4096]

Trains through ``apps/dlrm.py::run``, which trains on the CUDA card only.
"""

from __future__ import annotations

import sys

from ..apps.dlrm import run
from ..device import resolve_device

#: the arguments when it is given none (``examples/dlrm_synthetic.py``'s)
DEFAULT_ARGS = ("-b 256 -e 2 --arch-sparse-feature-size 64 "
                "--arch-mlp-bot 64-512-512-64 "
                "--arch-mlp-top 576-1024-1024-1024-1 --data-size 4096").split()


def main(argv=None, *, device=None):
    """``run`` on ``argv`` (default ``sys.argv[1:]``), or on DEFAULT_ARGS
    when that is empty; returns its samples/s."""
    if resolve_device(device).type != "cuda":
        raise ValueError(
            "dlrm_synthetic trains through apps.dlrm.run, which runs on the "
            "card only (device=None)")
    argv = sys.argv[1:] if argv is None else list(argv)
    return run(argv or DEFAULT_ARGS)


if __name__ == "__main__":
    main()
