"""Run a reference FlexFlow Python script unchanged on the port.

    python -m dlrm_flexflow_tpu_torch.flexflow [--device cpu] script.py [args...]

The script's ``import flexflow...`` reaches ``dlrm_flexflow_tpu_torch.
flexflow`` (``scope.use_port_flexflow``) and its weights go to the CUDA
card, or to ``--device``.  Without a card and without ``--device cpu``
the run raises before the script starts.
"""

from __future__ import annotations

import argparse
import sys

from ..device import resolve_device
from .scope import run_script


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dlrm_flexflow_tpu_torch.flexflow",
        description="run a reference flexflow script on the port")
    p.add_argument("--device", default=None,
                   help="where the weights go (default: the CUDA card)")
    p.add_argument("script")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    resolve_device(a.device)
    run_script(a.script, a.args, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
