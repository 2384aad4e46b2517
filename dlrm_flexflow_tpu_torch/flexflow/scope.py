"""Reference scripts on the port: the ``flexflow`` name and the device.

The JAX package holds the top-level name ``flexflow`` (``flexflow/`` at
the repo root), so a reference script's ``from flexflow.core import *``
reaches this subpackage only inside :func:`use_port_flexflow`.  For its
duration ``sys.modules`` maps ``flexflow`` and every ``flexflow.*``
module onto ``dlrm_flexflow_tpu_torch.flexflow`` and its modules, all
imported first (no file is loaded twice under two names; the modules
``keras/datasets.py`` and ``keras/utils.py`` register, such as
``flexflow.keras.datasets.mnist``, included).  On exit the entries that
were there before come back, so a later ``import flexflow.core`` in the
same process gives the JAX binding again.

The scope's device is where ``FFModel.init_layers`` and the keras
models' ``compile`` place the weights.  None means the CUDA card, as for
every entry point of the port (``device.py``): without one they raise,
and nothing falls back to the CPU.  Tests pass ``device="cpu"``.

``python -m dlrm_flexflow_tpu_torch.flexflow [--device cpu] script.py
[args...]`` runs a script through :func:`run_script`.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import pkgutil
import runpy
import sys
from typing import List, Optional

PACKAGE = __name__.rpartition(".")[0]
ALIAS = "flexflow"

# the device of each open scope, innermost last
_DEVICES: List[Optional[str]] = [None]


def current_device(device=None):
    """``device`` when given, else the innermost scope's (None: the
    card)."""
    return device if device is not None else _DEVICES[-1]


def _import_all() -> None:
    pkg = importlib.import_module(PACKAGE)
    for info in pkgutil.walk_packages(pkg.__path__, PACKAGE + "."):
        if not info.name.endswith(".__main__"):
            importlib.import_module(info.name)


def _aliased(name: str) -> bool:
    return name == ALIAS or name.startswith(ALIAS + ".")


@contextlib.contextmanager
def use_port_flexflow(device=None):
    """Map ``flexflow`` and its submodules onto this subpackage, with
    ``device`` (None: the card) as the weights' device, until the block
    ends; yields the subpackage."""
    _import_all()
    saved = {k: m for k, m in sys.modules.items() if _aliased(k)}
    for k in saved:
        del sys.modules[k]
    for k, m in list(sys.modules.items()):
        if k == PACKAGE or k.startswith(PACKAGE + "."):
            sys.modules[ALIAS + k[len(PACKAGE):]] = m
    _DEVICES.append(device)
    try:
        yield sys.modules[ALIAS]
    finally:
        _DEVICES.pop()
        for k in [k for k in sys.modules if _aliased(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def run_script(path: str, args=(), device=None) -> dict:
    """Run the reference script at ``path`` as ``__main__`` with
    ``sys.argv`` ``[path, *args]`` and its directory first on
    ``sys.path``, as ``python path args...`` would, inside
    :func:`use_port_flexflow`; returns its globals."""
    argv, syspath = sys.argv, list(sys.path)
    sys.argv = [path, *args]
    sys.path.insert(0, os.path.dirname(os.path.abspath(path)))
    try:
        with use_port_flexflow(device):
            return runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv
        sys.path[:] = syspath
