"""What the port compiles, as ``compile`` telemetry events (the
counterpart of ``dlrm_flexflow_tpu/telemetry/jax_hooks.py``).

The JAX package observes XLA's compiles through ``jax.monitoring`` and
emits one ``compile`` event per backend compile, plus ``kind="aot"``
events for the programs it lowers and compiles itself.  PyTorch runs
eagerly and compiles nothing of its own on the port's paths; what the
port builds is of two kinds, and each build site calls
:func:`record_compile`:

* a CUDA-graph capture (``graphs.GraphRunner``), the counterpart of an
  AOT compile: ``kind="aot"``, ``fn="serve[bucket=b]"`` for an engine
  bucket (as ``serving/engine.py:466`` names it) and ``fn="train_step"``
  for the model's captured step, with its donated-argument count
  (``model.py:2460-2470``);
* a kernel build (``_cuda.build``): ``kind="nvcc"``, ``fn`` the source.

``compile_stats`` keeps running counts and seconds per kind, whether or
not an event log is active.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .events import active_log

_lock = threading.Lock()
_counters: Dict[str, float] = {}


def record_compile(kind: str, duration_s: float, fn: Optional[str] = None,
                   donated_args: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Count one compile of ``kind`` and emit its ``compile`` event into
    the active log (no event while telemetry is off)."""
    with _lock:
        _counters[kind] = _counters.get(kind, 0) + 1
        _counters[kind + "_s"] = _counters.get(kind + "_s", 0.0) + duration_s
    log = active_log()
    if log is not None:
        log.emit("compile", kind=kind, duration_s=float(duration_s), fn=fn,
                 donated_args=donated_args, backend=backend)


def compile_stats() -> Dict[str, float]:
    """Snapshot of the running counters: per kind (``aot``, ``nvcc``) the
    count and, under ``<kind>_s``, the total seconds."""
    with _lock:
        return dict(_counters)
