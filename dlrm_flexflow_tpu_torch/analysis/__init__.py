"""ffcheck for the PyTorch port — static analysis of the port's own
idioms.

    python -m dlrm_flexflow_tpu_torch.analysis [--pass NAME] [--format text|json]

The JAX package's multi-pass AST analyzer, kept as the port's own copy
(same 13 passes in the same order, finding codes, waiver keys, JSON
document and SARIF) and pointed at ``dlrm_flexflow_tpu_torch/`` and
``chip_smoke.py``: lock discipline, blocking under a lock (torch's host
syncs included), capture purity and staleness (functions handed to
``graphs.GraphRunner``, ``with torch.cuda.graph(...)`` bodies, op
forwards and the autograd Functions they apply), donation safety
(``train_step``'s in-place state), cross-thread shared state, re-capture
hazards, import layering, and — over ``torch.distributed`` — collective
divergence, mesh-axis discipline and the podshard barrier protocol.
The shared engine (module loader, scoped symbol index, interprocedural
:class:`~engine.CallGraph` fixed point, :func:`~engine.get_value_taint`
summaries, stable waiver keys, the committed ``analysis/waivers.txt``
baseline) lives in :mod:`engine`; the pass catalog in :mod:`passes`.

Stdlib-only on purpose: the analyzer imports neither torch nor the JAX
package, and runs anywhere the source tree exists.
"""

from .engine import (AnalysisPass, AnalysisResult, BaselineError,
                     CallGraph, Finding, FunctionIndex, Module, Waivers,
                     WaiverError, all_passes, default_waivers,
                     get_callgraph, get_value_taint, load_modules,
                     repo_root, run_analysis, to_sarif, update_baseline,
                     write_json, write_sarif)

__all__ = [
    "AnalysisPass", "AnalysisResult", "BaselineError", "CallGraph",
    "Finding", "FunctionIndex", "Module", "Waivers", "WaiverError",
    "all_passes", "default_waivers", "get_callgraph", "get_value_taint",
    "load_modules", "repo_root", "run_analysis", "to_sarif",
    "update_baseline", "write_json", "write_sarif",
]
