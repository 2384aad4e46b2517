"""Training and serving telemetry of the port (counterpart of
``dlrm_flexflow_tpu/telemetry``, its core: events, schema, spans,
metrics, the exporter, row frequencies and compile events).

One process-wide ``EventLog`` (JSONL sink + in-memory ring) records
typed events validated against the JAX package's schema (``schema.py``,
a copy kept equal to it): ``step`` and ``phase_time`` (the trainer),
``compile`` (CUDA-graph captures and kernel builds, ``torch_hooks``),
``memory``, ``serve`` (engine dispatches, batcher rejects and the latency
summary), ``span`` (serving request chains and ``train.fit`` ->
``train.epoch`` -> ``train.dispatch``), ``row_freq`` and ``op_time``
(``profiling.OpTimer``).  Activate with ``set_event_log(EventLog(path=
...))`` or the scoped ``event_log(...)``; producers do nothing when
telemetry is off.  Live metrics (``metrics.py``) are served as Prometheus
text at ``/metrics`` by ``exporter.py``, opt-in via
``FFConfig.metrics_port`` / ``--metrics-port``.

The reports, the fleet merge and the SLO monitor come later (ROADMAP.md).
"""

from .events import (EventLog, active_log, emit, event_log,
                     sample_memory, set_event_log, suppressed)
from .rowfreq import RowFreqCounter, hot_rows
from .schema import SCHEMA, SCHEMA_VERSION, validate_event
from .torch_hooks import compile_stats, record_compile
from .trace import (NULL_SPAN, Span, current_span, record_span, span,
                    start_span)

__all__ = [
    "EventLog", "active_log", "emit", "event_log", "sample_memory",
    "set_event_log", "suppressed", "compile_stats", "record_compile",
    "SCHEMA", "SCHEMA_VERSION", "validate_event", "NULL_SPAN", "Span",
    "current_span", "record_span", "span",
    "start_span", "RowFreqCounter", "hot_rows",
]
