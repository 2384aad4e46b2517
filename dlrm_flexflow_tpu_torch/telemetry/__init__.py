"""Training and serving telemetry of the port (counterpart of
``dlrm_flexflow_tpu/telemetry``): events, schema, spans, metrics, the
exporter, row frequencies, compile events, the reports, the regress gate,
the fleet merge and the SLO monitor.

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

``python -m dlrm_flexflow_tpu_torch.telemetry report run.jsonl`` (or a
directory of per-process sinks; ``--format json`` for the one object,
``--fleet DIR``, ``--flight PATH``) prints the JAX package's report:
per-op times, compile timeline, throughput, sim-vs-measured calibration,
tuning, serving, tail, SLO and span sections; ``export-trace`` renders a
run for Perfetto; ``regress`` gates a bench result against a baseline,
keying H100 entries (``device``) apart from TPU ones.  ``slo.SLOMonitor``
turns the live metrics into burn rates, breach events, a flight record
and the ``/healthz`` verdict; ``fleet`` merges per-process sinks and
writes and renders flight records.
"""

from .events import (EventLog, active_log, emit, event_log,
                     sample_memory, set_event_log, suppressed)
from .fleet import (dump_flight_record, find_flight_records,
                    fleet_data, fleet_event_log, fleet_stamp,
                    load_fleet_events, load_flight_record,
                    process_sink_path)
from .rowfreq import RowFreqCounter, hot_rows
from .schema import SCHEMA, SCHEMA_VERSION, validate_event
from .slo import SLO, SLOMonitor, parse_slos
from .torch_hooks import compile_stats, record_compile
from .trace import (NULL_SPAN, Span, current_span, open_span_records,
                    record_span, span, start_span)

__all__ = [
    "EventLog", "active_log", "emit", "event_log",
    "sample_memory", "set_event_log", "suppressed", "compile_stats",
    "record_compile", "SCHEMA", "SCHEMA_VERSION", "validate_event",
    "NULL_SPAN", "Span", "current_span", "open_span_records",
    "record_span", "span", "start_span",
    "dump_flight_record", "find_flight_records", "fleet_data",
    "fleet_event_log", "fleet_stamp", "load_fleet_events",
    "load_flight_record", "process_sink_path", "RowFreqCounter",
    "hot_rows", "SLO", "SLOMonitor", "parse_slos",
]
