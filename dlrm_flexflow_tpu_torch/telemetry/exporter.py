"""Telemetry exporters (counterpart of
``dlrm_flexflow_tpu/telemetry/exporter.py``): a stdlib-only HTTP metrics
endpoint and the Perfetto/Chrome-trace JSON converter.

**Live metrics**: :class:`MetricsServer` serves the process'
:mod:`telemetry.metrics` registry as Prometheus text exposition at
``/metrics`` plus a ``/healthz`` probe, on a daemon thread of a
``ThreadingHTTPServer``, bound to 127.0.0.1 by default.  Scrapes are
pull-only.  Opt-in via ``FFConfig.metrics_port`` / ``--metrics-port``
(``FFModel.compile`` starts the process-wide server once) or explicitly
via :func:`start_metrics_server`.

**Trace export**: :func:`chrome_trace` renders a telemetry JSONL's
``span`` events on per-thread tracks, with the run's ``step`` /
``compile`` / ``op_time`` / ``serve`` dispatch events on labelled
synthetic tracks, as Chrome trace-event JSON that opens in Perfetto or
chrome://tracing; :func:`export_trace` writes it from a JSONL file (read
by ``report.load_events``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .metrics import REGISTRY, MetricsRegistry, render_exemplars

# ------------------------------------------------------------- HTTP exporter

# /healthz state: "ok" until an SLOMonitor breach flips it to "degraded"
# (telemetry/slo.py).  The degraded reply names the breached objectives
# and still returns 200: the probe reports quality, not liveness, so an
# orchestrator's liveness check keeps passing (a breached server must be
# scaled, not killed) while automation keys off the status field.
_health_lock = threading.Lock()
_health = {"status": "ok", "reason": ""}


def set_health(status: str, reason: str = "") -> None:
    """Set the /healthz verdict ("ok" / "degraded" + reason): called by
    the SLOMonitor's breach and recover transitions."""
    with _health_lock:
        _health["status"] = str(status)
        _health["reason"] = str(reason)


def health() -> dict:
    """The current /healthz verdict (a copy)."""
    with _health_lock:
        return dict(_health)


class _Handler(BaseHTTPRequestHandler):
    server_version = "dlrm-metrics/1"

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            try:
                # tail exemplars ride after the exposition as comment
                # lines (worst requests with trace id + dominant phase);
                # a Prometheus parser skips them
                body = (self.server.registry.render()
                        + render_exemplars()).encode("utf-8")
            except Exception as e:  # a broken collector must not 500-loop
                self._reply(500, f"collect failed: {e!r}\n".encode(),
                            "text/plain; charset=utf-8")
                return
            self._reply(200, body,
                        "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            self._reply(200, (json.dumps(health()) + "\n").encode(),
                        "application/json")
        else:
            self._reply(404, b"not found\n", "text/plain; charset=utf-8")

    def log_message(self, *args):  # silence per-request stderr lines
        pass


class MetricsServer:
    """One scrape endpoint.  ``port=0`` binds an ephemeral port (tests);
    read the bound port back from :attr:`port`.  Binds loopback by
    default — the endpoint is unauthenticated, so exposing it beyond
    the host (``host="0.0.0.0"`` for a real Prometheus deployment) is
    an explicit choice."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        self._srv = ThreadingHTTPServer((host, int(port)), _Handler)
        self._srv.daemon_threads = True
        self._srv.registry = registry or REGISTRY
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "MetricsServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._srv.serve_forever,
                name="dlrm-metrics-exporter", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


_global_server: Optional[MetricsServer] = None
_global_lock = threading.Lock()


def start_metrics_server(port: int, host: str = "127.0.0.1",
                         registry: Optional[MetricsRegistry] = None
                         ) -> MetricsServer:
    """Start (once) the process-wide metrics endpoint on ``port``.
    Idempotent: later calls return the running server (a port mismatch
    warns rather than binding a second endpoint)."""
    global _global_server
    with _global_lock:
        if _global_server is not None:
            if int(port) not in (0, _global_server.port):
                import warnings
                warnings.warn(
                    f"metrics server already running on port "
                    f"{_global_server.port}; ignoring request for "
                    f"{port}", RuntimeWarning)
            return _global_server
        _global_server = MetricsServer(port=port, host=host,
                                       registry=registry).start()
        return _global_server


def global_metrics_server() -> Optional[MetricsServer]:
    """The process-wide endpoint ``start_metrics_server`` started, or
    None before the first start."""
    return _global_server


# ----------------------------------------------------------- chrome tracing
#: synthetic track ids for events that carry no thread identity (small
#: ints cannot collide with real thread idents, which are pointers/tids)
_TRACK_STEPS = 1
_TRACK_COMPILES = 2
_TRACK_OPS = 3
_TRACK_SERVE = 4
_SYNTH_TRACKS = {_TRACK_STEPS: "train steps", _TRACK_COMPILES: "compiles",
                 _TRACK_OPS: "op times", _TRACK_SERVE: "serve dispatches"}

_PID = 1


def _x(name: str, ts_us: float, dur_us: float, tid: int, cat: str,
       args: Optional[dict] = None) -> dict:
    ev = {"ph": "X", "name": name, "cat": cat, "pid": _PID, "tid": tid,
          "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.001), 3)}
    if args:
        ev["args"] = args
    return ev


def chrome_trace(events: List[dict]) -> dict:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` wrapper
    Perfetto's JSON importer expects) from a list of schema-valid
    telemetry events.  Spans land on their opening thread's track;
    step / compile / op_time / serve-dispatch events land on labelled
    synthetic tracks.  Timestamps are microseconds relative to the
    earliest start in the log."""
    starts: List[float] = []
    for e in events:
        t = e.get("type")
        ts = float(e.get("ts", 0.0))
        if t == "span":
            starts.append(float(e["start_s"]))
        elif t == "step":
            starts.append(ts - float(e["wall_s"]))
        elif t == "compile":
            starts.append(ts - float(e["duration_s"]))
        elif t == "serve" and e.get("phase") == "dispatch":
            starts.append(ts - float(e.get("compute_us", 0.0)) * 1e-6)
        elif t == "op_time":
            # like step/compile, emitted AFTER the measured stretch
            starts.append(ts - float(e["forward_s"]))
    if not starts:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(starts)

    out: List[dict] = []
    tids: Dict[int, str] = dict(_SYNTH_TRACKS)
    for e in events:
        t = e.get("type")
        ts = float(e.get("ts", 0.0))
        if t == "span":
            tid = int(e.get("tid", 0))
            if e.get("thread"):
                tids.setdefault(tid, e["thread"])
            args = dict(e.get("attrs") or {})
            args.update(trace_id=e["trace_id"], span_id=e["span_id"])
            if "parent_id" in e:
                args["parent_id"] = e["parent_id"]
            if "status" in e:
                args["status"] = e["status"]
            out.append(_x(e["name"], (float(e["start_s"]) - t0) * 1e6,
                          float(e["dur_us"]), tid, "span", args))
        elif t == "step":
            wall = float(e["wall_s"])
            name = f"step:{e.get('phase', '?')}"
            args = {k: e[k] for k in ("samples", "samples_per_s", "epochs",
                                      "steps", "loss", "fenced") if k in e}
            out.append(_x(name, (ts - wall - t0) * 1e6, wall * 1e6,
                          _TRACK_STEPS, "step", args))
        elif t == "compile":
            dur = float(e["duration_s"])
            name = f"compile:{e.get('fn', e.get('kind', '?'))}"
            out.append(_x(name, (ts - dur - t0) * 1e6, dur * 1e6,
                          _TRACK_COMPILES, "compile",
                          {"kind": e.get("kind")}))
        elif t == "op_time":
            fwd = float(e["forward_s"])
            args = {k: e[k] for k in ("backward_s", "sim_forward_s")
                    if k in e}
            out.append(_x(f"op:{e['op']}", (ts - fwd - t0) * 1e6,
                          fwd * 1e6, _TRACK_OPS, "op_time", args))
        elif t == "serve" and e.get("phase") == "dispatch":
            dur_us = float(e.get("compute_us", 0.0))
            args = {k: e[k] for k in ("batch", "bucket", "padded", "fill",
                                      "queue_wait_us") if k in e}
            out.append(_x(f"dispatch[b={e.get('bucket', '?')}]",
                          (ts - t0) * 1e6 - dur_us, dur_us,
                          _TRACK_SERVE, "serve", args))
    for tid, name in sorted(tids.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                    "tid": tid, "args": {"name": name}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_trace(jsonl_path: str, out_path: str) -> Dict[str, int]:
    """Read a telemetry JSONL, write the Chrome-trace JSON, return
    counts for the CLI's one-line summary."""
    from .report import load_events

    events = load_events(jsonl_path)
    doc = chrome_trace(events)
    with open(out_path, "w") as f:
        json.dump(doc, f)
    n_spans = sum(1 for e in events if e.get("type") == "span")
    return {"events": len(events), "spans": n_spans,
            "trace_events": len(doc["traceEvents"])}
