"""Two functions of ``dlrm_flexflow_tpu/telemetry/fleet.py`` that the
resilience layer calls: the crash flight recorder and the grad-sync
prediction.  The fleet merge, its report and the rest of the module come
with the telemetry reports (ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

from .events import EventLog, active_log

#: filename prefix of flight-recorder artifacts; the trailing ``.tmp`` of
#: an in-flight write never matches ``flightrecorder_*.json``
FLIGHT_PREFIX = "flightrecorder_"


def predicted_sync_ms(params=None,
                      bytes_per_chip: Optional[float] = None
                      ) -> Optional[float]:
    """The cost model's price for one step's data-parallel grad
    all-reduce, in ms (JAX ``telemetry/fleet.py:325-347``).  None on one
    device, as in the JAX package (``:333-337``): the port trains on one
    device until the mesh comes (ROADMAP.md Queue A item 8), so there is
    no all-reduce to price."""
    return None


def dump_flight_record(exc: Optional[BaseException] = None,
                       log: Optional[EventLog] = None,
                       out_dir: Optional[str] = None) -> Optional[str]:
    """Dump the crash flight record: the EventLog ring, the still-open
    spans and a metrics snapshot, as ``<out_dir>/flightrecorder_<ts>.json``
    through an atomic tmp + rename (JAX ``telemetry/fleet.py:355``).

    Best effort by contract: it runs inside the exception handling of a
    dying run, so it never raises — any failure (disk full, an
    unserializable attr) degrades to one stderr line and ``None``, and
    the caller re-raises the original exception.  ``out_dir`` defaults to
    ``$FF_FLIGHT_DIR`` or ``artifacts/``.  Returns the artifact's path, or
    None when nothing was written (telemetry off, or the write failed)."""
    log = log if log is not None else active_log()
    if log is None:
        return None
    try:
        from .trace import open_span_records

        try:
            from .metrics import REGISTRY
            metrics_text = REGISTRY.render()
        except Exception:
            metrics_text = None
        ts = time.time()
        stamp = getattr(log, "stamp", None)
        doc = {
            "kind": "flightrecorder",
            "schema_version": 1,
            "ts": ts,
            "exception": (None if exc is None else
                          {"type": type(exc).__name__,
                           "message": str(exc)}),
            "stamp": stamp,
            "events": log.events(),
            "open_spans": open_span_records(),
            "metrics": metrics_text,
        }
        out_dir = out_dir or os.environ.get("FF_FLIGHT_DIR") or "artifacts"
        os.makedirs(out_dir, exist_ok=True)
        stem = f"{FLIGHT_PREFIX}{int(ts * 1000)}"
        if stamp and "pidx" in stamp:
            stem += f"_p{int(stamp['pidx']):03d}"
        final = os.path.join(out_dir, stem + ".json")
        k = 0
        while os.path.exists(final):  # same-ms re-dump: don't clobber
            k += 1
            final = os.path.join(out_dir, f"{stem}-{k}.json")
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        return final
    except Exception as e:  # never mask the exception being handled
        print(f"# flight recorder dump failed: {e!r}", file=sys.stderr)
        return None
