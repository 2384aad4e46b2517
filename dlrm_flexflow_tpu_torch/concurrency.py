"""Thread-coordination primitives (counterpart of
``dlrm_flexflow_tpu/concurrency.py``)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class CloseOnce:
    """Winner-elected idempotent shutdown.  ``run(shutdown)`` elects
    exactly ONE caller to execute ``shutdown()`` and keeps its result;
    concurrent callers park on an event and every later call returns the
    first result without re-running shutdown.  The lock guards only the
    who-runs flag and the stored result, never the shutdown itself.  A
    winner whose shutdown RAISES un-elects itself, so parked and later
    callers run it again."""

    def __init__(self):
        self._lock = threading.Lock()
        self._started = False
        self._done = threading.Event()
        self._summary: Optional[Dict[str, Any]] = None

    def run(self, shutdown):
        while True:
            with self._lock:
                if self._summary is not None:
                    return self._summary
                if not self._started:
                    self._started = True
                    self._done.clear()
                    break  # this caller runs the shutdown
            self._done.wait()
        try:
            summary = shutdown()
        except BaseException:
            # un-elect and wake parked closers in one locked step
            with self._lock:
                self._started = False
                self._done.set()
            raise
        with self._lock:
            self._summary = summary
            self._done.set()
        return summary
