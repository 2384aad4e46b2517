"""Host-loss detection (counterpart of
``dlrm_flexflow_tpu/resilience/watchdog.py``, the whole module).

A crashed or hung peer leaves every survivor parked forever in a
collective or a file barrier.  This module is the detection half of
failure-domain hardening; recovery is ``elastic/recovery.py``
(``recover_and_resume``) and the deadlined pod commit barrier is
``CheckpointManager._barrier``.  In the port the heartbeat protocol and
the stall watchdog run as they do in JAX:

* **heartbeat protocol** — every process touches ``heartbeat-pNNN`` in
  a shared directory on a cadence (:func:`beat`: atomic ``.tmp`` +
  rename, so a file killed mid-write is never read as a live beat); a
  :class:`HostWatchdog` thread re-beats its own file and ages the
  peers' (:func:`heartbeat_ages`), flagging by name every peer whose
  beat is older than the deadline.  Newly-dead peers emit one
  ``recovery`` ``phase="dead_peer"`` event each and the stalest age
  lands on the ``dlrm_host_heartbeat_age_s`` gauge every sweep.
* :class:`FleetBarrierTimeout` — the error the podshard commit barrier
  (``CheckpointManager._barrier``) raises instead of hanging when peers
  never arrive; named here because it is the fleet-death signal
  recovery code catches.
* :class:`StallWatchdog` — the step-level watchdog ``resilient_fit``
  arms (``FFConfig.stall_abort_multiple`` / ``FF_STALL_MULTIPLE``): no
  adopted step progress within ``multiple`` x the recent step wall
  (floored by ``floor_s``) means a wedged collective or hung peer —
  flight dump + loud abort (exit code :data:`STALL_EXIT`), never a
  silent hang.

All state shared between a watchdog thread and its public API is
guarded by one lock per instance (ffcheck shared-state discipline).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..telemetry import emit
from ..telemetry import metrics as _tmetrics
from ..telemetry.fleet import dump_flight_record

#: heartbeat file name prefix; ``heartbeat-p007`` is process 7's beat
HEARTBEAT_PREFIX = "heartbeat-p"

#: process exit code of a stall abort (distinct from generic failure so
#: launchers can tell "watchdog killed a hang" from "training crashed")
STALL_EXIT = 70


class FleetBarrierTimeout(BaseException):
    """A podshard commit barrier timed out: the named peer processes
    never arrived.  Subclasses BaseException (the ``Preemption``
    precedent — resilience/faultinject.py) so the checkpoint manager's
    never-abort ``except Exception`` cannot swallow a dead fleet: a
    barrier that will never fill must end the run LOUDLY (after a
    flight-record dump), not log "save failed, continuing" while every
    peer stays parked.  Single-attempt semantics are preserved — the
    timeout aborts, it never retries: a retry would re-park survivors
    at fences the dead can never fill (docs/distributed.md)."""

    def __init__(self, tag: str, missing, timeout_s: float,
                 arrived: Optional[int] = None,
                 expected: Optional[int] = None):
        self.tag = tag
        self.missing = tuple(missing)
        self.timeout_s = float(timeout_s)
        self.arrived = arrived
        self.expected = expected
        super().__init__(
            f"multihost checkpoint barrier {tag!r}: "
            f"{', '.join(self.missing) or 'peers'} missing after "
            f"{self.timeout_s:.0f}s "
            f"({arrived}/{expected} arrived) — aborting; survivors "
            f"recover via elastic.recover_and_resume from the last "
            f"committed checkpoint")


def _beat_path(directory: str, pidx: int) -> str:
    return os.path.join(directory, f"{HEARTBEAT_PREFIX}{pidx:03d}")


def beat(directory: str, pidx: int) -> str:
    """Touch this process' heartbeat file atomically (write a ``.tmp``
    sibling, then one rename): a process killed mid-beat leaves only a
    ``.tmp`` — never a half-written file that :func:`heartbeat_ages`
    could mistake for a live beat.  Returns the beat path."""
    os.makedirs(directory, exist_ok=True)
    path = _beat_path(directory, pidx)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w"):
        pass
    os.replace(tmp, path)  # the commit: mtime of `path` IS the beat
    return path


def heartbeat_ages(directory: str, nproc: int,
                   now: Optional[float] = None
                   ) -> Dict[str, Optional[float]]:
    """``{"p000": age_s or None, ...}`` for every expected process:
    seconds since each peer's last committed beat, or None when the
    peer has never beaten (no committed file).  Only exact
    ``heartbeat-pNNN`` names count — ``.tmp`` debris of a process
    killed mid-beat is never read as live (the rename in :func:`beat`
    is the commit point)."""
    if now is None:
        now = time.time()
    out: Dict[str, Optional[float]] = {}
    for i in range(int(nproc)):
        try:
            mtime = os.path.getmtime(_beat_path(directory, i))
        except OSError:
            out[f"p{i:03d}"] = None
            continue
        out[f"p{i:03d}"] = max(0.0, now - mtime)
    return out


class HostWatchdog:
    """Per-process heartbeat writer + peer ager (see module docstring).

    One instance per process: ``start()`` launches a daemon thread that
    re-touches this process' ``heartbeat-pNNN`` every ``interval_s``
    and ages every peer's; a peer whose beat (or, before its first
    beat, the watchdog's own start) is older than ``deadline_s`` is
    flagged dead BY NAME — readable via :meth:`dead_peers`, through
    the optional ``on_dead(names)`` callback (called once per newly
    dead set, outside the lock), and as one ``recovery``
    ``phase="dead_peer"`` event per peer.  The stalest peer age lands
    on ``dlrm_host_heartbeat_age_s`` every sweep.  Detection only —
    the caller decides whether to abort, eject, or
    ``recover_and_resume``."""

    def __init__(self, directory: str, pidx: int, nproc: int,
                 interval_s: float = 0.5, deadline_s: float = 5.0,
                 on_dead: Optional[Callable[[List[str]], None]] = None):
        self.directory = str(directory)
        self.pidx = int(pidx)
        self.nproc = int(nproc)
        self.interval_s = float(interval_s)
        self.deadline_s = float(deadline_s)
        self.on_dead = on_dead
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the watchdog thread writes these, the public API reads them —
        # one lock covers both sides (ffcheck shared-state)
        self._lock = threading.Lock()
        self._dead: set = set()
        self._max_age = 0.0
        # a peer that has not beaten yet ages from the watchdog's own
        # start — a fleet member that never wrote a single beat within
        # the deadline is as dead as one that stopped
        self._t_start = time.time()

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "HostWatchdog":
        beat(self.directory, self.pidx)  # visible before the first sweep
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="dlrm-host-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=max(2.0, 4 * self.interval_s))

    def __enter__(self) -> "HostWatchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # --------------------------------------------------------------- reading
    def dead_peers(self) -> List[str]:
        """Names (``p000``-style) of every peer flagged dead so far."""
        with self._lock:
            return sorted(self._dead)

    def max_peer_age(self) -> float:
        """Stalest peer heartbeat age seen on the latest sweep."""
        with self._lock:
            return self._max_age

    def wait_for_death(self, timeout_s: float) -> List[str]:
        """Block until some peer is flagged dead (or ``timeout_s``
        passes); returns :meth:`dead_peers` either way.  Launchers use it
        as the detection fence before recovery."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            dead = self.dead_peers()
            if dead:
                return dead
            time.sleep(min(0.05, self.interval_s))
        return self.dead_peers()

    # ---------------------------------------------------------------- thread
    def _run(self) -> None:
        self.sweep()
        while not self._stop.wait(self.interval_s):
            self.sweep()

    def sweep(self) -> List[str]:
        """One heartbeat + aging pass (the thread's body; callable
        directly in tests).  Returns the peers that turned dead on
        THIS sweep."""
        try:
            beat(self.directory, self.pidx)
        except OSError:
            pass  # a wedged shared FS: aging alone still detects peers
        now = time.time()
        ages = heartbeat_ages(self.directory, self.nproc, now=now)
        max_age = 0.0
        newly: List[tuple] = []
        with self._lock:
            for name, age in ages.items():
                if name == f"p{self.pidx:03d}":
                    continue
                if age is None:  # never beat: age since watchdog start
                    age = max(0.0, now - self._t_start)
                max_age = max(max_age, age)
                if age > self.deadline_s and name not in self._dead:
                    self._dead.add(name)
                    newly.append((name, age))
            self._max_age = max_age
        _tmetrics.HOST_HEARTBEAT_AGE.set(max_age)
        for name, age in newly:
            emit("recovery", phase="dead_peer", peer=name, age_s=age,
                 deadline_s=self.deadline_s)
        if newly and self.on_dead is not None:
            self.on_dead([name for name, _age in newly])
        return [name for name, _age in newly]


class StallWatchdog:
    """Step-level liveness for ``resilient_fit`` (see module
    docstring): ``progress`` is the loop's one-cell list of
    ``time.perf_counter()`` stamps (updated on every adopted
    dispatch), ``wall`` its one-cell recent step-wall estimate.  The
    watchdog thread polls; when no progress lands within
    ``max(multiple * wall[0], floor_s)`` it emits one ``recovery``
    ``phase="stall"`` event, dumps a flight record, prints the verdict
    to stderr, and hard-exits with :data:`STALL_EXIT` — ``os._exit``
    because the main thread is, by definition, wedged (blocked in a
    collective or an injected hang) and cannot run an exception.
    Tests pass ``on_stall(stalled_s, limit_s)`` to observe the firing
    without dying."""

    def __init__(self, progress: List[float],
                 wall: Optional[List[float]] = None,
                 multiple: float = 10.0, floor_s: float = 5.0,
                 poll_s: float = 0.25,
                 on_stall: Optional[Callable[[float, float], None]] = None):
        self.progress = progress
        self.wall = wall if wall is not None else [0.0]
        self.multiple = float(multiple)
        self.floor_s = float(floor_s)
        self.poll_s = float(poll_s)
        self.on_stall = on_stall
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def limit_s(self) -> float:
        return max(self.multiple * float(self.wall[0] or 0.0),
                   self.floor_s)

    def start(self) -> "StallWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="dlrm-stall-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=max(2.0, 4 * self.poll_s))

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            stalled = time.perf_counter() - self.progress[0]
            limit = self.limit_s()
            if stalled <= limit:
                continue
            self._fire(stalled, limit)
            return

    def _fire(self, stalled: float, limit: float) -> None:
        import sys
        emit("recovery", phase="stall", stall_s=stalled, limit_s=limit)
        err = RuntimeError(
            f"training stalled: no adopted step progress for "
            f"{stalled:.1f}s (limit {limit:.1f}s = max({self.multiple:g} "
            f"x recent step wall, {self.floor_s:g}s floor)) — a wedged "
            f"collective or dead peer; aborting loudly")
        dump_flight_record(err)  # best-effort; no-op without a log
        print(f"# stall watchdog: {err}", file=sys.stderr)
        sys.stderr.flush()
        if self.on_stall is not None:
            self.on_stall(stalled, limit)
            return
        os._exit(STALL_EXIT)  # the main thread is wedged; see docstring
