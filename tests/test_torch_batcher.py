"""The port's batcher surface for a replica router (done callbacks, the
queue probes, the engine-failure breaker, dispatcher death, the summary
switch of ``close``) against the JAX package's batcher, on the CPU.

Both batchers drive the same stub engine, so what is compared is the
batcher alone: each scenario returns what a caller can observe (results,
exceptions, probe readings, shed counts and the events of the run), and
the port's record must equal the JAX package's.
"""

import threading
import time
import types

import numpy as np
import pytest

from dlrm_flexflow_tpu import telemetry as jt
from dlrm_flexflow_tpu.serving import DynamicBatcher as JaxBatcher

from dlrm_flexflow_tpu_torch import telemetry as pt
from dlrm_flexflow_tpu_torch.serving import DynamicBatcher
from dlrm_flexflow_tpu_torch.telemetry import metrics as pmetrics

SIDES = {"jax": (JaxBatcher, jt), "port": (DynamicBatcher, pt)}
REQ = {"x": np.ones((1, 2), np.float32)}


class _Lost(BaseException):
    """Not an Exception: the dispatcher cannot absorb it and dies."""


class _Engine:
    """The engine surface a batcher reads: ``model.config``, ``buckets``,
    ``_in_specs`` and ``predict``.  It fails its first ``fail`` calls,
    and every call when ``lost``."""

    def __init__(self, fail=0, lost=False):
        self.model = types.SimpleNamespace(config=types.SimpleNamespace())
        self.buckets = [1, 8]
        self._in_specs = {"x": ((2,), np.float32)}
        self.fail, self.lost = fail, lost

    def predict(self, inputs, queue_wait_us=0.0, timings=None):
        if self.lost:
            raise _Lost("replica lost")
        if self.fail:
            self.fail -= 1
            raise RuntimeError("engine failure")
        return inputs["x"].sum(axis=1, keepdims=True)


@pytest.fixture(autouse=True)
def _fresh_registry():
    # the port's registry is process-wide: start and leave it empty
    pmetrics.reset()
    yield
    pmetrics.reset()


def _until(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "condition not reached"
        time.sleep(0.001)


def _outcome(fut):
    try:
        return ("ok", fut.result(10).tolist())
    except BaseException as e:  # noqa: BLE001 -- _Lost is the point
        return (type(e).__name__, str(e))


def _events(log):
    return sorted((e["type"], e.get("phase") or "", e.get("reason") or "")
                  for e in log.events() if e["type"] != "span")


def _callbacks(batcher_cls):
    b = batcher_cls(_Engine(), max_wait_us=0.0, autostart=False)
    f = b.submit(REQ)
    seen, late = [], []

    def first(fut):
        # result() takes the future's lock: a callback run under it
        # would hang there, so look first
        free = fut._lk.acquire(blocking=False)
        if free:
            fut._lk.release()
        seen.append(("first", free, _outcome(fut) if free else None))

    f.add_done_callback(first)
    f.add_done_callback(lambda fut: 1 / 0)  # reported and swallowed
    f.add_done_callback(lambda fut: seen.append(("third", fut.done())))
    b.start()
    first = _outcome(f)
    b.close(emit_summary=False)  # joins the dispatcher: callbacks ran
    f.add_done_callback(lambda fut: late.append(fut.done()))  # at once
    return dict(first=first, seen=seen, late=late)


def _health(batcher_cls):
    b = batcher_cls(_Engine(fail=2), max_wait_us=0.0, queue_depth=2,
                    autostart=False)
    futs = [b.submit(REQ), b.submit(REQ)]
    rec = dict(depth=b.queue_depth(), full=b.queue_full())
    try:
        b.submit(REQ)
        rec["third"] = "queued"
    except RuntimeError as e:
        rec["third"] = (type(e).__name__, str(e))
    b.start()
    rec["failed"] = [_outcome(f) for f in futs]
    _until(lambda: b.consecutive_engine_failures() == 2)
    rec["ok"] = _outcome(b.submit(REQ))
    rec["breaker"] = b.consecutive_engine_failures()  # re-armed
    rec["dead"] = b.dispatcher_dead()
    rec["after_probe"] = (b.queue_depth(), b.queue_full())
    rec["shed"] = b.stats.shed_causes()
    rec["summary"] = b.close()["requests"]
    return rec


def _death(batcher_cls):
    b = batcher_cls(_Engine(lost=True), max_wait_us=0.0, autostart=False)
    futs = [b.submit(REQ) for _ in range(3)]
    assert not b.dispatcher_dead()
    b.start()
    rec = dict(outcomes=[_outcome(f) for f in futs])
    b._thread.join(10)
    rec["dead"] = b.dispatcher_dead()
    try:
        b.submit(REQ)
    except RuntimeError as e:
        rec["after"] = (type(e).__name__, str(e))
    rec["rejected"] = b.stats.rejected
    return rec


@pytest.mark.parametrize("scenario", [_callbacks, _health, _death],
                         ids=["callbacks", "health", "death"])
def test_batcher_surface_matches_jax(scenario, monkeypatch):
    # the dying dispatcher re-raises on its thread, as it must; keep that
    # out of pytest's unhandled-thread-exception report
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    got = {}
    for side, (batcher_cls, tel) in SIDES.items():
        with tel.event_log() as log:
            rec = scenario(batcher_cls)
        rec["events"] = _events(log)
        got[side] = rec
    assert got["port"] == got["jax"]


def test_scenarios_observe_what_they_claim(monkeypatch):
    """The shared records above hold real behaviour, not two empty
    ones: the port's readings, spelled out."""
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    with pt.event_log() as log:
        cb = _callbacks(DynamicBatcher)
        health = _health(DynamicBatcher)
        death = _death(DynamicBatcher)
    assert cb["first"] == ("ok", [[2.0]])
    assert cb["seen"] == [("first", True, ("ok", [[2.0]])), ("third", True)]
    assert cb["late"] == [True]
    assert health["depth"] == 2 and health["full"] is True
    assert health["third"][0] == "Rejected"
    assert health["failed"] == [("RuntimeError", "engine failure")] * 2
    assert health["ok"] == ("ok", [[2.0]]) and health["breaker"] == 0
    assert health["dead"] is False and health["after_probe"] == (0, False)
    assert health["shed"] == {"queue_full": 1}
    assert death["outcomes"] == [("_Lost", "replica lost")] * 3
    assert death["dead"] is True and death["after"][0] == "Rejected"
    assert death["rejected"] == 4  # three failed, one shut out
    events = _events(log)
    # close(emit_summary=False) emitted no summary; close() did
    assert events.count(("serve", "summary", "")) == 1
    assert ("recovery", "dispatcher_died", "") in events
    assert events.count(("serve", "reject", "replica_dead")) == 3
