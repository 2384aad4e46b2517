"""The port's ReplicaRouter (dlrm_flexflow_tpu_torch/serving/router.py)
against the JAX package's, driven the same way on the CPU: least-loaded
offers through silent probes, one router-level shed only when every
replica is full, ``check_health`` ejection with ``ReplicaDead``,
``scale_to`` / ``rebuild`` with monotone counters, the pooled ``close``
summary and the router's metric families; and the router over one
tiered engine whose hot tier is exactly one top bucket's working set,
under concurrent clients, against the resident engine bit for bit.
JAX is imported here only.

The parity cases drive both routers over the same stub engine (a
deterministic row sum), so every count, label and load is compared
exactly.
"""

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.serving import ReplicaRouter as JaxRouter
from dlrm_flexflow_tpu.serving.batcher import DynamicBatcher as JaxBatcher
from dlrm_flexflow_tpu.serving.batcher import Rejected as JaxRejected
from dlrm_flexflow_tpu.serving.router import ReplicaDead as JaxReplicaDead
from dlrm_flexflow_tpu.telemetry import metrics as jmetrics

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import telemetry as tele
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.data.loader import zipf_ids
from dlrm_flexflow_tpu_torch.serving import (DynamicBatcher, InferenceEngine,
                                             Rejected, ReplicaDead,
                                             ReplicaRouter)
from dlrm_flexflow_tpu_torch.telemetry import metrics as pmetrics

PKGS = {
    "jax": SimpleNamespace(Router=JaxRouter, Batcher=JaxBatcher,
                           Rejected=JaxRejected, Dead=JaxReplicaDead,
                           metrics=jmetrics, cfg=JaxFFConfig),
    "port": SimpleNamespace(Router=ReplicaRouter, Batcher=DynamicBatcher,
                            Rejected=Rejected, Dead=ReplicaDead,
                            metrics=pmetrics, cfg=fft.FFConfig),
}


class _Stub:
    """An engine the batchers of both packages take: one float input of
    3 features, buckets 1 and 4, the row sum as the answer."""

    def __init__(self, cfg, fail=False):
        self.model = SimpleNamespace(config=cfg)
        self.buckets = [1, 4]
        self._in_specs = {"x": ((3,), np.dtype(np.float32))}
        self.fail = fail

    def predict(self, inputs, queue_wait_us=0.0, timings=None):
        if self.fail:
            raise RuntimeError("engine down")
        return np.asarray(inputs["x"]).sum(axis=1, keepdims=True)


def _req(i, n=1):
    return {"x": np.full((n, 3), float(i), dtype=np.float32)}


@pytest.fixture(autouse=True)
def _fresh_registries():
    pmetrics.reset()
    yield
    pmetrics.reset()


def _drive_saturation(pkg):
    """3 replicas, queues of 3, dispatchers stopped: 9 accepted offers in
    least-loaded order, then one router shed."""
    p = PKGS[pkg]
    stubs = [_Stub(p.cfg()) for _ in range(3)]
    router = p.Router(stubs, queue_depth=3, autostart=False, name=f"s{pkg}")
    loads, placed = [], []
    for i in range(9):
        router.submit(_req(i))
        loads.append(router.loads())
        placed.append([b.queue_depth() for b in router.batchers])
    with pytest.raises(p.Rejected) as err:
        router.submit(_req(99))
    shed = router.shed_count()
    rejected = [b.stats.rejected for b in router.batchers]
    summary = router.close()  # starts the dispatchers and drains
    return {"loads": loads, "placed": placed, "message": str(err.value),
            "shed": shed, "replica_rejected": rejected,
            "summary": {k: summary[k] for k in (
                "replicas", "requests", "dispatches", "rejected",
                "deadline_misses", "router_shed")},
            "keys": sorted(summary),
            "per_replica": len(summary["per_replica"])}


def test_least_loaded_silent_probes_and_one_shed_match_jax():
    """Offers go to the least-loaded replica (ties to the first); a full
    replica's refusal is silent (no replica-level reject); the router
    sheds once, only when every replica is full; the close summary has
    the same keys and counts."""
    got, want = _drive_saturation("port"), _drive_saturation("jax")
    assert got == want
    assert got["shed"] == 1 and got["replica_rejected"] == [0, 0, 0]
    assert got["loads"][2] == [1, 1, 1] and got["summary"]["requests"] == 9


@pytest.mark.parametrize("record", [True, False])
@pytest.mark.parametrize("why", ["queue_full", "shutdown"])
def test_silent_submit_counts_no_shed_like_jax(record, why):
    """``submit(..., record_shed=False)`` refuses without counting a shed
    or emitting a reject; with ``True`` (the default) it counts one."""
    out = {}
    for pkg, p in PKGS.items():
        b = p.Batcher(_Stub(p.cfg()), queue_depth=1, autostart=False)
        b.submit(_req(0))
        if why == "shutdown":
            b.close()
        before = p.metrics.SERVE_REJECTED.value
        with pytest.raises(p.Rejected) as err:
            b.submit(_req(1), None, record)
        out[pkg] = (str(err.value), p.metrics.SERVE_REJECTED.value - before,
                    b.stats.shed_causes())
        b.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == (1 if record else 0)


def test_probe_refusal_closes_its_span_as_probe_refused():
    b = DynamicBatcher(_Stub(fft.FFConfig()), queue_depth=1, autostart=False)
    b.submit(_req(0))
    with tele.event_log() as log:
        with pytest.raises(Rejected):
            b.submit(_req(1), record_shed=False)
        with pytest.raises(Rejected):
            b.submit(_req(2))
        events = log.events()
    b.close()
    spans = [e for e in events if e["type"] == "span"
             and e["name"] == "serve.request"]
    assert [s["status"] for s in spans] == ["probe_refused", "shed"]
    assert [e["reason"] for e in events if e["type"] == "serve"
            and e.get("phase") == "reject"] == ["queue_full"]


def _drive_ejection(pkg):
    p = PKGS[pkg]
    router = p.Router([_Stub(p.cfg()) for _ in range(2)], queue_depth=4,
                      autostart=False, name="e")
    futs = [router.submit(_req(i)) for i in range(4)]
    before = p.metrics.REPLICA_EJECTED.value
    # the first replica's dispatcher dies
    with router.batchers[0]._intake_lock:
        router.batchers[0]._dispatch_exc = RuntimeError("dispatcher died")
    ejected = router.check_health()
    again = router.check_health()
    router.start()
    errs = []
    for f in futs:
        try:
            f.result(timeout=30)
            errs.append(None)
        except BaseException as e:  # noqa: BLE001 — compared below
            errs.append(type(e).__name__)
    served = router.predict(_req(7), result_timeout_s=30)
    summary = router.close()
    return {"ejected": ejected, "again": again, "errs": errs,
            "served": served.tolist(), "labels": router.replica_labels(),
            "count": p.metrics.REPLICA_EJECTED.value - before,
            "summary": {k: summary[k] for k in ("replicas", "requests",
                                                "router_shed")}}


def test_check_health_ejects_like_jax():
    """A dead dispatcher is ejected once; what it owed fails with
    ReplicaDead; the survivor keeps serving; the ejection counts."""
    got, want = _drive_ejection("port"), _drive_ejection("jax")
    assert got == want
    assert got["ejected"] == ["e0"] and got["count"] == 1
    assert got["errs"].count("ReplicaDead") == 2


def test_circuit_breaker_ejects_like_jax():
    out = {}
    for pkg, p in PKGS.items():
        router = p.Router([_Stub(p.cfg(), fail=True), _Stub(p.cfg())],
                          name="c")
        for i in range(3):  # straight to the failing replica
            with pytest.raises(RuntimeError):
                router.batchers[0].predict(_req(i), result_timeout_s=30)
        out[pkg] = (router.check_health(max_engine_failures=5),
                    router.check_health(max_engine_failures=3),
                    router.replica_labels())
        router.close()
    assert out["port"] == out["jax"] == ([], ["c0"], ["c1"])


def _drive_scaling(pkg):
    p = PKGS[pkg]
    stubs = [_Stub(p.cfg()) for _ in range(2)]
    base = p.metrics.SERVE_REQUESTS.value or 0.0
    router = p.Router(stubs, name="g")
    served = []

    def requests_total():
        served.append(p.metrics.SERVE_REQUESTS.value - base)

    for i in range(6):
        router.predict(_req(i), result_timeout_s=30)
    requests_total()
    steps = [router.scale_to(4), router.replica_labels(),
             p.metrics.SERVE_REPLICAS.value]
    for i in range(6):
        router.predict(_req(i), result_timeout_s=30)
    requests_total()
    steps += [router.scale_to(1), router.replica_labels(),
              p.metrics.SERVE_REPLICAS.value]
    requests_total()
    steps += [router.rebuild([_Stub(p.cfg()) for _ in range(3)]),
              router.replica_labels()]
    for i in range(6):
        router.predict(_req(i), result_timeout_s=30)
    requests_total()
    with pytest.raises(ValueError):
        router.scale_to(0)
    summary = router.close()
    with pytest.raises(RuntimeError, match="shut down"):
        router.scale_to(2)
    steps.append({k: summary[k] for k in ("replicas", "requests",
                                          "router_shed")})
    steps.append(len(summary["per_replica"]))
    return steps, served


def test_scale_to_and_rebuild_match_jax_with_monotone_counters():
    (got, pserved), (want, jserved) = (_drive_scaling("port"),
                                       _drive_scaling("jax"))
    assert got == want
    assert pserved == jserved == sorted(pserved)
    assert pserved[-1] == 18
    assert got[1] == ["g0", "g1", "g2", "g3"] and got[4] == ["g0"]
    assert got[7] == ["g4", "g5", "g6"]


def test_router_metric_families_render_like_jax():
    """The per-replica gauge rows and the shed counter, by label."""
    rows = {}
    for pkg, p in PKGS.items():
        # the JAX registry is process-wide and never reset: deltas
        shed0 = p.metrics.SERVE_ROUTER_SHED.value
        sat0 = p.metrics.SERVE_SHED._fn().get("saturated", 0.0)
        router = p.Router([_Stub(p.cfg()) for _ in range(2)], name="m",
                          queue_depth=1, autostart=False)
        router.submit(_req(0))
        router.submit(_req(1))
        with pytest.raises(p.Rejected):
            router.submit(_req(2))
        rows[pkg] = (sorted(p.metrics.SERVE_REPLICA_QUEUE_DEPTH._fn().items()),
                     sorted(p.metrics.SERVE_REPLICA_QPS._fn()),
                     p.metrics.SERVE_REPLICAS.value,
                     p.metrics.SERVE_ROUTER_SHED.value - shed0,
                     p.metrics.SERVE_SHED._fn().get("saturated") - sat0)
        router.close()
        rows[pkg] += (p.metrics.SERVE_REPLICAS.value,
                      p.metrics.SERVE_ROUTER_SHED.value - shed0)
    assert rows["port"] == rows["jax"]
    assert rows["port"][0] == [("m0", 1.0), ("m1", 1.0)]
    text = pmetrics.REGISTRY.render()
    for name in ("dlrm_serve_replicas", "dlrm_serve_router_shed_total",
                 "dlrm_serve_replica_qps", "dlrm_serve_replica_queue_depth",
                 "dlrm_serve_replica_ejected_total"):
        assert f"# TYPE {name} " in text


# ------------------------------------------- the router over a tiered engine
TABLES = [400, 400, 400]
D = 8
TOP = 16


def _tiered_pair():
    """The port's resident and tiered engines on one DLRM (stacked tables
    of 400 x 8, buckets 1, 8, 16, bag 1): the tiered hot tier is exactly
    one top bucket's working set (16 slots a table)."""
    cfg = DLRMConfig(sparse_feature_size=D, embedding_size=list(TABLES),
                     mlp_bot=[13, 16, D], mlp_top=[D + len(TABLES) * D, 16, 1])
    model = build_dlrm(cfg, fft.FFConfig(batch_size=TOP,
                                         serve_buckets="1,8,16",
                                         storage_hot_rows=TOP)
                       ).compile(mesh=False)
    state = model.init(seed=3, device="cpu")
    old = os.environ.get("FF_TIERED_STORAGE")
    os.environ["FF_TIERED_STORAGE"] = "on"
    try:
        tiered = InferenceEngine(model, state, storage="tiered", device="cpu")
    finally:
        if old is None:
            del os.environ["FF_TIERED_STORAGE"]
        else:
            os.environ["FF_TIERED_STORAGE"] = old
    return InferenceEngine(model, state, device="cpu"), tiered


def test_router_over_one_tiered_engine_equals_resident_under_concurrency():
    """4 replicas over ONE tiered engine, 8 client threads, 200 requests of
    1-16 rows: every dispatch evicts most of the tier in place, so a
    replay that ran after another dispatch's install would read other
    rows.  Every result equals the resident engine's bit for bit."""
    resident, tiered = _tiered_pair()
    assert tiered.storage["mode"] == "tiered"
    rng = np.random.default_rng(31)
    pool = []
    for _ in range(200):
        n = int(rng.integers(1, TOP + 1))
        pool.append({"dense": rng.standard_normal((n, 13)).astype(np.float32),
                     "sparse": np.stack([zipf_ids(rng, r, (n, 1), a=1.2)
                                         for r in TABLES], axis=1)})
    want = [resident.predict(r) for r in pool]
    got, errors = {}, []
    router = ReplicaRouter([tiered] * 4, max_wait_us=200.0)

    def client(c):
        try:
            for i in range(c, len(pool), 8):
                got[i] = router.submit(pool[i]).result(timeout=120)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    summary = router.close()
    assert not errors and not any(t.is_alive() for t in threads)
    assert summary["requests"] == len(pool) and summary["router_shed"] == 0
    bad = [i for i in range(len(pool))
           if not np.array_equal(got[i], want[i])]
    assert not bad, f"{len(bad)} results differ from the resident engine"
    stats = tiered.storage_stats()
    assert stats["evictions"] > 0 and stats["misses"] > 0
    dispatches = sum(tiered.stats.dispatch_buckets.values())
    assert dispatches >= 2 * 4  # the replicas did interleave


def test_tiered_dispatch_holds_the_engine_lock_across_remap_and_replay(
        monkeypatch):
    """The store's remap, the replay and the output copy happen under one
    hold of the engine's lock (the runner's entry that takes it is never
    used by a tiered dispatch)."""
    resident, tiered = _tiered_pair()
    req = {"dense": np.zeros((3, 13), np.float32),
           "sparse": np.arange(9, dtype=np.int64).reshape(3, 3, 1)}
    want = resident.predict(req)
    runner_cls = type(next(iter(tiered._graphs.values())))
    seen = []
    real_run_locked = runner_cls.run_locked
    store = tiered._tiered["sparse"][1]
    real_remap = store._remap_deferred

    def remap(ids):
        seen.append(("remap", tiered._lock.locked()))
        return real_remap(ids)

    def run_locked(self, inputs, state=()):
        seen.append(("replay", tiered._lock.locked()))
        return real_run_locked(self, inputs, state)

    def run(self, inputs, state=()):
        raise AssertionError("a tiered dispatch took the runner's lock")

    monkeypatch.setattr(store, "_remap_deferred", remap)
    monkeypatch.setattr(runner_cls, "run_locked", run_locked)
    monkeypatch.setattr(runner_cls, "run", run)
    np.testing.assert_array_equal(tiered.predict(req), want)
    assert seen == [("remap", True), ("replay", True)]
    assert not tiered._lock.locked()
