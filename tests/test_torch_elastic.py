"""The port's scale-out, part 2 (``checkpoint.py``'s pod format and
reshard restore, ``resilience/manager.py``'s pod commit and deadlined
barrier, ``elastic/``, mesh-native serving) against the JAX package on
the 8-device virtual CPU platform.

The port's ranks are gloo processes (``distributed.launch``, rank bodies
in ``tests/torch_elastic_ranks.py``, which import no JAX); three groups
(8, 4 and 2 ranks) run every scenario and write their results, while the
JAX references run here at ``scripts/check_pod.py::two_proc_model``'s
shapes (4 tables of 64 x 8, bag 2, bottom 4-16-8, top 40-16-1, batch 32,
SGD lr 0.05), from the same weights.  A JAX podshard is written once by
two ``jax.distributed`` CPU processes.  Tolerances: checkpoints bit for
bit (a checkpoint moves data); resumed losses rtol 1e-5 against JAX's
resume from the same checkpoint, rtol 1e-3 / atol 1e-5 against the
never-killed run (JAX's elastic tolerance); a sharded engine within 1e-6
of JAX's, a replica bit for bit the one-process engine.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import checkpoint as jckpt
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jbuild_dlrm
from dlrm_flexflow_tpu.elastic import regate_strategy as jregate
from dlrm_flexflow_tpu.parallel import mesh as jmesh
from dlrm_flexflow_tpu.serving import InferenceEngine as JEngine
from dlrm_flexflow_tpu.sim import tune as jtune
from dlrm_flexflow_tpu.telemetry import metrics as jmetrics

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import distributed as fdist
from dlrm_flexflow_tpu_torch import elastic
from dlrm_flexflow_tpu_torch.bridge import params_from_jax
from dlrm_flexflow_tpu_torch.checkpoint import restore_checkpoint
from dlrm_flexflow_tpu_torch.elastic import (ElasticController,
                                             regate_strategy, reshard_restore)
from dlrm_flexflow_tpu_torch.resilience import (CheckpointManager, Reshape,
                                                faultinject,
                                                verify_checkpoint)
from dlrm_flexflow_tpu_torch.serving import InferenceEngine, ReplicaRouter
from dlrm_flexflow_tpu_torch.sim import tune as ptune
from dlrm_flexflow_tpu_torch.telemetry import event_log
from dlrm_flexflow_tpu_torch.telemetry import metrics as tmetrics
from dlrm_flexflow_tpu_torch.telemetry.schema import validate_event

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
import torch_elastic_ranks as ranks  # noqa: E402

B, STEPS = 32, 4
SIZES = [1, 3, 8, 11]       # the served requests' rows
DEADLINE_S, HANG_S = 1.5, 1.0

# the JAX podshard writer: two jax.distributed CPU processes, each
# training the same two steps on its local {"data": 2, "model": 2} mesh,
# then the state re-placed over all 8 devices (check_pod's
# to_global_state) so each process writes only its blocks
JAX_POD_WORKER = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu import distributed as dist
from dlrm_flexflow_tpu.resilience import CheckpointManager
from scripts.check_pod import to_global_state, two_proc_model
pid, port, ckpt = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                process_id=pid)
m = two_proc_model(mesh=ff.make_mesh({"data": 2, "model": 2},
                                     devices=jax.local_devices()))
st = m.init(seed=0)
rng = np.random.default_rng(5)
for _ in range(2):
    st, _ = m.train_step(st, {
        "dense": rng.standard_normal((32, 4)).astype(np.float32),
        "sparse": rng.integers(0, 64, size=(32, 4, 2)).astype(np.int32)},
        rng.integers(0, 2, size=(32, 1)).astype(np.float32))
assert CheckpointManager(ckpt, multihost=True).save(
    to_global_state(st), model=m) is not None
"""


# ----------------------------------------------------------- the JAX side
def jax_model(mesh, buckets="1,8"):
    cfg = JDLRMConfig(sparse_feature_size=8, embedding_size=[64] * 4,
                      embedding_bag_size=2, mlp_bot=[4, 16, 8],
                      mlp_top=[8 * 4 + 8, 16, 1])
    m = jbuild_dlrm(cfg, ffj.FFConfig(batch_size=B, serve_buckets=buckets),
                    table_parallel=True)
    m.compile(optimizer=ffj.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=(),
              mesh=jmesh.make_mesh(mesh) if mesh else False)
    return m


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def flat(tree, prefix):
    return {f"{prefix}{op}/{k}": v for op, d in tree.items()
            for k, v in d.items()}


def jax_batch(d, t):
    return ({"dense": d["dense"][t], "sparse": d["sparse"][t]},
            d["labels"][t])


def jax_steps(m, st, d, lo, hi):
    losses = []
    for t in range(lo, hi):
        st, mets = m.train_step(st, *jax_batch(d, t))
        losses.append(float(mets["loss"]))
    return st, losses


def bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def assert_state_bits(got: dict, want: dict, what: str):
    """Flat ``field/...`` arrays of two states, bit for bit."""
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]),
                                      err_msg=f"{what}: {k}")


def jax_flat_state(st) -> dict:
    return ranks.flat_state(type("S", (), {
        "params": np_tree(st.params), "opt_state": np_tree(st.opt_state),
        "rng": np.asarray(st.rng), "step": np.asarray(st.step)}))


def _launch_jax_pod(ckpt):
    """Start the two JAX podshard writers; returns their Popen objects."""
    import socket
    script = os.path.join(os.path.dirname(ckpt), "jax_pod_worker.py")
    with open(script, "w") as f:
        f.write(JAX_POD_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return [subprocess.Popen([sys.executable, script, str(i), str(port),
                              ckpt], env=env, cwd=REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i in range(2)]


def _wait(procs, what):
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"{what} {i} failed:\n{out[-3000:]}"


class _Group(threading.Thread):
    """One rank group launched in the background: its error, if any, is
    raised by ``join_ok``."""

    def __init__(self, target, world, **kwargs):
        super().__init__(daemon=True)
        self.args = (target, world, kwargs)
        self.err = None

    def run(self):
        target, world, kwargs = self.args
        try:
            fdist.launch(f"torch_elastic_ranks:{target}", world,
                         kwargs=kwargs, device="cpu", timeout_s=240,
                         pythonpath=[TESTS])
        except BaseException as e:  # noqa: BLE001 — re-raised by join_ok
            self.err = e

    def join_ok(self):
        self.join()
        if self.err is not None:
            raise self.err


def _data():
    rng = np.random.default_rng(0)
    return {
        "dense": rng.standard_normal((STEPS, B, 4)).astype(np.float32),
        "sparse": rng.integers(0, 64, size=(STEPS, B, 4, 2)
                               ).astype(np.int32),
        "labels": rng.integers(0, 2, size=(STEPS, B, 1)).astype(np.float32),
        "fit_dense": rng.standard_normal((4 * B, 4)).astype(np.float32),
        "fit_sparse": rng.integers(0, 64, size=(4 * B, 4, 2)
                                   ).astype(np.int32),
        "fit_labels": rng.integers(0, 2, size=(4 * B, 1)
                                   ).astype(np.float32)}


def _requests(tmp):
    rng = np.random.default_rng(3)
    n = sum(SIZES)
    path = str(tmp / "requests.npz")
    np.savez(path, sizes=np.array(SIZES),
             dense=rng.standard_normal((n, 4)).astype(np.float32),
             sparse=rng.integers(0, 64, size=(n, 4, 2)).astype(np.int32))
    return path


def _reshape_kill(tmp, d):
    """(f)'s first half in this process: the one-process table-parallel
    DLRM through fit's resilient loop, killed by preempt+reshape at step
    3; and its never-killed twin.  Returns the twin's trace."""
    def loader():
        return fft.ArrayDataLoader(
            {"dense": d["fit_dense"], "sparse": d["fit_sparse"]},
            d["fit_labels"], B)

    rdir = tmp / "reshape"
    m = ranks.two_proc_model(False)
    faultinject.install("preempt+reshape@step=3:mesh=1x2")
    try:
        with pytest.raises(Reshape) as e:
            m.fit(m.init(seed=0, device="cpu"), loader(), epochs=2,
                  verbose=False, checkpoint_every_n_steps=2,
                  checkpoint_manager=CheckpointManager(str(rdir / "ckpt")))
    finally:
        faultinject.clear()
    (rdir / "target.json").write_text(json.dumps(e.value.mesh_shape))
    twin = ranks.two_proc_model(False)
    twin.fit(twin.init(seed=0, device="cpu"), loader(), epochs=2,
             verbose=False, checkpoint_every_n_steps=2,
             checkpoint_manager=CheckpointManager(str(tmp / "twin")))
    return dict(zip(twin._fit_loss_steps.tolist(),
                    twin._fit_loss_trace.tolist())), e.value.mesh_shape


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank group and JAX reference of this file, once."""
    tmp = tmp_path_factory.mktemp("elastic")
    d = _data()
    jpod = str(tmp / "jax_pod")
    pod_procs = _launch_jax_pod(jpod)
    j8 = jax_model({"data": 4, "model": 2})
    st0 = j8.init(seed=0)
    p0 = np_tree(st0.params)
    data = str(tmp / "data.npz")
    np.savez(data, **flat(p0, "p/"), **d)
    requests = _requests(tmp)
    # (c): the JAX state after one step, and its one-process mesh save
    st1, _ = jax_steps(j8, st0, d, 0, 1)
    state8 = str(tmp / "state8.npz")
    np.savez(state8, **flat(np_tree(st1.params), "p/"),
             **{f"opt/{k}": np.asarray(v) for k, v in st1.opt_state.items()},
             rng=np.asarray(st1.rng), step=np.asarray(st1.step))
    jckpt.save_checkpoint(str(tmp / "jax_c"), st1, use_orbax=False,
                          model=j8)
    g8 = _Group("run_group8", 8, data=data, state=state8,
                ckpt=str(tmp / "port_c"), out=str(tmp / "g8"),
                requests=requests)
    g4 = _Group("run_pod4", 4, data=data, ckpt=str(tmp / "pod4"),
                out=str(tmp / "pod4.json"),
                new_store=f"file://{tmp}/store2", deadline_s=DEADLINE_S,
                hang_s=HANG_S, flight=str(tmp / "flight"))
    g8.start()
    g4.start()
    twin, target = _reshape_kill(tmp, d)
    _wait(pod_procs, "JAX podshard writer")
    g2 = _Group("run_pair", 2, data=data,
                jax_pod=os.path.join(jpod, "ckpt-2"), requests=requests,
                reshape_dir=str(tmp / "reshape"), out=str(tmp / "g2"))
    g2.start()
    # the JAX references, while the groups run
    reqs = ranks._requests(requests)
    ref = {"twin": twin, "target": target}
    ref["engines"] = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX engines stay out of the JAX package's process-wide
        # metrics registry, which its own tests read exactly
        mp.setattr(jmetrics, "track_engine", lambda engine: None)
        for tag, shape, state in (("g8", {"data": 4, "model": 2}, st1),
                                  ("model2", {"model": 2}, st0),
                                  ("data2", {"data": 2}, st0)):
            jm = j8 if tag == "g8" else jax_model(shape)
            st = state if tag == "g8" else jm.init(seed=0)
            eng = JEngine(jm, st)
            ref["engines"][tag] = {
                "buckets": list(eng.buckets), "sharded": eng._mesh_sharded,
                "outputs": [np.asarray(eng.predict(r)) for r in reqs]}
    # the one-process port engines the replica is held to
    pm = ranks.two_proc_model(False)
    ref["one_process"] = [
        InferenceEngine(pm, pm.load_params(params_from_jax(p0),
                                           device="cpu"),
                        device="cpu").predict(r) for r in reqs]
    j22 = jax_model({"data": 2, "model": 2})
    _, ref["never_killed"] = jax_steps(j22, j22.init(seed=0), d, 0, STEPS)
    g4.join_ok()
    # (a) JAX restores the port's podshard; (e) JAX resumes from it
    pod = json.load(open(tmp / "pod4.json"))
    ref["a"] = jax_flat_state(jckpt.restore_checkpoint(
        pod["path"], model=jax_model(None), on_mesh_change="reshard"))
    j12 = jax_model({"data": 1, "model": 2})
    rst = jckpt.restore_checkpoint(pod["path"], model=j12,
                                   on_mesh_change="reshard")
    _, ref["jax_resumed"] = jax_steps(j12, rst, d, 2, STEPS)
    g8.join_ok()
    g2.join_ok()
    ref["b"] = jax_flat_state(jckpt.restore_checkpoint(
        os.path.join(jpod, "ckpt-2"), model=jax_model(None),
        on_mesh_change="reshard"))
    return {"tmp": tmp, "ref": ref, "pod": pod, "jpod": jpod, "data": d}


def _rank_json(prefix, r):
    return json.load(open(f"{prefix}.rank{r}.json"))


# ---------------------------------------------------------------- (a)
def test_a_port_podshard_is_read_by_jax_bit_for_bit(runs):
    tmp, pod = runs["tmp"], runs["pod"]
    path = pod["path"]
    assert os.path.basename(path) == "ckpt-2" and verify_checkpoint(path) == []
    names = sorted(os.listdir(path))
    assert names == ["extra.json", "manifest.json", "meta.json"] + [
        f"shard-p{i:03d}.{x}" for i in range(4) for x in ("json", "npz")]
    assert json.load(open(os.path.join(path, "meta.json"))) == {
        "step": 2, "format": "podshard", "process_count": 4,
        "mesh": {"data": 2, "model": 2}}
    logical = dict(np.load(tmp / "logical.npz"))
    assert_state_bits(runs["ref"]["a"], logical, "JAX restore of the port pod")
    # every element written exactly once: the rectangles tile each array,
    # and only rank 0 writes the leaves no mesh shards
    cover, plain = {}, []
    for i in range(4):
        idx = json.load(open(os.path.join(path, f"shard-p{i:03d}.json")))
        assert idx["process_index"] == i and idx["process_count"] == 4
        with np.load(os.path.join(path, f"shard-p{i:03d}.npz")) as z:
            plain += [(i, k) for k in z.files if "@@" not in k]
        for key, meta in idx["arrays"].items():
            cover.setdefault(key, np.zeros(meta["shape"], np.int64))
        for part in idx["parts"]:
            cover[part["key"]][tuple(slice(a, b) for a, b in zip(
                part["lo"], part["hi"]))] += 1
    assert cover and all((c == 1).all() for c in cover.values())
    assert "params/emb/embedding" in cover
    assert {i for i, _ in plain} == {0}
    assert {k for _, k in plain} >= {"rng", "step", "opt_state/lr"}


def test_a_pod_save_stages_and_single_process_restore(runs):
    """The commit's stages are spans under its ckpt.save span; the port
    restores its own pod onto one process bit for bit (the logical
    state)."""
    pod = runs["pod"]
    assert set(pod["stages"]) >= {"d2h", "write", "fsync", "barrier_tmp",
                                  "barrier_written", "barrier_commit",
                                  "sha256"}
    assert pod["stages_parented"]
    m = ranks.two_proc_model(False)
    st = restore_checkpoint(pod["path"], m, on_mesh_change="reshard",
                            device="cpu")
    got = ranks.flat_state(type("S", (), {
        "params": {o: {k: v.numpy() for k, v in dd.items()}
                   for o, dd in st.params.items()},
        "opt_state": {k: v.numpy() for k, v in st.opt_state.items()},
        "rng": st.rng.numpy(), "step": st.step.numpy()}))
    assert_state_bits(got, dict(np.load(runs["tmp"] / "logical.npz")),
                      "port restore of its pod")


# ---------------------------------------------------------------- (b)
def test_b_jax_podshard_is_read_by_the_port_bit_for_bit(runs):
    want = runs["ref"]["b"]
    for r in range(2):  # onto {"data": 2}, each rank's whole arrays
        got = dict(np.load(f"{runs['tmp']}/g2.b.rank{r}.npz"))
        assert_state_bits(got, want, f"rank {r} on data=2")
    # onto no mesh, through reshard_restore: the event and the counter
    tmetrics.reset()
    m = ranks.two_proc_model(False)
    with event_log() as log:
        st, _extra, path = reshard_restore(runs["jpod"], m, device="cpu")
    ev = log.last("elastic")
    assert ev["phase"] == "reshard" and ev["from_mesh"] == "data=2,model=2"
    assert ev["to_mesh"] == "single" and not validate_event(ev)
    assert tmetrics.ELASTIC_RESHARDS.value == 1
    got = ranks.flat_state(type("S", (), {
        "params": {o: {k: v.numpy() for k, v in dd.items()}
                   for o, dd in st.params.items()},
        "opt_state": {k: v.numpy() for k, v in st.opt_state.items()},
        "rng": st.rng.numpy(), "step": st.step.numpy()}))
    assert_state_bits(got, want, "no mesh")
    with pytest.raises(fft.checkpoint.CheckpointError,
                       match="reshard_restore"):
        restore_checkpoint(path, m, device="cpu")


def test_b_partial_podshard_names_the_array(runs, tmp_path):
    import shutil
    d = tmp_path / "partial"
    shutil.copytree(os.path.join(runs["jpod"], "ckpt-2"), d)
    os.remove(d / "shard-p001.npz")
    os.remove(d / "shard-p001.json")
    with pytest.raises(fft.checkpoint.CheckpointError,
                       match=r"array 'params/.*' is only partially covered"):
        restore_checkpoint(str(d))


# ---------------------------------------------------------------- (c)
def test_c_gathered_save_under_ranks_equals_jax_one_process(runs):
    tmp = runs["tmp"]
    port, jax_dir = tmp / "port_c", tmp / "jax_c"
    assert _rank_json(tmp / "g8", 0)["wrote"] == ["meta.json", "state.npz"]
    assert (port / "meta.json").read_text() == (jax_dir / "meta.json"
                                                ).read_text()
    with np.load(port / "state.npz") as a, np.load(jax_dir / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(bits(a[k]), bits(b[k]), err_msg=k)


# ---------------------------------------------------------------- (d)
def test_d_deadlined_barrier_names_the_missing_ranks(runs):
    pod = runs["pod"]
    assert pod["raised"] == "FleetBarrierTimeout"
    assert pod["missing"] == ["p2", "p3"]
    assert DEADLINE_S <= pod["timeout_wall_s"] < DEADLINE_S + 10
    evs = pod["events"]
    rec = [e for e in evs if e["type"] == "recovery"]
    assert len(rec) == 1 and rec[0]["phase"] == "barrier_timeout"
    assert rec[0]["missing"] == ["p2", "p3"] and not validate_event(rec[0])
    # one attempt: no retry, no commit, and the flight record is there
    assert not [e for e in evs if e["type"] == "checkpoint"]
    assert len(pod["flight"]) == 1
    assert pod["flight"][0].startswith("flightrecorder_")


# ---------------------------------------------------------------- (e)
def test_e_host_loss_survivors_resume_and_train_on(runs):
    pod, ref = runs["pod"], runs["ref"]
    np.testing.assert_allclose(pod["first"], ref["never_killed"][:2],
                               rtol=1e-5)
    assert pod["world"] == 2 and pod["resumed_step"] == 2
    assert pod["resumed_path"] == pod["path"] and pod["kernels_off"]
    assert pod["extra"] == {"batches_done": 2}
    np.testing.assert_allclose(pod["resumed"], ref["jax_resumed"],
                               rtol=1e-5)
    np.testing.assert_allclose(pod["resumed"], ref["never_killed"][2:],
                               rtol=1e-3, atol=1e-5)
    evs = pod["resume_events"]
    resume = [e for e in evs if e["type"] == "recovery"]
    assert resume[-1]["phase"] == "resume"
    assert resume[-1]["process_count"] == 2
    reshard = [e for e in evs if e["type"] == "elastic"]
    assert reshard and reshard[0]["from_mesh"] == "data=2,model=2"
    assert reshard[0]["to_mesh"] == "model=2"


# ---------------------------------------------------------------- (f)
def test_f_resilient_fit_resumes_onto_the_reshape_target(runs):
    res = _rank_json(runs["tmp"] / "g2", 0)
    assert runs["ref"]["target"] == {"data": 1, "model": 2}
    assert res["f_steps"][0] == 3 and res["f_kernels_off"]
    ev = res["f_events"]
    assert ev and ev[0]["phase"] == "reshard"
    assert ev[0]["from_mesh"] == "single" and ev[0]["to_mesh"] == "model=2"
    twin = runs["ref"]["twin"]
    for s, loss in zip(res["f_steps"], res["f_trace"]):
        np.testing.assert_allclose(loss, twin[s], rtol=1e-5, err_msg=str(s))
    other = _rank_json(runs["tmp"] / "g2", 1)
    assert other["f_trace"] == res["f_trace"]


# ---------------------------------------------------------------- (g)
@pytest.mark.parametrize("tag,world,prefix", [
    ("g8", 8, "g8"), ("model2", 2, "g2"), ("data2", 2, "g2")])
def test_g_mesh_native_serving_against_jax(runs, tag, world, prefix):
    want = runs["ref"]["engines"][tag]
    key = "" if tag == "g8" else f"{tag}_"
    lead = _rank_json(runs["tmp"] / prefix, 0)
    assert lead[f"{key}buckets"] == want["buckets"]
    assert lead[f"{key}sharded"] == bool(want["sharded"])
    outs = [np.asarray(o, np.float32) for o in lead[f"{key}outputs"]]
    for got, w, n in zip(outs, want["outputs"], SIZES):
        assert got.shape == (n, 1)
        if want["sharded"]:
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6)
    if not want["sharded"]:  # a replica: bit for bit one process
        for got, w in zip(outs, runs["ref"]["one_process"]):
            np.testing.assert_array_equal(bits(got), bits(w))
    # every follower served every bucket the leader dispatched, warmup too
    n_dispatch = len(lead[f"{key}buckets"]) + sum(
        -(-n // max(want["buckets"])) for n in SIZES)
    for r in range(1, world):
        assert _rank_json(runs["tmp"] / prefix, r)[
            f"{key}followed"] == n_dispatch
    if tag == "g8":
        assert lead["kernels_off"]


def test_g_engine_refusals_and_the_leader_protocol_off_mesh():
    """Off a mesh of more than one rank the engine is its own leader and
    close() is a no-op; follow() refuses there."""
    m = ranks.two_proc_model(False)
    eng = InferenceEngine(m, m.init(seed=0, device="cpu"), device="cpu")
    assert eng.is_leader and eng.partition_rules is None
    assert not eng._mesh_sharded
    eng.close()
    with pytest.raises(ValueError, match="follow"):
        eng.follow()


# ---------------------------------------------------------------- (h)
def _artifacts(tune, art):
    """The same strategy documents in either package's artifacts dir."""
    strat = (ffj if tune is jtune else fft).Strategy()
    docs = {}
    for n in (1, 4):
        _p, docs[n] = tune.save_strategy_artifact(
            art, strat, app="dlrm", num_devices=n, sim_step_s=0.001,
            seed=0, budget=1)
    tune.promote(art, docs[1])
    return docs


def test_h_regate_verdicts_and_versions_match_jax(tmp_path):
    out = {}
    for name, tune, regate in (("jax", jtune, jregate),
                               ("port", ptune, regate_strategy)):
        art = str(tmp_path / name)
        docs = _artifacts(tune, art)
        seq = []
        for n, cand, fn in ((1, None, None), (4, None, None),
                            (4, docs[4], lambda d: d["sim_step_s"]),
                            # the candidate is priced first: 2x slower
                            (4, docs[4], lambda d, c=iter([2.0, 1.0]):
                             next(c)),
                            (2, None, None)):
            w, v = regate(art, "dlrm", n, candidate=cand, bench_fn=fn)
            seq.append((v, None if w is None else int(w["version"])))
        out[name] = seq
        with pytest.raises(ValueError, match="topology"):
            regate(art, "dlrm", 2, candidate=docs[4],
                   bench_fn=lambda d: 1.0)
    assert out["port"] == out["jax"]
    assert [v for v, _ in out["port"]] == ["incumbent", "none", "first",
                                           "rejected", "none"]


def test_h_controller_scales_without_dropping_requests(tmp_path):
    tmetrics.reset()
    m = ranks.two_proc_model(False)
    eng = InferenceEngine(m, m.init(seed=0, device="cpu"), device="cpu")
    art = str(tmp_path / "art")
    docs = _artifacts(ptune, art)
    reqs = ranks._requests(_requests(tmp_path))
    with event_log() as log:
        router = ReplicaRouter([eng, eng], max_batch_size=16,
                              queue_depth=64)
        ctl = ElasticController(router, artifacts_dir=art, app="dlrm")
        futures = [router.submit(reqs[i % 4]) for i in range(12)]
        r4 = ctl.scale_to(4, candidate=docs[4],
                          bench_fn=lambda d: d["sim_step_s"])
        futures += [router.submit(reqs[i % 4]) for i in range(12)]
        assert "dlrm_serve_replicas 4" in tmetrics.REGISTRY.render()
        r1 = ctl.scale_to(1)
        futures += [router.submit(reqs[i % 4]) for i in range(12)]
        results = [f.result(30.0) for f in futures]
        heal = ctl.heal(target_replicas=1)
        summary = ctl.close()
    assert (r4["replicas_from"], r4["replicas_to"]) == (2, 4)
    assert (r1["replicas_from"], r1["replicas_to"]) == (4, 1)
    assert r4["strategy"]["version"] == docs[4]["version"]
    assert ctl.verdicts == ["none", "first", "incumbent"]
    assert heal == {"ejected": [], "rebuilt": None}
    assert summary["requests"] == len(futures) == 36
    assert [r.shape[0] for r in results] == [
        reqs[i % 4]["dense"].shape[0] for i in range(12)] * 3
    evs = [e for e in log.events() if e["type"] == "elastic"]
    assert [e["phase"] for e in evs] == ["regate", "scale", "regate",
                                         "scale", "regate"]
    assert all(not validate_event(e) for e in evs)
    assert "dlrm_elastic_reshard_total 0" in tmetrics.REGISTRY.render()


def test_h_elastic_exports_the_jax_names():
    from dlrm_flexflow_tpu import elastic as jelastic
    assert sorted(elastic.__all__) == sorted(jelastic.__all__)
    for name in jelastic.__all__:
        assert callable(getattr(elastic, name))


def test_shutdown_without_a_group_is_a_noop():
    assert fdist.shutdown(timeout_s=0.1) is True


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of this process alone, left (and its teardown
    restored) afterwards."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    destroy = dist.destroy_process_group
    try:
        yield dist
    finally:
        dist.destroy_process_group = destroy
        if dist.is_initialized():
            destroy()


def test_recover_raises_when_the_old_group_cannot_be_left(
        one_rank_group, monkeypatch, tmp_path):
    """A teardown still blocked past SHUTDOWN_TIMEOUT_S ends the recovery
    with an error naming the deadline, before any group or model is
    built on a world that still counts the old ranks."""
    release = threading.Event()
    monkeypatch.setattr(one_rank_group, "destroy_process_group",
                        lambda *a, **k: release.wait(5.0))
    monkeypatch.setattr(fdist, "SHUTDOWN_TIMEOUT_S", 0.2)
    built = []
    try:
        with pytest.raises(RuntimeError, match="SHUTDOWN_TIMEOUT_S"):
            elastic.recover_and_resume(
                str(tmp_path / "ckpt"), lambda: built.append(1),
                num_processes=2, coordinator_address="127.0.0.1:1",
                process_id=0, device="cpu")
    finally:
        release.set()
    assert built == [] and one_rank_group.is_initialized()


def test_initialize_refuses_a_group_of_another_size(one_rank_group):
    """initialize keeps a group of the asked size and raises for any
    other: a survivor cannot slip into its old group unnoticed."""
    assert fdist.initialize(num_processes=1, process_id=0,
                            device="cpu")["process_count"] == 1
    with pytest.raises(RuntimeError, match="1 ranks is still up, and 2"):
        fdist.initialize(coordinator_address="127.0.0.1:1",
                         num_processes=2, process_id=0, device="cpu")
