"""The port's durability slice (dlrm_flexflow_tpu_torch/resilience,
data/prefetch.py, the resilient ``fit``) against the JAX package on the
CPU, at the JAX tests' small sizes: the counterparts of
tests/test_resilience.py, tests/test_pipeline.py, tests/test_recovery.py
(the single-process parts) and the fault-spec cases of
tests/test_elastic.py, and the cases that cross between the packages.
JAX is imported here only.

Tolerances, each with its reason:
  * the port against itself (killed and resumed against uninterrupted,
    prefetch on and off, lag 1 against eager, graphed against eager):
    bit for bit — the same arithmetic on the same tensors;
  * the port resumed from a JAX checkpoint against the JAX run: losses
    rtol 1e-5 at f32 (the port's Linear accumulates in f64 and rounds
    once, ROADMAP.md Queue C, so the last bits of a sum differ);
  * checkpoint files written by both packages for the same state: bytes.

The paths the port does not have raise, each with its own test: the
multi-host commit and its barrier, and (tests/test_torch_checkpoint.py)
orbax, podshard and cross-topology restores.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.data.loader import ArrayDataLoader as JaxLoader
from dlrm_flexflow_tpu.resilience import CheckpointManager as JaxManager
from dlrm_flexflow_tpu.resilience import NaNSentinel as JaxSentinel
from dlrm_flexflow_tpu.resilience import Preemption as JaxPreemption
from dlrm_flexflow_tpu.resilience import faultinject as jfault
from dlrm_flexflow_tpu.resilience import verify_checkpoint as jax_verify

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import state_from_jax
from dlrm_flexflow_tpu_torch.data import PrefetchLoader
from dlrm_flexflow_tpu_torch.data.loader import (ArrayDataLoader,
                                                 SyntheticDLRMLoader)
from dlrm_flexflow_tpu_torch.resilience import (CheckpointManager,
                                                FleetBarrierTimeout,
                                                NaNSentinel, Preemption,
                                                Reshape, TrainingDiverged,
                                                latest_checkpoint,
                                                verify_checkpoint)
from dlrm_flexflow_tpu_torch.resilience import faultinject
from dlrm_flexflow_tpu_torch.resilience.loop import resilient_fit
from dlrm_flexflow_tpu_torch.resilience.watchdog import (HostWatchdog,
                                                         StallWatchdog, beat,
                                                         heartbeat_ages)
from dlrm_flexflow_tpu_torch.telemetry import event_log
from dlrm_flexflow_tpu_torch.telemetry import metrics as tmetrics
from dlrm_flexflow_tpu_torch.telemetry.fleet import (dump_flight_record,
                                                     predicted_sync_ms)
from dlrm_flexflow_tpu_torch.telemetry.trace import start_span

N, BATCH = 64, 8  # 8 batches an epoch


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.clear()
    jfault.clear()
    yield
    faultinject.clear()
    jfault.clear()


def make_model(lr=0.05, prefetch_depth=0, **config):
    m = fft.FFModel(fft.FFConfig(batch_size=BATCH,
                                 prefetch_depth=prefetch_depth, **config))
    x = m.create_tensor((BATCH, 4), name="x")
    m.dense(x, 8, activation="relu")
    m.dense(m.layers[-1].outputs[0], 1)
    m.compile(optimizer=fft.SGDOptimizer(lr=lr),
              loss_type="mean_squared_error", metrics=())
    return m


def make_jax_model(lr=0.05):
    m = ffj.FFModel(ffj.FFConfig(batch_size=BATCH))
    x = m.create_tensor((BATCH, 4), name="x")
    m.dense(x, 8, activation="relu")
    m.dense(m.layers[-1].outputs[0], 1)
    m.compile(optimizer=ffj.SGDOptimizer(lr=lr),
              loss_type="mean_squared_error", metrics=(), mesh=False)
    return m


def _data(n=N):
    rng = np.random.default_rng(0)
    return ({"x": rng.standard_normal((n, 4)).astype(np.float32)},
            rng.standard_normal((n, 1)).astype(np.float32))


def make_loader(shuffle=True, seed=1, n=N):
    x, y = _data(n)
    return ArrayDataLoader(x, y, BATCH, shuffle=shuffle, seed=seed)


def make_jax_loader(shuffle=True, seed=1, n=N):
    x, y = _data(n)
    return JaxLoader(x, y, BATCH, shuffle=shuffle, seed=seed)


def init(m, seed=0):
    return m.init(seed=seed, device="cpu")


def jax_weights(jm):
    """A JAX model's init, and the port model state holding its weights
    (its dicts in the JAX state's order)."""
    js = jm.init(seed=0)
    return js, state_from_jax(js)


def assert_params_equal(a, b):
    for op, d in a.params.items():
        for k, v in d.items():
            assert torch.equal(v, b.params[op][k]), (op, k)


def batches_equal(a, b):
    assert len(a) == len(b)
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
        assert ia.keys() == ib.keys()
        for k in ia:
            np.testing.assert_array_equal(np.asarray(ia[k]),
                                          np.asarray(ib[k]))


class _Hooks:
    """The keras callback hooks, doing nothing: any callback makes the
    resilient loop settle every step at once (its eager mode)."""

    model = None

    def set_model(self, model):
        self.model = model

    def on_train_begin(self):
        pass

    def on_epoch_begin(self, epoch):
        pass

    def on_batch_begin(self, it):
        pass

    def on_batch_end(self, it):
        pass

    def on_epoch_end(self, epoch):
        return None

    def on_train_end(self):
        pass


# ------------------------------------------------------------- manager core
class TestCheckpointManager:
    def test_atomic_save_commits_with_manifest(self, tmp_path):
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        path = mgr.save(st, model=m, step=7)
        assert path is not None and path.endswith("ckpt-7")
        assert verify_checkpoint(path) == []
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["step"] == 7
        assert sorted(manifest["files"]) == ["meta.json", "state.npz"]
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith("tmp-")]

    def test_latest_skips_corrupt_entries(self, tmp_path):
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), keep_n=5)
        p1 = mgr.save(st, step=1)
        p2 = mgr.save(st, step=2)
        assert latest_checkpoint(str(tmp_path)) == p2
        with open(os.path.join(p2, "manifest.json")) as f:
            rel = sorted(json.load(f)["files"])[0]
        fp = os.path.join(p2, rel)
        blob = bytearray(open(fp, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(fp, "wb").write(bytes(blob))
        assert verify_checkpoint(p2) != []
        assert jax_verify(p2) != []  # the JAX package's verdict too
        assert latest_checkpoint(str(tmp_path)) == p1

    def test_retention_keeps_newest_n(self, tmp_path):
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        for s in (1, 2, 3, 4):
            mgr.save(st, step=s)
        names = sorted(n for n in os.listdir(tmp_path)
                       if n.startswith("ckpt-"))
        assert names == ["ckpt-3", "ckpt-4"]

    def test_save_failure_never_raises(self, tmp_path):
        faultinject.install("io_error@save=10")
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), keep_n=2, retries=1,
                                backoff_s=0.001)
        with event_log() as log:
            assert mgr.save(st, step=1) is None  # exhausted, no raise
        actions = [e["action"] for e in log.events("checkpoint")]
        assert actions == ["retry", "save_failed"]

    def test_transient_io_error_retried(self, tmp_path):
        faultinject.install("io_error@save=1")
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), keep_n=2, retries=2,
                                backoff_s=0.001)
        tmetrics.reset()
        with event_log() as log:
            path = mgr.save(st, step=1)
        assert path is not None and verify_checkpoint(path) == []
        assert [e["action"] for e in log.events("checkpoint")] == \
            ["retry", "save"]
        assert tmetrics.CHECKPOINT_SAVES.value == 1
        assert "dlrm_checkpoint_age_s" in tmetrics.REGISTRY.render()
        tmetrics.reset()

    def test_resave_same_step_never_unpublishes(self, tmp_path):
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        p1 = mgr.save(st, step=3)
        p = mgr.save(st, step=3)
        assert p == p1 and verify_checkpoint(p) == []
        assert sorted(n for n in os.listdir(tmp_path)
                      if not n.startswith("ckpt-")) == []
        os.remove(os.path.join(p, "manifest.json"))
        p2 = mgr.save(st, step=3)
        assert p2 == p1 and verify_checkpoint(p2) == []

    def test_multihost_commit_and_barrier_raise_naming_item_8(self,
                                                               tmp_path):
        """The pod commit and its deadlined barrier (ROADMAP.md item 8,
        part 2): one rank's pod save commits a verified checkpoint with
        no fence left behind, and a barrier whose peer never arrives
        raises FleetBarrierTimeout naming it; orbax still raises."""
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), multihost=True)
        with event_log() as log:
            p = mgr.save(st, model=m, step=1)
        assert verify_checkpoint(p) == []
        assert sorted(os.listdir(p)) == ["manifest.json", "meta.json",
                                         "shard-p000.json", "shard-p000.npz"]
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith(".barrier-")]
        spans = [e for e in log.events() if e["type"] == "span"]
        save = [e for e in spans if e["name"] == "ckpt.save"]
        stages = [e for e in spans if e["name"] != "ckpt.save"]
        assert len(save) == 1 and all(
            e["parent_id"] == save[0]["span_id"] for e in stages)
        assert sorted(e["name"] + ":" + e["attrs"]["phase"]
                      if e.get("attrs") else e["name"]
                      for e in stages) == [
            "ckpt.barrier:commit", "ckpt.barrier:tmp",
            "ckpt.barrier:written", "ckpt.d2h", "ckpt.fsync",
            "ckpt.sha256", "ckpt.write"]
        with pytest.raises(FleetBarrierTimeout, match="p1"):
            mgr._barrier("3-1", pidx=0, nproc=2, timeout_s=0.05)
        with pytest.raises(NotImplementedError, match="npz"):
            CheckpointManager(str(tmp_path), use_orbax=True)

    def test_restore_latest_returns_state_extra_and_path(self, tmp_path):
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(fft.checkpoint.CheckpointError,
                           match="no valid checkpoint"):
            mgr.restore_latest(model=m)
        p = mgr.save(st, model=m, step=2, extra={"epoch": 1})
        with event_log() as log:
            got, extra, path = mgr.restore_latest(model=m)
        assert path == p and extra == {"epoch": 1}
        assert_params_equal(st, got)
        assert log.last("checkpoint")["action"] == "restore"


class TestManifestAcrossPackages:
    """Both managers write the same directory for the same state, byte
    for byte, so each package's verify_checkpoint accepts the other's."""

    def test_same_state_same_files_byte_for_byte(self, tmp_path):
        jm, m = make_jax_model(), make_model()
        js, ps = jax_weights(jm)
        extra = {"epoch": 1, "loader": make_loader().state_dict(),
                 "epochs_requested": 2}
        jp = JaxManager(str(tmp_path / "j"), use_orbax=False).save(
            js, model=jm, step=3, extra=extra)
        pp = CheckpointManager(str(tmp_path / "p")).save(
            ps, model=m, step=3, extra=extra)
        names = sorted(os.listdir(jp))
        assert names == sorted(os.listdir(pp)) == [
            "extra.json", "manifest.json", "meta.json", "state.npz"]
        for name in names:
            assert open(os.path.join(jp, name), "rb").read() == \
                open(os.path.join(pp, name), "rb").read(), name

    def test_each_verify_accepts_the_other_directory(self, tmp_path):
        jm, m = make_jax_model(), make_model()
        js = jm.init(seed=0)
        jp = JaxManager(str(tmp_path / "j"), use_orbax=False).save(
            js, model=jm, step=1)
        pp = CheckpointManager(str(tmp_path / "p")).save(
            init(m), model=m, step=1)
        assert verify_checkpoint(jp) == [] and jax_verify(jp) == []
        assert verify_checkpoint(pp) == [] and jax_verify(pp) == []
        # an extra file is flagged by both
        (tmp_path / "p" / "ckpt-1" / "stray").write_text("x")
        assert verify_checkpoint(pp) and jax_verify(pp)


class TestCrashConsistency:
    def test_killed_save_invisible_and_gced(self, tmp_path):
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        good = mgr.save(st, step=1)
        faultinject.install("preempt@save")
        with pytest.raises(Preemption):
            mgr.save(st, step=2)
        assert any(n.startswith("tmp-") for n in os.listdir(tmp_path))
        assert latest_checkpoint(str(tmp_path)) == good
        faultinject.clear()
        mgr.gc()
        assert not any(n.startswith("tmp-") for n in os.listdir(tmp_path))
        assert latest_checkpoint(str(tmp_path)) == good

    def test_next_save_sweeps_debris(self, tmp_path):
        m = make_model()
        st = init(m)
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        faultinject.install("preempt@save")
        with pytest.raises(Preemption):
            mgr.save(st, step=1)
        faultinject.clear()
        p = mgr.save(st, step=2)  # commit runs gc
        assert p is not None
        assert not any(n.startswith("tmp-") for n in os.listdir(tmp_path))


# ---------------------------------------------------------- loader resume
class TestLoaderState:
    def test_state_roundtrip_replays_exact_sequence(self):
        a = make_loader(shuffle=True, seed=9)
        list(iter(a))
        it = iter(a)
        for _ in range(2):
            next(it)
        sd = a.state_dict()
        b = make_loader(shuffle=True, seed=123)
        b.load_state_dict(json.loads(json.dumps(sd)))
        rest_a = list(it) + list(iter(a))
        rest_b = list(iter(b)) + list(iter(b))
        assert len(rest_a) == len(rest_b) == 6 + 8
        batches_equal(rest_a, rest_b)

    def test_state_dict_between_epochs(self):
        a = make_loader(shuffle=True, seed=4)
        list(iter(a))
        sd = a.state_dict()
        assert sd["batch"] == 0
        b = make_loader(shuffle=True, seed=77)
        b.load_state_dict(sd)
        batches_equal(list(iter(a)), list(iter(b)))

    def test_state_dict_equals_the_jax_loader(self):
        a, j = make_loader(seed=5), make_jax_loader(seed=5)
        ia, ij = iter(a), iter(j)
        for _ in range(3):
            next(ia), next(ij)
        assert a.state_dict() == j.state_dict()


# ------------------------------------------------------- fit integration
def _kill_resume_twin(tmp_path, make, loader, epochs=2):
    """(resumed model, resumed state, twin model, twin state, plain
    state) of the acceptance path: a run killed at step 10 with saves
    every 4 steps, resumed; an uninterrupted twin through the same loop;
    the plain per-batch fit."""
    m = make()
    st, _ = m.fit(init(m), loader(), epochs=epochs, verbose=False,
                  warmup=False)
    m2 = make()
    faultinject.install("preempt@step=10")
    with pytest.raises(Preemption):
        m2.fit(init(m2), loader(), epochs=epochs, verbose=False,
               checkpoint_manager=CheckpointManager(str(tmp_path / "ck"),
                                                    use_orbax=False),
               checkpoint_every_n_steps=4)
    faultinject.clear()
    m3 = make()
    st3, _ = m3.fit(init(m3), loader(), epochs=epochs, verbose=False,
                    checkpoint_manager=CheckpointManager(
                        str(tmp_path / "ck"), use_orbax=False),
                    checkpoint_every_n_steps=4, resume=True)
    m4 = make()
    st4, _ = m4.fit(init(m4), loader(), epochs=epochs, verbose=False,
                    checkpoint_manager=CheckpointManager(
                        str(tmp_path / "twin")),
                    checkpoint_every_n_steps=4)
    return m3, st3, m4, st4, st


class TestResumeDeterminism:
    def test_kill_resume_matches_uninterrupted(self, tmp_path):
        """The acceptance path: 10 steps, kill, resume; the combined trace
        and the final params match an uninterrupted 16-step run bit for
        bit.  Shuffling loader: the resumed run replays the exact batch
        sequence."""
        m3, st3, m4, st4, st = _kill_resume_twin(tmp_path, make_model,
                                                 make_loader)
        assert m3._fit_loss_steps[0] == 9  # ckpt-8 + 1
        ref = dict(zip(m4._fit_loss_steps.tolist(),
                       m4._fit_loss_trace.tolist()))
        for s_, l_ in zip(m3._fit_loss_steps.tolist(),
                          m3._fit_loss_trace.tolist()):
            assert ref[s_] == l_  # bitwise
        assert_params_equal(st4, st3)
        assert_params_equal(st, st4)
        assert int(st3.step) == int(st4.step) == 16
        assert torch.equal(st3.opt_state["step"], st4.opt_state["step"])

    def test_kill_resume_of_a_dlrm_through_the_row_update(self, tmp_path):
        """The same on a small DLRM (bag 1, cat, stacked tables): every
        step, adopted or resumed, takes the row-sparse update (the row
        update's plain version on the CPU)."""
        def make():
            m = build_dlrm(DLRMConfig(sparse_feature_size=8,
                                      embedding_size=[64, 40, 50],
                                      mlp_bot=[13, 16, 8],
                                      mlp_top=[32, 16, 1]),
                           fft.FFConfig(batch_size=8))
            m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
                      loss_type="mean_squared_error",
                      metrics=("accuracy", "mean_squared_error"))
            assert [op.name for op in m._sparse_ops] == ["emb"]
            return m

        def loader():
            base = SyntheticDLRMLoader(64, 13, [64, 40, 50], 1, 8, seed=3)
            return ArrayDataLoader(base.inputs, base.labels, 8,
                                   shuffle=True, seed=2)

        m3, st3, m4, st4, st = _kill_resume_twin(tmp_path, make, loader)
        assert m3._fit_loss_steps[0] == 9
        ref = dict(zip(m4._fit_loss_steps.tolist(),
                       m4._fit_loss_trace.tolist()))
        for s_, l_ in zip(m3._fit_loss_steps.tolist(),
                          m3._fit_loss_trace.tolist()):
            assert ref[s_] == l_
        assert_params_equal(st4, st3)
        assert_params_equal(st, st4)

    def test_resume_without_manager_raises(self):
        m = make_model()
        with pytest.raises(ValueError, match="resume"):
            m.fit(init(m), make_loader(), epochs=1, verbose=False,
                  resume=True)

    def test_cadence_without_manager_raises(self):
        m = make_model()
        with pytest.raises(ValueError, match="cadence"):
            m.fit(init(m), make_loader(), epochs=1, verbose=False,
                  checkpoint_every_n_steps=4)

    def test_epoch_cadence_and_dir_string(self, tmp_path):
        m = make_model()
        m.fit(init(m), make_loader(), epochs=2, verbose=False,
              checkpoint_manager=str(tmp_path / "eck"),
              checkpoint_every_n_epochs=1)
        names = sorted(n for n in os.listdir(tmp_path / "eck"))
        assert names == ["ckpt-16", "ckpt-8"]
        with open(tmp_path / "eck" / "ckpt-8" / "extra.json") as f:
            assert json.load(f)["epoch"] == 1

    def test_resilient_fit_bypasses_the_staged_epochs(self, tmp_path):
        """An unshuffled array loader takes fit's staged branch; any
        resilience option takes the per-batch loop instead, and both
        train the same steps."""
        m = make_model()
        st, _ = m.fit(init(m), make_loader(shuffle=False), epochs=1,
                      verbose=False, warmup=False)
        assert m._last_fit_used_scan is True
        m2 = make_model()
        st2, _ = m2.fit(init(m2), make_loader(shuffle=False), epochs=1,
                        verbose=False,
                        checkpoint_manager=str(tmp_path / "c"),
                        checkpoint_every_n_epochs=1)
        assert m2._last_fit_used_scan is False
        assert len(m2._fit_loss_trace) == 8
        assert_params_equal(st, st2)


class TestSentinel:
    def test_nan_batch_rolls_back_and_skips(self):
        faultinject.install("nan_grads@step=3")
        m = make_model()
        with event_log() as log:
            m.fit(init(m), make_loader(), epochs=2, verbose=False,
                  sentinel=NaNSentinel(policy="skip"))
        tr = m._fit_loss_trace
        assert np.isfinite(tr).all()
        assert len(tr) == 15
        an = log.last("anomaly")
        assert an["kind"] == "nan_loss"
        assert an["action"] == "rollback_skip"
        assert an["step"] == 3
        fa = log.last("fault")
        assert fa["kind"] == "nan_grads" and fa["point"] == "step"

    def test_lr_backoff_retries_same_batch(self):
        faultinject.install("nan_grads@step=2")
        m = make_model(lr=0.05)
        with event_log() as log:
            st, _ = m.fit(init(m), make_loader(), epochs=1, verbose=False,
                          sentinel=NaNSentinel(policy="lr_backoff",
                                               lr_factor=0.5))
        assert len(m._fit_loss_trace) == 8
        assert np.isfinite(m._fit_loss_trace).all()
        assert m.optimizer.lr == pytest.approx(0.025)
        assert float(st.opt_state["lr"]) == np.float32(0.025)
        assert log.last("anomaly")["action"] == "rollback_lr_backoff"

    def test_max_rollbacks_raises_diverged(self):
        faultinject.install("nan_grads@step=1,nan_grads@step=2,"
                            "nan_grads@step=3")
        m = make_model()
        with pytest.raises(TrainingDiverged):
            m.fit(init(m), make_loader(), epochs=2, verbose=False,
                  sentinel=NaNSentinel(policy="skip", max_rollbacks=2))

    def test_lag1_detects_at_next_step_and_discards_inflight(self):
        faultinject.install("nan_grads@step=3")
        m = make_model()
        with event_log() as log:
            m.fit(init(m), make_loader(), epochs=2, verbose=False,
                  sentinel=NaNSentinel(policy="skip"))
        assert np.isfinite(m._fit_loss_trace).all()
        assert len(m._fit_loss_trace) == 15
        an = log.last("anomaly")
        assert an["kind"] == "nan_loss" and an["step"] == 3
        spans = [e for e in log.events("span")
                 if e["name"] == "train.dispatch"]
        statuses = [e.get("status") for e in spans]
        assert statuses.count("rejected") == 1
        assert statuses.count("discarded") == 1
        rej = next(e for e in spans if e.get("status") == "rejected")
        dis = next(e for e in spans if e.get("status") == "discarded")
        assert dis["attrs"]["step"] == rej["attrs"]["step"] + 1
        assert dis["start_s"] < rej["start_s"] + rej["dur_us"] * 1e-6

    @pytest.mark.parametrize("policy,faults", [
        ("skip", "nan_grads@step=3"),
        ("lr_backoff", "nan_grads@step=3"),
        # the second fault fires inside the discarded speculative step
        # and must be un-consumed so it re-fires where the eager loop
        # sees it
        ("skip", "nan_grads@step=3,nan_grads@step=4"),
    ])
    def test_lag1_trajectory_matches_eager_sentinel(self, policy, faults):
        def run(cbs):
            faultinject.clear()
            faultinject.install(faults)
            m = make_model()
            st, _ = resilient_fit(
                m, init(m), make_loader(), epochs=2, verbose=False,
                callbacks=cbs, manager=None, every_n_steps=None,
                every_n_epochs=None, resume=False,
                sentinel=NaNSentinel(policy=policy, max_rollbacks=4))
            return (st, m._fit_loss_trace.copy(),
                    m._fit_loss_steps.copy())

        st_lag, tr_lag, steps_lag = run(None)
        st_eag, tr_eag, steps_eag = run([_Hooks()])
        np.testing.assert_array_equal(steps_lag, steps_eag)
        np.testing.assert_array_equal(tr_lag, tr_eag)
        assert_params_equal(st_eag, st_lag)

    def test_check_params_catches_inf_state(self):
        s = NaNSentinel(check_params=True)
        m = make_model()
        st = init(m)
        assert s.classify(1.0, st) is None
        bad = dict(st.params)
        name = next(iter(bad))
        bad[name] = {k: v * float("nan") for k, v in bad[name].items()}
        st_bad = fft.TrainState(bad, st.opt_state, st.bn_state, st.rng,
                                st.step)
        assert s.classify(1.0, st_bad) == "nonfinite_params"
        assert s.classify(float("inf")) == "inf_loss"

    def test_bad_policy_rejected(self):
        with pytest.raises(ValueError, match="policy"):
            NaNSentinel(policy="retry")

    def test_rollbacks_counted_in_metrics(self):
        tmetrics.reset()
        faultinject.install("nan_grads@step=1")
        m = make_model()
        m.fit(init(m), make_loader(), epochs=1, verbose=False,
              sentinel=NaNSentinel(policy="skip"))
        assert tmetrics.SENTINEL_ROLLBACKS.value == 1
        tmetrics.reset()


# ------------------------------------------------------------ faultinject
class TestFaultInject:
    def test_parse_rejects_garbage(self):
        with pytest.raises(ValueError):
            faultinject.parse("explode@step=1")
        with pytest.raises(ValueError):
            faultinject.parse("nan_grads@nowhere")
        with pytest.raises(ValueError):
            faultinject.parse("nan_grads@step")

    def test_env_activation(self, monkeypatch):
        faultinject.clear()
        monkeypatch.setenv("FF_FAULTS", "preempt@step=1")
        faultinject.install_from_env()
        assert faultinject.active()
        with pytest.raises(Preemption):
            faultinject.maybe_preempt("step", step=1)
        assert not faultinject.active()

    def test_poison_copies_not_originals(self):
        faultinject.install("nan_grads@step=5")
        orig = {"x": np.ones((4, 2), np.float32),
                "ids": np.ones((4, 2), np.int64)}
        lab = np.ones((4, 1), np.float32)
        out, plab = faultinject.poison_batch(orig, lab, step=5)
        assert np.isnan(plab).all()
        assert out is orig and np.isfinite(orig["x"]).all()
        assert np.isfinite(lab).all()
        out2, lab2 = faultinject.poison_batch(orig, lab, step=5)
        assert out2 is orig and lab2 is lab

    def test_poison_falls_back_to_inputs_for_int_labels(self):
        faultinject.install("nan_grads@step=5")
        orig = {"x": np.ones((4, 2), np.float32),
                "ids": np.ones((4, 2), np.int64)}
        lab = np.ones((4, 1), np.int32)
        out, plab = faultinject.poison_batch(orig, lab, step=5)
        assert plab is lab
        assert np.isnan(out["x"]).all()
        assert np.array_equal(out["ids"], orig["ids"])
        assert np.isfinite(orig["x"]).all()

    def test_poison_takes_placed_tensors(self):
        """A prefetched batch is already tensors on the device."""
        faultinject.install("nan_grads@step=2,nan_grads@step=3")
        x = {"x": torch.ones(4, 2), "ids": torch.ones(4, 2,
                                                      dtype=torch.int64)}
        lab = torch.ones(4, 1)
        _, plab = faultinject.poison_batch(x, lab, step=2)
        assert torch.isnan(plab).all() and torch.isfinite(lab).all()
        out, same = faultinject.poison_batch(
            x, torch.ones(4, 1, dtype=torch.int64), step=3)
        assert torch.isnan(out["x"]).all()
        assert torch.equal(out["ids"], x["ids"])
        assert torch.isfinite(x["x"]).all()

    def test_specs_and_their_parse_match_jax(self):
        spec = ("nan_grads@step=3;io_error@save=2,preempt@save,"
                "preempt+reshape@step=5:mesh=2x1,host_crash@step=4,"
                "host_hang@barrier")
        assert [f.spec() for f in faultinject.parse(spec)] == \
            [f.spec() for f in jfault.parse(spec)]

    def test_config_faults_route_fit_through_the_resilient_loop(self):
        cfg = fft.FFConfig.parse_args(["--faults", "nan_grads@step=2",
                                       "--prefetch", "2"])
        assert cfg.faults == "nan_grads@step=2" and cfg.prefetch_depth == 2
        m = make_model(faults="nan_grads@step=2")
        m.fit(init(m), make_loader(), epochs=1, verbose=False,
              sentinel=NaNSentinel(policy="skip"))
        assert len(m._fit_loss_trace) == 7
        assert m._last_fit_used_scan is False


class TestReshapeSpecs:
    """The fault-spec cases of tests/test_elastic.py: the port parses and
    fires preempt+reshape (its resume under a new mesh waits for
    ROADMAP.md Queue A item 8)."""

    def test_parse_reshape_spec(self):
        (f,) = faultinject.parse("preempt+reshape@step=5:mesh=2x1")
        assert (f.kind, f.point, f.value, f.mesh) == \
            ("preempt+reshape", "step", 5, {"data": 2, "model": 1})
        (f,) = faultinject.parse("preempt+reshape@step=3")
        assert f.mesh is None

    def test_parse_mesh_shape(self):
        assert faultinject.parse_mesh_shape("4") == {"data": 4, "model": 1}
        assert faultinject.parse_mesh_shape("2x2") == {"data": 2,
                                                       "model": 2}
        for bad in ("2x0x1", "0", "ax2"):
            with pytest.raises(ValueError):
                faultinject.parse_mesh_shape(bad)
        with pytest.raises(ValueError):
            faultinject.parse("preempt@step=5:mesh=2x1")
        with pytest.raises(ValueError):
            faultinject.parse("preempt+reshape@save")

    def test_reshape_fires_once_with_its_shape(self):
        faultinject.install("preempt+reshape@step=7:mesh=2x2")
        faultinject.maybe_preempt("step", step=6)  # not yet
        with pytest.raises(Reshape) as ei:
            faultinject.maybe_preempt("step", step=7)
        assert ei.value.mesh_shape == {"data": 2, "model": 2}
        assert isinstance(ei.value, Preemption)
        faultinject.maybe_preempt("step", step=7)  # consumed


# --------------------------------------------------------------- watchdogs
class TestHeartbeats:
    def test_tmp_debris_and_stale_beats_never_read_live(self, tmp_path):
        d = str(tmp_path)
        beat(d, 0)
        beat(d, 1)
        aged = time.time() - 90.0
        os.utime(os.path.join(d, "heartbeat-p001"), (aged, aged))
        (tmp_path / "heartbeat-p002.tmp-4242").write_text("")
        ages = heartbeat_ages(d, 3)
        assert ages["p000"] is not None and ages["p000"] < 30.0
        assert ages["p001"] is not None and ages["p001"] > 80.0
        assert ages["p002"] is None

    def test_beat_is_atomic_rename(self, tmp_path):
        beat(str(tmp_path), 7)
        assert sorted(os.listdir(str(tmp_path))) == ["heartbeat-p007"]
        assert heartbeat_ages(str(tmp_path), 8)["p007"] < 10.0

    def test_missing_directory_reads_as_no_beats(self, tmp_path):
        ages = heartbeat_ages(str(tmp_path / "never_made"), 2)
        assert ages == {"p000": None, "p001": None}

    def test_watchdog_names_dead_peer_once(self, tmp_path):
        d = str(tmp_path)
        beat(d, 1)
        aged = time.time() - 60.0
        os.utime(os.path.join(d, "heartbeat-p001"), (aged, aged))
        wd = HostWatchdog(d, 0, 2, interval_s=0.1, deadline_s=5.0)
        with event_log() as log:
            assert wd.sweep() == ["p001"]
            assert wd.sweep() == []
        assert wd.dead_peers() == ["p001"]
        ev = log.last("recovery")
        assert ev["phase"] == "dead_peer" and ev["peer"] == "p001"
        assert tmetrics.HOST_HEARTBEAT_AGE.value > 50.0

    def test_never_beaten_peer_ages_from_watchdog_start(self, tmp_path):
        wd = HostWatchdog(str(tmp_path), 0, 2, deadline_s=30.0)
        assert wd.sweep() == []

    def test_watchdog_thread_flags_and_calls_back(self, tmp_path):
        seen = []
        wd = HostWatchdog(str(tmp_path), 0, 2, interval_s=0.05,
                          deadline_s=0.1, on_dead=seen.extend)
        with wd:
            assert wd.wait_for_death(5.0) == ["p001"]
        assert seen == ["p001"]

    def test_stall_limit_floor(self):
        progress = [0.0]
        w = StallWatchdog(progress, wall=[0.001], multiple=10.0,
                          floor_s=5.0)
        assert w.limit_s() == 5.0
        w2 = StallWatchdog(progress, wall=[2.0], multiple=10.0,
                           floor_s=5.0)
        assert w2.limit_s() == 20.0

    def test_stall_watchdog_fires_on_a_stalled_loop(self):
        fired = threading.Event()
        got = []

        def on_stall(stalled, limit):
            got.append((stalled, limit))
            fired.set()

        w = StallWatchdog([time.perf_counter()], wall=[0.0], floor_s=0.1,
                          poll_s=0.02, on_stall=on_stall)
        with event_log() as log:
            w.start()
            assert fired.wait(5.0)
            w.stop()
        assert got[0][0] > got[0][1] == 0.1
        assert log.last("recovery")["phase"] == "stall"

    def test_barrier_timeout_is_not_exception_family(self):
        err = FleetBarrierTimeout("t", ["p1"], 1.0)
        assert isinstance(err, BaseException)
        assert not isinstance(err, Exception)
        assert "p1" in str(err)

    @pytest.mark.parametrize("spec", ["host_crash@step=3",
                                      "host_hang@step=2",
                                      "host_hang@barrier"])
    def test_valid_host_loss_specs_parse(self, spec):
        faults = faultinject.parse(spec)
        assert len(faults) == 1 and faults[0].kind.startswith("host_")

    @pytest.mark.parametrize("spec", ["host_crash@barrier",
                                      "host_crash@save",
                                      "host_hang@save",
                                      "host_hang@restore",
                                      "nan_grads@barrier"])
    def test_invalid_point_combinations_rejected(self, spec):
        with pytest.raises(ValueError):
            faultinject.parse(spec)


class TestFlightRecorder:
    def test_noop_without_telemetry(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FF_FLIGHT_DIR", str(tmp_path))
        assert dump_flight_record(RuntimeError("x"), log=None) is None
        assert os.listdir(tmp_path) == []

    def test_dump_never_raises(self, tmp_path, monkeypatch):
        from dlrm_flexflow_tpu_torch.telemetry import EventLog
        monkeypatch.setenv("FF_FLIGHT_DIR",
                           os.path.join(str(tmp_path), "f.jsonl", "x"))
        (tmp_path / "f.jsonl").write_text("")  # a FILE, not a dir
        log = EventLog()
        log.emit("step", wall_s=1.0, samples=8)
        assert dump_flight_record(RuntimeError("x"), log=log) is None

    def test_dump_on_injected_fault(self, tmp_path, monkeypatch):
        """A resilient fit killed by nan_grads past max_rollbacks: the
        original exception propagates and one parseable artifact records
        the death, its last ring event the anomaly at the fatal step."""
        monkeypatch.setenv("FF_FLIGHT_DIR", str(tmp_path))
        faultinject.install("nan_grads@step=1,nan_grads@step=2,"
                            "nan_grads@step=3")
        m = make_model()
        with pytest.raises(TrainingDiverged):
            with event_log():
                m.fit(init(m), make_loader(), epochs=2, verbose=False,
                      sentinel=NaNSentinel(policy="skip",
                                           max_rollbacks=2))
        (name,) = os.listdir(tmp_path)
        doc = json.loads((tmp_path / name).read_text())
        assert doc["kind"] == "flightrecorder"
        assert doc["exception"]["type"] == "TrainingDiverged"
        last = doc["events"][-1]
        fatal = max(e["step"] for e in doc["events"]
                    if e["type"] == "fault" and e["kind"] == "nan_grads")
        assert last["type"] == "anomaly" and last["step"] == fatal

    def test_a_preempted_fit_dumps_its_open_spans(self, tmp_path,
                                                  monkeypatch):
        monkeypatch.setenv("FF_FLIGHT_DIR", str(tmp_path / "fr"))
        faultinject.install("preempt@step=3")
        m = make_model()
        with event_log():
            with pytest.raises(Preemption):
                m.fit(init(m), make_loader(), epochs=1, verbose=False,
                      sentinel=NaNSentinel())
        (name,) = os.listdir(tmp_path / "fr")
        assert name.startswith("flightrecorder_") and name.endswith(".json")
        doc = json.loads((tmp_path / "fr" / name).read_text())
        assert doc["exception"]["type"] == "Preemption"
        assert {s["name"] for s in doc["open_spans"]} >= {"train.fit",
                                                         "train.epoch"}
        assert any(e["type"] == "fault" for e in doc["events"])

    def test_predicted_sync_is_none_on_one_device(self):
        assert predicted_sync_ms({"a": {"w": torch.ones(3)}}) is None
        with event_log():
            sp = start_span("x")
            sp.end()


# ----------------------------------------------------------- prefetching
class TestPrefetchLoader:
    def test_rejects_bad_depth(self):
        with pytest.raises(ValueError, match="depth"):
            PrefetchLoader(make_loader(), depth=0)

    def test_yields_identical_batches_across_epochs(self):
        pf = PrefetchLoader(make_loader(seed=7), depth=3)
        bare = make_loader(seed=7)
        for _ in range(2):
            batches_equal(list(pf), list(bare))
        pf.close()

    def test_shape_passthroughs_and_peek(self):
        inner = make_loader()
        pf = PrefetchLoader(inner, depth=2)
        assert pf.num_batches == inner.num_batches
        assert pf.batch_size == inner.batch_size
        assert len(pf) == len(inner)
        assert pf.shuffle is True and pf.drop_last == inner.drop_last
        assert pf.inputs is inner.inputs and pf.labels is inner.labels
        pi, pl = pf.peek()
        bi, bl = inner.peek()
        np.testing.assert_array_equal(pl, bl)
        np.testing.assert_array_equal(pi["x"], bi["x"])
        pf.close()

    def test_place_fn_applied_in_worker(self):
        pf = PrefetchLoader(make_loader(), depth=2, place_fn=torch.as_tensor)
        inputs, labels = next(iter(pf))
        assert isinstance(inputs["x"], torch.Tensor)
        assert isinstance(labels, torch.Tensor)
        pf.close()

    def test_batch_placer_casts_to_the_graph_dtypes(self):
        m = make_model()
        init(m)
        pf = PrefetchLoader(make_loader(), depth=2,
                            place_fn=m.batch_placer())
        bare = make_loader()
        for (pi, pl), (bi, bl) in zip(pf, bare):
            assert pi["x"].dtype == torch.float32
            assert pi["x"].device == torch.device("cpu")
            np.testing.assert_array_equal(pi["x"].numpy(), bi["x"])
            np.testing.assert_array_equal(pl.numpy(), bl)
        pf.close()

    def test_cursor_is_consumed_exact_not_fetch_ahead(self):
        pf = PrefetchLoader(make_loader(seed=9), depth=2 * (N // BATCH))
        it = iter(pf)
        for _ in range(3):
            next(it)
        deadline = time.monotonic() + 5.0
        while pf._epoch[0].qsize() < N // BATCH - 3 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        twin = make_loader(seed=9)
        tw = iter(twin)
        for _ in range(3):
            next(tw)
        assert pf.state_dict() == twin.state_dict()
        fresh = make_loader(seed=123)
        fresh.load_state_dict(pf.state_dict())
        batches_equal(list(tw), list(iter(fresh)))

    def test_state_dict_before_any_consume_proxies_inner(self):
        inner = make_loader(seed=5)
        pf = PrefetchLoader(inner, depth=4)
        assert pf.state_dict() == inner.state_dict()

    def test_state_dict_mid_fetch_before_first_consume_is_epoch_start(self):
        pf = PrefetchLoader(make_loader(seed=11), depth=2 * (N // BATCH))
        it = iter(pf)
        deadline = time.monotonic() + 5.0
        while pf._epoch[0].qsize() < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        sd = pf.state_dict()
        assert sd["batch"] == 0
        fresh = make_loader(seed=123)
        fresh.load_state_dict(sd)
        batches_equal(list(it), list(iter(fresh)))

    def test_loader_without_state_dict_is_supported(self):
        class Plain:
            num_batches, batch_size = 2, BATCH

            def __iter__(self):
                for _ in range(2):
                    yield {"x": np.zeros((BATCH, 4), np.float32)}, \
                        np.zeros((BATCH, 1), np.float32)

        pf = PrefetchLoader(Plain(), depth=2)
        assert pf.state_dict() is None
        assert len(list(pf)) == 2
        assert pf.state_dict() is None

    def test_abandoned_generator_does_not_clobber_new_epoch(self):
        pf = PrefetchLoader(make_loader(), depth=2)
        g1 = iter(pf)
        next(g1)
        g2 = iter(pf)
        g1.close()
        assert pf._epoch is not None
        next(g2)
        t2 = pf._epoch[2]
        pf.close()
        assert not t2.is_alive()

    def test_load_state_dict_aborts_inflight_and_replays(self):
        pf = PrefetchLoader(make_loader(seed=3), depth=2)
        it = iter(pf)
        next(it), next(it)
        sd = pf.state_dict()
        pf2 = PrefetchLoader(make_loader(seed=77), depth=2)
        it2 = iter(pf2)
        next(it2)
        pf2.load_state_dict(sd)
        rest = list(it)
        batches_equal(rest, list(pf2)[:len(rest)])

    def test_worker_error_reraised_at_consumer(self):
        class Boom:
            num_batches, batch_size = 2, BATCH

            def __iter__(self):
                yield {"x": np.zeros((BATCH, 4), np.float32)}, \
                    np.zeros((BATCH, 1), np.float32)
                raise ValueError("loader exploded")

        pf = PrefetchLoader(Boom(), depth=2)
        it = iter(pf)
        next(it)
        with pytest.raises(ValueError, match="loader exploded"):
            next(it)

    def test_close_idempotent_and_refuses_iteration(self):
        pf = PrefetchLoader(make_loader(), depth=2)
        next(iter(pf))
        assert pf.close() == {"closed": True}
        assert pf.close() == {"closed": True}
        with pytest.raises(RuntimeError, match="closed"):
            iter(pf)


class TestPrefetchBitIdentity:
    def test_plain_fit_prefetch_on_off(self):
        states = {}
        for depth in (0, 2):
            m = make_model(prefetch_depth=depth)
            st, _ = m.fit(init(m), make_loader(), epochs=2, verbose=False,
                          warmup=False)
            assert m._last_fit_used_scan is False
            states[depth] = st
        assert_params_equal(states[0], states[2])

    def test_resilient_fit_prefetch_on_off(self, tmp_path):
        runs = {}
        for depth in (0, 2):
            m = make_model(prefetch_depth=depth)
            st, _ = m.fit(init(m), make_loader(), epochs=2, verbose=False,
                          checkpoint_manager=str(tmp_path / f"ck{depth}"),
                          checkpoint_every_n_steps=4)
            runs[depth] = (st, m._fit_loss_trace.copy(),
                           m._fit_loss_steps.copy())
        np.testing.assert_array_equal(runs[0][1], runs[2][1])
        np.testing.assert_array_equal(runs[0][2], runs[2][2])
        assert_params_equal(runs[0][0], runs[2][0])
        # the saved loader cursors are consumed-exact: same extra.json
        for name in ("ckpt-12", "ckpt-16"):
            a = (tmp_path / "ck0" / name / "extra.json").read_text()
            b = (tmp_path / "ck2" / name / "extra.json").read_text()
            assert a == b

    def test_sentinel_lag1_with_prefetch(self):
        traces = {}
        for depth in (0, 2):
            faultinject.clear()
            faultinject.install("nan_grads@step=3")
            m = make_model(prefetch_depth=depth)
            m.fit(init(m), make_loader(), epochs=2, verbose=False,
                  sentinel=NaNSentinel(policy="skip"))
            traces[depth] = m._fit_loss_trace.copy()
        assert np.isfinite(traces[0]).all() and len(traces[0]) == 15
        np.testing.assert_array_equal(traces[0], traces[2])

    def test_explicit_prefetch_loader_used_as_is(self):
        m = make_model(prefetch_depth=2)
        st0 = init(m)
        pf = PrefetchLoader(make_loader(), depth=2, place_fn=m.shard_batch)
        st, _ = m.fit(st0, pf, epochs=1, verbose=False, warmup=False)
        m2 = make_model(prefetch_depth=0)
        st2, _ = m2.fit(init(m2), make_loader(), epochs=1, verbose=False,
                        warmup=False)
        assert_params_equal(st2, st)
        pf.close()


class TestPipelineTelemetry:
    def test_per_batch_step_event_carries_stall_fields(self):
        m = make_model(prefetch_depth=2)
        with event_log() as log:
            m.fit(init(m), make_loader(), epochs=1, verbose=False,
                  warmup=False)
        ev = log.last("step")
        assert ev["phase"] == "fit"
        assert ev["data_stall_ms"] >= 0.0
        assert ev["dispatch_ms"] > 0.0
        pct = tmetrics.DATA_STALL_PCT.value
        assert pct is not None and 0.0 <= pct <= 100.0

    def test_resilient_step_event_carries_stall_fields(self, tmp_path):
        m = make_model()
        with event_log() as log:
            m.fit(init(m), make_loader(), epochs=1, verbose=False,
                  checkpoint_manager=str(tmp_path / "ck"),
                  checkpoint_every_n_steps=4)
        ev = log.last("step")
        assert ev["phase"] == "resilient_fit"
        assert ev["data_stall_ms"] >= 0.0 and ev["dispatch_ms"] > 0.0
        saves = [e for e in log.events("checkpoint")
                 if e["action"] == "save"]
        assert [e["step"] for e in saves] == [4, 8]
        spans = {e["name"] for e in log.events("span")}
        assert {"train.fit", "train.epoch", "train.dispatch",
                "ckpt.save"} <= spans
        phase = [e for e in log.events("phase_time")
                 if e["phase"] == "resilient_fit"]
        assert phase and "predicted_sync_ms" not in phase[-1]

    def test_scanned_path_has_no_stall_fields(self):
        m = make_model(prefetch_depth=2)
        with event_log() as log:
            m.fit(init(m), make_loader(shuffle=False), epochs=1,
                  verbose=False, warmup=False)
        assert m._last_fit_used_scan is True
        ev = log.last("step")
        assert "data_stall_ms" not in ev and "dispatch_ms" not in ev


# ---------------------------------------------------- the learning rate
class TestSetLearningRate:
    def test_an_lr_change_between_graphed_steps_acts_as_eagerly(self):
        """The captured step reads opt_state["lr"] by address:
        set_learning_rate writes it in place, so the steps after it (the
        same runner, no new capture) equal eager steps taken at the new
        rate, bit for bit."""
        x, y = _data(16)
        b1 = ({"x": x["x"][:8]}, y[:8])
        b2 = ({"x": x["x"][8:]}, y[8:])
        m = make_model()
        st = init(m)
        ref = st.clone()
        for b in (b1, b2, b1):          # eager, capture, replay
            st, _ = m.train_step(st, *b)
        caps = m.graph_captures
        st = m.set_learning_rate(st, 0.02)
        assert m.optimizer.lr == 0.02
        for b in (b2, b1):
            st, mets = m.train_step(st, *b)
        assert m.graph_captures == caps and m.graph_replays >= 3
        e = make_model()
        for b in (b1, b2, b1):
            ref, _ = e.train_step(ref, *b, donate=False)
        ref = e.set_learning_rate(ref, 0.02)
        for b in (b2, b1):
            ref, emets = e.train_step(ref, *b, donate=False)
        assert_params_equal(ref, st)
        assert torch.equal(mets["loss"], emets["loss"])

    def test_lr_value_and_a_missing_key_match_jax(self):
        jm = make_jax_model()
        js = jm.set_learning_rate(jm.init(seed=0), 0.0123)
        m = make_model()
        st = init(m)
        st = m.set_learning_rate(st, 0.0123)
        assert float(st.opt_state["lr"]) == float(js.opt_state["lr"])
        bare = fft.TrainState(st.params, {"step": st.opt_state["step"]},
                              st.bn_state, st.rng, st.step)
        got = m.set_learning_rate(bare, 0.5)
        assert got.opt_state["lr"].dtype == torch.float32
        assert float(got.opt_state["lr"]) == 0.5 and "lr" not in \
            bare.opt_state


# ------------------------------------------------------ across packages
def _jax_kill_and_twin(tmp_path):
    """The JAX acceptance path: killed at step 10 with saves every 4
    steps (npz), and its uninterrupted twin."""
    jm = make_jax_model()
    jfault.install("preempt@step=10")
    with pytest.raises(JaxPreemption):
        jm.fit(jm.init(seed=0), make_jax_loader(), epochs=2, verbose=False,
               checkpoint_manager=JaxManager(str(tmp_path / "jck"),
                                             use_orbax=False),
               checkpoint_every_n_steps=4)
    jfault.clear()
    jt = make_jax_model()
    jt.fit(jt.init(seed=0), make_jax_loader(), epochs=2, verbose=False,
           checkpoint_manager=JaxManager(str(tmp_path / "jtwin"),
                                         use_orbax=False),
           checkpoint_every_n_steps=4)
    return jt


def test_port_resumes_a_killed_jax_run_on_its_trajectory(tmp_path):
    """A JAX run killed at step 10 (saves every 4 steps); the port resumes
    from the JAX directory (ckpt-8 and its loader cursor) and follows the
    JAX uninterrupted run's loss trace from step 9 within rtol 1e-5."""
    jt = _jax_kill_and_twin(tmp_path)
    assert sorted(os.listdir(tmp_path / "jck")) == ["ckpt-4", "ckpt-8"]
    assert verify_checkpoint(str(tmp_path / "jck" / "ckpt-8")) == []
    m = make_model()
    st, _ = m.fit(init(m), make_loader(), epochs=2, verbose=False,
                  checkpoint_manager=CheckpointManager(str(tmp_path / "jck")),
                  checkpoint_every_n_steps=4, resume=True)
    assert m._fit_loss_steps.tolist() == list(range(9, 17))
    ref = dict(zip(jt._fit_loss_steps.tolist(),
                   jt._fit_loss_trace.tolist()))
    np.testing.assert_allclose(m._fit_loss_trace,
                               [ref[s] for s in m._fit_loss_steps],
                               rtol=1e-5)
    # the port's saves land beside the JAX ones and verify under both
    assert jax_verify(str(tmp_path / "jck" / "ckpt-16")) == []
    js = jt._fit_state
    for op, d in js.params.items():
        for k, v in d.items():
            np.testing.assert_allclose(st.params[op][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("policy,faults,epochs", [
    ("skip", "nan_grads@step=3", 2),
    ("lr_backoff", "nan_grads@step=2", 1),
    ("skip", "nan_grads@step=3,nan_grads@step=4", 2),
])
def test_sentinel_runs_match_jax(policy, faults, epochs):
    """The same weights and batches through both resilient loops with
    the same injected faults: the same adopted steps, the same final
    learning rate, the losses within rtol 1e-5."""
    jm = make_jax_model()
    js, ps = jax_weights(jm)
    jfault.install(faults)
    jm.fit(js, make_jax_loader(), epochs=epochs, verbose=False,
           sentinel=JaxSentinel(policy=policy, max_rollbacks=4))
    m = make_model()
    st = m.load_params(ps.params, device="cpu", opt_state=ps.opt_state)
    faultinject.install(faults)
    m.fit(st, make_loader(), epochs=epochs, verbose=False,
          sentinel=NaNSentinel(policy=policy, max_rollbacks=4))
    np.testing.assert_array_equal(m._fit_loss_steps, jm._fit_loss_steps)
    np.testing.assert_allclose(m._fit_loss_trace, jm._fit_loss_trace,
                               rtol=1e-5)
    assert m.optimizer.lr == jm.optimizer.lr
    assert float(m._fit_state.opt_state["lr"]) == \
        float(jm._fit_state.opt_state["lr"])
