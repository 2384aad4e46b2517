"""``fit``'s callbacks, ``schedule_learning_rate`` and
``compile(donate_state=)`` in the port
(dlrm_flexflow_tpu_torch/frontends/keras_callbacks.py, model.py) against
the JAX package's, on the CPU.  JAX is imported here only.

Tolerances: the rates a schedule sets, the hook order, the epochs run and
the checkpoint files' names, keys and metadata are exact; per-epoch
losses rtol 1e-3 and parameters rtol 1e-4 / atol 1e-6 (the port's Linear
accumulates in f64 and rounds once); a state restored from the port's own
checkpoint and a state kept by ``donate_state=False``: bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import checkpoint as jckpt
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.data.loader import ArrayDataLoader as JaxLoader
from dlrm_flexflow_tpu.frontends import keras_callbacks as jcb

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import state_from_jax
from dlrm_flexflow_tpu_torch.checkpoint import restore_checkpoint
from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader
from dlrm_flexflow_tpu_torch.frontends import keras_callbacks as pcb

D, BATCH = 8, 8
TABLES = [64, 96]


def _kw():
    return dict(sparse_feature_size=D, embedding_size=TABLES,
                embedding_bag_size=2, mlp_bot=[4, D],
                mlp_top=[D * 2 + D, 8, 1])


def _dlrm(pkg, **compile_kw):
    """The small lazy-Adam DLRM of tests/test_torch_lazy_optim.py."""
    opt = pkg.AdamOptimizer(lr=0.05, lazy_embeddings=True)
    if pkg is ffj:
        m = jax_build_dlrm(JaxDLRMConfig(**_kw()),
                           ffj.FFConfig(batch_size=BATCH))
        m.compile(optimizer=opt, loss_type="mean_squared_error",
                  metrics=("accuracy", "mean_squared_error"), mesh=False,
                  **compile_kw)
    else:
        m = build_dlrm(DLRMConfig(**_kw()), fft.FFConfig(batch_size=BATCH))
        m.compile(optimizer=opt, loss_type="mean_squared_error",
                  metrics=("accuracy", "mean_squared_error"), **compile_kw)
    return m


def _arrays(nb, seed=0):
    rng = np.random.default_rng(seed)
    n = nb * BATCH
    x = {"dense": rng.standard_normal((n, 4)).astype(np.float32),
         "sparse": np.stack([rng.integers(0, r // 4, size=(n, 2))
                             for r in TABLES], axis=1).astype(np.int32)}
    return x, rng.integers(0, 2, size=(n, 1)).astype(np.float32)


def _loaders(nb=2, seed=0):
    x, y = _arrays(nb, seed)
    return (JaxLoader(x, y, BATCH, shuffle=False),
            ArrayDataLoader(x, y, BATCH, shuffle=False))


def _pair(**compile_kw):
    """(JAX model and state, port model and the same state)."""
    jm, pm = _dlrm(ffj), _dlrm(fft, **compile_kw)
    js = jm.init(seed=0)
    return jm, js, pm, state_from_jax(jax.tree.map(np.asarray, js))


class Recorder(pcb.Callback):
    """Every hook call in order, with the rate the state held and the
    epoch's loss at each epoch end (the same class serves both
    packages: it only reads ``_fit_state`` and ``get_perf_metrics``)."""

    def __init__(self):
        super().__init__()
        self.calls, self.rates, self.mse, self.logs = [], [], [], []

    def set_model(self, model):
        self.calls.append(("set_model",))
        super().set_model(model)

    def on_train_begin(self, logs=None):
        self.calls.append(("train_begin",))

    def on_epoch_begin(self, epoch, logs=None):
        self.calls.append(("epoch_begin", epoch))

    def on_batch_begin(self, batch, logs=None):
        self.calls.append(("batch_begin", batch))

    def on_batch_end(self, batch, logs=None):
        self.calls.append(("batch_end", batch))

    def on_epoch_end(self, epoch, logs=None):
        self.calls.append(("epoch_end", epoch))
        self.rates.append(float(np.asarray(
            self.model._fit_state.opt_state["lr"])))
        self.mse.append(
            self.model.get_perf_metrics().finalized_means()["mse"])
        self.logs.append(logs)

    def on_train_end(self, logs=None):
        self.calls.append(("train_end",))


def _schedule(epoch):
    return [0.05, 0.01, 0.002][epoch]


def test_learning_rate_scheduler_sets_the_jax_rates():
    """A 3-epoch per-batch ``fit`` under ``LearningRateScheduler``: the same
    rate in the state at every epoch (epoch 0's before the warmup step),
    the same hooks in the same order, and the same per-epoch losses."""
    jm, js, pm, ps = _pair()
    jl, pl = _loaders()
    jrec, prec = Recorder(), Recorder()
    js, _ = jm.fit(js, jl, epochs=3, verbose=False,
                   callbacks=[jcb.LearningRateScheduler(_schedule), jrec])
    ps, _ = pm.fit(ps, pl, epochs=3, verbose=False,
                   callbacks=[pcb.LearningRateScheduler(_schedule), prec])
    assert not pm._last_fit_used_scan and not jm._last_fit_used_scan
    assert prec.rates == jrec.rates == [np.float32(r) for r in
                                        (0.05, 0.01, 0.002)]
    assert float(ps.opt_state["lr"]) == np.float32(0.002)
    assert pm.optimizer.lr == jm.optimizer.lr == 0.002
    assert prec.calls == jrec.calls
    np.testing.assert_allclose(prec.mse, jrec.mse, rtol=1e-3)
    assert int(ps.step) == int(js.step) == 7  # warmup + 3 x 2
    for op, params in js.params.items():
        for k, v in params.items():
            np.testing.assert_allclose(ps.params[op][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6)


def test_hook_order_and_logs():
    """set_model, on_train_begin, on_epoch_begin(0) before the warmup
    step, the batch hooks around each step, on_epoch_end with the epoch's
    metric means, on_train_end last; the state at each epoch end is
    ``_fit_state``."""
    pm = _dlrm(fft)
    _, pl = _loaders()
    rec = Recorder()
    state = pm.init(seed=0, device="cpu")
    pm.fit(state, pl, epochs=2, verbose=False, callbacks=[rec])
    assert rec.calls == [
        ("set_model",), ("train_begin",), ("epoch_begin", 0),
        ("batch_begin", 0), ("batch_end", 0), ("batch_begin", 1),
        ("batch_end", 1), ("epoch_end", 0), ("epoch_begin", 1),
        ("batch_begin", 0), ("batch_end", 0), ("batch_begin", 1),
        ("batch_end", 1), ("epoch_end", 1), ("train_end",)]
    assert [set(lg) for lg in rec.logs] == [
        set(pm.get_perf_metrics().finalized_means())] * 2
    assert rec.logs[-1] == pm.get_perf_metrics().finalized_means()
    # donated: the state's own tensors, stepped in place
    assert pm._fit_state.params["top_0"]["kernel"] is \
        state.params["top_0"]["kernel"]
    assert pm._fit_state.step is state.step and int(state.step) == 5


@pytest.mark.parametrize("callbacks", [None, [], [pcb.Callback()]],
                         ids=["none", "empty", "one"])
def test_callbacks_force_the_per_batch_loop(callbacks):
    """An array-backed, unshuffled loader takes the staged branch unless a
    callback is given (JAX ``_stage_scan_dataset``)."""
    pm = _dlrm(fft)
    _, pl = _loaders()
    pm.fit(pm.init(seed=0, device="cpu"), pl, epochs=1, verbose=False,
           callbacks=callbacks)
    assert pm._last_fit_used_scan == (not callbacks)


def _dense(pkg):
    m = pkg.FFModel(pkg.FFConfig(batch_size=8))
    x = m.create_tensor((8, 4), name="x")
    m.dense(x, 1)
    kw = {"mesh": False} if pkg is ffj else {}
    m.compile(optimizer=pkg.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=(), **kw)
    return m


def test_model_checkpoint_writes_the_jax_files(tmp_path, monkeypatch):
    """``ModelCheckpoint(period=2)`` over 4 epochs in both packages (JAX
    tests/test_checkpoint.py:79-110): saves after epochs 1 and 3 and no
    redundant final save, the same file names, npz keys, dtypes, shapes
    and meta.json; the last restores to the final state bit for bit.  The
    JAX side writes npz, as where orbax is absent (the port's format)."""
    monkeypatch.setattr(jckpt, "_orbax_available", lambda: False)
    rng = np.random.default_rng(0)
    x = {"x": rng.standard_normal((32, 4)).astype(np.float32)}
    y = rng.standard_normal((32, 1)).astype(np.float32)
    jm, pm = _dense(ffj), _dense(fft)
    js = jm.init(seed=0)
    ps = state_from_jax(jax.tree.map(np.asarray, js))
    jc = jcb.ModelCheckpoint(str(tmp_path / "j" / "ck_{epoch:02d}"), period=2)
    pc = pcb.ModelCheckpoint(str(tmp_path / "p" / "ck_{epoch:02d}"), period=2)
    js, _ = jm.fit(js, JaxLoader(x, y, 8), epochs=4, verbose=False,
                   callbacks=[jc])
    ps, _ = pm.fit(ps, ArrayDataLoader(x, y, 8), epochs=4, verbose=False,
                   callbacks=[pc])
    names = [os.path.basename(p) for p in pc.saved]
    assert names == [os.path.basename(p) for p in jc.saved] == \
        ["ck_01", "ck_03"]
    for jp, pp in zip(jc.saved, pc.saved):
        assert sorted(os.listdir(pp)) == sorted(os.listdir(jp))
        with open(os.path.join(pp, "meta.json")) as f, \
                open(os.path.join(jp, "meta.json")) as g:
            assert json.load(f) == json.load(g)
        a = np.load(os.path.join(jp, "state.npz"))
        b = np.load(os.path.join(pp, "state.npz"))
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    back = restore_checkpoint(pc.saved[-1], pm, device="cpu")
    assert torch.equal(back.params["dense"]["kernel"],
                       ps.params["dense"]["kernel"])
    assert int(back.step) == int(ps.step) == 17
    jback = jckpt.restore_checkpoint(pc.saved[-1], jm)  # JAX reads the port's
    assert int(np.asarray(jback.step)) == 17


def test_model_checkpoint_fixed_path_holds_the_final_state(tmp_path):
    """No ``{epoch}`` and an epoch count the period misses: the path ends
    up holding the final state (JAX tests/test_checkpoint.py:113-140)."""
    rng = np.random.default_rng(0)
    x = {"x": rng.standard_normal((32, 4)).astype(np.float32)}
    y = rng.standard_normal((32, 1)).astype(np.float32)
    pm = _dense(fft)
    ck = str(tmp_path / "ck")
    cb = pcb.ModelCheckpoint(ck, period=2)
    st, _ = pm.fit(pm.init(seed=0, device="cpu"), ArrayDataLoader(x, y, 8),
                   epochs=5, verbose=False, callbacks=[cb])
    assert cb.saved == [ck, ck, ck]  # epochs 1 and 3, then the final
    back = restore_checkpoint(ck, pm)
    assert int(back.step) == int(st.step) == 21
    assert torch.equal(back.params["dense"]["kernel"],
                       st.params["dense"]["kernel"])


def test_epoch_verify_metrics_stops_early_as_in_jax():
    """A target every epoch reaches stops ``fit`` after epoch 0 in both
    packages; ``VerifyMetrics`` with an unreachable target raises at the
    end, after the other callbacks' ``on_train_end``."""
    jm, js, pm, ps = _pair()
    jl, pl = _loaders()
    js, _ = jm.fit(js, jl, epochs=3, verbose=False,
                   callbacks=[jcb.EpochVerifyMetrics(0.0)])
    ps, _ = pm.fit(ps, pl, epochs=3, verbose=False,
                   callbacks=[pcb.EpochVerifyMetrics(0.0)])
    assert int(ps.step) == int(js.step) == 3  # warmup + one epoch
    rec = Recorder()
    with pytest.raises(AssertionError, match="Accuracy is wrong"):
        pm.fit(ps, pl, epochs=1, verbose=False,
               callbacks=[pcb.VerifyMetrics(101.0), rec])
    assert rec.calls[-1] == ("train_end",)
    assert int(pm._fit_state.step) == 6


def test_schedule_learning_rate_applies_at_the_next_epoch():
    """A rate asked for inside an epoch (here by ``on_batch_end``) lands
    at the next epoch's start, through ``set_learning_rate``."""
    pm = _dlrm(fft)
    _, pl = _loaders()
    rec = Recorder()

    class Asks(pcb.Callback):
        def on_batch_end(self, batch, logs=None):
            self.model.schedule_learning_rate(0.125)

    pm.fit(pm.init(seed=0, device="cpu"), pl, epochs=2, verbose=False,
           callbacks=[Asks(), rec])
    assert rec.rates == [np.float32(0.05), np.float32(0.125)]
    assert pm._pending_lr is not None  # the last ask waits for an epoch


@pytest.mark.parametrize("entry", ["train_step", "train_epoch", "fit"])
def test_compile_donate_state_false_keeps_the_input_state(entry):
    """``compile(donate_state=False)``: the input state is left as it was
    by every entry point, and the results equal the donated model's bit
    for bit."""
    keep, donate = _dlrm(fft, donate_state=False), _dlrm(fft)
    ps = keep.init(seed=0, device="cpu")
    kept = ps.clone()
    x, y = _arrays(2)
    if entry == "train_step":
        out, _ = keep.train_step(ps, {k: v[:BATCH] for k, v in x.items()},
                                 y[:BATCH])
        ref, _ = donate.train_step(kept.clone(),
                                   {k: v[:BATCH] for k, v in x.items()},
                                   y[:BATCH])
    elif entry == "train_epoch":
        stacked = ({k: v.reshape((2, BATCH) + v.shape[1:])
                    for k, v in x.items()}, y.reshape(2, BATCH, 1))
        out, _ = keep.train_epoch(ps, *stacked)
        ref, _ = donate.train_epoch(kept.clone(), *stacked)
    else:
        out, _ = keep.fit(ps, ArrayDataLoader(x, y, BATCH), epochs=2,
                          verbose=False)
        ref, _ = donate.fit(kept.clone(), ArrayDataLoader(x, y, BATCH),
                            epochs=2, verbose=False)
    flat = jax.tree_util.tree_leaves
    for a, b in zip(flat((ps.params, ps.opt_state, ps.step)),
                    flat((kept.params, kept.opt_state, kept.step))):
        assert torch.equal(a, b)
    assert int(out.step) > 0
    for a, b in zip(flat((out.params, out.opt_state)),
                    flat((ref.params, ref.opt_state))):
        assert torch.equal(a, b)
