"""The port's checkpoints (dlrm_flexflow_tpu_torch/checkpoint.py) against
the JAX package's on the CPU, at the JAX tests' small sizes
(tests/test_checkpoint.py).  JAX is imported here only.

The JAX checkpoint tests build with ``AdamOptimizer``; most of their
counterparts here use SGD, and the Adam cases (dense and row-lazy) carry
Adam's ``m`` and ``v`` across both ways and through a killed and resumed
lazy-Adam ``fit``.  The cross-package cases run two models: the dense MLP
of tests/test_resilience.py and a small DLRM with embeddings (bag 1,
``cat``, stacked tables) whose steps take the row update's plain version.
Both packages write ``use_orbax=False``: the card's machine has no orbax.

Every comparison is exact (``assert_array_equal``, bit patterns for
bf16): a checkpoint moves data, it computes nothing.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import checkpoint as jckpt
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import (state_from_jax, state_to_numpy)
from dlrm_flexflow_tpu_torch.checkpoint import (CheckpointError, _flatten,
                                                _unflatten,
                                                format_topology,
                                                mesh_topology,
                                                restore_checkpoint,
                                                same_topology,
                                                save_checkpoint,
                                                saved_topology)

TABLES = [64, 40, 50, 30]
D = 8
BATCH = 16


# ------------------------------------------------------------------ models
def _mlp(pkg, lr=0.05):
    """The dense MLP of tests/test_resilience.py, in either package."""
    m = pkg.FFModel(pkg.FFConfig(batch_size=8))
    x = m.create_tensor((8, 4), name="x")
    m.dense(x, 8, activation="relu")
    m.dense(m.layers[-1].outputs[0], 1)
    kw = {"mesh": False} if pkg is ffj else {}
    m.compile(optimizer=pkg.SGDOptimizer(lr=lr),
              loss_type="mean_squared_error", metrics=(), **kw)
    return m


def _dlrm_kwargs():
    return dict(sparse_feature_size=D, embedding_size=list(TABLES),
                embedding_bag_size=1, mlp_bot=[13, 16, D],
                mlp_top=[D + len(TABLES) * D, 16, 1],
                arch_interaction_op="cat")


def _dlrm(pkg, dtype="float32", lr=0.05, adam=None):
    """The small DLRM under SGD, or under Adam (``adam`` "dense" or
    "lazy": ``lazy_embeddings``)."""
    opt = (pkg.SGDOptimizer(lr=lr) if adam is None else
           pkg.AdamOptimizer(lr=lr, lazy_embeddings=adam == "lazy"))
    if pkg is ffj:
        m = jax_build_dlrm(JaxDLRMConfig(**_dlrm_kwargs()),
                           JaxFFConfig(batch_size=BATCH,
                                       embedding_dtype=dtype))
        m.compile(optimizer=opt, loss_type="mean_squared_error", metrics=(),
                  mesh=False)
    else:
        m = build_dlrm(DLRMConfig(**_dlrm_kwargs()),
                       fft.FFConfig(batch_size=BATCH, embedding_dtype=dtype))
        m.compile(optimizer=opt, loss_type="mean_squared_error", metrics=())
    return m


def _mlp_batch(seed=0):
    rng = np.random.default_rng(seed)
    return ({"x": rng.standard_normal((8, 4)).astype(np.float32)},
            rng.standard_normal((8, 1)).astype(np.float32))


def _dlrm_batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, r, size=(BATCH, 1)) for r in TABLES],
                   axis=1)
    return ({"dense": rng.standard_normal((BATCH, 13)).astype(np.float32),
             "sparse": ids.astype(np.int64)},
            rng.integers(0, 2, size=(BATCH, 1)).astype(np.float32))


def _pair(kind, dtype="float32"):
    """(jax model, port model, batch) of one kind."""
    if kind == "mlp":
        return _mlp(ffj), _mlp(fft), _mlp_batch
    return _dlrm(ffj, dtype), _dlrm(fft, dtype), _dlrm_batch


def _jax_trained(jm, batch):
    """A JAX state after one step (its dicts in the jitted step's order)."""
    st = jm.init(seed=0)
    st, _ = jm.train_step(st, *batch(1))
    return st


def _port_model_state(kind="mlp", dtype="float32"):
    pm = _mlp(fft) if kind == "mlp" else _dlrm(fft, dtype)
    batch = _mlp_batch if kind == "mlp" else _dlrm_batch
    st = pm.init(seed=0, device="cpu")
    st, _ = pm.train_step(st, *batch(1))
    return pm, st, batch


def _bits(x) -> np.ndarray:
    """Raw bytes of a tensor or array as uint8, bf16 and voids included."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        x = t.numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.reshape(-1).view(np.uint8)


def _assert_tree_bits(port_tree, jax_tree):
    if isinstance(jax_tree, dict):
        assert set(port_tree) == set(jax_tree)
        for k in jax_tree:
            _assert_tree_bits(port_tree[k], jax_tree[k])
        return
    np.testing.assert_array_equal(_bits(port_tree), _bits(jax_tree))


def _assert_states_bits(port_state, jax_state):
    for field in ("params", "opt_state", "bn_state", "rng", "step"):
        _assert_tree_bits(getattr(port_state, field),
                          getattr(jax_state, field))


# --------------------------------------- counterparts of test_checkpoint
def test_roundtrip_identical_params(tmp_path):
    pm, state, _ = _port_model_state("dlrm")
    path = save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = restore_checkpoint(path)
    for op, d in state.params.items():
        for k, v in d.items():
            assert torch.equal(v, restored.params[op][k])
    assert int(restored.step) == int(state.step) == 1
    # the optimizer state comes back too (a true resume, not just weights)
    for k in ("lr", "step"):
        assert torch.equal(state.opt_state[k], restored.opt_state[k])
    assert torch.equal(state.rng, restored.rng)
    assert restored.rng.dtype == torch.uint32
    assert restored.bn_state == {}


def test_resume_training_continues_identically(tmp_path):
    pm, state, batch = _port_model_state("dlrm")
    path = save_checkpoint(str(tmp_path / "c"), state)
    restored = restore_checkpoint(path, pm)
    assert restored.step.device == torch.device("cpu")
    _, mets_res = pm.train_step(restored, *batch(2))
    _, mets_direct = pm.train_step(state, *batch(2))
    assert float(mets_direct["loss"]) == float(mets_res["loss"])


def test_restore_of_a_model_never_placed_asks_for_the_card(tmp_path):
    """Entry points run on the card unless asked: a restore onto a model
    that was never placed targets CUDA (and raises without a card here);
    ``device="cpu"`` asks for the CPU."""
    _, state, _ = _port_model_state("mlp")
    path = save_checkpoint(str(tmp_path / "c"), state)
    fresh = _mlp(fft)
    got = restore_checkpoint(path, fresh, device="cpu")
    assert got.params["dense"]["kernel"].device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore_checkpoint(path, fresh)


def test_restore_across_topologies_raises_naming_item_8(tmp_path):
    """A checkpoint saved on another topology raises in "error" mode with
    the JAX package's text (both topologies, the way across), and
    restores in "reshard" mode (ROADMAP.md item 8, part 2 ported its
    reshard restore): the values bit for bit, on the restoring model."""
    pm, state, _ = _port_model_state("mlp")
    path = save_checkpoint(str(tmp_path / "c"), state, model=pm)
    meta = json.loads((tmp_path / "c" / "meta.json").read_text())
    assert meta == {"step": 1, "format": "npz", "mesh": {}}
    meta["mesh"] = {"data": 4, "model": 2}
    (tmp_path / "c" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(CheckpointError,
                       match=r"data=4,model=2.*single.*reshard_restore"):
        restore_checkpoint(path, pm, on_mesh_change="error")
    got = restore_checkpoint(path, pm, on_mesh_change="reshard",
                             device="cpu")
    _assert_tree_bits(got.params, {op: {k: v.numpy() for k, v in d.items()}
                                   for op, d in state.params.items()})
    with pytest.raises(ValueError, match="on_mesh_change"):
        restore_checkpoint(path, pm, on_mesh_change="nope")
    # size-1 axes replicate: the same as no mesh
    meta["mesh"] = {"data": 1, "model": 1}
    (tmp_path / "c" / "meta.json").write_text(json.dumps(meta))
    assert int(restore_checkpoint(path, pm).step) == 1


def test_topology_helpers_match_jax():
    from dlrm_flexflow_tpu.parallel import mesh as jmesh
    cases = [None, {}, {"data": 1}, {"data": 2, "model": 4},
             {"model": 4, "data": 2}, {"data": 2, "model": 1}]
    for a in cases:
        assert format_topology(a) == jmesh.format_topology(a)
        for b in cases:
            assert same_topology(a, b) == jmesh.same_topology(a, b)
    assert mesh_topology(None) == jmesh.mesh_topology(None) == {}


def test_host_tables_of_a_jax_checkpoint_warn_and_drop(tmp_path):
    """The JAX package's CPU-placed (hetero) tables have no op in the port
    to land in: a restore warns and drops them, as the JAX restore does
    for a model without the matching op."""
    pm, state, _ = _port_model_state("mlp")
    path = save_checkpoint(str(tmp_path / "c"), state)
    npz = dict(np.load(os.path.join(path, "state.npz")))
    npz["host_tables/emb_0"] = np.zeros((4, 2), np.float32)
    np.savez(os.path.join(path, "state.npz"), **npz)
    with pytest.warns(RuntimeWarning, match="emb_0"):
        got = restore_checkpoint(path, pm)
    assert set(got.params) == set(state.params)


def test_inference_only_skips_slots_and_training_restore_needs_them(
        tmp_path):
    pm, state, _ = _port_model_state("mlp")
    path = save_checkpoint(str(tmp_path / "c"), state)
    served = restore_checkpoint(path, inference_only=True)
    assert served.opt_state == {}
    assert torch.equal(served.params["dense"]["kernel"],
                       state.params["dense"]["kernel"])
    npz = dict(np.load(os.path.join(path, "state.npz")))
    np.savez(os.path.join(path, "state.npz"),
             **{k: v for k, v in npz.items()
                if not k.startswith("opt_state/")})
    with pytest.raises(CheckpointError, match="no optimizer slots"):
        restore_checkpoint(path)
    assert restore_checkpoint(path, inference_only=True).opt_state == {}


class TestSeparatorEscaping:
    """Op and param names holding '/' survive the '/'-joined flat keys."""

    def test_flatten_roundtrips_slash_names(self):
        tree = {"enc/dense": {"kernel": 1}, "enc": {"dense%2Fx": 2},
                "plain": {"bias": 3}}
        flat = _flatten(tree)
        assert _unflatten(flat) == tree
        assert len(flat) == 3
        assert flat == jckpt._flatten(tree)  # the JAX package's keys

    def test_checkpoint_roundtrips_slash_op_name(self, tmp_path):
        m = fft.FFModel(fft.FFConfig(batch_size=8))
        x = m.create_tensor((8, 4), name="x")
        m.dense(x, 2, name="tower/head")  # explicit name with separator
        m.compile(optimizer=fft.SGDOptimizer(0.01),
                  loss_type="mean_squared_error", metrics=())
        st = m.init(seed=0, device="cpu")
        p = save_checkpoint(str(tmp_path / "c"), st, use_orbax=False)
        r = restore_checkpoint(p)
        assert "tower/head" in r.params
        assert torch.equal(st.params["tower/head"]["kernel"],
                           r.params["tower/head"]["kernel"])
        # the JAX package reads the same tree
        j = jckpt.restore_checkpoint(p)
        assert "tower/head" in j.params
        np.testing.assert_array_equal(
            np.asarray(j.params["tower/head"]["kernel"]),
            st.params["tower/head"]["kernel"].numpy())


class TestClearRestoreErrors:
    """Missing or truncated checkpoint pieces raise CheckpointError naming
    the path, with the JAX package's messages."""

    def test_missing_directory(self, tmp_path):
        with pytest.raises(CheckpointError, match="does not exist"):
            restore_checkpoint(str(tmp_path / "nope"))

    def test_missing_meta(self, tmp_path):
        d = tmp_path / "c"
        d.mkdir()
        with pytest.raises(CheckpointError, match="no meta.json"):
            restore_checkpoint(str(d))
        with pytest.raises(CheckpointError, match="no meta.json"):
            saved_topology(str(d))

    def test_truncated_meta(self, tmp_path):
        d = tmp_path / "c"
        d.mkdir()
        (d / "meta.json").write_text('{"step": 3, "form')  # cut mid-write
        with pytest.raises(CheckpointError, match="truncated or corrupt"):
            restore_checkpoint(str(d))
        with pytest.raises(CheckpointError, match="truncated or corrupt"):
            saved_topology(str(d))

    def test_missing_state_npz(self, tmp_path):
        d = tmp_path / "c"
        d.mkdir()
        (d / "meta.json").write_text(json.dumps({"step": 1,
                                                 "format": "npz"}))
        with pytest.raises(CheckpointError, match="no state.npz"):
            restore_checkpoint(str(d))

    def test_truncated_state_npz(self, tmp_path):
        _, st, _ = _port_model_state("dlrm")
        p = save_checkpoint(str(tmp_path / "c"), st, use_orbax=False)
        npz = tmp_path / "c" / "state.npz"
        npz.write_bytes(npz.read_bytes()[:100])  # truncate the archive
        with pytest.raises(CheckpointError, match="unreadable"):
            restore_checkpoint(p)


# ------------------------------------------------ what the port refuses
def test_orbax_checkpoint_raises_naming_the_npz_way_out(tmp_path):
    """A JAX checkpoint in the orbax format (the JAX default where orbax
    is installed) raises, naming the re-save that makes it readable."""
    jm = _mlp(ffj)
    p = jckpt.save_checkpoint(str(tmp_path / "o"), jm.init(seed=0),
                              use_orbax=True)
    assert json.loads(open(os.path.join(p, "meta.json")).read())[
        "format"] == "orbax"
    with pytest.raises(CheckpointError, match="use_orbax=False"):
        restore_checkpoint(p)


def test_podshard_checkpoint_raises_naming_item_8(tmp_path):
    """The podshard format (ROADMAP.md item 8, part 2): a directory whose
    meta says podshard but holds no shard file raises naming what is
    missing; one process's pod save (every leaf a plain key of
    shard-p000, rank 0's) restores bit for bit."""
    d = tmp_path / "pod"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps(
        {"step": 4, "format": "podshard", "process_count": 2}))
    with pytest.raises(CheckpointError, match="no shard-p"):
        restore_checkpoint(str(d))
    pm, st, _ = _port_model_state("dlrm")
    p = save_checkpoint(str(tmp_path / "p1"), st, model=pm, multihost=True)
    assert sorted(os.listdir(p)) == ["meta.json", "shard-p000.json",
                                     "shard-p000.npz"]
    assert json.loads(open(os.path.join(p, "meta.json")).read()) == {
        "step": 1, "format": "podshard", "process_count": 1, "mesh": {}}
    got = restore_checkpoint(p, pm, device="cpu")
    for f in ("params", "opt_state", "rng", "step"):
        _assert_tree_bits(getattr(got, f), state_to_numpy(st)[f])


@pytest.mark.parametrize("kw", [{"multihost": True}, {"use_orbax": True}])
def test_unported_save_formats_raise(tmp_path, kw):
    """orbax raises; the pod format (multihost=True), ported with ROADMAP
    item 8, part 2, writes its shard files."""
    _, st, _ = _port_model_state("mlp")
    if kw.get("multihost"):
        p = save_checkpoint(str(tmp_path / "c"), st, **kw)
        assert "shard-p000.npz" in os.listdir(p)
        return
    with pytest.raises(NotImplementedError):
        save_checkpoint(str(tmp_path / "c"), st, **kw)


# ------------------------------------------------------ across packages
@pytest.mark.parametrize("kind,dtype", [("mlp", "float32"),
                                        ("dlrm", "float32"),
                                        ("dlrm", "bfloat16")])
def test_jax_npz_checkpoint_restores_into_the_port_bit_for_bit(
        tmp_path, kind, dtype):
    jm, pm, batch = _pair(kind, dtype)
    js = _jax_trained(jm, batch)
    p = jckpt.save_checkpoint(str(tmp_path / "j"), js, use_orbax=False,
                              model=jm)
    if dtype == "bfloat16":
        raw = np.load(os.path.join(p, "state.npz"))
        assert raw["params/emb/embedding"].dtype == np.dtype("V2")
    pm.init(seed=0, device="cpu")
    ps = restore_checkpoint(p, pm)
    _assert_states_bits(ps, js)
    if kind == "dlrm":
        assert ps.params["emb"]["embedding"].dtype == (
            torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert ps.rng.dtype == torch.uint32 and ps.step.dtype == torch.int32
    # and the port trains on it, the same step as on the bridged state
    ref = state_from_jax(jax.tree.map(np.asarray, js))
    _, a = pm.train_step(ps, *batch(2))
    _, b = pm.train_step(ref, *batch(2))
    assert float(a["loss"]) == float(b["loss"])


@pytest.mark.parametrize("kind", ["mlp", "dlrm"])
def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path, kind):
    pm, ps, _ = _port_model_state(kind)
    p = save_checkpoint(str(tmp_path / "p"), ps, model=pm)
    jm = _mlp(ffj) if kind == "mlp" else _dlrm(ffj)
    js = jckpt.restore_checkpoint(p, jm)
    _assert_states_bits(ps, js)
    assert jckpt.saved_topology(p) == {}


@pytest.mark.parametrize("kind,dtype", [("mlp", "float32"),
                                        ("dlrm", "float32"),
                                        ("dlrm", "bfloat16")])
def test_port_writes_the_jax_keys_dtypes_and_bytes(tmp_path, kind, dtype):
    """The same state saved by each package: the same npz keys, in the
    same order, each with the same dtype, shape and bytes, and the same
    meta.json.  bf16 tables are 2-byte voids in both."""
    jm, pm, batch = _pair(kind, dtype)
    js = _jax_trained(jm, batch)
    ps = state_from_jax(jax.tree.map(np.asarray, js))
    jp = jckpt.save_checkpoint(str(tmp_path / "j"), js, use_orbax=False,
                               model=jm)
    pp = save_checkpoint(str(tmp_path / "p"), ps, model=pm)
    a, b = np.load(os.path.join(jp, "state.npz")), \
        np.load(os.path.join(pp, "state.npz"))
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    for name in ("meta.json",):
        assert open(os.path.join(jp, name), "rb").read() == \
            open(os.path.join(pp, name), "rb").read()


def test_jax_restore_of_a_bf16_npz_raises_type_error(tmp_path):
    """A reference-side caveat (ROADMAP.md Queue C): the JAX package's own
    restore cannot read the |V2 leaves its npz writer makes for bf16
    tables, and raises TypeError at checkpoint.py:501.  The port writes
    the same bytes, so the JAX package cannot read the port's bf16
    checkpoints either; the port reads both."""
    pm, ps, _ = _port_model_state("dlrm", "bfloat16")
    p = save_checkpoint(str(tmp_path / "p"), ps, model=pm)
    with pytest.raises(TypeError, match="V2"):
        jckpt.restore_checkpoint(p)
    back = restore_checkpoint(p)
    _assert_tree_bits(back.params, state_to_numpy(ps)["params"])


def test_bridge_state_round_trip_is_bit_exact():
    jm, _, batch = _pair("dlrm", "bfloat16")
    js = _jax_trained(jm, batch)
    ps = state_from_jax(js)
    _assert_states_bits(ps, js)
    back = state_to_numpy(ps)
    js2 = ffj.TrainState(*(jax.tree.map(jnp.asarray, v)
                           for v in back.values()))
    _assert_states_bits(ps, js2)
    assert ps.params["emb"]["embedding"].dtype == torch.bfloat16


def test_train_state_carries_jax_fields_and_an_untouched_key():
    pm = _mlp(fft)
    st = pm.init(seed=5, device="cpu")
    assert [f for f in st.__dataclass_fields__] == \
        ["params", "opt_state", "bn_state", "rng", "step"]
    assert st.bn_state == {}
    np.testing.assert_array_equal(st.rng.numpy(),
                                  np.asarray(jax.random.PRNGKey(5)))
    key = st.rng.clone()
    st2, _ = pm.train_step(st, *_mlp_batch())
    assert torch.equal(st2.rng, key)  # no stochastic op: the key stays
    kept, _ = pm.train_step(st2, *_mlp_batch(), donate=False)
    assert kept.rng is not st2.rng and torch.equal(kept.rng, key)
    c = st2.clone()
    assert c.rng is not st2.rng and torch.equal(c.rng, st2.rng)


# ------------------------------------------------------------ Adam
@pytest.mark.parametrize("adam", ["dense", "lazy"])
def test_adam_npz_checkpoint_crosses_both_ways_bit_for_bit(tmp_path, adam):
    """A JAX Adam state after one step (dense Adam, or lazy Adam's row
    moments) restores in the port with ``m`` and ``v`` bit for bit; the
    port saves it back as the same npz bytes and meta.json, which the JAX
    package restores bit for bit; and the port steps the restored state
    as it steps the bridged one."""
    jm, pm = _dlrm(ffj, adam=adam), _dlrm(fft, adam=adam)
    js = _jax_trained(jm, _dlrm_batch)
    assert set(js.opt_state) == {"step", "lr", "m", "v"}
    jp = jckpt.save_checkpoint(str(tmp_path / "j"), js, use_orbax=False,
                               model=jm)
    pm.init(seed=0, device="cpu")
    ps = restore_checkpoint(jp, pm)
    _assert_states_bits(ps, js)
    assert ps.opt_state["m"]["emb"]["embedding"].dtype == torch.float32
    assert bool(ps.opt_state["v"]["emb"]["embedding"].any())
    pp = save_checkpoint(str(tmp_path / "p"), ps, model=pm)
    a = np.load(os.path.join(jp, "state.npz"))
    b = np.load(os.path.join(pp, "state.npz"))
    assert a.files == b.files and "opt_state/m/emb/embedding" in a.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert open(os.path.join(jp, "meta.json"), "rb").read() == \
        open(os.path.join(pp, "meta.json"), "rb").read()
    _assert_states_bits(ps, jckpt.restore_checkpoint(pp, jm))
    ref = state_from_jax(jax.tree.map(np.asarray, js))
    _, x = pm.train_step(ps, *_dlrm_batch(2))
    _, y = pm.train_step(ref, *_dlrm_batch(2))
    assert float(x["loss"]) == float(y["loss"])


def test_lazy_adam_fit_killed_and_resumed_equals_uninterrupted(tmp_path):
    """A lazy-Adam ``fit`` over 2 epochs x 8 shuffled batches, saving
    every 4 steps, killed at step 10 and resumed from its step-8
    checkpoint, equals the same run uninterrupted bit for bit: the loss
    of every step, the parameters and both moment tables."""
    from dlrm_flexflow_tpu_torch.data.loader import (ArrayDataLoader,
                                                     SyntheticDLRMLoader)
    from dlrm_flexflow_tpu_torch.resilience import (CheckpointManager,
                                                    Preemption, faultinject)

    def loader():
        base = SyntheticDLRMLoader(8 * BATCH, 13, TABLES, 1, BATCH, seed=3)
        return ArrayDataLoader(base.inputs, base.labels, BATCH, shuffle=True,
                               seed=2)

    def run(root, **kw):
        m = _dlrm(fft, adam="lazy")
        assert [op.name for op in m._sparse_ops] == ["emb"]
        st, _ = m.fit(m.init(seed=0, device="cpu"), loader(), epochs=2,
                      verbose=False, checkpoint_every_n_steps=4,
                      checkpoint_manager=CheckpointManager(
                          str(tmp_path / root), use_orbax=False), **kw)
        return m, st

    faultinject.clear()
    faultinject.install("preempt@step=10")
    try:
        with pytest.raises(Preemption):
            run("ck")
    finally:
        faultinject.clear()
    resumed, rs = run("ck", resume=True)
    twin, ts = run("twin")
    assert resumed._fit_loss_steps[0] == 9  # the step-8 checkpoint + 1
    ref = dict(zip(twin._fit_loss_steps.tolist(),
                   twin._fit_loss_trace.tolist()))
    assert len(ref) == 16
    for step, loss in zip(resumed._fit_loss_steps.tolist(),
                          resumed._fit_loss_trace.tolist()):
        assert ref[step] == loss
    for a, b in zip(jax.tree_util.tree_leaves((rs.params, rs.opt_state)),
                    jax.tree_util.tree_leaves((ts.params, ts.opt_state))):
        assert torch.equal(a, b)
    assert int(rs.step) == int(ts.step) == 16
