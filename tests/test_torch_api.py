"""The port's public API against the JAX package's, on the CPU: the
leading parameters of the ``FFModel`` methods both packages define, the
donated and kept-state forms of ``train_step``, ``fit``'s ``callbacks``
slot, and the CLI's synthetic data.  JAX is imported here only.

Every comparison is exact: names, order and defaults are compared as they
are; a state kept by ``donate=False`` must stay bit-identical and the
step must give bit-identical results in both forms (the same arithmetic
on the same tensors); the loaders' batches are data and must be equal.
"""

import inspect

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.data.loader import \
    SyntheticDLRMLoader as JaxSyntheticDLRMLoader

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm

TABLES = [64, 200, 90]
D = 16
BATCH = 16

# the public FFModel methods both packages define
_METHODS = ["fit", "train_step", "train_epoch", "train_epochs", "eval_step",
            "predict", "init", "compile", "forward", "get_weights",
            "set_weights", "get_perf_metrics", "set_learning_rate",
            "shard_batch"]


def _positional(fn):
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD]


@pytest.mark.parametrize("name", _METHODS)
def test_leading_parameters_match_jax(name):
    """A positional argument written for the JAX method lands in the
    parameter of the same name and default in the port: the port's
    positional parameters are the JAX method's first ones, in order.  The
    port may have fewer; a parameter only the port has is keyword-only."""
    port = _positional(getattr(fft.FFModel, name))
    jax_ = _positional(getattr(ffj.FFModel, name))
    assert len(port) <= len(jax_), (
        f"port-only positional parameters {[p.name for p in port]}")
    for p, j in zip(port, jax_):
        assert p.name == j.name, (name, [q.name for q in port],
                                  [q.name for q in jax_])
        assert p.default == j.default, (name, p.name)


def test_train_step_takes_slot_override_by_keyword_only():
    params = inspect.signature(fft.FFModel.train_step).parameters
    assert params["slot_override"].kind == inspect.Parameter.KEYWORD_ONLY
    assert params["donate"].default is True


def _model(interact, fused, sparse, momentum=0.0):
    t = len(TABLES)
    top0 = D + t * D if interact == "cat" else D + (t + 1) ** 2
    model = build_dlrm(
        DLRMConfig(sparse_feature_size=D, embedding_size=list(TABLES),
                   mlp_bot=[13, 32, D], mlp_top=[top0, 32, 1],
                   arch_interaction_op=interact, fused_interaction=fused),
        fft.FFConfig(batch_size=BATCH, sparse_embedding_updates=sparse))
    model.compile(optimizer=fft.SGDOptimizer(lr=0.1, momentum=momentum),
                  metrics=("accuracy", "mean_squared_error"))
    return model


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, 12, size=(BATCH, 1)) for _ in TABLES],
                   axis=1).astype(np.int64)
    return ({"dense": rng.standard_normal((BATCH, 13)).astype(np.float32),
             "sparse": ids},
            rng.integers(0, 2, size=(BATCH, 1)).astype(np.float32))


def _tensors(state):
    """Every tensor of a state, by path."""
    out = {"step": state.step}
    for op, params in state.params.items():
        for k, v in params.items():
            out[f"params/{op}/{k}"] = v
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            for op, params in v.items():
                for kk, vv in params.items():
                    out[f"opt/{k}/{op}/{kk}"] = vv
        else:
            out[f"opt/{k}"] = v
    return out


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k, v in ta.items():
        if v is None:
            assert tb[k] is None, k
        else:
            assert torch.equal(v, tb[k]), k


@pytest.mark.parametrize("interact,fused,sparse,momentum", [
    ("cat", "off", "auto", 0.0),   # the row-sparse step into the tables
    ("cat", "on", "off", 0.0),     # the dense table gradient, fused graph
    ("dot", "off", "auto", 0.9),   # momentum buffers updated in place
])
def test_train_step_donate_false_keeps_the_input_state(interact, fused,
                                                       sparse, momentum):
    """``donate=False`` leaves every tensor of the input state as it was,
    and gives the same new state and metrics as the donated step on a
    copy; ``donate=True`` (the default) still updates in place."""
    model = _model(interact, fused, sparse, momentum)
    state = model.init(seed=0, device="cpu")
    state, _ = model.train_step(state, *_batch(1))  # a step count, a v
    kept = state.clone()
    inputs, labels = _batch(2)
    new, mets = model.train_step(state, inputs, labels, False)
    _assert_same(state, kept)
    donated, dmets = model.train_step(kept, inputs, labels)
    _assert_same(new, donated)
    assert set(mets) == set(dmets)
    for k in mets:
        assert torch.equal(mets[k], dmets[k]), k
    assert donated.params["top_0"]["kernel"] is kept.params["top_0"]["kernel"]
    assert new.params["top_0"]["kernel"] is not (
        state.params["top_0"]["kernel"])


def test_fit_takes_callbacks_fifth_and_refuses_them_until_ported():
    """``fit(state, loader, epochs, verbose, callbacks)`` as in the JAX
    package: a fifth positional argument is ``callbacks``, not
    ``warmup``.  Callbacks are ported now, so ``fit`` runs them: every
    hook, in the JAX order, on the per-batch loop."""
    from dlrm_flexflow_tpu_torch.frontends.keras_callbacks import Callback
    params = list(inspect.signature(fft.FFModel.fit).parameters)
    assert params[5] == "callbacks"
    model = _model("cat", "off", "auto")
    state = model.init(seed=0, device="cpu")
    inputs, labels = _batch(3)
    loader = fft.ArrayDataLoader(inputs, labels, BATCH)

    class Hooks(Callback):
        calls = []

        def on_train_begin(self, logs=None):
            self.calls.append("train_begin")

        def on_epoch_begin(self, epoch, logs=None):
            self.calls.append(f"epoch_begin {epoch}")

        def on_batch_end(self, batch, logs=None):
            self.calls.append(f"batch_end {batch}")

        def on_epoch_end(self, epoch, logs=None):
            self.calls.append(f"epoch_end {epoch}")

        def on_train_end(self, logs=None):
            self.calls.append("train_end")

    hooks = Hooks()
    state, thpt = model.fit(state, loader, 1, False, [hooks])
    assert hooks.model is model and thpt > 0
    assert hooks.calls == ["train_begin", "epoch_begin 0", "batch_end 0",
                           "epoch_end 0", "train_end"]
    assert not model._last_fit_used_scan
    _, thpt = model.fit(state, loader, 1, False, None)
    assert thpt > 0


@pytest.mark.parametrize("seed", ["3", "0"])
def test_cli_loader_batches_equal_jax_cli_at_any_seed(seed):
    """The port's CLI data (``cli_loader``) equals the JAX CLI's
    (``dlrm_flexflow_tpu/apps/dlrm.py::run``: ``SyntheticDLRMLoader`` at
    its default seed, stacked ids): ``--seed`` seeds ``init`` only."""
    from dlrm_flexflow_tpu_torch.apps.dlrm import cli_loader
    argv = ["--seed", seed, "-b", "16", "--data-size", "80",
            "--arch-embedding-size", "100-2000-37",
            "--embedding-bag-size", "2", "--arch-mlp-bot", "13-32-16",
            "--arch-sparse-feature-size", "16"]
    ffc, cfg = fft.FFConfig.parse_args(argv), DLRMConfig.parse_args(argv)
    assert ffc.seed == int(seed)
    jffc, jcfg = JaxFFConfig.parse_args(argv), JaxDLRMConfig.parse_args(argv)
    n = jcfg.data_size if jcfg.data_size > 0 else 16 * jffc.batch_size
    want = list(JaxSyntheticDLRMLoader(
        n, jcfg.mlp_bot[0], jcfg.embedding_size, jcfg.embedding_bag_size,
        jffc.batch_size, stacked=True))
    got = list(cli_loader(cfg, ffc))
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        assert set(gx) == set(wx) == {"dense", "sparse"}
        for k in wx:
            np.testing.assert_array_equal(gx[k], np.asarray(wx[k]))
        np.testing.assert_array_equal(gy, np.asarray(wy))


# ------------------------------------------- every public name both define
def _modules(pkg):
    import pkgutil
    out = {"": pkg.__name__}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[m.name[len(pkg.__name__) + 1:]] = m.name
    return out


def _public_pairs():
    """(id, port callable, JAX callable) for every public function and
    class defined in a module of the same path in both packages, and every
    public method of such a class that both define."""
    import importlib
    jmods, pmods = _modules(ffj), _modules(fft)
    pairs = []
    for rel in sorted(set(jmods) & set(pmods)):
        if rel.startswith("tools") or rel.endswith("__main__"):
            continue
        jm = importlib.import_module(jmods[rel])
        pm = importlib.import_module(pmods[rel])
        for name, obj in sorted(vars(pm).items()):
            if name.startswith("_") or not (inspect.isfunction(obj)
                                            or inspect.isclass(obj)):
                continue
            jo = getattr(jm, name, None)
            if (getattr(obj, "__module__", None) != pm.__name__
                    or getattr(jo, "__module__", None) != jm.__name__):
                continue
            pairs.append((f"{rel}:{name}", obj, jo))
            if inspect.isclass(obj):
                for mname in sorted(vars(obj)):
                    jattr = getattr(jo, mname, None)
                    if mname.startswith("_") or not callable(jattr):
                        continue
                    pattr = getattr(obj, mname)
                    if inspect.isfunction(pattr) or inspect.ismethod(pattr):
                        pairs.append((f"{rel}:{name}.{mname}", pattr, jattr))
    return pairs


_PAIRS = _public_pairs()

#: by-design differences, each with its reason
_ALLOWED = {
    "ops.base:Op.init_params":
        "draws from a torch.Generator where the JAX op takes a PRNG key: "
        "the JAX RNG cannot be replayed in torch, so parameters cross by "
        "value (bridge.py) and the tests never re-initialise",
}


#: public classes renamed by design: JAX name -> (port name, reason); the
#: port's class keeps every public method of the JAX one, with the same
#: leading parameters
_RENAMED = {
    "sim.cost_model:TPUMachineModel": (
        "H100MachineModel",
        "the machine model prices an H100 SXM5 (data-sheet constants): its "
        "link fields are NVLink's and InfiniBand's (nvlink_bandwidth, "
        "nvlink_links_per_gpu, ib_bandwidth for ici_bandwidth, "
        "ici_links_per_chip, dcn_bandwidth); the methods keep the JAX "
        "names (ici_time prices NVLink, dcn_time InfiniBand)"),
}


@pytest.mark.parametrize("name", sorted(_RENAMED))
def test_renamed_classes_keep_the_jax_methods(name):
    import importlib
    rel, jname = name.split(":")
    pname, _ = _RENAMED[name]
    jm = importlib.import_module(f"dlrm_flexflow_tpu.{rel}")
    pm = importlib.import_module(f"dlrm_flexflow_tpu_torch.{rel}")
    jcls, pcls = getattr(jm, jname), getattr(pm, pname)
    assert not hasattr(pm, jname)
    methods = [m for m in vars(jcls) if not m.startswith("__")
               and callable(getattr(jcls, m))]
    assert methods
    for m in methods:
        p, j = _leading(getattr(pcls, m)), _leading(getattr(jcls, m))
        assert [(a.name, a.default) for a in p] == \
            [(b.name, b.default) for b in j], m


def _same_default(p, j):
    """Equal defaults; a JAX dtype default and a torch dtype default of
    the same name are the same default (the packages' dtype objects)."""
    if p is j:
        return True
    if isinstance(p, torch.dtype):
        try:
            return str(p) == f"torch.{np.dtype(j).name}"
        except TypeError:
            return False
    try:
        return bool(p == j)
    except Exception:  # noqa: BLE001 — incomparable defaults differ
        return False


def _leading(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_public_pairs_cover_the_ported_modules():
    names = {n for n, _, _ in _PAIRS}
    assert len(names) == len(_PAIRS) > 300
    for must in ("config:FFConfig", "serving.engine:InferenceEngine",
                 "model:FFModel.place_dataset", "serving.router:ReplicaRouter",
                 "storage.tiered:TieredEmbeddingTable",
                 "ops.kernel_costs:tiered_storage_wins",
                 "storage.policy:make_policy", "sim.search:mcmc_search",
                 "sim.simulator:Simulator",
                 "parallel.parallel_config:Strategy",
                 "model:FFModel.compile"):
        assert must in names, must
    assert set(_ALLOWED) <= names


@pytest.mark.parametrize("name,port,jax_", _PAIRS, ids=[n for n, _, _ in _PAIRS])
def test_public_leading_parameters_match_jax(name, port, jax_):
    """Every public function, class and method both packages define: a
    positional argument written for the JAX one lands in the parameter of
    the same name and default in the port (the port's positional
    parameters are the JAX ones' first, in order; a parameter only the
    port has is keyword-only), except the differences by design in
    ``_ALLOWED``."""
    p, j = _leading(port), _leading(jax_)
    if p is None or j is None:
        assert p is None and j is None, name
        return
    drift = (len(p) > len(j)
             or any(a.name != b.name or not _same_default(a.default,
                                                           b.default)
                    for a, b in zip(p, j)))
    if name in _ALLOWED:
        assert drift, f"{name} no longer differs: drop it from _ALLOWED"
        return
    assert not drift, (name, [(a.name, a.default) for a in p],
                       [(b.name, b.default) for b in j])


# ------------------------------------------------ the three repaired faults
def test_ffconfig_positional_call_written_for_jax_raises():
    """JAX ``FFConfig(1, 64, 1, 0.01)`` sets ``iterations=1``; the port
    lacks ``iterations``, so every field after ``batch_size`` is
    keyword-only and the call raises instead of setting
    ``learning_rate=1``."""
    assert JaxFFConfig(1, 64, 1, 0.01).learning_rate == 0.01
    with pytest.raises(TypeError):
        fft.FFConfig(1, 64, 1, 0.01)
    cfg = fft.FFConfig(2, 32, learning_rate=0.5, storage_hot_rows=512)
    assert (cfg.epochs, cfg.batch_size, cfg.learning_rate,
            cfg.storage_hot_rows) == (2, 32, 0.5, 512)
    assert fft.FFConfig().storage_hot_rows == JaxFFConfig().storage_hot_rows
    argv = ["--serve-storage", "tiered", "--storage-hot-rows", "96"]
    got, want = fft.FFConfig.parse_args(argv), JaxFFConfig.parse_args(argv)
    assert (got.serve_storage, got.storage_hot_rows) == \
        (want.serve_storage, want.storage_hot_rows) == ("tiered", 96)


def test_engine_takes_aot_fourth_and_aot_false_keeps_warmup_without_capture():
    """``InferenceEngine(m, s, None, False)``: ``aot=False`` as in the JAX
    package; warmup still builds every bucket's runner (one eager run
    each) and none of them captures a graph; the answers equal the
    graphed engine's."""
    from dlrm_flexflow_tpu_torch.serving import InferenceEngine
    model = _model("cat", "on", "auto")
    state = model.init(seed=0, device="cpu")
    names = list(inspect.signature(InferenceEngine).parameters)
    assert names[:8] == ["model", "params_or_state", "buckets", "aot",
                         "warmup", "stats", "quantize", "storage"]
    assert inspect.signature(InferenceEngine).parameters["device"].kind == \
        inspect.Parameter.KEYWORD_ONLY
    old_default = fft.FFConfig().serve_buckets
    eager = InferenceEngine(model, state, None, False, device="cpu")
    graphed = InferenceEngine(model, state, device="cpu")
    assert eager.buckets == graphed.buckets == [
        int(b) for b in old_default.split(",")]
    assert sorted(eager._graphs) == eager.buckets  # the warmup ran
    assert not any(r.capture for r in eager._graphs.values())
    assert all(r.capture for r in graphed._graphs.values())
    inputs, _ = _batch(4)
    np.testing.assert_array_equal(eager.predict(inputs),
                                  graphed.predict(inputs))


def test_place_dataset_defaults_to_the_models_device():
    """``place_dataset(inputs, labels)`` as in the JAX package: the
    device is keyword-only and defaults to the model's."""
    params = inspect.signature(fft.FFModel.place_dataset).parameters
    assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY
    model = _model("cat", "off", "auto")
    model.init(seed=0, device="cpu")
    inputs, labels = _batch(5)
    stacked = {k: v[None] for k, v in inputs.items()}
    x, y = model.place_dataset(stacked, labels[None])
    assert {t.device.type for t in x.values()} == {"cpu"}
    assert y.device.type == "cpu" and tuple(y.shape) == (1, BATCH, 1)
    np.testing.assert_array_equal(x["sparse"].numpy(), stacked["sparse"])
    x2, _ = model.place_dataset(stacked, labels[None], device="cpu")
    np.testing.assert_array_equal(x2["dense"].numpy(), stacked["dense"])
