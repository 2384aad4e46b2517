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
            "set_weights", "get_perf_metrics"]


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
    ``warmup``, and any callbacks raise until they are ported."""
    params = list(inspect.signature(fft.FFModel.fit).parameters)
    assert params[5] == "callbacks"
    model = _model("cat", "off", "auto")
    state = model.init(seed=0, device="cpu")
    inputs, labels = _batch(3)
    loader = fft.ArrayDataLoader(inputs, labels, BATCH)
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        model.fit(state, loader, 1, False, [object()])
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
