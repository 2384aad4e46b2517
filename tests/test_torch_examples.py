"""The repo's example scripts on the port (``dlrm_flexflow_tpu_torch/
examples/``) against the JAX scripts (``examples/*.py``), on the CPU.

Each port module is run through its ``main(argv, device="cpu")`` and
each JAX script in this process as its command runs it (``runpy``), on
the same inputs: the same command line, the same printed lines, and the
same numbers within the tolerances below.  Weights cross from the JAX
script's model to the port's through ``bridge.py``.  The three examples
that build a mesh over the rank group run in one 4-rank gloo group
(rank bodies in ``tests/torch_examples_ranks.py``, which import no JAX)
at cut table sizes, each against the JAX script on a JAX mesh of the
same shape, {"data": 2, "model": 2} and {"data": 2, "seq": 2} (the ring
of two).  Tolerances: the ranks' parameters within 1e-6 of JAX's
(``tests/test_torch_scaleout.py``), the ring's loss rtol 1e-5 and its
parameters rtol 1e-5 / atol 1e-6 (``tests/test_torch_seq_parallel.py``)
wherever Adam's step resolves the gradient, the bf16 Criteo epoch's loss
rtol 1e-3 and each op's weights within 1e-5 of its largest magnitude,
``torch_import``'s step rtol 1e-3 and its forward 1e-5 of the torch
module's, ``keras_mnist_style``'s ``evaluate`` 1e-5.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import importlib
import io
import os
import re
import runpy
import sys
import threading

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps import dlrm as japp
from dlrm_flexflow_tpu.data import loader as jloader
from dlrm_flexflow_tpu.frontends import keras as jkeras
from dlrm_flexflow_tpu.parallel.parallel_config import Strategy as JStrategy

from dlrm_flexflow_tpu_torch import distributed as fdist
from dlrm_flexflow_tpu_torch.apps import dlrm as papp
from dlrm_flexflow_tpu_torch.bridge import params_from_jax, params_to_numpy
from dlrm_flexflow_tpu_torch.frontends import keras as pkeras
from dlrm_flexflow_tpu_torch.model import FFModel
from dlrm_flexflow_tpu_torch.parallel.parallel_config import Strategy

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
import torch_examples_ranks as ranks  # noqa: E402

JAX_EXAMPLES = os.path.join(REPO, "examples")
PORT_EXAMPLES = os.path.join(REPO, "dlrm_flexflow_tpu_torch", "examples")
NAMES = sorted(f[:-3] for f in os.listdir(JAX_EXAMPLES) if f.endswith(".py"))
FORBIDDEN = ("jax", "jaxlib", "dlrm_flexflow_tpu", "flexflow")
WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the gloo ranks and the other workers of the
    suite share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(name):
    return importlib.import_module(f"dlrm_flexflow_tpu_torch.examples.{name}")


def np_tree(t):
    return {op: {k: np.array(v) for k, v in d.items()}
            for op, d in t.items()}


def jax_script(name, *, main_argv=None):
    """Run ``examples/<name>.py`` in this process and return what it
    printed: as its own command runs it, or with ``main_argv`` through
    its ``main``."""
    buf = io.StringIO()
    path = os.path.join(JAX_EXAMPLES, f"{name}.py")
    with contextlib.redirect_stdout(buf):
        if main_argv is None:
            runpy.run_path(path, run_name="__main__")
        else:
            runpy.run_path(path, run_name=f"jax_{name}")["main"](main_argv)
    return buf.getvalue()


def port_main(name, argv=()):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port(name).main(list(argv), device="cpu")
    return buf.getvalue()


@contextlib.contextmanager
def jax_recorded(mp, rec, *methods):
    """The JAX model's initial parameters (``init``) and its parameters and
    metrics after each of ``methods`` into ``rec``."""
    init = ffj.FFModel.init

    def recorded_init(self, *a, **k):
        st = init(self, *a, **k)
        rec["p0"] = np_tree(st.params)
        return st
    mp.setattr(ffj.FFModel, "init", recorded_init)
    for name in methods:
        real = getattr(ffj.FFModel, name)

        def wrapped(self, state, *a, _real=real, **k):
            out = _real(self, state, *a, **k)
            rec["p_end"] = np_tree(out[0].params)
            if "m" in out[0].opt_state:
                rec["m_end"] = np_tree(out[0].opt_state["m"])
            rec.setdefault("mets", []).append(out[1])
            return out
        mp.setattr(ffj.FFModel, name, wrapped)
    yield rec


@contextlib.contextmanager
def port_recorded(mp, rec, weights, *methods):
    """The port's ``init`` loads ``weights`` (the JAX model's) and the
    parameters and metrics after each of ``methods`` go into ``rec``."""
    def load(self, seed=None, *, device=None):
        return self.load_params(params_from_jax(weights), device=device)
    mp.setattr(FFModel, "init", load)
    for name in methods:
        real = getattr(FFModel, name)

        def wrapped(self, state, *a, _real=real, **k):
            out = _real(self, state, *a, **k)
            rec["p_end"] = params_to_numpy(out[0].params)
            rec.setdefault("mets", []).append(out[1])
            return out
        mp.setattr(FFModel, name, wrapped)
    yield rec


def close_to_scale(got, want, rel, what):
    """Each op's weights within ``rel`` of the op's largest weight
    magnitude in ``want`` (a zero-initialised bias is only its updates)."""
    assert set(got) == set(want), what
    for op, d in want.items():
        assert set(got[op]) == set(d), (what, op)
        scale = max(float(np.max(np.abs(w))) for w in d.values())
        for k, w in d.items():
            g = np.asarray(got[op][k], np.float64)
            w = np.asarray(w, np.float64)
            assert g.shape == w.shape, (what, op, k)
            err = float(np.max(np.abs(g - w))) if w.size else 0.0
            assert err <= rel * scale, (what, op, k, err, scale)


# ------------------------------------------------------------- the modules
def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def _uses_argparse(path):
    src = open(path).read()
    return "argparse" in src or "add_argument" in src


def test_one_port_module_per_jax_script():
    mods = sorted(f[:-3] for f in os.listdir(PORT_EXAMPLES)
                  if f.endswith(".py") and f != "__init__.py")
    assert mods == NAMES and len(NAMES) == 8


@pytest.mark.parametrize("name", NAMES + ["__init__"])
def test_module_imports_neither_jax_nor_the_jax_package(name):
    got = [m for m in _imports(os.path.join(PORT_EXAMPLES, f"{name}.py"))
           if m.split(".")[0] in FORBIDDEN]
    assert not got, f"{name} imports {got}"


def _parser(mp, main, argv):
    """The parser ``main`` builds, caught at its ``parse_args``."""
    seen = []

    class Caught(Exception):
        pass

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise Caught
    mp.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught):
        main(argv)
    return seen[0]


def _options(parser):
    return [(a.option_strings, a.dest, a.default, a.help, a.type, a.nargs)
            for a in parser._actions]


@pytest.mark.parametrize("name", NAMES)
def test_module_takes_the_jax_scripts_options(monkeypatch, name):
    """``dlrm_criteo`` parses exactly the JAX script's options (names,
    defaults, help, types) under its description; no other module, like
    no other script, parses any."""
    jpath = os.path.join(JAX_EXAMPLES, f"{name}.py")
    ppath = os.path.join(PORT_EXAMPLES, f"{name}.py")
    if name != "dlrm_criteo":
        assert not _uses_argparse(jpath) and not _uses_argparse(ppath)
        return
    jmain = runpy.run_path(jpath, run_name="jax_dlrm_criteo")["main"]
    want = _parser(monkeypatch, jmain, [])
    got = _parser(monkeypatch,
                  lambda argv: port(name).main(argv, device="cpu"), [])
    assert got.description == want.description
    assert _options(got) == _options(want)


# ----------------------------------------------------------- dlrm_synthetic
@pytest.mark.parametrize("argv", [[], ["-b", "64", "-e", "1",
                                       "--data-size", "512"]])
def test_synthetic_forwards_the_jax_scripts_argv(monkeypatch, argv):
    """The port module hands ``apps/dlrm.py::run`` the argv the JAX script
    hands JAX's ``run`` (its default string when given none), through
    ``main(argv)`` and through its ``__main__`` block; ``run`` is the
    card's only, so ``device="cpu"`` is refused."""
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(japp, "run", lambda a: calls["jax"].append(list(a)))
    monkeypatch.setattr(papp, "run", lambda a: calls["port"].append(list(a)))
    mod = port("dlrm_synthetic")
    monkeypatch.setattr(mod, "run", papp.run)
    monkeypatch.setattr(sys, "argv", ["dlrm_synthetic.py", *argv])
    runpy.run_path(os.path.join(JAX_EXAMPLES, "dlrm_synthetic.py"),
                   run_name="__main__")
    # past the card check (run is patched: nothing reaches a device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mod.main(argv)
    mod.main()
    runpy.run_module("dlrm_flexflow_tpu_torch.examples.dlrm_synthetic",
                     run_name="__main__")
    assert calls["port"] == calls["jax"] * 3
    assert calls["jax"][0] == (argv or ["-b", "256", "-e", "2",
                                        "--arch-sparse-feature-size", "64",
                                        "--arch-mlp-bot", "64-512-512-64",
                                        "--arch-mlp-top",
                                        "576-1024-1024-1024-1",
                                        "--data-size", "4096"])
    with pytest.raises(ValueError, match="card only"):
        mod.main(argv, device="cpu")


# ------------------------------------------------------------- torch_import
def _line_value(text, prefix):
    for ln in text.splitlines():
        if ln.startswith(prefix):
            return float(ln[len(prefix):])
    raise AssertionError(f"no line {prefix!r} in:\n{text}")


def test_torch_import_matches_torch_and_the_jax_script():
    """The same torch module (one seed for both scripts' ``Net()``): the
    port's forward within 1e-5 of torch's, and its one train step's loss
    within rtol 1e-3 of the JAX script's, from the same imported
    weights; the same lines, the TPU's name replaced by the port's."""
    torch.manual_seed(5)
    want = jax_script("torch_import")
    torch.manual_seed(5)
    got = port_main("torch_import")
    assert [ln.split("=")[0] for ln in got.splitlines()] == [
        "max |port - torch| ", "one train step, loss "]
    assert [ln.split("=")[0] for ln in want.splitlines()
            if "=" in ln] == ["max |tpu - torch| ", "one train step, loss "]
    assert _line_value(got, "max |port - torch| =") <= 1e-5
    np.testing.assert_allclose(
        _line_value(got, "one train step, loss ="),
        _line_value(want, "one train step, loss ="), rtol=1e-3)


# -------------------------------------------------------- keras_mnist_style
def test_keras_mnist_style_matches_the_jax_script(monkeypatch):
    """The summary equals JAX's; ``fit``'s losses are finite (dropout's
    masks are the port's own, so the runs part); with the JAX model's
    trained weights carried in (``bridge.py``), ``evaluate`` prints
    JAX's line and returns JAX's loss within 1e-5."""
    rec = {}

    def recorded(store, module):
        real = module.BaseModel.evaluate

        def evaluate(self, x, y):
            if store == "port":
                self.state = self.ffmodel.load_params(
                    params_from_jax(rec["jax_params"]), device="cpu")
            else:
                rec["jax_params"] = np_tree(self.state.params)
            rec[store] = real(self, x, y)
            return rec[store]
        return evaluate
    monkeypatch.setattr(jkeras.BaseModel, "evaluate",
                        recorded("jax", jkeras))
    want = jax_script("keras_mnist_style")
    monkeypatch.setattr(pkeras.BaseModel, "evaluate",
                        recorded("port", pkeras))
    epochs = FFModel._train_epochs

    def train_epochs(self, *a, **k):
        out = epochs(self, *a, **k)
        rec["fit_losses"] = out[1]["loss"].numpy()
        return out
    monkeypatch.setattr(FFModel, "_train_epochs", train_epochs)
    got = port_main("keras_mnist_style")
    summary = want[:want.index("\nepoch 0")].splitlines()
    assert got.splitlines()[:len(summary)] == [
        ln for ln in summary if not ln.startswith("  return ")]
    assert got.splitlines()[-1] == want.splitlines()[-1]
    assert got.splitlines()[-1].startswith("[Metrics] accuracy: ")
    assert rec["fit_losses"].shape == (3,)
    assert np.all(np.isfinite(rec["fit_losses"]))
    assert abs(rec["port"] - rec["jax"]) <= 1e-5


# ---------------------------------------------------------- strategy_search
def _configs(strategy):
    return {k: (tuple(v.dims), v.device_type, list(v.device_ids or []))
            for k, v in strategy.configs.items()}


def test_strategy_search_exports_the_reference_wire_format(monkeypatch,
                                                           tmp_path):
    """At a budget of 60, into ``tmp_path`` through ``EXPORT_STEM``: the
    JAX script's lines, and the ``.pb`` read by the JAX package's
    ``Strategy.load`` to the configs of the port's ``.json``, which are
    the search's best."""
    mod = port("strategy_search")
    stem = str(tmp_path / "searched")
    monkeypatch.setattr(mod, "EXPORT_STEM", stem)
    found = []
    search = mod.mcmc_search

    def small(*a, **k):
        k["budget"] = 60
        found.append(search(*a, **k))
        return found[0]
    monkeypatch.setattr(mod, "mcmc_search", small)
    out = port_main("strategy_search").splitlines()
    assert re.fullmatch(r"data-parallel: \d+\.\d{3} ms/iter \(simulated\)",
                        out[0])
    assert all(ln.startswith("[search] ") for ln in out[1:-2])
    assert re.fullmatch(r"searched     : \d+\.\d{3} ms/iter", out[-2])
    assert out[-1] == f"exported {stem}.{{json,pb}}"
    best = _configs(found[0])
    assert _configs(Strategy.load(stem + ".json")) == best
    assert _configs(JStrategy.load(stem + ".pb")) == best
    assert _configs(Strategy.load(stem + ".pb")) == best


# -------------------------------------------------------------- dlrm_criteo
def _criteo_npz(path, n=128):
    rng = np.random.default_rng(3)
    np.savez(path,
             X_int=rng.integers(0, 50, size=(n, 13)).astype(np.int32),
             X_cat=np.stack([rng.integers(0, r, size=n)
                             for r in japp.KAGGLE_TABLES],
                            axis=1).astype(np.int32),
             y=rng.integers(0, 2, size=n).astype(np.int32))
    return str(path)


def test_criteo_npz_is_preprocessed_as_jax_does_and_trained(tmp_path):
    """``--npz FILE``: the ``.h5`` written beside it equals the JAX
    ``preprocess_criteo_npz``'s, dataset for dataset, and the model
    trains on it (the full Criteo-Kaggle model, one epoch)."""
    h5py = pytest.importorskip("h5py")
    src = _criteo_npz(tmp_path / "day.npz")
    want = jloader.preprocess_criteo_npz(src, str(tmp_path / "jax.h5"))
    out = port_main("dlrm_criteo", ["--npz", src, "--epochs", "1"])
    got = str(tmp_path / "day.h5")
    lines = out.splitlines()
    assert lines[:2] == [f"preprocessed {src} -> {got}",
                         f"loaded 128 samples from {got}"]
    assert re.fullmatch(r"epoch 0: loss \d\.\d{4}  accuracy \d+\.\d\d%",
                        lines[3])
    with h5py.File(got) as g, h5py.File(want) as w:
        assert set(g) == set(w) == {"X_cat", "X_int", "y"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert np.asarray(g[k]).tobytes() == np.asarray(w[k]).tobytes()


def test_criteo_zipf_epoch_matches_the_jax_script(monkeypatch):
    """The Zipf fallback at a cut size (512 samples; 26 tables of at most
    2,000 rows): the distinct-rows line equals JAX's, and one bf16
    epoch from the JAX script's initial weights agrees with JAX's,
    the loss within rtol 1e-3 and each op's weights within 1e-5 of its
    largest magnitude (the kernels within 2e-6 of their own; the
    zero-initialised biases, only their bf16-computed updates, within
    2e-4 of their own, 1e-7 of their layer's kernels)."""
    argv = ["--samples", "512", "--epochs", "1"]
    for mod, cls in ((japp, japp.DLRMConfig),
                     (port("dlrm_criteo"), papp.DLRMConfig)):
        full = mod.criteo_kaggle_config
        monkeypatch.setattr(mod, "criteo_kaggle_config",
                            lambda full=full: dataclasses.replace(
                                full(), embedding_size=list(ranks.KAGGLE_CUT)))
    with monkeypatch.context() as mp, \
            jax_recorded(mp, {}, "train_epoch") as jrec:
        want = jax_script("dlrm_criteo", main_argv=argv)
    with monkeypatch.context() as mp, \
            port_recorded(mp, {}, jrec["p0"], "train_epoch") as prec:
        got = port_main("dlrm_criteo", argv)
    assert got.splitlines()[:2] == want.splitlines()[:2]
    assert "cache active: False" in got.splitlines()[1]
    np.testing.assert_allclose(float(prec["mets"][0]["loss"]),
                               float(jrec["mets"][0]["loss"]), rtol=1e-3)
    close_to_scale(prec["p_end"], jrec["p_end"], 1e-5, "criteo epoch")


# ----------------------------------------------------- the mesh examples
class _Group(threading.Thread):
    """The rank group, launched in the background: its error, if any, is
    raised by ``join_ok``."""

    def __init__(self, **kwargs):
        super().__init__(daemon=True)
        self.kwargs, self.err = kwargs, None

    def run(self):
        try:
            fdist.launch("torch_examples_ranks:run_examples", WORLD,
                         kwargs=self.kwargs, device="cpu", timeout_s=240,
                         pythonpath=[TESTS])
        except BaseException as e:  # noqa: BLE001 — re-raised by join_ok
            self.err = e

    def join_ok(self):
        self.join()
        if self.err is not None:
            raise self.err


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The port's modules of MESH_EXAMPLES on one 4-rank gloo group, each
    from the initial weights of the JAX script run here on a JAX mesh of
    four devices at the cut sizes (its printed lines, initial and final
    parameters): each script's weights reach the waiting ranks as soon
    as its ``init`` has drawn them."""
    tmp = tmp_path_factory.mktemp("examples")
    inputs, stores = tmp / "in", tmp / "stores"
    inputs.mkdir()
    stores.mkdir()
    out = str(tmp / "out")
    ranks_group = _Group(inputs=str(inputs), out=out, stores=str(stores))
    ranks_group.start()
    ref = {}
    for name in ranks.MESH_EXAMPLES:
        method = ("train_step" if name == "long_context_ring_attention"
                  else "fit")
        with pytest.MonkeyPatch.context() as mp, \
                jax_recorded(mp, {}, method) as rec:
            mp.setattr(jax, "device_count", lambda: WORLD)
            if name == "dlrm_hybrid_strategy":
                mp.setattr(japp, "DLRMConfig",
                           ranks.hybrid_config(japp.DLRMConfig))
            elif name == "dlrm_kaggle_ragged":
                mp.setattr(japp, "KAGGLE_TABLES", list(ranks.KAGGLE_CUT))
            init = ffj.FFModel.init

            def handed_over(self, *a, _name=name, **k):
                st = init(self, *a, **k)
                part = str(inputs / f".{_name}.npz")
                np.savez(part, **ranks.flat(rec["p0"], ""))
                os.replace(part, str(inputs / f"{_name}.npz"))
                return st
            mp.setattr(ffj.FFModel, "init", handed_over)
            rec["stdout"] = jax_script(name)
        ref[name] = rec
    ranks_group.join_ok()
    got = [np.load(f"{out}.rank{r}.npz") for r in range(WORLD)]
    return ref, got


def _lines(text):
    """The printed lines a run's numbers are compared on: all but the
    throughput line, whose wall differs from run to run."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("ELAPSED TIME") and "Warning" not in ln
            and not ln.startswith("  ")]


@pytest.mark.parametrize("name", ["dlrm_hybrid_strategy",
                                  "dlrm_kaggle_ragged"])
def test_table_parallel_example_on_four_ranks_matches_jax(group, name):
    """{"data": 2, "model": 2} over four gloo ranks: every rank prints the
    JAX script's lines (the mesh, the sharding spec the port records on
    the table's block, the fused row space, each epoch's metrics), and
    its gathered parameters after ``fit`` are within 1e-6 of JAX's.  The
    one line that differs is the Kaggle model's row-sparse ops: none in
    the port under this mesh (an open gap, ROADMAP Queue C, C13)."""
    ref, got = group
    want = _lines(ref[name]["stdout"])
    assert any("sharding: PartitionSpec('model', None" in ln for ln in want)
    if name == "dlrm_kaggle_ragged":
        # open gap C13 (model.py::compile, sparse_eligible): a ragged row
        # space sharded over "model" takes the dense table gradient in
        # the port, where JAX keeps its row-sparse path; the values are
        # the same
        assert want[0].endswith("sparse fast path: ['emb']")
        want[0] = want[0].replace("['emb']", "[]")
    for r in range(WORLD):
        assert _lines(str(got[r][f"{name}/stdout"])) == want, r
        assert bool(got[r][f"{name}/left"])
        p = ranks.unflatten(got[r], f"{name}/p_end/")
        for op, d in ref[name]["p_end"].items():
            for k, v in d.items():
                np.testing.assert_allclose(p[op][k], v, rtol=0, atol=1e-6,
                                           err_msg=f"rank {r} {op}/{k}")


def test_ring_example_two_rank_ring_matches_jax(group):
    """{"data": 2, "seq": 2}: two rings of two ranks, each naming one peer
    for its send and its receive.  On every rank: the mesh line is
    JAX's, the step's loss within rtol 1e-5 of JAX's, Adam's first
    moments (a tenth of the gradient through the ring) within 1e-5 of
    each tensor's largest magnitude, and the parameters after the step
    within rtol 1e-5 / atol 1e-6 wherever that gradient is resolved:
    Adam moves a parameter by about the rate whatever the gradient's
    size, so a gradient below the comparison's resolution (1e-5 of the
    largest) may step either way."""
    ref, got = group
    name = "long_context_ring_attention"
    want = ref[name]["stdout"].splitlines()
    assert want[0] == "mesh: {'data': 2, 'seq': 2}"
    loss = float(ref[name]["mets"][0]["loss"])
    for r in range(WORLD):
        lines = str(got[r][f"{name}/stdout"]).splitlines()
        assert lines[0] == want[0]
        assert lines[1].startswith("seq 256 over 2 shards: loss=")
        np.testing.assert_allclose(float(lines[1].split("=")[1]), loss,
                                   rtol=1e-5)
        assert bool(got[r][f"{name}/left"])
        p = ranks.unflatten(got[r], f"{name}/p_end/")
        m = ranks.unflatten(got[r], f"{name}/m_end/")
        for op, d in ref[name]["p_end"].items():
            for k, v in d.items():
                jm = ref[name]["m_end"][op][k]
                res = 1e-5 * float(np.abs(jm).max())
                assert float(np.abs(m[op][k] - jm).max()) <= res, (r, op, k)
                off = ~np.isclose(p[op][k], v, rtol=1e-5, atol=1e-6)
                assert np.all(np.abs(jm[off]) <= res), (r, op, k, off.sum())


# -------------------------------------------------------- no card, no CPU
@pytest.mark.parametrize("name", NAMES)
def test_main_without_a_card_raises_before_building(monkeypatch, name):
    """Run as ``python -m`` runs it, without a card and without
    ``device="cpu"``, each module raises naming ``device='cpu'`` before
    it builds a model."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")

    def built(self, *a, **k):
        raise AssertionError(f"{name} built a model before its device check")
    monkeypatch.setattr(FFModel, "__init__", built)
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runpy.run_module(f"dlrm_flexflow_tpu_torch.examples.{name}",
                         run_name="__main__")
