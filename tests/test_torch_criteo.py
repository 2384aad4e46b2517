"""The port's Criteo reader and preprocessor (``data/loader.py``) and the
DLRM CLI's ``--dataset`` against the JAX package's, on the CPU, on small
HDF5 and npz files each test writes itself.  Arrays are compared byte
for byte, with their dtypes and shapes.  JAX is imported here only.
"""

import functools
import importlib.util
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from dlrm_flexflow_tpu.data import loader as jloader  # noqa: E402

import dlrm_flexflow_tpu_torch as fft  # noqa: E402
from dlrm_flexflow_tpu_torch.apps import dlrm as papp  # noqa: E402
from dlrm_flexflow_tpu_torch.data import loader as ploader  # noqa: E402

N, T, DENSE = 48, 3, 13
TABLES = [30, 20, 12]


def _npz(path):
    """A raw Criteo-style npz: int32 counts (some 0), int32 categorical
    ids, int32 labels."""
    rng = np.random.default_rng(0)
    np.savez(path, X_int=rng.integers(0, 50, size=(N, DENSE)).astype(np.int32),
             X_cat=np.stack([rng.integers(0, r, size=N) for r in TABLES],
                            axis=1).astype(np.int32),
             y=rng.integers(0, 2, size=N).astype(np.int32))
    return str(path)


@pytest.fixture(scope="module")
def h5file(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo")
    return jloader.preprocess_criteo_npz(_npz(d / "day.npz"),
                                         str(d / "day.h5"))


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("stacked", [False, True])
def test_load_criteo_h5_equals_jax(h5file, stacked):
    """Both layouts: ``sparse`` (N, T, 1) stacked or ``sparse_<i>`` (N, 1)
    per table, ``dense`` f32, labels f32 (N, 1)."""
    gx, gy = ploader.load_criteo_h5(h5file, stacked=stacked)
    wx, wy = jloader.load_criteo_h5(h5file, stacked=stacked)
    _same(gx, wx)
    _same({"y": gy}, {"y": wy})
    assert gy.shape == (N, 1) and gx["dense"].dtype == np.float32
    assert ("sparse" in gx) == stacked


def test_preprocess_criteo_npz_equals_jax(tmp_path):
    """``preprocess_criteo_npz`` and its ``-i``/``-o`` entry write the JAX
    file's datasets: X_cat int64, X_int log(x + 1) f32, y f32."""
    src = _npz(tmp_path / "in.npz")
    want = jloader.preprocess_criteo_npz(src, str(tmp_path / "j.h5"))
    got = ploader.preprocess_criteo_npz(src, str(tmp_path / "p.h5"))
    assert got == str(tmp_path / "p.h5")
    ploader._preprocess_main(["-i", src, "-o", str(tmp_path / "m.h5")])
    with h5py.File(want, "r") as w:
        for path in (got, str(tmp_path / "m.h5")):
            with h5py.File(path, "r") as g:
                _same({k: g[k][()] for k in g}, {k: w[k][()] for k in w})


def test_loader_module_imports_without_h5py(monkeypatch, tmp_path):
    """h5py is imported by the reader only: the module imports without it
    (the card's machine has none), and the reader then raises the
    ImportError that names h5py."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    spec = importlib.util.spec_from_file_location("loader_without_h5py",
                                                  ploader.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(ImportError, match="h5py"):
        mod.load_criteo_h5(str(tmp_path / "absent.h5"))


def _cli_argv(h5file):
    return ["-b", "16", "-e", "1", "--dataset", h5file,
            "--arch-embedding-size", "-".join(map(str, TABLES)),
            "--arch-sparse-feature-size", "8", "--arch-mlp-bot", "13-16-8",
            "--arch-mlp-top", f"{8 + T * 8}-16-1"]


def test_cli_dataset_trains_on_the_file(monkeypatch, h5file):
    """``run(["--dataset", FILE, ...])`` trains on the HDF5 file in the
    graph's (stacked) ids layout: the batches ``fit`` sees are the JAX
    reader's, in order, and the model takes a step per batch.  (The CLI
    places the model on the card; here ``init`` is sent to the CPU.)"""
    seen = {}
    init, fit = fft.FFModel.init, fft.FFModel.fit
    monkeypatch.setattr(fft.FFModel, "init",
                        functools.partialmethod(init, device="cpu"))

    def spy(self, state, loader, *a, **k):
        seen["batches"] = list(loader)
        seen["model"] = self
        out = fit(self, state, loader, *a, **k)
        seen["steps"] = int(out[0].step)
        return out
    monkeypatch.setattr(fft.FFModel, "fit", spy)
    thpt = papp.run(_cli_argv(h5file))
    assert thpt > 0 and seen["model"]._dlrm_stacked
    wx, wy = jloader.load_criteo_h5(h5file, stacked=True)
    want = list(jloader.ArrayDataLoader(wx, wy, 16))
    assert len(seen["batches"]) == len(want) == N // 16
    for (gx, gy), (jx, jy) in zip(seen["batches"], want):
        _same(gx, jx)
        _same({"y": gy}, {"y": jy})
    assert seen["steps"] == N // 16 + 1  # the warmup step and the epoch


def test_cli_dataset_without_h5py_names_it(monkeypatch, h5file):
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(fft.FFModel, "init", functools.partialmethod(
        fft.FFModel.init, device="cpu"))
    with pytest.raises(ImportError, match="h5py"):
        papp.run(_cli_argv(h5file))
