"""The port's serving slice (dlrm_flexflow_tpu_torch) against the JAX
package on the CPU: Linear/matmul, the whole fused DLRM served by both
InferenceEngines on transferred weights, the port's padding contract,
its DynamicBatcher, the weight bridge, the device rule and import
hygiene.  JAX is imported here only; the port imports none of it."""

import ast
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.ops import base as jbase
from dlrm_flexflow_tpu.ops.linear import Linear as JaxLinear
from dlrm_flexflow_tpu.serving import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.serving.stats import LatencyStats as JaxStats
from dlrm_flexflow_tpu.tensor import Tensor as JaxTensor

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import params_from_jax
from dlrm_flexflow_tpu_torch.ops import base as tbase
from dlrm_flexflow_tpu_torch.ops.fused_interact_kernel import \
    fused_interact_cuda
from dlrm_flexflow_tpu_torch.ops.linear import Linear
from dlrm_flexflow_tpu_torch.serving import (DynamicBatcher, InferenceEngine,
                                             LatencyStats, Rejected)
from dlrm_flexflow_tpu_torch.tensor import Tensor

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dlrm_flexflow_tpu_torch"
TABLES = [40, 24, 32, 1000, 7, 300, 64, 500]
D = 16
BUCKETS = "1,8,64"


# ------------------------------------------------------------ Linear/matmul
def _x_w(seed, m=37, k=29, n=23):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((n,)).astype(np.float32))


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_matmul_matches_jax(cd):
    x, w, _ = _x_w(0)
    got = tbase.matmul(torch.from_numpy(x), torch.from_numpy(w), cd)
    want = np.asarray(jbase.matmul(jnp.asarray(x), jnp.asarray(w), cd))
    assert got.dtype == torch.float32
    # f32 sums in another order (the port accumulates in f64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bf16_matmul_returns_f32_not_rounded_bf16():
    """bf16 operands, f32 result: the output keeps bits that a bf16
    result would round away, and torch.matmul on bf16 tensors (which
    rounds its result to bf16) is NOT what the JAX package computes."""
    x, w, _ = _x_w(1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = tbase.matmul(xt, wt, "bfloat16")
    want = np.asarray(jbase.matmul(jnp.asarray(x), jnp.asarray(w),
                                   "bfloat16"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert not torch.equal(got, got.to(torch.bfloat16).float())
    rounded = torch.matmul(xt.bfloat16(), wt.bfloat16()).float().numpy()
    assert not np.allclose(rounded, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "sigmoid", None])
def test_linear_matches_jax(cd, act):
    x, w, b = _x_w(2)
    jop = JaxLinear("fc", JaxTensor(x.shape, jnp.float32), w.shape[1], act,
                    compute_dtype=cd)
    pop = Linear("fc", Tensor(x.shape, torch.float32), w.shape[1], act,
                 compute_dtype=cd)
    assert [(s.param_name, s.shape) for s in pop.param_specs()] == \
        [(s.param_name, s.shape) for s in jop.param_specs()]
    (want,) = jop.forward({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                          [jnp.asarray(x)])
    (got,) = pop.forward({"kernel": torch.from_numpy(w),
                          "bias": torch.from_numpy(b)}, [torch.from_numpy(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["relu", "sigmoid", "tanh", "elu", "gelu",
                                  "exp", "softmax", "identity", "none"])
def test_activation_fn_matches_jax(name):
    x = np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32)
    want = np.asarray(jbase.activation_fn(name)(jnp.asarray(x)))
    got = tbase.activation_fn(name)(torch.from_numpy(x)).numpy()
    # elementwise transcendental functions round differently per library
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


# ------------------------------------------------------- the slice vs JAX
def _dlrm_cfg(cls):
    return cls(sparse_feature_size=D, embedding_size=list(TABLES),
               mlp_bot=[13, 64, D], mlp_top=[D + len(TABLES) * D, 64, 32, 1],
               arch_interaction_op="cat", fused_interaction="on")


def _ffcfg(cls, cd):
    return cls(batch_size=64, compute_dtype=cd, serve_buckets=BUCKETS)


def _jax_model(cd):
    m = jax_build_dlrm(_dlrm_cfg(JaxDLRMConfig), _ffcfg(JaxFFConfig, cd))
    m.compile(optimizer=ffj.SGDOptimizer(lr=0.01),
              loss_type="mean_squared_error", metrics=(), mesh=False)
    return m


def _port_model(cd):
    return build_dlrm(_dlrm_cfg(DLRMConfig), _ffcfg(fft.FFConfig, cd)
                      ).compile(mesh=False)


@pytest.fixture(scope="module")
def served():
    """Both packages' engines on the same weights (JAX init(seed=0),
    transferred by params_from_jax): f32 and bf16 compute, the JAX side
    on its CPU emitter path and, at f32, on the Pallas kernel in
    interpret mode."""
    out = {}
    for cd in ("float32", "bfloat16"):
        jm = _jax_model(cd)
        state = jm.init(seed=0)
        np_params = jax.tree.map(np.asarray, state.params)
        pm = _port_model(cd)
        pstate = pm.load_params(params_from_jax(np_params), device="cpu")
        out[cd, "port"] = (pm, pstate, InferenceEngine(pm, pstate,
                                                       device="cpu"))
        out[cd, "emitter"] = JaxEngine(jm, state)
        if cd == "float32":
            jk = _jax_model(cd)
            jk.get_op("emb")._interpret = True  # before warmup traces
            out[cd, "kernel"] = JaxEngine(jk, state)
        out[cd, "np_params"] = np_params
    return out


def _request(n, seed):
    """n rows of dense features and (n, 8, 1) local ids, a few of them
    dropped (negative, or past their table's end)."""
    rng = np.random.default_rng(seed)
    sparse = np.stack([rng.integers(0, r, size=(n, 1)) for r in TABLES],
                      axis=1).astype(np.int64)
    sparse[rng.random((n, len(TABLES), 1)) < 0.1] = -1
    sparse[0, 3, 0] = TABLES[3] + 7
    if n > 2:
        sparse[2, 5, 0] = -4
    return {"dense": rng.standard_normal((n, 13)).astype(np.float32),
            "sparse": sparse}


@pytest.mark.parametrize("cd,jax_path,tol", [
    # f32: only the MLP matmuls' sum order differs
    ("float32", "emitter", (1e-5, 1e-6)),
    ("float32", "kernel", (1e-5, 1e-6)),
    # bf16 compute: a one-ulp difference in a bf16 operand (from an f32
    # input that differs in its last bit) can propagate through the
    # next layers' bf16 rounding
    ("bfloat16", "emitter", (2e-2, 2e-3)),
])
@pytest.mark.parametrize("n", [1, 3, 40, 100])  # 100 is chunked by 64
def test_slice_matches_jax_engine(served, cd, jax_path, tol, n):
    req = _request(n, seed=n)
    before = fused_interact_cuda.launches
    got = served[cd, "port"][2].predict(req)
    want = np.asarray(served[cd, jax_path].predict(req))
    assert got.shape == want.shape == (n, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])
    assert fused_interact_cuda.launches == before  # CPU: no kernel


def test_padding_is_bit_identical(served):
    """The first n rows of a padded bucket equal the unpadded forward."""
    pm, pstate, engine = served["float32", "port"]
    for n in (1, 2, 3, 5, 7, 40):
        req = _request(n, seed=100 + n)
        unpadded = pm.predict(pstate, req).numpy()
        np.testing.assert_array_equal(engine.predict(req), unpadded)
        assert engine.bucket_for(n) >= n


def test_params_from_jax_identical(served):
    np_params = served["float32", "np_params"]
    ported = params_from_jax(np_params)
    pstate = served["float32", "port"][1]
    assert set(ported) == set(np_params) == set(pstate.params)
    assert set(np_params) == {"bot_0", "bot_1", "emb", "top_0", "top_1",
                              "top_2"}
    for op, params in np_params.items():
        assert set(ported[op]) == set(params)
        for k, v in params.items():
            assert tuple(ported[op][k].shape) == v.shape
            np.testing.assert_array_equal(ported[op][k].numpy(), v)
            np.testing.assert_array_equal(pstate.params[op][k].numpy(), v)


def test_batcher_results_equal_direct_predict(served):
    engine = served["float32", "port"][2]
    reqs = {(c, i): _request(1 + (c + i) % 3, seed=1000 + 16 * c + i)
            for c in range(6) for i in range(8)}
    got = {}
    with DynamicBatcher(engine, max_wait_us=2000.0) as batcher:
        def client(c):
            futs = [(i, batcher.submit(reqs[c, i])) for i in range(8)]
            for i, f in futs:
                got[c, i] = f.result(timeout=60)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    assert set(got) == set(reqs)
    for key, req in reqs.items():
        np.testing.assert_array_equal(got[key], engine.predict(req))
    assert batcher.stats.count == len(reqs)


def test_batcher_rejects_on_full_queue_and_close_drains(served):
    engine = served["float32", "port"][2]
    batcher = DynamicBatcher(engine, queue_depth=2, autostart=False)
    futs = [batcher.submit(_request(1, seed=s)) for s in (1, 2)]
    with pytest.raises(Rejected):
        batcher.submit(_request(1, seed=3))
    summary = batcher.close()  # starts the dispatcher and drains
    for s, f in zip((1, 2), futs):
        np.testing.assert_array_equal(f.result(timeout=60),
                                      engine.predict(_request(1, seed=s)))
    assert summary["requests"] == 2 and summary["rejected"] == 1
    with pytest.raises(Rejected):
        batcher.submit(_request(1, seed=4))


# ------------------------------------------------------- smaller contracts
def test_latency_stats_match_jax():
    lats = np.random.default_rng(4).exponential(800.0, size=500)
    jst, pst = JaxStats(), LatencyStats()
    for v in lats:
        jst.record(v)
        pst.record(v)
    for b, v in zip([1, 8, 8, 64] * 20, lats):
        jst.record_dispatch(bucket=b, lat_us=v)
        pst.record_dispatch(bucket=b, lat_us=v)
    js, ps = jst.summary(wall_s=2.0), pst.summary(wall_s=2.0)
    assert js == ps
    assert jst.bucket_histograms() == pst.bucket_histograms()
    for p in (50, 99):
        assert jst.bucket_percentile(8, p) == pst.bucket_percentile(8, p)


def test_config_flags_match_jax():
    argv = ["-b", "128", "--seed", "3", "--compute-dtype", "bfloat16",
            "--serve-buckets", "2,16", "--serve-max-wait-us", "500",
            "--serve-queue-depth", "9", "--arch-embedding-size", "5-6-7",
            "--arch-interaction-op", "dot", "--fused-interaction", "on",
            "--arch-mlp-bot", "13-8", "--embedding-bag-size", "2"]
    pc, jc = fft.FFConfig.parse_args(argv), JaxFFConfig.parse_args(argv)
    for f in ("batch_size", "seed", "compute_dtype", "serve_buckets",
              "serve_max_wait_us", "serve_queue_depth", "serve_max_batch"):
        assert getattr(pc, f) == getattr(jc, f), f
    pd, jd = DLRMConfig.parse_args(argv), JaxDLRMConfig.parse_args(argv)
    assert pd == DLRMConfig(**{k: getattr(jd, k)
                               for k in DLRMConfig.__dataclass_fields__})


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    pm = _port_model("float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.init()
    state = pm.init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(pm, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port_model("float32").load_params(state.params)


def test_unported_paths_raise_not_implemented():
    pm = _port_model("float32")
    state = pm.init(seed=0, device="cpu")
    # the mesh is ported: compile takes a parallel.mesh.Mesh only
    with pytest.raises(TypeError, match="make_mesh"):
        _port_model("float32").compile(mesh=object())
    # Adam and the row-lazy updates are ported: they construct
    adam = fft.AdamOptimizer(lr=0.001)
    assert (adam.lr, adam.slot_names(), adam.lazy_embeddings) == (
        0.001, ("m", "v"), False)
    lazy = fft.SGDOptimizer(lr=0.1, lazy_embeddings=True)
    assert lazy.lazy_embeddings and lazy.slot_names() == ()
    # tiered storage is ported: on the fused graph, whose op the JAX
    # package does not tier either, the engine serves resident
    engine = InferenceEngine(pm, state, storage="tiered", warmup=False,
                             device="cpu")
    assert engine.storage == {"mode": "resident", "hot_rows": 4096,
                              "tables": {}, "fallbacks": {}}


def test_kaggle_graph_matches_jax():
    """Criteo-Kaggle's 26 ragged tables build as one fused op with the
    JAX package's op names and parameter shapes (no weights drawn)."""
    from dlrm_flexflow_tpu.apps.dlrm import \
        criteo_kaggle_config as jax_kaggle
    from dlrm_flexflow_tpu_torch.apps.dlrm import criteo_kaggle_config
    pc, jc = criteo_kaggle_config(), jax_kaggle()
    pc.fused_interaction = jc.fused_interaction = "on"
    pm = build_dlrm(pc, fft.FFConfig(batch_size=32))
    jm = jax_build_dlrm(jc, JaxFFConfig(batch_size=32))
    shapes = [[(s.op_name, s.param_name, s.shape) for s in op.param_specs()]
              for op in pm.layers]
    assert shapes == [[(s.op_name, s.param_name, s.shape)
                       for s in op.param_specs()] for op in jm.layers]
    assert pm.final_tensor.shape == jm.final_tensor.shape == (32, 1)


def test_get_and_set_weights():
    pm = _port_model("float32")
    state = pm.init(seed=1, device="cpu")
    w = pm.get_weights(state, "top_2", "kernel")
    assert isinstance(w, np.ndarray) and w.shape == (32, 1)
    new = pm.set_weights(state, "top_2", "kernel", w * 2)
    np.testing.assert_array_equal(pm.get_weights(new, "top_2", "kernel"),
                                  w * 2)
    np.testing.assert_array_equal(pm.get_weights(state, "top_2", "kernel"),
                                  w)  # the old state is untouched


def test_init_is_seeded_and_shaped():
    pm = _port_model("float32")
    a, b = pm.init(seed=5, device="cpu"), pm.init(seed=5, device="cpu")
    c = pm.init(seed=6, device="cpu")
    jm = _jax_model("float32")
    for op, params in jm.init(seed=0).params.items():
        for k, v in params.items():
            assert tuple(a.params[op][k].shape) == v.shape
            assert torch.equal(a.params[op][k], b.params[op][k])
    assert not torch.equal(a.params["emb"]["embedding"],
                           c.params["emb"]["embedding"])


# ---------------------------------------------------------- import hygiene
def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_at_runtime():
    assert {"dlrm_flexflow_tpu_torch.ops.row_update_kernel",
            "dlrm_flexflow_tpu_torch.ops.shape_ops",
            "dlrm_flexflow_tpu_torch.optim", "dlrm_flexflow_tpu_torch.losses",
            "dlrm_flexflow_tpu_torch.metrics",
            "dlrm_flexflow_tpu_torch.data.loader"} <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'dlrm_flexflow_tpu'\n"
        "             or m.startswith('dlrm_flexflow_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "clean" in res.stdout


def test_port_source_has_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "dlrm_flexflow_tpu"), \
                    f"{path}: imports {n}"
