"""Quantized serving tables in the port (dlrm_flexflow_tpu_torch/ops/
quantized.py and InferenceEngine(quantize=...)) against the JAX package
on the CPU.

Tolerances, each with its reason:
  * ``quantize_table``'s codes and scales, ``bf16`` storage,
    ``dequant_rows`` and the byte report: bit-exact (the same IEEE
    division, rounding half to even, on the same values);
  * a quantized engine against the JAX package's quantized engine on the
    same weights and requests: rtol 1e-5, atol 1e-6 on the outputs, the
    tolerance of the f32 serving slice: the tables and their gathers are
    equal, and only the MLP matmuls' summation order differs (the port
    accumulates its Linear layers in f64);
  * a quantized engine against the f32 engine: the JAX package's pinned
    bounds, ``INT8_ATOL`` and ``BF16_ATOL`` (1e-2 absolute on the sigmoid
    outputs, ``scripts/check_kernels.py:57-58``);
  * padding within one quantized engine: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.ops import StackedEmbedding as JaxStacked
from dlrm_flexflow_tpu.ops import quantized as jq
from dlrm_flexflow_tpu.serving import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.tensor import Tensor as JaxTensor

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import params_from_jax
from dlrm_flexflow_tpu_torch.ops import StackedEmbedding
from dlrm_flexflow_tpu_torch.ops import quantized as tq
from dlrm_flexflow_tpu_torch.serving import DynamicBatcher, InferenceEngine
from dlrm_flexflow_tpu_torch.tensor import Tensor

D = 16
TABLES = [40, 24, 32, 100]
BUCKETS = "1,8"


def _tables(seed, shape):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal(shape).astype(np.float32)
    t.reshape(-1, shape[-1])[3] = 0.0                 # a zero row: scale 1
    t.reshape(-1, shape[-1])[5, 2] = 1e-30            # a tiny amax
    t.reshape(-1, shape[-1])[6] *= 1e6                # a large one
    return t


@pytest.mark.parametrize("shape", [(50, D), (3, 20, D)])
def test_quantize_table_int8_matches_jax_bit_for_bit(shape):
    table = _tables(sum(shape), shape)
    want_codes, want_scale = jq.quantize_table(table, "int8", D)
    codes, scale = tq.quantize_table(torch.from_numpy(table), "int8", D)
    assert codes.dtype == torch.int8 and codes.shape == shape
    assert scale.dtype == torch.float32 and scale.shape == want_scale.shape
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  want_scale.view(np.uint32))


def test_quantize_table_bf16_and_modes_match_jax():
    table = _tables(1, (40, D))
    want, none = jq.quantize_table(table, "bf16", D)
    got, scale = tq.quantize_table(torch.from_numpy(table), "bf16", D)
    assert none is None and scale is None and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), np.asarray(want).view(np.uint16))
    assert tq.QUANT_MODES == jq.QUANT_MODES
    assert tq.QSCALE_KEY == jq.QSCALE_KEY
    for mod in (tq, jq):
        with pytest.raises(ValueError, match="unknown quantize mode"):
            mod.quantize_table(table, "int4", D)


def test_dequant_rows_matches_jax():
    table = _tables(2, (60, D))
    codes, scale = jq.quantize_table(table, "int8", D)
    gids = np.random.default_rng(2).integers(0, 60, size=(7, 4, 2))
    want = jq.dequant_rows(jnp.take(jnp.asarray(codes), gids, axis=0),
                           jnp.asarray(scale), jnp.asarray(gids))
    tcodes = torch.from_numpy(codes)
    got = tq.dequant_rows(tcodes[torch.from_numpy(gids)],
                          torch.from_numpy(scale), torch.from_numpy(gids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and it stays within one scale step of the f32 rows
    assert np.all(np.abs(got.numpy() - table[gids])
                  <= scale[gids] * 0.5 + 1e-6 * np.abs(table[gids]))


def _cfg(cls, fused):
    return cls(sparse_feature_size=D, embedding_size=list(TABLES),
               mlp_bot=[13, 32, D], mlp_top=[D + len(TABLES) * D, 32, 1],
               arch_interaction_op="cat", fused_interaction=fused)


def _pair(fused):
    """The JAX model and state, and the port model and state on the same
    weights."""
    jm = jax_build_dlrm(_cfg(JaxDLRMConfig, fused),
                        JaxFFConfig(batch_size=8, serve_buckets=BUCKETS))
    jm.compile(optimizer=ffj.SGDOptimizer(lr=0.01), metrics=(),
               loss_type="mean_squared_error", mesh=False)
    js = jm.init(seed=0)
    pm = build_dlrm(_cfg(DLRMConfig, fused),
                    fft.FFConfig(batch_size=8, serve_buckets=BUCKETS)
                    ).compile(mesh=False)
    ps = pm.load_params(params_from_jax(jax.tree.map(np.asarray, js.params)),
                        device="cpu")
    return jm, js, pm, ps


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_quantize_embedding_params_report_matches_jax(fused, mode):
    jm, js, pm, ps = _pair(fused)
    before = {op: {k: v.clone() for k, v in d.items()}
              for op, d in ps.params.items()}
    qp, report = tq.quantize_embedding_params(pm.layers, ps.params, mode)
    _, want = jq.quantize_embedding_params(jm.layers, js.params, mode)
    assert report == want
    assert report["bytes_after"] < report["bytes_before"]
    for op, d in ps.params.items():         # the training state untouched
        for k, v in d.items():
            assert torch.equal(v, before[op][k])
    assert (qp["emb"]["embedding"].dtype
            == (torch.int8 if mode == "int8" else torch.bfloat16))
    assert (tq.QSCALE_KEY in qp["emb"]) == (mode == "int8")
    assert tq.quantize_embedding_params(pm.layers, ps.params, "off") == (
        ps.params, jq.quantize_embedding_params(jm.layers, js.params,
                                                "off")[1])


def test_stacked_quantized_stays_in_table():
    """The JAX package's in-table clamp for quantized tables
    (``tests/test_kernels.py:228-245``): an invalid local id clamps
    within its own table, never onto a neighbouring table's row, and
    valid ids stay within quantization error of the f32 path."""
    jop = JaxStacked("emb", JaxTensor((2, 2, 2), jnp.int32), 2, 8, D)
    pop = StackedEmbedding("emb", Tensor((2, 2, 2), torch.int64), 2, 8, D)
    params = {"emb": jop.init_params(jax.random.PRNGKey(0))}
    jq_params, _ = jq.quantize_embedding_params([jop], params, "int8")
    pparams = params_from_jax(jax.tree.map(np.asarray, params))
    pq_params, _ = tq.quantize_embedding_params([pop], pparams, "int8")
    valid = np.array([[[1, 0], [7, 2]], [[3, 3], [0, 7]]])
    bad = np.array([[[1, 0], [-1, 2]], [[8, 3], [0, 7]]])
    clamped = np.array([[[1, 0], [0, 2]], [[7, 3], [0, 7]]])
    f32 = pop.forward(pparams["emb"], [torch.from_numpy(valid)])[0]
    q = pop.forward(pq_params["emb"], [torch.from_numpy(valid)])[0]
    np.testing.assert_allclose(q.numpy(), f32.numpy(), atol=1e-2)
    for ids in (valid, bad):
        got = pop.forward(pq_params["emb"], [torch.from_numpy(ids)])[0]
        want = jop.forward(jq_params["emb"], [jnp.asarray(ids)])[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_bad = pop.forward(pq_params["emb"], [torch.from_numpy(bad)])[0]
    got_clamped = pop.forward(pq_params["emb"],
                              [torch.from_numpy(clamped)])[0]
    np.testing.assert_array_equal(got_bad.numpy(), got_clamped.numpy())
    assert torch.isfinite(got_bad).all()


def _request(n, seed):
    rng = np.random.default_rng(seed)
    sparse = np.stack([rng.integers(0, r, size=(n, 1)) for r in TABLES],
                      axis=1).astype(np.int64)
    return {"dense": rng.standard_normal((n, 13)).astype(np.float32),
            "sparse": sparse}


@pytest.fixture(scope="module", params=["on", "off"])
def engines(request):
    jm, js, pm, ps = _pair(request.param)
    out = {"port": {}, "jax": {}}
    for mode in ("off", "int8", "bf16"):
        out["port"][mode] = InferenceEngine(pm, ps, quantize=mode,
                                            device="cpu")
        out["jax"][mode] = JaxEngine(jm, js, quantize=mode)
    return out


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_engine_matches_jax_engine(engines, mode):
    port, jax_eng = engines["port"][mode], engines["jax"][mode]
    assert port.quantization == jax_eng.quantization
    atol = tq.INT8_ATOL if mode == "int8" else tq.BF16_ATOL
    assert atol == 1e-2
    for n in (1, 3, 8, 11):
        req = _request(n, seed=n)
        got = port.predict(req)
        np.testing.assert_allclose(got, np.asarray(jax_eng.predict(req)),
                                   rtol=1e-5, atol=1e-6)
        base = engines["port"]["off"].predict(req)
        assert np.abs(got - base).max() <= atol
        assert not np.array_equal(got, base)  # the tables were re-encoded


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_padding_is_bit_identical(engines, mode):
    """Within one quantized engine a padded request gives the bits of the
    same rows in a full bucket, and the batcher gives the engine's."""
    eng = engines["port"][mode]
    full = _request(8, seed=20)
    want = eng.predict(full)
    for n in (1, 3, 5):
        part = {k: v[:n] for k, v in full.items()}
        np.testing.assert_array_equal(eng.predict(part), want[:n])
    with DynamicBatcher(eng, max_wait_us=0.0) as batcher:
        futs = [batcher.submit({k: v[i:i + 1] for k, v in full.items()})
                for i in range(4)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(60), want[i:i + 1])
