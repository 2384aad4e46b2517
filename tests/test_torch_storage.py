"""The port's tiered embedding storage (dlrm_flexflow_tpu_torch/storage)
and its tiered serving engine against the JAX package on the CPU: the
eviction policies, the store's three kinds (stacked, single, ragged) over
the same zipf id streams, its errors, its checkpoints across the two
packages, the hit-rate prediction and the gate's decision, and the
tiered InferenceEngine (predictions, ``engine.storage``,
``storage_stats``, ``from_checkpoint``).  JAX is imported here only.

Tolerances: the store moves rows and adds updates in the same order as
the JAX store's CPU path (``.at[].add``), so every row, remapped id and
counter is compared exactly.  The engines differ only in the MLP
matmuls' sum order: rtol 1e-5 / atol 1e-6, the serving slice's
tolerance; the port's tiered engine equals its resident engine bit for
bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu import storage as jstorage
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.checkpoint import save_checkpoint as jax_save_ckpt
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.serving import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.telemetry import rowfreq as jrowfreq

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch import storage as pstorage
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import params_from_jax
from dlrm_flexflow_tpu_torch.checkpoint import CheckpointError
from dlrm_flexflow_tpu_torch.data.loader import zipf_ids
from dlrm_flexflow_tpu_torch.ops.row_set_kernel import row_set_cuda
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import row_update_cuda
from dlrm_flexflow_tpu_torch.serving import InferenceEngine
from dlrm_flexflow_tpu_torch.telemetry import rowfreq as prowfreq

D = 8
HOT = 32
POLICIES = ("lfu", "lru", "clock")


@pytest.fixture(autouse=True)
def _fresh_counters(monkeypatch):
    monkeypatch.delenv("FF_TIERED_STORAGE", raising=False)
    jrowfreq.reset()
    prowfreq.reset()
    yield
    jrowfreq.reset()
    prowfreq.reset()


# ------------------------------------------------------------- policies
@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_victims_match_jax(name, seed):
    """The same fill / touch / victims sequence gives the same victims in
    the same order."""
    rng = np.random.default_rng(seed)
    slots = 24
    jp = jstorage.make_policy(name, slots)
    pp = pstorage.make_policy(name, slots)
    assert type(pp).__name__ == type(jp).__name__ and pp.name == jp.name
    for s in range(slots):
        seed_count = int(rng.integers(0, 5))
        jp.fill(s, seed=seed_count)
        pp.fill(s, seed=seed_count)
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0:
            s = int(rng.integers(0, slots))
            jp.touch(s)
            pp.touch(s)
        elif op == 1:
            s, c = int(rng.integers(0, slots)), int(rng.integers(0, 9))
            jp.fill(s, seed=c)
            pp.fill(s, seed=c)
        else:
            k = int(rng.integers(1, 6))
            pinned = set(rng.choice(slots, size=int(rng.integers(0, 8)),
                                    replace=False).tolist())
            assert pp.victims(k, set(pinned)) == jp.victims(k, set(pinned))


def test_policy_names_and_unknown_policy_match_jax():
    assert pstorage.POLICY_NAMES == jstorage.POLICY_NAMES
    with pytest.raises(ValueError) as je:
        jstorage.make_policy("mru", 4)
    with pytest.raises(ValueError) as pe:
        pstorage.make_policy("mru", 4)
    assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------- stores
KINDS = {
    # kind: (cold shape or flat rows, row_counts, ids per table)
    "stacked": ((3, 500, D), None),
    "single": ((700, D), None),
    "ragged": ((940, D), [300, 120, 500]),
}


def _cold(kind, seed=0):
    shape, counts = KINDS[kind]
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), counts


def _ids(kind, rng, batch, bag=2):
    """A (batch, T, bag) or (batch, bag) zipf id batch for ``kind``."""
    shape, counts = KINDS[kind]
    if kind == "single":
        return zipf_ids(rng, shape[0], (batch, bag))
    rows = counts or [shape[1]] * shape[0]
    return np.stack([zipf_ids(rng, r, (batch, bag)) for r in rows], axis=1)


def _stores(kind, policy="lfu", hot=HOT, seed=0):
    cold, counts = _cold(kind, seed)
    j = jstorage.TieredEmbeddingTable("sparse", jnp.asarray(cold), hot,
                                      row_counts=counts, policy=policy)
    p = pstorage.TieredEmbeddingTable("sparse", cold, hot, row_counts=counts,
                                      policy=policy, device="cpu")
    return j, p


def _counters(store):
    st = store.stats()
    st.pop("stall_us_total")
    st.pop("stall_us_last")
    return st


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_store_remaps_like_jax(kind, policy):
    """The same zipf id stream gives the same remapped ids, the same
    resident ids per table, the same counters and the same manifest, and
    ``gather_rows`` gives the JAX store's rows bit for bit."""
    j, p = _stores(kind, policy)
    assert (p.kind, p.tables, p.hot_slots, p.total_rows, p.dim) == \
        (j.kind, j.tables, j.hot_slots, j.total_rows, j.dim)
    rng = np.random.default_rng(11)
    launches = row_set_cuda.launches
    for _ in range(40):
        ids = _ids(kind, rng, int(rng.integers(1, 9)))
        np.testing.assert_array_equal(p.remap(ids), j.remap(ids))
    assert row_set_cuda.launches == launches  # CPU: the plain version
    for t in range(p.tables):
        assert p.resident_ids(t) == j.resident_ids(t)
    assert _counters(p) == _counters(j)
    assert p.hot_manifest() == j.hot_manifest()
    assert p.describe() == j.describe()
    assert _counters(p)["evictions"] > 0
    ids = _ids(kind, rng, 8)
    got = p.gather_rows(ids)
    assert got.dtype == torch.float32 and tuple(got.shape) == ids.shape + (D,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.gather_rows(ids)))
    # the hot tier holds the cold rows of its resident ids, bit for bit
    hot = p.hot_param().reshape(-1, D).numpy()
    np.testing.assert_array_equal(
        hot, np.asarray(j.hot_param()).reshape(-1, D))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_store_scatter_apply_matches_jax(kind):
    """``scatter_apply`` (duplicates accumulated in order, dirty rows
    written back on eviction) then ``cold_full``: bit for bit the JAX
    store's, with the same writebacks."""
    j, p = _stores(kind, hot=HOT)
    rng = np.random.default_rng(12)
    updates = row_update_cuda.launches
    for step in range(24):
        ids = _ids(kind, rng, int(rng.integers(1, 9)))
        if step % 3 == 2:
            np.testing.assert_array_equal(p.remap(ids), j.remap(ids))
            continue
        g = rng.standard_normal(ids.shape + (D,)).astype(np.float32)
        p.scatter_apply(ids, g, -0.05)
        j.scatter_apply(ids, jnp.asarray(g), -0.05)
    assert row_update_cuda.launches == updates  # CPU: the plain version
    assert _counters(p) == _counters(j)
    assert _counters(p)["writebacks"] > 0 and _counters(p)["dirty"] > 0
    full = p.cold_full()
    want = np.asarray(j.cold_full())
    assert isinstance(full, np.ndarray) and full.shape == want.shape
    np.testing.assert_array_equal(full, want)
    assert _counters(p) == _counters(j)  # the writeback's counts too


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_store_warm_start_matches_jax(kind):
    """``warm_from_rowfreq`` admits the same ids from the same observed
    traffic, and the next remap hits the same rows."""
    j, p = _stores(kind, "lfu")
    rng = np.random.default_rng(13)
    for _ in range(6):
        ids = _ids(kind, rng, 16)
        for key, arr in zip([t.key for t in p.tiers],
                            ([ids[:, t] for t in range(ids.shape[1])]
                             if kind != "single" else [ids])):
            jrowfreq.counter(key).observe(arr)
            prowfreq.counter(key).observe(arr)
    assert p.warm_from_rowfreq() == j.warm_from_rowfreq() > 0
    assert p.hot_manifest() == j.hot_manifest()
    ids = _ids(kind, rng, 8)
    np.testing.assert_array_equal(p.remap(ids), j.remap(ids))
    assert _counters(p) == _counters(j)


@pytest.mark.parametrize("case", ["low", "high", "working_set", "table_axis"])
def test_storage_errors_match_jax(case):
    """Out-of-range ids, a batch bigger than the tier, and ids without
    the table axis raise StorageError with the JAX message."""
    j, p = _stores("stacked", hot=4)
    ids = np.zeros((2, 3, 2), dtype=np.int64)
    if case == "low":
        ids[1, 1, 0] = -1
    elif case == "high":
        ids[0, 2, 1] = 500
    elif case == "working_set":
        ids = np.zeros((3, 3, 2), dtype=np.int64)
        ids[:, 0, :] = np.arange(6).reshape(3, 2) + 10  # 6 ids, 4 slots
    else:
        ids = np.zeros((2, 2), dtype=np.int64)
    with pytest.raises(jstorage.StorageError) as je:
        j.remap(ids)
    with pytest.raises(pstorage.StorageError) as pe:
        p.remap(ids)
    assert str(pe.value) == str(je.value)


def test_store_constructor_errors_match_jax():
    cases = [(np.zeros((4,), np.float32), 2, None),
             (np.zeros((10, D), np.float32), 0, None),
             (np.zeros((10, D), np.float32), 2, [6, 6])]
    for cold, hot, counts in cases:
        with pytest.raises(jstorage.StorageError) as je:
            jstorage.TieredEmbeddingTable("t", cold, hot, row_counts=counts)
        with pytest.raises(pstorage.StorageError) as pe:
            pstorage.TieredEmbeddingTable("t", cold, hot, row_counts=counts,
                                          device="cpu")
        assert str(pe.value) == str(je.value)


def _bits16(x):
    """A bf16 table (the port's tensor, JAX's array) as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bf16_store_matches_jax(kind, tmp_path):
    """A bf16 table tiered in both packages over the same zipf stream:
    the same remapped ids, victims and counters; ``gather_rows``, the
    hot tier, ``scatter_apply`` (bf16(scale) times the grads, duplicates
    added in order) with its writebacks, and ``cold_full`` bit for bit
    JAX's; a tiered checkpoint of either package loads in the port to
    the same bf16 table."""
    cold, counts = _cold(kind, seed=3)
    j = jstorage.TieredEmbeddingTable(
        "sparse", jnp.asarray(cold, dtype=jnp.bfloat16), HOT,
        row_counts=counts)
    p = pstorage.TieredEmbeddingTable(
        "sparse", torch.from_numpy(cold).to(torch.bfloat16), HOT,
        row_counts=counts, device="cpu")
    assert p.hot_param().dtype == torch.bfloat16
    rng = np.random.default_rng(16)
    for step in range(24):
        ids = _ids(kind, rng, int(rng.integers(1, 9)))
        if step % 3 == 2:
            np.testing.assert_array_equal(p.remap(ids), j.remap(ids))
            continue
        g = rng.standard_normal(ids.shape + (D,)).astype(np.float32)
        if step % 2:  # bf16 grads as well as f32 ones
            p.scatter_apply(ids, torch.from_numpy(g).to(torch.bfloat16),
                            -0.05)
            j.scatter_apply(ids, jnp.asarray(g, dtype=jnp.bfloat16), -0.05)
        else:
            p.scatter_apply(ids, g, -0.05)
            j.scatter_apply(ids, jnp.asarray(g), -0.05)
    for t in range(p.tables):
        assert p.resident_ids(t) == j.resident_ids(t)
    assert _counters(p) == _counters(j)
    assert _counters(p)["writebacks"] > 0 and _counters(p)["evictions"] > 0
    ids = _ids(kind, rng, 8)
    got = p.gather_rows(ids)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits16(got), _bits16(j.gather_rows(ids)))
    np.testing.assert_array_equal(_bits16(p.hot_param()),
                                  _bits16(j.hot_param()))
    full = p.cold_full()
    assert full.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits16(full), _bits16(j.cold_full()))
    assert _counters(p) == _counters(j)
    # checkpoints: the port's save, and JAX's (its np.savez of an
    # ml_dtypes array), each load in the port to the same table
    pstorage.save_tiered(str(tmp_path / "port"), p)
    jstorage.save_tiered(str(tmp_path / "jax"), j)
    with np.load(tmp_path / "port" / "cold.npz") as a, \
            np.load(tmp_path / "jax" / "cold.npz") as b:
        assert a["cold"].dtype == b["cold"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(a["cold"].view(np.uint16),
                                      b["cold"].view(np.uint16))
    for d in ("port", "jax"):
        back = pstorage.load_tiered(str(tmp_path / d), device="cpu")
        assert back.hot_manifest() == p.hot_manifest()
        np.testing.assert_array_equal(_bits16(back.cold_full()),
                                      _bits16(full))


# ------------------------------------------------------------ checkpoints
def _churn(store, kind, seed, scatter):
    rng = np.random.default_rng(seed)
    for step in range(12):
        ids = _ids(kind, rng, int(rng.integers(1, 9)))
        if scatter and step % 2:
            g = rng.standard_normal(ids.shape + (D,)).astype(np.float32)
            store.scatter_apply(ids, g if isinstance(
                store, pstorage.TieredEmbeddingTable) else jnp.asarray(g),
                0.1)
        else:
            store.remap(ids)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_save_tiered_crosses_between_the_packages(kind, policy, tmp_path):
    """A port save and a JAX save of the same history are the same
    files (the manifest byte for byte, the cold tier bit for bit); each
    loads in the other package to the same store."""
    j, p = _stores(kind, policy)
    _churn(j, kind, 14, scatter=True)
    _churn(p, kind, 14, scatter=True)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jstorage.save_tiered(str(jdir), j)
    pstorage.save_tiered(str(pdir), p)
    name = pstorage.checkpoint.MANIFEST_NAME
    assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    with np.load(pdir / "cold.npz") as a, np.load(jdir / "cold.npz") as b:
        assert list(a) == list(b) == ["cold"]
        np.testing.assert_array_equal(a["cold"], b["cold"])
    # each package's load of the other's save is the other's own load
    # (a load re-ranks as it admits: LRU stamps restart, so a loaded
    # manifest is compared with a loaded one)
    from_jax = pstorage.load_tiered(str(jdir), device="cpu")
    from_port = jstorage.load_tiered(str(pdir))
    for a, b in ((from_jax, jstorage.load_tiered(str(jdir))),
                 (from_port, pstorage.load_tiered(str(pdir), device="cpu"))):
        assert a.hot_manifest() == b.hot_manifest()
        assert [a.resident_ids(t) for t in range(a.tables)] == \
            [b.resident_ids(t) for t in range(b.tables)]
        np.testing.assert_array_equal(np.asarray(a.cold_full()),
                                      np.asarray(b.cold_full()))
    np.testing.assert_array_equal(from_jax.cold_full(), j.cold_full())
    rng = np.random.default_rng(15)
    for _ in range(5):
        ids = _ids(kind, rng, 8)
        np.testing.assert_array_equal(from_jax.remap(ids),
                                      from_port.remap(ids))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_load_under_a_smaller_budget_readmits_the_hottest_prefix(kind,
                                                                 tmp_path):
    j, p = _stores(kind, "lfu")
    _churn(p, kind, 16, scatter=False)
    _churn(j, kind, 16, scatter=False)
    pstorage.save_tiered(str(tmp_path), p)
    manifest = p.hot_manifest()
    small = pstorage.load_tiered(str(tmp_path), hot_rows=8, device="cpu")
    jsmall = jstorage.load_tiered(str(tmp_path), hot_rows=8)
    for t in range(small.tables):
        assert small.resident_ids(t) == sorted(i for i, _ in
                                               manifest[t][:8])
        assert small.resident_ids(t) == jsmall.resident_ids(t)
    assert small.hot_manifest() == jsmall.hot_manifest()


def test_load_tiered_errors_match_jax(tmp_path):
    with pytest.raises(jstorage.StorageError) as je:
        jstorage.load_tiered(str(tmp_path))
    with pytest.raises(pstorage.StorageError) as pe:
        pstorage.load_tiered(str(tmp_path), device="cpu")
    assert str(pe.value) == str(je.value)
    (tmp_path / "tiered_manifest.json").write_text(json.dumps({"version": 2}))
    with pytest.raises(jstorage.StorageError) as je:
        jstorage.load_tiered(str(tmp_path))
    with pytest.raises(pstorage.StorageError) as pe:
        pstorage.load_tiered(str(tmp_path), device="cpu")
    assert str(pe.value) == str(je.value)


# ------------------------------------------------------ hit rate and gate
@pytest.mark.parametrize("k", [1, 5, 40, 10_000])
def test_head_mass_matches_jax(k):
    rng = np.random.default_rng(17)
    assert prowfreq.head_mass("never", k) == jrowfreq.head_mass("never", k) \
        == (0, 0)
    for _ in range(5):
        ids = zipf_ids(rng, 3000, (64, 2))
        jrowfreq.counter("t").observe(ids)
        prowfreq.counter("t").observe(ids)
    assert prowfreq.head_mass("t", k) == jrowfreq.head_mass("t", k)
    assert prowfreq.get("t").head_mass(k) == jrowfreq.get("t").head_mass(k)


def test_predicted_hit_rate_and_keys_match_jax():
    rng = np.random.default_rng(18)
    keys = pstorage.default_table_keys("sparse", 3)
    assert keys == jstorage.default_table_keys("sparse", 3)
    assert pstorage.default_table_keys("x", 1) == \
        jstorage.default_table_keys("x", 1)
    args = (keys, [1000, 50, 4000], [64, 64, 64])
    assert pstorage.predicted_hit_rate(*args) == \
        jstorage.predicted_hit_rate(*args)
    for key in keys[:2]:  # the third stays unobserved: the uniform floor
        ids = zipf_ids(rng, 1000, (500,))
        jrowfreq.counter(key).observe(ids)
        prowfreq.counter(key).observe(ids)
    got = pstorage.predicted_hit_rate(*args)
    assert got == jstorage.predicted_hit_rate(*args) and got[1] is True


@pytest.mark.parametrize("mode", ["auto", "on", "off", "bogus"])
@pytest.mark.parametrize("shape", [
    dict(num_rows=1000, hot_rows=1000, lookups=8, hit_rate=0.99),  # fits
    dict(num_rows=10**6, hot_rows=64, lookups=128, hit_rate=0.99),  # < batch
    dict(num_rows=10**6, hot_rows=4096, lookups=0, hit_rate=0.99),
    dict(num_rows=10**6, hot_rows=4096, lookups=2048, hit_rate=0.0),
])
def test_tiered_decision_structure_and_override_match_jax(monkeypatch, mode,
                                                          shape):
    """The FF_TIERED_STORAGE override and the gate's structural refusals
    (a table that fits, a budget under one batch, no lookups, no skew)
    give JAX's decision and reason; the priced middle is the H100's own
    (tests/test_torch_kernel_costs.py)."""
    monkeypatch.setenv("FF_TIERED_STORAGE", mode)
    assert pstorage.storage_override() == jstorage.storage_override()
    kw = dict(dim=64, itemsize=4, **shape)
    assert pstorage.tiered_decision(**kw) == jstorage.tiered_decision(**kw)


# --------------------------------------------------------- tiered engine
ENGINE_TABLES = {"stacked": [400, 400, 400], "ragged": [400, 90, 250]}
BUCKETS = "1,8,16"


def _dlrm(cls, tables):
    t = len(tables)
    return cls(sparse_feature_size=D, embedding_size=list(tables),
               mlp_bot=[13, 16, D], mlp_top=[D + t * D, 16, 1],
               arch_interaction_op="cat")


def _ffc(cls, hot):
    return cls(batch_size=16, serve_buckets=BUCKETS, storage_hot_rows=hot)


def _models(tables, hot):
    jm = jax_build_dlrm(_dlrm(JaxDLRMConfig, tables), _ffc(JaxFFConfig, hot),
                        stacked_embeddings=True)
    jm.compile(optimizer=ffj.SGDOptimizer(lr=0.01),
               loss_type="mean_squared_error", metrics=(), mesh=False)
    pm = build_dlrm(_dlrm(DLRMConfig, tables), _ffc(fft.FFConfig, hot),
                    stacked_embeddings=True).compile(mesh=False)
    return jm, pm


def _request(rng, tables, n):
    sparse = np.stack([zipf_ids(rng, r, (n, 1)) for r in tables], axis=1)
    return {"dense": rng.standard_normal((n, 13)).astype(np.float32),
            "sparse": sparse}


@pytest.fixture(scope="module", params=sorted(ENGINE_TABLES))
def engines(request):
    """Both packages' tiered engines (hot rows = one top bucket's working
    set) and the port's resident engine, on the same weights, after the
    same observed traffic."""
    tables = ENGINE_TABLES[request.param]
    jm, pm = _models(tables, hot=16)
    jstate = jm.init(seed=0)
    np_params = jax.tree.map(np.asarray, jstate.params)
    pstate = pm.load_params(params_from_jax(np_params), device="cpu")
    rng = np.random.default_rng(21)
    jrowfreq.reset()
    prowfreq.reset()
    warm = _request(rng, tables, 64)["sparse"]
    for t in range(len(tables)):
        jrowfreq.counter(f"sparse[{t}]").observe(warm[:, t])
        prowfreq.counter(f"sparse[{t}]").observe(warm[:, t])
    old = os.environ.get("FF_TIERED_STORAGE")
    os.environ["FF_TIERED_STORAGE"] = "on"
    try:
        jt = JaxEngine(jm, jstate, storage="tiered")
        pt = InferenceEngine(pm, pstate, storage="tiered", device="cpu")
    finally:
        if old is None:
            del os.environ["FF_TIERED_STORAGE"]
        else:
            os.environ["FF_TIERED_STORAGE"] = old
    pr = InferenceEngine(pm, pstate, device="cpu")
    jrowfreq.reset()
    prowfreq.reset()
    return {"tables": tables, "jax": jt, "port": pt, "resident": pr,
            "jm": jm, "pm": pm, "jstate": jstate, "pstate": pstate}


def test_engine_storage_dict_matches_jax(engines):
    jt, pt = engines["jax"], engines["port"]
    assert pt.storage == jt.storage
    assert pt.storage["mode"] == "tiered"
    (info,) = pt.storage["tables"].values()
    assert info["warm_admitted"] > 0 and info["observed_traffic"] is True
    # the op's parameter is the store's hot tier, and stays it
    store = pt._tiered["sparse"][1]
    assert pt._params["emb"]["embedding"].data_ptr() == \
        store.hot_param().data_ptr()
    # the caller's state keeps its full table
    full = engines["pstate"].params["emb"]["embedding"]
    assert full.reshape(-1, D).shape[0] >= sum(engines["tables"])


def test_tiered_engine_matches_jax_and_resident(engines):
    """Single-threaded requests of 1-40 rows (40 is chunked by 16):
    predictions within the serving tolerance of the JAX tiered engine's,
    bit for bit the port's resident engine's; the same storage_stats
    counters after the same sequence."""
    jt, pt, pr = engines["jax"], engines["port"], engines["resident"]
    rng = np.random.default_rng(22)
    before_j, before_p = jt.storage_stats(), pt.storage_stats()
    keys = ("lookups", "hits", "misses", "hit_pct", "evictions",
            "writebacks")
    assert {k: before_p[k] for k in keys} == {k: before_j[k] for k in keys}
    for n in [1, 3, 8, 16, 5, 40, 2, 16, 11]:
        req = _request(rng, engines["tables"], n)
        got = pt.predict(req)
        np.testing.assert_array_equal(got, pr.predict(req))
        np.testing.assert_allclose(got, np.asarray(jt.predict(req)),
                                   rtol=1e-5, atol=1e-6)
    after_j, after_p = jt.storage_stats(), pt.storage_stats()
    assert {k: after_p[k] for k in keys} == {k: after_j[k] for k in keys}
    assert after_p["evictions"] > before_p["evictions"]
    assert set(after_p) == set(after_j)
    assert len(after_p["per_store"]) == len(after_j["per_store"]) == 1


def test_bf16_tiered_engine_matches_resident_and_jax(monkeypatch):
    """The model on bf16 tables (``embedding_dtype="bfloat16"``), tiered
    in both packages: the port's tiered answers equal its resident
    engine's bit for bit and JAX's within the serving tolerance, with
    the same storage counters, and the hot tier stays bf16."""
    tables = ENGINE_TABLES["stacked"]
    jm, pm = (build(_dlrm(cfg, tables), cls(
        batch_size=16, serve_buckets=BUCKETS, storage_hot_rows=16,
        embedding_dtype="bfloat16"), stacked_embeddings=True)
        for build, cfg, cls in ((jax_build_dlrm, JaxDLRMConfig, JaxFFConfig),
                                (build_dlrm, DLRMConfig, fft.FFConfig)))
    jm.compile(optimizer=ffj.SGDOptimizer(lr=0.01),
               loss_type="mean_squared_error", metrics=(), mesh=False)
    pm.compile()
    jstate = jm.init(seed=0)
    pstate = pm.load_params(params_from_jax(jax.tree.map(
        np.asarray, jstate.params)), device="cpu")
    assert pstate.params["emb"]["embedding"].dtype == torch.bfloat16
    monkeypatch.setenv("FF_TIERED_STORAGE", "on")
    jt = JaxEngine(jm, jstate, storage="tiered")
    pt = InferenceEngine(pm, pstate, storage="tiered", device="cpu")
    pr = InferenceEngine(pm, pstate, device="cpu")
    assert pt.storage == jt.storage and pt.storage["mode"] == "tiered"
    assert pt._tiered["sparse"][1].hot_param().dtype == torch.bfloat16
    rng = np.random.default_rng(23)
    for n in [1, 3, 8, 16, 5, 40, 2, 16, 11]:
        req = _request(rng, tables, n)
        got = pt.predict(req)
        np.testing.assert_array_equal(got, pr.predict(req))
        np.testing.assert_allclose(got, np.asarray(jt.predict(req)),
                                   rtol=1e-5, atol=1e-6)
    keys = ("lookups", "hits", "misses", "hit_pct", "evictions")
    sp, sj = pt.storage_stats(), jt.storage_stats()
    assert {k: sp[k] for k in keys} == {k: sj[k] for k in keys}
    assert sp["evictions"] > 0


def test_tiered_timings_report_the_stall(engines):
    pt = engines["port"]
    timings = {}
    pt.predict(_request(np.random.default_rng(23), engines["tables"], 16),
               timings=timings)
    assert set(timings) == {"bucket", "pad_us", "compute_us", "stall_us"}
    assert timings["bucket"] == 16.0 and timings["stall_us"] >= 0.0


def test_from_checkpoint_serves_a_jax_checkpoint(engines, tmp_path):
    """A checkpoint directory the JAX package wrote (npz) serves through
    the port's tiered engine to the resident predictions, bit for bit,
    and within the serving tolerance of the JAX engine's."""
    jax_save_ckpt(str(tmp_path / "ckpt"), engines["jstate"],
                  use_orbax=False)
    pm = engines["pm"]
    old = os.environ.get("FF_TIERED_STORAGE")
    os.environ["FF_TIERED_STORAGE"] = "on"
    try:
        eng = InferenceEngine.from_checkpoint(pm, str(tmp_path / "ckpt"),
                                              storage="tiered",
                                              device="cpu")
    finally:
        if old is None:
            del os.environ["FF_TIERED_STORAGE"]
        else:
            os.environ["FF_TIERED_STORAGE"] = old
    jeng = JaxEngine.from_checkpoint(engines["jm"], str(tmp_path / "ckpt"))
    assert eng.storage["mode"] == "tiered"
    rng = np.random.default_rng(24)
    for n in (1, 9, 16):
        req = _request(rng, engines["tables"], n)
        got = eng.predict(req)
        np.testing.assert_array_equal(got, engines["resident"].predict(req))
        np.testing.assert_allclose(got, np.asarray(jeng.predict(req)),
                                   rtol=1e-5, atol=1e-6)


def test_from_checkpoint_refuses_a_directory_of_corrupt_checkpoints(
        engines, tmp_path):
    (tmp_path / "ckpt-00000003").mkdir()
    with pytest.raises(CheckpointError, match="none verify"):
        InferenceEngine.from_checkpoint(engines["pm"], str(tmp_path),
                                        device="cpu")


def test_tiered_with_quantize_raises_the_jax_message(engines):
    with pytest.raises(ValueError) as pe:
        InferenceEngine(engines["pm"], engines["pstate"], storage="tiered",
                        quantize="int8", device="cpu")
    with pytest.raises(ValueError) as je:
        JaxEngine(engines["jm"], engines["jstate"], storage="tiered",
                  quantize="int8")
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("hot,reason", [
    (8, "hot tier (8 slots) below one bucket's worst-case working set "
        "(16x1 ids)"),
    (10_000, "table fits the hot budget — staying resident"),
])
def test_engine_fallbacks_match_jax(hot, reason):
    jm, pm = _models([400, 400], hot=hot)
    jstate = jm.init(seed=0)
    pstate = pm.load_params(params_from_jax(
        jax.tree.map(np.asarray, jstate.params)), device="cpu")
    jt = JaxEngine(jm, jstate, storage="tiered", warmup=False)
    pt = InferenceEngine(pm, pstate, storage="tiered", warmup=False,
                         device="cpu")
    assert pt.storage == jt.storage
    assert pt.storage["fallbacks"] == {"emb": reason}
    assert pt.storage_stats() == jt.storage_stats() == {}


def test_the_gate_refuses_uniform_traffic_and_the_engine_stays_resident():
    """Under ``auto`` with no observed skew, the H100-priced gate refuses
    (a uniform hit rate loses the 2x margin) as the JAX gate does."""
    jm, pm = _models([5000, 5000], hot=64)
    jstate = jm.init(seed=0)
    pstate = pm.load_params(params_from_jax(
        jax.tree.map(np.asarray, jstate.params)), device="cpu")
    pt = InferenceEngine(pm, pstate, storage="tiered", warmup=False,
                         device="cpu")
    jt = JaxEngine(jm, jstate, storage="tiered", warmup=False)
    assert pt.storage["mode"] == jt.storage["mode"] == "resident"
    assert pt.storage["fallbacks"]["emb"].startswith("cost gate:")
