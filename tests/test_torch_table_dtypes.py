"""bf16 embedding tables in the port (dlrm_flexflow_tpu_torch) against the
JAX package on the CPU.

* The plain versions of the bag (B1), the row update (B2) and the row set
  (B5) on bf16 tables against the JAX package's Pallas kernels run in
  interpret mode, bit for bit: bag order, ``avg``, duplicate runs,
  wrapped, dropped and out-of-range ids.  Both sides round each add of a
  bag or a run to bf16, in the same order.
* A few training steps of a DLRM with bf16 tables, the port against the
  JAX package on transferred weights and the same batches: the losses at
  rtol 1e-3 (the repo's bf16 gate), the bf16 tables bit for bit.  The
  port's Linear layers accumulate in f64 and round once (ROADMAP.md
  Queue C), so a row gradient may differ from the JAX package's in its
  last f32 bits; at this size no such difference reaches a bf16 entry,
  and the test holds that: the entries JAX's steps changed (a few
  hundred, counted from a snapshot of the starting table) and the rest
  equal the port's, bit for bit.
* The ops' forwards on bf16 tables at bags of 3 and 8, ``sum`` and
  ``avg`` (``Embedding`` without the bag kernel, ``StackedEmbedding``,
  ``RaggedStackedEmbedding``, ``FusedEmbedInteract``), against the JAX
  ops, bit for bit: each pools as its JAX op does (``jnp.sum`` and
  ``jnp.mean`` in f32 and rounded once; the fused op's pool rounded,
  then divided in bf16).
* The staged cached ``fit`` against the uncached one, bit for bit, on
  bf16 tables (the cache and its row-set writebacks keep the dtype).
* The bridge's bf16 round trip, bit for bit.
* Table dtypes other than f32 and bf16: refused by the ops and the
  config, and by the kernel wrappers on the card (a card-marked test).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj
from dlrm_flexflow_tpu.apps.dlrm import DLRMConfig as JaxDLRMConfig
from dlrm_flexflow_tpu.apps.dlrm import build_dlrm as jax_build_dlrm
from dlrm_flexflow_tpu.config import FFConfig as JaxFFConfig
from dlrm_flexflow_tpu.ops import embedding as jemb
from dlrm_flexflow_tpu.ops import pallas_embedding as jbag
from dlrm_flexflow_tpu.ops.fused_interact import \
    FusedEmbedInteract as JaxFused
from dlrm_flexflow_tpu.ops.pallas_scatter import (_row_set_pallas,
                                                  sparse_row_update)
from dlrm_flexflow_tpu.tensor import Tensor as JaxTensor

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import (opt_state_from_jax,
                                            params_from_jax, params_to_numpy)
from dlrm_flexflow_tpu_torch.ops import embedding as temb
from dlrm_flexflow_tpu_torch.ops.fused_interact import FusedEmbedInteract
from dlrm_flexflow_tpu_torch.ops.bag_kernel import (embedding_bag_cuda,
                                                   embedding_bag_ref)
from dlrm_flexflow_tpu_torch.ops.row_set_kernel import row_set_cuda
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import row_update_cuda
from dlrm_flexflow_tpu_torch.tensor import Tensor


def _bf16(rng, shape):
    """A bf16 numpy array (``ml_dtypes.bfloat16``) of normal values."""
    return np.asarray(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16))


def _torch(a):
    """A numpy array (bf16 included) as a CPU tensor, bit for bit."""
    return params_from_jax({"x": {"a": a}})["x"]["a"]


def _bits(x):
    """The raw 16 bits of a bf16 tensor or array, for exact compares."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


# ------------------------------------------------------------------ B1
@functools.lru_cache(maxsize=None)
def _bag_kernel(mode):
    return jax.jit(functools.partial(jbag.embedding_bag_pallas, mode=mode,
                                     interpret=True))


@pytest.mark.parametrize("bag", [1, 3, 8])
@pytest.mark.parametrize("mode", ["sum", "avg"])
def test_bag_plain_matches_interpret_kernel_on_bf16(mode, bag):
    """Each bag summed in bag order with every add rounded to bf16, and
    ``avg`` divided in bf16: the TPU kernel's bf16 scratch and sum."""
    rng = np.random.default_rng(bag)
    table = _bf16(rng, (64, 128))
    ids = rng.integers(0, 64, size=(16, bag))
    ids[1] = ids[0]                     # a bag that repeats another
    ids[2, :] = ids[0, 0]               # a bag of one repeated row
    port = embedding_bag_cuda(_torch(table), torch.from_numpy(ids), mode)
    want = _bag_kernel(mode)(jnp.asarray(table),
                             jnp.asarray(ids.astype(np.int32)))
    assert port.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(port), _bits(want))
    assert embedding_bag_cuda.launches == 0  # CPU tensors: the plain path


def test_bag_plain_order_and_take_rule_on_bf16():
    """The bag order is part of the result, and ids follow jnp.take: an id
    in [-R, 0) wraps, any other id outside [0, R) reads NaN."""
    rng = np.random.default_rng(3)
    table = _bf16(rng, (16, 128))
    ids = rng.integers(0, 16, size=(8, 3))
    ids[3, 1], ids[4, 0] = -1, 16
    port = embedding_bag_ref(_torch(table), torch.from_numpy(ids))
    rows = jnp.take(jnp.asarray(table), jnp.asarray(ids.astype(np.int32)),
                    axis=0)
    want = (rows[:, 0] + rows[:, 1]) + rows[:, 2]   # bf16 adds, in order
    nan = np.isnan(np.asarray(want, np.float32))
    np.testing.assert_array_equal(torch.isnan(port).numpy(), nan)
    # a NaN's payload is not part of the contract
    np.testing.assert_array_equal(_bits(port)[~nan], _bits(want)[~nan])
    assert nan[4].all() and not nan[3].any()


# ------------------------------------------------------- the ops' pools
_OP_ROWS = [40, 24, 32]


def _op_pair(kind, aggr, bag, b, d):
    """The JAX op and the port's of ``kind`` on a bf16 table, with their
    id (and bottom) inputs' shapes."""
    t = len(_OP_ROWS)
    bf = dict(table_dtype=jnp.bfloat16), dict(table_dtype=torch.bfloat16)
    if kind == "embedding":
        return (jemb.Embedding("e", JaxTensor((b, bag), jnp.int32), 40, d,
                               aggr, **bf[0]),
                temb.Embedding("e", Tensor((b, bag), torch.int64), 40, d,
                               aggr, **bf[1]))
    if kind == "stacked":
        return (jemb.StackedEmbedding("e", JaxTensor((b, t, bag), jnp.int32),
                                      t, 40, d, aggr, **bf[0]),
                temb.StackedEmbedding("e", Tensor((b, t, bag), torch.int64),
                                      t, 40, d, aggr, **bf[1]))
    if kind == "ragged":
        return (jemb.RaggedStackedEmbedding(
                    "e", JaxTensor((b, t, bag), jnp.int32), _OP_ROWS, d,
                    aggr, **bf[0]),
                temb.RaggedStackedEmbedding(
                    "e", Tensor((b, t, bag), torch.int64), _OP_ROWS, d,
                    aggr, **bf[1]))
    interact = kind.split("-")[1]
    return (JaxFused("e", JaxTensor((b, t, bag), jnp.int32),
                     JaxTensor((b, d), jnp.float32), _OP_ROWS, d, interact,
                     aggr, **bf[0]),
            FusedEmbedInteract("e", Tensor((b, t, bag), torch.int64),
                               Tensor((b, d), torch.float32), _OP_ROWS, d,
                               interact, aggr, **bf[1]))


@pytest.mark.parametrize("kind", ["embedding", "stacked", "ragged",
                                  "fused-cat", "fused-dot"])
@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("bag", [3, 8])
def test_op_forward_pools_bf16_tables_as_jax(kind, aggr, bag):
    """Bags longer than one row on a bf16 table, through each op's own
    forward (no bag kernel: ``use_pallas`` is off), bit for bit.  The
    fused ``dot`` sums its f32 dot products in another order than XLA,
    so its gram block is held at the f32 fused tests' rtol 1e-5, atol
    1e-6; its pooling is the fused ``cat`` case's, held bit for bit."""
    b, d = 9, 16
    jop, pop = _op_pair(kind, aggr, bag, b, d)
    shape = jop.param_specs()[0].shape
    assert tuple(pop.param_specs()[0].shape) == tuple(shape)
    assert pop.table_dtype == torch.bfloat16
    rng = np.random.default_rng(bag)
    table = _bf16(rng, shape)
    t = len(_OP_ROWS)
    # a narrow range, so ids repeat within and across bags
    ids = rng.integers(0, 12, size=(b, bag) if kind == "embedding"
                       else (b, t, bag))
    jx = [jnp.asarray(ids.astype(np.int32))]
    px = [torch.from_numpy(ids.astype(np.int64))]
    if kind.startswith("fused"):
        bottom = rng.standard_normal((b, d)).astype(np.float32)
        jx.append(jnp.asarray(bottom))
        px.append(torch.from_numpy(bottom))
    (want,) = jop.forward({"embedding": jnp.asarray(table)}, jx)
    (got,) = pop.forward({"embedding": _torch(table)}, px)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.isfinite(want).all()
    if kind != "fused-dot":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    np.testing.assert_array_equal(got.numpy()[:, :d], want[:, :d])
    np.testing.assert_allclose(got.numpy()[:, d:], want[:, d:], rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------------ B2
@functools.lru_cache(maxsize=None)
def _update_kernel(pipeline):
    return jax.jit(functools.partial(sparse_row_update, interpret=True,
                                     pipeline=pipeline))


def _update_port(table, ids, upd, scale):
    t = _torch(table).clone()
    out = row_update_cuda(t, torch.from_numpy(ids), _torch(upd), scale)
    assert out is t and row_update_cuda.launches == 0
    return t


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("upd_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
def test_row_update_plain_matches_interpret_kernel_on_bf16(d, upd_dtype,
                                                           pipeline):
    """Duplicate runs longer than the TPU kernel's 16-slot block: the
    scaled update rounded to bf16, then fetched + u0, + u1, ... each add
    rounded to bf16, one write per run.  At d = 64 the JAX package packs
    two rows into a 128-lane view row."""
    rng = np.random.default_rng(d)
    r, n = 64, 48
    table = _bf16(rng, (r, d))
    ids = rng.integers(0, 6, size=(n,)).astype(np.int32)
    ids[:20] = 2                        # one run of 20 and more
    rng.shuffle(ids)
    upd = (_bf16(rng, (n, d)) if upd_dtype == "bf16"
           else rng.standard_normal((n, d)).astype(np.float32))
    port = _update_port(table, ids, upd, -0.25)
    want = _update_kernel(pipeline)(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(upd), jnp.float32(-0.25))
    np.testing.assert_array_equal(_bits(port), _bits(want))


def test_row_update_wrapped_and_dropped_ids_on_bf16():
    """The ``.at[].add`` id contract on a bf16 table, against XLA's
    scatter (the path the JAX package takes off the TPU): an id in
    [-R, 0) wraps, an id >= R or < -R is dropped."""
    rng = np.random.default_rng(8)
    r, d = 32, 16
    table = _bf16(rng, (r, d))
    ids = np.array([3, -1, r, -r, 5, -r - 1, 3, 2 * r + 7, -1, 0, r - 1],
                   dtype=np.int64)
    upd = _bf16(rng, (ids.size, d))
    port = _update_port(table, ids, upd, torch.tensor(-0.5))
    want = sparse_row_update(jnp.asarray(table), jnp.asarray(ids),
                             jnp.asarray(upd), jnp.float32(-0.5))
    np.testing.assert_array_equal(_bits(port), _bits(want))
    untouched = sorted(set(range(r)) - {0, 3, 5, r - 1})
    np.testing.assert_array_equal(_bits(port)[untouched],
                                  _bits(table)[untouched])


# ------------------------------------------------------------------ B5
@pytest.mark.parametrize("rows_dtype", ["bf16", "f32"])
def test_row_set_plain_matches_interpret_kernel_on_bf16(rows_dtype):
    """Rows cast to the table's dtype and moved bit for bit; ids < 0 or
    >= R are dropped."""
    rng = np.random.default_rng(5)
    rows_n, n = 512, 40
    table = _bf16(rng, (rows_n, 128))
    ids = np.full((n,), rows_n, np.int32)
    ids[:30] = np.sort(rng.choice(rows_n, size=30, replace=False))
    ids[31] = -1
    rows = (_bf16(rng, (n, 128)) if rows_dtype == "bf16"
            else rng.standard_normal((n, 128)).astype(np.float32))
    t = _torch(table).clone()
    assert row_set_cuda(t, torch.from_numpy(ids), _torch(rows)) is t
    want = _row_set_pallas(jnp.asarray(table), jnp.asarray(ids),
                           jnp.asarray(rows), interpret=True)
    assert want.dtype == jnp.bfloat16 and t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t), _bits(want))
    assert row_set_cuda.launches == 0


# ------------------------------------------------------------ training
D = 16
TABLES = [40, 24, 32]


def _kwargs(interact, fused):
    t = len(TABLES)
    top0 = D + t * D if interact == "cat" else D + (t + 1) ** 2
    return dict(sparse_feature_size=D, embedding_size=list(TABLES),
                mlp_bot=[13, 32, D], mlp_top=[top0, 32, 1],
                arch_interaction_op=interact, fused_interaction=fused)


def _batches(steps, batch=16, seed=11):
    """Ids from a narrow range, so rows repeat inside a batch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = np.stack([rng.integers(0, min(r, 12), size=(batch, 1))
                        for r in TABLES], axis=1).astype(np.int64)
        out.append(({"dense": rng.standard_normal((batch, 13)).astype(
            np.float32), "sparse": ids},
            rng.integers(0, 2, size=(batch, 1)).astype(np.float32)))
    return out


def _models(interact, fused, sparse, lr=0.05):
    kw = _kwargs(interact, fused)
    fk = dict(batch_size=16, embedding_dtype="bfloat16",
              sparse_embedding_updates=sparse)
    mets = ("accuracy", "mean_squared_error")
    jm = jax_build_dlrm(JaxDLRMConfig(**kw), JaxFFConfig(**fk))
    jm.compile(optimizer=ffj.SGDOptimizer(lr=lr), metrics=mets, mesh=False,
               loss_type="mean_squared_error")
    js = jm.init(seed=0)
    pm = build_dlrm(DLRMConfig(**kw), fft.FFConfig(**fk))
    pm.compile(optimizer=fft.SGDOptimizer(lr=lr), metrics=mets,
               loss_type="mean_squared_error")
    ps = pm.load_params(
        params_from_jax(jax.tree.map(np.asarray, js.params)), device="cpu",
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray,
                                                  js.opt_state)))
    return jm, js, pm, ps


@pytest.mark.parametrize("interact,fused,sparse", [
    ("cat", "off", "auto"),      # StackedEmbedding, the row-sparse step
    ("dot", "on", "auto"),       # the fused op's bf16 path, row-sparse
    ("cat", "on", "off"),        # the fused op, the dense table gradient
])
def test_bf16_training_steps_match_jax(interact, fused, sparse):
    jm, js, pm, ps = _models(interact, fused, sparse)
    table = ps.params["emb"]["embedding"]
    assert table.dtype == torch.bfloat16
    start = _bits(table).copy()  # a row-sparse step updates it in place
    assert [op.name for op in pm._sparse_ops] == (
        jm._sparse_emb_ops if sparse != "off" else [])
    for inputs, labels in _batches(4):
        js, jmets = jm.train_step(js, inputs, labels)
        ps, pmets = pm.train_step(ps, inputs, labels)
        np.testing.assert_allclose(float(pmets["loss"]),
                                   float(jmets["loss"]), rtol=1e-3)
    got = ps.params["emb"]["embedding"]
    assert got.dtype == torch.bfloat16
    want = np.asarray(js.params["emb"]["embedding"])
    assert want.dtype == jnp.bfloat16
    moved = _bits(want) != start
    assert moved.sum() >= 150, moved.sum()  # the steps really train it
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_bf16_staged_cached_fit_equals_uncached():
    """fit's staged branch with the epoch row cache (the cache, its
    ladder blocks and writebacks in bf16) against the same fit uncached,
    bit for bit."""
    kw = _kwargs("cat", "off")
    batches = _batches(16, seed=12)
    inputs = {k: np.concatenate([b[0][k] for b in batches])
              for k in batches[0][0]}
    labels = np.concatenate([b[1] for b in batches])
    out = {}
    for cache in ("on", "off"):
        m = build_dlrm(DLRMConfig(**kw), fft.FFConfig(
            batch_size=16, embedding_dtype="bfloat16", epoch_row_cache=cache,
            epoch_cache_inner=4))
        m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
                  metrics=("accuracy", "mean_squared_error"))
        state = m.init(seed=2, device="cpu")
        loader = fft.ArrayDataLoader(inputs, labels, 16)
        state, _ = m.fit(state, loader, epochs=2, verbose=False)
        assert m._last_fit_used_scan and m._epoch_cache_active == (
            cache == "on")
        out[cache] = state
    for op, params in out["on"].params.items():
        for k, v in params.items():
            assert v.dtype == (torch.bfloat16 if op == "emb"
                               else torch.float32)
            assert torch.equal(v, out["off"].params[op][k]), f"{op}/{k}"


def test_bridge_round_trips_bf16_bit_for_bit():
    rng = np.random.default_rng(0)
    a = _bf16(rng, (7, 5)).copy()
    a[0, 0] = np.float32("nan")
    a[0, 1] = np.float32("-inf")
    params = params_from_jax({"emb": {"embedding": a},
                              "lin": {"kernel": np.ones((2, 2), np.float32)}})
    assert params["emb"]["embedding"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    assert back["emb"]["embedding"].dtype == a.dtype
    np.testing.assert_array_equal(back["emb"]["embedding"].view(np.uint16),
                                  a.view(np.uint16))
    np.testing.assert_array_equal(back["lin"]["kernel"], np.ones((2, 2)))
    # and into JAX again
    np.testing.assert_array_equal(
        _bits(jnp.asarray(back["emb"]["embedding"])), a.view(np.uint16))


# ----------------------------------------------------------- refusals
def test_other_table_dtypes_are_refused():
    ids = Tensor((4, 2), torch.int64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        temb.Embedding("e", ids, 10, 8, table_dtype=torch.float16)
    with pytest.raises(ValueError, match="embedding_dtype"):
        build_dlrm(DLRMConfig(**_kwargs("cat", "off")),
                   fft.FFConfig(embedding_dtype="float16"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernels_refuse_other_table_dtypes_on_the_card(dtype):
    """On a CUDA tensor each wrapper launches its kernel or raises; a
    table dtype the kernels do not store raises TypeError."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    table = torch.zeros((16, 8), dtype=dtype, device="cuda")
    ids = torch.arange(4, device="cuda")
    with pytest.raises(TypeError):
        row_update_cuda(table, ids, torch.ones((4, 8), device="cuda"))
    with pytest.raises(TypeError):
        row_set_cuda(table, ids, torch.ones((4, 8), device="cuda"))
    with pytest.raises(TypeError):
        embedding_bag_cuda(table, ids.reshape(2, 2))
