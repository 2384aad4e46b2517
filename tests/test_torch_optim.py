"""The port's dense optimizer updates (dlrm_flexflow_tpu_torch/optim.py)
against the JAX package's on the same parameters and gradients, on the
CPU.  JAX is imported here only.

Tolerances, each with its reason:
  * f32 parameters and slots: rtol 1e-6 and an atol of 1e-6 times the
    tensor's largest magnitude: XLA may fuse ``b*m + (1-b)*g`` into one
    multiply-add where torch rounds twice (one ulp), and a sum that
    cancels to near zero keeps the absolute size of that ulp;
  * a bf16 table: one bf16 ulp (rtol 2**-7): the f32 result above is
    rounded to bf16, and one ulp of f32 can cross a rounding boundary.
The port's update is in place: the tests also pin that it returns the
tensors it was given and advances ``step`` in place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dlrm_flexflow_tpu as ffj

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.bridge import _array

_CASES = {
    "sgd": dict(cls="SGDOptimizer", lr=0.1),
    "sgd_wd": dict(cls="SGDOptimizer", lr=0.1, weight_decay=0.01),
    "momentum": dict(cls="SGDOptimizer", lr=0.1, momentum=0.9),
    "nesterov_wd": dict(cls="SGDOptimizer", lr=0.1, momentum=0.9,
                        nesterov=True, weight_decay=0.01),
    "adam": dict(cls="AdamOptimizer", lr=0.01),
    "adam_wd": dict(cls="AdamOptimizer", lr=0.01, beta1=0.8, beta2=0.99,
                    weight_decay=0.01, epsilon=1e-6),
}


def _make(pkg, case):
    kw = dict(_CASES[case])
    return getattr(pkg, kw.pop("cls"))(**kw)


def _params(rng, table_dtype):
    params = {"dense": {"kernel": rng.standard_normal((8, 16)),
                        "bias": rng.standard_normal(16)},
              "emb": {"embedding": rng.standard_normal((32, 8)) * 0.05}}
    out = {op: {k: v.astype(np.float32) for k, v in d.items()}
           for op, d in params.items()}
    if table_dtype == "bfloat16":
        import ml_dtypes
        out["emb"]["embedding"] = out["emb"]["embedding"].astype(
            ml_dtypes.bfloat16)
    return out


def _to_torch(tree):
    def conv(a):
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {op: {k: conv(v) for k, v in d.items()} for op, d in tree.items()}


def _close(got, want, what):
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=2 ** -7,
                                   err_msg=what)
        return
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * scale, err_msg=what)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_CASES))
def test_dense_update_matches_jax(case, table_dtype):
    """Three updates with fresh gradients each: parameters, slots, step
    and lr against the JAX optimizer's, the slots f32 beside any table."""
    rng = np.random.default_rng(0)
    np_params = _params(rng, table_dtype)
    jopt, popt = _make(ffj, case), _make(fft, case)
    jp = {op: {k: jnp.asarray(v) for k, v in d.items()}
          for op, d in np_params.items()}
    pp = _to_torch(np_params)
    js, ps = jopt.init(jp), popt.init(pp)
    assert set(ps) == set(js)
    for i in range(3):
        grads = {op: {k: rng.standard_normal(v.shape).astype(np.float32)
                      for k, v in d.items()} for op, d in np_params.items()}
        if table_dtype == "bfloat16":
            import ml_dtypes
            grads["emb"]["embedding"] = grads["emb"]["embedding"].astype(
                ml_dtypes.bfloat16)
        jp, js = jopt.update(jp, {op: {k: jnp.asarray(v)
                                       for k, v in d.items()}
                                  for op, d in grads.items()}, js)
        step = ps["step"]
        out_p, out_s = popt.update(pp, _to_torch(grads), ps)
        assert out_p is pp and out_s is ps and ps["step"] is step
    assert int(ps["step"]) == int(js["step"]) == 3
    assert float(ps["lr"]) == float(js["lr"])
    for op, d in jp.items():
        for k, v in d.items():
            assert pp[op][k].dtype == (torch.bfloat16 if v.dtype.name ==
                                       "bfloat16" else torch.float32)
            _close(pp[op][k], v, f"{op}/{k}")
    for sn in popt.slot_names():
        for op, d in js[sn].items():
            for k, v in d.items():
                assert ps[sn][op][k].dtype == torch.float32
                _close(ps[sn][op][k], v, f"{sn}/{op}/{k}")


def test_adam_state_and_lazy_pieces_match_jax():
    """``slot_names``, the initial state's keys and dtypes, and the lazy
    row pieces at a step count of 4 (t = 5) against the JAX optimizer's,
    on the same rows."""
    rng = np.random.default_rng(1)
    jopt = ffj.AdamOptimizer(lr=0.01, weight_decay=0.001,
                             lazy_embeddings=True)
    popt = fft.AdamOptimizer(0.01, 0.9, 0.999, 0.001, 1e-8, True)
    assert popt.slot_names() == jopt.slot_names() == ("m", "v")
    assert popt.lazy_embeddings
    w, g, m, v = (rng.standard_normal((6, 8)).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v) * 1e-3
    jstate = {"step": jnp.asarray(4, jnp.int32),
              "lr": jnp.asarray(0.01, jnp.float32)}
    pstate = {"step": torch.tensor(4, dtype=torch.int32),
              "lr": torch.tensor(0.01)}
    t = {k: torch.from_numpy(a) for k, a in
         (("w", w), ("g", g), ("m", m), ("v", v))}
    jrows = jopt.lazy_slot_rows(jnp.asarray(w), jnp.asarray(g),
                                {"m": jnp.asarray(m), "v": jnp.asarray(v)},
                                jstate)
    prows = popt.lazy_slot_rows(t["w"], t["g"], {"m": t["m"], "v": t["v"]},
                                pstate)
    for sn in ("m", "v"):
        _close(prows[sn], jrows[sn], sn)
    _close(popt.lazy_weight_delta(t["w"], t["g"], prows, pstate),
           jopt.lazy_weight_delta(jnp.asarray(w), jnp.asarray(g), jrows,
                                  jstate), "delta")
    st = popt.init({"e": {"embedding": torch.zeros(4, 2,
                                                   dtype=torch.bfloat16)}})
    assert list(st) == ["step", "lr", "m", "v"]
    assert st["m"]["e"]["embedding"].dtype == torch.float32
    assert st["step"].dtype == torch.int32 and st["lr"].dtype == torch.float32


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_lazy_pieces_match_jax(momentum, nesterov):
    rng = np.random.default_rng(2)
    kw = dict(lr=0.1, momentum=momentum, nesterov=nesterov,
              weight_decay=0.01, lazy_embeddings=True)
    jopt, popt = ffj.SGDOptimizer(**kw), fft.SGDOptimizer(**kw)
    assert popt.slot_names() == jopt.slot_names()
    w, g, v = (rng.standard_normal((6, 8)).astype(np.float32)
               for _ in range(3))
    slots_j = {"v": jnp.asarray(v)} if momentum else {}
    slots_p = {"v": torch.from_numpy(v)} if momentum else {}
    jstate = {"lr": jnp.asarray(0.1, jnp.float32)}
    pstate = {"lr": torch.tensor(0.1)}
    jrows = jopt.lazy_slot_rows(jnp.asarray(w), jnp.asarray(g), slots_j,
                                jstate)
    prows = popt.lazy_slot_rows(torch.from_numpy(w), torch.from_numpy(g),
                                slots_p, pstate)
    assert set(prows) == set(jrows)
    for sn in prows:
        _close(prows[sn], jrows[sn], sn)
    _close(popt.lazy_weight_delta(torch.from_numpy(w), torch.from_numpy(g),
                                  prows, pstate),
           jopt.lazy_weight_delta(jnp.asarray(w), jnp.asarray(g), jrows,
                                  jstate), "delta")


def test_bridge_carries_adam_state_both_ways():
    """``opt_state_from_jax`` takes Adam's ``m`` beside ``step``, ``lr``
    and ``v``, in the JAX state's key order; anything else raises."""
    from dlrm_flexflow_tpu_torch.bridge import opt_state_from_jax
    rng = np.random.default_rng(3)
    params = {"d": {"kernel": jnp.asarray(
        rng.standard_normal((3, 2)).astype(np.float32))}}
    js = ffj.AdamOptimizer(0.01).init(params)
    got = opt_state_from_jax({k: (np.asarray(v) if k in ("step", "lr")
                                  else {op: {n: np.asarray(a)
                                             for n, a in d.items()}
                                        for op, d in v.items()})
                              for k, v in js.items()})
    assert list(got) == list(js)
    assert got["m"]["d"]["kernel"].dtype == torch.float32
    np.testing.assert_array_equal(_array(got["v"]["d"]["kernel"]),
                                  np.asarray(js["v"]["d"]["kernel"]))
    with pytest.raises(KeyError, match="Adam"):
        opt_state_from_jax({"step": np.int32(0), "mu": {}})
