"""Rank bodies of the port's mesh tests (``tests/test_torch_mesh.py``,
``test_torch_exchange.py``, ``test_torch_seq_parallel.py``).

Each function runs in every process of a gloo group started by
``dlrm_flexflow_tpu_torch.distributed.launch`` and imports neither JAX
nor the JAX package: the tests compute the JAX references in the pytest
process and hand the ranks the JAX weights and the data as ``.npz``
files.  Each scenario writes its results to ``.npz`` files that the
tests compare: rank 0 the global values, every rank its own blocks.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import params_from_jax, params_to_numpy
from dlrm_flexflow_tpu_torch.parallel import ParallelConfig, make_mesh


def unflatten(npz, prefix):
    out = {}
    for key in npz.files:
        if key.startswith(prefix):
            op, p = key[len(prefix):].split("/", 1)
            out.setdefault(op, {})[p] = npz[key]
    return out


def flat(tree, prefix):
    return {f"{prefix}{op}/{k}": v for op, d in tree.items()
            for k, v in d.items()}


# -------------------------------------------------------------- models
def build_dlrm_model(batch, tp=False, xmode="off", overlap="off",
                     bot=(4, 16, 8), tables=4, rows=64, dim=8, bag=2,
                     microbatches=2):
    cfg = DLRMConfig(sparse_feature_size=dim, embedding_size=[rows] * tables,
                     embedding_bag_size=bag, mlp_bot=list(bot),
                     mlp_top=[dim * tables + bot[-1], 16, 1],
                     exchange_overlap=overlap,
                     exchange_microbatches=microbatches)
    return build_dlrm(cfg, fft.FFConfig(batch_size=batch,
                                        table_exchange=xmode),
                      table_parallel=tp)


def build_tp_linear(batch, tp=True, model_ranks=2):
    m = fft.FFModel(fft.FFConfig(batch_size=batch))
    t = m.create_tensor((batch, 32), name="x")
    h = m.dense(t, 64, activation="relu", name="fc1")
    m.dense(h, 8, name="fc2")
    if tp:
        m.get_op("fc1").parallel_config = ParallelConfig(dims=(1, model_ranks))
    return m


def build_moe(batch, tp=True):
    m = fft.FFModel(fft.FFConfig(batch_size=batch))
    t = m.create_tensor((batch, 8), name="x")
    h = m.moe(t, num_experts=4, hidden_dim=16, top_k=2, name="moe")
    m.dense(h, 4)
    if tp:
        m.get_op("moe").parallel_config = ParallelConfig(dims=(1, 2))
    return m


def build_conv(batch, spatial=True):
    m = fft.FFModel(fft.FFConfig(batch_size=batch))
    x = m.create_tensor((batch, 3, 16, 16), name="img")
    h = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="c1")
    h = m.pool2d(h, 2, 2, 2, 2, 0, 0, name="p1")
    h = m.conv2d(h, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="c2")
    h = m.flat(h, name="f")
    m.dense(h, 4, name="out")
    if spatial:
        for n in ("c1", "c2", "p1"):
            m.get_op(n).parallel_config = ParallelConfig(dims=(2, 1, 2, 2))
    return m


def build_mha(batch, seq_parallel=True):
    m = fft.FFModel(fft.FFConfig(batch_size=batch))
    t = m.create_tensor((batch, 16, 32), name="x")
    m.multihead_attention(t, t, t, embed_dim=32, num_heads=4, causal=True,
                          seq_parallel=seq_parallel)
    return m


MODEL_FNS = {"dlrm": build_dlrm_model, "tp_linear": build_tp_linear,
            "moe": build_moe, "conv": build_conv, "mha": build_mha}


def run_model(case, mesh_shape, build_kw, data, out, steps=2, lr=0.05,
              forward=False, loss="mean_squared_error", overlap_op=None):
    """One training run under ``mesh_shape`` from the JAX weights: rank 0
    writes the losses and the gathered parameters, every rank its own
    blocks (``<out>.rank<i>.npz``)."""
    rank = dist.get_rank()
    d = np.load(data)
    m = MODEL_FNS[case](**build_kw)
    if overlap_op is not None:
        m.get_op(overlap_op[0]).overlap = overlap_op[1]
    m.compile(optimizer=fft.SGDOptimizer(lr=lr), loss_type=loss,
              metrics=("accuracy",), mesh=make_mesh(mesh_shape))
    st = m.load_params(params_from_jax(unflatten(d, "p/")), device="cpu")
    inputs = {k[3:]: d[k] for k in d.files if k.startswith("in/")}
    res = {}
    if forward:
        res["forward"] = m.forward(st, inputs).numpy()
    losses = []
    for _ in range(steps):
        st, mets = m.train_step(st, inputs, d["labels"])
        losses.append(float(mets["loss"]))
    res["losses"] = np.array(losses)
    res["correct"] = np.array(float(mets.get("train_correct", 0.0)))
    res["sparse"] = np.array([op.name for op in m._sparse_ops] or [""])
    # compile's one decision on kernels: off for every op and row update
    res["kernels_off"] = np.array(
        not any(op._allow_kernel for op in m.layers)
        and m._row_update.__name__ == "row_update_ref")
    res.update(flat(params_to_numpy(st.params), "p/"))
    if rank == 0:
        np.savez(out, **res)
    np.savez(f"{out}.rank{rank}.npz",
             **flat({op: {k: v.detach().numpy() for k, v in dd.items()}
                     for op, dd in st.params.items()}, "p/"))


def run_cases(cases):
    """Run each case (keyword dicts of :func:`run_model`) in order."""
    for case in json.loads(cases):
        run_model(**case)


def build_coupled(batch, tp=False):
    """Ops that mix batch rows (batch norm, dropout, a softmax output)
    around a conv and a Linear, channel parallel with ``tp``."""
    m = fft.FFModel(fft.FFConfig(batch_size=batch))
    x = m.create_tensor((batch, 3, 8, 8), name="img")
    h = m.conv2d(x, 4, 3, 3, 1, 1, 1, 1, name="c1")
    h = m.batch_norm(h, relu=True, name="bn")
    h = m.dropout(h, 0.3, name="drop")
    h = m.flat(h, name="f")
    h = m.dense(h, 16, activation="relu", name="d1")
    m.softmax(m.dense(h, 5, name="d2"), name="sm")
    if tp:
        m.get_op("d1").parallel_config = ParallelConfig(dims=(2, 2))
    return m


def _port_run(build, mesh, opt, inputs, labels, loss, steps=3):
    m = build()
    m.compile(optimizer=opt(), loss_type=loss, metrics=("accuracy",),
              mesh=mesh)
    st = m.init(seed=0, device="cpu")
    losses = []
    for _ in range(steps):
        st, mets = m.train_step(st, inputs, labels)
        losses.append(float(mets["loss"]))
    out = {"losses": np.array(losses),
           "predict": m.predict(st, inputs).numpy()}
    out.update(flat(params_to_numpy(st.params), "p/"))
    out.update(flat({k: {s: t.numpy().copy() for s, t in d.items()}
                     for k, d in st.bn_state.items()}, "bn/"))
    # the optimizer's slot tables, gathered as the state's global values
    from dlrm_flexflow_tpu_torch.bridge import state_to_numpy
    for sn, slots in state_to_numpy(st)["opt_state"].items():
        if isinstance(slots, dict):
            out.update(flat(slots, f"slot/{sn}/"))
    return out


def run_against_one_device(out):
    """Paths held to the port's own one-device run: batch norm, dropout
    and a softmax output under {"data": 4} and beside a channel-parallel
    Linear on {"data": 2, "model": 2} (momentum SGD, sparse CCE); lazy
    Adam on the row-sparse DLRM under {"data": 4}; ``train_epoch`` and
    ``fit`` under {"data": 4}."""
    from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader
    rng = np.random.default_rng(0)
    img = rng.standard_normal((8, 3, 8, 8)).astype(np.float32)
    cls = rng.integers(0, 5, size=(8, 1))
    dense = rng.standard_normal((16, 4)).astype(np.float32)
    sparse = rng.integers(0, 64, size=(16, 4, 2))
    lab = rng.integers(0, 2, size=(16, 1)).astype(np.float32)
    res = {}
    for name, shape, build, opt, ins, lb, loss in [
            ("coupled_dp", {"data": 4}, lambda: build_coupled(8),
             lambda: fft.SGDOptimizer(lr=0.05, momentum=0.9),
             {"img": img}, cls, "sparse_categorical_crossentropy"),
            ("coupled_tp", {"data": 2, "model": 2},
             lambda: build_coupled(8, tp=True),
             lambda: fft.SGDOptimizer(lr=0.05, momentum=0.9),
             {"img": img}, cls, "sparse_categorical_crossentropy"),
            ("lazy_adam", {"data": 4}, lambda: build_dlrm_model(16),
             lambda: fft.AdamOptimizer(lr=0.01, lazy_embeddings=True),
             {"dense": dense, "sparse": sparse}, lab,
             "mean_squared_error")]:
        for tag, mesh in (("mesh", make_mesh(shape)), ("one", False)):
            got = _port_run(build, mesh, opt, ins, lb, loss)
            res.update({f"{name}/{tag}/{k}": v for k, v in got.items()})
    for tag, mesh in (("mesh", make_mesh({"data": 4})), ("one", False)):
        m = build_dlrm_model(16)
        m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
                  loss_type="mean_squared_error", metrics=(), mesh=mesh)
        st = m.init(seed=0, device="cpu")
        ins = {"dense": dense, "sparse": sparse}
        st, folded = m.train_epoch(st, {k: np.stack([v, v[::-1]])
                                        for k, v in ins.items()},
                                   np.stack([lab, lab[::-1]]))
        st, _ = m.fit(st, ArrayDataLoader(ins, lab, 8, shuffle=False),
                      epochs=1, verbose=False)
        res[f"epochs/{tag}/loss"] = np.array(float(folded["loss"]))
        res.update({f"epochs/{tag}/{k}": v for k, v in
                    flat(params_to_numpy(st.params), "p/").items()})
    if dist.get_rank() == 0:
        np.savez(out, **res)


def run_mesh4(cases, internal):
    """The 4-rank scenarios of ``tests/test_torch_mesh.py``."""
    run_cases(cases)
    run_against_one_device(internal)


def run_exchange_group(cases, lookup, overlap, louts):
    """The exchange test's scenarios in one group."""
    run_cases(cases)
    run_lookup(lookup, louts["lookup"])
    run_overlap(overlap, louts["overlap"])


# --------------------------------------------------------- collectives
def run_lookup(data, out):
    """``table_parallel_lookup`` in both modes, with and without an int8
    scale, forward and the tables' gradient of ``sum(out ** 2)`` on
    {"data": 2, "model": 2}."""
    from dlrm_flexflow_tpu_torch.parallel.collectives import (
        all_reduce_sum_, global_value, local_block)
    from dlrm_flexflow_tpu_torch.parallel.mesh import PartitionSpec as P
    from dlrm_flexflow_tpu_torch.parallel.table_exchange import (
        table_parallel_lookup)
    d = np.load(data)
    mesh = make_mesh({"data": 2, "model": 2})
    tspec, ispec = P("model", None, None), P("data", None, None)
    ids = local_block(torch.from_numpy(d["ids"]), ispec, mesh)
    res = {}
    for mode in ("allgather", "all_to_all"):
        ospec = (P("data", None, None) if mode == "allgather"
                 else P(("data", "model"), None, None))
        tables = local_block(torch.from_numpy(d["tables"]), tspec,
                             mesh).requires_grad_()
        got = table_parallel_lookup(tables, ids, mesh, "sum", mode)
        res[f"{mode}/out"] = global_value(got.detach(), ospec, mesh).numpy()
        # a sum over the rows: each row's ranks share its gradient
        replicas = 2 if mode == "allgather" else 1
        (g,) = torch.autograd.grad((got ** 2).sum() / replicas, tables)
        all_reduce_sum_(g, mesh, ("data",))
        res[f"{mode}/grad"] = global_value(g, tspec, mesh).numpy()
        q = local_block(torch.from_numpy(d["qtables"]), tspec, mesh)
        t_loc, r = q.shape[0], q.shape[1]
        j = mesh.axis_index(("model",))
        qs = torch.from_numpy(d["qscale"])[j * t_loc * r:(j + 1) * t_loc * r]
        got = table_parallel_lookup(q, ids.clamp(0, d["tables"].shape[1] - 1),
                                    mesh, "sum", mode, qscale=qs)
        res[f"{mode}/qout"] = global_value(got, ospec, mesh).numpy()
    if dist.get_rank() == 0:
        np.savez(out, **res)


def run_overlap(data, out):
    """``overlapped_embed_bottom`` against the serial exchange and dense
    stack in both modes on {"data": 2, "model": 2}, values and the
    tables' and dense weights' gradients."""
    from dlrm_flexflow_tpu_torch.ops.base import matmul
    from dlrm_flexflow_tpu_torch.parallel.collectives import (
        all_reduce_sum_, global_value, local_block)
    from dlrm_flexflow_tpu_torch.parallel.mesh import PartitionSpec as P
    from dlrm_flexflow_tpu_torch.parallel.overlap import (
        microbatch_ok, overlapped_embed_bottom)
    from dlrm_flexflow_tpu_torch.parallel.table_exchange import (
        table_parallel_lookup)
    d = np.load(data)
    mesh = make_mesh({"data": 2, "model": 2})
    res = {"microbatch_ok": np.array(
        [microbatch_ok(16, 2, 2, "all_to_all"), microbatch_ok(6, 2, 2,
                                                              "all_to_all"),
         microbatch_ok(6, 2, 2, "allgather"), microbatch_ok(6, 2, 1,
                                                            "allgather")])}

    def dense_fn(p, x):
        return torch.relu(matmul(x, p["w"]))

    for mode in ("allgather", "all_to_all"):
        ospec = (P("data", None, None) if mode == "allgather"
                 else P(("data", "model"), None, None))
        for k in (1, 2, 4):
            tables = local_block(torch.from_numpy(d["tables"]),
                                 P("model", None, None),
                                 mesh).requires_grad_()
            ids = local_block(torch.from_numpy(d["ids"]),
                              P("data", None, None), mesh)
            dense = local_block(torch.from_numpy(d["dense"]),
                                P("data", None), mesh)
            w = torch.from_numpy(d["w"]).requires_grad_()
            if k == 1:
                emb = table_parallel_lookup(tables, ids, mesh, "sum", mode)
                bottom = dense_fn({"w": w}, dense)
                if mode == "all_to_all":
                    n = bottom.shape[0] // 2
                    j = mesh.axis_index(("model",))
                    bottom = bottom[j * n:(j + 1) * n]
            else:
                emb, bottom = overlapped_embed_bottom(
                    tables, ids, dense, mesh, dense_fn, {"w": w}, "sum",
                    mode, k)
            loss = (emb ** 2).sum() + (bottom ** 3).sum()
            replicas = 2 if mode == "allgather" else 1
            gt, gw = torch.autograd.grad(loss / replicas, (tables, w))
            all_reduce_sum_(gt, mesh, ("data",))
            all_reduce_sum_(gw, mesh, ("data", "model"))
            key = f"{mode}/k{k}"
            res[f"{key}/emb"] = global_value(emb.detach(), ospec,
                                             mesh).numpy()
            res[f"{key}/bottom"] = global_value(
                bottom.detach(), P(*tuple(ospec)[:2]), mesh).numpy()
            res[f"{key}/gt"] = global_value(gt, P("model", None, None),
                                            mesh).numpy()
            res[f"{key}/gw"] = gw.numpy()
    if dist.get_rank() == 0:
        np.savez(out, **res)


def run_attention(data, out):
    """Ring and Ulysses attention, causal and not, forward and the input
    gradients of ``sum(out ** 2)``, on {"seq": 4} and {"data": 2,
    "seq": 2}; the sequence-parallel MHA op; the SPMD pipeline on
    {"pipe": 4}."""
    from dlrm_flexflow_tpu_torch.parallel.collectives import all_reduce_sum_
    from dlrm_flexflow_tpu_torch.parallel.pipeline import (
        pipeline_loss_and_grad, place_stage_params, spmd_pipeline)
    from dlrm_flexflow_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)
    from dlrm_flexflow_tpu_torch.parallel.ulysses import (
        ulysses_attention_sharded)
    d = np.load(data)
    res = {}
    fns = {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}
    for mshape, tag in (({"seq": 4}, "s4"), ({"data": 2, "seq": 2}, "d2s2")):
        mesh = make_mesh(mshape)
        for name, fn in fns.items():
            for causal in (False, True):
                qkv = [torch.from_numpy(d[n]).requires_grad_()
                       for n in ("q", "k", "v")]
                o = fn(*qkv, mesh, causal=causal)
                grads = torch.autograd.grad((o ** 2).sum() / mesh.size, qkv)
                key = f"{tag}/{name}/{int(causal)}"
                res[f"{key}/out"] = o.detach().numpy()
                for n, g in zip("qkv", grads):
                    res[f"{key}/d{n}"] = all_reduce_sum_(
                        g, mesh, tuple(mshape)).numpy()
        mesh = make_mesh(mshape)
        x6 = torch.zeros((2, 6, 16, 8))
        try:
            ulysses_attention_sharded(x6, x6, x6, mesh)
            res[f"{tag}/ulysses_assert"] = np.array(0)
        except AssertionError:
            res[f"{tag}/ulysses_assert"] = np.array(1)
    # the sequence-parallel op, forward and two steps
    mesh = make_mesh({"data": 2, "seq": 2})
    m = build_mha(4, seq_parallel=True)
    lr = float(d["mha_lr"])
    m.compile(optimizer=fft.SGDOptimizer(lr=lr),
              loss_type="mean_squared_error", metrics=(), mesh=mesh)
    st = m.load_params(params_from_jax(unflatten(d, "mha/")), device="cpu")
    res["mha/forward"] = m.forward(st, {"x": d["mha_x"]}).numpy()
    losses = []
    for _ in range(2):
        st, mets = m.train_step(st, {"x": d["mha_x"]}, d["mha_y"])
        losses.append(float(mets["loss"]))
    res["mha/losses"] = np.array(losses)
    res.update(flat(params_to_numpy(st.params), "mhap/"))
    one = build_mha(4, seq_parallel=True)
    one.compile(optimizer=fft.SGDOptimizer(lr=lr),
                loss_type="mean_squared_error", metrics=(), mesh=False)
    s1 = one.load_params(params_from_jax(unflatten(d, "mha/")), device="cpu")
    for _ in range(2):
        s1, _ = one.train_step(s1, {"x": d["mha_x"]}, d["mha_y"])
    res.update(flat(params_to_numpy(s1.params), "mha1p/"))
    # the pipeline
    mesh = make_mesh({"pipe": 4})
    params = {"w": torch.from_numpy(d["pipe_w"]),
              "b": torch.from_numpy(d["pipe_b"])}
    placed = place_stage_params(params, mesh)
    res["pipe/local_w_shape"] = np.array(placed["w"].shape)

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    x = torch.from_numpy(d["pipe_x"])
    res["pipe/out"] = spmd_pipeline(stage_fn, mesh, 8)(placed, x).numpy()
    res["pipe/out4"] = np.concatenate(
        [spmd_pipeline(stage_fn, mesh, 4)(placed, x[:4]).numpy(),
         spmd_pipeline(stage_fn, mesh, 4)(placed, x[4:]).numpy()])
    lg = pipeline_loss_and_grad(stage_fn, lambda p, t: ((p - t) ** 2).mean(),
                                mesh, 8)
    loss, grads = lg(placed, x, torch.zeros_like(x))
    res["pipe/loss"] = loss.numpy()
    from dlrm_flexflow_tpu_torch.parallel.collectives import global_value
    from dlrm_flexflow_tpu_torch.parallel.mesh import PartitionSpec as P
    res["pipe/gw"] = global_value(grads["w"], P("pipe", None, None),
                                  mesh).numpy()
    if dist.get_rank() == 0:
        np.savez(out, **res)


# ------------------------------------------------------------ two hosts
def run_host_shards(data, out):
    """Two processes, each feeding only its rows through a
    ``HostShardLoader`` into a {"data": 2} table-parallel-free DLRM, by
    ``train_step`` and by ``fit``; the topology the group reports."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader
    d = np.load(data)
    mesh = make_mesh({"data": 2})
    topo = fdist.topology()
    res = {"topology": np.array([topo["process_index"],
                                 topo["process_count"],
                                 topo["global_devices"], topo["slices"]]),
           "host_slice": np.array([fdist.host_local_batch(32).start,
                                   fdist.host_local_batch(32).stop])}
    inputs = {"dense": d["in/dense"], "sparse": d["in/sparse"]}
    loader = ArrayDataLoader(inputs, d["labels"], 16, shuffle=False)
    m = build_dlrm_model(16)
    m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=(), mesh=mesh)
    p0 = params_from_jax(unflatten(d, "p/"))
    st = m.load_params(p0, device="cpu")
    losses = []
    for ins, lab in fdist.HostShardLoader(loader, mesh):
        assert ins["dense"].local.shape[0] == 8
        st, mets = m.train_step(st, ins, lab)
        losses.append(float(mets["loss"]))
    res["losses"] = np.array(losses)
    res.update(flat(params_to_numpy(st.params), "p/"))
    from dlrm_flexflow_tpu_torch.telemetry.fleet import predicted_sync_ms
    res["predicted_sync_ms"] = np.array(predicted_sync_ms(st.params))
    st2 = m.load_params(p0, device="cpu")
    st2, _ = m.fit(st2, fdist.HostShardLoader(loader, mesh), epochs=1,
                   verbose=False, warmup=False)
    res.update(flat(params_to_numpy(st2.params), "fit/"))
    if dist.get_rank() == 0:
        np.savez(out, **res)
