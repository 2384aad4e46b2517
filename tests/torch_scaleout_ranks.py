"""Rank bodies of ``tests/test_torch_scaleout.py``: host-placed (hetero)
tables and quantized serving under a mesh of ranks.

Each function runs in every process of a gloo group started by
``dlrm_flexflow_tpu_torch.distributed.launch`` and imports neither JAX
nor the JAX package: the test computes the JAX references in the pytest
process and hands the ranks the JAX weights, tables, batches and
requests as one ``.npz`` file.  Each rank writes its results to
``<out>.rank<i>.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

import dlrm_flexflow_tpu_torch as fft
import dlrm_flexflow_tpu_torch.model as pmodel
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import params_from_jax, params_to_numpy
from dlrm_flexflow_tpu_torch.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from dlrm_flexflow_tpu_torch.ops import hetero
from dlrm_flexflow_tpu_torch.parallel import ParallelConfig, make_mesh
from dlrm_flexflow_tpu_torch.serving import InferenceEngine

#: the hetero DLRM of ``tests/test_torch_hetero.py``: two per-table
#: embeddings of 40 and 60 rows of 8, bag 2, SGD at lr 0.1
TABLES = [40, 60]
D, BAG, BATCH, LR = 8, 2, 8, 0.1
STEPS = 3
#: the quantized engines' table-parallel DLRM (``scripts/check_pod.py``'s
#: shapes): 4 stacked tables of 64 x 8, bag 2
QTABLES, QROWS = 4, 64


def hetero_model(mesh, cpu=(0, 1), buckets="8"):
    cfg = DLRMConfig(sparse_feature_size=D, embedding_size=list(TABLES),
                     embedding_bag_size=BAG, mlp_bot=[4, 8, D],
                     mlp_top=[D * 2 + D, 8, 1])
    m = build_dlrm(cfg, fft.FFConfig(batch_size=BATCH, serve_buckets=buckets),
                   stacked_embeddings=False)
    s = fft.Strategy()
    for i in cpu:
        s[f"emb_{i}"] = ParallelConfig(dims=(1, 1), device_type="cpu",
                                       device_ids=[0])
    m.compile(optimizer=fft.SGDOptimizer(lr=LR),
              loss_type="mean_squared_error", metrics=(), strategy=s,
              mesh=mesh)
    return m


def quant_model(mesh, xmode="off", buckets="1,8"):
    cfg = DLRMConfig(sparse_feature_size=D, embedding_size=[QROWS] * QTABLES,
                     embedding_bag_size=BAG, mlp_bot=[4, 16, D],
                     mlp_top=[D * QTABLES + D, 16, 1])
    m = build_dlrm(cfg, fft.FFConfig(batch_size=32, serve_buckets=buckets,
                                     table_exchange=xmode),
                   table_parallel=True)
    m.compile(optimizer=fft.SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error", metrics=(), mesh=mesh)
    return m


def unflatten(npz, prefix):
    out = {}
    for key in npz.files:
        if key.startswith(prefix):
            op, p = key[len(prefix):].split("/", 1)
            out.setdefault(op, {})[p] = npz[key]
    return out


def batch(d, t):
    x = {"dense": d["dense"][t]}
    for i in range(len(TABLES)):
        x[f"sparse_{i}"] = d[f"sparse_{i}"][t]
    return x, d["labels"][t]


def requests(d, prefix, names):
    out, lo = [], 0
    for n in d["sizes"]:
        out.append({k: d[f"{prefix}{k}"][lo:lo + n] for k in names})
        lo += int(n)
    return out


def host_tables(m):
    """This rank's host tables (the owner's; none elsewhere)."""
    return {op.name: np.array(op.host_table.array) for op in m._hetero_ops
            if getattr(op, "host_table", None) is not None}


def serve(eng, reqs, res, key):
    """The leader predicts and closes, every other rank follows."""
    res[f"{key}/buckets"] = np.array(eng.buckets)
    res[f"{key}/sharded"] = np.array(eng._mesh_sharded)
    if eng.is_leader:
        for i, r in enumerate(reqs):
            res[f"{key}/out{i}"] = eng.predict(r)
        eng.close()
    else:
        res[f"{key}/followed"] = np.array(eng.follow())


def run_hetero(data, cases, out, ckpt=None):
    """Each hetero case ``(tag, mesh shape, host-placed tables)``: the
    JAX initial weights and tables, three steps (the losses, the gathered
    params, the owner's tables and every rank's held table bytes and
    host updates).  With ``ckpt`` the first case also saves a podshard and
    a gathered npz, restores the podshard onto a {"model": 2} mesh, and
    serves the requests through a mesh engine."""
    rank = dist.get_rank()
    d = np.load(data)
    res = {}
    for n, (tag, shape, cpu) in enumerate(cases):
        m = hetero_model(make_mesh(shape), tuple(cpu))
        st = m.load_params(params_from_jax(unflatten(d, f"{tag}/p/")),
                           device="cpu",
                           host_tables={
                               k[len(f"{tag}/t/"):]: d[k] for k in d.files
                               if k.startswith(f"{tag}/t/")})
        updates = []
        real = hetero.apply_host_sgd

        def counted(table, lr):
            updates.append(table.key)
            return real(table, lr)
        pmodel.apply_host_sgd = counted
        losses = []
        try:
            with hetero.timing() as parts:
                for t in range(STEPS):
                    st, mets = m.train_step(st, *batch(d, t))
                    losses.append(float(mets["loss"]))
        finally:
            pmodel.apply_host_sgd = real
        # the mesh's forward (the plan's host bag, rows in the data
        # sharding, gathered): every rank calls it
        res[f"{tag}/forward"] = m.forward(st, batch(d, 0)[0]).numpy()
        res[f"{tag}/losses"] = np.array(losses)
        res[f"{tag}/updates"] = np.array(len(updates))
        res[f"{tag}/parts"] = np.array([parts[k] for k in hetero.PARTS])
        res[f"{tag}/held_bytes"] = np.array(sum(
            a.nbytes for a in host_tables(m).values()))
        for op, dd in params_to_numpy(st.params).items():
            for k, v in dd.items():
                res[f"{tag}/p/{op}/{k}"] = v
        for op, a in host_tables(m).items():
            res[f"{tag}/t/{op}"] = a
        if ckpt is None or n:
            continue
        pod, npz = os.path.join(ckpt, "pod"), os.path.join(ckpt, "npz")
        if rank == 0:
            os.makedirs(pod, exist_ok=True)
        dist.barrier()
        save_checkpoint(pod, st, model=m, multihost=True)
        save_checkpoint(npz, st, model=m)
        dist.barrier()
        # the reshard restore onto another mesh: the owner takes them
        m2 = hetero_model(make_mesh({"model": 2}))
        m2.init(seed=1, device="cpu")  # tables to be overwritten
        st2 = restore_checkpoint(pod, m2, on_mesh_change="reshard",
                                 device="cpu")
        res["restored/held_bytes"] = np.array(sum(
            a.nbytes for a in host_tables(m2).values()))
        for op, a in host_tables(m2).items():
            res[f"restored/t/{op}"] = a
        res["restored/step"] = st2.step.numpy()
        # the mesh engine over the stepped state (a replica: every
        # parameter is replicated), the owner's lookup per bucket
        serve(InferenceEngine(m, st, device="cpu"),
              requests(d, "req/", ["dense", "sparse_0", "sparse_1"]), res,
              "serve")
        # the epoch entry points from the same start: the owner's
        # tables, and nothing on the other ranks
        x = {k: d[k] for k in ("dense", "sparse_0", "sparse_1")}
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in x.items()}
        for how in ("epochs", "fit"):
            m3 = hetero_model(make_mesh(shape), tuple(cpu))
            st3 = m3.load_params(
                params_from_jax(unflatten(d, f"{tag}/p/")), device="cpu",
                host_tables={k[len(f"{tag}/t/"):]: d[k] for k in d.files
                             if k.startswith(f"{tag}/t/")})
            if how == "epochs":
                m3.train_epochs(st3, x, d["labels"], 1)
            else:
                m3.fit(st3, fft.ArrayDataLoader(
                    flat, d["labels"].reshape(-1, 1), BATCH), epochs=1,
                    verbose=False, warmup=False)
            res[f"{how}/held_bytes"] = np.array(sum(
                a.nbytes for a in host_tables(m3).values()))
            for op, a in host_tables(m3).items():
                res[f"{how}/t/{op}"] = a
    np.savez(f"{out}.rank{rank}.npz", **res)


def run_quant(data, cases, out):
    """Each quantized case ``(tag, mesh shape, mode, exchange)``: the
    table-parallel DLRM from the JAX weights served through a mesh engine
    quantized at load."""
    rank = dist.get_rank()
    d = np.load(data)
    res = {}
    reqs = requests(d, "qreq/", ["dense", "sparse"])
    for tag, shape, mode, xmode in cases:
        m = quant_model(make_mesh(shape), xmode)
        st = m.load_params(params_from_jax(unflatten(d, "q/p/")),
                           device="cpu")
        eng = InferenceEngine(m, st, device="cpu", quantize=mode)
        res[f"{tag}/bytes"] = np.array([eng.quantization["bytes_before"],
                                        eng.quantization["bytes_after"]])
        res[f"{tag}/scale_replicated"] = np.array(all(
            getattr(p.get("qscale__"), "_ff_layout", None) is None
            for p in eng._params.values()))
        serve(eng, reqs, res, tag)
    np.savez(f"{out}.rank{rank}.npz", **res)


def run_group(hetero_kw=None, quant_kw=None):
    """One rank group's scenarios: the hetero runs, then the quantized
    engines."""
    if hetero_kw:
        run_hetero(**hetero_kw)
    if quant_kw:
        run_quant(**quant_kw)
    torch.distributed.barrier()
