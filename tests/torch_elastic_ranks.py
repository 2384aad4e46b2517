"""Rank bodies of the port's elastic tests (``tests/test_torch_elastic.py``).

Each function runs in every process of a gloo group started by
``dlrm_flexflow_tpu_torch.distributed.launch`` and imports neither JAX
nor the JAX package: the tests compute the JAX references in the pytest
process and hand the ranks the JAX weights and the data as ``.npz``
files.  Each body writes its results (rank 0, or each rank under its own
name) to ``.npz`` / ``.json`` files the tests compare.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import dlrm_flexflow_tpu_torch as fft
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.bridge import (opt_state_from_jax,
                                            params_from_jax)
from dlrm_flexflow_tpu_torch.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from dlrm_flexflow_tpu_torch.elastic import gather_state, recover_and_resume
from dlrm_flexflow_tpu_torch.model import TrainState
from dlrm_flexflow_tpu_torch.parallel import make_mesh
from dlrm_flexflow_tpu_torch.resilience import (CheckpointManager,
                                                FleetBarrierTimeout,
                                                HostLost, faultinject)
from dlrm_flexflow_tpu_torch.serving import InferenceEngine
from dlrm_flexflow_tpu_torch.telemetry import event_log

#: every engine's buckets (a sharded engine on {"data": 4} rounds to 4, 8)
BUCKETS = "1,8"


def two_proc_model(mesh, batch=32):
    """``scripts/check_pod.py::two_proc_model``'s DLRM: 4 tables of 64 x 8,
    bag 2, bottom 4-16-8, top 40-16-1, table-parallel, SGD lr 0.05."""
    cfg = DLRMConfig(sparse_feature_size=8, embedding_size=[64] * 4,
                     embedding_bag_size=2, mlp_bot=[4, 16, 8],
                     mlp_top=[8 * 4 + 8, 16, 1])
    m = build_dlrm(cfg, fft.FFConfig(batch_size=batch, serve_buckets=BUCKETS),
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


def flat_state(st) -> dict:
    """A gathered (host numpy) state as flat ``field/op/param`` arrays."""
    out = {}
    for field in ("params", "opt_state"):
        for k, v in getattr(st, field).items():
            if isinstance(v, dict):
                for op, d in v.items():
                    if isinstance(d, dict):
                        for p, a in d.items():
                            out[f"{field}/{k}/{op}/{p}"] = a
                    else:
                        out[f"{field}/{k}/{op}"] = d
            else:
                out[f"{field}/{k}"] = v
    out["rng"], out["step"] = st.rng, st.step
    return out


def batch(d, t):
    return ({"dense": d["dense"][t], "sparse": d["sparse"][t]},
            d["labels"][t])


def _steps(m, st, d, lo, hi):
    losses = []
    for t in range(lo, hi):
        st, mets = m.train_step(st, *batch(d, t))
        losses.append(float(mets["loss"]))
    return st, losses


def _kernels_off(m) -> bool:
    return (not any(op._allow_kernel for op in m.layers)
            and m._row_update.__name__ == "row_update_ref")


def ckpt_stages(events):
    """The seconds of each checkpoint stage span in ``events`` (``d2h``,
    ``write``, ..., a barrier as ``barrier_<phase>``), and whether each
    is a child of the one ``ckpt.save`` or ``ckpt.restore`` span."""
    spans = [e for e in events if e["type"] == "span"]
    top = [e["span_id"] for e in spans
           if e["name"] in ("ckpt.save", "ckpt.restore")]
    stages, parented = {}, len(top) == 1
    for e in spans:
        if e["name"].startswith("ckpt.") and e["span_id"] not in top:
            name = e["name"][len("ckpt."):]
            if name == "barrier":
                name += "_" + e["attrs"]["phase"]
            stages[name] = stages.get(name, 0.0) + e["dur_us"] / 1e6
            parented = parented and e["parent_id"] in top
    return stages, parented


# ------------------------------------------------------------------ pod4
def run_pod4(data, ckpt, out, new_store, deadline_s, hang_s, flight):
    """(a), (d) and (e) on four ranks: two steps on {"data": 2, "model":
    2} from the JAX weights, a podshard commit through
    CheckpointManager(multihost=None), the logical state gathered; one
    more step, then a second save at which ranks 2 and 3 hang at the
    barrier (``host_hang@barrier``): ranks 0 and 1 raise
    FleetBarrierTimeout naming them, ranks 2 and 3 wake (HostLost) and
    die; the two survivors recover_and_resume at world 2 on {"data": 1,
    "model": 2} and take two more steps."""
    rank = dist.get_rank()
    d = np.load(data)
    m = two_proc_model(make_mesh({"data": 2, "model": 2}))
    st = m.load_params(params_from_jax(unflatten(d, "p/")), device="cpu")
    st, first = _steps(m, st, d, 0, 2)
    mgr = CheckpointManager(ckpt, barrier_timeout_s=deadline_s)
    with event_log() as log:
        path = mgr.save(st, model=m, extra={"batches_done": 2})
    stages, parented = ckpt_stages(log.events())
    logical = gather_state(st)  # a collective: every rank
    if rank == 0:
        np.savez(os.path.join(os.path.dirname(out), "logical.npz"),
                 **flat_state(logical))
    st, third = _steps(m, st, d, 2, 3)
    if rank >= 2:  # the two ranks lost at the next save's barrier
        os.environ["FF_HANG_S"] = str(hang_s)
        faultinject.install("host_hang@barrier")
        try:
            mgr.save(st, model=m)
        except HostLost:
            pass
        sys.stdout.flush()
        os._exit(0)  # a lost host runs no teardown
    os.environ["FF_FLIGHT_DIR"] = os.path.join(flight, f"r{rank}")
    res = {"path": path, "first": first, "third": third, "stages": stages,
           "stages_parented": parented}
    t0 = time.perf_counter()
    with event_log() as log:
        try:
            mgr.save(st, model=m)
            res["raised"] = None
        except FleetBarrierTimeout as e:
            res.update(raised=type(e).__name__, missing=list(e.missing),
                       message=str(e))
        res["timeout_wall_s"] = time.perf_counter() - t0
        res["events"] = [e for e in log.events()
                         if e["type"] in ("recovery", "checkpoint", "fault")]
    res["flight"] = sorted(os.listdir(os.environ["FF_FLIGHT_DIR"]))
    del m, st

    def build():
        return two_proc_model(make_mesh({"data": 1, "model": 2}))

    with event_log() as log:
        m2, st2, extra, rpath = recover_and_resume(
            ckpt, build, coordinator_address=new_store, num_processes=2,
            process_id=rank, device="cpu")
        res["resume_events"] = [e for e in log.events()
                                if e["type"] in ("recovery", "elastic")]
    res.update(resumed_path=rpath, extra=extra,
               world=dist.get_world_size(),
               resumed_step=int(st2.step), kernels_off=_kernels_off(m2))
    st2, resumed = _steps(m2, st2, d, 2, 4)
    res["resumed"] = resumed
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


# --------------------------------------------------------------- group8
def _serve(m, st, requests, out_prefix, res):
    """Serve ``requests`` through a mesh engine: the leader predicts and
    closes, every other rank follows; rank 0 records the outputs."""
    eng = InferenceEngine(m, st, device="cpu")
    res[f"{out_prefix}buckets"] = list(eng.buckets)
    res[f"{out_prefix}sharded"] = bool(eng._mesh_sharded)
    if eng.is_leader:
        outs = [eng.predict(r) for r in requests]
        eng.close()
        res[f"{out_prefix}outputs"] = [o.tolist() for o in outs]
    else:
        res[f"{out_prefix}followed"] = eng.follow()
    return eng


def _requests(path):
    r = np.load(path)
    sizes = [int(x) for x in r["sizes"]]
    out, lo = [], 0
    for n in sizes:
        out.append({"dense": r["dense"][lo:lo + n],
                    "sparse": r["sparse"][lo:lo + n]})
        lo += n
    return out


def run_group8(data, state, ckpt, out, requests):
    """(c) and (g) on eight ranks, {"data": 4, "model": 2}: the JAX state
    after one step (its params, optimizer state, key and step) saved with
    multihost=False (a collective; rank 0 writes the npz), then the mesh
    engine over it serving the requests."""
    rank = dist.get_rank()
    d = np.load(state)
    m = two_proc_model(make_mesh({"data": 4, "model": 2}))
    st = m.load_params(params_from_jax(unflatten(d, "p/")), device="cpu",
                       opt_state=opt_state_from_jax(
                           {"step": d["opt/step"], "lr": d["opt/lr"]}))
    st = TrainState(st.params, st.opt_state, st.bn_state,
                    torch.from_numpy(np.array(d["rng"])),
                    torch.from_numpy(np.array(d["step"])))
    save_checkpoint(ckpt, st, model=m)
    res = {"wrote": sorted(os.listdir(ckpt)) if rank == 0 else None}
    _serve(m, st, _requests(requests), "", res)
    res["kernels_off"] = _kernels_off(m)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


# ----------------------------------------------------------------- pair
def run_pair(data, jax_pod, requests, reshape_dir, out):
    """(b), (f) and (g) on two ranks: the JAX podshard resharded onto
    {"data": 2}; the table-parallel engine on {"model": 2} (sharded) and
    the data-parallel one on {"data": 2} (a replica); the relaunch after
    a preempt+reshape onto its {"data": 1, "model": 2} target through
    resilient_fit's resume."""
    rank = dist.get_rank()
    res = {}
    d = np.load(data)
    # (b) the JAX package's podshard onto {"data": 2}
    m = two_proc_model(make_mesh({"data": 2}))
    st = restore_checkpoint(jax_pod, m, on_mesh_change="reshard",
                            device="cpu")
    np.savez(f"{out}.b.rank{rank}.npz",
             **flat_state(TrainState(
                 {op: {k: v.numpy() for k, v in dd.items()}
                  for op, dd in st.params.items()},
                 {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                  for k, v in st.opt_state.items()},
                 {}, st.rng.numpy(), st.step.numpy())))
    # (g) the engines over the JAX weights
    reqs = _requests(requests)
    for tag, shape in (("model2_", {"model": 2}), ("data2_", {"data": 2})):
        # no "model" axis: the table-parallel strategy replicates the
        # tables, so the {"data": 2} engine is a replica
        m = two_proc_model(make_mesh(shape))
        st = m.load_params(params_from_jax(unflatten(d, "p/")),
                           device="cpu")
        _serve(m, st, reqs, tag, res)
    # (f) the relaunch onto the reshape's target mesh
    target = json.load(open(os.path.join(reshape_dir, "target.json")))
    m = two_proc_model(make_mesh(target))
    st = m.init(seed=0, device="cpu")
    loader = fft.ArrayDataLoader(
        {"dense": d["fit_dense"], "sparse": d["fit_sparse"]},
        d["fit_labels"], 32)
    with event_log() as log:
        m.fit(st, loader, epochs=2, verbose=False,
              checkpoint_manager=CheckpointManager(
                  os.path.join(reshape_dir, "ckpt")),
              checkpoint_every_n_steps=2, resume=True)
        res["f_events"] = [e for e in log.events() if e["type"] == "elastic"]
    res["f_steps"] = m._fit_loss_steps.tolist()
    res["f_trace"] = m._fit_loss_trace.tolist()
    res["f_kernels_off"] = _kernels_off(m)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)

