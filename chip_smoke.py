#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dlrm_flexflow_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build every kernel in dlrm_flexflow_tpu_torch/csrc with nvcc;
  3. hold the fused forward kernel against its plain versions on the
     card through both entries: pre-masked flat ids, and the op's local
     ids (int64 and int32, dropped entries included) masked in the
     launch, whose output and masked ids must equal mask_local_ids +
     fused_interact_ref; the model's table at B = 1, 7, 256 and bag 0,
     1, 3, and small tables of d = 6, 33 and 64 with T * bag = 40;
  4. serve the full-width run_random.sh DLRM (fused interaction) through
     InferenceEngine + DynamicBatcher and check the answers and that the
     kernel ran on that path;
  5. time the fused forward at the serving buckets beside its bound, its
     plain version, a library call and the launch floor (an empty kernel),
     and the whole call as the op issues it, before (mask, cast, kernel)
     and now (one launch), with launches per call;
  6. hold the row update's two kernels (prepare-and-sort, update) against
     their plain versions, bit for bit, over ids uniform, zipf, one id,
     wrapped and dropped, int32 edges, R at a radix digit's bit
     boundary, n from 0 to 65,536, d 16/64/128, f32/bf16 updates and
     a float or tensor scale, and twice for determinism;
  7. hold the fused backward kernel against its plain version, with and
     without the safe ids it writes for the scatter (bit-exact against
     gids.clamp_min(0)): the model's table at B = 1, 7, 256 and bag 0,
     1, 3, and small tables of d = 6, 33 and 64, a bottom of 6 (the
     scalar paths), T * bag = 40 ids (two passes) and ids past the table;
  8. train the full-width run_random.sh DLRM: the classic graph through
     train_epoch and fit (row-update kernel), the fused graph on the
     row-sparse path, and the fused graph on the dense table gradient
     (forward and backward kernels), cat and dot, with launch counts,
     finite losses and one step of each held against the same step on
     the plain versions;
  9. time the row update (the sort alone, the update alone, the whole
     call, launches per call from torch.profiler, uniform and zipf ids)
     and the backward kernel at the path's shapes (cat and dot, beside
     the launch floor; one launch a call, and the op's whole backward
     launches it once and no clamp), and
     the training steps (information, not a claim);
 10. hold the row-set kernel against its plain version, bit for bit;
 11. hold the embedding-bag kernel against its plain version, bit for bit,
     int64 and int32 ids, bags up to 40, d = 128, 256 and 33;
 12. train the classic graph through fit's staged branch with the epoch
     row cache (fit(epochs=2) over 64 batches: one train_epochs, the
     ladder [8], 17 row-set launches), held bit for bit against the same
     run uncached, on row_set_ref, chunked, and through train_epochs;
 13. train a graph of Embedding(use_pallas=True) (the bag kernel forward,
     its row-update backward) a few steps, its forward and one step held
     against the plain versions;
 14. time the row-set kernel at the epilogue and block shapes, the bag
     kernel at every serving bucket (int64 and int32 ids, launches per
     call, the launch floor), and profile the cached and uncached staged epochs
     (information, not a claim).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from dlrm_flexflow_tpu_torch import (FFConfig, FFModel, SGDOptimizer,
                                     SyntheticDLRMLoader, ZipfDLRMLoader,
                                     _cuda)
from dlrm_flexflow_tpu_torch import epoch_cache as cache_module
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.data.loader import zipf_ids
from dlrm_flexflow_tpu_torch.ops import Embedding, FusedEmbedInteract
from dlrm_flexflow_tpu_torch.ops import embedding as emb_module
from dlrm_flexflow_tpu_torch.ops import fused_interact as fused_module
from dlrm_flexflow_tpu_torch.ops.bag_kernel import (embedding_bag_cuda,
                                                   embedding_bag_ref)
from dlrm_flexflow_tpu_torch.ops.fused_interact_kernel import (
    empty_launch_cuda, fused_embed_interact_cuda, fused_embed_interact_ref,
    fused_interact_bwd_cuda, fused_interact_bwd_ref, fused_interact_cuda,
    fused_interact_ref, interact_width, mask_local_ids)
from dlrm_flexflow_tpu_torch.ops.row_set_kernel import (
    launch_row_set, prepare_row_set, row_set_cuda, row_set_ref)
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import (
    launch_row_update, prepare_row_update_cuda, prepare_row_update_ref,
    row_update_cuda, row_update_ref)
from dlrm_flexflow_tpu_torch.ops.slotting import slot_rows
from dlrm_flexflow_tpu_torch.serving import DynamicBatcher, InferenceEngine
from dlrm_flexflow_tpu_torch.tools.cuda_timing import (graph_ms,
                                                    launches_per_call,
                                                    wall_ms)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# f32 rate outside the tensor cores, which the fused kernel's adds and
# dot products run at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# H100 SXM maximum SM clock (data sheet), for the row update's add chain
SM_CLOCK_HZ = 1.98e9

# the run_random.sh model (bench.py): serving buckets and training batch
TABLES, ROWS, DIM, BOT = 8, 1_000_000, 64, 64
BUCKETS = (1, 8, 64, 256)
BATCH = 256
INT32_MIN = int(np.iinfo(np.int32).min)
# rows of d = 64 f32 (25.6 MB) that the 50 MB L2 holds
L2_ROWS = 100_000
KERNELS = {
    "fused_interact_fwd": (
        "dlrm_flexflow_tpu_torch/csrc/fused_interact.cu",
        "dlrm_flexflow_tpu/ops/pallas_fused_interact.py:146",
        fused_interact_cuda),
    "fused_interact_bwd": (
        "dlrm_flexflow_tpu_torch/csrc/fused_interact_bwd.cu",
        "dlrm_flexflow_tpu/ops/pallas_fused_interact.py:312",
        fused_interact_bwd_cuda),
    "row_update": (
        "dlrm_flexflow_tpu_torch/csrc/row_update.cu",
        "dlrm_flexflow_tpu/ops/pallas_scatter.py:67",
        row_update_cuda),
    # the stable argsort that feeds _row_update_pallas in sparse_row_update
    "row_update_prep": (
        "dlrm_flexflow_tpu_torch/csrc/row_update_prep.cu",
        "dlrm_flexflow_tpu/ops/pallas_scatter.py:596",
        prepare_row_update_cuda),
    "row_set": (
        "dlrm_flexflow_tpu_torch/csrc/row_set.cu",
        "dlrm_flexflow_tpu/ops/pallas_scatter.py:460",
        row_set_cuda),
    "embedding_bag": (
        "dlrm_flexflow_tpu_torch/csrc/embedding_bag.cu",
        "dlrm_flexflow_tpu/ops/pallas_embedding.py:40",
        embedding_bag_cuda),
}


def reset_counts() -> None:
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches
            for name, (_, _, wrapper) in KERNELS.items()}


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


# --------------------------------------------------------------- phase 1
def card_info() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log({"phase": "card", "name": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "nvidia_smi": card})
    return card


# --------------------------------------------------------------- phase 2
def build_kernels() -> None:
    t0 = time.perf_counter()
    built = _cuda.build()
    for name, (secs, out) in _cuda.build_log.items():
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        log({"phase": "build", "source": f"csrc/{name}.cu",
             "nvcc_s": round(secs, 3), "ptxas": ptxas})
    log({"phase": "build", "built": sorted(built),
         "wall_s": round(time.perf_counter() - t0, 3)})


# --------------------------------------------------------------- phase 3
def _model_consts():
    """Offsets and row counts (int64, on the card) of the 8 x 1M tables."""
    return (torch.arange(TABLES, device="cuda", dtype=torch.int64) * ROWS,
            torch.full((TABLES,), ROWS, device="cuda", dtype=torch.int64))


def _local(gen, bsz, bag, drop: bool, counts=None):
    """Local ids (B, T, bag) int64 below each table's count (default the
    8 x 1M tables), with dropped ids (-1, -3, int32 min, one at and one
    past a table's count) when ``drop`` and the shape has room."""
    counts = [ROWS] * TABLES if counts is None else counts
    local = torch.stack([torch.randint(0, c, (bsz, bag), generator=gen,
                                       device="cuda") for c in counts], 1)
    if drop and bag:
        flat = local.view(-1)
        bad = [-1, -3, INT32_MIN, None, None]
        for i, v in enumerate(bad[:flat.numel() // 2]):
            k = (i * 7919) % flat.numel()
            t = (k // bag) % len(counts)
            flat[k] = v if v is not None else counts[t] + (i - 3) * 5
    return local


def _gids(gen, bsz, bag, drop: bool):
    """Masked flat ids (B, T, bag) int32 for the 8 x 1M-row tables, with
    the dropped ids of ``_local`` when ``drop``."""
    return mask_local_ids(_local(gen, bsz, bag, drop),
                          *_model_consts()).to(torch.int32)


def _bottom(gen, bsz):
    # bottom-MLP outputs pass a relu: non-negative, order 1
    return torch.rand((bsz, BOT), generator=gen, device="cuda")


def _agree(k, r, interact, bag):
    """The test tolerances: cat with bag <= 1 is data movement and must
    be bit-exact; a longer bag may sum in another order (rtol/atol 1e-6);
    dot's f32 dot products run in another order (rtol 1e-5, atol 1e-6)."""
    if interact == "cat" and bag <= 1:
        return torch.equal(k, r), "exact"
    if interact == "cat":
        return torch.allclose(k, r, rtol=1e-6, atol=1e-6), "rtol 1e-6 atol 1e-6"
    return torch.allclose(k, r, rtol=1e-5, atol=1e-6), "rtol 1e-5 atol 1e-6"


def _fwd_case(table, ids, bottom, consts, interact, aggr, cd, **tags):
    """One forward case on local ids: the pre-masked entry on the ids
    ``mask_local_ids`` gives, and the folded entry on the local ids with
    its gids, each against its plain version on the same inputs.
    Returns the case rows."""
    kw = dict(interact=interact, aggr=aggr, compute_dtype=cd)
    bsz, t, bag = ids.shape
    width = interact_width(interact, t, table.shape[1], bottom.shape[1])
    gids = mask_local_ids(ids, *consts).to(torch.int32)
    out, kg = fused_embed_interact_cuda(table, ids, *consts, bottom,
                                        want_gids=True, **kw)
    ref, rg = fused_embed_interact_ref(table, ids, *consts, bottom,
                                       want_gids=True, **kw)
    calls = [("premasked",
              fused_interact_cuda(table, gids, bottom, **kw),
              fused_interact_ref(table, gids, bottom, **kw), None),
             ("folded", out, ref, torch.equal(kg, rg))]
    torch.cuda.synchronize()
    rows = []
    for entry, k, r, gids_same in calls:
        ok, tol = _agree(k, r, interact, bag)
        ok = ok and k.shape == (bsz, width) and gids_same is not False
        err = float((k - r).abs().max()) if k.numel() else 0.0
        rows.append({"phase": "kernel_vs_plain",
                     "kernel": "fused_interact_fwd", "entry": entry,
                     "B": bsz, "T": t, "bag": bag, "d": table.shape[1],
                     "ids": str(ids.dtype)[6:],
                     "interact": interact, "aggr": aggr, "compute_dtype": cd,
                     **tags, "max_abs_err": err, "tolerance": tol,
                     "gids_bit_identical": gids_same, "ok": bool(ok)})
    return rows


def _fwd_configs():
    return [(i, a, cd) for i in ("cat", "dot") for a in ("sum", "avg")
            for cd in ((None,) if i == "cat" else (None, "bfloat16"))]


def check_kernel_cases(table) -> float:
    """The forward kernel through both entries against the plain versions:
    on the model's table (8 x 1M x 64) at B = 1, 7, 256 and bag 0, 1, 3,
    pre-masked ids and local ids (int64 and int32 in turn) with dropped
    entries; then on small ragged tables of d = 6 and 33 (the scalar
    path) and 64, with bag 5 (T * bag = 40 ids, more than a warp)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    consts = _model_consts()
    rows = []
    for bsz in (1, 7, 256):
        for bag in (0, 1, 3):
            local = _local(gen, bsz, bag, drop=True)
            bottom = _bottom(gen, bsz)
            for n, (interact, aggr, cd) in enumerate(_fwd_configs()):
                ids = local.to(torch.int32) if n % 2 else local
                rows += _fwd_case(table, ids, bottom, consts, interact, aggr,
                                  cd, tables="model")
    counts = [5000, 3000, 7000, 1000, 4000, 2500, 6000, 1500]
    offsets = np.concatenate([[0], np.cumsum(counts[:-1])])
    small = (torch.as_tensor(offsets, device="cuda"),
             torch.as_tensor(counts, device="cuda"))
    for d in (6, 33, 64):
        tab = _rows_tensor(gen, sum(counts), d)
        for bsz in (1, 7, 256):
            for bag in (1, 5):
                local = _local(gen, bsz, bag, drop=True, counts=counts)
                bottom = torch.rand((bsz, d), generator=gen, device="cuda")
                for n, (interact, aggr, cd) in enumerate(_fwd_configs()):
                    ids = local.to(torch.int32) if n % 2 else local
                    rows += _fwd_case(tab, ids, bottom, small, interact,
                                      aggr, cd, tables="small")
    for row in rows:
        log(row)
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"{len(failed)} of {len(rows)} forward case(s) "
                             f"disagree with the plain version")
    return max(r["max_abs_err"] for r in rows)


# --------------------------------------------------------------- phase 4
def build_model():
    """The run_random.sh DLRM with the fused interaction, at full width
    and depth: 8 tables of 1M x 64 f32 (2.05 GB), bottom 64-512-512-64,
    cat to 576, top 576-1024-1024-1024-1, bf16 compute, random weights
    from seed 0, on the card."""
    cfg = DLRMConfig(embedding_size=[ROWS] * TABLES, fused_interaction="on")
    ffc = FFConfig(batch_size=BUCKETS[-1], compute_dtype="bfloat16",
                   serve_buckets=",".join(map(str, BUCKETS)))
    model = build_dlrm(cfg, ffc).compile()
    t0 = time.perf_counter()
    state = model.init(seed=0)
    torch.cuda.synchronize()
    table = state.params["emb"]["embedding"]
    log({"phase": "model", "ops": [op.name for op in model.layers],
         "table": list(table.shape), "table_bytes": table.numel() * 4,
         "init_s": round(time.perf_counter() - t0, 3)})
    return model, state


def _request(rng, n):
    return {"dense": rng.standard_normal((n, 64)).astype(np.float32),
            "sparse": rng.integers(0, ROWS, size=(n, TABLES, 1),
                                   dtype=np.int64)}


def _plain_forward(model, state, req) -> np.ndarray:
    """The model's forward with the embedding op on its plain version
    (``fused_interact_ref``) on the same GPU tensors: no kernel launch."""
    params = state.params
    values = {t.uid: torch.from_numpy(req[t.name]).cuda()
              for t in model._inputs}
    with torch.inference_mode():
        for op in model.layers:
            xs = [values[t.uid] for t in op.inputs]
            if isinstance(op, FusedEmbedInteract):
                idx, bottom = xs
                offsets, counts = op.table_consts(idx.device)
                gids = mask_local_ids(idx, offsets, counts).to(torch.int32)
                outs = [fused_interact_ref(
                    params[op.name]["embedding"], gids, bottom.float(),
                    interact=op.interact, aggr=op.aggr,
                    compute_dtype=op.compute_dtype)]
            else:
                outs = op.forward(params.get(op.name, {}), xs)
            for o, t in zip(outs, op.outputs):
                values[t.uid] = o
    return values[model.final_tensor.uid].float().cpu().numpy()


def serve(model, state):
    """Drive the serving path: an InferenceEngine (warmed on every
    bucket), a DynamicBatcher answering 8 client threads x 16 one-row
    requests plus requests of 3, 40 and 256 rows, and a 300-row request
    the engine chunks.  The kernel's launch count is reset just before
    the traffic and read just after it."""
    t0 = time.perf_counter()
    engine = InferenceEngine(model, state)
    log({"phase": "engine", "buckets": engine.buckets,
         "warmup_s": round(time.perf_counter() - t0, 3)})
    rng = np.random.default_rng(0)
    clients, per_client = 8, 16
    reqs = [[_request(rng, 1) for _ in range(per_client)]
            for _ in range(clients)]
    big = {n: _request(rng, n) for n in (3, 40, 256, 300)}
    answers, errors = {}, []

    def client(c):
        try:
            for i, r in enumerate(reqs[c]):
                answers[c, i] = batcher.submit(r).result(timeout=120)
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    reset_counts()  # the main path starts here
    t_start = time.perf_counter()
    batcher = DynamicBatcher(engine)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for n in (3, 40, 256):
        answers["big", n] = batcher.submit(big[n]).result(timeout=120)
    for t in threads:
        t.join(timeout=300)
    alive = [t for t in threads if t.is_alive()]
    summary = batcher.close()
    answers["big", 300] = engine.predict(big[300])  # two top-bucket chunks
    wall_s = time.perf_counter() - t_start
    launches = read_counts()["fused_interact_fwd"]  # the main path ends
    if alive or errors:
        raise RuntimeError(f"client threads failed: alive={len(alive)} "
                           f"errors={errors[:1]!r}")
    want = {**{(c, i): 1 for c in range(clients)
               for i in range(per_client)},
            **{("big", n): n for n in big}}
    if set(answers) != set(want):
        raise AssertionError(f"missing answers: {set(want) - set(answers)}")
    for key, n in want.items():
        a = answers[key]
        if (a.shape != (n, 1) or a.dtype != np.float32
                or not np.isfinite(a).all() or not ((a > 0) & (a < 1)).all()):
            raise AssertionError(f"bad answer {key}: shape {a.shape} "
                                 f"dtype {a.dtype} range [{a.min()}, "
                                 f"{a.max()}]")
    if launches <= 0:
        raise AssertionError("the serving path launched no fused kernel")
    # a full bucket against the forward whose embedding op runs the plain
    # version on the same GPU tensors: the cat interaction is pure data
    # movement and the MLP is the same code, so the two agree bit for bit
    got = engine.predict(big[256])
    ref = _plain_forward(model, state, big[256])
    err = float(np.abs(got - ref).max())
    # the padding contract on the card: 3 rows padded to bucket 8 equal
    # the unpadded 3-row forward
    padded = engine.predict(big[3])
    unpadded = model.predict(state, big[3]).cpu().numpy()
    log({"phase": "serve", "requests": summary["requests"],
         "rows": sum(want.values()), "launches": launches,
         "wall_s": wall_s, "batcher_qps": summary["qps"],
         "batcher_p50_us": summary.get("p50_us"),
         "batcher_p99_us": summary.get("p99_us"),
         "dispatches": engine.stats.dispatch_buckets,
         "bucket_p50_us": {b: engine.stats.bucket_percentile(b, 50)
                           for b in engine.buckets},
         "bucket_p99_us": {b: engine.stats.bucket_percentile(b, 99)
                           for b in engine.buckets},
         "vs_plain_forward_max_abs_err": err,
         "padding_bit_identical": bool(np.array_equal(padded, unpadded)),
         "note": "latencies are information, not a claim"})
    if not np.array_equal(got, ref):
        raise AssertionError(f"served bucket != plain forward, max abs "
                             f"err {err}")
    if not np.array_equal(padded, unpadded):
        raise AssertionError("padded bucket rows != unpadded forward")
    for n in (1, 256):
        profile_dispatch(engine, big[256] if n == 256 else reqs[0][0], n)
    return launches, err


def profile_dispatch(engine, req, n: int, reps: int = 20) -> None:
    """Where an engine dispatch's time goes (information, not a check):
    the host wall per dispatch without and with torch.profiler, the
    device kernel time per dispatch from the profiler's CUDA activity,
    the device's idle share of the profiled wall, and the kernels that
    took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    engine.predict(req)
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict(req)
    wall_us = (time.perf_counter() - t0) * 1e6 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.predict(req)
        prof_wall_us = (time.perf_counter() - t0) * 1e6 / reps
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in kernels) / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log({"phase": "profile", "rows": n, "bucket": engine.bucket_for(n),
         "wall_us": wall_us, "profiled_wall_us": prof_wall_us,
         "device_busy_us": busy_us if kernels else "not measured",
         "device_idle_share": (1 - busy_us / prof_wall_us) if kernels
         else "not measured",
         "kernels_per_dispatch": sum(e.count for e in kernels) / reps,
         "top_kernels": [{"name": e.key[:70],
                          "us": e.self_device_time_total / reps,
                          "calls": e.count / reps} for e in top]})


# --------------------------------------------------------------- phase 5
def check_one_launch(what, fn, arg_sets, wrapper, kernel, traced,
                     kernels, others=()) -> None:
    """Fails unless every call of ``fn`` launches ``kernel`` exactly once:
    its wrapper's counter (exact) must grow by one a call, and the
    profiler's reading (``traced`` and ``kernels`` from
    ``launches_per_call``) must show no device operation besides it whose
    name holds none of ``others`` (by default: none at all).  The tracer
    can drop a record or two in 64 calls, so its reading of ``kernel``
    must lie in (0.9, 1]: 0, "not measured" or a second launch fail."""
    before = wrapper.launches
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    made = wrapper.launches - before
    mine = sum(n for k, n in kernels.items() if kernel in k)
    stray = [k for k in kernels
             if kernel not in k and not any(o in k for o in others)]
    if (made != len(arg_sets) or traced == "not measured"
            or not 0.9 < mine <= 1 or stray):
        raise AssertionError(
            f"{what}: {made} {kernel} launches for {len(arg_sets)} calls, "
            f"{traced} device operations per call traced ({kernels})")


def _launch_floor_ms(sets: int) -> float:
    """An empty kernel of the forward's library timed as the kernels are
    (``graph_ms``): the floor under any launch (information only)."""
    return graph_ms(empty_launch_cuda, [()] * sets)


def time_kernel(model, state, sets: int = 256):
    """Per serving bucket: the kernel on pre-masked ids, its plain version
    and ``F.embedding_bag`` (the pooling part only; the port never calls
    it) on the same inputs, and the bytes bound; the kernel on a table
    that fits the 50 MB L2 (``l2_table_ms``: what the rows' trips to
    device memory cost); then the whole call as
    the op issues it, on its int64 local ids: before this design the
    mask, the cast and the kernel on pre-masked ids, now the folded call
    and the op's forward itself, each with launches per call; the whole
    call's bound (local ids at 8 bytes, offsets and counts, rows, bottom,
    output); and the launch floor."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    table = state.params["emb"]["embedding"]
    op = model.get_op("emb")
    consts = op.table_consts(table.device)
    floor_ms = _launch_floor_ms(sets)
    l2_table = _rows_tensor(gen, L2_ROWS, DIM)
    rows = []
    for bsz in BUCKETS:
        bag = 1
        local_sets = [(_local(gen, bsz, bag, drop=False), _bottom(gen, bsz))
                      for _ in range(sets)]
        arg_sets = [(table, mask_local_ids(i, *consts).to(torch.int32), b)
                    for i, b in local_sets]
        l2_sets = [(l2_table, (i % L2_ROWS).to(torch.int32), b)
                   for i, b in local_sets]

        def kern(t, g, b):
            return fused_interact_cuda(t, g, b, interact="cat", aggr="sum")

        def plain(t, g, b):
            return fused_interact_ref(t, g, b, interact="cat", aggr="sum")

        def library(t, g, b):
            return torch.nn.functional.embedding_bag(
                g.view(-1, bag), t, mode="sum")

        def op_before(i, b):  # the op's forward before: mask, cast, kernel
            g = mask_local_ids(i, *consts).to(torch.int32).contiguous()
            return fused_interact_cuda(table, g, b, interact="cat",
                                       aggr="sum")

        def op_folded(i, b):
            return fused_embed_interact_cuda(table, i, *consts, b)[0]

        def op_plain(i, b):
            return fused_embed_interact_ref(table, i, *consts, b)[0]

        def op_forward(i, b):
            with torch.no_grad():
                return op.forward(state.params["emb"], [i, b])[0]

        width = interact_width("cat", TABLES, DIM, BOT)
        live = sum(int((g >= 0).sum()) for _, g, _ in arg_sets) / sets
        nbytes = 4 * (live * DIM + bsz * BOT + bsz * TABLES * bag
                      + bsz * width)
        op_bytes = (nbytes + 4 * bsz * TABLES * bag  # int64 ids, not int32
                    + 2 * 8 * TABLES)                # offsets and counts
        flops = live * DIM  # the pooling adds
        bound_ms, bound_by = _bound(nbytes, flops)
        op_bound_ms, op_bound_by = _bound(op_bytes, flops)
        row = {"phase": "timing", "kernel": "fused_interact_fwd",
               "B": bsz, "T": TABLES, "bag": bag, "d": DIM,
               "interact": "cat", "bytes": nbytes, "bound_ms": bound_ms,
               "bound_by": bound_by, "launch_floor_ms": floor_ms,
               "ms": graph_ms(kern, arg_sets),
               "l2_table_ms": graph_ms(kern, l2_sets),
               "plain_ms": graph_ms(plain, arg_sets),
               "library_ms": graph_ms(library, arg_sets),
               "call_ms": wall_ms(kern, arg_sets),
               "plain_call_ms": wall_ms(plain, arg_sets),
               "op_bytes": op_bytes, "op_bound_ms": op_bound_ms,
               "op_bound_by": op_bound_by,
               "op_before_ms": graph_ms(op_before, local_sets),
               "op_ms": graph_ms(op_folded, local_sets),
               "op_forward_ms": graph_ms(op_forward, local_sets),
               "op_plain_ms": graph_ms(op_plain, local_sets),
               "op_before_call_ms": wall_ms(op_before, local_sets),
               "op_call_ms": wall_ms(op_folded, local_sets),
               "op_forward_call_ms": wall_ms(op_forward, local_sets)}
        for name, fn in (("op_before", op_before), ("op", op_folded),
                         ("op_forward", op_forward)):
            row[f"{name}_launches_per_call"], row[f"{name}_kernels"] = (
                launches_per_call(fn, local_sets[:64]))
        row["share_of_bound"] = bound_ms / row["ms"]
        row["op_share_of_bound"] = op_bound_ms / row["op_ms"]
        log(row)
        rows.append(row)
        for name, fn in (("op", op_folded), ("op_forward", op_forward)):
            check_one_launch(name, fn, local_sets[:64], fused_interact_cuda,
                             "fused_interact_kernel",
                             row[f"{name}_launches_per_call"],
                             row[f"{name}_kernels"])
    return rows


# --------------------------------------------------------------- phase 6
def _rows_tensor(gen, rows, dim):
    return torch.rand((rows, dim), generator=gen, device="cuda") - 0.5


def _row_ids(kind, n, rows, gen, rng):
    """int64 ids of one phase-6 case on the card."""
    if kind == "uniform":
        return torch.randint(0, rows, (n,), generator=gen, device="cuda")
    if kind == "one_id":
        return torch.full((n,), rows // 3, dtype=torch.int64, device="cuda")
    if kind == "zipf":
        return torch.from_numpy(zipf_ids(rng, rows, (n,), a=1.05)).cuda()
    # wrapped and dropped, a fixed mix by slot: a quarter in [-R, 0)
    # (wraps), a quarter in [R, 2R) and a quarter in [-2R, -R) (dropped),
    # the rest in range.  The in-range and wrapped ids come from one pool
    # of 64 rows, so runs repeat a row under both spellings.
    pool = torch.randint(0, rows, (64,), generator=gen, device="cuda")
    pick = pool[torch.randint(0, 64, (n,), generator=gen, device="cuda")]
    far = torch.randint(0, rows, (n,), generator=gen, device="cuda")
    slot = torch.arange(n, device="cuda") % 4
    ids = torch.where(slot == 0, pick - rows,
                      torch.where(slot == 1, far + rows,
                                  torch.where(slot == 2, -rows - 1 - far,
                                              pick)))
    return ids[torch.randperm(n, generator=gen, device="cuda")]


def _longest_run(ids, rows) -> int:
    live = torch.where(ids < 0, ids + rows, ids)
    live = live[(live >= 0) & (live < rows)]
    return int(torch.bincount(live).max()) if live.numel() else 0


def _row_update_cases():
    """(kind, n, rows, d, id dtype, update dtype, scale) of phase 6;
    rows None means the headline's 8M-row table."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(k, n, None, DIM, torch.int64, f32, "tensor")
             for k in ("uniform", "one_id", "zipf", "wrap_drop")
             for n in (0, 1, 2048, 65_536)]
    cases += [(k, 2048, ROWS, d, torch.int64, f32, "tensor")
              for k in ("uniform", "zipf", "wrap_drop") for d in (16, 128)]
    # R at a digit's bit boundary (255 / 256 / 257: one pass or two;
    # 2^16 / 2^16 + 1: two or three); the sort's one-tile block (n <= 4096),
    # its tiled walk within one tile of 8192 and over two tiles
    cases += [("wrap_drop", n, r, DIM, torch.int64, f32, "tensor")
              for r in (255, 256, 257, 2 ** 16, 2 ** 16 + 1)
              for n in (2048, 6000, 9000)]
    # n just past the one-tile block and past one tile, not multiples
    cases += [(k, n, None, DIM, torch.int64, f32, "tensor")
              for k in ("zipf", "wrap_drop") for n in (4097, 8193, 20_000)]
    # int32 ids with int32 min and max; the update dtypes and scales
    cases += [("int32_edges", 2048, None, DIM, torch.int32, f32, "tensor")]
    cases += [("zipf", 2048, None if d == DIM else ROWS, d, torch.int32,
               dt, sc)
              for d in (16, DIM, 128) for dt in (f32, bf16)
              for sc in ("tensor", "float")]
    return cases


def _case_ids(kind, n, rows, gen, rng, dtype):
    if kind != "int32_edges":
        return _row_ids(kind, n, rows, gen, rng).to(dtype)
    ids = _row_ids("wrap_drop", n, rows, gen, rng)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    for i, v in enumerate((lo, hi, lo + 1, -rows, -rows - 1, rows)):
        ids[(i * 331) % n] = v
    return ids.to(dtype)


def check_row_update(table) -> float:
    """The prepare-and-sort kernel against ``prepare_row_update_ref`` and
    the whole ``row_update_cuda`` call against ``row_update_ref`` on the
    same GPU tensors, both bit for bit, on clones of ``table`` (the
    headline's 8M x 64 flat table), on 1M-row tables of d = 16 and 128 and
    on small tables whose R sits at a digit's bit boundary; each zipf case
    of 2048 or more slots runs the kernel twice and must give the same
    table (no atomics: deterministic)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    tables = {}

    def base_for(rows, d):
        if rows is None:
            return table
        if (rows, d) not in tables:
            tables[rows, d] = _rows_tensor(gen, rows, d)
        return tables[rows, d]

    failed, worst, prep_worst = [], 0.0, 0.0
    for kind, n, rows_n, d, id_dtype, upd_dtype, scale_kind in (
            _row_update_cases()):
        base = base_for(rows_n, d)
        rows = base.shape[0]
        ids = _case_ids(kind, n, rows, gen, rng, id_dtype)
        upd = torch.randn((n, d), generator=gen, device="cuda").to(upd_dtype)
        scale = (torch.tensor(-0.01, device="cuda") if scale_kind == "tensor"
                 else -0.01)
        keys, order = prepare_row_update_cuda(ids, rows)
        want_keys, want_order = prepare_row_update_ref(ids, rows)
        got = row_update_cuda(base.clone(), ids, upd, scale)
        want = row_update_ref(base.clone(), ids, upd, scale)
        again = (row_update_cuda(base.clone(), ids, upd, scale)
                 if kind == "zipf" and n >= 2048 else None)
        torch.cuda.synchronize()
        prep_ok = (torch.equal(keys, want_keys)
                   and torch.equal(order, want_order))
        ok = prep_ok and torch.equal(got, want)
        deterministic = again is None or torch.equal(got, again)
        err = float((got - want).abs().max()) if n else 0.0
        worst = max(worst, err)
        if n:
            prep_worst = max(prep_worst, float(max(
                (keys - want_keys).abs().max(),
                (order - want_order).abs().max())))
        i64 = ids.long()
        wrapped = int(((i64 < 0) & (i64 >= -rows)).sum())
        dropped = int(((i64 < -rows) | (i64 >= rows)).sum())
        if kind in ("wrap_drop", "int32_edges") and n >= 2 and not (
                wrapped and dropped):
            ok = False  # the case must hold both branches
        case = {"phase": "kernel_vs_plain", "kernel": "row_update",
                "ids": kind, "n": n, "rows": rows, "d": d,
                "id_dtype": str(id_dtype).split(".")[-1],
                "upd_dtype": str(upd_dtype).split(".")[-1],
                "scale": scale_kind, "wrapped": wrapped, "dropped": dropped,
                "longest_run": _longest_run(i64, rows),
                "prep_exact": bool(prep_ok), "max_abs_err": err,
                "tolerance": "exact",
                "deterministic": (None if again is None
                                  else bool(deterministic)),
                "ok": bool(ok and deterministic)}
        log(case)
        if not case["ok"]:
            failed.append(case)
        del got, want, again
    if failed:
        raise AssertionError(f"{len(failed)} row_update case(s) disagree "
                             f"with the plain version")
    return worst, prep_worst


# --------------------------------------------------------------- phase 7
def _cotangent(gen, bsz, interact, t=TABLES, d=DIM, bot=BOT):
    width = interact_width(interact, t, d, bot)
    return torch.randn((bsz, width), generator=gen, device="cuda")


def _bwd_case(table, gids, bottom, g, interact, aggr, **tags):
    """One backward case: the kernel with and without the safe ids
    against ``fused_interact_bwd_ref``, cat bit-exact (slices, a division
    by the bag and masks), dot within rtol 1e-5 and atol 1e-6 (its f32
    dot products sum in another order); the safe ids bit-exact against
    ``gids.clamp_min(0)``; the two launches' row grads and dbottom
    bit-identical to each other."""
    kw = dict(interact=interact, aggr=aggr)
    bsz, t, bag = gids.shape
    k = fused_interact_bwd_cuda(table, gids, bottom, g, want_safe=True, **kw)
    k2 = fused_interact_bwd_cuda(table, gids, bottom, g, **kw)
    r = fused_interact_bwd_ref(table, gids, bottom, g, **kw)
    torch.cuda.synchronize()
    if interact == "cat":
        ok, tol = all(map(torch.equal, k[:2], r)), "exact"
    else:
        ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                 for a, b in zip(k[:2], r))
        tol = "rtol 1e-5 atol 1e-6"
    safe_same = torch.equal(k[2], gids.clamp_min(0))
    ok = (ok and safe_same and all(map(torch.equal, k[:2], k2))
          and k[0].shape == (bsz, t, bag, table.shape[1]))
    err = max((float((a - b).abs().max()) if a.numel() else 0.0)
              for a, b in zip(k[:2], r))
    return {"phase": "kernel_vs_plain", "kernel": "fused_interact_bwd",
            "B": bsz, "T": t, "bag": bag, "d": table.shape[1],
            "bot": bottom.shape[1], "interact": interact, "aggr": aggr,
            **tags, "max_abs_err": err, "tolerance": tol,
            "safe_bit_identical": safe_same, "ok": bool(ok)}


def _past_the_table(gids, rows):
    """Pre-masked ids at and past the table's end, which the kernel drops
    and the safe ids keep, at a fixed spread of slots."""
    flat = gids.view(-1)
    for i, k in enumerate(range(3, flat.numel(), 97)):
        flat[k] = rows + 5 * (i % 3)
    return gids


def check_fused_bwd(table) -> float:
    """The backward kernel against its plain version (``_bwd_case``): on
    the model's table (8 x 1M x 64, bottom 64) at B = 1, 7, 256 and bag 0,
    1, 3, with dropped ids; then on small ragged tables of d = 6 and 33
    (the scalar path) and 64, cat also with a bottom of 6 (the scalar path
    by the bottom), bag 1 and 5 (T * bag = 40 slots: the ids in two
    passes), with dropped ids and ids at and past the table's end."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for bsz in (1, 7, 256):
        for bag in (0, 1, 3):
            gids = _gids(gen, bsz, bag, drop=True)
            bottom = _bottom(gen, bsz)
            for interact in ("cat", "dot"):
                g = _cotangent(gen, bsz, interact)
                for aggr in ("sum", "avg"):
                    rows.append(_bwd_case(table, gids, bottom, g, interact,
                                          aggr, tables="model"))
    counts = [5000, 3000, 7000, 1000, 4000, 2500, 6000, 1500]
    offsets = np.concatenate([[0], np.cumsum(counts[:-1])])
    small = (torch.as_tensor(offsets, device="cuda"),
             torch.as_tensor(counts, device="cuda"))
    for d in (6, 33, 64):
        tab = _rows_tensor(gen, sum(counts), d)
        for bsz in (1, 7, 256):
            for bag in (1, 5):
                gids = _past_the_table(mask_local_ids(
                    _local(gen, bsz, bag, drop=True, counts=counts), *small
                ).to(torch.int32), tab.shape[0])
                for interact, bot in (("cat", d), ("cat", 6), ("dot", d)):
                    if interact == "cat" and bot == 6 and d == 6:
                        continue
                    bottom = torch.rand((bsz, bot), generator=gen,
                                        device="cuda")
                    g = _cotangent(gen, bsz, interact, len(counts), d, bot)
                    for aggr in ("sum", "avg"):
                        rows.append(_bwd_case(tab, gids, bottom, g, interact,
                                              aggr, tables="small"))
    for row in rows:
        log(row)
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"{len(failed)} of {len(rows)} "
                             f"fused_interact_bwd case(s) disagree with the "
                             f"plain version")
    return max(r["max_abs_err"] for r in rows)


# --------------------------------------------------------------- phase 8
@contextlib.contextmanager
def _plain(module, name, fn):
    """Swap one module-level kernel wrapper for its plain version."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def _train_model(fused, compute_dtype, sparse="auto", interact="cat",
                 **config):
    """The run_random.sh model, or with ``interact="dot"`` its dot form
    (top MLP 145-1024-1024-1024-1)."""
    top0 = interact_width(interact, TABLES, DIM, BOT)
    cfg = DLRMConfig(embedding_size=[ROWS] * TABLES,
                     fused_interaction="on" if fused else "off",
                     arch_interaction_op=interact,
                     mlp_top=[top0, 1024, 1024, 1024, 1])
    ffc = FFConfig(batch_size=BATCH, compute_dtype=compute_dtype,
                   sparse_embedding_updates=sparse, **config)
    model = build_dlrm(cfg, ffc).compile(
        optimizer=SGDOptimizer(lr=0.01), loss_type="mean_squared_error",
        metrics=("accuracy", "mean_squared_error"))
    state = model.init(seed=0)
    torch.cuda.synchronize()
    return model, state


def _epoch_data(batches):
    """The first ``batches`` batches of SyntheticDLRMLoader(seed=0),
    stacked as (num_batches, batch, ...) arrays."""
    loader = SyntheticDLRMLoader(batches * BATCH, BOT, [ROWS] * TABLES, 1,
                                 BATCH, seed=0)
    steps = list(loader)
    return ({k: np.stack([s[0][k] for s in steps]) for k in steps[0][0]},
            np.stack([s[1] for s in steps]))


def _finite(mets) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in mets.values())


def _same_step(model, state, inputs, labels, module, name, plain_fn,
               rtol=0.0, atol=0.0):
    """One train_step through the kernels and the same step with one
    wrapper swapped for its plain version, on clones of ``state``;
    returns (every parameter and the loss bit-identical, or within
    ``rtol``/``atol`` when given; max abs difference over all
    parameters)."""
    a, ma = model.train_step(state, inputs, labels, False)
    with _plain(module, name, plain_fn):
        b, mb = model.train_step(state, inputs, labels, False)
    torch.cuda.synchronize()

    def agree(x, y):
        if rtol or atol:
            return torch.allclose(x, y, rtol=rtol, atol=atol)
        return torch.equal(x, y)

    same, err = True, 0.0
    for op, params in a.params.items():
        for k, v in params.items():
            same = same and agree(v, b.params[op][k])
            err = max(err, float((v - b.params[op][k]).abs().max()))
    same = same and agree(ma["loss"], mb["loss"])
    return same, err


def _log_profile(prof, config: str, steps: int, wall_us: float) -> None:
    """Log a profiled window per step: the device kernel time from the
    profiler's CUDA activity, the device's idle share of the profiled
    wall, the share of f64 GEMM kernels (the Linear layers' f64
    accumulation), and the kernels that took the most device time."""
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in kernels) / steps
    f64_us = sum(e.self_device_time_total for e in kernels
                 if "f64" in e.key or "dgemm" in e.key.lower()) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    log({"phase": "profile", "config": config, "steps": steps,
         "profiled_step_wall_us": wall_us,
         "device_busy_us": busy_us if kernels else "not measured",
         "device_idle_share": (1 - busy_us / wall_us) if kernels
         else "not measured",
         "f64_gemm_us": f64_us if kernels else "not measured",
         "kernels_per_step": sum(e.count for e in kernels) / steps,
         "top_kernels": [{"name": e.key[:80],
                          "us": e.self_device_time_total / steps,
                          "calls": e.count / steps} for e in top]})


def profile_steps(model, state, inputs, labels, config: str, reps: int = 5):
    """Where a training step's time goes (information, not a check): the
    host wall per step and ``_log_profile`` over ``reps`` steps."""
    from torch.profiler import ProfilerActivity, profile
    batches = [({k: v[i] for k, v in inputs.items()}, labels[i])
               for i in range(reps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in batches:
            state, _ = model.train_step(state, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    _log_profile(prof, config, reps, wall_us)
    return state


def train_headline(inputs, labels):
    """(i) The run_random.sh classic graph (8 x 1M x 64 stacked tables,
    cat, bf16 compute, SGD lr 0.01, MSE): train_epoch over 64 batches,
    then a short fit over ZipfDLRMLoader data."""
    model, state = _train_model(False, "bfloat16")
    op = model.get_op("emb")
    flat = state.params["emb"]["embedding"].view(-1, DIM)
    step0 = ({k: v[0] for k, v in inputs.items()}, labels[0])
    same, err = _same_step(model, state, *step0, emb_module,
                           "row_update_cuda", row_update_ref)
    log({"phase": "train_vs_plain", "config": "headline",
         "plain": "row_update_ref", "bit_identical": same,
         "max_abs_err": err})
    if not same:
        raise AssertionError("headline step through the row-update kernel "
                             "!= the same step on row_update_ref")
    touched = np.unique(op.flat_ids(torch.from_numpy(inputs["sparse"])
                                    ).numpy().reshape(-1))
    rng = np.random.default_rng(6)
    sample = rng.choice(flat.shape[0], 8192, replace=False)
    cold = torch.from_numpy(np.setdiff1d(sample, touched)).cuda()
    hot = torch.from_numpy(rng.choice(touched, 2048, replace=False)).cuda()
    cold_before, hot_before = flat[cold].clone(), flat[hot].clone()
    nb = labels.shape[0]
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, inputs, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    epoch_counts = read_counts()  # ... and ends here
    flat = state.params["emb"]["embedding"].view(-1, DIM)
    changed = float((flat[hot] != hot_before).any(dim=1).float().mean())
    cold_same = bool(torch.equal(flat[cold], cold_before))
    state = profile_steps(model, state, inputs, labels, "headline")
    zipf = ZipfDLRMLoader(8 * BATCH, BOT, [ROWS] * TABLES, 1, BATCH, seed=0)
    reset_counts()
    state, fit_thpt = model.fit(state, zipf, epochs=1, verbose=False)
    fit_counts = read_counts()
    fit_means = model.get_perf_metrics().finalized_means()
    row = {"phase": "train", "config": "headline", "graph": "classic cat",
           "compute_dtype": "bfloat16", "steps": nb,
           "launches": epoch_counts, "fit_launches": fit_counts,
           "loss": float(folded["loss"]),
           "accuracy": float(folded["train_correct"] / folded["train_all"]),
           "untouched_sampled_rows": int(cold.numel()),
           "untouched_rows_bit_identical": cold_same,
           "touched_sampled_rows_changed": changed,
           "fit_metrics": fit_means, "fit_samples_per_s": fit_thpt,
           "step_wall_ms": wall * 1e3 / nb,
           "samples_per_s": nb * BATCH / wall,
           "note": "walls are information, not a claim"}
    log(row)
    if not (_finite(folded) and np.isfinite(list(fit_means.values())).all()):
        raise AssertionError("headline training gave a non-finite metric")
    if epoch_counts["row_update"] != nb or fit_counts["row_update"] != 9:
        raise AssertionError(f"row_update launched {epoch_counts} times in "
                             f"{nb} steps and {fit_counts} in fit's 9")
    if not cold_same or changed < 0.99:
        raise AssertionError(f"rows: untouched identical {cold_same}, "
                             f"touched changed {changed}")
    del model, state
    torch.cuda.empty_cache()
    return row, {k: epoch_counts[k] + fit_counts[k] for k in epoch_counts}


def train_fused_sparse(inputs, labels):
    """(ii) The fused graph on the row-sparse path: rows injected, pooled
    and interacted in PyTorch, the row-update kernel on every step."""
    model, state = _train_model(True, "bfloat16")
    nb = 4
    part = ({k: v[:nb] for k, v in inputs.items()}, labels[:nb])
    reset_counts()  # the main path starts here
    state, folded = model.train_epoch(state, *part)
    torch.cuda.synchronize()
    counts = read_counts()  # ... and ends here
    log({"phase": "train", "config": "fused_sparse", "steps": nb,
         "launches": counts, "loss": float(folded["loss"])})
    if not _finite(folded) or counts["row_update"] != nb:
        raise AssertionError(f"fused sparse path: launches {counts}, "
                             f"finite {_finite(folded)}")
    del model, state
    torch.cuda.empty_cache()
    return counts


def train_fused_dense(inputs, labels):
    """(iii) The fused graph on the dense table gradient at f32: the
    forward kernel, the backward kernel and the row-update kernel's
    scatter into the 2.05 GB table gradient on every step."""
    model, state = _train_model(True, "float32", sparse="off")
    step0 = ({k: v[0] for k, v in inputs.items()}, labels[0])
    same, err = _same_step(model, state, *step0, fused_module,
                           "fused_interact_bwd_cuda", fused_interact_bwd_ref)
    log({"phase": "train_vs_plain", "config": "fused_dense",
         "plain": "fused_interact_bwd_ref", "bit_identical": same,
         "max_abs_err": err, "tolerance": "exact (cat)"})
    if not same:
        raise AssertionError("fused dense step through the backward kernel "
                             "!= the same step on fused_interact_bwd_ref")
    state, _ = model.train_step(state, *step0)  # warm
    torch.cuda.synchronize()
    nb = 4
    part = ({k: v[1:1 + nb] for k, v in inputs.items()}, labels[1:1 + nb])
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, *part)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()  # ... and ends here
    row = {"phase": "train", "config": "fused_dense", "graph": "fused cat",
           "compute_dtype": "float32", "steps": nb, "launches": counts,
           "loss": float(folded["loss"]), "step_wall_ms": wall * 1e3 / nb,
           "samples_per_s": nb * BATCH / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "note": "walls are information, not a claim"}
    log(row)
    if (not _finite(folded)
            or min(counts[k] for k in ("fused_interact_fwd",
                                       "fused_interact_bwd",
                                       "row_update")) < nb):
        raise AssertionError(f"fused dense path: launches {counts}, "
                             f"finite {_finite(folded)}")
    profile_steps(model, state, inputs, labels, "fused_dense", reps=3)
    del model, state
    torch.cuda.empty_cache()
    return row, counts


def train_fused_dense_dot(inputs, labels):
    """(iii-dot) The fused graph's dot form on the dense table gradient at
    f32 (top MLP 145-1024-1024-1024-1): the forward kernel's and the
    backward kernel's dot halves on a training path, its first step held
    to the same step on ``fused_interact_bwd_ref`` within phase 7's dot
    tolerance."""
    model, state = _train_model(True, "float32", sparse="off",
                                interact="dot")
    step0 = ({k: v[0] for k, v in inputs.items()}, labels[0])
    same, err = _same_step(model, state, *step0, fused_module,
                           "fused_interact_bwd_cuda", fused_interact_bwd_ref,
                           rtol=1e-5, atol=1e-6)
    log({"phase": "train_vs_plain", "config": "fused_dense_dot",
         "plain": "fused_interact_bwd_ref", "within_tolerance": same,
         "max_abs_err": err, "tolerance": "rtol 1e-5 atol 1e-6 (dot)"})
    if not same:
        raise AssertionError("fused dense dot step through the backward "
                             "kernel != the same step on "
                             "fused_interact_bwd_ref")
    state, _ = model.train_step(state, *step0)  # warm
    torch.cuda.synchronize()
    nb = 4
    part = ({k: v[1:1 + nb] for k, v in inputs.items()}, labels[1:1 + nb])
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, *part)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()  # ... and ends here
    row = {"phase": "train", "config": "fused_dense_dot", "graph": "fused dot",
           "compute_dtype": "float32", "steps": nb, "launches": counts,
           "loss": float(folded["loss"]), "step_wall_ms": wall * 1e3 / nb,
           "samples_per_s": nb * BATCH / wall,
           "note": "walls are information, not a claim"}
    log(row)
    if (not _finite(folded)
            or min(counts[k] for k in ("fused_interact_fwd",
                                       "fused_interact_bwd",
                                       "row_update")) < nb):
        raise AssertionError(f"fused dense dot path: launches {counts}, "
                             f"finite {_finite(folded)}")
    profile_steps(model, state, inputs, labels, "fused_dense_dot", reps=3)
    del model, state
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------- phase 9
def _bound(nbytes, flops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def time_row_update(table, sets: int = 64):
    """Kernel A at the training step's shape (n = 256 * 8 updates of
    d = 64 on the 8M-row table), uniform and zipf ids, from CUDA graphs:
    the prepare-and-sort kernel alone, the update kernel alone on its
    prepared keys and order, and the whole ``row_update_cuda`` call;
    beside them the plain versions (``prepare_row_update_ref`` from a
    graph; ``row_update_ref`` host-synchronising, so timed eagerly), the
    library calls (``torch.sort`` for the sort, ``index_add_``, the same
    sum in an atomic order, for the update), launches per call from
    torch.profiler, the bytes bound and the add chain's serial floor."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    rows, n = table.shape[0], BATCH * TABLES
    out = {}
    for kind in ("uniform", "zipf"):
        arg_sets = [(table, _row_ids(kind, n, rows, gen, rng),
                     torch.randn((n, DIM), generator=gen, device="cuda"),
                     torch.tensor(-0.01, device="cuda"))
                    for _ in range(sets)]
        id_sets = [(i, rows) for _, i, _, _ in arg_sets]
        prepared = [(t,) + prepare_row_update_cuda(i, rows) + (u, s)
                    for t, i, u, s in arg_sets]
        uniq = sum(int(torch.unique(a[1]).numel()) for a in arg_sets) / sets
        longest = sum(_longest_run(a[1], rows) for a in arg_sets) / sets
        # the call: ids (8 B) and updates read, each touched row read and
        # written; the sort alone: ids read, keys and order written
        nbytes = 2 * uniq * DIM * 4 + n * DIM * 4 + n * 8
        bound_ms, bound_by = _bound(nbytes, 2 * n * DIM)
        prep_bytes = n * 8 + n * 8
        prep_bound_ms, prep_bound_by = _bound(prep_bytes, 0)
        row = {"phase": "timing", "kernel": "row_update", "ids": kind,
               "n": n, "d": DIM, "rows": rows, "distinct_rows": uniq,
               "mean_longest_run": longest, "bytes": nbytes,
               "bound_ms": bound_ms, "bound_by": bound_by,
               # L dependent FADDs of 4 cycles at the 1.98 GHz boost clock
               "serial_floor_ms": longest * 4 / SM_CLOCK_HZ * 1e3,
               "ms": graph_ms(row_update_cuda, arg_sets),
               "kernel_ms": graph_ms(launch_row_update, prepared),
               "prep_ms": graph_ms(prepare_row_update_cuda, id_sets),
               "plain_ms": wall_ms(row_update_ref, arg_sets[:16]),
               "prep_plain_ms": graph_ms(prepare_row_update_ref, id_sets),
               "library_ms": graph_ms(
                   lambda t, i, u, s: t.index_add_(0, i, u, alpha=-0.01),
                   arg_sets),
               "prep_library_ms": graph_ms(
                   lambda i, r: torch.sort(i, stable=True), id_sets),
               "prep_bytes": prep_bytes, "prep_bound_ms": prep_bound_ms,
               "prep_bound_by": prep_bound_by,
               "call_ms": wall_ms(row_update_cuda, arg_sets)}
        # "ms" is the whole call, so it includes "prep_ms"
        row["launches_per_call"], row["kernels_per_call"] = (
            launches_per_call(row_update_cuda, arg_sets))
        row["share_of_bound"] = bound_ms / row["ms"]
        log(row)
        out[kind] = row
    # the sort's cost by its passes (R's bit length: 8, 16, 23 bits), and
    # the update kernel's by the length of one run among uniform ids
    log({"phase": "timing", "kernel": "row_update_prep", "n": n,
         "ms_by_passes": {
             passes: graph_ms(prepare_row_update_cuda, [
                 (torch.randint(0, r, (n,), generator=gen, device="cuda"), r)
                 for _ in range(16)])
             for passes, r in ((1, 200), (2, 60_000), (3, rows))}})
    by_run = {}
    for length in (1, 32, 64, 256, 1024):
        sets = []
        for _ in range(16):
            ids = torch.randint(0, rows, (n,), generator=gen, device="cuda")
            ids[:length] = rows // 2
            ids = ids[torch.randperm(n, generator=gen, device="cuda")]
            sets.append((table,) + prepare_row_update_cuda(ids, rows) + (
                torch.randn((n, DIM), generator=gen, device="cuda"),
                torch.tensor(-0.01, device="cuda")))
        by_run[length] = graph_ms(launch_row_update, sets)
    log({"phase": "timing", "kernel": "row_update", "n": n,
         "kernel_ms_by_run_length": by_run,
         "serial_floor_ms_per_row": 4 / SM_CLOCK_HZ * 1e3})
    return out


def _op_backward(interact):
    """``FusedEmbedInteractFn.backward`` as autograd calls it at f32 (the
    op's whole backward: the zero table gradient, the backward kernel
    with the safe ids, the row update's two kernels), on a context that
    holds what the forward saved."""
    def call(table, gids, bottom, g):
        ctx = SimpleNamespace(saved_tensors=(table, bottom, gids),
                              config=(interact, "sum", None))
        return fused_module.FusedEmbedInteractFn.backward(ctx, g)
    return call


# the op backward's device operations besides the backward kernel: the
# zero table gradient and the row update's prepare-and-sort and update
_OP_BWD_OTHERS = ("FillFunctor", "Memset", "prep_", "row_update_kernel")


def time_fused_bwd(table, sets: int = 64):
    """The backward kernel at B in 1, 8, 64, 256 for cat and dot, called
    as the op calls it (with the safe ids): its time, its bound, its
    plain version's time, the launch floor (an empty kernel), and the
    one-launch gate; no single PyTorch call computes it, so there is no
    library time.  At B = 256 also the op's whole backward on the 8M-row
    table: its time, its device operations per call, and the gate that
    it launches the backward kernel once and no clamp."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    floor_ms = _launch_floor_ms(sets)
    out = {}
    for interact in ("cat", "dot"):
        for bsz in BUCKETS:
            arg_sets = [(table, _gids(gen, bsz, 1, drop=False),
                         _bottom(gen, bsz), _cotangent(gen, bsz, interact))
                        for _ in range(sets)]

            def kern(t, gi, b, g):
                return fused_interact_bwd_cuda(t, gi, b, g, interact=interact,
                                               want_safe=True)

            def plain(t, gi, b, g):
                return fused_interact_bwd_ref(t, gi, b, g, interact=interact,
                                              want_safe=True)

            width = interact_width(interact, TABLES, DIM, BOT)
            slots = bsz * TABLES
            # g and the ids read; row grads, dbottom and safe ids written
            nbytes = 4 * (bsz * width + slots + slots * DIM + bsz * BOT
                          + slots)
            flops = 0
            if interact == "dot":
                f = TABLES + 1
                nbytes += 4 * (slots * DIM + bsz * BOT)  # re-read rows
                flops = slots * DIM + 4 * bsz * f * f * DIM
            bound_ms, bound_by = _bound(nbytes, flops)
            row = {"phase": "timing", "kernel": "fused_interact_bwd",
                   "interact": interact, "B": bsz, "T": TABLES, "bag": 1,
                   "d": DIM, "bytes": nbytes, "bound_ms": bound_ms,
                   "bound_by": bound_by, "launch_floor_ms": floor_ms,
                   "ms": graph_ms(kern, arg_sets),
                   "plain_ms": graph_ms(plain, arg_sets),
                   "library_ms": None, "call_ms": wall_ms(kern, arg_sets)}
            row["launches_per_call"], row["kernels_per_call"] = (
                launches_per_call(kern, arg_sets))
            row["share_of_bound"] = bound_ms / row["ms"]
            if bsz == BATCH:
                op_sets = arg_sets[:8]  # each call zero-fills a 2.05 GB table
                op = _op_backward(interact)
                row["op_backward_ms"] = graph_ms(op, op_sets)
                row["op_backward_call_ms"] = wall_ms(op, op_sets)
                row["op_backward_ops_per_call"], row["op_backward_ops"] = (
                    launches_per_call(op, op_sets))
            log(row)
            out[interact, bsz] = row
            check_one_launch("fused_interact_bwd_cuda", kern, arg_sets,
                             fused_interact_bwd_cuda,
                             "fused_interact_bwd_kernel",
                             row["launches_per_call"],
                             row["kernels_per_call"])
            if bsz == BATCH:
                check_one_launch("op backward", op, op_sets,
                                 fused_interact_bwd_cuda,
                                 "fused_interact_bwd_kernel",
                                 row["op_backward_ops_per_call"],
                                 row["op_backward_ops"],
                                 others=_OP_BWD_OTHERS)
    return out


# -------------------------------------------------------------- phase 10

def _set_ids(gen, n, rows):
    """int32 ids of one phase-10 case, in a random order: n - n // 4
    distinct live rows and n // 4 dropped ids, in turn the sentinel R,
    -1, int32 min and R + 5.  Returns (ids, the live rows)."""
    n_drop = n // 4
    live = torch.randperm(rows, generator=gen, device="cuda")[:n - n_drop]
    bad = torch.tensor([rows, -1, INT32_MIN, rows + 5], device="cuda")
    ids = torch.cat([live, bad[torch.arange(n_drop, device="cuda") % 4]])
    perm = torch.randperm(n, generator=gen, device="cuda")
    return ids.to(torch.int32)[perm], live


def check_row_set(table) -> float:
    """The row-set kernel against ``row_set_ref`` on clones of ``table``
    (the headline's 8M x 64 flat table) and of 1M-row tables of d = 16
    and 128, bit for bit; sampled untouched rows must be unchanged and
    the live rows set."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    others = {d: _rows_tensor(gen, ROWS, d) for d in (16, 128)}
    failed, worst = [], 0.0
    for d in (16, DIM, 128):
        base = table if d == DIM else others[d]
        rows = base.shape[0]
        for n in (0, 1, 7, 4096, 16_384, 131_072):
            ids, live = _set_ids(gen, n, rows)
            vals = torch.randn((n, d), generator=gen, device="cuda")
            got = row_set_cuda(base.clone(), ids, vals)
            want = row_set_ref(base.clone(), ids, vals)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            err = float((got - want).abs().max()) if n else 0.0
            worst = max(worst, err)
            sample = torch.randint(0, rows, (8192,), generator=gen,
                                   device="cuda")
            cold = sample[~torch.isin(sample, live)]
            untouched = torch.equal(got[cold], base[cold])
            hit = (ids >= 0) & (ids < rows)
            set_ok = torch.equal(got[ids[hit].long()], vals[hit])
            ok = ok and untouched and set_ok
            case = {"phase": "kernel_vs_plain", "kernel": "row_set", "n": n,
                    "rows": rows, "d": d, "live": int(hit.sum()),
                    "dropped_negative": int((ids < 0).sum()),
                    "dropped_past_end": int((ids >= rows).sum()),
                    "untouched_sampled_rows": int(cold.numel()),
                    "untouched_bit_identical": untouched,
                    "live_rows_set": set_ok, "max_abs_err": err,
                    "tolerance": "exact", "ok": bool(ok)}
            log(case)
            if not ok:
                failed.append(case)
            del got, want
    del others
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{len(failed)} row_set case(s) disagree with "
                             f"the plain version")
    return worst


# -------------------------------------------------------------- phase 11
def _same_bits(k, r) -> bool:
    """Equal values, with NaN where the other has NaN."""
    nan = torch.isnan(k)
    return torch.equal(nan, torch.isnan(r)) and torch.equal(
        k.masked_fill(nan, 0), r.masked_fill(nan, 0))


def check_embedding_bag():
    """The bag kernel against ``embedding_bag_ref`` on 1M-row tables of
    d = 128 and 256, bit for bit: sum and avg, bag 1, 3 and 8, B = 1, 8,
    64 and 256, with a bag of one repeated row and a bag repeating
    another; then the paths the redesign added: int32 ids, a bag of 40
    (longer than a warp's ids and a lane's register chunk) and d = 33
    (the scalar path, on a 100k-row table), with a wrapped id (-5) and
    one out of range (a NaN row).  Returns (max abs error, the d = 128
    table)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    tables = {d: _rows_tensor(gen, ROWS, d) for d in (128, 256)}
    tables[33] = _rows_tensor(gen, 100_000, 33)
    cases = [(d, bag, torch.int64, False) for d in (128, 256)
             for bag in (1, 3, 8)]
    cases += [(d, bag, dt, True) for d in (128, 33) for bag in (1, 8, 40)
              for dt in (torch.int32, torch.int64)]
    failed, worst = [], 0.0
    for d, bag, dtype, edges in cases:
        table = tables[d]
        rows = table.shape[0]
        for bsz in BUCKETS:
            ids = torch.randint(0, rows, (bsz, bag), generator=gen,
                                device="cuda")
            ids[0] = int(ids[0, 0])
            if bsz > 1:
                ids[-1] = ids[0]
            if edges and bsz > 2:
                ids[1, bag // 2], ids[2, bag - 1] = -5, rows
            ids = ids.to(dtype)
            for mode in ("sum", "avg"):
                k = embedding_bag_cuda(table, ids, mode)
                r = embedding_bag_ref(table, ids, mode)
                torch.cuda.synchronize()
                ok = _same_bits(k, r) and k.shape == (bsz, d)
                live = ~torch.isnan(r)
                err = float((k[live] - r[live]).abs().max())
                worst = max(worst, err)
                case = {"phase": "kernel_vs_plain", "kernel": "embedding_bag",
                        "B": bsz, "bag": bag, "d": d, "rows": rows,
                        "ids": str(dtype)[6:], "mode": mode,
                        "wrapped_and_nan_ids": edges and bsz > 2,
                        "max_abs_err": err, "tolerance": "exact",
                        "ok": bool(ok)}
                log(case)
                if not ok:
                    failed.append(case)
    if failed:
        raise AssertionError(f"{len(failed)} embedding_bag case(s) disagree "
                             f"with the plain version")
    return worst, tables[128]


# -------------------------------------------------------------- phase 12
def _states_equal(a, b) -> bool:
    return (int(a.step) == int(b.step)
            and all(torch.equal(v, b.params[op][k])
                    for op, params in a.params.items()
                    for k, v in params.items()))


def _staged_fit(model, batches, epochs=2):
    """``fit`` from a fresh seed-0 state over the first ``batches``
    batches of SyntheticDLRMLoader(seed=0), launch counts reset just
    before and read just after.  Returns (state, counts, row)."""
    state = model.init(seed=0)
    loader = SyntheticDLRMLoader(batches * BATCH, BOT, [ROWS] * TABLES, 1,
                                 BATCH, seed=0)
    torch.cuda.synchronize()
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, thpt = model.fit(state, loader, epochs=epochs, verbose=False)
    wall = time.perf_counter() - t0
    counts = read_counts()  # ... and ends here
    means = model.get_perf_metrics().finalized_means()
    row = {"batches": batches, "epochs": epochs,
           "staged": model._last_fit_used_scan,
           "cache": model._epoch_cache_active,
           "chunks": model._epoch_chunk_bounds(batches),
           "launches": counts, "fit_samples_per_s": thpt, "wall_s": wall,
           "last_epoch_metrics": means}
    if not np.isfinite(list(means.values())).all():
        raise AssertionError(f"staged fit gave a non-finite metric: {row}")
    return state, counts, row


def train_staged(inputs, labels):
    """fit(epochs=2) of the classic headline graph on the staged branch
    with the epoch row cache.  At 16 batches (ladder [8]: 2 blocks per
    epoch) against the same fit uncached and on ``row_set_ref``; at 64
    batches (ladder [8]: 8 blocks of 16,384 rows per epoch inside the
    131,072-row epoch cache), the main path: 17 row-set launches, then a
    chunked run (levels off, chunk 16) and ``train_epochs`` cached and
    uncached over the same batches, all bit for bit."""
    model, _ = _train_model(False, "bfloat16")
    off, _ = _train_model(False, "bfloat16", epoch_row_cache="off")
    chunked, _ = _train_model(False, "bfloat16", epoch_cache_levels="off",
                              epoch_cache_chunk=16)
    n_ops = len(model._sparse_ops)
    cached16, counts16, row16 = _staged_fit(model, 16)
    uncached16, counts_off, row_off = _staged_fit(off, 16)
    with _plain(cache_module, "row_set_cuda", row_set_ref):
        plain16, counts_plain, _ = _staged_fit(model, 16)
    same_off = _states_equal(cached16, uncached16)
    same_plain = _states_equal(cached16, plain16)
    del cached16, uncached16, plain16
    log({"phase": "train_staged", "config": "headline, 16 batches", **row16,
         "uncached": row_off, "vs_uncached_bit_identical": same_off,
         "vs_row_set_ref_bit_identical": same_plain})
    if not (row16["staged"] and row16["cache"] and not row_off["cache"]
            and same_off and same_plain
            and counts16["row_set"] == 5 * n_ops
            and counts_off["row_set"] == 0 == counts_plain["row_set"]):
        raise AssertionError("staged fit at 16 batches: cached != uncached "
                             "or != row_set_ref, or wrong launches")
    main, counts, row = _staged_fit(model, 64)
    chunk_state, chunk_counts, chunk_row = _staged_fit(chunked, 64)
    same_chunked = _states_equal(main, chunk_state)
    del chunk_state
    walls, epochs_states, losses = {}, {}, {}
    for name, m in (("cached", model), ("uncached", off)):
        st = m.init(seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, stacked = m.train_epochs(st, inputs, labels, 2)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        epochs_states[name] = st
        losses[name] = stacked["loss"].tolist()
    same_epochs = _states_equal(epochs_states["cached"],
                                epochs_states["uncached"])
    nb = labels.shape[0]
    row = {"phase": "train_staged", "config": "headline, 64 batches", **row,
           "chunked": chunk_row, "vs_chunked_bit_identical": same_chunked,
           "train_epochs_wall_s": walls,
           "train_epochs_samples_per_s": {
               k: 2 * nb * BATCH / v for k, v in walls.items()},
           "train_epochs_losses": losses,
           "train_epochs_cached_vs_uncached_bit_identical": same_epochs,
           "note": "walls are information, not a claim"}
    log(row)
    finite = all(np.isfinite(v).all() for v in losses.values())
    if not (row["staged"] and row["cache"] and row["chunks"] is None
            and counts["row_set"] == 17 * n_ops
            and counts["row_update"] == 1 + 2 * 64 * n_ops
            and chunk_row["chunks"] and chunk_counts["row_set"] == 8 * n_ops
            and same_chunked and same_epochs and finite):
        raise AssertionError("staged fit at 64 batches: wrong path, "
                             "launches, or results")
    for name, m in (("cached", model), ("uncached", off)):
        profile_epoch(m, epochs_states[name], inputs, labels,
                      f"staged_{name}")
    del model, off, chunked, main, epochs_states
    torch.cuda.empty_cache()
    return row, counts


def profile_epoch(model, state, inputs, labels, config: str):
    """Where a staged epoch's time goes (information, not a check): one
    train_epoch under torch.profiler, per step."""
    from torch.profiler import ProfilerActivity, profile
    nb = labels.shape[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_epoch(state, inputs, labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / nb
    _log_profile(prof, config, nb, wall_us)


# -------------------------------------------------------------- phase 13
BAG_ROWS, BAG_DIM, BAG = 1_000_000, 128, 8


def _bag_graph():
    """One 1M x 128 Embedding(use_pallas=True), bag 8, B = 256,
    concatenated with a dense input of width 128, then Linear 256-1, MSE,
    SGD lr 0.01 (FFModel.embedding never passes the flag, as in the JAX
    package, so the op is added directly)."""
    model = FFModel(FFConfig(batch_size=BATCH))
    ids = model.create_tensor((BATCH, BAG), "int64", name="ids")
    dense = model.create_tensor((BATCH, BAG_DIM), "float32", name="dense")
    emb = model._add(Embedding(model._name("embedding"), ids, BAG_ROWS,
                               BAG_DIM, "sum", use_pallas=True))
    model.dense(model.concat([emb, dense], axis=1), 1, name="out")
    model.compile(optimizer=SGDOptimizer(lr=0.01),
                  loss_type="mean_squared_error",
                  metrics=("mean_squared_error",))
    return model, model.init(seed=0)


def train_bag_graph():
    """A few training steps of the use_pallas graph through train_epoch:
    the bag kernel forward and its backward's row update into a zero
    table, every step.  Its forward is held against the plain forward
    and one step against the same step on the plain versions."""
    model, state = _bag_graph()
    op = model.get_op("embedding")
    rng = np.random.default_rng(13)
    nb = 4
    inputs = {"ids": rng.integers(0, BAG_ROWS, (nb + 1, BATCH, BAG)),
              "dense": rng.standard_normal((nb + 1, BATCH, BAG_DIM)).astype(
                  np.float32)}
    labels = rng.standard_normal((nb + 1, BATCH, 1)).astype(np.float32)
    first = ({k: v[0] for k, v in inputs.items()}, labels[0])
    got = model.predict(state, first[0])
    with _plain(emb_module, "embedding_bag_cuda", embedding_bag_ref):
        want = model.predict(state, first[0])
    fwd_same = torch.equal(got, want)
    a, b = state.clone(), state.clone()
    a, ma = model.train_step(a, *first)
    with _plain(emb_module, "embedding_bag_cuda", embedding_bag_ref), \
            _plain(emb_module, "row_update_cuda", row_update_ref):
        b, mb = model.train_step(b, *first)
    step_same = _states_equal(a, b) and torch.equal(ma["loss"], mb["loss"])
    del a, b
    rest = ({k: v[1:] for k, v in inputs.items()}, labels[1:])
    torch.cuda.synchronize()
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, *rest)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()  # ... and ends here
    row = {"phase": "train_bag", "config": "Embedding(use_pallas=True)",
           "use_pallas": op.use_pallas,
           "row_sparse_ops": [o.name for o in model._sparse_ops],
           "steps": nb, "launches": counts, "loss": float(folded["loss"]),
           "forward_vs_plain_bit_identical": fwd_same,
           "step_vs_plain_bit_identical": step_same,
           "step_wall_ms": wall * 1e3 / nb,
           "note": "walls are information, not a claim"}
    log(row)
    if not (op.use_pallas and not model._sparse_ops and fwd_same
            and step_same and _finite(folded)
            and counts["embedding_bag"] == nb
            and counts["row_update"] == nb):
        raise AssertionError(f"use_pallas graph: {row}")
    del model, state
    torch.cuda.empty_cache()
    return row, counts


# -------------------------------------------------------------- phase 14
def _epoch_rowofs(sets, gen):
    """Writeback plans of the main path's shapes from fresh uniform epochs
    of 64 batches (B = 256, 8 tables, bag 1): the epilogue's (n = 131,072
    into the 8M-row table) and the first ladder block's (n = 16,384 into
    the 131,072-row epoch cache)."""
    offsets = torch.arange(TABLES, device="cuda")[:, None] * ROWS
    epilogue, block = [], []
    for _ in range(sets):
        ids = torch.randint(0, ROWS, (64, BATCH, TABLES, 1), generator=gen,
                            device="cuda") + offsets
        rowof, slots = slot_rows(ids, TABLES * ROWS)
        epilogue.append(rowof)
        block.append(slot_rows(slots[:8], rowof.numel())[0])
    return {"epilogue": epilogue, "block": block}


def time_row_set(table, sets: int = 4):
    """The row-set kernel at the epilogue and block shapes: the kernel
    alone on prepared inputs and the whole wrapper from CUDA graphs, the
    plain version (host-synchronising, so timed eagerly) and
    ``index_copy_`` on the live ids (the library call).  The bound counts
    this run's live rows: each read once from the rows and written once,
    plus the n int32 ids."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for shape, rowofs in _epoch_rowofs(sets, gen).items():
        parent = (table if shape == "epilogue"
                  else _rows_tensor(gen, 64 * BATCH * TABLES, DIM))
        arg_sets = [(parent, r, torch.randn((r.numel(), DIM), generator=gen,
                                            device="cuda")) for r in rowofs]
        prepared = [(t,) + prepare_row_set(t, i, v) for t, i, v in arg_sets]
        lib_sets = []
        for t, i, v in arg_sets:
            hit = i < t.shape[0]
            lib_sets.append((t, i[hit].long(), v[hit].contiguous()))
        n = rowofs[0].numel()
        live = sum(int(a[1].numel()) for a in lib_sets) / sets
        nbytes = 2 * live * DIM * 4 + n * 4
        bound_ms, bound_by = _bound(nbytes, 0)
        row = {"phase": "timing", "kernel": "row_set", "shape": shape,
               "n": n, "d": DIM, "rows": parent.shape[0],
               "live_rows": live, "bytes": nbytes, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "ms": graph_ms(launch_row_set, prepared),
               "wrapper_ms": graph_ms(row_set_cuda, arg_sets),
               "plain_ms": wall_ms(row_set_ref, arg_sets),
               "library_ms": graph_ms(
                   lambda t, i, v: t.index_copy_(0, i, v), lib_sets),
               "call_ms": wall_ms(row_set_cuda, arg_sets)}
        row["share_of_bound"] = bound_ms / row["ms"]
        log(row)
        out[shape] = row
        del arg_sets, prepared, lib_sets
    torch.cuda.empty_cache()
    return out


def time_embedding_bag(table, sets: int = 256):
    """The bag kernel at the JAX docstring's shape (1M x 128 f32, bag 8)
    at every serving bucket, its plain version and ``F.embedding_bag``
    (mode "sum", the library call), from CUDA graphs cycling many id
    sets, with int64 ids (8 bytes each in the bound) and int32 ids, on a
    table that fits the L2 (50k x 128), the launches per call, and the
    launch floor.  Returns the B = 256 row."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    floor_ms = _launch_floor_ms(sets)
    l2_table = _rows_tensor(gen, L2_ROWS // 2, BAG_DIM)
    rows = {}
    for bsz in BUCKETS:
        arg_sets = [(table, torch.randint(0, BAG_ROWS, (bsz, BAG),
                                          generator=gen, device="cuda"))
                    for _ in range(sets)]
        i32_sets = [(t, i.to(torch.int32)) for t, i in arg_sets]
        l2_sets = [(l2_table, i % (L2_ROWS // 2)) for _, i in arg_sets]
        nbytes = 4 * bsz * BAG * BAG_DIM + 8 * bsz * BAG + 4 * bsz * BAG_DIM
        bound_ms, bound_by = _bound(nbytes, bsz * BAG * BAG_DIM)
        row = {"phase": "timing", "kernel": "embedding_bag", "B": bsz,
               "bag": BAG, "d": BAG_DIM, "rows": BAG_ROWS, "mode": "sum",
               "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
               "launch_floor_ms": floor_ms,
               "ms": graph_ms(embedding_bag_cuda, arg_sets),
               "int32_ids_ms": graph_ms(embedding_bag_cuda, i32_sets),
               "l2_table_ms": graph_ms(embedding_bag_cuda, l2_sets),
               "plain_ms": graph_ms(embedding_bag_ref, arg_sets),
               "library_ms": graph_ms(
                   lambda t, i: torch.nn.functional.embedding_bag(
                       i, t, mode="sum"), arg_sets),
               "call_ms": wall_ms(embedding_bag_cuda, arg_sets)}
        row["launches_per_call"], row["kernels_per_call"] = (
            launches_per_call(embedding_bag_cuda, i32_sets[:64]))
        row["share_of_bound"] = bound_ms / row["ms"]
        log(row)
        rows[bsz] = row
        check_one_launch("embedding_bag_cuda", embedding_bag_cuda,
                         i32_sets[:64], embedding_bag_cuda,
                         "embedding_bag_kernel", row["launches_per_call"],
                         row["kernels_per_call"])
    return rows[BATCH]


def _entry(name, launches, err, timing):
    source, replaces, _ = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card_info()
    build_kernels()
    # phases 3-5: the serving path
    model, state = build_model()
    table = state.params["emb"]["embedding"]
    fwd_err = check_kernel_cases(table)
    serve_launches, path_err = serve(model, state)
    top = time_kernel(model, state)[-1]  # the top serving bucket, B=256
    # the main path launches the folded call: its time, plain version and
    # whole-call bound
    fwd_time = {"ms": top["op_ms"], "plain_ms": top["op_plain_ms"],
                "bound_ms": top["op_bound_ms"],
                "bound_by": top["op_bound_by"],
                "library_ms": top["library_ms"]}
    # phases 6-7: the training kernels against their plain versions
    row_err, prep_err = check_row_update(table)
    bwd_err = check_fused_bwd(table)
    # phases 10-11: the row-set and bag kernels against their plain versions
    set_err = check_row_set(table)
    bag_err, bag_table = check_embedding_bag()
    del model, state, table
    torch.cuda.empty_cache()
    # phase 8: the training paths
    inputs, labels = _epoch_data(64)
    headline, headline_counts = train_headline(inputs, labels)
    sparse_counts = train_fused_sparse(inputs, labels)
    dense, dense_counts = train_fused_dense(inputs, labels)
    dot_counts = train_fused_dense_dot(inputs, labels)
    # phases 12-13: the staged, cached epochs and the use_pallas graph
    staged, staged_counts = train_staged(inputs, labels)
    bag_row, bag_counts = train_bag_graph()
    path_counts = (headline_counts, sparse_counts, dense_counts, dot_counts,
                   staged_counts, bag_counts)
    row_launches = sum(c["row_update"] for c in path_counts)
    prep_launches = sum(c["row_update_prep"] for c in path_counts)
    if prep_launches != row_launches:
        raise AssertionError(f"{prep_launches} prepare-and-sort launches "
                             f"for {row_launches} row updates")
    # phases 9 and 14: timings at the paths' shapes
    gen = torch.Generator(device="cuda").manual_seed(9)
    table = _rows_tensor(gen, TABLES * ROWS, DIM)
    row_times = time_row_update(table)
    row_time = row_times["zipf"]  # the main path's realistic traffic
    prep_time = {"ms": row_time["prep_ms"],
                 "plain_ms": row_time["prep_plain_ms"],
                 "bound_ms": row_time["prep_bound_ms"],
                 "bound_by": row_time["prep_bound_by"],
                 "library_ms": row_time["prep_library_ms"]}
    bwd_time = time_fused_bwd(table)["cat", BATCH]
    set_time = time_row_set(table)["epilogue"]
    bag_time = time_embedding_bag(bag_table)
    log({"phase": "done", "wall_s": round(time.perf_counter() - t0, 3),
         "train_step_wall_ms": {"headline": headline["step_wall_ms"],
                                "fused_dense": dense["step_wall_ms"],
                                "use_pallas": bag_row["step_wall_ms"]},
         "staged_fit_samples_per_s": staged["fit_samples_per_s"]})
    log({"kernels": [
        _entry("fused_interact_fwd",
               serve_launches + sum(c["fused_interact_fwd"]
                                    for c in (dense_counts, dot_counts)),
               max(fwd_err, path_err), fwd_time),
        _entry("fused_interact_bwd",
               sum(c["fused_interact_bwd"] for c in (dense_counts,
                                                     dot_counts)),
               bwd_err, bwd_time),
        _entry("row_update", row_launches, row_err, row_time),
        _entry("row_update_prep", prep_launches, prep_err, prep_time),
        _entry("row_set", staged_counts["row_set"], set_err, set_time),
        _entry("embedding_bag", bag_counts["embedding_bag"], bag_err,
               bag_time)]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
