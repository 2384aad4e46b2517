#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dlrm_flexflow_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build every kernel in dlrm_flexflow_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card;
  4. serve the full-width run_random.sh DLRM (fused interaction) through
     InferenceEngine + DynamicBatcher and check the answers and that the
     kernel ran on that path;
  5. time each kernel at the path's shapes beside its bound, its plain
     version and a library call.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from dlrm_flexflow_tpu_torch import FFConfig, _cuda
from dlrm_flexflow_tpu_torch.apps.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.ops import FusedEmbedInteract
from dlrm_flexflow_tpu_torch.ops.fused_interact_kernel import (
    fused_interact_cuda, fused_interact_ref, interact_width, mask_local_ids)
from dlrm_flexflow_tpu_torch.serving import DynamicBatcher, InferenceEngine

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# f32 rate outside the tensor cores, which the fused kernel's adds and
# dot products run at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the run_random.sh serving model (bench.py::bench_serving)
TABLES, ROWS, DIM, BOT = 8, 1_000_000, 64, 64
BUCKETS = (1, 8, 64, 256)
SOURCE = "dlrm_flexflow_tpu_torch/csrc/fused_interact.cu"
REPLACES = "dlrm_flexflow_tpu/ops/pallas_fused_interact.py:146"


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
def _gids(gen, bsz, bag, drop: bool):
    """Masked flat ids (B, T, bag) int32 for the 8 x 1M-row tables, with
    dropped ids (-1, -3, int32 min, and one past a table's end) when
    ``drop`` and the shape has room for them."""
    local = torch.randint(0, ROWS, (bsz, TABLES, bag), generator=gen,
                          device="cuda", dtype=torch.int64)
    if drop and bag:
        flat = local.view(-1)
        bad = [-1, -3, int(np.iinfo(np.int32).min), ROWS]
        for i, v in enumerate(bad[:flat.numel() // 2]):
            flat[(i * 7919) % flat.numel()] = v
    offsets = torch.arange(TABLES, device="cuda", dtype=torch.int64) * ROWS
    counts = torch.full((TABLES,), ROWS, device="cuda", dtype=torch.int64)
    return mask_local_ids(local, offsets, counts).to(torch.int32)


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


def check_kernel_cases(table) -> float:
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    failed = []
    for bsz in (1, 7, 256):
        for bag in (0, 1, 3):
            gids = _gids(gen, bsz, bag, drop=True)
            bottom = _bottom(gen, bsz)
            for interact in ("cat", "dot"):
                for aggr in ("sum", "avg"):
                    for cd in ((None,) if interact == "cat"
                               else (None, "bfloat16")):
                        kw = dict(interact=interact, aggr=aggr,
                                  compute_dtype=cd)
                        k = fused_interact_cuda(table, gids, bottom, **kw)
                        r = fused_interact_ref(table, gids, bottom, **kw)
                        torch.cuda.synchronize()
                        ok, tol = _agree(k, r, interact, bag)
                        ok = ok and k.shape == (bsz, interact_width(
                            interact, TABLES, DIM, BOT))
                        err = float((k - r).abs().max()) if k.numel() else 0.0
                        worst = max(worst, err)
                        case = {"phase": "kernel_vs_plain",
                                "kernel": "fused_interact_fwd", "B": bsz,
                                "bag": bag, "interact": interact,
                                "aggr": aggr, "compute_dtype": cd,
                                "max_abs_err": err, "tolerance": tol,
                                "ok": bool(ok)}
                        log(case)
                        if not ok:
                            failed.append(case)
    if failed:
        raise AssertionError(f"{len(failed)} kernel case(s) disagree with "
                             f"the plain version")
    return worst


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

    fused_interact_cuda.launches = 0  # the main path starts here
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
    launches = fused_interact_cuda.launches  # the main path ends here
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
def _graph_ms(fn, arg_sets, reps: int = 5) -> float:
    """Device time of one call of ``fn``: the calls over every argument
    set are captured once in a CUDA graph (no host launch cost between
    them), the graph is replayed ``reps`` times between CUDA events, and
    the total is divided by the calls.  Cycling many id sets touches more
    table rows than the 50 MB L2 holds at the large buckets."""
    for args in arg_sets[:3]:
        fn(*args)  # warm the allocator and the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def _eager_ms(fn, arg_sets) -> float:
    """Wall time of one call as the host issues it, launch cost included."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(arg_sets)


def time_kernel(table, sets: int = 256):
    """Per serving bucket: the kernel, its plain version and
    ``F.embedding_bag`` (the pooling part only; the port never calls it)
    on the same inputs, and the bytes bound."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for bsz in BUCKETS:
        bag = 1
        arg_sets = [(table, _gids(gen, bsz, bag, drop=False),
                     _bottom(gen, bsz)) for _ in range(sets)]

        def kern(t, g, b):
            return fused_interact_cuda(t, g, b, interact="cat", aggr="sum")

        def plain(t, g, b):
            return fused_interact_ref(t, g, b, interact="cat", aggr="sum")

        def library(t, g, b):
            return torch.nn.functional.embedding_bag(
                g.view(-1, bag), t, mode="sum")

        width = interact_width("cat", TABLES, DIM, BOT)
        live = sum(int((g >= 0).sum()) for _, g, _ in arg_sets) / sets
        nbytes = 4 * (live * DIM + bsz * BOT + bsz * TABLES * bag
                      + bsz * width)
        flops = live * DIM  # the pooling adds
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        row = {"phase": "timing", "kernel": "fused_interact_fwd",
               "B": bsz, "T": TABLES, "bag": bag, "d": DIM,
               "interact": "cat", "bytes": nbytes,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "ms": _graph_ms(kern, arg_sets),
               "plain_ms": _graph_ms(plain, arg_sets),
               "library_ms": _graph_ms(library, arg_sets),
               "call_ms": _eager_ms(kern, arg_sets),
               "plain_call_ms": _eager_ms(plain, arg_sets)}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(row)
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card_info()
    build_kernels()
    model, state = build_model()
    table = state.params["emb"]["embedding"]
    worst = check_kernel_cases(table)
    launches, path_err = serve(model, state)
    head = time_kernel(table)[-1]  # the top serving bucket, B=256
    log({"phase": "done", "wall_s": round(time.perf_counter() - t0, 3)})
    log({"kernels": [{
        "name": "fused_interact_fwd", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(worst, path_err), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]}]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
