#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dlrm_flexflow_tpu_torch) on one GPU,
and on a machine of four or more, the mesh between four of them.

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
     InferenceEngine + DynamicBatcher (one CUDA graph per bucket) and
     check the answers, that the kernel ran on that path (launch counts
     through the graphs' replay accounting) and that the graphs replayed;
     every bucket's graph against the eager model.predict, bit for bit,
     full and padded; a lazy bucket capture while another thread runs
     eager forwards, the capturing thread holding its capture open (host
     waits only, at most 5 s) until that thread has finished two
     synchronising calls; profile a dispatch graphed and eager;
  5. time the fused forward at the serving buckets beside its bound, its
     plain version, a library call and the launch floor (an empty kernel),
     and the whole call as the op issues it, before (mask, cast, kernel)
     and now (one launch), with launches per call;
  6. hold the row update's two kernels (prepare-and-sort, update) against
     their plain versions, bit for bit, over ids uniform, zipf, one id,
     wrapped and dropped, int32 edges, R at a radix digit's bit
     boundary, n from 0 to 65,536, d 16/64/128, f32/bf16 updates and
     a float or tensor scale, and twice for determinism; and on bf16
     tables (n = 2048 on 1M x 64, uniform and zipf, the small-R and the
     wrap/drop cases); and at NMT's widths (n = 64 x 40 int32 ids into
     20,480 rows of d = 1024 and 2048, uniform, zipf and one id, f32
     and bf16 tables);
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
     the plain versions; on every path four captured and replayed steps
     held bit for bit against four eager steps, and the main path's
     steps replayed from one captured step;
  9. time the row update (the sort alone, the update alone, the whole
     call, launches per call from torch.profiler, uniform and zipf ids)
     and the backward kernel at the path's shapes (cat and dot, beside
     the launch floor; one launch a call, and the op's whole backward
     launches it once and no clamp), and
     the training steps (information, not a claim);
 10. hold the row-set kernel against its plain version, bit for bit, on
     f32 tables and on the 8M x 64 table in bf16, and on the edges of
     its design: n = 1, 31, 33 and 131,067, rows of 64 B to 4,000 B,
     the 4- and 2-byte words (bf16 d = 3, f32 d = 5, rows 4 and 2 bytes
     into their storage), a warp tile all dropped, a dense touch;
 11. hold the embedding-bag kernel against its plain version, bit for bit,
     int64 and int32 ids, bags up to 40, d = 128, 256 and 33, on f32 and
     bf16 tables (1M x 128, B = 256, bag 8, sum and avg among them);
 12. train the classic graph through fit's staged branch with the epoch
     row cache (fit(epochs=2) over 64 batches: one train_epochs, the
     ladder [8], 17 row-set launches, one capture), held bit for bit
     against the same run uncached, on row_set_ref, on eager steps,
     chunked, and through train_epochs;
 13. train a graph of Embedding(use_pallas=True) (the bag kernel forward,
     its row-update backward) a few steps, its forward and one step held
     against the plain versions, on an f32 and on a bf16 table;
 14. time the row-set kernel at the epilogue and block shapes (one
     launch a call, by its counter and the profiler), the bag
     kernel at every serving bucket (int64 and int32 ids, launches per
     call, the launch floor), and profile the cached and uncached staged
     epochs, graphed and eager (information, not a claim);
 15. (vii) train the run_random.sh classic graph on bf16 tables
     (embedding_dtype="bfloat16", 1,024,000,000 B): one step against
     row_update_ref, graphed steps against eager ones, 64 batches through
     train_epoch, then the staged cached fit(epochs=2) against the same
     fit uncached, all bit for bit;
 16. (viii) serve the fused model with its tables quantized at load, int8
     and bf16, through the batcher on the f32 engine's requests: within
     1e-2 of it, padding and graph-vs-eager bit for bit, the f32-only
     fused kernel never launched, the byte report checked;
 17. the serving path and one staged fit inside an event log with the
     /metrics endpoint up on 127.0.0.1: every event valid, one compile
     event per capture, the engine, batcher and train families scraped;
     walls with telemetry on and off (information);
 18. time the bag, row-update and row-set kernels on bf16 storage beside
     their bounds, plain versions and library calls (information);
 19. durability: the headline model (classic graph, bf16 compute, seed
     0) through fit's resilient loop over 2 epochs x 8 batches of a
     shuffling ArrayDataLoader, every step through the row-update kernel:
     (a) the plain per-batch fit; (b) CheckpointManager(keep_n=2) saving
     every 8 steps, killed by preempt@step=10; (c) resumed from (b)'s
     directory at step 9; (d) an uninterrupted twin; (e) (d) with
     prefetch_depth=2 (pinned staging, a prefetch stream); (f)
     nan_grads@step=5 under NaNSentinel("skip"): 15 adopted steps, one
     anomaly.  (c) = (d) in loss trace and parameters, (d) = (a) and
     (e) = (d) in parameters, bit for bit; verify_checkpoint clean on
     every directory before and after; each save's and the restore's
     wall, bytes and GB/s, the free disk, and the step wall with and
     without the sentinel (information).  It writes under a directory
     beside this script (at most two run directories, about 8.3 GB, at
     once) and removes it;
 20. tiered storage, the cost gates and the router, on the run_random.sh
     serving model without the fused interaction (bf16 compute, buckets
     1-256): (a) measure the constants of ops/kernel_costs.py (pinned
     H2D of 1-2048 rows of 256 B, the StackedEmbedding gather at the
     buckets, the row set's 2048-row install, index_copy_, a 64 MiB
     copy_, the launch floor) and print each gate's decision and flip
     point at the served shapes, under the committed and the measured
     constants; (b) build InferenceEngine(storage="tiered") at 4096 hot
     rows a table with the gate deciding on 512 zipf (1.05) requests'
     row frequencies (a refusal is printed on its own line, and the
     engine built again under FF_TIERED_STORAGE=on); (c) serve those
     requests of 1-256 rows through the batcher from 8 threads, each
     result bit for bit the resident engine's, then again one dispatch
     at a time on an aot=False tiered engine: bit for bit the resident
     and the graphed results, one row-set launch on each dispatch with
     misses and none on an all-hit one; (d) again at 512 hot rows (the
     tier evicts) through a 4-replica ReplicaRouter over that one
     engine, bit for bit; (e) scatter_apply of a tiered store on the
     card against the same store on the CPU (the plain versions), bit
     for bit, with writebacks; (f) a 4-replica router over the resident
     fused engine (B3), bit for bit its answers; (g) save_tiered /
     load_tiered of (c)'s 2 GB store, bit for bit, and a load at 512 hot
     rows re-admitting the hottest prefix.  Hit %, misses, evictions,
     the miss stall (median, p99), QPS and p99 are information;
 21. lazy optimizers, on (i)'s model (8 f32 tables of 1M x 64, bf16
     compute): (a) AdamOptimizer(lr=0.001, lazy_embeddings=True) and
     SGDOptimizer(lr=0.01, momentum=0.9, lazy_embeddings=True), uncached:
     one step through the row update against the same step on
     row_update_ref (parameters, moment or velocity tables and loss, bit
     for bit), 16 graphed steps against 16 eager ones; (b), (c) fit
     (epochs=2) over 64 staged batches cached (the epoch cache alone),
     laddered ("16,8") and uncached, bit for bit, with each path's B2
     and B5 launches checked (B2 4 a step under Adam: the duplicate-run
     sum, m, v, the weights; 3 under momentum); (d) dense Adam (weight
     decay 1e-4) for 4 steps: finite metrics, every table row moved; (e)
     a 3-epoch per-batch fit under LearningRateScheduler: the state's
     rate each epoch is the schedule's, graphed bit for bit eager.  The
     graphed step walls of SGD, lazy momentum and lazy Adam, the staged
     fits' samples/s and the slot tables' bytes are information;
 22. the SOAP core, on (i)'s classic graph and on the fused graph (8 f32
     tables of 1M x 64, bf16 compute, B = 256): (a) CostModel(
     H100MachineModel(), measure=True) times every op on the card (one
     line per op: measured and analytic forward and backward, their
     ratio; a fallback to the analytic estimate fails the phase), the
     embedding ops' backward through B2, the fused op's forward through
     B3; (b) Simulator(model, 1) of the data-parallel strategy against
     the measured step (phase 8 (i)'s train_epoch wall for the classic
     graph, phase 22's replayed steps for the fused one), and calibrate's
     scale (information); (c) mcmc_search at 4 and 8 simulated devices,
     budget 500, seed 0, Python and native, each best no slower than
     data-parallel, with its wall; (d) the 8-device best saved as .json
     and .pb and loaded back equal, compile(strategy=) on the card, 8
     graphed steps bit for bit against the same 8 steps without a
     strategy;
 23. the closed SOAP loop and its reports, on the fused run_random.sh
     model at f32 compute (B3 forward; B4 then B2 backward), every sink,
     artifact and flight record under one temporary directory beside
     this script, removed at the end: (a) OpTimer(model, iters=10)
     .profile inside an event log, one valid op_time event per op with
     its measured and analytic forward and backward, B3, B4 and B2
     launched; (b) search_tune(model, 4, sink, artifacts, budget=300,
     seed=0) twice on the calibrated simulator's bench: "first" at v1,
     then "promoted" at v2 with parent 1, the calibration's error
     strictly lower after the fit, every artifact valid, the incumbent
     loaded through Strategy.load, dlrm_strategy_version at 2; each
     class's scales, the calibrated and the analytic best at 4 devices
     against data-parallel (information); (c) tools/search_tune.py
     --bench real on (b)'s artifacts: the candidate's and the
     incumbent's graphed steps (B2), the verdict information; (d) the
     fused engine through the batcher under an SLOMonitor(p99 at the
     latency edge at or above 10x phase 4's p99, availability 99.9,
     freshness 600) on a fake clock, /metrics up on 127.0.0.1: a healthy
     stretch, a delayed one (one breach of the latency SLO, /healthz
     degraded over HTTP, exactly one flight record), healthy ticks until
     one recover (/healthz ok), the burn and budget gauges one row per
     SLO, the freshness SLO on the incumbent's age; (e) the report CLI on
     (a)-(d)'s sinks in a subprocess, text and JSON with the same
     sections (per_op, calibration, tuning, serving and slo among them),
     report --flight on (d)'s record, regress on this run's entries
     stamped with the card's name: 0 against themselves, non-zero
     against a copy 20% slower;
 24. the reference's five other apps at their published widths and
     depth (apps/*.py defaults: AlexNet at 229, ResNet-50 3/4/6/3 at
     224, Inception-v3 at 299, Candle-Uno, NMT at vocabulary 20,480 and
     2048 wide), batch 64, each with its CLI's optimizer, loss and data:
     NMT's step through B2 against the same step on row_update_ref bit
     for bit, four graphed steps against four eager ones bit for bit
     (batch-norm statistics included), then the main path, fit over the
     CLI's four batches (NMT: B2 twice a step, B5 at the epoch cache's
     writebacks), five timed graphed steps; the ops count, parameter
     bytes, losses, peak memory, step wall, and the f64 dense layer's
     forward and backward beside its step (AlexNet's 9216 -> 4096,
     NMT's 20,480-wide projection) are printed;
 25. one forward and one SGD step (lr 0.01) of each app at batch 2, full
     width, on the card against the port's CPU path from the same
     parameters: logits, loss and the parameters' change within
     CARD_VS_CPU_TOL (TF32 would show);
 26. B2 timed at NMT's shape (n = 2560, d = 2048, f32) beside its plain
     version, index_add_ and the bytes bound;
 27. small graphs of the ops no app uses (batch norm, dropout, mixture of
     experts, attention causal and not, split, reverse, the elementwise
     ops): four graphed steps against four eager ones bit for bit, four
     steps on the card against the CPU (losses and the change of every
     parameter and running statistic within SMALL_TOL), the dropout
     masks of each step equal on the card and the CPU, and at lr 0 the
     loss of one batch different on every replay.  Each of phases
     24-27 prints its wall;
 28. last (host-heavy), the hetero Criteo-Kaggle DLRM
     (criteo_kaggle_config, one Embedding per table, B = 256, SGD at
     lr 0.01 without weight decay, MSE, Zipf 1.05 ids from seed 0):
     (a) the strategy dlrm_strategy(26, 1, hetero_cpu_embeddings=True,
     stacked=False), all 26 tables (412 MB) in host memory; (b) only the
     four tables of over 1M rows on the host and 22 on the card (B2).
     Each run: native/ffruntime.cpp built from the checkout and used for
     every lookup and deposit (the numpy branches raise); 8 steps of fit
     against the same steps on the port's CPU path from the same
     weights, tables and data (losses and the change of every parameter
     and table within CARD_VS_CPU_TOL); the tables and every handle
     move; no CUDA graph captured; the bytes init allocates on the card
     (memory_allocated after it less before it, since earlier phases
     hold some) within the card's own params and below the host tables'
     bytes (412 MB in (a)); B2's
     launches 22 a step in (b), none in (a); a save and restore of the
     host tables bit for bit; the step split into host lookup, H2D,
     device, D2H, host gradient and host update (hetero.timing(),
     information), beside the card's name and power limit;
 29. bf16 activation storage (FFConfig(activation_dtype="bfloat16")),
     each graph first checked to declare every op output bf16 but the
     final output and the loss input, and to store one forward's values
     so: (a) the run_random.sh classic graph at bf16 compute: one step
     through B2 against row_update_ref bit for bit, four graphed steps
     against four eager ones bit for bit, 16 losses beside the
     f32-activation model's from the same weights (within 0.05, the JAX
     package's policy), three steps against the port's CPU path (losses
     within rtol 1e-3), then the main path, train_epoch over the 64
     batches with the epoch cache (B2 a step, B5); (b) the fused model
     served through the batcher over buckets 1-256 (B3), the padding
     contract and every bucket's graph against the eager forward bit for
     bit; (c) Inception-v3 at 299, batch 64, bf16 compute and
     activations: four graphed steps against four eager ones bit for
     bit, the graphed step's wall and peak memory beside the same
     model's under f32 activations, and at batch 2 the logits and the
     loss against the port's CPU path (ACT_INCEPTION_TOL);
 30. bf16 tiered serving: the run_random.sh tables stored bf16 (1.02 GB),
     4096 hot rows a table, phase 20's 512 zipf-1.05 requests from 8
     clients, bit for bit the resident bf16 engine's; hit %, QPS and p99
     beside phase 20's f32 run; B5 bf16 installs counted; then a bf16
     store's scatter_apply on the card against the CPU store, bit for
     bit (bf16 grads through B2 on the bf16 rows, f32 grads through B2
     on an f32 copy of the touched rows, set back by B5);
 31. the frontends: the keras examples seq_mnist_mlp (784-512-512-10)
     and func_cifar10_cnn at their widths on keras_datasets' data, and
     a torch.fx conversion of a torch CNN (weights imported from the
     module's CUDA tensors), each four steps on the card against the
     same model on the CPU, then fit, timed steps and evaluate;
     ONNXModel refusing without onnx.  No kernel runs in this phase;
 32. the mesh: (a) one rank through distributed.initialize (NCCL over a
     file store, one all_reduce): the run_random.sh classic graph under
     make_mesh({"data": 1}), and its table-parallel form under {"data":
     1, "model": 1} with table_exchange="allgather" (which warns and
     stays off), each four steps bit for bit the no-mesh model, the
     row-update kernel and the captured steps included; (b) two ranks on
     the one card over gloo (NCCL refuses two ranks on one device): the
     table-parallel DLRM at full width on {"data": 1, "model": 2}, four
     tables a rank, in both exchange modes and the overlapped graph, four
     steps each against the port's one-process run on the card (losses,
     touched rows, MLPs at rtol 1e-5, table sums), and ring attention at
     (2, 8, 4096, 64) on {"seq": 2} against sdpa (2e-5); each collective
     gloo refuses on CUDA tensors is logged and the rest runs.  Step
     walls and the exchange's share of the step are printed beside the
     card; two gloo ranks on one card say nothing of NCCL over NVLink.
     No kernel runs under the two-rank mesh;
 33. last (host I/O), elastic recovery, in a directory beside this
     script, removed at its end: (1) two gloo ranks on the one card
     train the table-parallel run_random.sh DLRM at full width (f32
     compute, SGD lr 0.01) on {"data": 1, "model": 2} with
     table_exchange="allgather", four steps; (2) they commit a podshard
     checkpoint through CheckpointManager(multihost=None), each rank
     its ~1.03 GB of tables, rank 0 the replicated leaves, the meta and
     the manifest; (7) rank 0 serves 32 requests of 1-256 rows through
     the mesh engine, broadcasting each bucket to rank 1, which
     follows; (3) one more step, then a second save at which rank 1
     hangs at the barrier (host_hang@barrier): rank 0 raises
     FleetBarrierTimeout naming p1 within its 20 s deadline (a recovery
     event, one flight record), and ckpt-4 stays the newest valid
     checkpoint; (4) in this process recover_and_resume reshards ckpt-4
     onto one card with no mesh, bit for bit the ranks' step-4 state
     (SHA-256 of every leaf); (6) InferenceEngine.from_checkpoint(...,
     on_mesh_change="reshard") bit for bit the engine built from the
     restored state over the 32 requests (buckets 1-256), and the
     mesh's answers within 1e-6 of it; (5) four graphed steps through B2
     (one call a step), the losses of all eight steps within rtol 1e-5
     of a never-killed one-process run.  No kernel launches in the
     ranks.  The save's walls by stage (D2H, npz write, SHA-256, fsync,
     the barriers), bytes per rank, the barrier timeout's wall, the
     restore's (read, reassemble, H2D), the resumed step walls, B2's
     launches and the dispatch walls, mesh and one process, are printed;
 34. scale-out on the one card, in a directory beside this script,
     removed at its end: (a) phase 28's all-host Kaggle DLRM (26 tables,
     412 MB in host memory, B = 256) on {"data": 2} over two gloo ranks,
     8 steps: rank 0 alone holds the tables and runs the native lookups
     and deposits over the global batch; the losses within rtol 1e-5,
     the host tables and handles within 1e-6 (the largest differences
     printed) of the same model in one process on the card from the
     same weights and batches, no kernel launch in the ranks; a
     podshard save whose rank-1 shard holds no table, restored on one
     card bit for bit; 3 more steps split by part (id gather, lookup,
     rows' scatter, cotangent gather, deposit, host update, H2D, D2H);
     (b) the table-parallel run_random.sh DLRM (f32 compute) on {"data":
     1, "model": 2} served int8 then bf16 through a mesh engine quantized
     at load (codes of 4 tables a rank, the int8 scale column whole on
     each), 32 requests of 1-256 rows each, within 1e-6 of the one-card
     engine of the same mode, dispatch walls of both; (c)
     tools/search_tune.py --pod 2x4 --bench sim (its ``_2x4pod``
     pointer) and --pod auto (one card: the flat pointer), both exit 0.
     No kernel launches in the ranks (kernels are off under a mesh of
     more than one rank);
 35. the mesh between cards, only when torch sees four or more (else one
     line, {"phase": "mesh_cards", "ran": false, "cards": n}, and nothing
     else): four NCCL ranks, one a card (distributed.launch with no
     backend), through the rank bodies of phases 32-34, in a directory
     beside this script removed at its end.  Any error of any rank fails
     the phase (nothing is refused under NCCL), and no rank may launch a
     kernel.  Each run is held against one process of the port on card 0
     after the group has left, from the same weights and batches: (a)
     the run_random.sh DLRM at full width, f32, SGD lr 0.01, global batch
     1024, MESH_STEPS steps, on {"data": 4} (row-sparse replicas),
     {"data": 1, "model": 4} (two tables a rank; allgather, all_to_all
     and the overlapped graph) and {"data": 2, "model": 2} (all_to_all):
     every rank's losses at rtol 1e-5, its touched rows and MLPs at rtol
     1e-5 / atol 1e-6, its table sums; the step wall on every rank, one
     process's, the exchange's wall and share, samples/s across the
     cards; (b) ring attention and Ulysses (its all-to-all) on {"seq": 4}
     at RING_SHAPE against sdpa at 2e-5; (c) phase 34(a) on {"data": 4}
     (rank 0 holds the host tables behind distributed.host_group's gloo
     group beside NCCL): losses rtol 1e-5, tables and handles 1e-6, the
     split by part on every rank; (d) phase 34(b) on {"data": 1, "model":
     4}, the buckets broadcast on the card, ranks 1-3 following, answers
     within 1e-6 of the one-card engine of each mode, dispatch walls of
     both; then, under a 15 s collective deadline, the leader leaves the
     bf16 engine without its stop and every follower must leave with
     follow()'s "the leader ..." error within 45 s of its last answer;
     (e) phase 33's elastic_rank on {"data": 1, "model": 4} (allgather,
     batch 1024): a podshard commit, rank 3 never reaching the second
     save's barrier (each survivor's FleetBarrierTimeout names p3 within
     its 20 s deadline), the three survivors recover_and_resume at world
     3 over NCCL at a new store, resharded onto {"data": 3} at batch 768
     (four table shards become three replicas), every restore bit for
     bit the saved blocks, MESH_STEPS more steps at rtol 1e-5 of one
     process resumed from the same checkpoint; the save's walls by
     stage, the timeouts and the recoveries printed; (f) the DLRM CLI
     (CLI_ARGS) under python -m torch.distributed.run
     --nproc_per_node=4: exit 0, every rank's epoch metrics equal,
     samples/s of each rank.  The kernels line counts no launch of this
     phase.
  36. the port's ffcheck (dlrm_flexflow_tpu_torch/analysis), on every
     machine, after the timings: (a) `python -m
     dlrm_flexflow_tpu_torch.analysis --format json -o` a sink in a
     temporary directory, as a child: exit 0 (clean or waived, no stale
     waiver), its wall on this host, its modules and findings by pass,
     and the telemetry report's == analysis == section of the sink; (b)
     each spelling trace-purity/trace-staleness flag (VOCAB_CASES) as
     the one line of a method captured through graphs.GraphRunner on
     cuda:0, a child per case, all in flight together: the analyzer
     must give the case its code and the card must refuse the capture
     (the syncs) or freeze it (clock reads, a Python attribute, a
     rebound global, os.environ, a Python counter, a print: after the
     Python change two replays keep the capture-time result, or do not
     repeat the effect); (c) every function a GraphRunner captured in
     this run (recorded from the start of main by wrapping the class's
     capture from here) is a static capture entry of the analyzer or
     reachable from one.
The phases that train epochs of the run_random.sh model ask for the
epoch row cache ("on"): "auto" is off on the card.
Profile lines carry the graph replays in their window, the graph pool's
bytes and the host's launches per dispatch or step.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from dlrm_flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                     SGDOptimizer, SyntheticDLRMLoader,
                                     ZipfDLRMLoader, _cuda)
from dlrm_flexflow_tpu_torch import epoch_cache as cache_module
from dlrm_flexflow_tpu_torch import native_lib
from dlrm_flexflow_tpu_torch import model as model_module
from dlrm_flexflow_tpu_torch import telemetry as tele
from dlrm_flexflow_tpu_torch.apps.dlrm import (KAGGLE_TABLES, DLRMConfig,
                                               build_dlrm,
                                               criteo_kaggle_config)
from dlrm_flexflow_tpu_torch.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from dlrm_flexflow_tpu_torch.data import native as native_module
from dlrm_flexflow_tpu_torch.data.loader import ArrayDataLoader, zipf_ids
from dlrm_flexflow_tpu_torch.frontends import keras as keras_frontend
from dlrm_flexflow_tpu_torch.frontends import onnx_model
from dlrm_flexflow_tpu_torch.frontends.keras_callbacks import (
    Callback, LearningRateScheduler)
from dlrm_flexflow_tpu_torch.frontends.torch_fx import PyTorchModel
from dlrm_flexflow_tpu_torch.graphs import flatten
from dlrm_flexflow_tpu_torch.ops import Embedding, FusedEmbedInteract
from dlrm_flexflow_tpu_torch.ops import embedding as emb_module
from dlrm_flexflow_tpu_torch.ops import fused_interact as fused_module
from dlrm_flexflow_tpu_torch.ops import hetero as hetero_module
from dlrm_flexflow_tpu_torch.ops.bag_kernel import (embedding_bag_cuda,
                                                   embedding_bag_ref)
from dlrm_flexflow_tpu_torch.ops.quantized import BF16_ATOL, INT8_ATOL
from dlrm_flexflow_tpu_torch.ops.fused_interact_kernel import (
    empty_launch_cuda, fused_embed_interact_cuda, fused_embed_interact_ref,
    fused_interact_bwd_cuda, fused_interact_bwd_ref, fused_interact_cuda,
    fused_interact_ref, interact_width, mask_local_ids)
from dlrm_flexflow_tpu_torch.ops.row_set_kernel import (
    launch_row_set, prepare_row_set, row_set_cuda, row_set_plan, row_set_ref)
from dlrm_flexflow_tpu_torch.ops.row_update_kernel import (
    launch_row_update, prepare_row_update_cuda, prepare_row_update_ref,
    row_update_cuda, row_update_ref)
from dlrm_flexflow_tpu_torch.ops.slotting import slot_rows
from dlrm_flexflow_tpu_torch.ops.softmax import dropout_keep, fold_in
from dlrm_flexflow_tpu_torch.parallel import Strategy
from dlrm_flexflow_tpu_torch.parallel.strategy_pb import dlrm_strategy
from dlrm_flexflow_tpu_torch.profiling import OpTimer
from dlrm_flexflow_tpu_torch.resilience import (CheckpointManager,
                                                NaNSentinel, Preemption,
                                                faultinject,
                                                verify_checkpoint)
from dlrm_flexflow_tpu_torch.ops import kernel_costs
from dlrm_flexflow_tpu_torch.serving import (DynamicBatcher, InferenceEngine,
                                             ReplicaRouter)
from dlrm_flexflow_tpu_torch.sim import (CostModel, H100MachineModel,
                                         Simulator, mcmc_search)
from dlrm_flexflow_tpu_torch.sim import tune
from dlrm_flexflow_tpu_torch.sim.search import data_parallel_strategy
from dlrm_flexflow_tpu_torch.storage import (TieredEmbeddingTable,
                                             load_tiered, predicted_hit_rate,
                                             save_tiered)
from dlrm_flexflow_tpu_torch.telemetry import rowfreq
from dlrm_flexflow_tpu_torch.tensor import Tensor
from dlrm_flexflow_tpu_torch.telemetry import exporter as tele_exporter
from dlrm_flexflow_tpu_torch.telemetry import fleet as tele_fleet
from dlrm_flexflow_tpu_torch.telemetry import metrics as tele_metrics
from dlrm_flexflow_tpu_torch.telemetry import regress as tele_regress
from dlrm_flexflow_tpu_torch.telemetry import report as tele_report
from dlrm_flexflow_tpu_torch.telemetry import schema as tele_schema
from dlrm_flexflow_tpu_torch.telemetry import slo as tele_slo
from dlrm_flexflow_tpu_torch.tools import search_tune as tune_tool
from dlrm_flexflow_tpu_torch.tools.cuda_timing import (graph_ms,
                                                    launches_per_call,
                                                    wall_ms)

#: the JAX package's pinned absolute tolerances of quantized serving on
#: the sigmoid outputs (scripts/check_kernels.py:16-18, :57-58, :164)
QUANT_ATOL = {"int8": INT8_ATOL, "bf16": BF16_ATOL}

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
# phase 20: the tiered serving run of bench.py (BENCH_STORAGE=tiered,
# BENCH_HOT_ROWS, BENCH_ID_DIST=zipf at its default exponent)
HOT_ROWS = 4096
ZIPF_ALPHA = 1.05
# phases 24-26: the apps' batch (FFConfig's default) and NMT's embedding
# tables (nmt.py defaults): 20,480 rows of 2048, 64 x 40 ids a step
APP_BATCH = 64
NMT_ROWS, NMT_DIM, NMT_IDS = 20 * 1024, 2048, APP_BATCH * 40
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


def _free() -> None:
    """Release a finished phase's memory: its models, states and graph
    pools (a CUDA graph's pool goes with its runner)."""
    gc.collect()
    torch.cuda.empty_cache()


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
        # each kernel's properties, under its (mangled) name
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln
                 or "Function properties for" in ln]
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
def build_model(**config):
    """The run_random.sh DLRM with the fused interaction, at full width
    and depth: 8 tables of 1M x 64 f32 (2.05 GB), bottom 64-512-512-64,
    cat to 576, top 576-1024-1024-1024-1, bf16 compute, random weights
    from seed 0, on the card; ``config`` adds FFConfig fields."""
    cfg = DLRMConfig(embedding_size=[ROWS] * TABLES, fused_interaction="on")
    ffc = FFConfig(batch_size=BUCKETS[-1], compute_dtype="bfloat16",
                   serve_buckets=",".join(map(str, BUCKETS)), **config)
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
    the traffic and read just after it.  Returns (launches, the plain
    forward's max abs error, the batcher's p99 in us)."""
    t0 = time.perf_counter()
    engine = InferenceEngine(model, state)
    torch.cuda.synchronize()
    log({"phase": "engine", "buckets": engine.buckets,
         "graphs": sorted(engine._graphs),
         "warmup_s": round(time.perf_counter() - t0, 3),
         "pool_bytes": pool_bytes(engine._pool)})
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
    replays0 = engine.graph_replays
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
    replays = engine.graph_replays - replays0
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
    if launches <= 0 or replays <= 0:
        raise AssertionError(f"the serving path launched {launches} fused "
                             f"kernels in {replays} graph replays")
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
         "graph_replays": replays,
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
    check_buckets_vs_eager(model, state, engine, rng)
    check_lazy_capture_beside_traffic(model, state, rng)
    for n in (1, 256):
        profile_dispatch(model, state, engine,
                         big[256] if n == 256 else reqs[0][0], n)
    return launches, err, summary.get("p99_us")


def check_buckets_vs_eager(model, state, engine, rng,
                           config: str = "serving") -> None:
    """Every bucket's graph, after the traffic's replays, against the eager
    ``model.predict`` on the same rows, bit for bit: a full bucket and a
    partial one (padded by the engine, unpadded eagerly)."""
    rows = []
    for b in engine.buckets:
        for n in sorted({b, max(1, b - 3)}):
            req = _request(rng, n)
            before = engine.graph_replays
            got = engine.predict(req)
            want = model.predict(state, req).cpu().numpy()
            rows.append({"bucket": b, "rows": n,
                         "replayed": engine.graph_replays - before,
                         "bit_identical": bool(np.array_equal(got, want)),
                         "max_abs_err": float(np.abs(got - want).max())})
    ok = all(r["bit_identical"] and r["replayed"] == 1 for r in rows)
    log({"phase": "graph_vs_eager", "config": config, "cases": rows,
         "ok": ok})
    if not ok:
        raise AssertionError("a bucket's graph != the eager forward")


#: how long an open capture waits for the other thread's synchronising
#: calls (phase 4's lazy capture); reaching it fails the check
OVERLAP_WAIT_S = 5.0


@contextlib.contextmanager
def _capture_times(marks, opened=None):
    """Append ``("begin" | "end", perf_counter())`` to ``marks`` around
    every CUDA graph capture made inside the block.  With ``opened`` (a
    callable), the capturing thread calls it once ``capture_begin`` has
    returned, before the captured work."""
    cls = torch.cuda.CUDAGraph
    begin, end = cls.capture_begin, cls.capture_end

    def timed_begin(self, *args, **kwargs):
        marks.append(("begin", time.perf_counter()))
        out = begin(self, *args, **kwargs)
        if opened is not None:
            opened()
        return out

    def timed_end(self, *args, **kwargs):
        out = end(self, *args, **kwargs)
        marks.append(("end", time.perf_counter()))
        return out

    cls.capture_begin, cls.capture_end = timed_begin, timed_end
    try:
        yield
    finally:
        cls.capture_begin, cls.capture_end = begin, end


def check_lazy_capture_beside_traffic(model, state, rng) -> None:
    """An engine built without warmup captures its bucket at the first
    dispatch while another thread runs eager forwards and small
    device-to-host copies, each a synchronising call.  The engine
    captures in ``thread_local`` mode (a ``global`` capture forbids such
    calls in every thread), so neither thread may fail, the dispatch must
    equal the eager forward bit for bit, and some of the other thread's
    synchronising calls must have finished while the capture was open.
    The overlap is made certain: once ``capture_begin`` has returned, the
    capturing thread waits on a ``threading.Event``, with host waits only
    and no CUDA call, until the other thread has logged two synchronising
    calls after that mark; a wait of ``OVERLAP_WAIT_S`` fails the check."""
    engine = InferenceEngine(model, state, buckets=[8], warmup=False)
    req, other = _request(rng, 5), _request(rng, 64)
    probe = torch.ones(1, device="cuda")
    stop, errors, synced, marks = threading.Event(), [], [], []
    overlapped, since_open, waits = threading.Event(), [], []

    def note_sync():
        t = time.perf_counter()
        synced.append(t)
        if since_open and t > since_open[0]:
            since_open.append(t)
            if len(since_open) > 2:  # the mark and two calls after it
                overlapped.set()

    def opened():
        since_open.append(time.perf_counter())
        waits.append(overlapped.wait(OVERLAP_WAIT_S))

    def traffic():
        try:
            while not stop.is_set():
                model.predict(state, other).cpu()
                note_sync()
                for _ in range(8):
                    probe.cpu()
                    note_sync()
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    thread = threading.Thread(target=traffic)
    try:
        thread.start()
        while len(synced) < 9 and thread.is_alive():
            time.sleep(0.001)
        with _capture_times(marks, opened):
            got = engine.predict(req)  # the eager run and the capture
    finally:
        stop.set()
        thread.join(timeout=120)
        sys.setswitchinterval(interval)
    want = model.predict(state, req).cpu().numpy()
    opened = [t for k, t in marks if k == "begin"]
    closed = [t for k, t in marks if k == "end"]
    during = (sum(1 for t in synced if opened[0] < t < closed[0])
              if len(opened) == len(closed) == 1 else 0)
    ok = (not errors and not thread.is_alive() and during > 0
          and waits == [True] and sorted(engine._graphs) == [8]
          and bool(np.array_equal(got, want)))
    log({"phase": "graph_vs_eager", "config": "lazy capture beside eager "
         "traffic", "captures": len(opened),
         "capture_ms": (closed[0] - opened[0]) * 1e3 if closed else None,
         "traffic_syncs_during_capture": during,
         "overlap_waits_met": waits, "overlap_wait_limit_s": OVERLAP_WAIT_S,
         "errors": [repr(e) for e in errors[:1]], "ok": ok})
    if not ok:
        raise AssertionError("a lazy bucket capture beside another "
                             "thread's forwards failed")


def pool_bytes(handle):
    """Bytes of device memory in the segments of one graph memory pool
    (``torch.cuda.memory_snapshot``), or "not measured" when the
    snapshot does not name pools."""
    if handle is None:
        return 0
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return "not measured"
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == tuple(handle))


# host-side operations that put work on the card (CUDA API calls that
# launch a kernel or a graph, or copy)
_HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                  "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
                  "cudaLaunchKernelExC", "cuLaunchKernelEx")


def _device_profile(prof, calls: int, wall_us: float,
                    plain_wall_us: float) -> dict:
    """Per call of a profiled window: device busy time, idle share of the
    profiled wall (``wall_us``) and of the same window's wall without the
    profiler (``plain_wall_us``), device operations, host launches
    (``_HOST_LAUNCHES``, from the profiler's CPU activity), and the top
    device operations."""
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    host = sum(e.count for e in events
               if not str(e.device_type).endswith("CUDA")
               and e.key in _HOST_LAUNCHES)
    busy_us = sum(e.self_device_time_total for e in kernels) / calls
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"profiled_wall_us": wall_us, "wall_us": plain_wall_us,
            "device_busy_us": busy_us if kernels else "not measured",
            "device_idle_share": (1 - busy_us / wall_us) if kernels
            else "not measured",
            "device_idle_share_unprofiled": (1 - busy_us / plain_wall_us)
            if kernels else "not measured",
            "kernels_per_call": sum(e.count for e in kernels) / calls,
            "host_launches_per_call": host / calls,
            "f64_gemm_us": sum(e.self_device_time_total for e in kernels
                               if "f64" in e.key or "dgemm" in e.key.lower()
                               ) / calls if kernels else "not measured",
            "top_kernels": [{"name": e.key[:80],
                             "us": e.self_device_time_total / calls,
                             "calls": e.count / calls} for e in top]}


def profile_dispatch(model, state, engine, req, n: int, reps: int = 20
                     ) -> None:
    """Where a dispatch's time goes (information, not a check), graphed
    (``engine.predict``: copy in, one bucket graph replay, copy out) and
    eager (``model.predict`` on the request padded to the same bucket,
    the dispatch before this port's graphs): the host wall per dispatch
    without and with torch.profiler, then ``_device_profile``; the graph
    replays in the window and the engine's pool."""
    from torch.profiler import ProfilerActivity, profile
    b = engine.bucket_for(n)

    def eager():
        padded = {k: engine._pad(np.asarray(v), n, b)
                  for k, v in req.items()}
        return model.predict(state, padded)[:n].cpu().numpy()

    for mode, fn in (("graphed", lambda: engine.predict(req)),
                     ("eager", eager)):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
        replays0 = engine.graph_replays
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            prof_wall_us = (time.perf_counter() - t0) * 1e6 / reps
        log({"phase": "profile", "config": "serving", "dispatch": mode,
             "rows": n, "bucket": b,
             "graph_replays": engine.graph_replays - replays0,
             "pool_bytes": pool_bytes(engine._pool),
             **_device_profile(prof, reps, prof_wall_us, wall_us)})


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
    """(kind, n, rows, d, id dtype, update dtype, scale, table dtype) of
    phase 6; rows None means the headline's 8M-row table (for a bf16
    table, a 1M-row one)."""
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
    cases = [c + (f32,) for c in cases]
    # bf16 tables (the (vii) path): n = 2048 on a 1M x 64 table, uniform
    # and zipf ids with bf16 and f32 updates, then the small-R and the
    # wrap/drop cases above
    cases += [(k, 2048, None, DIM, torch.int64, dt, "tensor", bf16)
              for k in ("uniform", "zipf") for dt in (bf16, f32)]
    cases += [c[:7] + (bf16,) for c in cases
              if c[0] == "wrap_drop" and c[7] == f32
              and c[2] in (None, 255, 256, 257, 2 ** 16, 2 ** 16 + 1)]
    # NMT's embeddings (phase 24): n = 64 x 40 int32 token ids into
    # 20,480 rows of d = 1024 and 2048 (the update kernel's widest column
    # loops), updates in the table's dtype, f32 and bf16 tables
    cases += [(k, NMT_IDS, NMT_ROWS, d, torch.int32, dt, "tensor", dt)
              for k in ("uniform", "zipf", "one_id") for d in (1024, NMT_DIM)
              for dt in (f32, bf16)]
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

    def base_for(rows, d, dtype):
        if rows is None and dtype == torch.float32:
            return table
        rows = ROWS if rows is None else rows
        if (rows, d, dtype) not in tables:
            tables[rows, d, dtype] = _rows_tensor(gen, rows, d).to(dtype)
        return tables[rows, d, dtype]

    failed, worst, prep_worst = [], 0.0, 0.0
    for kind, n, rows_n, d, id_dtype, upd_dtype, scale_kind, tdt in (
            _row_update_cases()):
        base = base_for(rows_n, d, tdt)
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
        err = float((got.float() - want.float()).abs().max()) if n else 0.0
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
                "table_dtype": str(tdt).split(".")[-1],
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
                 optimizer=None, strategy=None, **config):
    """The run_random.sh model, or with ``interact="dot"`` its dot form
    (top MLP 145-1024-1024-1024-1), under SGD at lr 0.01 unless an
    ``optimizer`` is given, compiled with ``strategy`` when given.  The
    epoch row cache is on unless ``epoch_row_cache`` says otherwise:
    "auto" is off on the card, and the phases that train epochs here
    drive the cached path and its row-set launches."""
    config.setdefault("epoch_row_cache", "on")
    top0 = interact_width(interact, TABLES, DIM, BOT)
    cfg = DLRMConfig(embedding_size=[ROWS] * TABLES,
                     fused_interaction="on" if fused else "off",
                     arch_interaction_op=interact,
                     mlp_top=[top0, 1024, 1024, 1024, 1])
    ffc = FFConfig(batch_size=BATCH, compute_dtype=compute_dtype,
                   sparse_embedding_updates=sparse, **config)
    model = build_dlrm(cfg, ffc).compile(
        optimizer=optimizer or SGDOptimizer(lr=0.01),
        loss_type="mean_squared_error",
        metrics=("accuracy", "mean_squared_error"), strategy=strategy)
    state = model.init(seed=0)
    torch.cuda.synchronize()
    return model, state


def _epoch_data(batches, batch=BATCH, seed=0):
    """The first ``batches`` batches of ``batch`` rows of
    SyntheticDLRMLoader(seed=seed), stacked as (num_batches, batch, ...)
    arrays."""
    loader = SyntheticDLRMLoader(batches * batch, BOT, [ROWS] * TABLES, 1,
                                 batch, seed=seed)
    steps = list(loader)
    return ({k: np.stack([s[0][k] for s in steps]) for k in steps[0][0]},
            np.stack([s[1] for s in steps]))


def _finite(mets) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in mets.values())


def _tensors(state):
    """``(path, tensor)`` of every parameter, every optimizer-state
    tensor (step, lr and the slot tables) and every batch-norm statistic
    of ``state``."""
    return flatten((state.params, state.opt_state, state.bn_state))


def _same_step(model, state, inputs, labels, module, name, plain_fn,
               rtol=0.0, atol=0.0):
    """One train_step through the kernels and the same step with one
    wrapper swapped for its plain version, on clones of ``state``;
    returns (every parameter, every optimizer-state tensor and the loss
    bit-identical, or within ``rtol``/``atol`` when given; max abs
    difference over all of them)."""
    a, ma = model.train_step(state, inputs, labels, False)
    with _plain(module, name, plain_fn):
        b, mb = model.train_step(state, inputs, labels, False)
    torch.cuda.synchronize()

    def agree(x, y):
        if (rtol or atol) and x.is_floating_point():
            return torch.allclose(x, y, rtol=rtol, atol=atol)
        return torch.equal(x, y)

    same, err = True, 0.0
    for (_, v), (_, w) in zip(_tensors(a), _tensors(b)):
        same = same and agree(v, w)
        err = max(err, float((v - w).abs().max()))
    same = same and agree(ma["loss"], mb["loss"])
    return same, err


@contextlib.contextmanager
def _eager_steps(model):
    """Run the model's donated steps on the eager body: the dispatch
    before the compiled step, for the comparisons and eager profiles."""
    model._step = model._step_body
    try:
        yield
    finally:
        del model._step


def _graph_counts(model) -> dict:
    return {"captures": model.graph_captures,
            "replays": model.graph_replays}


def check_graphed_vs_eager(model, state, inputs, labels, config: str,
                           k: int = 4) -> None:
    """``k`` donated steps from a clone of ``state`` (the first eager, the
    second captured, the rest replayed; the first captures at once when
    the clone lands where an earlier state stepped eagerly) against ``k``
    eager steps (``donate=False``) from another clone: every parameter
    and optimizer-state tensor, both step counts and every metric of
    every step bit for bit."""
    eager, graphed = state.clone(), state.clone()
    before = _graph_counts(model)
    same, err = True, 0.0
    for i in range(k):
        x, y = {n: v[i] for n, v in inputs.items()}, labels[i]
        eager, em = model.train_step(eager, x, y, False)
        graphed, gm = model.train_step(graphed, x, y)
        torch.cuda.synchronize()
        # NaN equal to NaN: NMT's sparse_cce metric reads the logits, as
        # the JAX package's does (ROADMAP Queue C), and is NaN in both
        same = same and all(torch.equal(em[m], gm[m]) or bool(
            torch.isnan(em[m]) and torch.isnan(gm[m])) for m in em)
        err = max([err] + [float((em[m] - gm[m]).abs().nan_to_num())
                           for m in em])
    for (_, v), (_, w) in zip(_tensors(graphed), _tensors(eager)):
        same = same and torch.equal(v, w)
        err = max(err, float((v - w).abs().max()))
    same = same and int(graphed.step) == int(eager.step)
    after = _graph_counts(model)
    log({"phase": "graph_vs_eager", "config": config, "steps": k,
         "captures": after["captures"] - before["captures"],
         "replays": after["replays"] - before["replays"],
         "bit_identical": same, "max_abs_err": err})
    del eager, graphed
    if (not same or after["captures"] - before["captures"] != 1
            or after["replays"] - before["replays"] not in (k - 1, k)):
        raise AssertionError(f"{config}: {k} graphed steps != {k} eager "
                             f"steps, or not replayed")


def _log_profile(prof, config: str, dispatch: str, steps: int,
                 wall_us: float, plain_wall_us: float, model,
                 counts0) -> None:
    """Log a profiled window per step (``_device_profile``), with the
    graph captures and replays in the window and the model's graph
    pool."""
    counts = _graph_counts(model)
    log({"phase": "profile", "config": config, "dispatch": dispatch,
         "steps": steps, "profiled_step_wall_us": wall_us,
         "graph_captures": counts["captures"] - counts0["captures"],
         "graph_replays": counts["replays"] - counts0["replays"],
         "pool_bytes": pool_bytes(model._graph_pool),
         **_device_profile(prof, steps, wall_us, plain_wall_us)})


def profile_steps(model, state, inputs, labels, config: str, reps: int = 5):
    """Where a training step's time goes (information, not a check):
    ``reps`` donated steps timed without the profiler, then the same
    under it (``_log_profile``), graphed (two steps before the windows:
    the eager one and the capture) and then eager (``_eager_steps``)."""
    from torch.profiler import ProfilerActivity, profile
    batches = [({k: v[i] for k, v in inputs.items()}, labels[i])
               for i in range(reps + 2)]
    for x, y in batches[:2]:
        state, _ = model.train_step(state, x, y)
    torch.cuda.synchronize()

    def window():
        nonlocal state
        t0 = time.perf_counter()
        for x, y in batches[2:]:
            state, _ = model.train_step(state, x, y)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / reps

    for dispatch in ("graphed", "eager"):
        ctx = (_eager_steps(model) if dispatch == "eager"
               else contextlib.nullcontext())
        with ctx:
            plain_wall_us = window()
            counts0 = _graph_counts(model)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_us = window()
        _log_profile(prof, config, dispatch, reps, wall_us, plain_wall_us,
                     model, counts0)
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
    check_graphed_vs_eager(model, state, inputs, labels, "headline")
    touched = np.unique(op.flat_ids(torch.from_numpy(inputs["sparse"])
                                    ).numpy().reshape(-1))
    rng = np.random.default_rng(6)
    sample = rng.choice(flat.shape[0], 8192, replace=False)
    cold = torch.from_numpy(np.setdiff1d(sample, touched)).cuda()
    hot = torch.from_numpy(rng.choice(touched, 2048, replace=False)).cuda()
    cold_before, hot_before = flat[cold].clone(), flat[hot].clone()
    nb = labels.shape[0]
    graphs0 = _graph_counts(model)
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, inputs, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    epoch_counts = read_counts()  # ... and ends here
    epoch_graphs = {k: v - graphs0[k]
                    for k, v in _graph_counts(model).items()}
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
           "graphs": epoch_graphs,
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
    if epoch_graphs != {"captures": 1, "replays": nb - 1}:
        raise AssertionError(f"train_epoch did not replay its captured "
                             f"step: {epoch_graphs}")
    if not cold_same or changed < 0.99:
        raise AssertionError(f"rows: untouched identical {cold_same}, "
                             f"touched changed {changed}")
    del model, state
    _free()
    return row, {k: epoch_counts[k] + fit_counts[k] for k in epoch_counts}


def train_fused_sparse(inputs, labels):
    """(ii) The fused graph on the row-sparse path: rows injected, pooled
    and interacted in PyTorch, the row-update kernel on every step."""
    model, state = _train_model(True, "bfloat16")
    check_graphed_vs_eager(model, state, inputs, labels, "fused_sparse")
    nb = 4
    part = ({k: v[:nb] for k, v in inputs.items()}, labels[:nb])
    graphs0 = _graph_counts(model)
    reset_counts()  # the main path starts here
    state, folded = model.train_epoch(state, *part)
    torch.cuda.synchronize()
    counts = read_counts()  # ... and ends here
    graphs = {k: v - graphs0[k] for k, v in _graph_counts(model).items()}
    log({"phase": "train", "config": "fused_sparse", "steps": nb,
         "launches": counts, "graphs": graphs,
         "loss": float(folded["loss"])})
    if (not _finite(folded) or counts["row_update"] != nb
            or graphs["replays"] != nb - 1):
        raise AssertionError(f"fused sparse path: launches {counts}, "
                             f"finite {_finite(folded)}")
    del model, state
    _free()
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
    check_graphed_vs_eager(model, state, inputs, labels, "fused_dense")
    state, _ = model.train_step(state, *step0)  # the eager step: warm
    torch.cuda.synchronize()
    nb = 4
    part = ({k: v[1:1 + nb] for k, v in inputs.items()}, labels[1:1 + nb])
    graphs0 = _graph_counts(model)
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, *part)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()  # ... and ends here
    graphs = {k: v - graphs0[k] for k, v in _graph_counts(model).items()}
    row = {"phase": "train", "config": "fused_dense", "graph": "fused cat",
           "compute_dtype": "float32", "steps": nb, "launches": counts,
           "graphs": graphs, "pool_bytes": pool_bytes(model._graph_pool),
           "loss": float(folded["loss"]), "step_wall_ms": wall * 1e3 / nb,
           "samples_per_s": nb * BATCH / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "note": "walls are information, not a claim"}
    log(row)
    if (not _finite(folded) or graphs != {"captures": 1, "replays": nb}
            or min(counts[k] for k in ("fused_interact_fwd",
                                       "fused_interact_bwd",
                                       "row_update")) < nb):
        raise AssertionError(f"fused dense path: launches {counts}, "
                             f"finite {_finite(folded)}")
    profile_steps(model, state, inputs, labels, "fused_dense", reps=3)
    del model, state
    _free()
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
    check_graphed_vs_eager(model, state, inputs, labels, "fused_dense_dot")
    state, _ = model.train_step(state, *step0)  # the eager step: warm
    torch.cuda.synchronize()
    nb = 4
    part = ({k: v[1:1 + nb] for k, v in inputs.items()}, labels[1:1 + nb])
    graphs0 = _graph_counts(model)
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, *part)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()  # ... and ends here
    graphs = {k: v - graphs0[k] for k, v in _graph_counts(model).items()}
    row = {"phase": "train", "config": "fused_dense_dot", "graph": "fused dot",
           "compute_dtype": "float32", "steps": nb, "launches": counts,
           "graphs": graphs, "loss": float(folded["loss"]),
           "step_wall_ms": wall * 1e3 / nb,
           "samples_per_s": nb * BATCH / wall,
           "note": "walls are information, not a claim"}
    log(row)
    if (not _finite(folded) or graphs != {"captures": 1, "replays": nb}
            or min(counts[k] for k in ("fused_interact_fwd",
                                       "fused_interact_bwd",
                                       "row_update")) < nb):
        raise AssertionError(f"fused dense dot path: launches {counts}, "
                             f"finite {_finite(folded)}")
    profile_steps(model, state, inputs, labels, "fused_dense_dot", reps=3)
    del model, state
    _free()
    return counts


# --------------------------------------------------------------- phase 9
def _bound(nbytes, flops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def time_row_update(table, sets: int = 64, extras: bool = True):
    """Kernel A at the training step's shape (n = 256 * 8 updates of
    d = 64 on the 8M-row table, f32 or bf16, with updates in the table's
    dtype, as the step's row grads are), uniform and zipf ids, from CUDA
    graphs:
    the prepare-and-sort kernel alone, the update kernel alone on its
    prepared keys and order, and the whole ``row_update_cuda`` call;
    beside them the plain versions (``prepare_row_update_ref`` from a
    graph; ``row_update_ref`` host-synchronising, so timed eagerly), the
    library calls (``torch.sort`` for the sort, ``index_add_``, the same
    sum in an atomic order, for the update), launches per call from
    torch.profiler, the bytes bound and the add chain's serial floor.
    ``extras``: also the sort by its passes and the update by run
    length."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    rows, n = table.shape[0], BATCH * TABLES
    esize = table.element_size()
    out = {}
    for kind in ("uniform", "zipf"):
        arg_sets = [(table, _row_ids(kind, n, rows, gen, rng),
                     torch.randn((n, DIM), generator=gen,
                                 device="cuda").to(table.dtype),
                     torch.tensor(-0.01, device="cuda"))
                    for _ in range(sets)]
        id_sets = [(i, rows) for _, i, _, _ in arg_sets]
        prepared = [(t,) + prepare_row_update_cuda(i, rows) + (u, s)
                    for t, i, u, s in arg_sets]
        uniq = sum(int(torch.unique(a[1]).numel()) for a in arg_sets) / sets
        longest = sum(_longest_run(a[1], rows) for a in arg_sets) / sets
        # the call: ids (8 B) and updates read, each touched row read and
        # written; the sort alone: ids read, keys and order written
        nbytes = 2 * uniq * DIM * esize + n * DIM * esize + n * 8
        bound_ms, bound_by = _bound(nbytes, 2 * n * DIM)
        prep_bytes = n * 8 + n * 8
        prep_bound_ms, prep_bound_by = _bound(prep_bytes, 0)
        row = {"phase": "timing", "kernel": "row_update", "ids": kind,
               "table_dtype": str(table.dtype).split(".")[-1],
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
    if not extras:
        return out
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


def _row_set_plan(table, rows, n):
    """The word and grid ``launch_row_set`` picks for ``n`` rows (``rows``
    as prepared, in the table's dtype) into ``table``."""
    return row_set_plan(n, table.shape[1] * table.element_size(),
                        table.data_ptr(), rows.data_ptr(),
                        torch.cuda.get_device_properties(
                            0).multi_processor_count)


def _row_set_case(gen, base, ids, vals, live, **tags):
    """One phase-10 case: the kernel against ``row_set_ref`` on clones of
    ``base``, bit for bit; sampled untouched rows must be unchanged and
    the live rows set.  Returns the logged case."""
    rows, d = base.shape
    n = ids.numel()
    got = base.clone()
    plan = n and _row_set_plan(got, prepare_row_set(base, ids, vals)[1], n)
    row_set_cuda(got, ids, vals)
    want = row_set_ref(base.clone(), ids, vals)
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    err = float((got.float() - want.float()).abs().max()) if n else 0.0
    sample = torch.randint(0, rows, (8192,), generator=gen, device="cuda")
    cold = sample[~torch.isin(sample, live)]
    untouched = torch.equal(got[cold], base[cold])
    hit = (ids >= 0) & (ids < rows)
    set_ok = torch.equal(got[ids[hit].long()], vals[hit].to(got.dtype))
    case = {"phase": "kernel_vs_plain", "kernel": "row_set", **tags,
            "n": n, "rows": rows, "d": d,
            "table_dtype": str(base.dtype).split(".")[-1],
            "word": plan and plan.word, "blocks": plan and plan.blocks,
            "live": int(hit.sum()),
            "dropped_negative": int((ids < 0).sum()),
            "dropped_past_end": int((ids >= rows).sum()),
            "untouched_sampled_rows": int(cold.numel()),
            "untouched_bit_identical": untouched,
            "live_rows_set": set_ok, "max_abs_err": err,
            "tolerance": "exact", "ok": bool(ok and untouched and set_ok)}
    log(case)
    return case


def _row_set_edges(gen, table):
    """The edges of the kernel's design (csrc/row_set.cu): partial and
    single tiles, rows of 64 B to 4,000 B (one to several warp passes a
    row), the 4- and 2-byte words (odd widths, rows that start 4 and 2
    bytes into their storage), a tile whose every slot is dropped, and a
    fully dense touch.  Yields (case name, base table, ids, rows, live)."""
    for n in (1, 31, 33, 131_072 - 5):
        ids, live = _set_ids(gen, n, table.shape[0])
        yield (f"n={n}", table, ids,
               torch.randn((n, DIM), generator=gen, device="cuda"), live)
    for d, rows, dtype in ((1000, 20_000, torch.float32),
                           (3, 100_000, torch.bfloat16),
                           (5, 100_000, torch.float32)):
        base = _rows_tensor(gen, rows, d).to(dtype)
        for n in (1, 31, 33, 4097):
            ids, live = _set_ids(gen, n, rows)
            yield (f"d={d}", base, ids,
                   torch.randn((n, d), generator=gen, device="cuda"), live)
    for dtype in (torch.float32, torch.bfloat16):
        # rows one element (4 or 2 bytes) into their storage, in the
        # table's dtype, so the wrapper passes them as they are
        base = table[:1_000_000].to(dtype)
        n = 4096
        ids, live = _set_ids(gen, n, base.shape[0])
        store = torch.randn((n * DIM + 1,), generator=gen,
                            device="cuda").to(dtype)
        yield (f"rows {base.element_size()} bytes in", base, ids,
               store[1:].view(n, DIM), live)
    # slots 32-63, the second warp tile, all dropped
    live = torch.randperm(table.shape[0], generator=gen, device="cuda")[:64]
    drop = torch.tensor([table.shape[0], -1, INT32_MIN, table.shape[0] + 5],
                        device="cuda").repeat(8)
    ids = torch.cat([live[:32], drop, live[32:]]).to(torch.int32)
    yield ("a tile all dropped", table, ids,
           torch.randn((96, DIM), generator=gen, device="cuda"), live)
    rows = 4096
    ids = torch.randperm(rows, generator=gen, device="cuda")
    yield ("dense touch", _rows_tensor(gen, rows, DIM), ids.to(torch.int32),
           torch.randn((rows, DIM), generator=gen, device="cuda"), ids)


def check_row_set(table) -> float:
    """The row-set kernel against ``row_set_ref`` on clones of ``table``
    (the headline's 8M x 64 flat table), of 1M-row tables of d = 16 and
    128 and of the headline table in bf16 (f32 rows cast to it, at the
    epilogue's and a ladder block's n among others), and on the design's
    edges (``_row_set_edges``), bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    others = {d: _rows_tensor(gen, ROWS, d) for d in (16, 128)}
    others["bf16"] = table.to(torch.bfloat16)
    # a ladder block's writeback: 16,384 rows into the 131,072-row cache
    others["bf16_block"] = _rows_tensor(gen, 64 * BATCH * TABLES,
                                        DIM).to(torch.bfloat16)
    ns = (0, 1, 7, 4096, 16_384, 131_072)
    cases = []
    for d, key, sizes in ((16, 16, ns), (DIM, None, ns), (128, 128, ns),
                          (DIM, "bf16", ns), (DIM, "bf16_block", (16_384,))):
        base = table if key is None else others[key]
        for n in sizes:
            ids, live = _set_ids(gen, n, base.shape[0])
            vals = torch.randn((n, d), generator=gen, device="cuda")
            cases.append(_row_set_case(gen, base, ids, vals, live))
    del others
    _free()
    for name, base, ids, vals, live in _row_set_edges(gen, table):
        cases.append(_row_set_case(gen, base, ids, vals, live, case=name))
    _free()
    failed = [c for c in cases if not c["ok"]]
    words = {c["word"] for c in cases if c.get("case")}
    if failed or not {16, 4, 2} <= words:
        raise AssertionError(f"{len(failed)} row_set case(s) disagree with "
                             f"the plain version; words {sorted(words)}")
    return max(c["max_abs_err"] for c in cases)


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
    one out of range (a NaN row); and a bf16 table of 1M x 128 (bags 1,
    3 and 8, the scalar d = 33 path and the edges), its output in bf16.
    Returns (max abs error, the d = 128 table)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    tables = {d: _rows_tensor(gen, ROWS, d) for d in (128, 256)}
    tables[33] = _rows_tensor(gen, 100_000, 33)
    tables["bf16", 128] = tables[128].to(torch.bfloat16)
    tables["bf16", 33] = tables[33].to(torch.bfloat16)
    cases = [(d, bag, torch.int64, False) for d in (128, 256)
             for bag in (1, 3, 8)]
    cases += [(d, bag, dt, True) for d in (128, 33) for bag in (1, 8, 40)
              for dt in (torch.int32, torch.int64)]
    cases += [(("bf16", 128), bag, torch.int64, False) for bag in (1, 3, 8)]
    cases += [(("bf16", d), bag, torch.int32, True) for d in (128, 33)
              for bag in (8, 40)]
    failed, worst = [], 0.0
    for key, bag, dtype, edges in cases:
        table = tables[key]
        d = table.shape[1]
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
                ok = (_same_bits(k, r) and k.shape == (bsz, d)
                      and k.dtype == table.dtype)
                live = ~torch.isnan(r)
                err = float((k[live].float() - r[live].float()).abs().max())
                worst = max(worst, err)
                case = {"phase": "kernel_vs_plain", "kernel": "embedding_bag",
                        "B": bsz, "bag": bag, "d": d, "rows": rows,
                        "table_dtype": str(table.dtype).split(".")[-1],
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
    graphs0 = _graph_counts(model)
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
           "launches": counts,
           "graphs": {k: v - graphs0[k]
                      for k, v in _graph_counts(model).items()},
           "fit_samples_per_s": thpt, "wall_s": wall,
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
    with _eager_steps(model):
        eager16, _, row_eager = _staged_fit(model, 16)
    with _eager_steps(off):
        eager_off16, _, _ = _staged_fit(off, 16)
    same_off = _states_equal(cached16, uncached16)
    same_plain = _states_equal(cached16, plain16)
    same_eager = (_states_equal(cached16, eager16)
                  and row16["last_epoch_metrics"]
                  == row_eager["last_epoch_metrics"])
    same_eager_off = _states_equal(uncached16, eager_off16)
    del cached16, uncached16, plain16, eager16, eager_off16
    log({"phase": "train_staged", "config": "headline, 16 batches", **row16,
         "uncached": row_off, "vs_uncached_bit_identical": same_off,
         "vs_row_set_ref_bit_identical": same_plain,
         "vs_eager_steps_bit_identical": same_eager,
         "uncached_vs_eager_steps_bit_identical": same_eager_off})
    log({"phase": "graph_vs_eager", "config": "staged fit, 16 batches",
         "cached": same_eager, "uncached": same_eager_off})
    if not (row16["staged"] and row16["cache"] and not row_off["cache"]
            and same_off and same_plain and same_eager and same_eager_off
            and row16["graphs"]["captures"] == 1
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
            and row["graphs"] == {"captures": 1, "replays": 2 * 64 - 1}
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
    _free()
    return row, counts


def profile_epoch(model, state, inputs, labels, config: str):
    """Where a staged epoch's time goes (information, not a check): one
    train_epoch without the profiler, then one under it, per step,
    graphed (the state and the caches' buffers are the ones
    ``train_epochs`` captured against, so the windows only replay) and
    then eager (``_eager_steps``)."""
    from torch.profiler import ProfilerActivity, profile
    nb = labels.shape[0]

    def window():
        nonlocal state
        t0 = time.perf_counter()
        state, _ = model.train_epoch(state, inputs, labels)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / nb

    for dispatch in ("graphed", "eager"):
        ctx = (_eager_steps(model) if dispatch == "eager"
               else contextlib.nullcontext())
        with ctx:
            plain_wall_us = window()
            counts0 = _graph_counts(model)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_us = window()
        _log_profile(prof, config, dispatch, nb, wall_us, plain_wall_us,
                     model, counts0)


# -------------------------------------------------------------- phase 13
BAG_ROWS, BAG_DIM, BAG = 1_000_000, 128, 8


def _bag_graph(table_dtype=torch.float32):
    """One 1M x 128 Embedding(use_pallas=True), bag 8, B = 256, its table
    in ``table_dtype``, concatenated with a dense input of width 128, then
    Linear 256-1, MSE, SGD lr 0.01 (FFModel.embedding never passes the
    flag, as in the JAX package, so the op is added directly)."""
    model = FFModel(FFConfig(batch_size=BATCH))
    ids = model.create_tensor((BATCH, BAG), "int64", name="ids")
    dense = model.create_tensor((BATCH, BAG_DIM), "float32", name="dense")
    emb = model._add(Embedding(model._name("embedding"), ids, BAG_ROWS,
                               BAG_DIM, "sum", use_pallas=True,
                               table_dtype=table_dtype))
    model.dense(model.concat([emb, dense], axis=1), 1, name="out")
    model.compile(optimizer=SGDOptimizer(lr=0.01),
                  loss_type="mean_squared_error",
                  metrics=("mean_squared_error",))
    return model, model.init(seed=0)


def train_bag_graph(table_dtype=torch.float32):
    """A few training steps of the use_pallas graph through train_epoch:
    the bag kernel forward and its backward's row update into a zero
    table, every step, on an f32 or a bf16 table.  Its forward is held
    against the plain forward and one step against the same step on the
    plain versions."""
    model, state = _bag_graph(table_dtype)
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
    check_graphed_vs_eager(model, state, inputs, labels,
                           f"use_pallas, {table_dtype}")
    rest = ({k: v[1:] for k, v in inputs.items()}, labels[1:])
    torch.cuda.synchronize()
    graphs0 = _graph_counts(model)
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, *rest)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()  # ... and ends here
    graphs = {k: v - graphs0[k] for k, v in _graph_counts(model).items()}
    dtype = str(table_dtype).split(".")[-1]
    row = {"phase": "train_bag",
           "config": f"Embedding(use_pallas=True), {dtype} table",
           "table_dtype": dtype, "use_pallas": op.use_pallas,
           "row_sparse_ops": [o.name for o in model._sparse_ops],
           "steps": nb, "launches": counts, "graphs": graphs,
           "loss": float(folded["loss"]),
           "forward_vs_plain_bit_identical": fwd_same,
           "step_vs_plain_bit_identical": step_same,
           "step_wall_ms": wall * 1e3 / nb,
           "note": "walls are information, not a claim"}
    log(row)
    if not (op.use_pallas and not model._sparse_ops and fwd_same
            and step_same and _finite(folded)
            and state.params[op.name]["embedding"].dtype == table_dtype
            and graphs == {"captures": 1, "replays": nb - 1}
            and counts["embedding_bag"] == nb
            and counts["row_update"] == nb):
        raise AssertionError(f"use_pallas graph: {row}")
    del model, state
    _free()
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
    ``index_copy_`` on the live ids (the library call), the launch
    floor, the launch's word and grid, and one launch a call (the
    wrapper's counter and the profiler must agree).  The bound counts
    this run's live rows: each read once from the rows and written once,
    plus the n int32 ids.  ``table`` is f32 or bf16; the rows are in its
    dtype, as the cache's are."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    esize = table.element_size()
    floor_ms = _launch_floor_ms(64)
    out = {}
    for shape, rowofs in _epoch_rowofs(sets, gen).items():
        parent = (table if shape == "epilogue"
                  else _rows_tensor(gen, 64 * BATCH * TABLES,
                                    DIM).to(table.dtype))
        arg_sets = [(parent, r, torch.randn((r.numel(), DIM), generator=gen,
                                            device="cuda").to(table.dtype))
                    for r in rowofs]
        prepared = [(t,) + prepare_row_set(t, i, v) for t, i, v in arg_sets]
        lib_sets = []
        for t, i, v in arg_sets:
            hit = i < t.shape[0]
            lib_sets.append((t, i[hit].long(), v[hit].contiguous()))
        n = rowofs[0].numel()
        live = sum(int(a[1].numel()) for a in lib_sets) / sets
        nbytes = 2 * live * DIM * esize + n * 4
        bound_ms, bound_by = _bound(nbytes, 0)
        row = {"phase": "timing", "kernel": "row_set", "shape": shape,
               "table_dtype": str(table.dtype).split(".")[-1],
               "n": n, "d": DIM, "rows": parent.shape[0],
               "live_rows": live, "bytes": nbytes, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "ms": graph_ms(launch_row_set, prepared),
               "wrapper_ms": graph_ms(row_set_cuda, arg_sets),
               "plain_ms": wall_ms(row_set_ref, arg_sets),
               "library_ms": graph_ms(
                   lambda t, i, v: t.index_copy_(0, i, v), lib_sets),
               "call_ms": wall_ms(row_set_cuda, arg_sets),
               "launch_floor_ms": floor_ms}
        row["share_of_bound"] = bound_ms / row["ms"]
        plan = _row_set_plan(prepared[0][0], prepared[0][2], n)
        row.update(word=plan.word, blocks=plan.blocks)
        # 16 calls on each set: the tracer's reading of one launch a call
        row["launches_per_call"], row["kernels_per_call"] = (
            launches_per_call(row_set_cuda, arg_sets * 16))
        log(row)
        check_one_launch("row_set_cuda", row_set_cuda, arg_sets * 16,
                         row_set_cuda, "row_set_kernel",
                         row["launches_per_call"], row["kernels_per_call"])
        out[shape] = row
        del arg_sets, prepared, lib_sets
    _free()
    return out


def time_embedding_bag(table, sets: int = 256):
    """The bag kernel at the JAX docstring's shape (1M x 128 f32, bag 8)
    at every serving bucket, its plain version and ``F.embedding_bag``
    (mode "sum", the library call), from CUDA graphs cycling many id
    sets, with int64 ids (8 bytes each in the bound) and int32 ids, on a
    table that fits the L2 (50k x 128), the launches per call, and the
    launch floor.  ``table`` is f32 or bf16 (then the output is bf16 and
    the library call runs on bf16).  Returns the B = 256 row."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    floor_ms = _launch_floor_ms(sets)
    l2_table = _rows_tensor(gen, L2_ROWS // 2, BAG_DIM).to(table.dtype)
    esize = table.element_size()
    rows = {}
    for bsz in BUCKETS:
        arg_sets = [(table, torch.randint(0, BAG_ROWS, (bsz, BAG),
                                          generator=gen, device="cuda"))
                    for _ in range(sets)]
        i32_sets = [(t, i.to(torch.int32)) for t, i in arg_sets]
        l2_sets = [(l2_table, i % (L2_ROWS // 2)) for _, i in arg_sets]
        nbytes = (esize * bsz * BAG * BAG_DIM + 8 * bsz * BAG
                  + esize * bsz * BAG_DIM)
        bound_ms, bound_by = _bound(nbytes, bsz * BAG * BAG_DIM)
        row = {"phase": "timing", "kernel": "embedding_bag", "B": bsz,
               "table_dtype": str(table.dtype).split(".")[-1],
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


# -------------------------------------------------------------- phase 15
#: the run_random.sh tables: 8 x 1M x 64 f32
TABLE_BYTES_F32 = TABLES * ROWS * DIM * 4


def train_bf16_tables(inputs, labels):
    """(vii) The bf16-table headline: the run_random.sh classic graph with
    ``embedding_dtype="bfloat16"`` (8 x 1M x 64 bf16 tables, 1,024,000,000
    B; cat, bf16 compute, SGD lr 0.01, MSE).  One step held against the
    same step on ``row_update_ref``; four graphed steps against four
    eager ones; then the main path: 64 batches through train_epoch, and
    the staged cached fit(epochs=2) over 64 batches held bit for bit
    against the same fit uncached.  Returns (row, the main path's
    launches)."""
    model, state = _train_model(False, "bfloat16", embedding_dtype="bfloat16")
    table = state.params["emb"]["embedding"]
    nbytes = table.numel() * table.element_size()
    if table.dtype != torch.bfloat16 or nbytes != TABLE_BYTES_F32 // 2:
        raise AssertionError(f"bf16 tables: {table.dtype}, {nbytes} B")
    step0 = ({k: v[0] for k, v in inputs.items()}, labels[0])
    same, err = _same_step(model, state, *step0, emb_module,
                           "row_update_cuda", row_update_ref)
    log({"phase": "train_vs_plain", "config": "bf16 tables",
         "plain": "row_update_ref", "bit_identical": same,
         "max_abs_err": err})
    if not same:
        raise AssertionError("bf16-table step through the row-update kernel "
                             "!= the same step on row_update_ref")
    check_graphed_vs_eager(model, state, inputs, labels, "bf16 tables")
    nb = labels.shape[0]
    graphs0 = _graph_counts(model)
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, inputs, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    epoch_counts = read_counts()  # ... and ends here
    epoch_graphs = {k: v - graphs0[k]
                    for k, v in _graph_counts(model).items()}
    kept = state.params["emb"]["embedding"].dtype == torch.bfloat16
    del state
    _free()
    off, _ = _train_model(False, "bfloat16", embedding_dtype="bfloat16",
                          epoch_row_cache="off")
    cached, fit_counts, fit_row = _staged_fit(model, nb)  # the main path
    uncached, _, off_row = _staged_fit(off, nb)
    same_cache = _states_equal(cached, uncached)
    kept = kept and cached.params["emb"]["embedding"].dtype == torch.bfloat16
    row = {"phase": "train_bf16", "config": "headline, bf16 tables",
           "table_bytes": nbytes, "f32_table_bytes": TABLE_BYTES_F32,
           "steps": nb, "launches": epoch_counts, "graphs": epoch_graphs,
           "loss": float(folded["loss"]),
           "step_wall_ms": wall * 1e3 / nb,
           "samples_per_s": nb * BATCH / wall,
           "staged_fit": fit_row, "staged_fit_uncached": off_row,
           "cached_vs_uncached_bit_identical": same_cache,
           "tables_stay_bf16": kept,
           "note": "walls and samples/s are information, not a claim"}
    log(row)
    if not (_finite(folded) and kept and same_cache
            and fit_row["staged"] and fit_row["cache"]
            and not off_row["cache"]
            and epoch_counts["row_update"] == nb
            and epoch_counts["row_update_prep"] == nb
            and epoch_graphs == {"captures": 1, "replays": nb - 1}
            and fit_counts["row_set"] == 17
            and fit_counts["row_update"] == 1 + 2 * nb):
        raise AssertionError(f"bf16-table training: {row}")
    del model, off, cached, uncached
    _free()
    return row, {k: epoch_counts[k] + fit_counts[k] for k in epoch_counts}


# -------------------------------------------------------------- phase 16
#: the quantized tables' bytes: int8 codes plus one f32 scale per row,
#: and bf16 rows
QUANT_BYTES = {"int8": TABLES * ROWS * DIM + TABLES * ROWS * 4,
               "bf16": TABLES * ROWS * DIM * 2}


def serve_quantized(model, state):
    """(viii) Quantized serving: the fused serving model's tables
    re-encoded at engine load, ``int8`` (512,000,000 B of codes and
    32,000,000 B of scales) and ``bf16`` (1,024,000,000 B), against the
    f32 engine (2,048,000,000 B), buckets 1, 8, 64 and 256, through the
    batcher on the same requests.  Held: every answer within the JAX
    package's pinned absolute tolerance of the f32 engine's (1e-2 for
    both); a padded request's bits equal the same rows of a full bucket;
    every bucket's graph equals the eager forward on the quantized
    params; the fused forward kernel, f32-only, never launches."""
    rng = np.random.default_rng(16)
    reqs = [_request(rng, n) for n in (1, 1, 1, 3, 8, 40, 64, 100, 256)]
    base = InferenceEngine(model, state)
    want = [base.predict(r) for r in reqs]
    del base
    out = {}
    for mode in ("int8", "bf16"):
        t0 = time.perf_counter()
        engine = InferenceEngine(model, state, quantize=mode)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        replays0 = engine.graph_replays
        reset_counts()  # the quantized engine's traffic starts here
        batcher = DynamicBatcher(engine)
        futs = [batcher.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
        batcher.close()
        counts = read_counts()  # ... and ends here
        replays = engine.graph_replays - replays0
        errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
        sane = all(g.shape == w.shape and np.isfinite(g).all()
                   and ((g > 0) & (g < 1)).all() for g, w in zip(got, want))
        full = _request(rng, 256)
        full_out = engine.predict(full)
        padding = {n: bool(np.array_equal(
            engine.predict({k: v[:n] for k, v in full.items()}),
            full_out[:n])) for n in (1, 3, 40, 200)}
        vs_eager = {}
        for b in engine.buckets:
            for n in sorted({b, max(1, b - 3)}):
                r = _request(rng, n)
                vs_eager[f"{b}/{n}"] = bool(np.array_equal(
                    engine.predict(r),
                    model.predict(engine._params, r).cpu().numpy()))
        atol = QUANT_ATOL[mode]
        rep = engine.quantization
        row = {"phase": "serve_quantized", "mode": mode,
               "bytes_before": rep["bytes_before"],
               "bytes_after": rep["bytes_after"], "tables": rep["tables"],
               "load_s": load_s, "requests": len(reqs),
               "rows": sum(r["dense"].shape[0] for r in reqs),
               "graph_replays": replays, "launches": counts,
               "max_abs_err_vs_f32_engine": max(errs), "tolerance": atol,
               "padding_bit_identical": padding,
               "graph_vs_eager_bit_identical": vs_eager}
        log(row)
        if not (sane and max(errs) <= atol and all(padding.values())
                and all(vs_eager.values()) and replays > 0
                and counts["fused_interact_fwd"] == 0
                and rep["bytes_before"] == TABLE_BYTES_F32
                and rep["bytes_after"] == QUANT_BYTES[mode]):
            raise AssertionError(f"quantized serving ({mode}): {row}")
        out[mode] = row
        del engine, batcher
        _free()
    return out


# -------------------------------------------------------------- phase 17
def _timed(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / reps


def telemetry_on_the_card(model, state):
    """The serving path (an engine and a batcher over 80 requests) and one
    staged fit (the classic headline graph, 16 batches, 2 epochs) inside
    an event log, with the /metrics endpoint up on 127.0.0.1.  Held:
    every event valid under the port's schema (equal to the JAX
    package's); one ``compile`` event per CUDA-graph capture made;
    /metrics holds the engine, batcher and train families.  Printed: the
    events by type, and a serving dispatch's and a training step's walls
    with telemetry on and off (information)."""
    srv = tele_exporter.MetricsServer(port=0).start()
    try:
        rng = np.random.default_rng(17)
        reqs = [_request(rng, n) for n in [1] * 64 + [3, 8, 40, 64, 256] * 3]
        with tele.event_log(ring=200_000) as events_log:
            engine = InferenceEngine(model, state)
            batcher = DynamicBatcher(engine)
            for f in [batcher.submit(r) for r in reqs]:
                f.result(timeout=120)
            batcher.close()
            tm, _ = _train_model(False, "bfloat16")
            _, _, fit_row = _staged_fit(tm, 16)
        events = events_log.events()
        invalid = [e for e in events if tele_schema.validate_event(e)]
        compiles = [e for e in events if e["type"] == "compile"]
        captures = len(engine._graphs) + tm.graph_captures
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=30) as r:
            body = r.read().decode()
        # a family's samples on /metrics: the engine's dispatches by
        # bucket, the batcher's requests and queue, the trainer's steps
        # and rate; each must be there with a value above 0 (the queue
        # depth at 0 or more)
        samples = {}
        for ln in body.splitlines():
            if ln and not ln.startswith("#"):
                name, value = ln.rsplit(" ", 1)
                samples[name] = float(value)
        found = {
            "engine": any(k.startswith("dlrm_serve_dispatches_total{bucket=")
                          and v > 0 for k, v in samples.items()),
            "batcher": samples.get("dlrm_serve_requests_total", 0) > 0,
            "queue": samples.get("dlrm_serve_queue_depth", -1) >= 0,
            "train": samples.get("dlrm_train_steps_total", 0) > 0,
            "train_rate": samples.get("dlrm_train_samples_per_s", 0) > 0}
        served = {k: v for k, v in samples.items()
                  if k.startswith(("dlrm_serve_requests_total",
                                   "dlrm_serve_dispatches_total",
                                   "dlrm_train_steps_total"))}
        # the walls with telemetry on and off: one-row dispatches, and
        # the per-batch fit's steps, in turns off, on, on, off
        one = reqs[0]
        loader = SyntheticDLRMLoader(16 * BATCH, BOT, [ROWS] * TABLES, 1,
                                     BATCH, seed=0)
        tm.config.fit_scan_max_bytes = 0   # the per-batch loop
        tstate, _ = tm.fit(tm.init(seed=0), loader, epochs=1, verbose=False)
        walls = {"dispatch_us": {"off": [], "on": []},
                 "step_us": {"off": [], "on": []}}
        for which in ("off", "on", "on", "off"):
            ctx = (tele.event_log(ring=200_000) if which == "on"
                   else contextlib.nullcontext())
            with ctx:
                walls["dispatch_us"][which].append(
                    _timed(lambda: engine.predict(one), 200))
                t0 = time.perf_counter()
                tstate, _ = tm.fit(tstate, loader, epochs=1, verbose=False,
                                   warmup=False)
                walls["step_us"][which].append(
                    (time.perf_counter() - t0) * 1e6 / 16)
        row = {"phase": "telemetry", "events": len(events),
               "by_type": dict(collections.Counter(e["type"]
                                                    for e in events)),
               "invalid": len(invalid), "compile_events": len(compiles),
               "graph_captures": captures,
               "compile_fns": sorted(e.get("fn", "") for e in compiles),
               "metrics_families": found, "metrics_samples": served,
               "fit_graphs": fit_row["graphs"],
               "walls_off_on": walls,
               "note": "walls are information, not a claim"}
        log(row)
        if invalid:
            raise AssertionError(f"invalid telemetry events: {invalid[:3]}")
        if len(compiles) != captures or not all(found.values()):
            raise AssertionError(f"telemetry on the card: {row}")
        del engine, batcher, tm, tstate
    finally:
        srv.stop()
    _free()
    return row


# -------------------------------------------------------------- phase 18
def time_bf16_kernels(table, bag_table):
    """B2, B5 and B1 on bf16 storage (information for PERF.md's kernel
    table): the row update on the (vii) table, 8M x 64 bf16, n = 2048
    uniform and zipf ids with bf16 updates; the row set at the epilogue
    and block shapes into bf16 tables; the bag on a 1M x 128 bf16 table,
    bag 8, at every serving bucket.  Each beside its bytes bound (2-byte
    elements), its plain version and its library call on bf16
    (``index_add_``, ``index_copy_``, ``F.embedding_bag``).  Returns the
    main-path rows: zipf, the epilogue and B = 256."""
    tb = table.to(torch.bfloat16)
    rows = time_row_update(tb, extras=False)
    sets = time_row_set(tb)
    bag = time_embedding_bag(bag_table.to(torch.bfloat16))
    del tb
    _free()
    return {"row_update": rows["zipf"], "row_set": sets["epilogue"],
            "row_set_block": sets["block"], "embedding_bag": bag}



# --------------------------------------------------------------- phase 19
def _durability_loader():
    """2 epochs x 8 batches: the first 8 batches of SyntheticDLRMLoader
    (seed 0) behind a shuffling ArrayDataLoader (seed 1)."""
    base = SyntheticDLRMLoader(8 * BATCH, BOT, [ROWS] * TABLES, 1, BATCH,
                               seed=0)
    return ArrayDataLoader(base.inputs, base.labels, BATCH, shuffle=True,
                           seed=1)


def _durability_run(name, root, faults=None, prefetch=0, resume=False,
                    save=True, sentinel=None, plain=False):
    """One run of phase 19 on a fresh headline model (seed 0): the plain
    per-batch fit, or fit with a CheckpointManager on ``root/name`` (saves
    every 8 steps), inside an event log.  Returns (final params, model,
    events, wall_s, raised); the model's tables are released."""
    model, state = _train_model(False, "bfloat16", prefetch_depth=prefetch)
    kw = {}
    if not plain:
        kw = {"checkpoint_manager": CheckpointManager(
                  os.path.join(root, name), keep_n=2, use_orbax=False)
              if save else None,
              "checkpoint_every_n_steps": 8 if save else None,
              "resume": resume, "sentinel": sentinel}
    if faults:
        faultinject.install(faults)
    raised = None
    t0 = time.perf_counter()
    with tele.event_log() as elog:
        try:
            state, _ = model.fit(state, _durability_loader(), epochs=2,
                                 verbose=False, warmup=False, **kw)
        except Preemption as e:
            raised = e
        finally:
            faultinject.clear()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = elog.events()
    params = None if raised else state.params
    del state
    return params, model, events, wall, raised


def _same_params(a, b) -> bool:
    return all(torch.equal(v, b[op][k]) for op, d in a.items()
               for k, v in d.items())


def _ckpt_events(events, root):
    """Each save's and restore's wall, bytes and rate, from the manager's
    ``checkpoint`` events (the committed directory's files, on disk)."""
    out = []
    for e in events:
        if e["type"] != "checkpoint" or e["action"] not in ("save",
                                                            "restore"):
            continue
        path = e["path"]
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        out.append({"action": e["action"], "step": e.get("step"),
                    "dir": os.path.relpath(path, root),
                    "wall_s": e["duration_s"], "bytes": nbytes,
                    "gb_per_s": nbytes / e["duration_s"] / 1e9})
    return out


def _step_walls(events) -> list:
    return [e["step_wall_ms"] for e in events
            if e["type"] == "phase_time" and e.get("phase") == "step"]


def _verify(root, name):
    d = os.path.join(root, name)
    errs = {c: verify_checkpoint(os.path.join(d, c))
            for c in sorted(os.listdir(d)) if c.startswith("ckpt-")}
    if not errs or any(errs.values()):
        raise AssertionError(f"verify_checkpoint on {d}: {errs}")
    return sorted(errs)


def _save_breakdown(state, root):
    """Where one save's and one restore's wall goes, by stage, on a copy
    of the manager's work for ``state``: the device-to-host copies, the
    npz write, the manifest's SHA-256, the fsync; then the npz read and
    the host-to-device copies (information)."""
    from dlrm_flexflow_tpu_torch import checkpoint as ckpt
    from dlrm_flexflow_tpu_torch.resilience import manager as mgr
    path = os.path.join(root, "breakdown.npz")
    t = [time.perf_counter()]
    host = {k: ckpt._host(v) for k, v in ckpt._flat_state(state).items()}
    t.append(time.perf_counter())
    np.savez(path, **host)
    t.append(time.perf_counter())
    mgr._sha256(path)
    t.append(time.perf_counter())
    mgr._fsync_file(path)
    t.append(time.perf_counter())
    del host
    with np.load(path) as data:
        arrs = {k: ckpt._tensor(data[k]) for k in data.files}
    t.append(time.perf_counter())
    on_card = {k: v.to(state.step.device) for k, v in arrs.items()}
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    del arrs, on_card
    os.remove(path)
    stages = ("d2h", "npz_write", "sha256", "fsync", "npz_read", "h2d")
    return {k: t[i + 1] - t[i] for i, k in enumerate(stages)}


def durability(root):
    """Phase 19: the run_random.sh headline (classic graph, bf16 compute,
    SGD lr 0.01, seed 0) through fit's resilient loop on the card.  (a)
    the plain per-batch fit; (b) checkpoints every 8 steps, killed at step
    10 (Preemption); (c) resumed from its directory; (d) an uninterrupted
    twin through the same loop; (e) (d) with prefetch_depth=2; (f)
    nan_grads@step=5 under NaNSentinel("skip").  (c) = (d) in trace and
    parameters, (d) = (a) and (e) = (d) in parameters, bit for bit;
    verify_checkpoint clean before and after each pair; at most two run
    directories on disk at once.  Returns (row, launch counts)."""
    free = shutil.disk_usage(root)
    log({"phase": "durability", "disk_free_bytes": free.free,
         "disk_total_bytes": free.total, "dir": root})
    reset_counts()  # the main path starts here (every run below)
    runs = {}
    a, model, ev_a, wall_a, _ = _durability_run("a", root, plain=True)
    runs["a"] = {"wall_s": wall_a, "last_fit_used_scan":
                 model._last_fit_used_scan}
    del model
    _free()
    _, model, ev_b, wall_b, raised = _durability_run(
        "b", root, faults="preempt@step=10")
    if not isinstance(raised, Preemption):
        raise AssertionError("(b) was not preempted at step 10")
    flight = os.listdir(os.path.join(root, "flight"))
    runs["b"] = {"wall_s": wall_b, "preempted": str(raised),
                 "flight_records": flight}
    if len(flight) != 1:
        raise AssertionError(f"(b) left flight records {flight}")
    del model
    _free()
    runs["b"]["verified"] = _verify(root, "b")
    c, model_c, ev_c, wall_c, _ = _durability_run("b", root, resume=True)
    runs["c"] = {"wall_s": wall_c,
                 "first_step": int(model_c._fit_loss_steps[0])}
    if runs["c"]["first_step"] != 9:
        raise AssertionError(f"(c) resumed at {runs['c']['first_step']}")
    runs["c"]["verified"] = _verify(root, "b")
    d, model_d, ev_d, wall_d, _ = _durability_run("d", root)
    runs["d"] = {"wall_s": wall_d, "verified": _verify(root, "d")}
    ref = dict(zip(model_d._fit_loss_steps.tolist(),
                   model_d._fit_loss_trace.tolist()))
    trace_same = all(ref[s_] == l_ for s_, l_ in
                     zip(model_c._fit_loss_steps.tolist(),
                         model_c._fit_loss_trace.tolist()))
    checks = {"c_trace_eq_d": trace_same,
              "c_params_eq_d": _same_params(c, d),
              "d_params_eq_a": _same_params(d, a)}
    ckpts = _ckpt_events(ev_b + ev_c + ev_d, root)
    shutil.rmtree(os.path.join(root, "b"))
    breakdown = _save_breakdown(model_d._fit_state, root)
    del a, c, model_c
    _free()
    e, model, ev_e, wall_e, _ = _durability_run("e", root, prefetch=2)
    runs["e"] = {"wall_s": wall_e, "verified": _verify(root, "e")}
    checks["e_params_eq_d"] = _same_params(e, d)
    checks["e_trace_eq_d"] = bool(np.array_equal(model._fit_loss_trace,
                                                 model_d._fit_loss_trace))
    ckpts += _ckpt_events(ev_e, root)
    shutil.rmtree(os.path.join(root, "d"))
    shutil.rmtree(os.path.join(root, "e"))
    del d, e, model
    _free()
    f, model, ev_f, wall_f, _ = _durability_run(
        "f", root, faults="nan_grads@step=5", save=False,
        sentinel=NaNSentinel(policy="skip"))
    anomalies = [x for x in ev_f if x["type"] == "anomaly"]
    runs["f"] = {"wall_s": wall_f, "adopted": len(model._fit_loss_trace),
                 "anomalies": [{k: x.get(k) for k in ("kind", "step",
                                                      "action")}
                               for x in anomalies],
                 "finite": bool(np.isfinite(model._fit_loss_trace).all())}
    checks["f_adopted_15"] = runs["f"]["adopted"] == 15
    checks["f_one_anomaly"] = (len(anomalies) == 1
                               and anomalies[0]["step"] == 5)
    checks["f_finite"] = runs["f"]["finite"]
    del f, model
    _free()
    counts = read_counts()  # ... and ends here
    walls = {"sentinel_off": _step_walls(ev_d), "sentinel_on":
             _step_walls(ev_f)}
    saves = [x for x in ckpts if x["action"] == "save"]
    row = {"phase": "durability", "runs": runs, "checks": checks,
           "saves": saves,
           "restores": [x for x in ckpts if x["action"] == "restore"],
           "bytes_written": sum(x["bytes"] for x in saves),
           "save_restore_stages_s": breakdown,
           "step_wall_ms_median": {k: float(np.median(v))
                                   for k, v in walls.items()},
           "step_wall_ms": walls, "launches": counts,
           "note": "walls are information, not a claim"}
    log(row)
    if not all(checks.values()):
        raise AssertionError(f"durability checks failed: {checks}")
    want = 16 + 10 + 8 + 16 + 16 + 17  # (a)-(f); (f) discards one step
    if counts["row_update"] != want or counts["row_update_prep"] != want:
        raise AssertionError(f"row update launched {counts}, want {want} "
                             f"(a 16, b 10, c 8, d 16, e 16, f 17)")
    return row, counts


def durability_phase():
    """Phase 19 in a directory of its own beside this script, removed
    afterwards (the checkpoints hold 2.06 GB each); the flight records
    that the killed run dumps land there too."""
    root = tempfile.mkdtemp(prefix=".durability-",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    old = os.environ.get("FF_FLIGHT_DIR")
    os.environ["FF_FLIGHT_DIR"] = os.path.join(root, "flight")
    try:
        return durability(root)
    finally:
        if old is None:
            del os.environ["FF_FLIGHT_DIR"]
        else:
            os.environ["FF_FLIGHT_DIR"] = old
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------- phase 20
@contextlib.contextmanager
def _costs(constants):
    """``kernel_costs``'s constants set to ``constants`` for the block."""
    old = {k: getattr(kernel_costs, k) for k in constants}
    for k, v in constants.items():
        setattr(kernel_costs, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(kernel_costs, k, v)


def measure_cost_constants(card: str):
    """Phase 20(a): each constant of ``ops/kernel_costs.py`` on this card,
    device times from CUDA graphs of many calls (``graph_ms``).  Returns
    {constant: value}."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    row_bytes = DIM * 4
    # the host link: one non_blocking H2D of a miss block of n rows of
    # 256 B from pinned memory; a least-squares line, ns against bytes
    link_ns = {}
    for n in (1, 2, 8, 32, 128, 512, 2048):
        src = torch.empty(n * row_bytes, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(n * row_bytes, dtype=torch.uint8, device="cuda")
        link_ns[n] = graph_ms(
            lambda d=dst, s=src: d.copy_(s, non_blocking=True),
            [()] * 16) * 1e6
    sizes = np.array([n * row_bytes for n in link_ns], dtype=np.float64)
    slope, intercept = np.polyfit(sizes, np.array(list(link_ns.values())), 1)
    # the StackedEmbedding gather at the serving buckets (uniform ids);
    # a least-squares line, ns against rows: the slope is the per-row
    # cost, the intercept the call's fixed cost
    tables = _rows_tensor(gen, TABLES * ROWS, DIM).view(TABLES, ROWS, DIM)
    gather_ns = {}
    for b in BUCKETS:
        op = emb_module.StackedEmbedding(
            "emb", Tensor((b, TABLES, 1), torch.int64), TABLES, ROWS, DIM)
        sets = [(torch.randint(0, ROWS, (b, TABLES, 1), generator=gen,
                               device="cuda"),) for _ in range(64)]
        gather_ns[b * TABLES] = graph_ms(
            lambda ids, o=op: o.forward({"embedding": tables}, [ids]),
            sets) * 1e6
    g_slope, g_intercept = np.polyfit(
        np.array(list(gather_ns), dtype=np.float64),
        np.array(list(gather_ns.values())), 1)
    # the row set installing a full top-bucket miss block into a hot tier
    hot = _rows_tensor(gen, TABLES * HOT_ROWS, DIM)
    n = BUCKETS[-1] * TABLES
    set_sets = []
    for _ in range(16):
        ids = torch.randperm(hot.shape[0], generator=gen, device="cuda")[:n]
        set_sets.append(prepare_row_set(hot, ids.to(torch.int32),
                                        _rows_tensor(gen, n, DIM)))
    set_ms = graph_ms(lambda i, r: launch_row_set(hot, i, r), set_sets)
    # the library call row_set_wins prices, index_copy_, and B5 on the
    # parent at the install's and the staged epilogue's row counts: each
    # a line through the two, ns against rows
    parent = tables.view(TABLES * ROWS, DIM)
    lib_ms, parent_set_ms = {}, {}
    for rows_n, reps in ((n, 16), (131_072, 8)):
        copy_sets = [(torch.randperm(TABLES * ROWS, generator=gen,
                                     device="cuda")[:rows_n],
                      _rows_tensor(gen, rows_n, DIM)) for _ in range(reps)]
        lib_ms[rows_n] = graph_ms(
            lambda i, r: parent.index_copy_(0, i, r), copy_sets)
        psets = [prepare_row_set(parent, i.to(torch.int32), r)
                 for i, r in copy_sets]
        parent_set_ms[rows_n] = graph_ms(
            lambda i, r: launch_row_set(parent, i, r), psets)
        del copy_sets, psets

    def line(ms):
        (n0, t0), (n1, t1) = sorted(ms.items())
        per_row = (t1 - t0) * 1e6 / (n1 - n0)
        return {"ns_per_row": per_row, "fixed_ns": t0 * 1e6 - per_row * n0}

    # an intermediate bounced between two ops: a 64 MiB copy_
    a = torch.empty(16 << 20, device="cuda")
    b_ = torch.empty_like(a)
    hbm_ms = graph_ms(lambda: a.copy_(b_), [()] * 4)
    measured = {
        "SET_KERNEL_NS_PER_ROW": set_ms * 1e6 / n,
        "EMITTER_SWEEP_GBPS": parent.numel() * 4 * 2.0 / (lib_ms[n] * 1e6),
        "GATHER_NS_PER_ROW": g_slope,
        "HBM_GBPS": a.numel() * 4 * 2.0 / (hbm_ms * 1e6),
        "OP_BOUNDARY_NS": _launch_floor_ms(256) * 1e6,
        "HOST_LINK_GBPS": 1.0 / slope,
        "HOST_LINK_LATENCY_NS": intercept,
    }
    measured = {k: float(v) for k, v in measured.items()}
    log({"phase": "cost_constants", "measured": measured,
         "committed": {k: getattr(kernel_costs, k) for k in measured},
         "host_link_ns_by_rows": link_ns,
         "gather_ns_by_rows": gather_ns, "gather_fixed_ns": g_intercept,
         "row_set_ms_2048_rows_hot_tier": set_ms,
         "into_8m_rows": {"index_copy_ms_by_rows": lib_ms,
                          "row_set_ms_by_rows": parent_set_ms,
                          "index_copy_line": line(lib_ms),
                          "row_set_line": line(parent_set_ms)},
         "card": card})
    del tables, hot, parent, set_sets, a, b_
    _free()
    return measured


def _gate_decisions(hit_rate):
    """Each gate's decision at the served shapes, and where it flips."""
    d = {"tiered": kernel_costs.tiered_storage_wins(
        num_rows=TABLES * ROWS, dim=DIM, itemsize=4,
        hot_rows=TABLES * HOT_ROWS, lookups=BUCKETS[-1] * TABLES,
        hit_rate=hit_rate)}
    hits = [h / 1000 for h in range(1001)]
    d["tiered_flips_at_hit"] = next(
        (h for h in hits if kernel_costs.tiered_storage_wins(
            num_rows=TABLES * ROWS, dim=DIM, itemsize=4,
            hot_rows=TABLES * HOT_ROWS, lookups=BUCKETS[-1] * TABLES,
            hit_rate=h)), None)
    parents = {"hot tier install": (TABLES * HOT_ROWS, BUCKETS[-1] * TABLES),
               "staged epilogue": (TABLES * ROWS, 131_072),
               "ladder block": (TABLES * ROWS, 16_384)}
    for k, (parent, n) in parents.items():
        # the JAX sweep model's answer (index_copy_ does not sweep the
        # parent: the cost_constants line holds both measured lines)
        d[f"row_set {k}"] = kernel_costs.row_set_wins(parent, DIM, n, 4)
    for interact in ("cat", "dot"):
        d[f"fused {interact}"] = {b: kernel_costs.fused_interact_wins(
            b, TABLES, 1, DIM, 4, interact) for b in BUCKETS}
        wins = [b for b in range(1, 4097)
                if kernel_costs.fused_interact_wins(b, TABLES, 1, DIM, 4,
                                                    interact)]
        d[f"fused {interact} wins_up_to_batch"] = max(wins) if wins else 0
    return d


def _zipf_pool(rng, count):
    """``count`` requests of 1-256 rows, ids zipf at alpha 1.05 over each
    1M-row table, as bench.py's tiered serving run draws them."""
    sizes = rng.integers(1, BUCKETS[-1] + 1, size=count)
    return [{"dense": rng.standard_normal((n, BOT)).astype(np.float32),
             "sparse": zipf_ids(rng, ROWS, (n, TABLES, 1), a=ZIPF_ALPHA)}
            for n in sizes]


def _tiered_engine(model, state, **kw):
    """An engine with the gate deciding; if the gate refuses, say so and
    build it again under FF_TIERED_STORAGE=on (the package's override)."""
    engine = InferenceEngine(model, state, storage="tiered", **kw)
    if engine.storage["mode"] == "tiered":
        return engine, None
    refused = engine.storage["fallbacks"]
    log({"phase": "tiered", "gate_refused": refused,
         "note": "building again under FF_TIERED_STORAGE=on"})
    del engine
    os.environ["FF_TIERED_STORAGE"] = "on"
    try:
        return InferenceEngine(model, state, storage="tiered", **kw), refused
    finally:
        del os.environ["FF_TIERED_STORAGE"]


def _clients(submit, pool, clients):
    """Every request of ``pool`` through ``submit`` from ``clients``
    closed-loop threads (request i from thread i % clients, each waiting
    for its answer before the next); returns {i: rows}."""
    answers, errors = {}, []

    def client(c):
        try:
            for i in range(c, len(pool), clients):
                answers[i] = submit(pool[i]).result(timeout=300)
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"client threads failed: {errors[:1]!r}")
    return answers


def _same_as(answers, want, what):
    bad = [i for i in want if not np.array_equal(answers.get(i), want[i])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(want)} results "
                             f"differ from the resident engine's "
                             f"(first {bad[:5]})")


def _pct(xs, p):
    return float(np.percentile(xs, p)) if len(xs) else None


def serve_tiered(model, state, pool, resident):
    """Phase 20(b)-(d).  Returns (row, B5 launches on the path)."""
    rowfreq.reset()
    for r in pool:  # the pool's traffic, observed before the build
        for t in range(TABLES):
            rowfreq.counter(f"sparse[{t}]").observe(r["sparse"][:, t])
    want = {i: resident.predict(r) for i, r in enumerate(pool)}
    # the resident engine's own QPS and p99 on the pool, for comparison
    with DynamicBatcher(resident) as batcher:
        t_start = time.perf_counter()
        _same_as(_clients(batcher.submit, pool, 8), want,
                 "resident through the batcher")
        base_wall = time.perf_counter() - t_start
    base = batcher.close()
    # (b)-(c): the gate decides, then the pool through the batcher
    t0 = time.perf_counter()
    engine, refused = _tiered_engine(model, state)
    build_s = time.perf_counter() - t0
    store = engine._tiered["sparse"][1]
    reset_counts()  # the main path starts here
    t_start = time.perf_counter()
    with DynamicBatcher(engine) as batcher:
        got = _clients(batcher.submit, pool, 8)
    wall_s = time.perf_counter() - t_start
    summary = batcher.close()
    graphed_sets = read_counts()["row_set"]
    dispatches = sum(engine.stats.dispatch_buckets.values())
    _same_as(got, want, "tiered, graphed, through the batcher")
    graphed_stats = engine.storage_stats()
    if not 0 < graphed_sets <= dispatches:
        raise AssertionError(f"{graphed_sets} row-set launches in "
                             f"{dispatches} dispatches")
    # the same pool, one dispatch at a time, on an eager tiered engine:
    # one install (one B5 launch) exactly on each dispatch with misses
    eager, _ = _tiered_engine(model, state, aot=False)
    estore = eager._tiered["sparse"][1]
    stalls, all_hit, bad, host_us = [], 0, [], []
    for i, r in enumerate(pool):
        sets0, miss0 = row_set_cuda.launches, estore.stats()["misses"]
        timings = {}
        t1 = time.perf_counter()
        out = eager.predict(r, timings=timings)
        # the dispatch's wall before its forward: the remap, the install's
        # enqueue and the padding (host)
        host_us.append((time.perf_counter() - t1) * 1e6
                       - timings["compute_us"])
        sets, misses = (row_set_cuda.launches - sets0,
                        estore.stats()["misses"] - miss0)
        if sets != (1 if misses else 0):
            bad.append((i, misses, sets))
        if misses:
            stalls.append(estore.stats()["stall_us_last"])
        else:
            all_hit += 1
        if not (np.array_equal(out, want[i]) and np.array_equal(out, got[i])):
            raise AssertionError(f"eager tiered request {i} differs from "
                                 "the resident or the graphed engine")
    # an all-hit dispatch: rows that are resident now
    hit_req = {"dense": pool[0]["dense"][:1].repeat(8, axis=0),
               "sparse": np.stack([estore.resident_ids(t)[:8]
                                   for t in range(TABLES)],
                                  axis=1)[..., None]}
    sets0, miss0 = row_set_cuda.launches, estore.stats()["misses"]
    if not np.array_equal(eager.predict(hit_req), resident.predict(hit_req)):
        raise AssertionError("the all-hit request differs from resident")
    if (row_set_cuda.launches - sets0, estore.stats()["misses"] - miss0) \
            != (0, 0):
        bad.append(("all-hit", row_set_cuda.launches - sets0))
    all_hit += 1
    eager_sets = read_counts()["row_set"] - graphed_sets
    if bad or not stalls:
        raise AssertionError(f"installs per dispatch {bad[:5]}; all-hit "
                             f"dispatches {all_hit}, with misses "
                             f"{len(stalls)}")
    row = {"phase": "tiered", "config": "run_random.sh, hot 4096",
           "storage": engine.storage, "gate_refused": refused,
           "build_s": build_s, "requests": summary["requests"],
           "rows": int(sum(len(r["dense"]) for r in pool)),
           "dispatches": dispatches, "row_set_launches": graphed_sets,
           "wall_s": wall_s, "qps": summary["qps"],
           "p50_us": summary.get("p50_us"), "p99_us": summary.get("p99_us"),
           "hit_pct": graphed_stats["hit_pct"],
           "misses": graphed_stats["misses"],
           "evictions": graphed_stats["evictions"],
           "stall_us_mean": graphed_stats["stall_us_total"]
           / max(1, graphed_sets),
           "resident": {"qps": base["qps"], "p50_us": base.get("p50_us"),
                        "p99_us": base.get("p99_us"), "wall_s": base_wall},
           "eager": {"dispatches": len(pool), "all_hit": all_hit,
                     "host_us_median": _pct(host_us, 50),
                     "host_us_p99": _pct(host_us, 99),
                     "row_set_launches": eager_sets,
                     "stall_us_median": _pct(stalls, 50),
                     "stall_us_p99": _pct(stalls, 99),
                     "hit_pct": estore.stats()["hit_pct"]},
           "bit_for_bit": {"graphed_vs_resident": True,
                           "eager_vs_resident": True,
                           "graphed_vs_eager": True},
           "note": "QPS, latencies and stalls are information"}
    log(row)
    del eager, estore
    _free()
    # (d): 512 hot rows a table, so the tier evicts, through 4 replicas
    model.config.storage_hot_rows = 512
    try:
        small, _ = _tiered_engine(model, state)
    finally:
        model.config.storage_hot_rows = HOT_ROWS
    sets0 = row_set_cuda.launches
    t_start = time.perf_counter()
    router = ReplicaRouter([small] * 4)
    got = _clients(router.submit, pool, 8)
    rsummary = router.close()
    rwall = time.perf_counter() - t_start
    _same_as(got, want, "tiered, hot 512, through a 4-replica router")
    sstats = small.storage_stats()
    if sstats["evictions"] <= 0:
        raise AssertionError("hot 512 evicted nothing")
    rrow = {"phase": "tiered", "config": "run_random.sh, hot 512, "
            "ReplicaRouter x4 over one engine",
            "requests": rsummary["requests"], "wall_s": rwall,
            "qps": rsummary["qps"], "p50_us": rsummary.get("p50_us"),
            "p99_us": rsummary.get("p99_us"),
            "router_shed": rsummary["router_shed"],
            "hit_pct": sstats["hit_pct"], "misses": sstats["misses"],
            "evictions": sstats["evictions"],
            "row_set_launches": row_set_cuda.launches - sets0,
            "stall_us_mean": sstats["stall_us_total"]
            / max(1, row_set_cuda.launches - sets0),
            "bit_for_bit_vs_resident": True}
    log(rrow)
    counts = read_counts()  # ... and ends here
    del small, router
    _free()
    return {"hot4096": row, "hot512_router": rrow}, counts, store


def check_tiered_scatter(rounds: int = 12, dtype=torch.float32):
    """Phase 20(e) (and 30 on a bf16 table): ``scatter_apply`` of a
    stacked store on the card (the row-update kernel, installs by the
    row-set kernel, writebacks of evicted dirty rows) against the same
    store on the CPU (the plain versions), bit for bit: each round's
    ``gather_rows`` and the final ``cold_full``.  On a bf16 table the
    rounds alternate bf16 grads (B2 on the bf16 hot tier) and f32 grads
    (B2 on an f32 copy of the touched rows, set back by B5).  Returns
    (max abs err, path launches)."""
    rng = np.random.default_rng(5)
    cold = torch.from_numpy(rng.standard_normal(
        (TABLES, 100_000, DIM)).astype(np.float32)).to(dtype)
    card = TieredEmbeddingTable("sparse", cold, 512)
    host = TieredEmbeddingTable("sparse", cold, 512, device="cpu")
    err = 0.0
    reset_counts()  # the main path starts here
    for r in range(rounds):
        ids = zipf_ids(rng, 100_000, (BUCKETS[-1], TABLES, 1), a=ZIPF_ALPHA)
        grads = torch.from_numpy(rng.standard_normal(
            ids.shape + (DIM,)).astype(np.float32))
        if dtype == torch.bfloat16 and r % 2:
            grads = grads.to(torch.bfloat16)
        card.scatter_apply(ids, grads, -0.01)
        host.scatter_apply(ids, grads, -0.01)
        a = card.gather_rows(ids).cpu()
        b = host.gather_rows(ids)
        err = max(err, float((a.float() - b.float()).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError("tiered scatter_apply: card != plain")
    counts = read_counts()  # ... and ends here (the CPU store counts none)
    cs, hs = card.stats(), host.stats()
    same = torch.equal(torch.as_tensor(card.cold_full()),
                       torch.as_tensor(host.cold_full()))
    log({"phase": "kernel_vs_plain", "kernel": "row_update",
         "config": "TieredEmbeddingTable.scatter_apply, (8, 100000, 64) "
                   f"{str(dtype).replace('torch.', '')}, hot 512",
         "rounds": rounds, "launches": counts,
         "evictions": cs["evictions"], "writebacks": cs["writebacks"],
         "stats_equal": {k: cs[k] == hs[k] for k in (
             "hits", "misses", "evictions", "writebacks", "dirty")},
         "cold_full_bit_for_bit": same, "max_abs_err": err})
    if not same or cs["writebacks"] <= 0 or not (
            counts["row_update"] == counts["row_update_prep"] == rounds):
        raise AssertionError(f"tiered scatter: cold equal {same}, "
                             f"launches {counts}, {cs['writebacks']} "
                             "writebacks")
    return err, counts


def router_fused():
    """Phase 20(f): a 4-replica ReplicaRouter over the resident fused
    serving engine (kernel B3): every result equals the engine's own
    answer.  Returns (row, path launches)."""
    model, state = build_model()
    engine = InferenceEngine(model, state)
    rng = np.random.default_rng(6)
    pool = [_request(rng, int(n)) for n in rng.integers(1, 17, size=256)]
    want = {i: engine.predict(r) for i, r in enumerate(pool)}
    reset_counts()  # the main path starts here
    router = ReplicaRouter([engine] * 4)
    got = _clients(router.submit, pool, 8)
    summary = router.close()
    counts = read_counts()  # ... and ends here
    launches = counts["fused_interact_fwd"]
    _same_as(got, want, "fused engine through a 4-replica router")
    row = {"phase": "router", "config": "fused resident engine x4",
           "requests": summary["requests"], "qps": summary["qps"],
           "p99_us": summary.get("p99_us"),
           "per_replica_requests": [s["requests"]
                                    for s in summary["per_replica"]],
           "fused_launches": launches, "bit_for_bit_vs_engine": True}
    log(row)
    if launches <= 0:
        raise AssertionError("the router's replicas launched no B3")
    del model, state, engine, router
    _free()
    return row, counts


def tiered_checkpoint(store):
    """Phase 20(g): save_tiered / load_tiered of phase (c)'s full-width
    store, in a directory beside this script (2 GB), removed after: the
    cold tier and the manifest back bit for bit, and a load under 512
    hot rows re-admits each table's hottest 512."""
    root = tempfile.mkdtemp(prefix=".tiered-",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.perf_counter()
        save_tiered(root, store)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_tiered(root)
        load_s = time.perf_counter() - t0
        manifest = store.hot_manifest()
        same = (np.array_equal(back.cold_full(), store.cold_full())
                and back.hot_manifest() == manifest)
        small = load_tiered(root, hot_rows=512)
        prefix = all(small.resident_ids(t) == sorted(i for i, _ in
                                                     manifest[t][:512])
                     for t in range(TABLES))
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for f in os.listdir(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = {"phase": "tiered_checkpoint", "bytes": nbytes, "save_s": save_s,
           "load_s": load_s, "round_trip_bit_for_bit": same,
           "hot512_prefix_readmitted": prefix}
    log(row)
    if not (same and prefix):
        raise AssertionError(f"tiered checkpoint: {row}")
    return row


def tiered_phase(card: str):
    """Phase 20 on the run_random.sh serving model without the fused
    interaction (the JAX package tiers Embedding, StackedEmbedding and
    RaggedStackedEmbedding only): (a) constants and gates, (b)-(d)
    tiered serving, (e) scatter_apply, (f) the router over B3, (g) the
    tiered checkpoint.  Returns (rows, path launches)."""
    measured = measure_cost_constants(card)
    model = build_dlrm(DLRMConfig(embedding_size=[ROWS] * TABLES),
                       FFConfig(batch_size=BUCKETS[-1],
                                compute_dtype="bfloat16",
                                serve_buckets=",".join(map(str, BUCKETS)),
                                storage_hot_rows=HOT_ROWS)).compile()
    state = model.init(seed=0)
    resident = InferenceEngine(model, state)
    pool = _zipf_pool(np.random.default_rng(20), 512)
    keys = [f"sparse[{t}]" for t in range(TABLES)]
    rows, counts, store = serve_tiered(model, state, pool, resident)
    hit, _ = predicted_hit_rate(keys, [ROWS] * TABLES, [HOT_ROWS] * TABLES)
    gates = {"committed": _gate_decisions(hit)}
    with _costs(measured):
        gates["measured"] = _gate_decisions(hit)
    log({"phase": "gates", "predicted_hit": hit, **gates})
    del resident, model, state
    _free()
    ckpt = tiered_checkpoint(store)
    del store
    _free()
    scatter_err, scatter_counts = check_tiered_scatter()
    router_row, router_counts = router_fused()
    counts = {k: counts[k] + scatter_counts[k] + router_counts[k]
              for k in counts}
    return {**rows, "router_fused": router_row, "checkpoint": ckpt,
            "constants": measured, "gates": gates,
            "scatter_err": scatter_err}, counts


# -------------------------------------------------------------- phase 21
#: phase 21's optimizers, on the row-lazy path
LAZY = {"adam": lambda: AdamOptimizer(lr=0.001, lazy_embeddings=True),
        "momentum": lambda: SGDOptimizer(lr=0.01, momentum=0.9,
                                         lazy_embeddings=True)}
#: the staged fit's three configurations: the epoch cache alone, with the
#: in-graph ladder "16,8", and no cache
LAZY_FITS = {"cached": {"epoch_row_cache": "on",
                        "epoch_cache_levels": "off"},
             "laddered": {"epoch_row_cache": "on",
                          "epoch_cache_levels": "16,8"},
             "uncached": {"epoch_row_cache": "off"}}


def _same_state(a, b) -> bool:
    """Step count, every parameter and every optimizer-state tensor, bit
    for bit."""
    return int(a.step) == int(b.step) and all(
        torch.equal(v, w)
        for (_, v), (_, w) in zip(_tensors(a), _tensors(b)))


def _replay_wall_ms(model, state, inputs, labels):
    """(state, ms a step, launches a step) of uncached ``train_epoch``
    replays: one epoch captures (its first step eager), the next one,
    timed to a synchronise, only replays; launches over both epochs."""
    reset_counts()
    state, _ = model.train_epoch(state, inputs, labels)
    torch.cuda.synchronize()
    graphs0 = _graph_counts(model)
    t0 = time.perf_counter()
    state, folded = model.train_epoch(state, inputs, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    nb = labels.shape[0]
    if (_graph_counts(model)["replays"] - graphs0["replays"] != nb
            or not _finite(folded)):
        raise AssertionError("the timed epoch did not replay every step, "
                             "or gave a non-finite metric")
    return state, wall * 1e3 / nb, counts


def lazy_step_checks(name, inputs, labels):
    """(a) for one lazy optimizer on the uncached path: one step through
    B2 against the same step on ``row_update_ref`` (parameters, moment
    or velocity tables, loss: bit for bit), 16 graphed steps against 16
    eager ones, and the graphed step's wall beside plain SGD's on the
    same model.  Returns (row, main-path launches)."""
    model, state = _train_model(False, "bfloat16", optimizer=LAZY[name](),
                                epoch_row_cache="off")
    slots = model._lazy_slots
    step0 = ({k: v[0] for k, v in inputs.items()}, labels[0])
    same, err = _same_step(model, state, *step0, model_module,
                           "row_update_cuda", row_update_ref)
    log({"phase": "lazy_vs_plain", "optimizer": name,
         "plain": "row_update_ref", "compared": ["params"] + list(slots),
         "bit_identical": same, "max_abs_err": err})
    if not same:
        raise AssertionError(f"lazy {name} step through B2 != the same "
                             f"step on row_update_ref")
    check_graphed_vs_eager(model, state, inputs, labels, f"lazy {name}",
                           k=16)
    slot_bytes = {sn: state.opt_state[sn]["emb"]["embedding"].nbytes
                  for sn in slots}
    state, wall_ms, counts = _replay_wall_ms(model, state, inputs, labels)
    steps = 2 * labels.shape[0]
    row = {"phase": "lazy_step", "optimizer": name,
           "graphed_step_wall_ms": wall_ms,
           "b2_calls_per_step": counts["row_update"] / steps,
           "launches": counts, "table_slot_bytes": slot_bytes,
           "all_slot_bytes": sum(t.nbytes for sn in slots
                                 for _, t in flatten(state.opt_state[sn])),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "note": "walls are information, not a claim"}
    log(row)
    if counts["row_update"] != (len(slots) + 2) * steps:
        raise AssertionError(f"lazy {name}: {counts} launches in {steps} "
                             f"steps")
    del model, state
    _free()
    return row, counts


def lazy_fits(name):
    """(b), (c): ``fit(epochs=2)`` over 64 staged batches under a lazy
    optimizer, cached, laddered and uncached, each against the first bit
    for bit (parameters and slot tables).  Returns (rows, launches)."""
    rows, total, first = {}, None, None
    for config, extra in LAZY_FITS.items():
        model, _ = _train_model(False, "bfloat16", optimizer=LAZY[name](),
                                **extra)
        slots = model._lazy_slots
        state, counts, row = _staged_fit(model, 64)
        steps = 1 + 2 * 64
        blocks = {"cached": 1, "laddered": 25, "uncached": 0}[config]
        row.update({"phase": "lazy_fit", "optimizer": name,
                    "config": config,
                    "b2_calls_per_step": counts["row_update"] / steps,
                    "b5_calls_per_fit": counts["row_set"]})
        if first is None:
            first = state
        else:
            row["bit_identical_to_cached"] = _same_state(state, first)
        log(row)
        rows[config] = row
        total = (counts if total is None else
                 {k: total[k] + counts[k] for k in total})
        if not (row["staged"] and row["cache"] == (config != "uncached")
                and row["graphs"]["captures"] == 1
                and row.get("bit_identical_to_cached", True)
                and counts["row_update"] == (len(slots) + 2) * steps
                and counts["row_set"] == blocks * (1 + len(slots))):
            raise AssertionError(f"lazy {name} fit, {config}: wrong path, "
                                 f"launches, or bits: {row}")
        del model, state
        _free()
    del first
    _free()
    return rows, total


def dense_adam():
    """(d): Adam without ``lazy_embeddings`` takes the dense table
    gradient: 4 steps at full width; finite metrics, and every row of the
    8M-row table rewritten (weight decay 1e-4: with none, a row that no
    step touched has zero moments and an Adam step of exactly 0)."""
    model, state = _train_model(
        False, "bfloat16", optimizer=AdamOptimizer(lr=0.001,
                                                   weight_decay=1e-4))
    before = state.params["emb"]["embedding"].clone()
    inputs, labels = _epoch_data(4)
    t0 = time.perf_counter()
    finite = True
    for i in range(4):
        state, mets = model.train_step(
            state, {k: v[i] for k, v in inputs.items()}, labels[i])
        finite = finite and _finite(mets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = float((state.params["emb"]["embedding"] != before)
                  .view(-1, DIM).any(dim=1).float().mean())
    row = {"phase": "dense_adam", "sparse_ops": len(model._sparse_ops),
           "finite": finite, "rows_moved": moved,
           "graphs": _graph_counts(model), "wall_ms_4_steps": wall * 1e3,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "note": "the wall holds the eager step and the capture"}
    log(row)
    if model._sparse_ops or not finite or moved != 1.0:
        raise AssertionError(f"dense Adam: {row}")
    del model, state, before
    _free()
    return row


class _EpochRates(Callback):
    """The rate in the state at each epoch's end."""

    def __init__(self):
        super().__init__()
        self.rates = []

    def on_epoch_end(self, epoch, logs=None):
        self.rates.append(float(self.model._fit_state.opt_state["lr"]))


def scheduled_fit():
    """(e): lazy Adam through a 3-epoch per-batch ``fit`` (4 batches an
    epoch) under ``LearningRateScheduler``: the state's rate at each epoch
    is the schedule's, and the graphed run equals the same run on eager
    steps bit for bit (a replay reads the rate by address).  Returns
    (row, launches)."""
    schedule = [1e-3, 5e-4, 2.5e-4]
    model, _ = _train_model(False, "bfloat16", optimizer=LAZY["adam"]())
    runs = {}
    for dispatch in ("graphed", "eager"):
        rec = _EpochRates()
        loader = SyntheticDLRMLoader(4 * BATCH, BOT, [ROWS] * TABLES, 1,
                                     BATCH, seed=0)
        state = model.init(seed=0)
        ctx = (_eager_steps(model) if dispatch == "eager"
               else contextlib.nullcontext())
        torch.cuda.synchronize()
        reset_counts()
        with ctx:
            state, thpt = model.fit(state, loader, epochs=3, verbose=False,
                                    callbacks=[LearningRateScheduler(
                                        lambda e: schedule[e]), rec])
        torch.cuda.synchronize()
        runs[dispatch] = (state, rec.rates, read_counts(), thpt,
                          model._last_fit_used_scan)
    (gs, grates, counts, thpt, scan), (es, erates, _, _, _) = \
        runs["graphed"], runs["eager"]
    want = [float(np.float32(r)) for r in schedule]
    row = {"phase": "scheduled_fit", "rates": grates, "eager_rates": erates,
           "schedule": want, "per_batch": not scan,
           "graphed_vs_eager_bit_identical": _same_state(gs, es),
           "launches": counts, "fit_samples_per_s": thpt}
    log(row)
    if (grates != want or erates != want or scan
            or not row["graphed_vs_eager_bit_identical"]
            or counts["row_update"] != 4 * 13):
        raise AssertionError(f"scheduled fit: {row}")
    del model, runs, gs, es
    _free()
    return row, counts


def lazy_phase(inputs, labels, headline_ms):
    """Phase 21, lazy optimizers: (a) per optimizer, (b) and (c) the
    staged fits, (d) dense Adam, (e) the scheduled fit; the graphed step
    walls beside plain SGD's on the same uncached path.  Returns (row,
    main-path launches)."""
    model, state = _train_model(False, "bfloat16", epoch_row_cache="off")
    _, sgd_ms, sgd_counts = _replay_wall_ms(model, state, inputs, labels)
    del model, state
    _free()
    steps, fits, counts = {}, {}, sgd_counts
    for name in LAZY:
        steps[name], c = lazy_step_checks(name, inputs, labels)
        counts = {k: counts[k] + c[k] for k in counts}
        fits[name], c = lazy_fits(name)
        counts = {k: counts[k] + c[k] for k in counts}
    dense = dense_adam()
    sched, c = scheduled_fit()
    counts = {k: counts[k] + c[k] for k in counts}
    row = {"phase": "lazy_optimizers",
           "graphed_step_wall_ms": {
               "sgd": sgd_ms,
               **{n: r["graphed_step_wall_ms"] for n, r in steps.items()}},
           "headline_step_wall_ms_phase_8": headline_ms,
           "b2_calls_per_step": {n: r["b2_calls_per_step"]
                                 for n, r in steps.items()},
           "b5_calls_per_fit": {n: {c: r["b5_calls_per_fit"]
                                    for c, r in f.items()}
                                for n, f in fits.items()},
           "staged_fit_samples_per_s": {
               n: {c: r["fit_samples_per_s"] for c, r in f.items()}
               for n, f in fits.items()},
           "table_slot_bytes": {n: r["table_slot_bytes"]
                                for n, r in steps.items()},
           "dense_adam_rows_moved": dense["rows_moved"],
           "scheduled_rates": sched["rates"], "launches": counts,
           "note": "walls are information, not a claim"}
    log(row)
    return row, counts


# -------------------------------------------------------------- phase 22
#: phase 22's searches: simulated devices, MCMC budget and seed
SOAP_DEVICES = (4, 8)
SOAP_BUDGET = 500
#: the cost model's loud fallbacks, made errors inside phase 22
SOAP_FALLBACKS = "(measured cost for|cost-model measurement budget)"


def _soap_costs(graph, model, cm):
    """Each op's measured (forward, backward) at one part beside the
    analytic H100 estimate; one line per op.  Returns the rows."""
    analytic = CostModel(machine=H100MachineModel())
    rows = []
    for op in model.layers:
        f, b = cm.op_times(op, 1)
        af, ab = analytic.op_times(op, 1)
        row = {"phase": "soap_op", "graph": graph, "op": op.name,
               "type": type(op).__name__, "fwd_us": f * 1e6,
               "bwd_us": b * 1e6, "fwd_analytic_us": af * 1e6,
               "bwd_analytic_us": ab * 1e6, "fwd_measured_over_analytic":
               f / af, "bwd_measured_over_analytic": b / ab}
        log(row)
        if not (np.isfinite([f, b]).all() and f > 0 and b > 0):
            raise AssertionError(f"op cost not finite and positive: {row}")
        rows.append(row)
    return rows


def _soap_searches(graph, model, cm):
    """mcmc_search at 4 and 8 simulated devices on the measured costs,
    both backends; each best no slower than data-parallel (both priced
    by the Python simulator).  Returns ({(n, backend): best}, rows)."""
    best, rows = {}, []
    for n in SOAP_DEVICES:
        sim = Simulator(model, n, cost_model=cm)
        dp_s = sim.simulate(data_parallel_strategy(model, n))
        for backend in ("python", "native"):
            t0 = time.perf_counter()
            s = mcmc_search(model, n, budget=SOAP_BUDGET, seed=0,
                            simulator=sim, backend=backend)
            wall = time.perf_counter() - t0
            best_s = sim.simulate(s)
            row = {"phase": "soap_search", "graph": graph, "devices": n,
                   "backend": backend, "budget": SOAP_BUDGET, "seed": 0,
                   "search_wall_s": wall, "best_ms": best_s * 1e3,
                   "chain_best_ms": s.best_simulated_time * 1e3,
                   "data_parallel_ms": dp_s * 1e3,
                   "speedup_over_data_parallel": dp_s / best_s}
            log(row)
            if not best_s <= dp_s:
                raise AssertionError(f"search slower than data-parallel: "
                                     f"{row}")
            best[n, backend] = s
            rows.append(row)
    return best, rows


def _configs(strategy):
    return {k: (tuple(v.dims), v.device_type, v.device_ids)
            for k, v in strategy.configs.items()}


def _strategied_steps(fused, strategy, inputs, labels, steps=8):
    """``steps`` donated (graphed) steps of the headline model compiled
    with ``strategy`` and without one (the first eager, then one capture
    and replays): (bit for bit, the wall of steps 3 to ``steps`` in ms a
    step each way, the graph counts with the strategy)."""
    walls, states, graphs = {}, {}, None
    for name, s in (("strategy", strategy), ("none", None)):
        model, state = _train_model(fused, "bfloat16", strategy=s,
                                    epoch_row_cache="off")
        if s is not None and not all(op.parallel_config is s[op.name]
                                     for op in model.layers):
            raise AssertionError("compile(strategy=) did not set the ops' "
                                 "configs")
        graphs0 = _graph_counts(model)
        for i in range(steps):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, _ = model.train_step(
                state, {k: v[i] for k, v in inputs.items()}, labels[i])
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3 / (steps - 2)
        if s is not None:
            graphs = {k: v - graphs0[k]
                      for k, v in _graph_counts(model).items()}
        states[name] = state
        del model
    same = _same_state(states["strategy"], states["none"])
    del states
    _free()
    return same, walls, graphs


def soap_phase(inputs, labels, headline_ms):
    """Phase 22, the SOAP core on the card.  Returns (row, launches)."""
    reset_counts()
    rows = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=SOAP_FALLBACKS,
                                category=RuntimeWarning)
        for graph, fused in (("classic", False), ("fused", True)):
            cfg = DLRMConfig(embedding_size=[ROWS] * TABLES,
                             fused_interaction="on" if fused else "off",
                             mlp_top=[interact_width("cat", TABLES, DIM,
                                                     BOT), 1024, 1024,
                                      1024, 1])
            model = build_dlrm(cfg, FFConfig(batch_size=BATCH,
                                             compute_dtype="bfloat16"))
            cm = CostModel(machine=H100MachineModel(), measure=True)
            ops = _soap_costs(graph, model, cm)
            sim1 = Simulator(model, 1, cost_model=cm)
            dp1 = data_parallel_strategy(model, 1)
            sim_ms = sim1.simulate(dp1) * 1e3
            best, searches = _soap_searches(graph, model, cm)
            torch.cuda.synchronize()
            measured = {"measure_wall_s": cm._measure_spent,
                        "keys_measured": len(cm._cache)}
            # the strategy round trip: .json and .pb load back equal
            strategy = best[8, "python"]
            loaded = {}
            with tempfile.TemporaryDirectory(
                    prefix=".soap-",
                    dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
                for ext in (".json", ".pb"):
                    path = os.path.join(tmp, f"best{ext}")
                    strategy.save(path)
                    loaded[ext] = Strategy.load(path)
            round_trip = (_configs(loaded[".json"]) == _configs(
                loaded[".pb"]) == _configs(strategy))
            same, walls, graphs = _strategied_steps(
                fused, loaded[".pb"], inputs, labels)
            step_ms = headline_ms if graph == "classic" else walls["none"]
            scale = sim1.calibrate(dp1, step_ms / 1e3)
            row = {"phase": "soap", "graph": graph, "ops": len(ops),
                   "simulated_step_ms": sim_ms,
                   "measured_step_ms": step_ms,
                   "measured_step_from": ("phase 8 (i), train_epoch"
                                          if graph == "classic" else
                                          "phase 22, train_step replays"),
                   "simulated_over_measured": sim_ms / step_ms,
                   "calibrate_scale": scale,
                   "replayed_step_ms_phase_22": walls,
                   "strategy_round_trip_equal": round_trip,
                   "strategy_ops": len(strategy.configs),
                   "strategied_8_steps_bit_identical": same,
                   "strategied_graphs": graphs,
                   "search_wall_s": {f"{r['devices']}/{r['backend']}":
                                     r["search_wall_s"] for r in searches},
                   **measured}
            log(row)
            if not (np.isfinite([sim_ms, scale]).all() and sim_ms > 0
                    and scale > 0 and round_trip and same
                    and graphs["captures"] == 1
                    and graphs["replays"] in (6, 7)):
                raise AssertionError(f"SOAP phase, {graph} graph: {row}")
            rows[graph] = row
            del model, cm, best
            _free()
    counts = read_counts()
    log({"phase": "soap_launches", "launches": counts})
    if counts["row_update"] == 0 or counts["fused_interact_fwd"] == 0:
        raise AssertionError(f"phase 22 launched B2 or B3 no time: {counts}")
    return rows, counts


# -------------------------------------------------------------- phase 23
#: phase 23's closed loop: simulated devices, MCMC budget and seed
TUNE_DEVICES = 4
TUNE_BUDGET = 300
#: the SLO monitor's windows on its fake clock (one tick a second)
SLO_WINDOWS = {"fast_window_s": 2.0, "slow_window_s": 10.0}
#: one-row requests a tick of the SLO stretches submits
SLO_TICK_REQUESTS = 32
#: the report sections phase 23's sinks must produce
REPORT_SECTIONS = ("per_op", "calibration", "tuning", "serving", "slo")


class _DelayedEngine(InferenceEngine):
    """The serving engine with a fixed host delay before each dispatch
    while ``delay_s`` is above 0 (the JAX package's
    ``scripts/check_serving.py::_SlowEngine``, switchable)."""

    delay_s = 0.0

    def predict(self, inputs, queue_wait_us=0.0, timings=None):
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        return super().predict(inputs, queue_wait_us, timings)


class _FakeClock:
    """The SLO monitor's injectable clock, advanced by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _op_timer(model, state, sink):
    """(a) ``OpTimer(model, iters=10).profile`` inside an event log at
    ``sink``: one valid op_time event per op with all four times, and
    the B3, B4 and B2 counters moved.  Returns the launch counts."""
    reset_counts()
    with tele.event_log(path=sink, mode="w"):
        times = OpTimer(model, iters=10).profile(state, None)
    torch.cuda.synchronize()
    counts = read_counts()
    events = tele_report.load_events(sink, strict=True)
    by_op = collections.Counter(e["op"] for e in events)
    keys = ("forward_s", "backward_s", "sim_forward_s", "sim_backward_s")
    for e in events:
        log({"phase": "tune_op_time", "op": e["op"],
             **{k: e.get(k) for k in keys},
             "fwd_measured_over_analytic":
                 e["forward_s"] / e["sim_forward_s"],
             "bwd_measured_over_analytic":
                 e["backward_s"] / e["sim_backward_s"]})
    ok = (len(events) == len(model.layers)
          and sorted(by_op) == sorted(op.name for op in model.layers)
          and set(by_op.values()) == {1} and set(times) == set(by_op)
          and all(e["type"] == "op_time" and all(
              np.isfinite(e.get(k, np.nan)) and e[k] > 0 for k in keys)
              for e in events)
          and counts["fused_interact_fwd"] > 0
          and counts["fused_interact_bwd"] > 0
          and counts["row_update"] > 0)
    log({"phase": "tune_op_timer", "events": len(events),
         "ops": len(model.layers), "launches": counts, "ok": ok})
    if not ok:
        raise AssertionError(f"OpTimer on the card: {counts}, {by_op}")
    return counts


def _tune_runs(model, op_sink, tune_sink, art):
    """(b) ``search_tune`` twice under the calibrated simulator's bench:
    ``first`` at v1, then ``promoted`` at v2 with parent 1, the
    calibration's error strictly lower after the fit, every artifact
    valid, the incumbent loading through ``Strategy.load`` and
    ``dlrm_strategy_version`` at 2.  Returns (results, calibration)."""
    with tele.event_log(path=tune_sink, mode="a"):
        runs = [tune.search_tune(model, TUNE_DEVICES, op_sink, art,
                                 budget=TUNE_BUDGET, seed=0)
                for _ in range(2)]
    for r in runs:
        log({"phase": "search_tune", **r})
    cal = tune.Calibration.load(runs[-1]["calibration_path"])
    strategies = tune.list_artifacts(art, "strategy")
    calibrations = tune.list_artifacts(art, "calibration")
    valid = all(tune.load_strategy_artifact(p) for _, p in strategies)
    valid = valid and all(tune.Calibration.load(p).ops == cal.ops
                          for _, p in calibrations)
    pointer = tune.incumbent_path(art, "dlrm", TUNE_DEVICES)
    loaded = Strategy.load(pointer)
    version = tele_metrics.STRATEGY_VERSION.value
    r1, r2 = runs
    ok = ((r1["verdict"], r1["version"], r1["parent_version"])
          == ("first", 1, None)
          and (r2["verdict"], r2["version"], r2["parent_version"])
          == ("promoted", 2, 1)
          and all(r["mae_pct_after"] < r["mae_pct_before"] for r in runs)
          and valid and [v for v, _ in strategies] == [1, 2]
          and len(loaded.configs) == len(model.layers) and version == 2)
    log({"phase": "tune_artifacts", "strategies": len(strategies),
         "calibrations": len(calibrations), "incumbent": pointer,
         "incumbent_ops": len(loaded.configs),
         "dlrm_strategy_version": version, "ok": ok})
    if not ok:
        raise AssertionError(f"search_tune: {runs}")
    return runs, cal


def _calibrated_searches(model, cal, art):
    """The calibration's effect (information): each class's scales, the
    calibrated best at 4 simulated devices against data-parallel, and
    the analytic search's best at the same budget and seed beside it."""
    log({"phase": "tune_calibration", "scales": {
        k: {"forward": f, "backward": b} for k, (f, b) in
        sorted(cal.scales.items())},
        "mae_pct_before": cal.mae_pct_before,
        "mae_pct_after": cal.mae_pct_after, "ops": cal.ops})
    inc = tune.load_incumbent(art, "dlrm", TUNE_DEVICES)
    best = tune.strategy_from_artifact(inc)
    dp = data_parallel_strategy(model, TUNE_DEVICES)
    calibrated = Simulator(model, TUNE_DEVICES,
                           cost_model=CostModel(calibration=cal))
    analytic = Simulator(model, TUNE_DEVICES, cost_model=CostModel())
    analytic_best = mcmc_search(model, TUNE_DEVICES, budget=TUNE_BUDGET,
                                seed=0, simulator=analytic,
                                backend="python")
    log({"phase": "tune_searches", "devices": TUNE_DEVICES,
         "calibrated_best_ms": calibrated.simulate(best) * 1e3,
         "calibrated_data_parallel_ms": calibrated.simulate(dp) * 1e3,
         "analytic_best_ms": analytic.simulate(analytic_best) * 1e3,
         "analytic_data_parallel_ms": analytic.simulate(dp) * 1e3,
         "calibrated_best_under_analytic_ms":
             analytic.simulate(best) * 1e3,
         "ops_differing_from_analytic_best": sorted(
             k for k in best.configs
             if _configs(best)[k] != _configs(analytic_best)[k]),
         "note": "information, not a claim"})


def _real_gate(op_sink, tune_sink, art, model, cal):
    """(c) ``tools/search_tune.py --bench real`` on (b)'s artifacts: the
    candidate's and the incumbent's graphed steps on the card (the fused
    graph's row-sparse step: its forward gathers the touched rows, so B2
    runs and B3 does not).  The gate must return; its verdict is
    information.  Returns (result, counts)."""
    args = tune_tool.parse_args([
        "--telemetry", op_sink, "--artifacts", art,
        "--devices", str(TUNE_DEVICES), "--budget", str(TUNE_BUDGET),
        "--seed", "0", "--bench", "real", "--batch", str(BATCH),
        "--fused-interaction", "on", "--sink", tune_sink])
    reset_counts()
    r = tune_tool.run(args)
    torch.cuda.synchronize()
    counts = read_counts()
    dp1 = data_parallel_strategy(model, 1)
    measured_s = min(r["candidate_s"], r["incumbent_s"])
    sims = {name: Simulator(model, 1, cost_model=cm).simulate(dp1)
            for name, cm in (("analytic", CostModel()),
                             ("calibrated", CostModel(calibration=cal)))}
    row = {"phase": "tune_real_gate", **r,
           "candidate_step_ms": r["candidate_s"] * 1e3,
           "incumbent_step_ms": r["incumbent_s"] * 1e3,
           "one_card_simulated_over_measured": {
               k: v / measured_s for k, v in sims.items()},
           "launches": counts,
           "note": "strategies execute alike on one card: the verdict "
                   "is information"}
    log(row)
    if not (r["verdict"] in ("promoted", "rejected")
            and all(np.isfinite([r["candidate_s"], r["incumbent_s"]]))
            and r["candidate_s"] > 0 and r["incumbent_s"] > 0
            and counts["row_update"] > 0):
        raise AssertionError(f"the real gate: {row}")
    return r, counts


def _healthz(port) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
        return json.loads(r.read().decode())


def _slo_serving(model, state, serve_p99_us, flight_dir, slo_sink, art):
    """(d) The fused engine through the batcher under an SLOMonitor on a
    fake clock, with /metrics up on 127.0.0.1: a healthy stretch with no
    breach and /healthz ok; a delayed stretch with one breach of the
    latency SLO, /healthz degraded and exactly one flight record in
    ``flight_dir``; healthy ticks until one recover, /healthz ok again;
    the burn and budget gauges scraped with one row per SLO; the
    freshness SLO reading the incumbent strategy's age.  Returns (the
    row, the launch counts, the dispatches' p99 in ms)."""
    edges = tele_metrics.LATENCY_BUCKETS_US
    # the latency objective: the histogram edge at or above 10x phase
    # 4's p99 (the probe counts a request bad only past an edge), and a
    # delay that puts every delayed request past that edge
    edge_us = next((e for e in edges if e >= 10 * serve_p99_us),
                   edges[-1])
    spec = (f"p99_ms={edge_us / 1e3:g},availability=99.9,freshness=600")
    clock = _FakeClock()
    slos = tele_slo.parse_slos(spec, **SLO_WINDOWS)
    engine = _DelayedEngine(model, state, buckets=list(BUCKETS))
    rng = np.random.default_rng(23)
    pool = [_request(rng, 1) for _ in range(64)]
    srv = tele_exporter.MetricsServer(port=0).start()
    monitor = tele_slo.SLOMonitor(slos, clock=clock, flight_dir=flight_dir)
    batcher = DynamicBatcher(engine)
    phases, health = [], {}

    def tick(tag):
        futures = [batcher.submit(pool[i % len(pool)])
                   for i in range(SLO_TICK_REQUESTS)]
        for f in futures:
            f.result(timeout=120)
        clock.t += 1.0
        evs = monitor.tick()
        phases.extend((tag, e["phase"], e["slo"]) for e in evs
                      if e["phase"] != "eval")
        return evs

    try:
        reset_counts()
        with tele.event_log(path=slo_sink, mode="w"):
            monitor.tick()  # the baseline sample
            for _ in range(5):
                tick("healthy")
            health["healthy"] = _healthz(srv.port)
            engine.delay_s = 1.5 * edge_us / 1e6
            tick("delayed")
            engine.delay_s = 0.0
            health["breached"] = _healthz(srv.port)
            scrape = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=30
            ).read().decode()
            for _ in range(40):
                tick("after")
                if any(p == "recover" for _, p, _ in phases):
                    break
            for _ in range(2):
                tick("after")
            health["recovered"] = _healthz(srv.port)
            summary = batcher.close()
            batcher = None
            fresh = monitor._state["freshness"]
            age = tele_metrics.STRATEGY_AGE.value
        counts = read_counts()
    finally:
        if batcher is not None:
            batcher.close()
        monitor.stop()
        srv.stop()
    inc = tune.load_incumbent(art, "dlrm", TUNE_DEVICES)
    records = tele_fleet.find_flight_records(flight_dir)
    rows = {fam: sorted(ln.split("{", 1)[1].split("}", 1)[0]
                        for ln in scrape.splitlines()
                        if ln.startswith(fam + "{"))
            for fam in ("dlrm_slo_burn_rate", "dlrm_slo_error_budget_pct")}
    names = sorted(f'slo="{s.name}"' for s in slos)
    breaches = [x for x in phases if x[1] == "breach"]
    recovers = [x for x in phases if x[1] == "recover"]
    slo_events = tele_report.load_events(slo_sink, strict=True)
    dominant = [e.get("dominant") for e in slo_events
                if e["type"] == "slo" and e["phase"] == "breach"]
    row = {"phase": "slo", "spec": spec, "threshold_us": edge_us,
           "phase_4_p99_us": serve_p99_us,
           "delay_ms": 1.5 * edge_us / 1e3, "transitions": phases,
           "healthz": health, "flight_records": records,
           "gauge_rows": rows, "breach_dominant_tail_phase": dominant,
           "freshness_samples": len(fresh.samples),
           "strategy_age_s": age, "launches": counts,
           "requests": summary["requests"], "p99_us": summary.get("p99_us")}
    log(row)
    ok = (breaches == [("delayed", "breach", slos[0].name)]
          and recovers == [("after", "recover", slos[0].name)]
          and len(phases) == 2
          and health["healthy"]["status"] == "ok"
          and health["breached"]["status"] == "degraded"
          and slos[0].name in health["breached"]["reason"]
          and health["recovered"]["status"] == "ok"
          and len(records) == 1
          and rows["dlrm_slo_burn_rate"] == names
          and rows["dlrm_slo_error_budget_pct"] == names
          and len(fresh.samples) > 0 and fresh.samples[-1][2] == 0.0
          and age is not None
          and abs(age - (time.time() - inc["created_ts"])) < 60.0
          and counts["fused_interact_fwd"] > 0)
    if not ok:
        raise AssertionError(f"SLO monitoring of the fused engine: {row}")
    return row, counts, (summary.get("p99_us") or 0.0) / 1e3


def _report_cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "dlrm_flexflow_tpu_torch.telemetry", *args],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return out.returncode, out.stdout, out.stderr


def _reports(sinks, record, history, card_name, real, p99_ms):
    """(e) The report CLI on (a)-(d)'s sinks in a subprocess, as text and
    as JSON: the per-op, calibration, tuning, serving and slo sections in
    both forms, the same sections in each; ``report --flight`` on (d)'s
    record; ``regress`` on this run's entries stamped with the card's
    name, passing against itself and failing against a copy 20% slower."""
    rc_t, text, err_t = _report_cli("report", sinks)
    rc_j, js, err_j = _report_cli("report", sinks, "--format", "json")
    rc_f, flight, err_f = _report_cli("report", "--flight", record)
    data = json.loads(js) if rc_j == 0 else {}
    heads = [ln for ln in text.splitlines()
             if ln.startswith("== ") and ln != "== run summary =="]
    json_sections = [k for k in data if k != "run"]
    same = (len(heads) == len(json_sections) and all(
        "\n".join(data[k]["lines"]) in text for k in json_sections))
    entries = [{"metric": "dlrm_tune_step_ms", "fenced": True,
                "value": real["candidate_s"] * 1e3, "device": card_name},
               {"metric": "dlrm_tune_samples_per_s", "fenced": True,
                "value": BATCH / real["candidate_s"], "device": card_name},
               {"metric": "dlrm_serving_p99_ms", "fenced": True,
                "value": p99_ms, "device": card_name}]
    slower = [dict(e, value=e["value"] / 1.2 if e["metric"].endswith(
        "_per_s") else e["value"] * 1.2) for e in entries]
    base, slow = history + ".base.json", history + ".slow.json"
    for path, doc in ((base, entries), (slow, slower)):
        with open(path, "w") as f:
            json.dump(doc, f)
    rc_same, out_same, _ = _report_cli("regress", "--baseline", base,
                                       "--new", base)
    rc_slow, out_slow, _ = _report_cli("regress", "--baseline", base,
                                       "--new", slow)
    row = {"phase": "reports", "text_sections": heads,
           "json_sections": json_sections, "same_sections": same,
           "flight_rendered": "== flight record ==" in flight,
           "regress_vs_itself_rc": rc_same, "regress_vs_slower_rc": rc_slow,
           "regress_keys": sorted(tele_regress.load_metrics(base)),
           "errors": [e[-400:] for e in (err_t, err_j, err_f) if e]}
    log(row)
    log("\n".join(["# report (text):", text, "# report --flight:", flight,
                   "# regress against the slower copy:", out_slow]))
    if not (rc_t == rc_j == rc_f == 0 and same
            and set(REPORT_SECTIONS) <= set(json_sections)
            and "== flight record ==" in flight
            and rc_same == 0 and rc_slow != 0
            and all(k.endswith(f":device={card_name}")
                    for k in row["regress_keys"])
            and out_same.strip().endswith("tolerance)")):
        raise AssertionError(f"the reports: {row}")
    return row


def tuning_phase(card, serve_p99_us):
    """Phase 23, the closed SOAP loop and its reports.  Every sink and
    artifact lives under one temporary directory beside this script,
    removed at the end.  Returns (row, launch counts)."""
    root = tempfile.mkdtemp(prefix=".tune-",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    sinks, art = os.path.join(root, "sinks"), os.path.join(root, "art")
    flight_dir = os.path.join(root, "flight")
    os.makedirs(sinks)
    op_sink = os.path.join(sinks, "op_time.jsonl")
    tune_sink = os.path.join(sinks, "tune.jsonl")
    slo_sink = os.path.join(sinks, "slo.jsonl")
    try:
        model, state = _train_model(True, "float32", epoch_row_cache="off")
        op_counts = _op_timer(model, state, op_sink)
        runs, cal = _tune_runs(model, op_sink, tune_sink, art)
        _calibrated_searches(model, cal, art)
        real, real_counts = _real_gate(op_sink, tune_sink, art, model, cal)
        _free()
        slo_row, slo_counts, p99_ms = _slo_serving(
            model, state, serve_p99_us, flight_dir, slo_sink, art)
        records = tele_fleet.find_flight_records(flight_dir)
        reports = _reports(sinks, records[0], os.path.join(root, "hist"),
                           card.split(",")[0].strip(), real, p99_ms)
        del model, state
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free()
    counts = {k: op_counts[k] + real_counts[k] + slo_counts[k]
              for k in op_counts}
    log({"phase": "tune_launches", "launches": counts})
    return {"runs": runs, "real": real, "slo": slo_row,
            "reports": reports}, counts


# -------------------------------------------------------------- phase 24
#: the reference's five other apps, each at its published widths and
#: depth (apps/*.py defaults) and the FFConfig default batch of 64
APPS = ("alexnet", "resnet", "inception", "candle_uno", "nmt")
#: each app's large f64-accumulated dense layer (ops/base.py::matmul), by
#: op name: the share of the step it takes is information for ROADMAP
#: Queue A item 1
F64_LAYERS = {"alexnet": "dense", "nmt": "proj"}
#: card against the port's CPU path at batch 2 (phase 25): of the loss's
#: input (the logits) after one forward, the largest difference over the
#: largest magnitude; of the loss, the relative difference; of the
#: parameters' change after one SGD step, the L2 norm of the difference
#: over the L2 norm of the change, all parameters together, within the
#: larger of "update_l2" and "spread_x" times the CPU's own spread: the
#: same CPU step's change on inputs moved by 1e-7 of their size.  A deep
#: net without normalisation (ResNet-50 at random weights) is that
#: sensitive: a pre-activation within rounding of zero takes the other
#: side of a relu, and its whole term moves the gradients (2.0e-4 in L2
#: between two CPU steps at batch 2 whose inputs differ by 1e-7).  The
#: largest single difference and its tensor are printed.
#: TF32 in the convolutions or their backward (10-bit mantissas) would
#: show at about 1e-3 in the logits, and its rounding, some 1e4 times
#: f32's, far above ten spreads in the update.
CARD_VS_CPU_TOL = {"logits": 1e-4, "loss": 1e-5, "update_l2": 1e-4,
                   "spread_x": 10.0,
                   # phase 28: each of the 8 losses, relative; the change
                   # of every parameter and host table over the 8 steps,
                   # in L2 relative to the change's own L2
                   "hetero_loss": 1e-5, "hetero_update_l2": 1e-4}


def _app(app, batch, optimizer=None, **config):
    """(model compiled with the CLI's optimizer and loss, or with
    ``optimizer``, under FFConfig fields ``config``; a function of n
    giving the CLI's data loader of n batches)."""
    from dlrm_flexflow_tpu_torch.apps import (alexnet, candle_uno,
                                              inception, nmt, resnet)
    # NMT's staged fit writes its epoch cache back through B5 under "on"
    ffc = FFConfig(batch_size=batch, epoch_row_cache="on", **config)
    if app in ("alexnet", "resnet", "inception"):
        mod = {"alexnet": alexnet, "resnet": resnet,
               "inception": inception}[app]
        model = getattr(mod, f"build_{app}")(ffc)
        opt = SGDOptimizer(lr=0.001)
        loader = lambda n: mod.cli_loader(ffc, n)  # noqa: E731
    elif app == "candle_uno":
        mod, cfg = candle_uno, candle_uno.CandleConfig()
        model = mod.build_candle_uno(cfg, ffc)
        opt = AdamOptimizer(lr=ffc.learning_rate)
        loader = lambda n: mod.cli_loader(cfg, ffc, n)  # noqa: E731
    else:
        mod, cfg = nmt, nmt.NMTConfig()
        model = mod.build_nmt(cfg, ffc)
        opt = SGDOptimizer(lr=ffc.learning_rate)
        loader = lambda n: mod.cli_loader(cfg, ffc, n)  # noqa: E731
    model.compile(optimizer=optimizer or opt, loss_type=mod.LOSS,
                  metrics=mod.METRICS)
    return model, loader


def _stacked(loader):
    """A loader's batches as (num_batches, batch, ...) arrays."""
    steps = list(loader)
    return ({k: np.stack([s[0][k] for s in steps]) for k in steps[0][0]},
            np.stack([s[1] for s in steps]))


def _f64_layer_ms(model, state, name, batch):
    """Device ms of one Linear op's forward and backward at the step's
    shapes, as the port runs it (f64 accumulation, ``ops/base.py::
    matmul``), and of the same three products in f32 (cuBLAS without
    TF32; information: what the f64 rule costs)."""
    op = model.get_op(name)
    gen = torch.Generator(device="cuda").manual_seed(11)
    shape = (batch,) + tuple(op.inputs[0].shape[1:])
    x = torch.randn(shape, generator=gen, device="cuda").requires_grad_()
    params = {k: v.detach().clone().requires_grad_()
              for k, v in state.params[name].items()}
    gy = torch.randn((batch,) + tuple(op.outputs[0].shape[1:]),
                     generator=gen, device="cuda")
    leaves = [x] + list(params.values())

    def port():
        (y,) = op.forward(params, [x])
        return torch.autograd.grad(y, leaves, gy)

    w = params["kernel"].detach()
    xd, gd = x.detach().reshape(-1, w.shape[0]), gy.reshape(-1, w.shape[1])

    def f32():
        return xd @ w, gd @ w.t(), xd.t() @ gd

    return graph_ms(port, [()]), graph_ms(f32, [()])


def train_app(app):
    """(i)-(iv) of phase 24 for one app at batch 64: one step through B2
    held bit for bit against the same step on ``row_update_ref`` (NMT, the
    app whose embeddings train row-sparse), four graphed steps against
    four eager ones bit for bit, the main path (``fit`` over the CLI's
    four batches, launches counted), then two warm and five timed graphed
    steps (losses, step wall); the f64 dense layer's share of that step;
    the parameter bytes and the peak memory.  Returns (row, main-path
    launches)."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' live tensors
    t_start = time.perf_counter()
    model, loader = _app(app, APP_BATCH)
    state = model.init(seed=0)
    inputs, labels = _stacked(loader(4))
    step0 = ({k: v[0] for k, v in inputs.items()}, labels[0])
    if app == "nmt":
        same, err = _same_step(model, state, *step0, emb_module,
                               "row_update_cuda", row_update_ref)
        log({"phase": "train_vs_plain", "config": app,
             "plain": "row_update_ref", "bit_identical": same,
             "max_abs_err": err})
        if not same:
            raise AssertionError("nmt step through the row-update kernel "
                                 "!= the same step on row_update_ref")
    check_graphed_vs_eager(model, state, inputs, labels, app)
    graphs0, steps0 = _graph_counts(model), int(state.step)
    reset_counts()  # the main path starts here
    state, thpt = model.fit(state, loader(4), epochs=1, verbose=False)
    torch.cuda.synchronize()
    counts = read_counts()  # ... and ends here
    fit_steps = int(state.step) - steps0  # fit's warm-up step included
    fit_graphs = {k: v - graphs0[k] for k, v in _graph_counts(model).items()}
    fit_means = model.get_perf_metrics().finalized_means()
    losses = []
    for i in range(7):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, mets = model.train_step(state, {k: v[i % 4] for k, v in
                                               inputs.items()}, labels[i % 4])
        losses.append(mets["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    losses = [float(v) for v in losses]
    row = {"phase": "app_train", "app": app, "batch": APP_BATCH,
           "ops": len(model.layers),
           "param_bytes": sum(v.numel() * v.element_size()
                              for d in state.params.values()
                              for v in d.values()),
           "optimizer": type(model.optimizer).__name__,
           "loss_type": model.loss_type, "sparse_ops":
               [op.name for op in model._sparse_ops],
           "fit_steps": fit_steps, "fit_launches": counts,
           "fit_graphs": fit_graphs,
           "fit_samples_per_s": thpt, "fit_metrics": fit_means,
           "losses": losses, "graphed_step_wall_ms": step_ms,
           "samples_per_s": APP_BATCH / step_ms * 1e3,
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - held,
           "held_before_bytes": held,
           "cuts": "none (published widths and depth, batch 64)"}
    if app in F64_LAYERS:
        f64_ms, f32_ms = _f64_layer_ms(model, state, F64_LAYERS[app],
                                       APP_BATCH)
        row["f64_layer"] = {"op": F64_LAYERS[app], "fwd_bwd_ms": f64_ms,
                            "share_of_step": f64_ms / step_ms,
                            "f32_products_ms": f32_ms}
    row["wall_s"] = time.perf_counter() - t_start
    log(row)
    # NMT's sparse_cce metric takes the log of its logits, NaN in the JAX
    # package too (ROADMAP Queue C): every other metric must be finite
    checked = [float(v) for k, v in fit_means.items()
               if not (app == "nmt" and k == "sparse_cce")]
    if not all(np.isfinite(losses + checked)):
        raise AssertionError(f"{app}: a non-finite loss or metric")
    if app == "nmt" and (counts["row_update"] != 2 * fit_steps
                         or counts["row_update_prep"] != counts[
                             "row_update"]):
        raise AssertionError(f"nmt: {counts['row_update']} row updates "
                             f"for {fit_steps} steps (2 a step)")
    if app != "nmt" and any(counts.values()):
        raise AssertionError(f"{app}: a kernel launched on a path that has "
                             f"none: {counts}")
    del model, state
    _free()
    return row, counts


# -------------------------------------------------------------- phase 25
def _rel(a, b) -> float:
    """max |a - b| over max |b|, on the CPU in f64."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _logits(model, state, inputs):
    """The loss's input (the logits under a Softmax op) of one eval
    forward."""
    dev = params_device_of(state)
    with torch.no_grad():
        values, _ = model._apply(state.params,
                                 model._place_inputs(inputs, dev),
                                 bn_state=state.bn_state)
    return values[model._loss_uid]


def params_device_of(state):
    return next(v for d in state.params.values() for v in d.values()).device


def _cpu_params(state):
    """Copies of a state's parameters on the CPU."""
    return {op: {k: v.to("cpu", copy=True) for k, v in d.items()}
            for op, d in state.params.items()}


def app_card_vs_cpu(app):
    """One forward and one SGD step (lr 0.01) of one app at batch 2, full
    width and depth, on the card and on the port's CPU path from the same
    parameters: the logits, the loss and every parameter's change within
    ``CARD_VS_CPU_TOL``.  Returns (row, launches)."""
    model, loader = _app(app, 2, optimizer=SGDOptimizer(lr=0.01))
    card = model.init(seed=0)
    cpu = model.load_params(card.params, device="cpu")
    before = cpu.clone()
    x, y = next(iter(loader(1)))
    t0 = time.perf_counter()
    logits_err = _rel(_logits(model, card, x), _logits(model, cpu, x))
    reset_counts()
    card, mc = model.train_step(card, x, y)
    torch.cuda.synchronize()
    counts = read_counts()
    cpu, mp = model.train_step(cpu, x, y)
    loss_err = _rel(mc["loss"], mp["loss"])
    # the CPU's own spread: the step on inputs moved by 1e-7 of their size
    # (none for a graph of integer inputs alone: NMT's tokens)
    rng = np.random.default_rng(19)
    moved = {k: (v * (1 + 1e-7 * rng.standard_normal(v.shape))).astype(
        v.dtype) if v.dtype.kind == "f" else v for k, v in x.items()}
    spread_state = (model.train_step(before, moved, y, donate=False)[0]
                    if any(v.dtype.kind == "f" for v in x.values()) else cpu)
    diff = scale = sq_diff = sq_scale = sq_spread = 0.0
    worst = (0.0, None)
    for op, d in cpu.params.items():
        for k, v in d.items():
            want = (v - before.params[op][k]).double()
            got = (card.params[op][k].cpu() - before.params[op][k]).double()
            near = (spread_state.params[op][k] - before.params[op][k]
                    ).double()
            gap, size = float((got - want).abs().max()), float(
                want.abs().max())
            diff, scale = max(diff, gap), max(scale, size)
            sq_diff += float(((got - want) ** 2).sum())
            sq_spread += float(((near - want) ** 2).sum())
            sq_scale += float((want ** 2).sum())
            if size > 0 and gap / size > worst[0]:
                worst = (gap / size, f"{op}/{k}")
    upd_err = (sq_diff / max(sq_scale, 1e-300)) ** 0.5
    spread = (sq_spread / max(sq_scale, 1e-300)) ** 0.5
    upd_tol = max(CARD_VS_CPU_TOL["update_l2"],
                  CARD_VS_CPU_TOL["spread_x"] * spread)
    row = {"phase": "app_card_vs_cpu", "app": app, "batch": 2,
           "logits_rel_err": logits_err, "loss_rel_err": loss_err,
           "update_l2_rel_err": upd_err, "cpu_spread_l2": spread,
           "update_l2_tolerance": upd_tol,
           "update_max_rel_err": diff / max(scale, 1e-30),
           "worst_tensor_update_rel_err": {"param": worst[1],
                                           "err": worst[0]},
           "tolerance": CARD_VS_CPU_TOL,
           "launches": counts, "wall_s": time.perf_counter() - t0}
    row["ok"] = (logits_err <= CARD_VS_CPU_TOL["logits"]
                 and loss_err <= CARD_VS_CPU_TOL["loss"]
                 and upd_err <= upd_tol)
    log(row)
    if not row["ok"]:
        raise AssertionError(f"{app}: the card's forward or step differs "
                             f"from the CPU's beyond the tolerance")
    del model, card, cpu, before
    _free()
    return row, counts


# -------------------------------------------------------------- phase 26
def time_row_update_nmt(sets: int = 16):
    """B2 at NMT's shape (n = 64 * 40 uniform token ids into a 20,480 x
    2048 f32 table, f32 updates, as ``src_embed``'s step): the whole call
    from a CUDA graph, beside its plain version, ``index_add_`` (the same
    sum in an atomic order) and the bytes bound."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    table = _rows_tensor(gen, NMT_ROWS, NMT_DIM)
    arg_sets = [(table, torch.randint(0, NMT_ROWS, (NMT_IDS,), generator=gen,
                                      device="cuda", dtype=torch.int32),
                 torch.randn((NMT_IDS, NMT_DIM), generator=gen,
                             device="cuda"),
                 torch.tensor(-0.01, device="cuda")) for _ in range(sets)]
    uniq = sum(int(torch.unique(a[1]).numel()) for a in arg_sets) / sets
    n, d = NMT_IDS, NMT_DIM
    nbytes = 2 * uniq * d * 4 + n * d * 4 + n * 4
    bound_ms, bound_by = _bound(nbytes, 2 * n * d)
    row = {"phase": "timing", "kernel": "row_update", "shape": "nmt",
           "n": n, "d": d, "rows": NMT_ROWS, "table_dtype": "float32",
           "distinct_rows": uniq,
           "mean_longest_run": sum(_longest_run(a[1].long(), NMT_ROWS)
                                   for a in arg_sets) / sets,
           "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
           "ms": graph_ms(row_update_cuda, arg_sets),
           "plain_ms": wall_ms(row_update_ref, arg_sets[:8]),
           "library_ms": graph_ms(
               lambda t, i, u, s: t.index_add_(0, i, u, alpha=-0.01),
               arg_sets)}
    row["share_of_bound"] = bound_ms / row["ms"]
    log(row)
    del table, arg_sets
    _free()
    return row


# -------------------------------------------------------------- phase 27
def _small_graph(kind):
    """(model, inputs (4, B, ...), labels (4, B, ...)) of one small graph
    of the ops that no app uses, compiled with SGD at 0.05 (``kind``
    "dropout_fixed": the dropout graph at lr 0, so only the masks move
    its loss)."""
    b = 8
    m = FFModel(FFConfig(batch_size=b))
    rng = np.random.default_rng(17)
    loss, nout = "mean_squared_error", 1
    if kind == "batch_norm":
        x = m.create_tensor((b, 3, 12, 12), name="x")
        t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1)
        t = m.batch_norm(t, relu=True)
        t = m.pool2d(t, 2, 2, 2, 2, 0, 0)
        t = m.batch_norm(t)
        t = m.dense(m.flat(t), 5)
        m.softmax(t)
        loss, nout = "sparse_categorical_crossentropy", 5
        shape = (3, 12, 12)
    elif kind in ("dropout", "dropout_fixed"):
        x = m.create_tensor((b, 64), name="x")
        t = m.dense(x, 256, activation="relu")
        t = m.dropout(t, 0.5)
        t = m.dense(t, 64, activation="tanh")
        t = m.dropout(t, 0.25, seed=3)
        m.dense(t, 1)
        shape = (64,)
    elif kind == "moe":
        x = m.create_tensor((b, 32), name="x")
        t = m.moe(x, 8, 64, top_k=2)
        t = m.moe(t, 4, 16, top_k=4)
        m.dense(t, 1)
        shape = (32,)
    elif kind == "attention":
        x = m.create_tensor((b, 16, 32), name="x")
        t = m.multihead_attention(x, x, x, 32, 4, causal=True)
        t = m.multihead_attention(t, x, x, 32, 2, causal=False)
        m.dense(m.flat(t), 1)
        shape = (16, 32)
    else:  # split, reverse and the elementwise ops
        x = m.create_tensor((b, 48), name="x")
        t = m.dense(x, 48)
        a, c, e = m.split(t, [16, 16, 16], 1)
        c = m.reverse(c, 1)
        t = m.add(m.multiply(m.sigmoid(a), m.tanh(c)),
                  m.divide(m.exp(m.scalar_multiply(e, 0.1)),
                           m.scalar_add(m.pow(m.relu(e), 2.0), 1.0)))
        t = m.subtract(m.gelu(t), m.elu(m.scalar_sub(t, 0.5)))
        t = m.identity(m.scalar_truediv(t, 3.0))
        m.dense(t, 1)
        shape = (48,)
    lr = 0.0 if kind == "dropout_fixed" else 0.05
    m.compile(optimizer=SGDOptimizer(lr=lr), loss_type=loss, metrics=())
    xs = rng.standard_normal((4, b) + shape).astype(np.float32)
    if kind == "dropout_fixed":
        xs[:] = xs[0]
    if nout == 1:
        ys = rng.standard_normal((4, b, 1)).astype(np.float32)
    else:
        ys = rng.integers(0, nout, size=(4, b, 1)).astype(np.int32)
    return m, {"x": xs}, ys


SMALL_GRAPHS = ("batch_norm", "dropout", "dropout_fixed", "moe",
                "attention", "elementwise")
#: the small graphs' card against CPU after 4 SGD steps: each loss
#: relative to itself; the change of every parameter and batch-norm
#: statistic over the 4 steps, all together, in L2 relative to the
#: change's own L2 (a tensor whose gradient is zero in exact arithmetic,
#: such as a convolution's bias in front of a batch norm, moves by
#: rounding alone, differently on each device; the worst tensor is
#: printed)
SMALL_TOL = 1e-4


def _change_l2(card_now, cpu_now, start):
    """(L2 of the card's change minus the CPU's over L2 of the CPU's
    change, all tensors together; the tensor where they differ most,
    relative to its own change)."""
    sq_diff = sq_scale = 0.0
    worst = (0.0, None)
    for (p, c), (_, h), (_, s0) in zip(flatten(card_now), flatten(cpu_now),
                                       flatten(start)):
        got = (c.detach().cpu() - s0).double()
        want = (h - s0).double()
        sq_diff += float(((got - want) ** 2).sum())
        sq_scale += float((want ** 2).sum())
        size = float(want.abs().max())
        if size > 0:
            gap = float((got - want).abs().max()) / size
            if gap > worst[0]:
                worst = (gap, "/".join(map(str, p)))
    err = (sq_diff / sq_scale) ** 0.5 if sq_scale else sq_diff ** 0.5
    return err, worst


def small_graph(kind):
    """One small graph on the card: four graphed steps against four eager
    ones bit for bit (parameters, batch-norm statistics, metrics), then
    the same four steps on the port's CPU path from the same state within
    ``SMALL_TOL``; for the dropout graphs each step's masks drawn on the
    card equal the CPU's, and at lr 0 the graphed losses of one batch
    differ from replay to replay."""
    model, inputs, labels = _small_graph(kind)
    state = model.init(seed=0)
    cpu = model.load_params(state.params, device="cpu")
    check_graphed_vs_eager(model, state, inputs, labels, kind)
    masks_equal, losses = None, []
    if kind.startswith("dropout"):
        masks_equal = True
        for step in range(4):
            for st in (state, cpu):
                st.step.fill_(step)
            key_card = fold_in(state.rng, state.step)
            key_cpu = fold_in(cpu.rng, cpu.step)
            masks_equal = masks_equal and torch.equal(
                key_card.cpu(), key_cpu) and torch.equal(
                dropout_keep(key_card, (8, 256), 0.5).cpu(),
                dropout_keep(key_cpu, (8, 256), 0.5))
        for st in (state, cpu):
            st.step.fill_(0)
    held_bn = {k: v.clone() for k, v in flatten(state.bn_state)}
    start = _cpu_params(cpu), {
        op: {k: v.clone() for k, v in d.items()}
        for op, d in cpu.bn_state.items()}
    for i in range(4):
        x, y = {"x": inputs["x"][i]}, labels[i]
        state, mc = model.train_step(state, x, y)
        cpu, mp = model.train_step(cpu, x, y)
        losses.append((float(mc["loss"]), float(mp["loss"])))
    torch.cuda.synchronize()
    loss_err = max(_rel(torch.tensor(a), torch.tensor(b)) for a, b in losses)
    change_err, worst = _change_l2((state.params, state.bn_state),
                                   (cpu.params, cpu.bn_state), start)
    err = max(loss_err, change_err)
    bn_moved = (all(not torch.equal(v, held_bn[p])
                    for p, v in flatten(state.bn_state))
                if state.bn_state else None)
    row = {"phase": "small_graph", "graph": kind,
           "ops": sorted({op.op_type for op in model.layers}),
           "losses_card_cpu": losses, "loss_rel_err": loss_err,
           "change_l2_rel_err": change_err,
           "worst_tensor": {"name": worst[1], "err": worst[0]},
           "tolerance": SMALL_TOL, "bn_state_moved": bn_moved,
           "masks_card_eq_cpu": masks_equal}
    ok = (err <= SMALL_TOL and bn_moved in (None, True)
          and masks_equal in (None, True))
    if kind == "dropout_fixed":
        card_losses = [a for a, _ in losses]
        row["replay_losses_distinct"] = len(set(card_losses)) == 4
        ok = ok and row["replay_losses_distinct"]
    row["ok"] = bool(ok)
    log(row)
    if not ok:
        raise AssertionError(f"small graph {kind} failed on the card")
    del model, state, cpu
    _free()


def apps_phase():
    """Phases 24-27: the five apps trained at their published widths, each
    against the port's CPU path at batch 2, B2 at NMT's shape, the small
    graphs of the other ops.  Returns (rows, main-path launches, B2's
    NMT timing)."""
    rows, total = {}, None
    for app in APPS:
        t0 = time.perf_counter()
        row, counts = train_app(app)
        log({"phase": "wall", "name": f"app_train {app}",
             "wall_s": time.perf_counter() - t0})
        rows[app] = row
        total = counts if total is None else {k: total[k] + counts[k]
                                              for k in total}
    t0 = time.perf_counter()
    for app in APPS:
        app_card_vs_cpu(app)
    log({"phase": "wall", "name": "app_card_vs_cpu",
         "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    nmt_b2 = time_row_update_nmt()
    for kind in SMALL_GRAPHS:
        small_graph(kind)
    log({"phase": "wall", "name": "b2_nmt_timing and small_graphs",
         "wall_s": time.perf_counter() - t0})
    return rows, total, nmt_b2


# --------------------------------------------------------------- phase 28
#: the hetero Kaggle phase: the steps of each run and the row count above
#: which the mixed run keeps a table on the host
HETERO_STEPS = 8
HETERO_BIG_ROWS = 1_000_000


def _kaggle(host_tables, mesh=None):
    """The Criteo-Kaggle DLRM (``criteo_kaggle_config``, one ``Embedding``
    per table, batch 256) compiled with the CLI's SGD at FFConfig's rate
    without weight decay (``--wd 0``: plain SGD, so tables on the card
    take the row-sparse path), MSE loss, accuracy and MSE metrics, and a
    strategy placing tables ``host_tables`` on the host: every table is
    the reference generator's ``dlrm_strategy(26, 1,
    hetero_cpu_embeddings=True, stacked=False)``; under ``mesh`` when
    given (phase 34)."""
    cfg = criteo_kaggle_config()
    t = len(cfg.embedding_size)
    model = build_dlrm(cfg, FFConfig(batch_size=BATCH),
                       stacked_embeddings=False)
    full = dlrm_strategy(t, 1, hetero_cpu_embeddings=True, stacked=False)
    strategy = Strategy()
    for i in host_tables:
        strategy[f"emb_{i}"] = full[f"emb_{i}"]
    model.compile(optimizer=SGDOptimizer(lr=FFConfig().learning_rate),
                  loss_type="mean_squared_error",
                  metrics=("accuracy", "mean_squared_error"),
                  strategy=strategy, mesh=mesh)
    return model


def _kaggle_loader():
    """Phase 28's and 34's Kaggle batches: HETERO_STEPS batches of 256,
    zipf-1.05 ids (seed 0)."""
    return ZipfDLRMLoader(HETERO_STEPS * BATCH, 13, KAGGLE_TABLES, 1,
                          BATCH, stacked=False, a=ZIPF_ALPHA, seed=0)


def _host_tables(model):
    """The host tables this process holds (across ranks, the owner's)."""
    return {op.name: op.host_table.array for op in model._hetero_ops
            if getattr(op, "host_table", None) is not None}


def _fit_losses(model, state, loader):
    """``fit`` over the loader (one epoch, no warmup step) with each
    step's loss and host-placed ops' handles recorded by a wrapper around
    the step it dispatches."""
    losses, handles, step = [], [], model._train_step

    def recorded(*args, **kw):
        out = step(*args, **kw)
        losses.append(float(out[1]["loss"]))
        handles.append({op.name: float(out[0].params[op.name]["handle"])
                        for op in model._hetero_ops})
        return out
    model._train_step = recorded
    try:
        state, _ = model.fit(state, loader, epochs=1, verbose=False,
                             warmup=False)
    finally:
        del model._train_step
    return state, losses, handles


def _numpy_branch_off():
    """The hetero numpy branches raise while the card runs: the native
    library (built from native/ffruntime.cpp) does every lookup and
    deposit."""
    def refuse(*_a, **_k):
        raise AssertionError("the numpy branch ran: ffruntime.cpp was not "
                             "used")
    stack = contextlib.ExitStack()
    for name in ("bag_numpy", "bag_grad_numpy"):
        stack.enter_context(_plain(hetero_module, name, refuse))
    return stack


def _hetero_times(model, state, loader, steps: int = HETERO_STEPS):
    """The host-side split of a step (hetero.timing(): each part waits
    for the card first) averaged over ``steps`` steps, the timed step's
    wall, and the untimed step's wall, in ms."""
    batches = list(loader)[:steps]
    for x, y in batches[:2]:  # warm: allocator and cuBLAS
        state, _ = model.train_step(state, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in batches:
        state, m = model.train_step(state, x, y)
    float(m["loss"])
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with hetero_module.timing() as parts:
        t0 = time.perf_counter()
        for x, y in batches:
            state, m = model.train_step(state, x, y)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    split = {k: v * 1e3 / steps for k, v in parts.items()}
    split["device"] = wall_ms - sum(split.values())
    return state, split, wall_ms, plain_ms


def hetero_run(card, name, host_tables, loader, root):
    """One hetero run (phase 28): the model on the card with its host
    tables, ``HETERO_STEPS`` steps through ``fit`` against the same steps
    on the port's CPU path from the same weights, tables and data; a
    save and restore of the host tables; the step's split."""
    model = _kaggle(host_tables)
    hosted = {op.name for op in model._hetero_ops}
    table_bytes = sum(4 * r * model.get_op(f"emb_{i}").out_dim
                      for i, r in enumerate(KAGGLE_TABLES))
    host_bytes = sum(4 * op.num_entries * op.out_dim
                     for op in model._hetero_ops)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = model.init(seed=0)
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    card_bytes = sum(t.numel() * t.element_size()
                     for _, t in flatten((state.params, state.opt_state)))
    start_tables = {k: v.copy() for k, v in _host_tables(model).items()}
    start = _cpu_params(state)
    twin = _kaggle(host_tables)
    cpu_state = twin.load_params(start, device="cpu",
                                 opt_state=_cpu_opt(state.opt_state),
                                 host_tables=start_tables)
    reset_counts()
    t0 = time.perf_counter()
    with _numpy_branch_off():
        state, card_losses, card_handles = _fit_losses(model, state, loader)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    cpu_state, cpu_losses, _ = _fit_losses(twin, cpu_state, loader)
    loss_err = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(card_losses, cpu_losses))
    tables = {k: torch.from_numpy(v) for k, v in _host_tables(model).items()}
    cpu_tables = {k: torch.from_numpy(v) for k, v in _host_tables(twin).items()}
    start_t = {k: torch.from_numpy(v) for k, v in start_tables.items()}
    update_err, worst = _change_l2((state.params, tables),
                                   (cpu_state.params, cpu_tables),
                                   (start, start_t))
    tables_moved = all(not torch.equal(tables[k], start_t[k])
                       for k in tables)
    # a handle moves by a few ulps of 1.0 a step (lr 0.01 times a small
    # gradient) and may round back to 1.0: each must leave 1.0 at a step
    handles = {n: float(state.params[n]["handle"]) for n in sorted(hosted)}
    handles_moved = all(any(h[n] != 1.0 for h in card_handles)
                        for n in hosted)
    # the checkpoint round trip of the host tables, bit for bit
    trained = {k: v.clone() for k, v in tables.items()}
    path = os.path.join(root, name)
    t0 = time.perf_counter()
    save_checkpoint(path, state, model=model)
    save_s = time.perf_counter() - t0
    npz_bytes = os.path.getsize(os.path.join(path, "state.npz"))
    for op in model._hetero_ops:
        op.host_table.array = np.zeros_like(op.host_table.array)
    t0 = time.perf_counter()
    back = restore_checkpoint(path, model)
    restore_s = time.perf_counter() - t0
    round_trip = (all(torch.equal(torch.from_numpy(v), trained[k])
                      for k, v in _host_tables(model).items())
                  and all(torch.equal(a, b) for (_, a), (_, b) in zip(
                      flatten(back.params), flatten(state.params))))
    shutil.rmtree(path, ignore_errors=True)
    with _numpy_branch_off():
        state, split, timed_ms, step_ms = _hetero_times(model, back, loader)
    row = {"phase": "hetero", "run": name, "card": card,
           "host_tables": len(hosted), "card_tables":
               len(KAGGLE_TABLES) - len(hosted),
           "host_table_bytes": host_bytes, "all_table_bytes": table_bytes,
           "memory_allocated_after_init": mem,
           "memory_allocated_init_delta": mem - base,
           "card_param_and_slot_bytes": card_bytes,
           "losses_card": card_losses, "losses_cpu": cpu_losses,
           "loss_rel_err": loss_err, "change_l2_rel_err": update_err,
           "worst_tensor": {"name": worst[1], "err": worst[0]},
           "tolerance": {k: CARD_VS_CPU_TOL[k]
                         for k in ("hetero_loss", "hetero_update_l2")},
           "tables_moved": tables_moved, "handles": handles,
           "handles_moved": handles_moved,
           "graph_captures": model.graph_captures,
           "launches": counts, "fit_wall_s": fit_s,
           "checkpoint": {"npz_bytes": npz_bytes, "save_s": save_s,
                          "restore_s": restore_s,
                          "host_tables_bit_for_bit": round_trip},
           "step_ms": step_ms, "timed_step_ms": timed_ms,
           "split_ms": split}
    ok = (loss_err <= CARD_VS_CPU_TOL["hetero_loss"]
          and update_err <= CARD_VS_CPU_TOL["hetero_update_l2"]
          and tables_moved and handles_moved and model.graph_captures == 0
          and twin.graph_captures == 0 and round_trip
          and mem - base <= card_bytes + (1 << 20)
          and mem - base < host_bytes
          and all(np.isfinite(card_losses)))
    if len(hosted) < len(KAGGLE_TABLES):
        # the tables on the card step through B2 next to the host tables
        want = (len(KAGGLE_TABLES) - len(hosted)) * HETERO_STEPS
        ok = ok and counts["row_update"] == counts["row_update_prep"] == want
    else:
        ok = ok and not any(counts.values())
    row["ok"] = bool(ok)
    log(row)
    if not ok:
        raise AssertionError(f"hetero run {name} failed on the card")
    del model, twin, state, cpu_state, back
    _free()
    return row, counts


def _cpu_opt(opt_state):
    """A copy of an optimizer state on the CPU."""
    if isinstance(opt_state, dict):
        return {k: _cpu_opt(v) for k, v in opt_state.items()}
    return opt_state.to("cpu", copy=True)


def hetero_phase(card):
    """Phase 28: the hetero Kaggle DLRM, every table on the host, then the
    four tables of over 1M rows on the host and 22 on the card.  Returns
    ({run: row}, launches of both runs)."""
    t0 = time.perf_counter()
    tb = time.perf_counter()
    if not native_module.native_available():
        raise AssertionError("native/ffruntime.cpp did not build")
    lib = native_module.get_lib()._name
    log({"phase": "hetero", "native_library": os.path.relpath(
        lib, os.path.dirname(os.path.abspath(__file__))),
         "compilers_tried_in_order": native_lib.compilers(),
         "build_or_load_s": time.perf_counter() - tb})
    if "dlrm_flexflow_tpu_torch/_build/ffruntime-" not in lib:
        raise AssertionError(f"unexpected native library {lib}")
    loader = _kaggle_loader()
    root = tempfile.mkdtemp(prefix=".hetero-",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    rows, total = {}, None
    try:
        for name, tables in (
                ("all_host", range(len(KAGGLE_TABLES))),
                ("mixed", [i for i, r in enumerate(KAGGLE_TABLES)
                           if r > HETERO_BIG_ROWS])):
            rows[name], counts = hetero_run(card, name, list(tables), loader,
                                            root)
            total = counts if total is None else {k: total[k] + counts[k]
                                                  for k in total}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log({"phase": "wall", "name": "hetero", "wall_s":
         time.perf_counter() - t0})
    return rows, total

# -------------------------------------------------------------- phase 29
#: the JAX package's policy for bf16 activation storage (its
#: test_ops.py:484-491): a loss within 0.05 of the f32-activation run's
ACT_LOSS_TOL = 0.05
#: steps of the loss trajectories, and of the card against the CPU
ACT_STEPS, ACT_CPU_STEPS = 16, 3
#: the card against the port's CPU path under bf16 activations: losses
#: at the repo's bf16 gate (rtol 1e-3)
ACT_CARD_VS_CPU_RTOL = 1e-3
#: Inception-v3 under bf16 compute and activations, the card against the
#: port's CPU path at batch 2: the logits within two bf16 ulps of the
#: largest (cuDNN and the CPU sum each convolution in another f32 order,
#: so a bf16 output near a rounding step may round the other way), the
#: loss at the repo's bf16 gate
ACT_INCEPTION_TOL = {"logits": 2.0 ** -7, "loss": ACT_CARD_VS_CPU_RTOL}


def _losses(model, state, inputs, labels, steps):
    """``steps`` donated steps over the first batches; (state, losses)."""
    out = []
    for i in range(steps):
        state, m = model.train_step(state, {k: v[i] for k, v in
                                            inputs.items()}, labels[i])
        out.append(m["loss"])
    return state, [float(v) for v in out]


def _declared(model) -> dict:
    """How many op outputs the compile declared of each dtype."""
    return dict(collections.Counter(str(t.dtype).replace("torch.", "")
                                    for op in model.layers
                                    for t in op.outputs))


def _check_storage(model, state, inputs, exempt: int, config: str) -> dict:
    """The bf16-activation rewrite on the card: every op output declared
    bf16 but the ``exempt`` f32 ones (the final output and the loss
    input), and every value of one eval forward stored in its declared
    dtype.  Returns the declared counts; raises otherwise."""
    declared = _declared(model)
    n = sum(declared.values())
    dev = params_device_of(state)
    with torch.no_grad():
        values, _ = model._apply(state.params,
                                 model._place_inputs(inputs, dev),
                                 bn_state=state.bn_state)
    wrong = [(op.name, str(values[t.uid].dtype)) for op in model.layers
             for t in op.outputs if values[t.uid].dtype != t.dtype]
    del values
    if declared != {"bfloat16": n - exempt, "float32": exempt} or wrong:
        raise AssertionError(f"{config}: declared {declared} ({exempt} "
                             f"f32 expected), stored otherwise: {wrong}")
    return declared


def bf16_act_classic(inputs, labels):
    """Phase 29(a): the run_random.sh classic graph (bf16 compute) under
    ``activation_dtype="bfloat16"``: one step through B2 against the same
    step on ``row_update_ref`` bit for bit, four graphed steps against
    four eager ones bit for bit, ``ACT_STEPS`` losses beside the
    f32-activation model's from the same weights, ``ACT_CPU_STEPS`` steps
    against the port's CPU path, and the main path, ``train_epoch`` over
    the 64 batches (B2 a step, B5 at the cache's writebacks)."""
    model, state = _train_model(False, "bfloat16",
                                activation_dtype="bfloat16")
    step0 = ({k: v[0] for k, v in inputs.items()}, labels[0])
    declared = _check_storage(model, state, step0[0], 1, "bf16_act classic")
    same, err = _same_step(model, state, *step0, emb_module,
                           "row_update_cuda", row_update_ref)
    log({"phase": "train_vs_plain", "config": "bf16_act classic",
         "plain": "row_update_ref", "bit_identical": same,
         "max_abs_err": err})
    if not same:
        raise AssertionError("bf16-activation step through B2 != the same "
                             "step on row_update_ref")
    check_graphed_vs_eager(model, state, inputs, labels, "bf16_act classic")
    f32_model, f32_state = _train_model(False, "bfloat16")
    _, f32_losses = _losses(f32_model, f32_state, inputs, labels, ACT_STEPS)
    del f32_model, f32_state
    _free()
    _, act_losses = _losses(model, state.clone(), inputs, labels, ACT_STEPS)
    gap = max(abs(a - b) for a, b in zip(act_losses, f32_losses))
    nb = labels.shape[0]
    graphs0 = _graph_counts(model)
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    trained, folded = model.train_epoch(state.clone(), inputs, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()  # ... and ends here
    graphs = {k: v - graphs0[k] for k, v in _graph_counts(model).items()}
    del trained
    # the card against the port's CPU path from the same weights, eager
    # on the card, donated on the CPU (no 2 GB clone a step); last: it
    # places the model's CPU state
    card, cpu = state, model.load_params(state.params, device="cpu")
    card_losses, cpu_losses = [], []
    for i in range(ACT_CPU_STEPS):
        x, y = {k: v[i] for k, v in inputs.items()}, labels[i]
        card, mc = model.train_step(card, x, y, False)
        cpu, mp = model.train_step(cpu, x, y)
        card_losses.append(float(mc["loss"]))
        cpu_losses.append(float(mp["loss"]))
    cpu_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))
    row = {"phase": "bf16_act", "config": "classic cat, run_random.sh",
           "compute_dtype": "bfloat16", "activation_dtype": "bfloat16",
           "declared": declared, "steps": nb, "launches": counts,
           "graphs": graphs, "loss": float(folded["loss"]),
           "step_wall_ms": wall * 1e3 / nb,
           "losses": act_losses, "f32_activation_losses": f32_losses,
           "max_loss_gap": gap, "loss_tol": ACT_LOSS_TOL,
           "card_losses": card_losses, "cpu_losses": cpu_losses,
           "card_vs_cpu_loss_rel_err": cpu_err,
           "card_vs_cpu_rtol": ACT_CARD_VS_CPU_RTOL,
           "note": "walls are information, not a claim"}
    log(row)
    if not (_finite(folded) and gap < ACT_LOSS_TOL
            and cpu_err <= ACT_CARD_VS_CPU_RTOL):
        raise AssertionError(f"bf16 activations: loss gap {gap} to the "
                             f"f32-activation run, card vs CPU {cpu_err}")
    if (counts["row_update"] != nb or counts["row_set"] <= 0
            or graphs != {"captures": 1, "replays": nb - 1}):
        raise AssertionError(f"bf16-activation train_epoch: launches "
                             f"{counts}, graphs {graphs}")
    del model, state, card, cpu
    _free()
    return row, counts


def bf16_act_serving():
    """Phase 29(b): the fused run_random.sh model under bf16 activations
    served by an InferenceEngine over buckets 1-256 (B3, the bottom cast
    to f32 for it): 8 clients x 16 one-row requests and 3, 40 and 256
    rows through the batcher, the padding contract and every bucket's
    graph against the eager forward bit for bit, the answers beside the
    f32-activation engine's."""
    model, state = build_model(activation_dtype="bfloat16")
    engine = InferenceEngine(model, state)
    rng = np.random.default_rng(29)
    reqs = [_request(rng, 1) for _ in range(8 * 16)]
    big = {n: _request(rng, n) for n in (3, 40, 256)}
    declared = _check_storage(model, state, big[256], 1, "bf16_act serving")
    reset_counts()  # the main path starts here
    replays0 = engine.graph_replays
    with DynamicBatcher(engine) as batcher:
        got = _clients(batcher.submit, reqs + list(big.values()), 8)
    summary = batcher.close()
    counts = read_counts()  # ... and ends here
    replays = engine.graph_replays - replays0
    padded = engine.predict(big[3])
    unpadded = model.predict(state, big[3])
    pad_same = bool(np.array_equal(padded, unpadded.cpu().numpy()))
    check_buckets_vs_eager(model, state, engine, rng, "bf16_act serving")
    ok = all(np.isfinite(a).all() and ((a > 0) & (a < 1)).all()
             for a in got.values())
    f32_model, f32_state = build_model()
    f32_out = f32_model.predict(f32_state, big[256]).cpu().numpy()
    gap = float(np.abs(engine.predict(big[256]) - f32_out).max())
    row = {"phase": "bf16_act", "config": "fused serving, run_random.sh",
           "declared": declared, "requests": summary["requests"],
           "qps": summary["qps"], "p99_us": summary.get("p99_us"),
           "launches": counts, "graph_replays": replays,
           "output_dtype": str(unpadded.dtype),
           "padding_bit_identical": pad_same,
           "max_abs_gap_to_f32_activations": gap,
           "note": "latencies are information, not a claim"}
    log(row)
    if not (ok and pad_same and unpadded.dtype == torch.float32):
        raise AssertionError(f"bf16-activation serving: answers ok {ok}, "
                             f"padding {pad_same}")
    if counts["fused_interact_fwd"] <= 0 or replays <= 0:
        raise AssertionError(f"bf16-activation serving launched {counts} "
                             f"in {replays} replays")
    del model, state, engine, f32_model, f32_state
    _free()
    return row, counts


def _inception_timed(act, inputs, labels, check: bool):
    """Inception-v3 at 299 x 299, batch 64, bf16 compute, activations
    stored ``act``: (with ``check``) the storage and four graphed steps
    against four eager ones bit for bit, then two warm and five timed
    graphed steps.  Returns (row, launches)."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model, _ = _app("inception", APP_BATCH, compute_dtype="bfloat16",
                    activation_dtype=act)
    state = model.init(seed=0)
    declared = (_check_storage(model, state, {k: v[0] for k, v in
                                              inputs.items()}, 2,
                               "bf16_act inception") if check
                else _declared(model))
    if check:
        check_graphed_vs_eager(model, state, inputs, labels,
                               "bf16_act inception")
    reset_counts()
    losses = []
    for i in range(7):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, mets = model.train_step(state, {k: v[i % 4] for k, v in
                                               inputs.items()}, labels[i % 4])
        losses.append(mets["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    counts = read_counts()
    row = {"activation_dtype": act, "declared": declared,
           "losses": [float(v) for v in losses],
           "graphed_step_wall_ms": step_ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - held}
    del model, state
    _free()
    return row, counts


def _inception_card_vs_cpu():
    """One eval forward and one SGD step (lr 0.01) of Inception-v3 at
    batch 2, full width and depth, bf16 compute and activations, on the
    card and on the port's CPU path from the same parameters: the loss
    input (the logits) and the loss within ``ACT_INCEPTION_TOL``."""
    model, loader = _app("inception", 2, optimizer=SGDOptimizer(lr=0.01),
                         compute_dtype="bfloat16",
                         activation_dtype="bfloat16")
    card = model.init(seed=0)
    cpu = model.load_params(card.params, device="cpu")
    x, y = next(iter(loader(1)))
    logits_card, logits_cpu = _logits(model, card, x), _logits(model, cpu, x)
    logits_err = _rel(logits_card, logits_cpu)
    card, mc = model.train_step(card, x, y)
    cpu, mp = model.train_step(cpu, x, y)
    loss_err = _rel(mc["loss"], mp["loss"])
    row = {"batch": 2, "logits_dtype": str(logits_card.dtype),
           "logits_rel_err": logits_err, "loss_rel_err": loss_err,
           "losses_card_cpu": [float(mc["loss"]), float(mp["loss"])],
           "tolerance": ACT_INCEPTION_TOL}
    del model, card, cpu
    _free()
    return row


def bf16_act_inception():
    """Phase 29(c): Inception-v3 at 299 x 299, batch 64, bf16 compute
    (the JAX convolution takes one dtype, so bf16 storage goes with bf16
    compute): under bf16 activations the storage, graphed steps against
    eager ones bit for bit, the step's wall and peak memory; the same
    figures under f32 activations, so the two differ only in storage;
    and the card against the port's CPU path at batch 2."""
    model, loader = _app("inception", APP_BATCH)
    inputs, labels = _stacked(loader(4))
    del model
    bf16, counts = _inception_timed("bfloat16", inputs, labels, True)
    f32, f32_counts = _inception_timed("float32", inputs, labels, False)
    vs_cpu = _inception_card_vs_cpu()
    row = {"phase": "bf16_act", "config": "inception-v3 299, batch 64",
           "compute_dtype": "bfloat16", **bf16,
           "f32_activations": f32,
           "step_ratio_bf16_to_f32_act": (bf16["graphed_step_wall_ms"]
                                          / f32["graphed_step_wall_ms"]),
           "peak_ratio_bf16_to_f32_act": (bf16["peak_memory_bytes"]
                                          / f32["peak_memory_bytes"]),
           "card_vs_cpu": vs_cpu, "launches": counts,
           "note": "walls are information"}
    log(row)
    ok = (np.isfinite(bf16["losses"] + f32["losses"]).all()
          and vs_cpu["logits_rel_err"] <= ACT_INCEPTION_TOL["logits"]
          and vs_cpu["loss_rel_err"] <= ACT_INCEPTION_TOL["loss"])
    if not ok or any(counts.values()) or any(f32_counts.values()):
        raise AssertionError(f"bf16-activation inception: losses "
                             f"{bf16['losses']}, card vs CPU {vs_cpu}, "
                             f"launches {counts} {f32_counts}")
    return row


def bf16_activation_phase(inputs, labels):
    """Phase 29.  Returns (rows, main-path launches)."""
    t0 = time.perf_counter()
    classic, classic_counts = bf16_act_classic(inputs, labels)
    serving, serving_counts = bf16_act_serving()
    inception = bf16_act_inception()
    log({"phase": "wall", "name": "bf16_act", "wall_s":
         time.perf_counter() - t0})
    return ({"classic": classic, "serving": serving,
             "inception": inception},
            {k: classic_counts[k] + serving_counts[k]
             for k in classic_counts})


# -------------------------------------------------------------- phase 30
def bf16_tiered_phase(f32_rows):
    """Phase 30: the run_random.sh serving model (unfused, bf16 compute)
    on bf16 tables (1.02 GB), tiered at 4096 hot rows a table: phase
    20's 512 zipf-1.05 requests from 8 clients through the batcher, bit
    for bit the resident bf16 engine's, beside phase 20's f32 figures;
    then ``scatter_apply`` of a bf16 store on the card against the CPU
    store (B2 on bf16 rows, B5 bf16 installs).  Returns (row,
    main-path launches)."""
    t_phase = time.perf_counter()
    model = build_dlrm(DLRMConfig(embedding_size=[ROWS] * TABLES),
                       FFConfig(batch_size=BUCKETS[-1],
                                compute_dtype="bfloat16",
                                serve_buckets=",".join(map(str, BUCKETS)),
                                storage_hot_rows=HOT_ROWS,
                                embedding_dtype="bfloat16")).compile()
    state = model.init(seed=0)
    resident = InferenceEngine(model, state)
    pool = _zipf_pool(np.random.default_rng(20), 512)  # phase 20's pool
    rowfreq.reset()
    for r in pool:
        for t in range(TABLES):
            rowfreq.counter(f"sparse[{t}]").observe(r["sparse"][:, t])
    want = {i: resident.predict(r) for i, r in enumerate(pool)}
    with DynamicBatcher(resident) as batcher:
        _same_as(_clients(batcher.submit, pool, 8), want,
                 "bf16 resident through the batcher")
    base = batcher.close()
    engine, refused = _tiered_engine(model, state)
    if engine._tiered["sparse"][1].hot_param().dtype != torch.bfloat16:
        raise AssertionError("the tiered store's hot tier is not bf16")
    reset_counts()  # the main path starts here
    t_start = time.perf_counter()
    with DynamicBatcher(engine) as batcher:
        got = _clients(batcher.submit, pool, 8)
    wall_s = time.perf_counter() - t_start
    summary = batcher.close()
    counts = read_counts()
    dispatches = sum(engine.stats.dispatch_buckets.values())
    _same_as(got, want, "bf16 tiered, graphed, through the batcher")
    st = engine.storage_stats()
    del engine, resident, model, state
    _free()
    scatter_err, scatter_counts = check_tiered_scatter(
        dtype=torch.bfloat16)  # ... and ends here
    counts = {k: counts[k] + scatter_counts[k] for k in counts}
    f32 = f32_rows["hot4096"]
    row = {"phase": "tiered_bf16", "config": "run_random.sh on bf16 "
           "tables (1.02 GB), hot 4096", "gate_refused": refused,
           "table_bytes": TABLES * ROWS * DIM * 2,
           "requests": summary["requests"], "dispatches": dispatches,
           "wall_s": wall_s, "qps": summary["qps"],
           "p50_us": summary.get("p50_us"), "p99_us": summary.get("p99_us"),
           "hit_pct": st["hit_pct"], "misses": st["misses"],
           "evictions": st["evictions"],
           "b5_bf16_installs": counts["row_set"] - scatter_counts["row_set"],
           "b2_scatter_updates": scatter_counts["row_update"],
           "scatter_launches": scatter_counts,
           "scatter_note": "bf16 grads: B2 on the bf16 hot tier; f32 "
                           "grads: B2 on an f32 copy of the touched rows, "
                           "set back by B5 (bf16)",
           "scatter_max_abs_err": scatter_err,
           "resident": {"qps": base["qps"], "p99_us": base.get("p99_us")},
           "f32_phase20": {k: f32.get(k) for k in ("qps", "p99_us",
                                                    "hit_pct")},
           "bit_for_bit_vs_resident": True,
           "wall_phase_s": time.perf_counter() - t_phase,
           "note": "QPS and latencies are information"}
    log(row)
    if not 0 < row["b5_bf16_installs"] <= dispatches:
        raise AssertionError(f"{row['b5_bf16_installs']} bf16 installs in "
                             f"{dispatches} dispatches")
    return row, counts


# -------------------------------------------------------------- phase 31
#: the keras examples' sample count (examples/compat/keras, 2048) and
#: the card-against-CPU steps of each frontend model
FRONT_SAMPLES, FRONT_STEPS = 2048, 4


def _seq_mnist_mlp():
    """examples/compat/keras/seq_mnist_mlp.py: 784-512-512-10."""
    K = keras_frontend
    return K.Sequential([K.Dense(512, activation="relu", input_shape=(784,)),
                         K.Dense(512, activation="relu"), K.Dense(10),
                         K.Activation("softmax")])


def _func_cifar10_cnn():
    """examples/compat/keras/func_cifar10_cnn.py."""
    K = keras_frontend
    inp = K.InputTensor((3, 32, 32), "float32")
    t = K.Conv2D(filters=32, kernel_size=(3, 3), strides=(1, 1),
                 padding=(1, 1), activation="relu")(inp)
    t = K.Conv2D(filters=32, kernel_size=(3, 3), strides=(1, 1),
                 padding=(1, 1), activation="relu")(t)
    t = K.MaxPooling2D(pool_size=(2, 2), strides=(2, 2), padding="valid")(t)
    t = K.Dense(512, activation="relu")(K.Flatten()(t))
    out = K.Activation("softmax")(K.Dense(10)(t))
    return K.Model(inp, out)


def _keras_data(name):
    """The example's training data from keras_datasets (its synthetic
    data where no keras cache is present)."""
    ds = keras_frontend.datasets
    if name == "seq_mnist_mlp":
        (x, y), _ = ds.mnist.load_data()
        x = x[:FRONT_SAMPLES].reshape(FRONT_SAMPLES, 784)
    else:
        (x, y), _ = ds.cifar10.load_data(FRONT_SAMPLES)
        x = x[:FRONT_SAMPLES]
    return (x.astype("float32") / 255,
            y[:FRONT_SAMPLES].astype("int32").reshape(-1, 1))


def _card_vs_cpu_steps(card_model, card_state, cpu_model, inputs, labels,
                       batch):
    """``FRONT_STEPS`` eager steps of two FFModels from the card state's
    parameters (the second on the CPU): (max loss rel err, predictions'
    rel err after)."""
    cpu_state = cpu_model.load_params(card_state.params, device="cpu")
    card_state = card_state.clone()
    loss_err = 0.0
    for i in range(FRONT_STEPS):
        sl = slice(i * batch, (i + 1) * batch)
        x = {k: v[sl] for k, v in inputs.items()}
        card_state, mc = card_model.train_step(card_state, x, labels[sl],
                                               False)
        cpu_state, mp = cpu_model.train_step(cpu_state, x, labels[sl], False)
        loss_err = max(loss_err, _rel(mc["loss"], mp["loss"]))
    x = {k: v[:batch] for k, v in inputs.items()}
    pred_err = _rel(card_model.predict(card_state, x),
                    cpu_model.predict(cpu_state, x))
    return loss_err, pred_err


def _keras_run(name, build):
    """One keras example trained on the card: FRONT_STEPS steps against
    the same model on the CPU, then ``fit`` over the example's samples,
    five timed graphed steps and ``evaluate``."""
    x, y = _keras_data(name)
    batch = 64
    card, cpu = build(), build()
    opt = lambda: SGDOptimizer(lr=0.01)  # noqa: E731
    mets = ("accuracy", "sparse_categorical_crossentropy")
    card.compile(opt(), "sparse_categorical_crossentropy", mets, batch)
    cpu.compile(opt(), "sparse_categorical_crossentropy", mets, batch,
                device="cpu")
    inputs = card._as_input_dict(x)
    loss_err, pred_err = _card_vs_cpu_steps(card.ffmodel, card.state,
                                            cpu.ffmodel, inputs, y, batch)
    thpt = card.fit(x, y, epochs=1, verbose=False)
    state = card.state
    for i in range(7):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        sl = slice(i * batch, (i + 1) * batch)
        state, m = card.ffmodel.train_step(
            state, {k: v[sl] for k, v in inputs.items()}, y[sl])
    float(m["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    card.state = state
    loss = card.evaluate(x[:512], y[:512])
    return {"frontend": "keras", "model": name,
            "ops": len(card.ffmodel.layers),
            "loss_rel_err": loss_err, "pred_rel_err": pred_err,
            "fit_samples_per_s": thpt, "graphed_step_wall_ms": step_ms,
            "evaluate_loss": loss, "summary_lines":
                len(card.summary().splitlines())}


class _TorchCNN(torch.nn.Module):
    """A CIFAR-width CNN for the torch.fx importer: conv, batch norm,
    relu, max pool, conv, relu, average pool, flatten, two linear."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(3, 32, 3, padding=1)
        self.bn = nn.BatchNorm2d(32)
        self.pool = nn.MaxPool2d(2)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.avg = nn.AvgPool2d(2)
        self.flat = nn.Flatten()
        self.fc1 = nn.Linear(64 * 8 * 8, 512)
        self.fc2 = nn.Linear(512, 10)

    def forward(self, x):
        h = self.pool(torch.relu(self.bn(self.conv1(x))))
        h = self.avg(torch.relu(self.conv2(h)))
        return self.fc2(torch.relu(self.fc1(self.flat(h))))


def _torch_fx_run():
    """A torch CNN on the card converted by ``PyTorchModel``: its weights
    imported from the module's CUDA tensors; the forward against the
    module's (cuDNN without TF32, as the port's convolution); steps
    against the same conversion on the CPU."""
    torch.manual_seed(0)
    module = _TorchCNN().cuda().eval()
    batch = 64
    conv = PyTorchModel(module)
    models = {}
    for dev in ("cuda", "cpu"):
        m = conv.apply(FFConfig(batch_size=batch), {"x": (3, 32, 32)})
        m.compile(optimizer=SGDOptimizer(lr=0.01),
                  loss_type="mean_squared_error", metrics=())
        models[dev] = (m, conv.import_weights(m, m.init(
            seed=0, device=dev)))
    card, state = models["cuda"]
    x = np.random.default_rng(31).standard_normal(
        (batch * FRONT_STEPS, 3, 32, 32)).astype(np.float32)
    y = np.random.default_rng(32).standard_normal(
        (batch * FRONT_STEPS, 10)).astype(np.float32)
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, deterministic=True, allow_tf32=False):
        ref = module(torch.from_numpy(x[:batch]).cuda())
    module_err = _rel(card.predict(state, {"x": x[:batch]}), ref)
    loss_err, pred_err = _card_vs_cpu_steps(card, state, models["cpu"][0],
                                            {"x": x}, y, batch)
    return {"frontend": "torch_fx", "model": "cifar cnn",
            "ops": len(card.layers), "module_rel_err": module_err,
            "loss_rel_err": loss_err, "pred_rel_err": pred_err}


#: the card against the CPU for the frontends' models (the apps' logits
#: and loss tolerances, CARD_VS_CPU_TOL), and a converted module's
#: forward against the module's (the JAX package's CNN test's 1e-4)
FRONT_TOL = {"loss": 1e-5, "pred": 1e-4, "module": 1e-4}


def frontends_phase():
    """Phase 31: the keras examples seq_mnist_mlp and func_cifar10_cnn at
    their widths on keras_datasets' data, a torch.fx conversion of a
    torch CNN, each trained on the card and held against the same model
    on the CPU, and ``ONNXModel`` refusing without ``onnx``.  No kernel
    runs in this phase."""
    t0 = time.perf_counter()
    reset_counts()
    rows = [_keras_run("seq_mnist_mlp", _seq_mnist_mlp),
            _keras_run("func_cifar10_cnn", _func_cifar10_cnn),
            _torch_fx_run()]
    counts = read_counts()
    import importlib.util
    onnx_present = importlib.util.find_spec("onnx") is not None
    refused = None
    if not onnx_present:
        try:
            onnx_model.ONNXModel("model.onnx")
        except ImportError as e:
            refused = str(e)
    for r in rows:
        log({"phase": "frontends", **r, "tolerance": FRONT_TOL})
    log({"phase": "frontends", "onnx_installed": onnx_present,
         "onnx_refusal": refused, "launches": counts,
         "note": "no kernel runs in this phase: dense models only",
         "wall_s": time.perf_counter() - t0})
    bad = [r for r in rows if r["loss_rel_err"] > FRONT_TOL["loss"]
           or r["pred_rel_err"] > FRONT_TOL["pred"]
           or r.get("module_rel_err", 0.0) > FRONT_TOL["module"]]
    if bad or any(counts.values()) or (not onnx_present and not refused):
        raise AssertionError(f"frontends: {bad}, launches {counts}, onnx "
                             f"refusal {refused!r}")
    _free()
    return rows



# -------------------------------------------------------------- phase 32
MESH_STEPS = 4
#: sequence-parallel attention on the card: (B, H, S, D), S split over
#: the ranks of "seq"
RING_SHAPE = (2, 8, 4096, 64)
#: 32(b)'s runs: [name, mesh shape, table_parallel, table_exchange,
#: overlap]
MESH2_RUNS = [
    ["allgather", {"data": 1, "model": 2}, True, "allgather", "off"],
    ["all_to_all", {"data": 1, "model": 2}, True, "all_to_all", "off"],
    ["overlap_allgather", {"data": 1, "model": 2}, True, "allgather", "on"]]


def _mesh_model(mesh, compute_dtype, table_parallel=False,
                table_exchange="off", overlap="off", batch=BATCH):
    """The run_random.sh classic graph (or with ``overlap`` "on" its
    overlapped graph) at full width and global batch ``batch``, compiled
    under ``mesh`` (False: no mesh), SGD at lr 0.01; and the warnings
    compile gave."""
    cfg = DLRMConfig(embedding_size=[ROWS] * TABLES,
                     exchange_overlap=overlap)
    ffc = FFConfig(batch_size=batch, compute_dtype=compute_dtype,
                   table_exchange=table_exchange)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = build_dlrm(cfg, ffc, table_parallel=table_parallel).compile(
            optimizer=SGDOptimizer(lr=0.01), loss_type="mean_squared_error",
            metrics=("accuracy", "mean_squared_error"), mesh=mesh)
    return model, [str(w.message) for w in caught]


def _mesh_dlrm(mesh, compute_dtype, table_parallel=False,
               table_exchange="off", overlap="off", batch=BATCH):
    """``_mesh_model`` with its state from seed 0 on this process's
    card."""
    model, warned = _mesh_model(mesh, compute_dtype, table_parallel,
                                table_exchange, overlap, batch)
    return model, model.init(seed=0), warned


def _mesh_steps(model, state, inputs, labels, walls=None):
    """MESH_STEPS donated steps; the losses and the median step wall
    (each step's wall appended to ``walls`` when given)."""
    losses, walls = [], [] if walls is None else walls
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        state, mets = model.train_step(
            state, {k: v[i] for k, v in inputs.items()}, labels[i])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(mets["loss"]))
    return state, losses, float(np.median(walls))


def mesh_one_rank(inputs, labels):
    """32(a): one rank through distributed.initialize (NCCL, a file
    store): the headline classic graph under make_mesh({"data": 1}), and
    the table-parallel graph under {"data": 1, "model": 1} with
    table_exchange="allgather" (which warns and stays off), each bit for
    bit the no-mesh model over MESH_STEPS steps, kernels and captured
    steps included."""
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch import distributed as fdist
    from dlrm_flexflow_tpu_torch.parallel import make_mesh
    store_dir = tempfile.mkdtemp(prefix="mesh1-")
    topo = fdist.initialize(f"file://{store_dir}/store", 1, 0)
    probe = torch.ones(4, device="cuda")
    dist.all_reduce(probe)  # the NCCL communicator itself
    torch.cuda.synchronize()
    if dist.get_backend() != "nccl" or float(probe.sum()) != 4.0:
        raise AssertionError("32(a): no working NCCL group of one rank")
    runs, counts = {}, {k: 0 for k in KERNELS}
    for name, mesh, kw in (
            ("data1", make_mesh({"data": 1}), {}),
            ("data1_model1_allgather", make_mesh({"data": 1, "model": 1}),
             {"table_parallel": True, "table_exchange": "allgather"})):
        base, bstate, _ = _mesh_dlrm(False, "bfloat16", **kw)
        bstate, blosses, bwall = _mesh_steps(base, bstate, inputs, labels)
        want = {f"{o}/{k}": v.detach().clone()
                for o, d in bstate.params.items() for k, v in d.items()}
        bcaps = base.graph_captures
        del base, bstate
        _free()
        model, state, warned = _mesh_dlrm(mesh, "bfloat16", **kw)
        if model._spmd is not None or model.mesh is not mesh:
            raise AssertionError(f"32(a) {name}: a trivial mesh must run "
                                 "the no-mesh program")
        reset_counts()
        state, losses, wall = _mesh_steps(model, state, inputs, labels)
        got = read_counts()
        same = losses == blosses and model.graph_captures == bcaps and all(
            torch.equal(v, want[f"{o}/{k}"])
            for o, d in state.params.items() for k, v in d.items())
        if not same or got["row_update"] == 0:
            raise AssertionError(f"32(a) {name}: not bit for bit the "
                                 f"no-mesh model (losses {losses} vs "
                                 f"{blosses}, launches {got})")
        for k, v in got.items():
            counts[k] += v
        runs[name] = {"bit_identical": True, "losses": losses,
                      "step_wall_ms": wall, "no_mesh_step_wall_ms": bwall,
                      "row_update_launches": got["row_update"],
                      "captures": model.graph_captures,
                      "exchange_warning": [w for w in warned
                                           if "table_exchange" in w]}
        del model, state, want
        _free()
    dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)
    log({"phase": "mesh_one_rank", "backend": "nccl", "topology": topo,
         **runs})
    return runs, counts


def _touched(inputs):
    """The flat rows of the MESH_STEPS batches' ids, per table."""
    ids = inputs["sparse"][:MESH_STEPS]          # (steps, B, T, bag)
    return {t: np.unique(ids[:, :, t].reshape(-1)) for t in range(TABLES)}


def _gloo_refusal(err):
    """What gloo refused, from a collective's error on CUDA tensors:
    "alltoall" (the backend has no all-to-all), "cuda_pointer" (its TCP
    transport cannot read or write device memory, as a send/recv asks),
    "peer_closed" (the other rank's transport closed after its own
    refusal; 32(b) accepts it only beside that refusal), or None for any
    other error, which is a fault."""
    msg = str(err)
    if "does not support alltoall" in msg:
        return "alltoall"
    if "gloo/transport/tcp" in msg and "Bad address" in msg:
        return "cuda_pointer"
    if "gloo/transport/tcp" in msg and "Connection closed by peer" in msg:
        return "peer_closed"
    return None


def _rank_group(world, backend):
    """This rank's id, after checking that its group has ``world`` ranks
    on ``backend``."""
    import torch.distributed as dist
    if dist.get_world_size() != world or dist.get_backend() != backend:
        raise AssertionError(f"a rank of {dist.get_world_size()} on "
                             f"{dist.get_backend()}, not {world} on "
                             f"{backend}")
    return dist.get_rank()


def _refused(out, backend, run, err):
    """Record gloo's own refusal of ``run`` (``_gloo_refusal``) in
    ``out``; re-raise anything else, and under NCCL everything."""
    kind = _gloo_refusal(err) if backend == "gloo" else None
    if kind is None:
        raise err
    out["refused"].append({"run": run, "rank": out["rank"], "kind": kind,
                           "error": str(err)[:400]})


def mesh_rank(out_dir, world, runs, backend, batch=BATCH):
    """The mesh DLRM's rank body, 32(b) (two gloo ranks on the one card)
    and 35(a) (four NCCL ranks, one a card): for each of ``runs``
    (``[name, mesh shape, table_parallel, table_exchange, overlap]``)
    the run_random.sh DLRM at full width, f32 compute, global batch
    ``batch``, MESH_STEPS steps, with no kernel launch (kernels are off
    under a mesh of more than one rank); then the exchange alone on the
    first batch (a table-parallel run's lookup and exchange, or the
    replicas' gather of every rank's ids and row gradients).  Under gloo
    a collective it refuses on CUDA tensors (``_gloo_refusal``) is
    recorded and the rest runs; any other error raises, and under NCCL
    every error."""
    from dlrm_flexflow_tpu_torch.parallel import make_mesh
    from dlrm_flexflow_tpu_torch.parallel.collectives import gather_cat
    from dlrm_flexflow_tpu_torch.parallel.table_exchange import (
        table_parallel_lookup)
    rank = _rank_group(world, backend)
    inputs, labels = _epoch_data(MESH_STEPS, batch)
    touched = _touched(inputs)
    out = {"rank": rank, "runs": {}, "refused": []}
    for name, shape, tp, xmode, overlap in runs:
        mesh = make_mesh(shape)
        model, state, _ = _mesh_dlrm(mesh, "float32", tp, xmode, overlap,
                                     batch)
        reset_counts()
        try:
            state, losses, wall = _mesh_steps(model, state, inputs, labels)
        except RuntimeError as e:
            _refused(out, backend, name, e)
            del model, state
            _free()
            continue
        launches = read_counts()
        if any(launches.values()):
            raise AssertionError(f"{name}: kernels launched under a mesh "
                                 f"of {world} ranks: {launches}")
        op = model.get_op("emb_bot" if overlap == "on" else "emb")
        table = state.params[op.name]["embedding"]  # the rank's tables
        t_loc = table.shape[0]
        first = mesh.coords.get("model", 0) * t_loc if tp else 0
        shard = batch // shape.get("data", 1)
        lo = mesh.coords.get("data", 0) * shard
        ids = torch.from_numpy(inputs["sparse"][0][lo:lo + shard]).cuda()
        grads = torch.zeros(ids.numel(), DIM, device="cuda")
        ex = []
        for _ in range(8):  # the exchange alone, on the first batch
            t0 = time.perf_counter()
            if tp:
                table_parallel_lookup(table, ids, mesh, "sum", xmode)
            else:
                gather_cat(ids.reshape(-1), mesh, ("data",))
                gather_cat(grads, mesh, ("data",))
            torch.cuda.synchronize()
            ex.append((time.perf_counter() - t0) * 1e3)
        rows = {first + j: table[j][torch.from_numpy(
            touched[first + j]).cuda()].cpu() for j in range(t_loc)}
        mlp = {f"{o}/{k}": v.detach().cpu() for o, d in state.params.items()
               for k, v in d.items() if k != "embedding"}
        out["runs"][name] = {
            "losses": losses, "step_wall_ms": wall,
            "exchange_ms": float(np.median(ex)),
            "local_tables": list(table.shape), "launches": launches,
            "checksums": {first + j: float(table[j].double().sum())
                          for j in range(t_loc)}}
        torch.save({"rows": rows, "mlp": mlp},
                   os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        del model, state, table, grads
        _free()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _seq_qkv():
    """q, k and v at RING_SHAPE from seed 11, on this process's card."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    return tuple(torch.randn(RING_SHAPE, generator=gen, device="cuda")
                 for _ in range(3))


def _seq_attention(out_dir, world, mesh, backend, kind):
    """Sequence-parallel attention (``kind`` "ring" or "ulysses") at
    RING_SHAPE on ``mesh``, causal: a warm call, then one timed; rank 0
    saves the output.  Under gloo a refusal is recorded (``_refused``);
    any other error raises, and under NCCL every error."""
    from dlrm_flexflow_tpu_torch.parallel import make_mesh
    from dlrm_flexflow_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)
    from dlrm_flexflow_tpu_torch.parallel.ulysses import (
        ulysses_attention_sharded)
    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded}[kind]
    rank = _rank_group(world, backend)
    out = {"rank": rank, "refused": []}
    q, k, v = _seq_qkv()
    smesh = make_mesh(mesh)
    try:
        fn(q, k, v, smesh, causal=True)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(q, k, v, smesh, causal=True)
        torch.cuda.synchronize()
        out[f"{kind}_ms"] = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            torch.save(o.cpu(), os.path.join(out_dir, f"{kind}.pt"))
    except RuntimeError as e:
        _refused(out, backend, f"{kind}_attention", e)
    with open(os.path.join(out_dir, f"{kind}{rank}.json"), "w") as f:
        json.dump(out, f)


def ring_rank(out_dir, world, mesh, backend):
    """Ring attention's rank body (``parallel/ring_attention.py``), 32(b)
    on {"seq": 2} in a group of its own, since gloo's TCP transport may
    refuse a send from device memory on its own thread, which aborts the
    process (``std::terminate``) where the caller cannot catch it; 35(b)
    on {"seq": 4}."""
    _seq_attention(out_dir, world, mesh, backend, "ring")


def ulysses_rank(out_dir, world, mesh, backend):
    """Ulysses attention's rank body (``parallel/ulysses.py``, its
    head/sequence all-to-all), 35(b) on {"seq": 4}."""
    _seq_attention(out_dir, world, mesh, backend, "ulysses")


def seq_rank(out_dir, world, mesh, backend):
    """35(b)'s group: ``ring_rank`` then ``ulysses_rank``."""
    ring_rank(out_dir, world, mesh, backend)
    ulysses_rank(out_dir, world, mesh, backend)


def _ring_group(out_dir):
    """Run ring_rank's group (32(b)); returns its ranks' records, or, when
    a rank died of gloo's own refusal (the abort ``ring_rank`` names), a
    record of that refusal for each such rank.  The abort is accepted
    only when the other rank shows no fault of its own: its log holds
    gloo's closed connection, or no traceback and no abort (it was
    stopped while waiting).  Any other failure raises."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    try:
        fdist.launch("chip_smoke:ring_rank", 2, kwargs={
            "out_dir": out_dir, "world": 2, "mesh": {"seq": 2},
            "backend": "gloo"}, backend="gloo", timeout_s=300, threads=4)
    except RuntimeError as e:
        kind = _gloo_refusal(e)
        if kind != "cuda_pointer":
            raise
        tails = {int(t.split(" ", 1)[0]): t.split("---\n", 1)[-1]
                 for t in str(e).split("--- rank ")[1:]}
        aborted = [r for r, t in tails.items() if "Bad address" in t]
        if not aborted or len(tails) != 2 or any(
                "Connection closed by peer" not in t
                and ("Traceback" in t or "terminate called" in t
                     or "Fatal Python error" in t)
                for r, t in tails.items() if r not in aborted):
            raise
        return [{"rank": r, "aborted": True, "refused": [{
            "run": "ring_attention", "rank": r, "kind": kind,
            "error": "the rank aborted: " + tails[r][-400:]}]}
            for r in aborted]
    return [json.load(open(os.path.join(out_dir, f"ring{r}.json")))
            for r in range(2)]


def _check_mesh_runs(tag, out_dir, world, runs, batch, ranks):
    """Hold each of ``runs`` that every rank completed (``mesh_rank``'s
    records ``ranks``) against the port's one-process run on this card
    on the same batches: every rank's losses at rtol 1e-5, its touched
    rows and MLP parameters at rtol 1e-5 / atol 1e-6, its table sums.
    Returns each run's walls and errors."""
    inputs, labels = _epoch_data(MESH_STEPS, batch)
    touched = _touched(inputs)
    refs, results = {}, {}
    for name, shape, tp, xmode, overlap in runs:
        if name not in ranks[0]["runs"]:
            continue
        if overlap not in refs:  # one reference for each graph
            model, state, _ = _mesh_dlrm(False, "float32", overlap=overlap,
                                         batch=batch)
            each = []
            state, losses, wall = _mesh_steps(model, state, inputs, labels,
                                              each)
            op = "emb_bot" if overlap == "on" else "emb"
            refs[overlap] = (model, state, losses, each,
                             state.params[op]["embedding"])
        _, state, losses, each, table = refs[overlap]
        err = 0.0
        for r in range(world):
            got = ranks[r]["runs"][name]
            np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
            saved = torch.load(os.path.join(out_dir, f"{name}.rank{r}.pt"))
            for t, rows in saved["rows"].items():
                want = table[t][torch.from_numpy(touched[t]).cuda()].cpu()
                np.testing.assert_allclose(rows.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-6)
                err = max(err, float((rows - want).abs().max()))
            for key, v in saved["mlp"].items():
                o, k = key.split("/")
                want = state.params[o][k].detach().cpu()
                np.testing.assert_allclose(v.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-6)
                err = max(err, float((v - want).abs().max()))
            for t, cs in got["checksums"].items():
                want = float(table[int(t)].double().sum())
                if abs(cs - want) > 1e-5 * max(abs(want), 1.0):
                    raise AssertionError(f"{tag} {name}: table {t} sum "
                                         f"{cs} vs {want} on rank {r}")
        walls = [x["runs"][name]["step_wall_ms"] for x in ranks]
        exch = [x["runs"][name]["exchange_ms"] for x in ranks]
        results[name] = {
            "mesh": shape, "table_parallel": tp, "exchange": xmode,
            "overlap": overlap, "losses": ranks[0]["runs"][name]["losses"],
            "max_abs_err": err,
            "local_tables": ranks[0]["runs"][name]["local_tables"],
            "launches": [sum(x["runs"][name]["launches"].values())
                         for x in ranks],
            "step_wall_ms": max(walls), "step_wall_ms_by_rank": walls,
            # one process: its first step eager, the second captured,
            # then replays; the last step is the graphed one
            "one_process_step_wall_ms": float(np.median(each)),
            "one_process_step_walls_ms": each,
            "exchange_ms": max(exch), "exchange_ms_by_rank": exch,
            "exchange_share_of_step": max(exch) / max(walls),
            "samples_per_s": batch / (max(walls) / 1e3),
            "one_process_graphed_samples_per_s": batch / (each[-1] / 1e3)}
    del refs
    _free()
    return results


def _check_seq(tag, out_dir, ranks, kind):
    """Rank 0's sequence-parallel output (``kind``) against the port's
    sdpa on this card at 2e-5; None when gloo refused it."""
    from dlrm_flexflow_tpu_torch.ops.attention import sdpa
    path = os.path.join(out_dir, f"{kind}.pt")
    if not os.path.exists(path):
        return None
    q, k, v = _seq_qkv()
    sdpa(q, k, v, causal=True)  # warm, as the ranks' calls are
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sdpa(q, k, v, causal=True)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    got = torch.load(path).cuda()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
        raise AssertionError(f"{tag} {kind} attention: max err {err}")
    row = {"shape": list(RING_SHAPE), "max_abs_err": err,
           f"{kind}_ms": max(x.get(f"{kind}_ms", 0.0) for x in ranks),
           "one_process_sdpa_ms": dense_ms}
    del q, k, v, want, got
    _free()
    return row


def mesh_two_ranks(card):
    """32(b): mesh_rank in two processes on the one card over gloo (NCCL
    refuses two ranks on one device), each run held against the port's
    one-process run on the card at rtol 1e-5, on the ranks' batches;
    ring attention against sdpa at 2e-5.  The allgather and overlapped
    runs must complete on both ranks; a run is left out only for a
    refusal of gloo's own, which is logged with its rank."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    out_dir = tempfile.mkdtemp(prefix="mesh2-")
    t0 = time.perf_counter()
    fdist.launch("chip_smoke:mesh_rank", 2, kwargs={
        "out_dir": out_dir, "world": 2, "runs": MESH2_RUNS,
        "backend": "gloo"}, backend="gloo", timeout_s=420, threads=4)
    group_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(2)]
    rings = _ring_group(out_dir)
    refused = [x for r in ranks + rings for x in r["refused"]]
    for x in refused:
        log({"phase": "mesh_two_ranks", "gloo_refused": x})
        # a closed connection is a refusal only as the echo of the other
        # rank's own refusal of the same run
        other = [y for r in ranks + rings if r["rank"] != x["rank"]
                 for y in r["refused"]]
        if x["kind"] == "peer_closed" and not any(
                y["run"] == x["run"] and y["kind"] != "peer_closed"
                for y in other):
            raise AssertionError(f"32(b) {x['run']}: rank {x['rank']}'s "
                                 f"peer closed with no refusal of its own")
    for name in ("allgather", "overlap_allgather"):  # gloo takes both
        if any(name not in x["runs"] for x in ranks):
            raise AssertionError(f"32(b): the {name} run did not complete "
                                 "on both ranks")
    results = _check_mesh_runs("32(b)", out_dir, 2, MESH2_RUNS, BATCH,
                               ranks)
    ring = _check_seq("32(b)", out_dir, rings, "ring")
    if ring is not None:
        results["ring_attention"] = ring
    shutil.rmtree(out_dir, ignore_errors=True)
    refused = sorted({x["run"] for x in refused})
    log({"phase": "mesh_two_ranks", "card": card, "backend": "gloo",
         "group_wall_s": round(group_s, 3), **results,
         "gloo_refused": refused,
         "note": "two gloo ranks on one card: these walls say nothing of "
                 "NCCL over NVLink between cards"})
    return results, refused


# --------------------------------------------------------------- phase 33
#: phase 33: the rank that never reaches the second save's barrier sleeps
#: HANG_S there; the survivor's barrier deadline is DEADLINE_S
ELASTIC_DEADLINE_S, ELASTIC_HANG_S = 20.0, 21.0
ELASTIC_REQUESTS = 32


def _elastic_requests():
    """Phase 33's 32 requests of 1-256 rows (seed 33), uniform ids."""
    rng = np.random.default_rng(33)
    out = []
    for n in rng.integers(1, BATCH + 1, size=ELASTIC_REQUESTS):
        out.append({"dense": rng.standard_normal((int(n), BOT)).astype(
                        np.float32),
                    "sparse": rng.integers(0, ROWS, size=(int(n), TABLES, 1))})
    return out


def _digests(state, blocks=None):
    """SHA-256 of every leaf's bytes (``checkpoint._host``), hashed in
    parallel threads: the table ``emb/embedding`` as ``blocks`` of whole
    tables (``(lo, hi)``; default one block, ``[]`` none), every other
    leaf whole."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from dlrm_flexflow_tpu_torch import checkpoint as ckpt
    flat = ckpt._flat_state(state)
    table = flat.pop("params/emb/embedding")
    jobs = {k: ckpt._host(v) for k, v in flat.items()}
    for lo, hi in [(0, table.shape[0])] if blocks is None else blocks:
        jobs[f"params/emb/embedding[{lo}:{hi}]"] = ckpt._host(table[lo:hi])
    with ThreadPoolExecutor(4) as pool:
        hashed = pool.map(lambda a: hashlib.sha256(
            np.ascontiguousarray(a).data).hexdigest(), jobs.values())
        return dict(zip(jobs, hashed))


def _ckpt_stages(events):
    """The seconds of each checkpoint stage span in ``events``: the
    children of ``ckpt.save`` / ``ckpt.restore`` (``d2h``, ``write``,
    ``fsync``, ``sha256``, a barrier as ``barrier_<phase>``; ``read``,
    ``reassemble``, ``h2d``)."""
    spans = [e for e in events if e["type"] == "span"]
    top = {e["span_id"] for e in spans
           if e["name"] in ("ckpt.save", "ckpt.restore")}
    stages = {}
    for e in spans:
        if e.get("parent_id") in top and e["name"].startswith("ckpt."):
            name = e["name"][len("ckpt."):]
            if name == "barrier":
                name += "_" + e["attrs"]["phase"]
            stages[name] = stages.get(name, 0.0) + e["dur_us"] / 1e6
    return stages


def elastic_rank(root, world, mesh, backend, batch=BATCH, serve=True,
                 resume=None):
    """The elastic rank body, 33 (two gloo ranks on the one card) and
    35(e) (four NCCL ranks, one a card): (1) the table-parallel DLRM at
    full width on ``mesh`` (``{"data": 1, "model": world}``) with
    table_exchange="allgather", global batch ``batch``, MESH_STEPS steps;
    (2) a podshard commit through CheckpointManager(multihost=None), each
    rank's walls by stage; with ``serve`` (33) (7) the mesh engine over
    that state serving ELASTIC_REQUESTS requests (rank 0 the leader, the
    others following); one more step, then (3) a second save at which
    the last rank hangs at the barrier (host_hang@barrier): every other
    rank must raise FleetBarrierTimeout naming it.  With ``resume``
    (35(e): ``{"store", "mesh", "batch"}``) the survivors then
    recover_and_resume at world - 1 at the new store, the checkpoint
    resharded onto ``resume["mesh"]`` at its global batch, and take
    MESH_STEPS steps on ``_resume_data``.  No kernel may launch."""
    import hashlib

    from dlrm_flexflow_tpu_torch.elastic import recover_and_resume
    from dlrm_flexflow_tpu_torch.parallel import make_mesh
    from dlrm_flexflow_tpu_torch.resilience import (FleetBarrierTimeout,
                                                    HostLost)
    rank = _rank_group(world, backend)
    lost = world - 1
    inputs, labels = _epoch_data(2 * MESH_STEPS, batch)
    model, state, _ = _mesh_dlrm(make_mesh(mesh), "float32", True,
                                 "allgather", batch=batch)
    out = {"rank": rank}
    reset_counts()
    walls = []
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        state, mets = model.train_step(
            state, {k: v[i] for k, v in inputs.items()}, labels[i])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        out.setdefault("losses", []).append(float(mets["loss"]))
    out["step_wall_ms"] = walls
    mgr = CheckpointManager(os.path.join(root, "ckpt"),
                            barrier_timeout_s=ELASTIC_DEADLINE_S)
    t0 = time.perf_counter()
    with tele.event_log() as elog:
        path = mgr.save(state, model=model,
                        extra={"batches_done": MESH_STEPS})
        out["save_wall_s"] = time.perf_counter() - t0
        out["save_stages_s"] = _ckpt_stages(elog.events())
    out["path"] = path
    out["bytes"] = os.path.getsize(os.path.join(path,
                                                f"shard-p{rank:03d}.npz"))
    # what the restore must give back: this rank's block of the tables
    # and the replicated leaves, by hash
    table = state.params["emb"]["embedding"]
    t_loc = table.shape[0]
    h = hashlib.sha256(np.ascontiguousarray(
        table.detach().cpu().numpy()).data).hexdigest()
    out["digests"] = {f"params/emb/embedding[{rank * t_loc}:"
                      f"{(rank + 1) * t_loc}]": h}
    if rank == 0:  # the leaves no mesh shards
        out["digests"].update(_digests(state, blocks=[]))
    if serve:  # (7) serving on the mesh, through the leader's broadcast
        engine = InferenceEngine(model, state)
        out["engine"] = {"buckets": engine.buckets,
                         "sharded": engine._mesh_sharded}
        if engine.is_leader:
            outs, dwalls = [], []
            for r in _elastic_requests():
                t0 = time.perf_counter()
                outs.append(engine.predict(r))
                dwalls.append((time.perf_counter() - t0) * 1e3)
            engine.close()
            np.save(os.path.join(root, "mesh_outputs.npy"),
                    np.concatenate(outs))
            out["dispatch_wall_ms"] = dwalls
        else:
            out["followed"] = engine.follow()
        del engine
    out["launches"] = read_counts()  # the mesh launches none
    state, _ = model.train_step(
        state, {k: v[MESH_STEPS] for k, v in inputs.items()},
        labels[MESH_STEPS])
    torch.cuda.synchronize()
    if rank == lost:  # lost at the next save's barrier
        os.environ["FF_HANG_S"] = str(ELASTIC_HANG_S)
        faultinject.install("host_hang@barrier")
        try:
            mgr.save(state, model=model)
            out["hang"] = "returned"
        except HostLost as e:
            out["hang"] = str(e)
        finally:
            faultinject.clear()
    else:
        os.environ["FF_FLIGHT_DIR"] = os.path.join(root, f"flight{rank}")
        t0 = time.perf_counter()
        with tele.event_log() as elog:
            try:
                mgr.save(state, model=model)
                out["timeout"] = None
            except FleetBarrierTimeout as e:
                out["timeout"] = {"missing": list(e.missing),
                                  "message": str(e)}
            out["timeout_wall_s"] = time.perf_counter() - t0
            out["recovery_events"] = [
                e for e in elog.events() if e["type"] == "recovery"]
        out["flight"] = os.listdir(os.environ["FF_FLIGHT_DIR"])
    if resume is not None and rank != lost:
        del model, state, table
        _free()
        t0 = time.perf_counter()
        with tele.event_log() as elog:
            model, state, extra, path = recover_and_resume(
                os.path.join(root, "ckpt"), lambda: _mesh_model(
                    make_mesh(resume["mesh"]), "float32",
                    batch=resume["batch"])[0],
                coordinator_address=resume["store"],
                num_processes=world - 1, process_id=rank)
            torch.cuda.synchronize()
            out["recover_wall_s"] = time.perf_counter() - t0
            out["recover_events"] = [(e["type"], e["phase"])
                                     for e in elog.events()
                                     if e["type"] in ("elastic", "recovery")]
            out["restore_stages_s"] = _ckpt_stages(elog.events())
        out["resumed_from"] = {"path": path, "step": int(state.step),
                               "extra": extra}
        out["restored_digests"] = _digests(
            state, [(r * t_loc, (r + 1) * t_loc) for r in range(world)])
        rin, rlab = _resume_data(resume["batch"])
        reset_counts()
        out["resumed_losses"], out["resumed_step_wall_ms"] = [], []
        for i in range(MESH_STEPS):
            t0 = time.perf_counter()
            state, mets = model.train_step(
                state, {k: v[i] for k, v in rin.items()}, rlab[i])
            out["resumed_losses"].append(float(mets["loss"]))
            out["resumed_step_wall_ms"].append(
                (time.perf_counter() - t0) * 1e3)
        out["resumed_launches"] = read_counts()
        out["resumed_mesh"] = model.mesh.shape
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _resume_data(batch):
    """35(e)'s batches after the recovery: MESH_STEPS batches of
    ``batch`` rows (seed 35)."""
    return _epoch_data(MESH_STEPS, batch, seed=35)


def _elastic_model():
    """33's one-card model: the classic run_random.sh graph at f32 compute
    with no mesh (B2 on the row-sparse path), compiled, not placed."""
    cfg = DLRMConfig(embedding_size=[ROWS] * TABLES)
    return build_dlrm(cfg, FFConfig(batch_size=BATCH,
                                    compute_dtype="float32")).compile(
        optimizer=SGDOptimizer(lr=0.01), loss_type="mean_squared_error",
        metrics=("accuracy", "mean_squared_error"))


def elastic(card, root):
    """Phase 33 in ``root``: train on two ranks, commit a podshard, lose
    rank 1 at the next save's barrier, recover on one card
    (recover_and_resume), serve from the checkpoint, train on; each
    result checked (module docstring).  Returns (row, launch counts of the
    resumed steps)."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    from dlrm_flexflow_tpu_torch.elastic import recover_and_resume
    from dlrm_flexflow_tpu_torch.resilience import latest_checkpoint
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fdist.launch("chip_smoke:elastic_rank", 2, kwargs={
        "root": root, "world": 2, "mesh": {"data": 1, "model": 2},
        "backend": "gloo"}, backend="gloo", timeout_s=300, threads=4)
    group_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json")))
             for r in range(2)]
    r0, r1 = ranks
    ckpt_dir = os.path.join(root, "ckpt")
    newest = latest_checkpoint(ckpt_dir)
    checks = {
        "commit": r0["path"] == r1["path"] == newest
        and os.path.basename(newest) == f"ckpt-{MESH_STEPS}"
        and not verify_checkpoint(newest),
        "shards": sorted(n for n in os.listdir(newest)
                         if n.startswith("shard-")) == [
            "shard-p000.json", "shard-p000.npz", "shard-p001.json",
            "shard-p001.npz"],
        "timeout_names_p1": (r0["timeout"] or {}).get("missing") == ["p1"],
        "timeout_within_deadline": ELASTIC_DEADLINE_S
        <= r0["timeout_wall_s"] < ELASTIC_DEADLINE_S + 10,
        "recovery_event": [e["phase"] for e in r0["recovery_events"]]
        == ["barrier_timeout"],
        "flight_record": len(r0["flight"]) == 1,
        "rank1_lost": r1["hang"].startswith("injected host hang"),
        "no_launch_in_ranks": not any(any(x["launches"].values())
                                      for x in ranks),
        "followed": r1["followed"] == len(r0["engine"]["buckets"]) + sum(
            -(-int(r["dense"].shape[0]) // r0["engine"]["buckets"][-1])
            for r in _elastic_requests()),
        "sharded_engine": r0["engine"]["sharded"],
    }
    # (4) recover on one card: no mesh, one survivor (no bootstrap)
    t0 = time.perf_counter()
    with tele.event_log() as elog:
        model, state, extra, path = recover_and_resume(ckpt_dir,
                                                       _elastic_model)
        events = [e for e in elog.events()
                  if e["type"] in ("elastic", "recovery")]
        restore_stages = _ckpt_stages(elog.events())
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    t_loc = TABLES // 2
    digests = _digests(state, [(0, t_loc), (t_loc, TABLES)])
    want = {**r0["digests"], **r1["digests"]}
    checks["restore_bit_for_bit"] = digests == want
    checks["resumed_at_step"] = (int(state.step) == MESH_STEPS
                                 and path == newest
                                 and extra == {"batches_done": MESH_STEPS})
    checks["events"] = [(e["type"], e["phase"]) for e in events] == [
        ("elastic", "reshard"), ("recovery", "resume")]
    # (6) serve from the checkpoint, bit for bit the engine built from the
    # restored state; the mesh's answers within 1e-6 of it
    requests = _elastic_requests()
    direct = InferenceEngine(model, state)
    outs, dwalls = [], []
    for r in requests:
        t0 = time.perf_counter()
        outs.append(direct.predict(r))
        dwalls.append((time.perf_counter() - t0) * 1e3)
    from_ckpt = InferenceEngine.from_checkpoint(model, ckpt_dir,
                                                on_mesh_change="reshard")
    same = all(np.array_equal(from_ckpt.predict(r), o)
               for r, o in zip(requests, outs))
    checks["from_checkpoint_bit_for_bit"] = same and (
        from_ckpt.buckets == direct.buckets == list(BUCKETS))
    mesh_out = np.load(os.path.join(root, "mesh_outputs.npy"))
    mesh_err = float(np.abs(mesh_out - np.concatenate(outs)).max())
    checks["mesh_serving_within_1e-6"] = mesh_err <= 1e-6
    del direct, from_ckpt
    _free()
    # (5) train on: MESH_STEPS graphed steps through B2, one call a step,
    # against a never-killed one-process run of 2 * MESH_STEPS steps
    inputs, labels = _epoch_data(2 * MESH_STEPS)
    reset_counts()  # the main path: the resumed steps
    walls, losses = [], []
    for i in range(MESH_STEPS, 2 * MESH_STEPS):
        t0 = time.perf_counter()
        state, mets = model.train_step(
            state, {k: v[i] for k, v in inputs.items()}, labels[i])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(mets["loss"]))
    counts = read_counts()
    captures = model.graph_captures
    del model, state
    _free()
    base = _elastic_model()
    bstate = base.init(seed=0)
    blosses = []
    for i in range(2 * MESH_STEPS):
        bstate, mets = base.train_step(
            bstate, {k: v[i] for k, v in inputs.items()}, labels[i])
        blosses.append(float(mets["loss"]))
    del base, bstate
    _free()
    rel = [abs(a - b) / abs(b) for a, b in
           zip(r0["losses"] + losses, blosses)]
    checks["resumed_losses_rtol_1e-5"] = max(rel[MESH_STEPS:]) <= 1e-5
    checks["mesh_losses_rtol_1e-5"] = max(rel[:MESH_STEPS]) <= 1e-5
    checks["b2_one_call_a_step"] = (counts["row_update"] == MESH_STEPS
                                    == counts["row_update_prep"])
    checks["captured"] = captures >= 1
    row = {"phase": "elastic", "card": card, "backend": "gloo",
           "group_wall_s": group_s,
           "save_wall_s": [x["save_wall_s"] for x in ranks],
           "save_stages_s": [x["save_stages_s"] for x in ranks],
           "bytes_per_rank": [x["bytes"] for x in ranks],
           "barrier_timeout_wall_s": r0["timeout_wall_s"],
           "timeout_message": r0["timeout"]["message"]
           if r0["timeout"] else None,
           "restore_wall_s": recover_s, "restore_stages_s": restore_stages,
           "mesh_step_wall_ms": r0["step_wall_ms"],
           "resumed_step_wall_ms": walls, "captures": captures,
           "losses": {"mesh": r0["losses"], "resumed": losses,
                      "never_killed": blosses},
           "max_rel_loss_diff": max(rel), "b2_launches": counts,
           "mesh_engine": r0["engine"], "mesh_serving_max_abs_err": mesh_err,
           "dispatch_wall_ms_median": {
               "mesh": float(np.median(r0["dispatch_wall_ms"])),
               "one_process": float(np.median(dwalls))},
           "checks": checks,
           "phase_wall_s": time.perf_counter() - t_phase,
           "note": "two gloo ranks on one card: the mesh walls say nothing "
                   "of NCCL between cards"}
    log(row)
    if not all(checks.values()):
        raise AssertionError(f"33: checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return row, counts


def elastic_phase(card):
    """Phase 33 in a directory of its own beside this script, removed
    afterwards (two 2.05 GB checkpoints' worth of shard files at most)."""
    root = tempfile.mkdtemp(prefix=".elastic-",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        return elastic(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

# --------------------------------------------------------------- phase 34
#: 34(a): steps timed by part after the commit; 34(b): requests a mode
HETERO_MESH_TIMED = 3
QUANT_MESH_REQUESTS = 32
#: 34(c): the tool's search budget and device count
POD_BUDGET, POD_DEVICES = 50, 8


def _sha(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).data).hexdigest()


def hetero_mesh_rank(root, world, mesh, backend):
    """The hetero mesh rank body, 34(a) (two gloo ranks on the one card,
    ``{"data": 2}``) and 35(c) (four NCCL ranks, one a card, ``{"data":
    4}``; the leader's gathers and scatters on ``distributed.host_group``'s
    gloo group beside NCCL): phase 28's all-host Kaggle DLRM on ``mesh``,
    HETERO_STEPS global batches of 256, the native lookups and deposits
    on rank 0 (the owner) only; a podshard save; HETERO_MESH_TIMED more
    steps under hetero.timing() (each part waits for the card first)."""
    import torch.distributed as dist

    from dlrm_flexflow_tpu_torch.parallel import make_mesh
    rank = _rank_group(world, backend)
    t0 = time.perf_counter()
    model = _kaggle(range(len(KAGGLE_TABLES)), make_mesh(mesh))
    state = model.init(seed=0)
    out = {"rank": rank, "init_s": time.perf_counter() - t0,
           "held_bytes": sum(int(a.nbytes)
                             for a in _host_tables(model).values())}
    batches = list(_kaggle_loader())
    reset_counts()
    losses, walls = [], []
    with _numpy_branch_off():
        for x, y in batches:
            t0 = time.perf_counter()
            state, mets = model.train_step(state, x, y)
            losses.append(float(mets["loss"]))
            walls.append((time.perf_counter() - t0) * 1e3)
    out["launches"] = read_counts()
    out["losses"], out["step_wall_ms"] = losses, walls
    out["handles"] = {op.name: float(state.params[op.name]["handle"])
                      for op in model._hetero_ops}
    out["digests"] = {k: _sha(v) for k, v in _host_tables(model).items()}
    path = os.path.join(root, "pod")
    if rank == 0:
        os.makedirs(path, exist_ok=True)
    dist.barrier()
    t0 = time.perf_counter()
    save_checkpoint(path, state, model=model, multihost=True)
    out["save_s"] = time.perf_counter() - t0
    dist.barrier()
    out["shard_bytes"] = os.path.getsize(
        os.path.join(path, f"shard-p{rank:03d}.npz"))
    with _numpy_branch_off(), hetero_module.timing() as parts:
        t0 = time.perf_counter()
        for x, y in batches[:HETERO_MESH_TIMED]:
            state, mets = model.train_step(state, x, y)
        float(mets["loss"])
        wall = (time.perf_counter() - t0) * 1e3 / HETERO_MESH_TIMED
    out["split_ms"] = {k: v * 1e3 / HETERO_MESH_TIMED
                       for k, v in parts.items()}
    out["split_ms"]["rest"] = wall - sum(out["split_ms"].values())
    out["timed_step_ms"] = wall
    with open(os.path.join(root, f"hetero{rank}.json"), "w") as f:
        json.dump(out, f)


def hetero_mesh(card, root, world=2, mesh=None, backend="gloo",
                tag="34(a)"):
    """34(a) (35(c) with four NCCL ranks): hetero_mesh_rank in ``world``
    processes, held against the same model in this process on its card
    from the same weights and batches (losses rtol 1e-5, the owner's
    host tables and the handles within 1e-6), no launch in the ranks,
    the host tables on rank 0 only; the podshard restored on one card
    bit for bit the owner's tables, with the other ranks' shard files
    holding none."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    mesh = mesh or {"data": world}
    t0 = time.perf_counter()
    fdist.launch("chip_smoke:hetero_mesh_rank", world, kwargs={
        "root": root, "world": world, "mesh": mesh, "backend": backend},
        backend=None if backend == "nccl" else backend, timeout_s=420,
        threads=4)
    group_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(root, f"hetero{r}.json")))
             for r in range(world)]
    r0, others = ranks[0], ranks[1:]
    model = _kaggle(range(len(KAGGLE_TABLES)))
    state = model.init(seed=0)
    host_bytes = sum(4 * op.num_entries * op.out_dim
                     for op in model._hetero_ops)
    losses, walls = [], []
    with _numpy_branch_off():
        for x, y in _kaggle_loader():
            t0 = time.perf_counter()
            state, mets = model.train_step(state, x, y)
            losses.append(float(mets["loss"]))
            walls.append((time.perf_counter() - t0) * 1e3)
    want = _host_tables(model)  # rebound by each step: a snapshot
    handles = {op.name: float(state.params[op.name]["handle"])
               for op in model._hetero_ops}
    t0 = time.perf_counter()
    back = restore_checkpoint(os.path.join(root, "pod"), model,
                              on_mesh_change="reshard")
    restore_s = time.perf_counter() - t0
    got = _host_tables(model)
    table_err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    handle_err = max(abs(float(back.params[k]["handle"]) - handles[k])
                     for k in handles)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                       losses))
    p_host = []
    for r in range(1, world):
        with np.load(os.path.join(root, "pod", f"shard-p{r:03d}.npz")) as f:
            p_host += [k for k in f.files if k.startswith("host_tables/")]
    checks = {
        "losses_rtol_1e-5": loss_err <= 1e-5,
        "ranks_agree": all(x["losses"] == r0["losses"] for x in others),
        "tables_1e-6": table_err <= 1e-6,
        "handles_1e-6": handle_err <= 1e-6
        and max(abs(r0["handles"][k] - handles[k]) for k in handles)
        <= 1e-6,
        "no_launch_in_ranks": not any(any(x["launches"].values())
                                      for x in ranks),
        "tables_on_rank0_only": r0["held_bytes"] == host_bytes
        and all(x["held_bytes"] == 0 and x["digests"] == {}
                for x in others),
        "restore_bit_for_bit": {k: _sha(v) for k, v in got.items()}
        == r0["digests"] and int(back.step) == HETERO_STEPS,
        "other_shards_hold_no_table": p_host == [],
        "finite": bool(np.all(np.isfinite(r0["losses"]))),
    }
    row = {"phase": "hetero_mesh" if backend == "gloo" else "cards_hetero",
           "card": card, "mesh": mesh, "backend": backend,
           "group_wall_s": group_s,
           "init_s": [x["init_s"] for x in ranks],
           "losses": {"mesh": r0["losses"], "one_process": losses},
           "max_rel_loss_diff": loss_err,
           "max_abs_table_diff": table_err, "max_abs_handle_diff":
               handle_err, "held_bytes": [x["held_bytes"] for x in ranks],
           "shard_bytes": [x["shard_bytes"] for x in ranks],
           "save_s": [x["save_s"] for x in ranks], "restore_s": restore_s,
           "step_wall_ms_median": [float(np.median(x["step_wall_ms"]))
                                   for x in ranks],
           "one_process_step_wall_ms_median": float(np.median(walls)),
           "timed_step_ms": [x["timed_step_ms"] for x in ranks],
           "split_ms": {f"rank{r}": x["split_ms"]
                        for r, x in enumerate(ranks)},
           "launches": [x["launches"] for x in ranks], "checks": checks,
           "note": (f"{world} gloo ranks on one card and one host: the "
                    "gathers and scatters say nothing of a network "
                    "between hosts") if backend == "gloo" else
                   (f"{world} NCCL ranks, one a card, on one host: the "
                    "leader's gathers and scatters run on a gloo group "
                    "on the host")}
    log(row)
    del model, state, back, want, got
    _free()
    if not all(checks.values()):
        raise AssertionError(f"{tag}: checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def _quant_mesh_requests():
    """34(b)'s QUANT_MESH_REQUESTS requests of 1-256 rows (seed 34)."""
    rng = np.random.default_rng(34)
    return [{"dense": rng.standard_normal((int(n), BOT)).astype(np.float32),
             "sparse": rng.integers(0, ROWS, size=(int(n), TABLES, 1))}
            for n in rng.integers(1, BATCH + 1, size=QUANT_MESH_REQUESTS)]


def _serve_all(engine, requests):
    outs, walls = [], []
    for r in requests:
        t0 = time.perf_counter()
        outs.append(engine.predict(r))
        walls.append((time.perf_counter() - t0) * 1e3)
    return np.concatenate(outs), walls


#: 35(d): the leader stays this long after its last answer before it
#: leaves without its stop (its last bucket's collectives end on every
#: rank first); the group's collective deadline then
LEADER_LINGER_S, LEAVE_DEADLINE_S = 2.0, 15.0


def quant_mesh_rank(root, world, mesh, backend, leave=False):
    """The quantized mesh engines' rank body, 34(b) (two gloo ranks on the
    one card, ``{"data": 1, "model": 2}``) and 35(d) (four NCCL ranks,
    one a card, ``{"data": 1, "model": 4}``, the buckets broadcast on
    the card): the table-parallel run_random.sh DLRM at full width (f32
    compute) served int8 then bf16 through a mesh engine quantized at
    load (the global tables gathered, quantized and placed under the
    rules): rank 0 serves the requests, the others follow.  With
    ``leave`` the leader leaves the bf16 engine without its stop
    (LEADER_LINGER_S after its last answer) and each follower records
    how its ``follow()`` ended and when."""
    from dlrm_flexflow_tpu_torch.parallel import make_mesh
    rank = _rank_group(world, backend)
    model, state, _ = _mesh_dlrm(make_mesh(mesh), "float32",
                                 table_parallel=True)
    out = {"rank": rank}
    for mode in ("int8", "bf16"):
        stop = not (leave and mode == "bf16")
        reset_counts()
        t0 = time.perf_counter()
        engine = InferenceEngine(model, state, quantize=mode)
        row = {"build_s": time.perf_counter() - t0,
               "bytes_after": engine.quantization["bytes_after"],
               "buckets": engine.buckets, "sharded": engine._mesh_sharded,
               "codes_block": list(engine._params["emb"]["embedding"].shape),
               "scale_rows": (list(engine._params["emb"]["qscale__"].shape)
                              if mode == "int8" else None)}
        if engine.is_leader:
            outs, walls = _serve_all(engine, _quant_mesh_requests())
            row["last_answer_at"] = time.time()
            if stop:
                engine.close()
            else:
                time.sleep(LEADER_LINGER_S)
            np.save(os.path.join(root, f"quant_{mode}.npy"), outs)
            row["dispatch_wall_ms"] = walls
        elif stop:
            row["followed"] = engine.follow()
        else:
            try:
                engine.follow()
                row["left"] = None
            except RuntimeError as e:
                row["left"] = str(e)
                row["followed"] = int(str(e).split(" after ")[1].split()[0])
            row["left_at"] = time.time()
        row["launches"] = read_counts()
        out[mode] = row
        del engine
        _free()
    with open(os.path.join(root, f"quant{rank}.json"), "w") as f:
        json.dump(out, f)


def quant_mesh(card, root, world=2, mesh=None, backend="gloo", tag="34(b)",
               leave=False):
    """34(b) (35(d) with four NCCL ranks): quant_mesh_rank in ``world``
    processes, each mode's answers held against the one-card engine of
    the same mode over the same requests (max abs error 1e-6), the codes
    a rank holds its tables', the int8 scale column whole on each rank,
    no launch in the ranks.  With ``leave`` (a collective deadline of
    LEAVE_DEADLINE_S) every follower of the bf16 engine must leave with
    follow()'s "the leader ..." error within that deadline plus 30 s of
    the leader's last answer."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    mesh = mesh or {"data": 1, "model": world}
    t0 = time.perf_counter()
    fdist.launch("chip_smoke:quant_mesh_rank", world, kwargs={
        "root": root, "world": world, "mesh": mesh, "backend": backend,
        "leave": leave}, backend=None if backend == "nccl" else backend,
        timeout_s=420, threads=4,
        collective_timeout_s=LEAVE_DEADLINE_S if leave else None)
    group_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(root, f"quant{r}.json")))
             for r in range(world)]
    model, state, _ = _mesh_dlrm(False, "float32", table_parallel=True)
    requests = _quant_mesh_requests()
    rows, checks = {}, {}
    for mode in ("int8", "bf16"):
        engine = InferenceEngine(model, state, quantize=mode)
        outs, walls = _serve_all(engine, requests)
        mesh_out = np.load(os.path.join(root, f"quant_{mode}.npy"))
        err = float(np.abs(mesh_out - outs).max())
        a, rest = ranks[0][mode], [x[mode] for x in ranks[1:]]
        n_dispatch = len(a["buckets"]) + sum(
            -(-int(r["dense"].shape[0]) // a["buckets"][-1])
            for r in requests)
        checks[mode] = {
            "answers_1e-6": err <= 1e-6 and mesh_out.shape == outs.shape,
            "bytes_as_one_card": a["bytes_after"]
            == engine.quantization["bytes_after"],
            "codes_block": all(x["codes_block"] == [TABLES // world, ROWS,
                                                    DIM]
                               for x in [a] + rest),
            "scale_whole": mode != "int8"
            or a["scale_rows"] == [TABLES * ROWS, 1],
            "sharded": a["sharded"] and a["buckets"] == list(BUCKETS),
            "followed": all(b["followed"] == n_dispatch for b in rest),
            "no_launch_in_ranks": not any(any(x["launches"].values())
                                          for x in [a] + rest)}
        rows[mode] = {"max_abs_err": err,
                      "bytes_after": a["bytes_after"],
                      "engine_build_s": [x["build_s"] for x in [a] + rest],
                      "dispatch_wall_ms_median": {
                          "mesh": float(np.median(a["dispatch_wall_ms"])),
                          "one_card": float(np.median(walls))}}
        if leave and mode == "bf16":
            left = [b["left_at"] - a["last_answer_at"] for b in rest]
            checks[mode]["followers_left"] = all(
                (b["left"] or "").startswith("follow(): the leader (rank 0)")
                for b in rest) and max(left) < LEAVE_DEADLINE_S + 30
            rows[mode]["followers_left_after_s"] = left
            rows[mode]["follower_error"] = rest[0]["left"]
        del engine
        _free()
    row = {"phase": "quant_mesh" if backend == "gloo" else "cards_serving",
           "card": card, "mesh": mesh, "backend": backend,
           "group_wall_s": group_s, **rows, "checks": checks,
           "note": f"mesh dispatches are eager with a {backend} broadcast "
                   "of each bucket; the one-card engine replays a CUDA "
                   "graph per bucket"}
    log(row)
    del model, state
    _free()
    bad = [f"{m}.{k}" for m, c in checks.items() for k, v in c.items()
           if not v]
    if bad:
        raise AssertionError(f"{tag}: checks failed: {bad}")
    return row


def pod_tool(card, root):
    """34(c): tools/search_tune.py --pod 2x4 --bench sim and --pod auto on
    the card machine, over op_time telemetry drawn for the tool's model
    (seed 34): both exit 0 with one JSON line, the first promotes into
    the ``_2x4pod`` pointer, the second (one process, one card: one flat
    node) into the flat one."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dlrm_flexflow_tpu_torch", "tools", "search_tune.py")
    _, m = tune_tool.build_model(tune_tool.parse_args(["--telemetry", "x"]))
    rng = np.random.default_rng(34)
    tel = os.path.join(root, "op_time.jsonl")
    with open(tel, "w") as f:
        for i, op in enumerate(m.layers):
            sf, sb = (float(x) for x in rng.uniform(1e-6, 1e-3, size=2))
            f.write(json.dumps({"type": "op_time", "ts": float(i),
                                "op": op.name, "forward_s": 3 * sf,
                                "backward_s": 2 * sb, "sim_forward_s": sf,
                                "sim_backward_s": sb}) + "\n")
    del m
    art = os.path.join(root, "artifacts")
    runs, checks = {}, {}
    for pod, name in (
            ("2x4", f"strategy_incumbent_dlrm_{POD_DEVICES}dev_2x4pod.json"),
            ("auto", f"strategy_incumbent_dlrm_{POD_DEVICES}dev.json")):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, tool, "--telemetry", tel, "--artifacts", art,
             "--devices", str(POD_DEVICES), "--budget", str(POD_BUDGET),
             "--bench", "sim", "--pod", pod], capture_output=True,
            text=True, timeout=300)
        wall = time.perf_counter() - t0
        lines = r.stdout.strip().splitlines()
        result = json.loads(lines[-1]) if r.returncode == 0 and lines \
            else None
        runs[pod] = {"rc": r.returncode, "wall_s": wall, "result": result,
                     "stderr_tail": r.stderr[-400:] if r.returncode else ""}
        checks[pod] = (r.returncode == 0 and len(lines) == 1
                       and os.path.isfile(os.path.join(art, name)))
    checks["pod_pointer_only_for_2x4"] = sorted(
        n for n in os.listdir(art) if n.startswith("strategy_incumbent")) \
        == sorted([f"strategy_incumbent_dlrm_{POD_DEVICES}dev.json",
                   f"strategy_incumbent_dlrm_{POD_DEVICES}dev_2x4pod.json"])
    row = {"phase": "pod_tool", "card": card, "runs": runs,
           "checks": checks}
    log(row)
    if not all(checks.values()):
        raise AssertionError(f"34(c): checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def scaleout_phase(card):
    """Phase 34 in a directory of its own beside this script, removed
    afterwards (the hetero podshard holds the 412 MB of host tables)."""
    root = tempfile.mkdtemp(prefix=".scaleout-",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    try:
        rows = {"hetero": hetero_mesh(card, root),
                "quant": quant_mesh(card, root),
                "pod": pod_tool(card, root)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows["wall_s"] = time.perf_counter() - t0
    log({"phase": "wall", "name": "scaleout", "wall_s": rows["wall_s"]})
    return rows


# --------------------------------------------------------------- phase 35
#: phase 35: the cards it needs, one NCCL rank on each; the DLRM's global
#: batch (256 rows a data rank on {"data": 4}) and the survivors' after
#: the lost rank of 35(e) (three replicas of 256 rows)
CARDS = 4
CARDS_BATCH, RESUME_BATCH = 1024, 768
#: 35(a)'s runs, as MESH2_RUNS
MESH4_RUNS = [
    ["data4", {"data": 4}, False, "off", "off"],
    ["model4_allgather", {"data": 1, "model": 4}, True, "allgather", "off"],
    ["model4_all_to_all", {"data": 1, "model": 4}, True, "all_to_all",
     "off"],
    ["model4_overlap_allgather", {"data": 1, "model": 4}, True, "allgather",
     "on"],
    ["data2_model2_all_to_all", {"data": 2, "model": 2}, True, "all_to_all",
     "off"]]
#: 35(f): the DLRM CLI's arguments (run_random.sh's model by default)
CLI_ARGS = ["-b", str(CARDS_BATCH), "-e", "2", "--wd", "0",
            "--data-size", str(32 * CARDS_BATCH)]


def cards_dlrm(card, root):
    """35(a): mesh_rank on four NCCL ranks over MESH4_RUNS at global batch
    CARDS_BATCH, each run held against one process on this card
    (``_check_mesh_runs``); every run must complete on every rank."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    t0 = time.perf_counter()
    fdist.launch("chip_smoke:mesh_rank", CARDS, kwargs={
        "out_dir": root, "world": CARDS, "runs": MESH4_RUNS,
        "backend": "nccl", "batch": CARDS_BATCH}, timeout_s=420, threads=4)
    group_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json")))
             for r in range(CARDS)]
    missing = [(x["rank"], name) for x in ranks for name, *_ in MESH4_RUNS
               if name not in x["runs"]]
    if missing or any(x["refused"] for x in ranks):
        raise AssertionError(f"35(a): runs missing under NCCL: {missing}")
    results = _check_mesh_runs("35(a)", root, CARDS, MESH4_RUNS,
                               CARDS_BATCH, ranks)
    log({"phase": "cards_dlrm", "card": card, "backend": "nccl",
         "cards": CARDS, "global_batch": CARDS_BATCH,
         "group_wall_s": group_s, **results})
    return results


def cards_seq(card, root):
    """35(b): ring attention and Ulysses on {"seq": 4} (``seq_rank``),
    each against sdpa on this card at 2e-5."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    t0 = time.perf_counter()
    fdist.launch("chip_smoke:seq_rank", CARDS, kwargs={
        "out_dir": root, "world": CARDS, "mesh": {"seq": CARDS},
        "backend": "nccl"}, timeout_s=300, threads=4)
    group_s = time.perf_counter() - t0
    rows = {}
    for kind in ("ring", "ulysses"):
        ranks = [json.load(open(os.path.join(root, f"{kind}{r}.json")))
                 for r in range(CARDS)]
        rows[kind] = _check_seq("35(b)", root, ranks, kind)
        if rows[kind] is None or any(x["refused"] for x in ranks):
            raise AssertionError(f"35(b): {kind} attention did not run")
    log({"phase": "cards_attention", "card": card, "backend": "nccl",
         "mesh": {"seq": CARDS}, "group_wall_s": group_s, **rows})
    return rows


def cards_hetero(card, root):
    """35(c): 34(a) on {"data": 4} over four NCCL ranks."""
    return hetero_mesh(card, root, CARDS, {"data": CARDS}, "nccl", "35(c)")


def cards_serving(card, root):
    """35(d): 34(b) on {"data": 1, "model": 4} over four NCCL ranks, the
    leader then leaving the bf16 engine without its stop."""
    return quant_mesh(card, root, CARDS, {"data": 1, "model": CARDS},
                      "nccl", "35(d)", leave=True)


def cards_elastic(card, root):
    """35(e): elastic_rank on four NCCL ranks ({"data": 1, "model": 4},
    allgather, global batch CARDS_BATCH): a podshard commit, rank 3 lost
    at the next save's barrier, the three survivors recovered at a new
    store over NCCL onto {"data": 3} at RESUME_BATCH, MESH_STEPS steps
    on.  Held against one process on this card restored from the same
    checkpoint on the same batches (losses rtol 1e-5); every restore bit
    for bit the saved blocks."""
    from dlrm_flexflow_tpu_torch import distributed as fdist
    from dlrm_flexflow_tpu_torch.resilience import latest_checkpoint
    lost = CARDS - 1
    resume = {"store": f"file://{root}/store3", "mesh": {"data": lost},
              "batch": RESUME_BATCH}
    t0 = time.perf_counter()
    fdist.launch("chip_smoke:elastic_rank", CARDS, kwargs={
        "root": root, "world": CARDS, "mesh": {"data": 1, "model": CARDS},
        "backend": "nccl", "batch": CARDS_BATCH, "serve": False,
        "resume": resume}, timeout_s=420, threads=4)
    group_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(root, f"rank{r}.json")))
             for r in range(CARDS)]
    survivors = ranks[:lost]
    ckpt_dir = os.path.join(root, "ckpt")
    newest = latest_checkpoint(ckpt_dir)
    saved = {}
    for x in ranks:
        saved.update(x["digests"])
    t_loc = TABLES // CARDS
    model = _mesh_model(False, "float32", batch=RESUME_BATCH)[0]
    t0 = time.perf_counter()
    state = restore_checkpoint(newest, model, on_mesh_change="reshard")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    one_digests = _digests(state, [(r * t_loc, (r + 1) * t_loc)
                                   for r in range(CARDS)])
    rin, rlab = _resume_data(RESUME_BATCH)
    losses, walls = [], []
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        state, mets = model.train_step(
            state, {k: v[i] for k, v in rin.items()}, rlab[i])
        losses.append(float(mets["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    del model, state
    _free()
    rel = max(abs(a - b) / abs(b) for x in survivors
              for a, b in zip(x["resumed_losses"], losses))
    shards = sorted(n for n in os.listdir(newest) if n.startswith("shard-"))
    checks = {
        "commit": all(x["path"] == newest for x in ranks)
        and os.path.basename(newest) == f"ckpt-{MESH_STEPS}"
        and not verify_checkpoint(newest),
        "shards": shards == [f"shard-p{r:03d}.{e}" for r in range(CARDS)
                             for e in ("json", "npz")],
        "timeouts_name_p3": all((x["timeout"] or {}).get("missing")
                                == [f"p{lost}"] for x in survivors),
        "timeouts_within_deadline": all(
            ELASTIC_DEADLINE_S <= x["timeout_wall_s"]
            < ELASTIC_DEADLINE_S + 10 for x in survivors),
        "recovery_events": all([e["phase"] for e in x["recovery_events"]]
                               == ["barrier_timeout"] for x in survivors),
        "flight_records": all(len(x["flight"]) == 1 for x in survivors),
        "rank3_lost": ranks[lost]["hang"].startswith("injected host hang"),
        "no_launch_in_ranks": not any(
            any(x["launches"].values())
            or any(x.get("resumed_launches", {}).values()) for x in ranks),
        "recovered": all(
            x["resumed_from"] == {"path": newest, "step": MESH_STEPS,
                                  "extra": {"batches_done": MESH_STEPS}}
            and [tuple(e) for e in x["recover_events"]]
            == [("elastic", "reshard"), ("recovery", "resume")]
            and x["resumed_mesh"] == {"data": lost} for x in survivors),
        "restore_bit_for_bit": all(x["restored_digests"] == saved
                                   for x in survivors)
        and one_digests == saved,
        "resumed_losses_rtol_1e-5": rel <= 1e-5,
        "survivors_agree": all(x["resumed_losses"]
                               == survivors[0]["resumed_losses"]
                               for x in survivors),
    }
    row = {"phase": "cards_elastic", "card": card, "backend": "nccl",
           "mesh": {"data": 1, "model": CARDS}, "resumed_mesh": resume[
               "mesh"], "group_wall_s": group_s,
           "step_wall_ms_median": [float(np.median(x["step_wall_ms"]))
                                   for x in ranks],
           "save_wall_s": [x["save_wall_s"] for x in ranks],
           "save_stages_s": [x["save_stages_s"] for x in ranks],
           "bytes_per_rank": [x["bytes"] for x in ranks],
           "barrier_timeout_wall_s": [x["timeout_wall_s"]
                                      for x in survivors],
           "timeout_message": survivors[0]["timeout"]["message"]
           if survivors[0]["timeout"] else None,
           "recover_wall_s": [x["recover_wall_s"] for x in survivors],
           "restore_stages_s": [x["restore_stages_s"] for x in survivors],
           "resumed_step_wall_ms": [x["resumed_step_wall_ms"]
                                    for x in survivors],
           "one_process_restore_s": restore_s,
           "one_process_step_wall_ms": walls,
           "losses": {"resumed": survivors[0]["resumed_losses"],
                      "one_process": losses},
           "max_rel_loss_diff": rel, "checks": checks}
    log(row)
    if not all(checks.values()):
        raise AssertionError(f"35(e): checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def cards_cli(card, root):
    """35(f): the DLRM CLI (``apps/dlrm.py``, CLI_ARGS) under ``python -m
    torch.distributed.run --nproc_per_node=4``, each rank's output in its
    own log: exit 0, every rank's epoch metrics equal and finite, each
    rank's samples/s."""
    import glob
    import re
    here = os.path.dirname(os.path.abspath(__file__))
    logs = os.path.join(root, "logs")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={CARDS}", "--log-dir", logs, "--redirects", "3",
         "-m", "dlrm_flexflow_tpu_torch.apps.dlrm", *CLI_ARGS],
        capture_output=True, text=True, timeout=420, cwd=here, env=env)
    wall = time.perf_counter() - t0
    out = {}
    for path in glob.glob(os.path.join(logs, "*", "attempt_*", "*",
                                       "stdout.log")):
        with open(path, errors="replace") as f:
            out[int(os.path.basename(os.path.dirname(path)))] = f.read()
    epochs = {k: [ln for ln in t.splitlines() if ln.startswith("epoch ")]
              for k, t in out.items()}
    thpt = {k: [float(x) for x in re.findall(
        r"THROUGHPUT = ([0-9.]+) samples/s", t)] for k, t in out.items()}
    nums = [float(x) for lines in epochs.values() for ln in lines
            for x in re.findall(r"[-+]?\d*\.\d+(?:[eE][-+]?\d+)?", ln)]
    checks = {
        "exit_0": r.returncode == 0,
        "every_rank": sorted(out) == list(range(CARDS)),
        "metrics_equal": len(epochs.get(0, [])) == 2 and all(
            v == epochs[0] for v in epochs.values()),
        "finite": bool(nums) and bool(np.all(np.isfinite(nums))),
        "throughput": all(len(v) == 1 for v in thpt.values()),
    }
    row = {"phase": "cards_cli", "card": card, "args": CLI_ARGS,
           "rc": r.returncode, "wall_s": wall,
           "epoch_metrics_rank0": epochs.get(0),
           "samples_per_s": {k: v[0] for k, v in sorted(thpt.items())
                             if v},
           "checks": checks}
    if not all(checks.values()):
        row["stderr_tail"] = r.stderr[-2000:]
        row["rank_tails"] = {k: t[-1500:] for k, t in out.items()}
    log(row)
    if not all(checks.values()):
        raise AssertionError(f"35(f): checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


#: phase 35's parts, in order
CARDS_PARTS = (("dlrm", cards_dlrm), ("attention", cards_seq),
               ("hetero", cards_hetero), ("serving", cards_serving),
               ("elastic", cards_elastic), ("cli", cards_cli))


def cards_phase(card):
    """Phase 35, each part (CARDS_PARTS) in a directory of its own under
    one beside this script, removed afterwards; with fewer than CARDS
    cards, one line saying that it did not run, and None."""
    n = torch.cuda.device_count()
    if n < CARDS:
        log({"phase": "mesh_cards", "ran": False, "cards": n,
             "note": f"phase 35 needs {CARDS} cards; it did not run"})
        return None
    root = tempfile.mkdtemp(prefix=".cards-",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    rows = {}
    try:
        for name, fn in CARDS_PARTS:
            sub = os.path.join(root, name)
            os.makedirs(sub)
            _free()
            t1 = time.perf_counter()
            rows[name] = fn(card, sub)
            log({"phase": "wall", "name": f"cards_{name}",
                 "wall_s": time.perf_counter() - t1})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows["wall_s"] = time.perf_counter() - t0
    log({"phase": "wall", "name": "mesh_cards", "wall_s": rows["wall_s"]})
    return rows


# --------------------------------------------------------------- phase 36
#: phase 36(b): each spelling the port's trace-purity/trace-staleness
#: flag, as the one line of a captured method: (name, line, the code the
#: analyzer must give it, what the card must do, the Python change made
#: after the capture).  "refused": the capture raises; "frozen": the
#: capture succeeds and after the change two replays still give the
#: capture-time result (or, for a side effect, do not repeat it).
VOCAB_CASES = (
    ("item", "y = x * 0 + x.sum().item()", "host-sync-in-trace",
     "refused", ""),
    ("tolist", "y = x * len(x.tolist())", "host-sync-in-trace",
     "refused", ""),
    ("cpu", "y = x.cpu().to(x.device)", "host-sync-in-trace",
     "refused", ""),
    ("numpy", "y = torch.as_tensor(x.numpy(), device=x.device)",
     "host-sync-in-trace", "refused", ""),
    ("to_cpu", "y = x.to('cpu').to(x.device)", "host-sync-in-trace",
     "refused", ""),
    ("cuda_synchronize", "torch.cuda.synchronize(); y = x * 1",
     "host-sync-in-trace", "refused", ""),
    ("stream_synchronize",
     "torch.cuda.current_stream().synchronize(); y = x * 1",
     "host-sync-in-trace", "refused", ""),
    ("event_synchronize",
     "e = torch.cuda.Event(); e.record(); e.synchronize(); y = x * 1",
     "host-sync-in-trace", "refused", ""),
    ("nonzero", "y = x.nonzero().float()", "host-sync-in-trace",
     "refused", ""),
    ("unique", "y = x.unique()", "host-sync-in-trace", "refused", ""),
    ("masked_select", "y = x.masked_select(x > 2)", "host-sync-in-trace",
     "refused", ""),
    ("where_one_arg", "y = torch.where(x > 2)[0].float()",
     "host-sync-in-trace", "refused", ""),
    ("np_asarray", "y = torch.as_tensor(np.asarray(x), device=x.device)",
     "host-sync-in-trace", "refused", ""),
    ("perf_counter", "y = x * 0 + time.perf_counter() % 1000",
     "host-clock-in-trace", "frozen", "time.sleep(0.05)"),
    ("time_time", "y = x * 0 + time.time() % 1000",
     "host-clock-in-trace", "frozen", "time.sleep(0.05)"),
    ("monotonic", "y = x * 0 + time.monotonic() % 1000",
     "host-clock-in-trace", "frozen", "time.sleep(0.05)"),
    ("self_attr", "y = x * self.scale", "stale-attr-read", "frozen",
     "case.set_scale(2.0)"),
    ("global", "y = x * SCALE", "stale-global-read", "frozen",
     "mod.rescale(2.0)"),
    ("environ", "y = x * float(os.environ.get('FF_CASE_SCALE', '1'))",
     "env-read-in-trace", "frozen", "os.environ['FF_CASE_SCALE'] = '2'"),
    ("counter", "bump.n += 1; y = x * 1", "side-effect-in-trace",
     "frozen", ""),
    ("print", "print('captured'); y = x * 1", "side-effect-in-trace",
     "frozen", ""),
)

#: one case's module: the line inside a method that GraphRunner captures
VOCAB_MODULE = '''\
import os
import time

import numpy as np
import torch

from dlrm_flexflow_tpu_torch.graphs import GraphRunner

SCALE = 1.0


def rescale(s):
    global SCALE
    SCALE = s


def bump():
    return bump.n


bump.n = 0


class Case:
    def __init__(self):
        self.scale = 1.0

    def set_scale(self, s):
        self.scale = s

    def fn(self, static, state):
        x = static["x"]
        {line}
        return y

    def build(self, x):
        return GraphRunner(self.fn, {{"x": x}})
'''

#: the child that runs one case on cuda:0 and prints one JSON line
VOCAB_CHILD = r'''
import contextlib, importlib.util, io, json, os, sys, time
import torch
path, change = sys.argv[1], sys.argv[2]
spec = importlib.util.spec_from_file_location("case_mod", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
x = torch.arange(1.0, 9.0, device="cuda")
case = mod.Case()
out = {}
buf = io.StringIO()
try:
    with contextlib.redirect_stdout(buf):
        runner = case.build(x)
    torch.cuda.synchronize()
except Exception as e:  # noqa: BLE001 - the refusal is the record
    out["verdict"] = "refused"
    out["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
else:
    first = runner.run({"x": x})
    n0, p0 = mod.bump.n, buf.getvalue().count("captured")
    exec(change, {"case": case, "mod": mod, "os": os, "time": time})
    replays = io.StringIO()
    with contextlib.redirect_stdout(replays):
        a = runner.run({"x": x})
        b = runner.run({"x": x})
    torch.cuda.synchronize()
    quiet = (mod.bump.n == n0
             and replays.getvalue().count("captured") == 0)
    live_buf = io.StringIO()
    with contextlib.redirect_stdout(live_buf):
        live = case.fn({"x": x}, ())
    torch.cuda.synchronize()
    same = bool(torch.equal(a, first) and torch.equal(b, first))
    moved = not torch.equal(live, first)
    effect = (mod.bump.n > n0 or live_buf.getvalue().count("captured") > 0)
    if same and moved:
        out["verdict"] = "frozen"
    elif same and quiet and effect:
        out["verdict"] = "frozen"
        out["side_effect"] = {"at_capture": max(p0, n0),
                              "on_replay": 0}
    else:
        out["verdict"] = "neither"
        out["detail"] = {"replays_equal": same, "live_differs": moved,
                         "replays_quiet": quiet}
print(json.dumps(out), flush=True)
'''


class _CaptureLog:
    """The ``__qualname__`` of every function a ``graphs.GraphRunner``
    captures in this process (phase 36(c)), recorded by wrapping the
    class's capture from here: the port's code is not changed."""

    def __init__(self):
        from dlrm_flexflow_tpu_torch import graphs
        self.names = names = []
        orig = graphs.GraphRunner._capture

        def _capture(runner, state, pool):
            fn = runner._fn
            names.append(getattr(fn, "__qualname__", repr(fn)))
            return orig(runner, state, pool)

        graphs.GraphRunner._capture = _capture


def _analysis_tree_run(root: str) -> dict:
    """Phase 36(a): the port's ffcheck over the checkout as a child
    process, its JSON sink under ``root``; the child's wall (interpreter
    start and imports included) is the analyzer's on this host."""
    here = os.path.dirname(os.path.abspath(__file__))
    sink = os.path.join(root, "artifacts", "analysis_1.json")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "dlrm_flexflow_tpu_torch.analysis",
         "--format", "json", "-o", sink],
        cwd=here, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(
            f"36(a): the port's ffcheck exited {r.returncode}:\n"
            f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    with open(sink) as f:
        doc = json.load(f)
    from dlrm_flexflow_tpu_torch.telemetry.report import analysis_summary
    section = analysis_summary(doc, sink)
    if not doc["summary"]["ok"] or section[0] != "== analysis ==" \
            or "ffcheck: OK" not in section[1]:
        raise AssertionError(f"36(a): the sink does not render clean: "
                             f"{section}")
    return {"wall_s": wall, "modules": doc["modules"],
            "passes": len(doc["passes"]), "summary": doc["summary"],
            "waived_by_pass": {k: v["waived"]
                               for k, v in doc["by_pass"].items()
                               if v["waived"]},
            "findings_by_pass": {k: v["findings"]
                                 for k, v in doc["by_pass"].items()},
            "report": section[:3]}


def _vocabulary(root: str) -> list:
    """Phase 36(b): every case's static code (the port's analyzer over
    the case modules) and the card's verdict (a child per case, all in
    flight together)."""
    from dlrm_flexflow_tpu_torch.analysis import run_analysis
    here = os.path.dirname(os.path.abspath(__file__))
    cases = os.path.join(root, "vocab")
    os.makedirs(cases)
    for name, line, _code, _verdict, _change in VOCAB_CASES:
        with open(os.path.join(cases, f"{name}.py"), "w") as f:
            f.write(VOCAB_MODULE.format(line=line))
    res = run_analysis(repo=root, roots=["vocab"],
                       pass_names=["trace-purity", "trace-staleness"])
    static = {}
    for f in res.findings:
        if f.detail == "Case.fn":
            static.setdefault(f.path.split("/")[-1][:-3], set()).add(f.code)
    procs = [(name, subprocess.Popen(
        [sys.executable, "-c", VOCAB_CHILD,
         os.path.join(cases, f"{name}.py"), change],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for name, _l, _c, _v, change in VOCAB_CASES]
    rows, bad = [], []
    for (name, line, code, verdict, _change), (_n, proc) in zip(
            VOCAB_CASES, procs):
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        got = {}
        for ln in out.splitlines()[::-1]:
            if ln.startswith("{"):
                got = json.loads(ln)
                break
        row = {"case": name, "line": line,
               "static": sorted(static.get(name, ())),
               "card": got.get("verdict", f"no result (exit "
                                          f"{proc.returncode})")}
        for k in ("error", "side_effect", "detail"):
            if k in got:
                row[k] = got[k]
        if not got:
            row["stderr"] = err[-800:]
        rows.append(row)
        if row["static"] != [code] or row["card"] != verdict:
            bad.append((name, code, verdict, row))
    if bad:
        raise AssertionError(f"36(b): vocabulary and card disagree: {bad}")
    return rows


def _coverage(captured) -> dict:
    """Phase 36(c): every function a GraphRunner captured in this run is
    a static capture entry of the port's analyzer or reachable from
    one."""
    from dlrm_flexflow_tpu_torch.analysis import FunctionIndex, load_modules
    from dlrm_flexflow_tpu_torch.analysis.passes._entries import (
        all_capture_entries, capture_reach)
    here = os.path.dirname(os.path.abspath(__file__))
    mods = load_modules(repo=here)
    index = FunctionIndex(mods)
    entries = {index.owner[n][1] for n in all_capture_entries(mods, index)}
    reach = {index.owner[n][1] for n in capture_reach(mods, index)}
    got = sorted(set(captured))
    missing = [q for q in got if q not in reach]
    row = {"captured": got, "captures": len(captured),
           "static_entries": len(entries), "reachable": len(reach),
           "not_covered": missing}
    if not got or missing:
        raise AssertionError(f"36(c): captured functions outside the "
                             f"static entries: {row}")
    return row


def analysis_phase(card, captured) -> dict:
    """Phase 36: the port's ffcheck on the card's host — (a) the tree
    run, (b) its capture vocabulary against the card's capture, (c) its
    capture entries against what this run captured — in a temporary
    directory outside the checkout, removed afterwards."""
    root = tempfile.mkdtemp(prefix="ffcheck-")
    t0 = time.perf_counter()
    try:
        tree = _analysis_tree_run(root)
        log({"phase": "analysis_tree", "card": card, **tree})
        vocab = _vocabulary(root)
        for row in vocab:
            log({"phase": "analysis_vocab", **row})
        cover = _coverage(captured)
        log({"phase": "analysis_captures", **cover})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    log({"phase": "wall", "name": "analysis", "wall_s": wall})
    return {"tree": tree, "vocab": vocab, "captures": cover,
            "wall_s": wall}


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
    card = card_info()
    build_kernels()
    # phase 36(c) records every capture of the run from here on
    captures = _CaptureLog()
    # phases 3-5: the serving path
    model, state = build_model()
    table = state.params["emb"]["embedding"]
    fwd_err = check_kernel_cases(table)
    serve_launches, path_err, serve_p99_us = serve(model, state)
    top = time_kernel(model, state)[-1]  # the top serving bucket, B=256
    # phases 16-17: quantized serving, and telemetry on the card
    quantized = serve_quantized(model, state)
    telemetry = telemetry_on_the_card(model, state)
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
    _free()
    # phase 8: the training paths
    inputs, labels = _epoch_data(64)
    headline, headline_counts = train_headline(inputs, labels)
    sparse_counts = train_fused_sparse(inputs, labels)
    dense, dense_counts = train_fused_dense(inputs, labels)
    dot_counts = train_fused_dense_dot(inputs, labels)
    # phases 12-13: the staged, cached epochs and the use_pallas graph
    staged, staged_counts = train_staged(inputs, labels)
    bag_row, bag_counts = train_bag_graph()
    # phase 15 and 13 on bf16 tables: the (vii) headline and the bag graph
    bf16_row, bf16_counts = train_bf16_tables(inputs, labels)
    bag16_row, bag16_counts = train_bag_graph(torch.bfloat16)
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
    # phase 18: the bf16 kernels' times
    bf16_times = time_bf16_kernels(table, bag_table)
    log({"phase": "bf16_kernels", **{
        k: {f: v[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")}
        for k, v in bf16_times.items()},
         "launches": {"row_update": sum(c["row_update"]
                                        for c in (bf16_counts, bag16_counts)),
                      "row_set": bf16_counts["row_set"],
                      "embedding_bag": bag16_counts["embedding_bag"]}})
    # phase 19: durability (resilient fit: saves, kill, resume, sentinel),
    # after the timings: its host I/O stays out of their process history
    del table
    _free()
    durable, durable_counts = durability_phase()
    # phase 20: tiered storage, the cost gates and the router, after the
    # timings too (host-heavy)
    tiered, tiered_counts = tiered_phase(card)
    # phase 21: momentum and Adam on the row-lazy path (B2, B5), and dense
    # Adam, at full width
    lazy, lazy_counts = lazy_phase(inputs, labels, headline["step_wall_ms"])
    # phase 22: the SOAP core on measured costs (B2, B3), the searches,
    # the strategy round trip and compile(strategy=) on the card
    soap, soap_counts = soap_phase(inputs, labels, headline["step_wall_ms"])
    # phase 23: the closed loop (OpTimer's op_time telemetry, search_tune
    # twice, the real gate), the SLO monitor over the fused engine, and
    # the report and regress CLIs (B3, B4, B2)
    tuned, tune_counts = tuning_phase(card, serve_p99_us)
    # phases 24-27: the five other apps at their published widths (NMT's
    # embeddings through B2 and B5), each against the CPU path, B2 at
    # NMT's shape, the small graphs of the other ops
    apps, apps_counts, nmt_b2 = apps_phase()
    # phase 28: the hetero Kaggle DLRM (tables in host memory through
    # native/ffruntime.cpp; the mixed run's card tables through B2), last:
    # host-heavy
    hetero, hetero_counts = hetero_phase(card)
    # phase 29: bf16 activation storage (the classic graph through B2 and
    # B5, fused serving through B3, Inception-v3); phase 30: bf16 tiered
    # serving (B5 installs, B2 on bf16 rows); phase 31: the frontends
    act, act_counts = bf16_activation_phase(inputs, labels)
    tiered16, tiered16_counts = bf16_tiered_phase(tiered)
    fronts = frontends_phase()
    # phase 32: the mesh, one rank over NCCL (bit for bit the no-mesh
    # model, kernels included) and two ranks on the one card over gloo
    _free()
    mesh1, mesh1_counts = mesh_one_rank(inputs, labels)
    mesh2, mesh2_refused = mesh_two_ranks(card)
    # phase 33: the podshard commit, a rank lost at the barrier, the
    # reshard recovery on one card (B2), serving from the checkpoint and
    # on the mesh; host I/O-heavy, so last
    _free()
    elastic_row, elastic_counts = elastic_phase(card)
    # phase 34: the hetero Kaggle DLRM and quantized serving across two
    # gloo ranks on the card (no kernel runs there), search_tune --pod
    _free()
    scaleout = scaleout_phase(card)
    # phase 35: the mesh between four cards over NCCL (no kernel runs in
    # the ranks); one line and nothing else on fewer cards
    _free()
    cards = cards_phase(card)
    # phase 36: the port's ffcheck (a host phase: after the timings)
    _free()
    analysis = analysis_phase(card, captures.names)
    path_counts = (headline_counts, sparse_counts, dense_counts, dot_counts,
                   staged_counts, bag_counts, bf16_counts, bag16_counts,
                   durable_counts, tiered_counts, lazy_counts, soap_counts,
                   tune_counts, apps_counts, hetero_counts, act_counts,
                   tiered16_counts, mesh1_counts, elastic_counts)
    row_launches = sum(c["row_update"] for c in path_counts)
    prep_launches = sum(c["row_update_prep"] for c in path_counts)
    if prep_launches != row_launches:
        raise AssertionError(f"{prep_launches} prepare-and-sort launches "
                             f"for {row_launches} row updates")
    log({"phase": "done", "wall_s": round(time.perf_counter() - t0, 3),
         "train_step_wall_ms": {"headline": headline["step_wall_ms"],
                                "fused_dense": dense["step_wall_ms"],
                                "use_pallas": bag_row["step_wall_ms"],
                                "bf16_tables": bf16_row["step_wall_ms"],
                                "use_pallas_bf16": bag16_row["step_wall_ms"]},
         "staged_fit_samples_per_s": staged["fit_samples_per_s"],
         "staged_fit_graphs": staged["graphs"],
         "bf16_staged_fit_samples_per_s":
             bf16_row["staged_fit"]["fit_samples_per_s"],
         "quantized_bytes": {m: r["bytes_after"]
                             for m, r in quantized.items()},
         "telemetry_events": telemetry["by_type"],
         "durability": {
             "save_wall_s": [x["wall_s"] for x in durable["saves"]],
             "restore_wall_s": [x["wall_s"] for x in durable["restores"]],
             "save_gb_per_s": [x["gb_per_s"] for x in durable["saves"]],
             "step_wall_ms_median": durable["step_wall_ms_median"]},
         "tiered": {k: {f: tiered[k].get(f) for f in (
             "hit_pct", "misses", "evictions", "qps", "p99_us",
             "stall_us_mean")} for k in ("hot4096", "hot512_router")},
         "tiered_stall_us": {f: tiered["hot4096"]["eager"][f] for f in (
             "stall_us_median", "stall_us_p99")},
         "lazy_graphed_step_wall_ms": lazy["graphed_step_wall_ms"],
         "lazy_staged_fit_samples_per_s": lazy["staged_fit_samples_per_s"],
         "soap_simulated_over_measured": {
             g: r["simulated_over_measured"] for g, r in soap.items()},
         "tune_mae_pct": [tuned["runs"][-1]["mae_pct_before"],
                          tuned["runs"][-1]["mae_pct_after"]],
         "tune_real_step_ms": {
             "candidate": tuned["real"]["candidate_s"] * 1e3,
             "incumbent": tuned["real"]["incumbent_s"] * 1e3},
         "app_graphed_step_wall_ms": {
             a: r["graphed_step_wall_ms"] for a, r in apps.items()},
         "app_peak_memory_bytes": {
             a: r["peak_memory_bytes"] for a, r in apps.items()},
         "f64_layer_share_of_step": {
             a: r["f64_layer"]["share_of_step"] for a, r in apps.items()
             if "f64_layer" in r},
         "row_update_nmt_ms": {k: nmt_b2[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms")},
         "hetero_step_ms": {r: hetero[r]["step_ms"] for r in hetero},
         "hetero_split_ms": {r: hetero[r]["split_ms"] for r in hetero},
         "bf16_act": {
             "classic_step_wall_ms": act["classic"]["step_wall_ms"],
             "classic_max_loss_gap": act["classic"]["max_loss_gap"],
             "serving_qps": act["serving"]["qps"],
             "inception_graphed_step_wall_ms":
                 act["inception"]["graphed_step_wall_ms"],
             "inception_peak_memory_bytes":
                 act["inception"]["peak_memory_bytes"],
             "inception_f32_act_graphed_step_wall_ms":
                 act["inception"]["f32_activations"][
                     "graphed_step_wall_ms"],
             "inception_f32_act_peak_memory_bytes":
                 act["inception"]["f32_activations"]["peak_memory_bytes"],
             "inception_card_vs_cpu": {
                 k: act["inception"]["card_vs_cpu"][k]
                 for k in ("logits_rel_err", "loss_rel_err")}},
         "tiered_bf16": {k: tiered16[k] for k in (
             "qps", "p99_us", "hit_pct", "b5_bf16_installs",
             "b2_scatter_updates")},
         "frontends_step_wall_ms": {
             r["model"]: r.get("graphed_step_wall_ms") for r in fronts},
         "mesh_one_rank_step_wall_ms": {
             k: r["step_wall_ms"] for k, r in mesh1.items()},
         "mesh_two_ranks": {k: {f: r.get(f) for f in (
             "step_wall_ms", "one_process_step_wall_ms", "exchange_ms",
             "exchange_share_of_step", "ring_ms", "one_process_sdpa_ms",
             "max_abs_err")} for k, r in mesh2.items()},
         "mesh_gloo_refused": mesh2_refused,
         "elastic": {
             "save_wall_s": elastic_row["save_wall_s"],
             "bytes_per_rank": elastic_row["bytes_per_rank"],
             "barrier_timeout_wall_s":
                 elastic_row["barrier_timeout_wall_s"],
             "restore_wall_s": elastic_row["restore_wall_s"],
             "resumed_step_wall_ms": elastic_row["resumed_step_wall_ms"],
             "max_rel_loss_diff": elastic_row["max_rel_loss_diff"],
             "b2_launches": elastic_row["b2_launches"]["row_update"],
             "dispatch_wall_ms_median":
                 elastic_row["dispatch_wall_ms_median"],
             "phase_wall_s": elastic_row["phase_wall_s"]},
         "scaleout": {
             "hetero_step_wall_ms_median":
                 scaleout["hetero"]["step_wall_ms_median"],
             "hetero_split_ms_rank0": scaleout["hetero"]["split_ms"][
                 "rank0"],
             "hetero_max_abs_table_diff":
                 scaleout["hetero"]["max_abs_table_diff"],
             "quant_max_abs_err": {m: scaleout["quant"][m]["max_abs_err"]
                                   for m in ("int8", "bf16")},
             "quant_dispatch_wall_ms_median": {
                 m: scaleout["quant"][m]["dispatch_wall_ms_median"]
                 for m in ("int8", "bf16")},
             "phase_wall_s": scaleout["wall_s"]},
         "mesh_cards": None if cards is None else {
             "samples_per_s": {k: r["samples_per_s"]
                               for k, r in cards["dlrm"].items()},
             "exchange_share_of_step": {
                 k: r["exchange_share_of_step"]
                 for k, r in cards["dlrm"].items()},
             "attention_ms": {k: r[f"{k}_ms"]
                              for k, r in cards["attention"].items()},
             "hetero_step_wall_ms_median":
                 cards["hetero"]["step_wall_ms_median"],
             "serving_dispatch_wall_ms_median": {
                 m: cards["serving"][m]["dispatch_wall_ms_median"]
                 for m in ("int8", "bf16")},
             "elastic_recover_wall_s": cards["elastic"]["recover_wall_s"],
             "cli_samples_per_s": cards["cli"]["samples_per_s"],
             "phase_wall_s": cards["wall_s"]},
         "analysis": {
             "tree_wall_s": analysis["tree"]["wall_s"],
             "modules": analysis["tree"]["modules"],
             "vocabulary": {r["case"]: r["card"]
                            for r in analysis["vocab"]},
             "captured": analysis["captures"]["captured"],
             "phase_wall_s": analysis["wall_s"]},
         "note": "walls include each path's eager step and capture"})
    log({"kernels": [
        _entry("fused_interact_fwd",
               serve_launches + sum(c["fused_interact_fwd"]
                                    for c in (dense_counts, dot_counts,
                                              tiered_counts, soap_counts,
                                              tune_counts, act_counts)),
               max(fwd_err, path_err), fwd_time),
        _entry("fused_interact_bwd",
               sum(c["fused_interact_bwd"] for c in (dense_counts,
                                                     dot_counts,
                                                     tune_counts)),
               bwd_err, bwd_time),
        _entry("row_update", row_launches, row_err, row_time),
        _entry("row_update_prep", prep_launches, prep_err, prep_time),
        _entry("row_set", staged_counts["row_set"] + bf16_counts["row_set"]
               + tiered_counts["row_set"] + lazy_counts["row_set"]
               + apps_counts["row_set"] + act_counts["row_set"]
               + tiered16_counts["row_set"], set_err, set_time),
        _entry("embedding_bag", bag_counts["embedding_bag"]
               + bag16_counts["embedding_bag"], bag_err, bag_time)]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
