"""Bucketed inference engine (counterpart of
``dlrm_flexflow_tpu/serving/engine.py``), single-device.

An :class:`InferenceEngine` holds a compiled :class:`~..model.FFModel`
and its parameters on one device and runs the labels-free forward at a
fixed set of batch-size **buckets**.  A partial batch pads with zero rows
up to the enclosing bucket and the padding is sliced off; a batch past
the largest bucket runs as top-bucket chunks.  The forward is
row-independent, so the first ``n`` rows of a padded bucket equal the
unpadded forward bit for bit.

Each bucket's forward is one CUDA graph (``graphs.GraphRunner``), where
the JAX package AOT-compiles each bucket's program (``_ensure``): built
by ``warmup`` (every bucket, in the constructor by default) or at a
bucket's first dispatch, after one eager run of the forward (the kernel
build and load, cuBLAS and the allocator).  ``aot=False`` keeps that
warm run and then runs the forward eagerly, as the JAX package's
cached-jit path does.  The buckets' graphs share one memory pool and one
lock.  A dispatch copies the padded request into the bucket's static
inputs, replays, and copies the rows back.  On the CPU the same runner
calls the forward on the same static inputs.

``quantize="int8"|"bf16"`` (default ``FFConfig.serve_quantize``)
re-encodes the tables of a copy of the params at load
(``ops/quantized.py``; ``engine.quantization`` is the JAX package's byte
report), and every bucket's graph captures the quantized forward.

``storage="tiered"`` (default ``FFConfig.serve_storage``) keeps only the
hottest ``FFConfig.storage_hot_rows`` rows of each table on the card
(``storage/tiered.py``): per embedding op the store's fixed hot tier
takes the place of the table before the buckets' graphs are captured, so
every graph reads it by address, and each dispatch remaps the raw ids to
hot slots.  A store writes its hot tier in place, so a tiered dispatch
holds the engine's lock across the remap (with the misses' copy and
row-set install), the replay's enqueue and the output copy's enqueue:
stream order then puts any later install after this replay.  The
predictions equal the resident engine's bit for bit.

Every dispatch emits one ``serve`` ``phase="dispatch"`` event and, under
the caller's span, the ``serve.pad`` and ``serve.engine_forward`` spans
(and ``serve.storage_remap`` when tiered); every bucket's capture emits a
``compile`` event (``kind="aot"``, ``fn="serve[bucket=b]"``), and the
engine's per-bucket dispatch counts are scraped by ``/metrics``
(``telemetry.metrics.track_engine``).

**Under a mesh** the engine is mesh-native.  ``partition_rules`` (the
rules the training placement uses) is kept on the engine; a parameter
sharded by them makes a SHARDED engine (``_mesh_sharded``), a fully
replicated tree a REPLICA.  A sharded engine on a data+model mesh rounds
its buckets up to multiples of the data size, as the JAX package does.
A mesh whose axes are all of size 1 runs the no-mesh program (graphs
included).  Over more than one rank the port has one process per rank
where JAX has one controller, so every rank must run the same bucket in
the same order for the collectives to meet:

* rank 0, the **leader**, owns the batcher (and the router, if any);
  before each forward it broadcasts a header (a bucket follows, or
  stop) over the host group (``distributed.host_group``: the world
  under gloo, a gloo group of its own under NCCL), then the padded
  bucket over the world group (on the card under NCCL), and the
  results are returned on rank 0;
* every other rank runs :meth:`InferenceEngine.follow` (a **follower**)
  until the leader's :meth:`close` (or the error path of a failed
  dispatch) broadcasts the stop; a follower waits for the next header
  on the host, where a gloo collective raises past the group's deadline
  or when the leader's connection closes, so a dead leader cannot park
  it forever, under NCCL too (an NCCL collective left waiting would be
  ended by NCCL's watchdog, which takes the whole process down);
* each rank holds its blocks of the parameters (a state trained on the
  mesh is taken as it is; global values are cut by the rules);
* dispatch is eager, as the mesh step is (gloo cannot be captured): a
  sharded engine runs the mesh's forward (its outputs tolerance-pinned
  against one device: the collectives reorder reductions); a replica
  runs the one-device program on the whole bucket on every rank, bit
  for bit the one-device engine.

Under a mesh of more than one rank no kernel launches (as JAX keeps
Pallas off under SPMD), and tiered storage is refused as in JAX (every
table left resident with the reason).  A quantized engine there
quantizes the global tables (a mesh block is gathered first), then
places them under the rules, as the JAX engine does: the codes take
their table's spec, the int8 scale column is replicated, and a
table-sharded op reads its T/mp tables' rows of it
(``parallel/spmd.py::_rank_scale``).  Host-placed tables (the hetero
strategy) are looked up by the owner rank over each bucket
(``ops/hetero.py::HostComm``), whether the engine is sharded or a
replica.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import _cuda
from ..device import resolve_device
from ..graphs import GraphRunner, run_eager
from ..ops.quantized import QUANT_MODES, quantize_embedding_params
from ..parallel.mesh import to_device
from ..telemetry import active_log, emit
from ..telemetry import metrics as _metrics
from ..telemetry.torch_hooks import record_compile
from ..telemetry.trace import current_span, record_span
from ..tensor import numpy_dtype
from .stats import LatencyStats

DEFAULT_BUCKETS = (1, 8, 64, 256)


def parse_buckets(spec) -> List[int]:
    """Sorted unique positive bucket sizes from a ``"1,8,64,256"``
    string, any int sequence, or None/"" for the default ladder."""
    if spec is None:
        return list(DEFAULT_BUCKETS)
    if isinstance(spec, str):
        parts = [p for p in spec.replace(" ", "").split(",") if p]
        if not parts:
            return list(DEFAULT_BUCKETS)
        sizes = [int(p) for p in parts]
    else:
        sizes = [int(s) for s in spec]
        if not sizes:
            return list(DEFAULT_BUCKETS)
    if any(s <= 0 for s in sizes):
        raise ValueError(f"bucket sizes must be positive, got {sizes}")
    return sorted(set(sizes))


class InferenceEngine:
    """Params -> low-latency bucketed predictions on ``device`` (default:
    the CUDA card; raises without one).

    ``params_or_state``: a ``TrainState`` or a bare ``{op: {param:
    tensor}}`` dict; the parameters are moved to ``device`` (no copy when
    they are already there), except the tables a tiered store takes,
    which stay where they are and are copied to the host.  ``buckets``
    overrides ``model.config.serve_buckets``; ``aot=False`` runs the
    forward eagerly instead of replaying a CUDA graph (``None`` or
    ``True``: graphs; ``None`` runs a model with host-placed tables
    eagerly, since a host lookup cannot be captured); ``quantize`` overrides
    ``model.config.serve_quantize`` ("off", "int8" or "bf16"): the tables
    are quantized on a copy of the params, so the training state is never
    touched.  ``storage`` overrides ``model.config.serve_storage``
    ("resident" or "tiered"); ``self.storage`` records the mode that ran
    and each table left resident with its reason.
    """

    def __init__(self, model, params_or_state=None,
                 buckets: Optional[Union[str, Sequence[int]]] = None,
                 aot: Optional[bool] = None, warmup: bool = True,
                 stats: Optional[LatencyStats] = None,
                 quantize: Optional[str] = None,
                 storage: Optional[str] = None, *, device=None):
        if getattr(model, "_forward_fn", None) is None:
            raise ValueError(
                "model must be compile()d before building an "
                "InferenceEngine (no forward exists yet)")
        if params_or_state is None:
            raise ValueError(
                "InferenceEngine needs parameters: pass a TrainState or "
                "params dict, or use InferenceEngine.from_checkpoint()")
        quantize = (quantize or getattr(model.config, "serve_quantize", "off")
                    or "off").strip().lower()
        if quantize not in QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r} "
                             f"(have {QUANT_MODES})")
        storage = (storage or getattr(model.config, "serve_storage",
                                      "resident") or "resident").strip().lower()
        if storage not in ("resident", "tiered"):
            raise ValueError(f"unknown serve_storage {storage!r} "
                             "(have 'resident', 'tiered')")
        if storage == "tiered" and quantize != "off":
            raise ValueError(
                "serve_storage='tiered' cannot combine with "
                "serve_quantize: the hot tier caches the f32 "
                "training rows bit-exactly (quantizing the cold "
                "tier is a separate mode, not built yet)")
        self.device = resolve_device(device)
        self.model = model
        if buckets is None:
            buckets = getattr(model.config, "serve_buckets", None)
        self.buckets = parse_buckets(buckets)
        # across the ranks of a mesh: eager (gloo cannot be captured)
        self._spmd = getattr(model, "_spmd", None) is not None
        # the leader protocol's headers travel on the host (a collective
        # to build: every rank of a mesh builds its engine)
        self._head_group = None
        if self._spmd:
            import torch.distributed as dist

            from ..distributed import host_group
            self._head_group = host_group(range(dist.get_world_size()))
        self._aot = (not getattr(model, "_hetero_ops", None)
                     if aot is None else bool(aot)) and not self._spmd
        self._params = dict(getattr(params_or_state, "params",
                                    params_or_state))
        self.partition_rules = None
        self._mesh_sharded = False
        self._stopped = False
        self.quantization = None
        if self._spmd and quantize != "off":
            # the JAX engine's order: the global tables quantized on a
            # copy, then placed under the partition rules (the scale
            # column falls to the replicated catch-all)
            self._params, self.quantization = quantize_embedding_params(
                model.layers, self._global_params(), quantize)
        if model.mesh is not None:
            self._place_on_mesh()
        # tiered storage, built before the params move to the card (a
        # tiered table never lands there whole) and before warmup (every
        # bucket's graph captures against the hot tiers)
        self.storage = {"mode": "resident"}
        self._tiered: Dict[str, Any] = {}  # input name -> (op, store)
        if storage == "tiered":
            self._build_tiered()
        self._params = {op: {k: to_device(v, self.device)
                             for k, v in d.items()}
                        for op, d in self._params.items()}
        # batch norm's running statistics (the JAX engine's): bare params
        # would serve on batch statistics, rows leaking into each other
        bn = getattr(params_or_state, "bn_state", None) or {}
        if not bn and any(getattr(op, "has_state", False)
                          for op in model.layers):
            raise ValueError(
                "model has BatchNorm state but none was provided: pass a "
                "TrainState (bare params would serve on batch statistics, "
                "breaking the padding contract)")
        self._bn = {op: {k: v.to(self.device) for k, v in d.items()}
                    for op, d in bn.items()}
        # the tables re-encoded on a copy of the params tree, on the card
        if self.quantization is None:
            self._params, self.quantization = quantize_embedding_params(
                model.layers, self._params, quantize)
        self.stats = stats or LatencyStats()
        self._in_specs = {t.name: (tuple(t.shape[1:]), numpy_dtype(t.dtype))
                          for t in model._inputs}
        self._dtypes = {t.name: t.dtype for t in model._inputs}
        self._graphs: Dict[int, GraphRunner] = {}
        # the model's compile the bucket graphs were built under
        self._generation = model.compile_generation
        self._pool = None
        self._lock = threading.Lock()
        # /metrics scrapes the per-bucket dispatch counts that
        # stats.record_dispatch keeps under its own lock
        _metrics.track_engine(self)
        if warmup:
            self.warmup()

    # ---------------------------------------------------------------- mesh
    def _global_params(self) -> Dict[str, dict]:
        """Every parameter's global value: a mesh block (a state trained
        or restored on the mesh) gathered, a collective every rank joins
        in the tree's order; a global value as it is."""
        from ..parallel.spmd import global_param
        return {op: {k: global_param(v) for k, v in d.items()}
                for op, d in self._params.items()}

    def _place_on_mesh(self) -> None:
        """The JAX engine's mesh placement: ``partition_rules`` kept on
        the engine, ``_mesh_sharded`` when any parameter's rule shards it
        (a fully replicated tree is a replica), a sharded engine's
        buckets rounded up to the data size.  Across ranks each leaf
        becomes the rank's block: one already a mesh block (a state
        trained or restored on this mesh) is kept, a global value is cut
        by its rule."""
        from ..parallel.mesh import (DATA_AXIS, apply_partition_rules,
                                     partition_rules, rule_spec)
        model, mesh = self.model, self.model.mesh
        self.partition_rules = partition_rules(model)
        shapes = {op.name: {p.param_name: tuple(p.shape)
                            for p in op.param_specs()}
                  for op in model.layers}
        sharded = False
        placed = {}
        for op_name, d in self._params.items():
            placed[op_name] = {}
            for k, v in d.items():
                layout = getattr(v, "_ff_layout", None)
                if layout is not None:
                    spec = layout[1]
                else:
                    spec = rule_spec(self.partition_rules, f"{op_name}/{k}",
                                     shapes.get(op_name, {}).get(
                                         k, tuple(v.shape)), mesh)
                    if self._spmd:
                        v = apply_partition_rules(
                            self.partition_rules, {op_name: {k: v}},
                            mesh)[op_name][k]
                sharded = sharded or any(ax is not None for ax in spec)
                placed[op_name][k] = v
        self._params = placed
        self._mesh_sharded = sharded
        dsize = mesh.shape.get(DATA_AXIS, 1)
        if self._mesh_sharded and dsize > 1:
            # a sharded engine on a data+model mesh runs data-divisible
            # buckets only, as the JAX engine compiles them (predict
            # pads the same way)
            self.buckets = sorted({-(-b // dsize) * dsize
                                   for b in self.buckets})

    @property
    def is_leader(self) -> bool:
        """Whether this rank owns the batcher and returns the results
        (rank 0; always, off a mesh of more than one rank)."""
        if not self._spmd:
            return True
        import torch.distributed as dist
        return dist.get_rank() == 0

    def _comm_device(self) -> torch.device:
        import torch.distributed as dist
        return (self.device if dist.get_backend() == "nccl"
                else torch.device("cpu"))

    def _mesh_forward(self, inputs: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
        """One padded bucket's forward on this rank: the mesh's forward
        (a sharded engine: the rank's rows, the output gathered on every
        rank) or, for a replica, the one-device program on the whole
        bucket."""
        model = self.model
        with torch.inference_mode():
            if not self._mesh_sharded:
                x = {k: v.to(self.device, self._dtypes[k])
                     for k, v in inputs.items()}
                values, _ = model._apply_plain(self._params, x,
                                               bn_state=self._bn)
                out = model.final_tensor
                return values[out.uid].to(out.dtype)
            placed = model._place_inputs(inputs, self.device)
            return model._forward_fn(self._params, placed, self._bn)

    def _broadcast_bucket(self, cmd: int, b: int,
                          padded: Optional[Dict[str, torch.Tensor]] = None
                          ) -> None:
        """The leader's half of one step of the protocol: the header
        ``[cmd, b]`` (cmd 1: a bucket follows, 0: stop) on the host
        group, then each input of the padded bucket, in the model's input
        order, over the world group."""
        import torch.distributed as dist
        dev = self._comm_device()
        dist.broadcast(torch.tensor([cmd, b], dtype=torch.int64), src=0,
                       group=self._head_group)
        for name in (self._in_specs if cmd else ()):
            dist.broadcast(padded[name].to(dev).contiguous(), src=0)

    def _stop_followers(self) -> None:
        """Send the stop once (the leader's close and error path)."""
        if self._spmd and self.is_leader and not self._stopped:
            self._stopped = True
            self._broadcast_bucket(0, 0)

    def follow(self) -> int:
        """A follower rank's loop (every rank but 0 under a mesh of more
        than one rank): receive each bucket the leader broadcasts, run
        its forward with the leader, until the leader's stop.  Returns
        the buckets served.  Each wait for the next bucket's header is a
        gloo collective on the host, under gloo and NCCL alike, bounded
        by the process group's collective deadline: past it, or as soon
        as the leader's process is gone and its connection closed, it
        raises ``RuntimeError`` ("follow(): the leader ..."), chained
        from gloo's error, so a dead leader never parks a follower and
        never leaves an NCCL collective for the watchdog to end."""
        import torch.distributed as dist
        if self.is_leader:
            raise ValueError("follow() runs on the ranks other than 0 of a "
                             "mesh of more than one rank; rank 0 serves")
        dev = self._comm_device()
        served = 0
        while True:
            head = torch.zeros(2, dtype=torch.int64)
            try:
                dist.broadcast(head, src=0, group=self._head_group)
            except RuntimeError as e:
                raise RuntimeError(
                    f"follow(): the leader (rank 0) sent no bucket and no "
                    f"stop within the group's collective deadline, or its "
                    f"connection closed, after {served} buckets: the "
                    f"leader is gone") from e
            cmd, b = (int(x) for x in head.tolist())
            if cmd == 0:
                self._stopped = True
                return served
            inputs = {}
            for name, (shape, _) in self._in_specs.items():
                t = torch.empty((b,) + shape, dtype=self._dtypes[name],
                                device=dev)
                dist.broadcast(t, src=0)
                inputs[name] = t
            with self._lock:
                self._mesh_forward(inputs)
            served += 1

    def close(self) -> None:
        """Release the followers (the leader of a mesh of more than one
        rank broadcasts the stop); a no-op elsewhere, and when called
        again."""
        with self._lock:
            self._stop_followers()

    def _mesh_dispatch(self, padded: Dict[str, np.ndarray], b: int
                       ) -> torch.Tensor:
        """The leader's padded bucket through the protocol, under the
        engine's lock: broadcast, then the forward on every rank.  A
        failure after the broadcast sends the stop (the followers may be
        inside the collective the leader left) and re-raises."""
        if not self.is_leader:
            raise ValueError("a follower rank serves through follow(); "
                             "rank 0 takes the requests")
        if self._stopped:
            raise RuntimeError("this mesh engine is closed: its followers "
                               "have stopped")
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self._dtypes[k]) for k, v in padded.items()}
        try:
            self._broadcast_bucket(1, b, tensors)
            return self._mesh_forward(tensors)
        except BaseException:
            try:
                self._stop_followers()
            except Exception:  # noqa: BLE001 — the group may be broken
                pass
            raise

    # ------------------------------------------------------------ construction
    @classmethod
    def from_checkpoint(cls, model, path: str,
                        on_mesh_change: str = "error",
                        **kwargs) -> "InferenceEngine":
        """Build an engine from a training checkpoint without optimizer
        slots in memory: ``path`` is a ``CheckpointManager`` directory
        (the newest checkpoint that verifies is used) or one committed
        checkpoint directory.  Restores with ``inference_only=True`` to
        the host, and the engine places what it serves (a tiered table
        never lands on the card whole); ``kwargs`` go to the
        constructor."""
        import os

        from ..checkpoint import CheckpointError, restore_checkpoint
        from ..resilience.manager import latest_checkpoint

        ckpt = latest_checkpoint(path)
        if ckpt is None:
            # not a manager directory -> one committed checkpoint
            # directory; but a manager directory whose every ckpt-* is
            # corrupt must say so, not "no meta.json" about the parent
            try:
                has_entries = any(n.startswith("ckpt-")
                                  for n in os.listdir(path))
            except OSError:
                has_entries = False
            if has_entries:
                raise CheckpointError(
                    f"{path!r} contains checkpoints but none verify "
                    f"(all corrupt/partial) — nothing to serve from")
            ckpt = path
        state = restore_checkpoint(ckpt, model=model, inference_only=True,
                                   on_mesh_change=on_mesh_change,
                                   device="cpu")
        return cls(model, state, **kwargs)

    # ------------------------------------------------------- tiered storage
    def _build_tiered(self) -> None:
        """Per embedding op: structural eligibility, then the
        kernel_costs price (predicted hit rate from the row-frequency
        counters), then build the store, warm-start its LFU admission,
        and put its hot tier in the op's ``embedding`` slot, so warmup
        captures against it.  Ops left resident are recorded in
        ``self.storage['fallbacks']`` with their reason."""
        from ..storage import (TieredEmbeddingTable, default_table_keys,
                               predicted_hit_rate, tiered_decision)

        cfg = self.model.config
        hot_budget = int(getattr(cfg, "storage_hot_rows", 4096))
        top = self.buckets[-1]
        tables: Dict[str, Any] = {}
        fallbacks: Dict[str, str] = {}
        for op in self.model.layers:
            kind = getattr(op, "op_type", "")
            if kind not in ("Embedding", "StackedEmbedding",
                            "RaggedStackedEmbedding"):
                continue
            if kind == "Embedding":
                rows = [op.num_entries]
            elif kind == "StackedEmbedding":
                rows = [op.num_entries] * op.num_tables
            else:
                rows = list(op.row_counts)
            # structural eligibility, JAX's reasons: tiering remaps ids
            # against ONE plain per-table row space on the device — a mesh
            # (a sharded row space; the live table exchange runs only
            # under one) and a host-placed table are out (the port has no
            # lane-packed storage)
            ishape = op.inputs[0].shape  # includes the batch dim
            bag = ishape[-1] if len(ishape) >= (
                3 if kind != "Embedding" else 2) else 1
            hot_per = [min(hot_budget, r) for r in rows]
            reason = None
            if self.model.mesh is not None:
                reason = "mesh-native serving (sharded row space)"
            elif getattr(op, "placement", "tpu") == "cpu":
                reason = "host-placed table (already off-device)"
            elif min(hot_per) < top * bag:
                reason = (f"hot tier ({min(hot_per)} slots) below "
                          f"one bucket's worst-case working set "
                          f"({top}x{bag} ids)")
            if reason is None:
                table = self._params[op.name]["embedding"]
                keys = default_table_keys(op.inputs[0].name, len(rows))
                hit, observed = predicted_hit_rate(keys, rows, hot_per)
                ok, reason = tiered_decision(
                    num_rows=sum(rows), dim=op.out_dim,
                    itemsize=table.element_size(),
                    hot_rows=sum(hot_per), lookups=top * bag * len(rows),
                    hit_rate=hit)
                if ok:
                    store = TieredEmbeddingTable(
                        op.inputs[0].name, table, hot_budget,
                        row_counts=(rows if kind ==
                                    "RaggedStackedEmbedding" else None),
                        table_keys=keys, device=self.device)
                    store.reserve(top * bag * len(rows))
                    warmed = store.warm_from_rowfreq()
                    # a copy of the op's dict: the caller's state keeps
                    # its full table
                    self._params[op.name] = {
                        **self._params[op.name],
                        "embedding": store.hot_param()}
                    self._tiered[op.inputs[0].name] = (op.name, store)
                    tables[op.name] = {
                        "input": op.inputs[0].name, "kind": store.kind,
                        "rows": store.total_rows,
                        "hot_slots": store.hot_slots,
                        "policy": store.policy_name,
                        "predicted_hit": round(hit, 4),
                        "observed_traffic": observed,
                        "warm_admitted": warmed, "why": reason}
                    continue
            fallbacks[op.name] = reason
        self.storage = {
            "mode": "tiered" if tables else "resident",
            "hot_rows": hot_budget, "tables": tables,
            "fallbacks": fallbacks}

    def storage_stats(self) -> Dict[str, Any]:
        """The live tiered-store counters summed across this engine's
        stores (empty when serving resident): what a benchmark records
        beside the dlrm_embed_cache_* gauges."""
        stores = [s for _, s in self._tiered.values()]
        if not stores:
            return {}
        stats = [s.stats() for s in stores]
        lookups = sum(s["lookups"] for s in stats)
        hits = sum(s["hits"] for s in stats)
        return {
            "lookups": lookups, "hits": hits,
            "misses": sum(s["misses"] for s in stats),
            "hit_pct": 100.0 * hits / max(1, lookups),
            "evictions": sum(s["evictions"] for s in stats),
            "writebacks": sum(s["writebacks"] for s in stats),
            "stall_us_total": sum(s["stall_us_total"] for s in stats),
            "stall_us_last": max(s["stall_us_last"] for s in stats),
            "per_store": stats,
        }

    # ---------------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Build every bucket's graph outside the serving path, so
        steady-state traffic never waits on a kernel build, a capture or
        a first allocation.  On the card every kernel is built first:
        the dispatch path reaches kernels no bucket's forward runs (a
        tiered store's first miss launches the row set), and a kernel's
        first launch builds it under the engine's lock.  Across ranks
        the leader runs each bucket once through the protocol (the
        followers join it in :meth:`follow`), a follower builds the
        kernels only."""
        if self.device.type == "cuda":
            _cuda.build()
        if self._spmd:
            if not self.is_leader:
                return
            for b in self.buckets:
                zeros = {name: np.zeros((b,) + shape, dtype=dtype)
                         for name, (shape, dtype) in self._in_specs.items()}
                t0 = time.perf_counter()
                with self._lock:
                    self._mesh_dispatch(zeros, b)
                record_compile("aot", time.perf_counter() - t0,
                               fn=f"serve[bucket={b}]", donated_args=0,
                               backend=self.device.type)
            return
        for b in self.buckets:
            self._ensure(b)

    @property
    def graph_replays(self) -> int:
        """Dispatches replayed from the buckets' graphs (on the CPU, and
        with ``aot=False``: runs of the runners)."""
        return sum(r.replays for r in self._graphs.values())

    def _forward(self, static, params):
        return self.model._forward_fn(params, static, self._bn)

    def _ensure(self, b: int) -> GraphRunner:
        """Bucket ``b``'s runner, built under the engine's lock at its
        first use: one eager forward on zero inputs, then the capture
        (none with ``aot=False``), timed together as the bucket's
        ``compile`` event (emitted outside the lock).  A recompile of
        the model (a new loss or activation dtype) drops every bucket's
        graph first: a captured forward never replays a compile it was
        not built under."""
        runner = self._graphs.get(b)
        if (runner is not None
                and self._generation == self.model.compile_generation):
            return runner
        built = None
        with self._lock:
            if self._generation != self.model.compile_generation:
                self._graphs.clear()
                self._pool = None
                self._generation = self.model.compile_generation
            if b not in self._graphs:
                t0 = time.perf_counter()
                dummy = {name: torch.zeros((b,) + shape,
                                           dtype=self._dtypes[name],
                                           device=self.device)
                         for name, (shape, _) in self._in_specs.items()}
                run_eager(self._forward, dummy, self._params,
                          device=self.device)
                if self.device.type == "cuda" and self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                self._graphs[b] = GraphRunner(
                    self._forward, dummy, self._params, pool=self._pool,
                    lock=self._lock, capture=self._aot)
                built = time.perf_counter() - t0
            runner = self._graphs[b]
        if built is not None:
            record_compile("aot", built, fn=f"serve[bucket={b}]",
                           donated_args=0, backend=self.device.type)
        return runner

    # --------------------------------------------------------------- serving
    def bucket_for(self, n: int) -> Optional[int]:
        """The smallest bucket holding ``n`` rows, or None when ``n``
        exceeds the largest bucket (predict then chunks by it)."""
        for b in self.buckets:
            if b >= n:
                return b
        return None

    @staticmethod
    def _pad(arr: np.ndarray, n: int, b: int) -> np.ndarray:
        if n == b:
            return arr
        pad = np.zeros((b - n,) + arr.shape[1:], dtype=arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def predict(self, inputs: Dict[str, Any], queue_wait_us: float = 0.0,
                timings: Optional[Dict[str, float]] = None) -> np.ndarray:
        """Run the labels-free forward on ``inputs`` (dict name -> (n, ...)
        array), padding to the enclosing bucket and slicing the padding
        back off; batches larger than the top bucket run as top-bucket
        chunks.  Returns a host numpy array.

        ``queue_wait_us`` rides the dispatch event; ``timings`` (an
        optional out-param) receives the last chunk's ``bucket``,
        ``pad_us``, ``compute_us`` and ``stall_us`` (the
        dlrm_embed_cache_miss_stall_us gauge when tiered, else 0), the
        batcher's tail-exemplar decomposition."""
        arrs = {}
        n = None
        for name, (_shape, dtype) in self._in_specs.items():
            if name not in inputs:
                raise ValueError(f"predict inputs missing {name!r} "
                                 f"(model inputs: {sorted(self._in_specs)})")
            a = np.asarray(inputs[name], dtype=dtype)
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    f"inconsistent request batch: {name!r} has "
                    f"{a.shape[0]} rows, expected {n}")
            arrs[name] = a
        if not n:
            raise ValueError("empty request (0 rows)")
        top = self.buckets[-1]
        chunks = []
        for lo in range(0, n, top):
            m = min(n - lo, top)
            chunks.append(self._dispatch(
                {k: v[lo:lo + m] for k, v in arrs.items()}, m,
                queue_wait_us, timings))
        if len(chunks) == 1:
            return chunks[0]
        return np.concatenate(chunks, axis=0)

    def _dispatch(self, chunk: Dict[str, np.ndarray], m: int,
                  queue_wait_us: float,
                  timings: Optional[Dict[str, float]] = None) -> np.ndarray:
        """One dispatch: under the engine's lock, remap every tiered
        input (each store enqueues its misses' copy and row-set install;
        none when resident), pad, and enqueue the replay and the output's
        copy out of the graph; then fence, and let the stores read their
        miss stalls.  Lock order: the engine's, then a store's (a store
        never takes the engine's).  The bucket's build stays outside: it
        has its own compile event.  With an event log active the spans
        are emitted after the fence, outside the lock, under the caller's
        current span (the batcher's ``serve.dispatch``)."""
        b = self.bucket_for(m)
        runner = None if self._spmd else self._ensure(b)
        notes = []
        with self._lock:
            t_remap = time.perf_counter()
            if self._tiered:
                chunk = dict(chunk)
                for name, (_, store) in self._tiered.items():
                    ids, info = store._remap_deferred(chunk[name])
                    chunk[name] = ids.astype(chunk[name].dtype, copy=False)
                    notes.append((store, info))
            t_pad = time.perf_counter()
            padded = {k: self._pad(v, m, b) for k, v in chunk.items()}
            t0 = time.perf_counter()
            if runner is None:
                out = self._mesh_dispatch(padded, b)[:m]
            else:
                out = runner.run_locked(padded, self._params)[:m]
        out = out.cpu().numpy()  # the device-to-host copy is the fence
        t1 = time.perf_counter()
        for store, info in notes:
            store._note(info)
        compute_us = (t1 - t0) * 1e6
        self.stats.record_dispatch(bucket=b, lat_us=compute_us)
        if timings is not None:
            timings["bucket"] = float(b)
            timings["pad_us"] = (t0 - t_pad) * 1e6
            timings["compute_us"] = compute_us
            stall = _metrics.EMBED_CACHE_MISS_STALL_US.value
            timings["stall_us"] = (float(stall) if self._tiered
                                   and stall is not None else 0.0)
        if active_log() is not None:
            attrs = {"batch": m, "bucket": b}
            parent = current_span()
            now_s, now = time.time(), time.perf_counter()
            spans = (("serve.storage_remap", t_remap, t_pad),) \
                if self._tiered else ()
            for name, a, z in spans + (("serve.pad", t_pad, t0),
                                       ("serve.engine_forward", t0, t1)):
                record_span(name, now_s - (now - a), (z - a) * 1e6,
                            parent=parent, attrs=attrs)
            emit("serve", phase="dispatch", batch=m, bucket=b, padded=b - m,
                 fill=m / b, queue_wait_us=float(queue_wait_us),
                 compute_us=compute_us)
        return out
