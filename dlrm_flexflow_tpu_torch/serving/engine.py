"""Bucketed inference engine (counterpart of
``dlrm_flexflow_tpu/serving/engine.py``), resident and single-device.

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
build and load, cuBLAS and the allocator).  The buckets' graphs share one
memory pool and one lock.  A dispatch copies the padded request into the
bucket's static inputs, replays, and copies the rows back.  On the CPU
the same runner calls the forward on the same static inputs.

``quantize="int8"|"bf16"`` (default ``FFConfig.serve_quantize``)
re-encodes the tables of a copy of the params at load
(``ops/quantized.py``; ``engine.quantization`` is the JAX package's byte
report), and every bucket's graph captures the quantized forward.

Every dispatch emits one ``serve`` ``phase="dispatch"`` event and, under
the caller's span, the ``serve.pad`` and ``serve.engine_forward`` spans;
every bucket's capture emits a ``compile`` event (``kind="aot"``,
``fn="serve[bucket=b]"``), and the engine's per-bucket dispatch counts
are scraped by ``/metrics`` (``telemetry.metrics.track_engine``).

Not ported yet: tiered storage (ROADMAP.md Queue A item 5) and
mesh-native serving (the scale-out slice; a model compiled here has no
mesh).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graphs import GraphRunner, run_eager
from ..ops.quantized import QUANT_MODES, quantize_embedding_params
from ..telemetry import active_log, emit
from ..telemetry import metrics as _metrics
from ..telemetry.torch_hooks import record_compile
from ..telemetry.trace import NULL_SPAN, span as trace_span
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
    they are already there).  ``buckets`` overrides
    ``model.config.serve_buckets``; ``quantize`` overrides
    ``model.config.serve_quantize`` ("off", "int8" or "bf16"): the tables
    are quantized on a copy of the params, so the training state is
    never touched.
    """

    def __init__(self, model, params_or_state=None,
                 buckets: Optional[Union[str, Sequence[int]]] = None,
                 warmup: bool = True,
                 stats: Optional[LatencyStats] = None,
                 quantize: Optional[str] = None,
                 storage: Optional[str] = None,
                 device=None):
        if getattr(model, "_forward_fn", None) is None:
            raise ValueError(
                "model must be compile()d before building an "
                "InferenceEngine (no forward exists yet)")
        if params_or_state is None:
            raise ValueError(
                "InferenceEngine needs parameters: pass a TrainState or a "
                "params dict")
        quantize = (quantize or getattr(model.config, "serve_quantize", "off")
                    or "off").strip().lower()
        if quantize not in QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r} "
                             f"(have {QUANT_MODES})")
        storage = (storage or getattr(model.config, "serve_storage",
                                      "resident") or "resident").strip().lower()
        if storage != "resident":
            raise NotImplementedError(
                f"serve_storage={storage!r}: tiered storage is not ported "
                "yet (ROADMAP.md Queue A item 5)")
        self.device = resolve_device(device)
        self.model = model
        params = getattr(params_or_state, "params", params_or_state)
        self._params = {op: {k: v.to(self.device) for k, v in d.items()}
                        for op, d in params.items()}
        # the tables re-encoded on a copy of the params tree, on the card
        self._params, self.quantization = quantize_embedding_params(
            model.layers, self._params, quantize)
        if buckets is None:
            buckets = getattr(model.config, "serve_buckets", None)
        self.buckets = parse_buckets(buckets)
        self.stats = stats or LatencyStats()
        self._in_specs = {t.name: (tuple(t.shape[1:]), numpy_dtype(t.dtype))
                          for t in model._inputs}
        self._dtypes = {t.name: t.dtype for t in model._inputs}
        self._graphs: Dict[int, GraphRunner] = {}
        self._pool = None
        self._lock = threading.Lock()
        # /metrics scrapes the per-bucket dispatch counts that
        # stats.record_dispatch keeps under its own lock
        _metrics.track_engine(self)
        if warmup:
            self.warmup()

    # ---------------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Build every bucket's graph outside the serving path, so
        steady-state traffic never waits on a kernel build, a capture or
        a first allocation."""
        for b in self.buckets:
            self._ensure(b)

    @property
    def graph_replays(self) -> int:
        """Dispatches replayed from the buckets' graphs (on the CPU: runs
        of the runners)."""
        return sum(r.replays for r in self._graphs.values())

    def _forward(self, static, params):
        return self.model._forward_fn(params, static)

    def _ensure(self, b: int) -> GraphRunner:
        """Bucket ``b``'s runner, built under the engine's lock at its
        first use: one eager forward on zero inputs, then the capture,
        timed together as the bucket's ``compile`` event (emitted outside
        the lock)."""
        runner = self._graphs.get(b)
        if runner is not None:
            return runner
        built = None
        with self._lock:
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
                    lock=self._lock)
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
        ``pad_us``, ``compute_us`` and ``stall_us`` (0: no tiered store),
        the batcher's tail-exemplar decomposition."""
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
        # with an event log active the spans nest under the caller's
        # current span (the batcher's serve.dispatch) and the dispatch
        # is one event; with none, the spans are the no-op NULL_SPAN.
        # The bucket's build stays outside the pad span: it has its own
        # compile event
        b = self.bucket_for(m)
        runner = self._ensure(b)
        traced = active_log() is not None
        attrs = {"batch": m, "bucket": b} if traced else None
        t_pad = time.perf_counter()
        with (trace_span("serve.pad", attrs=attrs) if traced
              else NULL_SPAN):
            padded = {k: self._pad(v, m, b) for k, v in chunk.items()}
        t0 = time.perf_counter()
        with (trace_span("serve.engine_forward", attrs=attrs) if traced
              else NULL_SPAN):
            # the device-to-host copy of the result is the fence
            out = runner.run(padded, self._params)[:m].cpu().numpy()
        compute_us = (time.perf_counter() - t0) * 1e6
        self.stats.record_dispatch(bucket=b, lat_us=compute_us)
        if timings is not None:
            timings["bucket"] = float(b)
            timings["pad_us"] = (t0 - t_pad) * 1e6
            timings["compute_us"] = compute_us
            timings["stall_us"] = 0.0
        if traced:
            emit("serve", phase="dispatch", batch=m, bucket=b, padded=b - m,
                 fill=m / b, queue_wait_us=float(queue_wait_us),
                 compute_us=compute_us)
        return out
