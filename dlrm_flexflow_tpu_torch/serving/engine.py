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

Not ported yet: quantized tables and tiered storage (the
serving-extras slice), mesh-native serving (the scale-out slice; a model
compiled here has no mesh), see ROADMAP.md.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..graphs import GraphRunner, run_eager
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
    ``model.config.serve_buckets``.
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
        if quantize != "off":
            raise NotImplementedError(
                f"serve_quantize={quantize!r}: quantized tables come with "
                "the serving-extras slice in ROADMAP.md")
        storage = (storage or getattr(model.config, "serve_storage",
                                      "resident") or "resident").strip().lower()
        if storage != "resident":
            raise NotImplementedError(
                f"serve_storage={storage!r}: tiered storage comes with the "
                "serving-extras slice in ROADMAP.md")
        self.device = resolve_device(device)
        self.model = model
        params = getattr(params_or_state, "params", params_or_state)
        self._params = {op: {k: v.to(self.device) for k, v in d.items()}
                        for op, d in params.items()}
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
        first use: one eager forward on zero inputs, then the capture."""
        runner = self._graphs.get(b)
        if runner is not None:
            return runner
        with self._lock:
            if b not in self._graphs:
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
            return self._graphs[b]

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

    def predict(self, inputs: Dict[str, Any]) -> np.ndarray:
        """Run the labels-free forward on ``inputs`` (dict name -> (n, ...)
        array), padding to the enclosing bucket and slicing the padding
        back off; batches larger than the top bucket run as top-bucket
        chunks.  Returns a host numpy array."""
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
                {k: v[lo:lo + m] for k, v in arrs.items()}, m))
        if len(chunks) == 1:
            return chunks[0]
        return np.concatenate(chunks, axis=0)

    def _dispatch(self, chunk: Dict[str, np.ndarray], m: int) -> np.ndarray:
        b = self.bucket_for(m)
        runner = self._ensure(b)
        padded = {k: self._pad(v, m, b) for k, v in chunk.items()}
        t0 = time.perf_counter()
        # the device-to-host copy of the result is the fence
        out = runner.run(padded, self._params)[:m].cpu().numpy()
        self.stats.record_dispatch(bucket=b,
                                   lat_us=(time.perf_counter() - t0) * 1e6)
        return out
