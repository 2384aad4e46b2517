"""Per-op cost measurement and the H100 machine model (counterpart of
``dlrm_flexflow_tpu/sim/cost_model.py``; reference
src/runtime/simulator.cu:21-76, the device and link graph with its
bandwidth constants, and simulator.cc:235-273, the memoized real-kernel
timing ``measure_op_forward/backward_time``).

Three cost sources, all memoized:
  * measured   — the op's forward and backward run on the CUDA card,
                 ``measure_iters`` calls captured in one CUDA graph and
                 its replay timed with CUDA events (the reference's
                 approach: real kernels);
  * analytic   — roofline estimate max(FLOPs / peak, bytes / HBM rate)
                 plus one launch, from :class:`H100MachineModel`;
  * calibrated — the analytic roofline scaled by per-op-class factors
                 (any object with ``scale_for(op) -> (fwd, bwd)``: the
                 port's ``sim.tune.Calibration``, fitted from ``op_time``
                 telemetry by the closed loop, or the JAX package's).

The formulas are the JAX package's, so that under the same constants the
two packages price every op, transfer and collective bit for bit; only
the constants are the H100's.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class PodTopology:
    """Two-level cluster shape: ``num_slices`` nodes of
    ``chips_per_slice`` GPUs each.  The names are the JAX package's (a
    TPU pod's ICI slices joined by DCN) and its strategy and artifact
    JSON keeps them; on H100 machines a slice is a node whose GPUs share
    an NVSwitch, and the nodes are joined by InfiniBand.

    Flat device ids map to nodes contiguously: device ``d`` lives on node
    ``d // chips_per_slice``.  ``num_slices=1`` is the flat model (every
    transfer rides NVLink) and prices bit-identically to a machine
    without a topology."""

    num_slices: int = 1
    chips_per_slice: int = 1

    def __post_init__(self):
        if int(self.num_slices) < 1 or int(self.chips_per_slice) < 1:
            raise ValueError(
                f"PodTopology needs >=1 slices of >=1 chips, got "
                f"{self.num_slices}x{self.chips_per_slice}")
        object.__setattr__(self, "num_slices", int(self.num_slices))
        object.__setattr__(self, "chips_per_slice",
                           int(self.chips_per_slice))

    @property
    def num_devices(self) -> int:
        return self.num_slices * self.chips_per_slice

    def slice_of(self, device: int) -> int:
        """The node a flat device id lives on (ids beyond the cluster
        fold modulo, matching the simulator's ``dev % num_devices``)."""
        return (int(device) % self.num_devices) // self.chips_per_slice

    def same_slice(self, a: int, b: int) -> bool:
        return self.slice_of(a) == self.slice_of(b)

    def slices_spanned(self, devices: Sequence[int]) -> int:
        """How many distinct nodes a device list touches (>=1)."""
        if not devices:
            return 1
        return len({self.slice_of(d) for d in devices})

    def local_group(self, devices: Sequence[int]) -> int:
        """Largest per-node participant count of a device list: the
        within-node group size the hierarchical collectives ring over."""
        if not devices:
            return 1
        counts: Dict[int, int] = {}
        for d in devices:
            s = self.slice_of(d)
            counts[s] = counts.get(s, 0) + 1
        return max(counts.values())

    def to_json(self) -> dict:
        return {"num_slices": self.num_slices,
                "chips_per_slice": self.chips_per_slice}

    @staticmethod
    def from_json(d: dict) -> "PodTopology":
        return PodTopology(int(d["num_slices"]),
                           int(d["chips_per_slice"]))

    @staticmethod
    def parse(spec: str) -> "PodTopology":
        """``"<slices>x<chips>"`` (e.g. ``"2x4"``) -> PodTopology."""
        try:
            s, c = spec.lower().split("x")
            return PodTopology(int(s), int(c))
        except (ValueError, AttributeError):
            raise ValueError(
                f"pod topology spec must look like '2x4' "
                f"(slices x chips-per-slice), got {spec!r}") from None


@dataclass
class H100MachineModel:
    """NVIDIA H100 SXM5 constants, with the method names of the JAX
    package's ``TPUMachineModel``.  Rates in bytes/s and FLOP/s.

    From NVIDIA's H100 Tensor Core GPU data sheet (SXM5 column): HBM3
    3.35 TB/s and 80 GB; FP64 tensor core 67 TFLOP/s; FP32 67 TFLOP/s;
    BF16 tensor core 989 TFLOP/s dense (1,979 with sparsity); NVLink 4 at
    900 GB/s a GPU over 18 links; and for the scale-out fabric, an
    InfiniBand NDR NIC at 400 Gb/s (50 GB/s).

    The link formulas keep the JAX structure with these meanings:
    ``ici_time`` prices one NVLink hop at ``nvlink_bandwidth``, a GPU's
    whole NVLink port into the NVSwitch in one direction (900 GB/s over
    both directions, so 450 GB/s each way) where the JAX model prices one
    ICI ring link; the ring collectives then ring over the switch.
    ``dcn_time`` prices the inter-node hop at one NIC's rate.
    ``topology`` (a :class:`PodTopology`) makes transfers and collectives
    two-level: NVLink within a node, InfiniBand across nodes; ``None`` is
    the flat one-node model.
    """

    name: str = "h100-sxm5"
    peak_flops_bf16: float = 989e12
    # The port's f32 Linear layers run as f64 GEMMs (ops/base.py::matmul
    # accumulates in f64 so that a row does not depend on its batch), and
    # the FP64 tensor-core rate is the same 67 TFLOP/s.  This is not the
    # TF32 rate: the port never runs TF32.
    peak_flops_f32: float = 67e12
    hbm_bandwidth: float = 3.35e12
    hbm_bytes: float = 80e9
    nvlink_bandwidth: float = 450e9   # per GPU, per direction
    nvlink_links_per_gpu: int = 18
    ib_bandwidth: float = 50e9        # per NIC (NDR, 400 Gb/s)
    # an empty kernel's launch in a CUDA graph: 977.5 ns, chip_smoke.py
    # phase 20(a) (OP_BOUNDARY_NS), on an NVIDIA H100 80GB HBM3 at
    # 700.00 W; the empty kernel read 0.82-1.03 us across the timing
    # phases of the same script
    kernel_launch_overhead: float = 0.9775e-6
    topology: Optional[PodTopology] = None

    def matmul_time(self, flops: float, dtype: str = "bfloat16") -> float:
        peak = (self.peak_flops_bf16 if dtype in ("bfloat16", "bf16")
                else self.peak_flops_f32)
        # the JAX model's 60% utilisation for small ops, kept: the
        # measured mode is the card's own number
        return flops / (0.6 * peak)

    def memory_time(self, bytes_moved: float) -> float:
        return bytes_moved / self.hbm_bandwidth

    def ici_time(self, bytes_moved: float, hops: int = 1) -> float:
        """One transfer over NVLink through the NVSwitch (``hops`` times
        the port rate; the JAX model's one ICI ring link)."""
        return hops * bytes_moved / self.nvlink_bandwidth

    def xfer_time(self, bytes_moved: float, src: Optional[int] = None,
                  dst: Optional[int] = None) -> float:
        """One point-to-point transfer, routed by the topology: NVLink
        when ``src`` and ``dst`` share a node (or without a topology or
        device ids: the flat model), InfiniBand across nodes."""
        t = self.topology
        if (t is None or t.num_slices <= 1 or src is None or dst is None
                or t.same_slice(src, dst)):
            return self.ici_time(bytes_moved)
        return self.dcn_time(bytes_moved)

    # Collective group shape: ``devices`` (when the caller knows the
    # placement, as the simulator's gradient sync does) pins which nodes
    # take part; without it n participants fill ceil(n / chips_per_slice)
    # nodes.
    def _group(self, n: int, devices: Optional[Sequence[int]]
               ) -> Tuple[int, int]:
        """(nodes spanned, within-node group) of an n-GPU collective."""
        t = self.topology
        if t is None or t.num_slices <= 1 or n <= 1:
            return 1, n
        if devices:
            return t.slices_spanned(devices), t.local_group(devices)
        s = min(t.num_slices, -(-n // t.chips_per_slice))  # ceil
        return s, min(n, t.chips_per_slice)

    def all_reduce_time(self, bytes_per_chip: float, n: int,
                        devices: Optional[Sequence[int]] = None) -> float:
        """Ring all-reduce: 2(n-1)/n of the bytes over NVLink inside one
        node.  Across nodes it is hierarchical: a reduce-scatter within
        each node over NVLink, an all-reduce of the 1/m shard across
        nodes over InfiniBand, and the all-gather back over NVLink."""
        if n <= 1:
            return 0.0
        s, m = self._group(n, devices)
        if s <= 1:
            return self.ici_time(2.0 * (n - 1) / n * bytes_per_chip)
        m = max(m, 1)
        within = 2.0 * self.ici_time((m - 1) / m * bytes_per_chip)
        across = self.dcn_time(2.0 * (s - 1) / s * bytes_per_chip / m)
        return within + across

    def all_gather_time(self, bytes_per_chip: float, n: int,
                        devices: Optional[Sequence[int]] = None) -> float:
        if n <= 1:
            return 0.0
        s, m = self._group(n, devices)
        if s <= 1:
            return self.ici_time((n - 1) / n * bytes_per_chip * n)
        m = max(m, 1)
        # within-node all-gather, the exchange of each node's block with
        # the s-1 other nodes, the broadcast of the foreign blocks
        within = self.ici_time((m - 1) * bytes_per_chip)
        across = self.dcn_time((s - 1) * m * bytes_per_chip)
        bcast = self.ici_time((s - 1) * m * bytes_per_chip)
        return within + across + bcast

    def all_to_all_time(self, bytes_per_chip: float, n: int,
                        devices: Optional[Sequence[int]] = None) -> float:
        """All-to-all: each GPU sends (n-1)/n of its shard; across nodes
        the fraction (n-m)/n rides InfiniBand."""
        if n <= 1:
            return 0.0
        s, m = self._group(n, devices)
        if s <= 1:
            return self.ici_time(bytes_per_chip * (n - 1) / n)
        m = max(m, 1)
        return (self.ici_time(bytes_per_chip * (m - 1) / n)
                + self.dcn_time(bytes_per_chip * (n - m) / n))

    def dcn_time(self, bytes_moved: float) -> float:
        """One inter-node transfer over an InfiniBand NIC."""
        return bytes_moved / self.ib_bandwidth


def overlapped_exchange_time(machine: "H100MachineModel", exchange_s: float,
                             dense_s: float, microbatches: int,
                             overlapped: bool = True) -> float:
    """Time for an embedding exchange running next to a dense stack.

    Serial (``overlapped=False`` or K <= 1): the two rails pay their sum.
    Pipelined (``parallel/overlap.py``): each of K microbatches pays
    ``max(exchange/K, dense/K)``, plus one fill term, ``min(exchange,
    dense)/K``, that has nothing to hide under.  The pricing hook
    ``OverlappedEmbedBottom.exchange_overlap_cost`` feeds the simulator."""
    if not overlapped or microbatches <= 1:
        return exchange_s + dense_s
    k = max(int(microbatches), 1)
    return k * max(exchange_s / k, dense_s / k) + min(exchange_s,
                                                      dense_s) / k


class CostModel:
    """Memoized per-op timing (reference simulator.cc:235-273).

    ``measure=True`` times the op's forward and backward on the CUDA card
    (``_measure_op``); otherwise the analytic roofline from
    ``op.flops()`` and the tensors' bytes, scaled by ``calibration`` when
    one is given.
    """

    def __init__(self, machine: Optional[H100MachineModel] = None,
                 measure: bool = False, measure_iters: int = 24,
                 measure_budget_s: float = 300.0, calibration=None):
        self.machine = machine or H100MachineModel()
        self.measure = measure
        # per op-class multipliers on the ANALYTIC estimate only:
        # measured times are already real
        self.calibration = calibration
        self.measure_iters = measure_iters
        # wall budget for all measurement; once spent, later ops fall back
        # to the analytic estimate with a warning
        self.measure_budget_s = measure_budget_s
        self._measure_spent = 0.0
        self._budget_warned = False
        # measured and analytic totals over the keys that were measured:
        # post-budget analytic estimates are scaled by their ratio, so one
        # search never compares raw roofline numbers with measured ones
        self._measured_total = 0.0
        self._analytic_total = 0.0
        self._cache: Dict[Tuple, Tuple[float, float]] = {}
        self._null_replay: Optional[float] = None  # measured lazily

    # ---- helpers -----------------------------------------------------------
    @staticmethod
    def _op_key(op, num_parts: int) -> Tuple:
        return (type(op).__name__,
                tuple(t.shape for t in op.inputs),
                tuple(t.shape for t in op.outputs),
                tuple((s.param_name, s.shape) for s in op.param_specs()),
                num_parts)

    def op_times(self, op, num_parts: int = 1) -> Tuple[float, float]:
        """Return (forward_s, backward_s) for one partition of the op when
        its output is split into ``num_parts`` equal parts."""
        key = self._op_key(op, num_parts)
        if key in self._cache:
            return self._cache[key]
        if self.measure and self._measure_spent >= self.measure_budget_s:
            if not self._budget_warned:
                warnings.warn(
                    f"cost-model measurement budget "
                    f"({self.measure_budget_s:.0f}s) spent; remaining ops "
                    "use calibrated analytic estimates", RuntimeWarning)
                self._budget_warned = True
            scale = (self._measured_total / self._analytic_total
                     if self._analytic_total > 0 else 1.0)
            fwd, bwd = self._analytic_op(op, num_parts)
            fwd, bwd = fwd * scale, bwd * scale
        elif self.measure:
            t0 = time.perf_counter()
            try:
                fwd, bwd = self._measure_op(op, num_parts)
                af, ab = self._analytic_op(op, num_parts)
                self._measured_total += fwd + bwd
                self._analytic_total += af + ab
            except Exception as e:
                # fall back, but loudly: a silent fallback would bias the
                # search with analytic numbers while claiming measured ones
                warnings.warn(
                    f"measured cost for {op.name} ({type(op).__name__}) "
                    f"failed ({type(e).__name__}: {e}); using analytic "
                    "estimate", RuntimeWarning)
                fwd, bwd = self._analytic_op(op, num_parts)
            finally:
                self._measure_spent += time.perf_counter() - t0
        else:
            fwd, bwd = self._analytic_op(op, num_parts)
            if self.calibration is not None:
                sf, sb = self.calibration.scale_for(op)
                fwd, bwd = fwd * sf, bwd * sb
        self._cache[key] = (fwd, bwd)
        return fwd, bwd

    # ---- analytic ----------------------------------------------------------
    @staticmethod
    def _nbytes(dtype) -> int:
        return dtype.itemsize  # a torch dtype (tensors and parameters)

    def _analytic_op(self, op, num_parts: int) -> Tuple[float, float]:
        m = self.machine
        # an op that prices its own exchange and dense rails (the
        # overlapped embedding, ops/overlap_embed.py) overrides the
        # roofline; calibration still applies on top in op_times
        hook = getattr(op, "exchange_overlap_cost", None)
        if hook is not None:
            est = hook(m, num_parts)
            if est is not None:
                return est
        batch = op.outputs[0].shape[0] if op.outputs[0].ndim else 1
        flops = op.flops(batch) / max(num_parts, 1)
        compute_dtype = getattr(op, "compute_dtype", None) or "float32"
        in_bytes = sum(self._nbytes(t.dtype) * t.numel()
                       for t in op.inputs) / max(num_parts, 1)
        out_bytes = sum(self._nbytes(t.dtype) * t.numel()
                        for t in op.outputs) / max(num_parts, 1)
        w_bytes = sum(self._nbytes(s.dtype) * int(np.prod(s.shape))
                      for s in op.param_specs())
        fwd = max(m.matmul_time(flops, str(compute_dtype)),
                  m.memory_time(in_bytes + out_bytes + w_bytes))
        fwd += m.kernel_launch_overhead
        # backward ~ 2x forward FLOPs (dgrad + wgrad), same traffic + grads
        bwd = max(m.matmul_time(2 * flops, str(compute_dtype)),
                  m.memory_time(2 * (in_bytes + out_bytes) + 2 * w_bytes))
        bwd += m.kernel_launch_overhead
        return fwd, bwd

    # ---- measured ----------------------------------------------------------
    def _measure_op(self, op, num_parts: int) -> Tuple[float, float]:
        """Time the op's real kernels on the card (the reference runs the
        real CUDA kernels on simulator scratch, linear.cu:973-1049).

        Inputs are one part's: the batch dim divided by ``num_parts``.
        Ids are uniform in ``[0, num_entries)`` (``[0, 2)`` for an op
        without ``num_entries``, as in the JAX package), other inputs
        standard normal f32.  The forward is ``op.forward`` without
        autograd.  The backward of an embedding-family op is the row-
        sparse step it trains through, ``gather_rows`` then
        ``scatter_apply`` (the row-update kernel's prepare-and-sort and
        update); of any other op with parameters, ``torch.autograd`` of
        the JAX package's loss ``sum(o * o)`` with respect to them; an
        op without parameters is billed its forward again."""
        import torch

        dev = torch.device("cuda")

        def part_shape(shape):
            if not shape:
                return shape
            b = max(shape[0] // num_parts, 1)
            return (b,) + tuple(shape[1:])

        rng = np.random.default_rng(0)
        xs = []
        for t in op.inputs:
            shp = part_shape(t.shape)
            if not t.dtype.is_floating_point:
                hi = getattr(op, "num_entries", 2)
                xs.append(torch.from_numpy(rng.integers(0, hi, size=shp))
                          .to(dev, t.dtype))
            else:
                xs.append(torch.from_numpy(
                    rng.standard_normal(shp).astype(np.float32)).to(dev))
        params = op.init_params(torch.Generator(device=dev).manual_seed(0))

        def fwd_fn():
            with torch.no_grad():
                return op.forward(params, list(xs))[0]

        # embedding-family ops train through the row-sparse kernels; their
        # dense table gradient never runs under plain SGD, so measure what
        # the step executes
        sparse_capable = (hasattr(op, "gather_rows")
                          and hasattr(op, "scatter_apply")
                          and "embedding" in params)
        if sparse_capable:
            table = params["embedding"]

            def bwd_fn():
                with torch.no_grad():
                    rows = op.gather_rows(table, xs[0])
                    return op.scatter_apply(table, xs[0], rows, -0.01)
        else:
            leaves = [p.requires_grad_() for p in params.values()]

            def bwd_fn():
                with torch.enable_grad():
                    outs = op.forward(params, list(xs))
                    loss = sum((o * o).sum() for o in outs
                               if o.is_floating_point())
                    return torch.autograd.grad(loss, leaves)

        if self._null_replay is None:
            self._null_replay = self._null_replay_s()
        fwd = self._graphed_s(fwd_fn)
        bwd = self._graphed_s(bwd_fn) if params else fwd
        return fwd, bwd

    def _null_replay_s(self) -> float:
        """Device seconds of a replay of a graph of one trivial node (a
        one-element fill): the fixed cost under every timed replay."""
        import torch
        z = torch.zeros(1, device="cuda")
        return self._replay_s(self._capture(z.zero_, 1)[0])

    def _capture(self, fn, calls: int):
        """(graph, launches per kernel wrapper) of ``calls`` calls of
        ``fn`` captured in one CUDA graph, after two warm calls on a side
        stream (allocator, cuBLAS and autograd state, kernel builds).
        Capture runs no kernel, so what the wrappers counted during it is
        taken back and handed to the caller, who adds it per replay (as
        ``graphs.GraphRunner`` does)."""
        import torch

        from ..graphs import COUNTED

        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        current.wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = [w.launches for w in COUNTED]
        try:
            with warnings.catch_warnings():
                # an op that launches nothing (a view) captures an empty
                # graph: a valid measurement of no device work
                warnings.filterwarnings(
                    "ignore", message="The CUDA Graph is empty",
                    category=UserWarning)
                with torch.cuda.graph(graph):
                    for _ in range(calls):
                        fn()
        finally:
            added = [w.launches - b for w, b in zip(COUNTED, before)]
            for w, b in zip(COUNTED, before):
                w.launches = b
        return graph, added

    @staticmethod
    def _replay_s(graph, added=None, windows: int = 3) -> float:
        """The best of ``windows`` event-timed replays of ``graph``, in
        seconds; each replay adds ``added`` to the kernel wrappers'
        launch counts."""
        import torch

        from ..graphs import COUNTED

        graph.replay()  # the first replay uploads the graph
        best = float("inf")
        for _ in range(windows + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        if added is not None:
            for w, n in zip(COUNTED, added):
                w.launches += n * (windows + 2)
        return best

    def _graphed_s(self, fn) -> float:
        """Device seconds of one call of ``fn``: ``measure_iters`` calls
        in one CUDA graph, the best replay less one replay of a trivial
        graph, over the calls (at least a quarter of the raw per-call
        time, as in the JAX package, so that no op is billed zero)."""
        iters = self.measure_iters
        graph, added = self._capture(fn, iters)
        best = self._replay_s(graph, added)
        del graph
        return max((best - self._null_replay) / iters,
                   best / (4 * iters), 1e-9)
