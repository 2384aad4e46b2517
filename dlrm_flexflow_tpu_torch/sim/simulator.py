"""Execution simulator: the SimTask DAG and its event-driven timeline
(counterpart of ``dlrm_flexflow_tpu/sim/simulator.py``, whose semantics
it keeps bit for bit; reference src/runtime/simulator.{h,cc}: SimTask,
Device and TaskManager simulator.h:29-87, transfer tasks from the
producer and consumer rectangles ``add_task_dependencies_with_xfer``
simulator.cc:200-233, ``simulate_runtime`` simulator.cc:275-448 with the
weight sync overlapped with backward or after a barrier, :327-408).

Every device has two rails, compute and network: transfers and gradient
all-reduces (NVLink, or InfiniBand across nodes under a ``PodTopology``)
overlap with compute and contend only with other transfers on the same
device.  The per-op costs come from ``cost_model.CostModel`` (analytic
or measured on the card), the link costs from its machine model.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..parallel.parallel_config import ParallelConfig, Strategy
from .cost_model import CostModel


@dataclass
class SimTask:
    """One unit of simulated work (reference SimTask, simulator.h:37-56)."""

    name: str
    device: int            # flat device id, -1 for pure-comm tasks
    run_time: float
    kind: str = "compute"  # compute | comm | update
    next_tasks: List["SimTask"] = field(default_factory=list)
    counter: int = 0       # unresolved dependencies
    ready_time: float = 0.0

    def add_next(self, t: "SimTask"):
        self.next_tasks.append(t)
        t.counter += 1

    def __lt__(self, other):  # heapq ordering
        return self.ready_time < other.ready_time


def _parts_of(pc: Optional[ParallelConfig], ndim: int, n: int) -> ParallelConfig:
    if pc is None:
        return ParallelConfig.data_parallel(ndim, n)
    return pc


def _part_devices(pc: ParallelConfig) -> List[int]:
    if pc.device_ids:
        return list(pc.device_ids)[:pc.num_parts]
    return list(range(pc.num_parts))


from ..ops.base import rect_of_part as _rect_of_part  # noqa: E402


def _overlap_bytes(lo1, hi1, lo2, hi2, dtype_bytes=4) -> int:
    n = dtype_bytes
    for a, b, c, d in zip(lo1, hi1, lo2, hi2):
        inter = min(b, d) - max(a, c)
        if inter <= 0:
            return 0
        n *= inter
    return n


class Simulator:
    """Estimate one training-iteration time for a model under a strategy
    (reference Simulator::simulate_runtime, simulator.cc:275-448)."""

    def __init__(self, model, num_devices: int,
                 cost_model: Optional[CostModel] = None,
                 overlap_backward_update: bool = False):
        self.model = model
        self.num_devices = num_devices
        self.costs = cost_model or CostModel()
        self.machine = self.costs.machine
        self.overlap = overlap_backward_update
        # multiplicative calibration against a real measured step (the
        # reference fits its hard-coded bandwidth constants to the
        # cluster the same way, simulator.cu:27-29); set by calibrate()
        self.scale = 1.0

    def calibrate(self, strategy: Strategy, real_step_time: float) -> float:
        """Fit ``scale`` so simulate(strategy) == real_step_time; returns
        the factor.  Use one config to calibrate, others to validate —
        relative comparisons (what the search needs) are unaffected.
        Each fit is recorded as one ``search`` phase=calibrate telemetry
        event (simulated against measured)."""
        raw = self.simulate(strategy) / self.scale
        self.scale = real_step_time / raw if raw > 0 else 1.0
        from ..telemetry import active_log
        log = active_log()
        if log is not None:
            log.emit("search", phase="calibrate", simulated_s=raw,
                     measured_s=real_step_time, scale=self.scale)
        return self.scale

    # ------------------------------------------------------------------ build
    def _build_tasks(self, strategy: Strategy):
        tasks: List[SimTask] = []
        fwd_of: Dict[Tuple[str, int], SimTask] = {}
        bwd_of: Dict[Tuple[str, int], SimTask] = {}

        def new_task(name, device, rt, kind="compute"):
            t = SimTask(name, device, rt, kind)
            tasks.append(t)
            return t

        # forward + backward per part
        for op in self.model.layers:
            pc = _parts_of(strategy.configs.get(op.name),
                           op.outputs[0].ndim, self.num_devices)
            devs = _part_devices(pc)
            f, b = self.costs.op_times(op, pc.num_parts)
            for i, dev in enumerate(devs):
                fwd_of[(op.name, i)] = new_task(f"{op.name}:fwd{i}",
                                                dev % self.num_devices, f)
                bwd_of[(op.name, i)] = new_task(f"{op.name}:bwd{i}",
                                                dev % self.num_devices, b)

        # dependencies + comm from tensor-rectangle intersections
        # (reference add_task_dependencies_with_xfer, simulator.cc:200-233)
        for op in self.model.layers:
            dst_pc = _parts_of(strategy.configs.get(op.name),
                               op.outputs[0].ndim, self.num_devices)
            dst_devs = _part_devices(dst_pc)
            for input_idx, inp in enumerate(op.inputs):
                src = inp.owner_op
                if src is None:
                    continue
                src_pc = _parts_of(strategy.configs.get(src.name),
                                   src.outputs[0].ndim, self.num_devices)
                src_devs = _part_devices(src_pc)
                shape = inp.shape
                for di in range(dst_pc.num_parts):
                    # TRUE input rectangle this part reads (per-op hook —
                    # e.g. a channel-parallel Linear part reads the FULL
                    # input, a Concat part reads an axis-shifted slice;
                    # reference simulator.cc:200-233)
                    dlo, dhi = op.input_rect(dst_pc, input_idx, di)
                    for si in range(src_pc.num_parts):
                        slo, shi = _rect_of_part(src_pc, shape, si)
                        nbytes = _overlap_bytes(slo, shi, dlo, dhi)
                        if nbytes == 0:
                            continue
                        sdev = src_devs[si] % self.num_devices
                        ddev = dst_devs[di] % self.num_devices
                        sf = fwd_of[(src.name, si)]
                        df = fwd_of[(op.name, di)]
                        sb = bwd_of[(src.name, si)]
                        db = bwd_of[(op.name, di)]
                        if sdev == ddev:
                            sf.add_next(df)
                            db.add_next(sb)
                        else:
                            # two-level routing (PodTopology): a hop
                            # within a node rides NVLink, one across
                            # nodes InfiniBand; without a topology
                            # xfer_time is ici_time
                            ct = SimTask(f"{src.name}->{op.name}", ddev,
                                         self.machine.xfer_time(
                                             nbytes, sdev, ddev),
                                         "comm")
                            tasks.append(ct)
                            sf.add_next(ct)
                            ct.add_next(df)
                            cb = SimTask(f"{op.name}->{src.name}:grad", sdev,
                                         self.machine.xfer_time(
                                             nbytes, ddev, sdev),
                                         "comm")
                            tasks.append(cb)
                            db.add_next(cb)
                            cb.add_next(sb)
            # fwd(op) before bwd(op)
            for i in range(dst_pc.num_parts):
                fwd_of[(op.name, i)].add_next(bwd_of[(op.name, i)])

        # weight synchronization (reference simulator.cc:327-408): for each
        # op with params replicated over K parts, add a ring all-reduce of
        # the gradient + an update task.
        #   overlap mode — each op's grad sync + update starts as soon as
        #   ITS OWN backward parts finish, overlapping the rest of the
        #   backward pass (the reference's overlap branch).
        #   bulk-sync mode — a global barrier after the LAST backward
        #   precedes every update (barrier + update phase, the reference's
        #   non-overlap branch).
        barrier = None
        if not self.overlap:
            barrier = new_task("bwd-barrier", 0, 0.0, "barrier")
            for t in bwd_of.values():
                t.add_next(barrier)
        update_tasks = []
        for op in self.model.layers:
            specs = op.param_specs()
            if not specs:
                continue
            pc = _parts_of(strategy.configs.get(op.name),
                           op.outputs[0].ndim, self.num_devices)
            k = pc.num_parts
            wbytes = sum(4 * int(np.prod(s.shape)) for s in specs)
            # tensor-parallel dims shard the weight -> only the data-dim
            # replicas all-reduce
            replicas = pc.dims[0] if pc.dims else 1
            shard = wbytes / max(k // max(replicas, 1), 1)
            # which devices each replica group sits on decides whether
            # the ring stays on NVLink or pays the two-level InfiniBand
            # exchange (PodTopology): part index order is dim-0 fastest
            # (ops/base.part_coords), so one group per non-batch
            # coordinate = one contiguous run of the device list; the
            # groups all-reduce concurrently, the slowest one is the
            # modeled cost.  Flat machines price every group alike.
            devs_all = [d % self.num_devices for d in _part_devices(pc)]
            groups = [devs_all[g * replicas:(g + 1) * replicas]
                      for g in range(max(k // max(replicas, 1), 1))]
            ar = max(self.machine.all_reduce_time(shard, replicas,
                                                  devices=g)
                     for g in groups)
            dev0 = _part_devices(pc)[0]
            upd = SimTask(f"{op.name}:update", dev0,
                          self.machine.memory_time(2 * shard), "update")
            # the grad all-reduce is a comm task on the NETWORK rail:
            # collectives run asynchronously with compute, so in overlap
            # mode an op's grad sync rides under later backwards — the
            # modeled win of reference simulator.cc:327-408's overlap
            # branch (bulk-sync holds it behind the barrier instead)
            sync = None
            if ar > 0.0:
                sync = new_task(f"{op.name}:gradsync", dev0, ar, "comm")
                sync.add_next(upd)
            tasks.append(upd)
            head = sync if sync is not None else upd
            if barrier is not None:
                barrier.add_next(head)
            else:
                for i in range(k):
                    bwd_of[(op.name, i)].add_next(head)
            update_tasks.append(upd)

        return tasks, update_tasks

    # --------------------------------------------------------------- simulate
    def simulate(self, strategy: Strategy) -> float:
        """Event-driven simulation over per-device timelines
        (reference simulator.cc:410-447)."""
        tasks, update_tasks = self._build_tasks(strategy)
        # two rails per device: compute and the network (copy engines
        # and NCCL's channels overlap with compute), so comm tasks contend
        # only with other comm on the same device
        device_free = [0.0] * self.num_devices
        net_free = [0.0] * self.num_devices
        ready: List[Tuple[float, int, SimTask]] = []
        seq = 0
        for t in tasks:
            if t.counter == 0:
                heapq.heappush(ready, (t.ready_time, seq, t))
                seq += 1
        done = 0
        makespan = 0.0
        while ready:
            rt, _, t = heapq.heappop(ready)
            dev = t.device % self.num_devices if t.device >= 0 else 0
            rail = net_free if t.kind == "comm" else device_free
            start = max(rt, rail[dev])
            end = start + t.run_time
            rail[dev] = end
            makespan = max(makespan, end)
            done += 1
            for nxt in t.next_tasks:
                nxt.counter -= 1
                nxt.ready_time = max(nxt.ready_time, end)
                if nxt.counter == 0:
                    heapq.heappush(ready, (nxt.ready_time, seq, nxt))
                    seq += 1
        if done != len(tasks):
            raise RuntimeError(f"simulated {done}/{len(tasks)} tasks — "
                               "dependency cycle in SimTask DAG")
        return makespan * self.scale
