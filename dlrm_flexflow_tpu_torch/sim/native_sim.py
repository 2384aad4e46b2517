"""ctypes bindings for the native simulator and search engine
(``native/ffsim.cpp``; counterpart of
``dlrm_flexflow_tpu/sim/native_sim.py``).

The reference runs its execution simulator and MCMC search as C++
inside the runtime (src/runtime/simulator.cc:275-448,
src/runtime/model.cc:1082-1144).  This module serializes the op graph,
the per-op cost table and the ParallelConfig candidate sets into flat
arrays and hands the hot loop (the DAG build, the event simulation and
the annealing chain) to the library, which ``native_lib.py`` builds from
the repo's source into the port's build directory.  ``simulator.py``
stays the Python implementation; the two are parity-tested.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.parallel_config import ParallelConfig, Strategy
from .cost_model import CostModel

MAXD = 8  # must match native/ffsim.cpp

_LIB: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ..native_lib import load_native_lib

        lib = load_native_lib("libffsim.so", "ffsim.cpp")
        i64 = ctypes.c_int64
        p = ctypes.c_void_p
        d = ctypes.c_double
        lib.ffsim_create.argtypes = [i64, i64] + [p] * 11 + [i64] + \
            [p] * 6 + [i64, ctypes.c_int32, d, d]
        lib.ffsim_create.restype = p
        lib.ffsim_simulate.argtypes = [p, p]
        lib.ffsim_simulate.restype = d
        lib.ffsim_search.argtypes = [p, p, i64, d, ctypes.c_uint64, p, p]
        lib.ffsim_search.restype = d
        lib.ffsim_destroy.argtypes = [p]
        _LIB = lib
    return _LIB


def native_available() -> bool:
    try:
        get_lib()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _pad_dims(dims: Sequence[int]) -> Tuple[int, ...]:
    dims = tuple(int(x) for x in dims) or (1,)
    assert len(dims) <= MAXD, f"ndim > {MAXD} not supported by native sim"
    return dims + (1,) * (MAXD - len(dims))


class NativeSimulator:
    """Native counterpart of sim.simulator.Simulator.

    ``candidates`` maps op name -> list of ParallelConfigs the search may
    choose from.  ``simulate``/``search`` only accept strategies whose
    per-op configs are inside the candidate set (KeyError otherwise); to
    evaluate one fixed arbitrary strategy, build an instance via
    ``for_strategy``.
    """

    def __init__(self, model, num_devices: int,
                 candidates: Dict[str, List[ParallelConfig]],
                 cost_model: Optional[CostModel] = None,
                 overlap_backward_update: bool = False):
        self.model = model
        self.num_devices = num_devices
        self.overlap = overlap_backward_update
        self.costs = cost_model or CostModel()
        self.machine = self.costs.machine
        self.op_names = [op.name for op in model.layers]
        self.candidates = {name: list(cands)
                           for name, cands in candidates.items()}
        for op in model.layers:
            self.candidates.setdefault(op.name, [
                self._default_config(op)])
        self._handle = None
        self._build()

    def _default_config(self, op) -> ParallelConfig:
        pc = ParallelConfig.data_parallel(op.outputs[0].ndim,
                                          self.num_devices)
        if op.outputs[0].shape[0] % self.num_devices != 0:
            pc = ParallelConfig(dims=(1,) * op.outputs[0].ndim,
                                device_ids=[0])
        return pc

    def _build(self):
        ops = self.model.layers
        n = len(ops)
        op_ndim = np.zeros(n, np.int64)
        op_shape = np.ones((n, MAXD), np.int64)
        op_wbytes = np.zeros(n, np.float64)
        op_has_params = np.zeros(n, np.int32)
        cand_off = np.zeros(n, np.int64)
        cand_cnt = np.zeros(n, np.int64)
        all_dims, all_fwd, all_bwd = [], [], []
        dev_off, dev_pool = [], []
        for i, op in enumerate(ops):
            shape = op.outputs[0].shape
            op_ndim[i] = len(shape)
            op_shape[i, :len(shape)] = shape
            specs = op.param_specs()
            op_has_params[i] = 1 if specs else 0
            op_wbytes[i] = sum(4.0 * int(np.prod(s.shape)) for s in specs)
            cands = self.candidates[op.name]
            cand_off[i] = len(all_fwd)
            cand_cnt[i] = len(cands)
            for pc in cands:
                f, b = self.costs.op_times(op, pc.num_parts)
                all_dims.append(_pad_dims(pc.dims))
                all_fwd.append(f)
                all_bwd.append(b)
                devs = (list(pc.device_ids)[:pc.num_parts]
                        if pc.device_ids else list(range(pc.num_parts)))
                # pad: the engine indexes devices[part] for every part
                while len(devs) < pc.num_parts:
                    devs.append(devs[-1] if devs else 0)
                dev_off.append(len(dev_pool))
                dev_pool.extend(devs)

        # edges grouped by destination op (in layer order), input order —
        # the traversal order the engine's edge cursor assumes
        name_to_idx = {op.name: i for i, op in enumerate(ops)}
        e_src, e_dst, e_ndim, e_shape = [], [], [], []
        # per-edge TRUE input rects for every (dst candidate, part) —
        # the host-side evaluation of Op.input_rect the engine indexes by
        # (edge_rect_off + candidate part_prefix + part)
        e_rect_off, rect_pool = [], []
        for i, op in enumerate(ops):
            for input_idx, inp in enumerate(op.inputs):
                if inp.owner_op is None:
                    continue
                e_src.append(name_to_idx[inp.owner_op.name])
                e_dst.append(i)
                e_ndim.append(len(inp.shape))
                e_shape.append(_pad_dims(inp.shape))
                e_rect_off.append(len(rect_pool))
                for pc in self.candidates[op.name]:
                    for part in range(pc.num_parts):
                        lo, hi = op.input_rect(pc, input_idx, part)
                        rect_pool.append(_pad_dims(lo) + _pad_dims(hi))

        self._arrays = dict(
            op_ndim=op_ndim, op_shape=op_shape.ravel(),
            op_wbytes=op_wbytes, op_has_params=op_has_params,
            cand_off=cand_off, cand_cnt=cand_cnt,
            cand_dims=np.asarray(all_dims, np.int64).ravel(),
            cand_fwd=np.asarray(all_fwd, np.float64),
            cand_bwd=np.asarray(all_bwd, np.float64),
            cand_dev_off=np.asarray(dev_off, np.int64),
            cand_dev_pool=np.asarray(dev_pool, np.int64),
            edge_src=np.asarray(e_src, np.int64),
            edge_dst=np.asarray(e_dst, np.int64),
            edge_ndim=np.asarray(e_ndim, np.int64),
            edge_shape=(np.asarray(e_shape, np.int64).ravel()
                        if e_shape else np.zeros(0, np.int64)),
            edge_rect_off=np.asarray(e_rect_off, np.int64),
            rect_pool=(np.asarray(rect_pool, np.int64).ravel()
                       if rect_pool else np.zeros(0, np.int64)),
        )
        a = self._arrays
        lib = get_lib()
        self._handle = lib.ffsim_create(
            len(ops), self.num_devices,
            _ptr(a["op_ndim"]), _ptr(a["op_shape"]), _ptr(a["op_wbytes"]),
            _ptr(a["op_has_params"]), _ptr(a["cand_off"]),
            _ptr(a["cand_cnt"]), _ptr(a["cand_dims"]), _ptr(a["cand_fwd"]),
            _ptr(a["cand_bwd"]), _ptr(a["cand_dev_off"]),
            _ptr(a["cand_dev_pool"]), len(e_src),
            _ptr(a["edge_src"]), _ptr(a["edge_dst"]), _ptr(a["edge_ndim"]),
            _ptr(a["edge_shape"]), _ptr(a["edge_rect_off"]),
            _ptr(a["rect_pool"]), len(a["rect_pool"]),
            1 if self.overlap else 0,
            # the engine's one link class: NVLink through the switch
            float(self.machine.nvlink_bandwidth),
            float(self.machine.hbm_bandwidth))
        if not self._handle:
            raise RuntimeError("ffsim_create failed")

    @classmethod
    def for_strategy(cls, model, num_devices: int, strategy: Strategy,
                     cost_model: Optional[CostModel] = None,
                     overlap_backward_update: bool = False
                     ) -> "NativeSimulator":
        """A one-candidate-per-op instance for evaluating a fixed
        strategy (parity with Simulator.simulate)."""
        cands = {}
        for op in model.layers:
            pc = strategy.configs.get(op.name)
            if pc is None:
                pc = ParallelConfig.data_parallel(op.outputs[0].ndim,
                                                  num_devices)
            cands[op.name] = [pc]
        return cls(model, num_devices, cands, cost_model,
                   overlap_backward_update=overlap_backward_update)

    def _indices_for(self, strategy: Strategy) -> np.ndarray:
        idx = np.zeros(len(self.op_names), np.int64)
        for i, (op, name) in enumerate(zip(self.model.layers,
                                           self.op_names)):
            pc = strategy.configs.get(name)
            if pc is None:
                idx[i] = 0
                continue
            cands = self.candidates[name]
            for j, c in enumerate(cands):
                devs_c = c.device_ids or list(range(c.num_parts))
                devs_p = pc.device_ids or list(range(pc.num_parts))
                if tuple(c.dims) == tuple(pc.dims) and devs_c == devs_p:
                    idx[i] = j
                    break
            else:
                raise KeyError(
                    f"{name}: config {pc.dims} not in candidate set")
        return idx

    def simulate(self, strategy: Strategy) -> float:
        t = get_lib().ffsim_simulate(self._handle,
                                     _ptr(self._indices_for(strategy)))
        if t < 0:
            raise RuntimeError("dependency cycle in SimTask DAG")
        return float(t)

    def search(self, start: Strategy, budget: int, alpha: float,
               seed: int = 0) -> Tuple[Strategy, float]:
        """Run the full MCMC chain natively; returns (best, best_time)."""
        start_idx = self._indices_for(start)
        best_idx = np.zeros_like(start_idx)
        accepted = np.zeros(1, np.int64)
        t = get_lib().ffsim_search(self._handle, _ptr(start_idx),
                                   int(budget), float(alpha),
                                   int(seed) & (2**64 - 1),
                                   _ptr(best_idx), _ptr(accepted))
        if t < 0:
            raise RuntimeError("dependency cycle in SimTask DAG")
        best = Strategy()
        for i, name in enumerate(self.op_names):
            best[name] = self.candidates[name][int(best_idx[i])]
        best.best_simulated_time = float(t)
        return best, float(t)

    def close(self):
        if self._handle:
            get_lib().ffsim_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
