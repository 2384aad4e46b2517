"""MCMC strategy search: simulated annealing over per-op ParallelConfigs
(counterpart of ``dlrm_flexflow_tpu/sim/search.py``; reference
``FFModel::optimize`` model.cc:1093-1144: start from data-parallel,
rewrite one op at random, accept with probability
``exp(-alpha * delta)``, keep the best within the budget;
``FFModel::rewrite`` model.cc:1082-1091;
``Op::get_random_parallel_config`` model.cc:295-324).
"""

from __future__ import annotations

import math
import os
import random
from typing import Callable, List, Optional

from ..parallel.parallel_config import ParallelConfig, Strategy
from ..telemetry import active_log
from .simulator import Simulator


def _factorizations(n: int, ndim: int) -> List[tuple]:
    """All ways to write n as an ordered product of ndim factors."""
    if ndim == 1:
        return [(n,)]
    out = []
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, ndim - 1):
                out.append((d,) + rest)
    return out


def placement_variants(n: int, num_devices: int,
                       topology=None) -> List[List[int]]:
    """Candidate device lists for an ``n``-part op: the "O" of SOAP at
    cluster scale.  A flat machine (no topology, or one node) has one
    placement, ``range(n)``: every permutation prices alike under one
    link class.  Across nodes of a :class:`~.cost_model.PodTopology`
    the same parts can land packed (``range(n)``: consecutive parts
    share a node) or strided (consecutive parts on different nodes),
    which the two-level model prices differently (NVLink against
    InfiniBand); both join the proposal set (the reference mapper's
    per-node freedom, mapper.cc:222-322)."""
    packed = list(range(n))
    if (topology is None or topology.num_slices <= 1 or n <= 1
            or n > num_devices):
        return [packed]
    cps = topology.chips_per_slice
    # strided: walk node by node through same-index GPUs (0, cps,
    # 2*cps, ..., 1, cps+1, ...) so consecutive parts cross nodes
    order = [s * cps + c for c in range(cps)
             for s in range(topology.num_slices)]
    strided = [d for d in order if d < num_devices][:n]
    if strided == packed or len(strided) < n:
        return [packed]
    return [packed, strided]


def legal_configs(op, num_devices: int,
                  max_dims: Optional[int] = None,
                  topology=None) -> List[ParallelConfig]:
    """Candidate ParallelConfigs for an op (reference model.cc:295-324
    samples one; we enumerate to give the chain a uniform proposal set).

    Legality: every partition count must divide the corresponding output
    dim; device counts are divisors of num_devices.  With a multi-slice
    ``topology`` each partitioning additionally appears once per
    distinct device placement (:func:`placement_variants`), so the
    chain can trade an InfiniBand crossing for an NVLink hop.
    """
    shape = op.outputs[0].shape
    ndim = len(shape)
    if max_dims is not None:
        ndim = min(ndim, max_dims)
    cands = []
    n = 1
    divisors = [d for d in range(1, num_devices + 1) if num_devices % d == 0]
    seen = set()
    for n in divisors:
        for dims in _factorizations(n, ndim):
            full = dims + (1,) * (len(shape) - ndim)
            if any(s % d != 0 or d > s for s, d in zip(shape, full)):
                continue
            if full in seen:
                continue
            seen.add(full)
            for devs in placement_variants(n, num_devices, topology):
                cands.append(ParallelConfig(dims=full,
                                            device_ids=list(devs)))
    return cands


def data_parallel_strategy(model, num_devices: int) -> Strategy:
    """The search's starting point (reference model.cc:1102): data-parallel
    over every op, falling back to no partitioning when the batch dimension
    does not divide."""
    s = Strategy()
    for op in model.layers:
        s[op.name] = ParallelConfig.data_parallel(
            op.outputs[0].ndim, num_devices)
        if op.outputs[0].shape[0] % num_devices != 0:
            s[op.name] = ParallelConfig(
                dims=(1,) * op.outputs[0].ndim, device_ids=[0])
    return s


def mcmc_search(model, num_devices: int, budget: int = 1000,
                alpha: float = 0.05,
                simulator: Optional[Simulator] = None,
                seed: int = 0,
                verbose: bool = False,
                on_iteration: Optional[Callable] = None,
                backend: str = "auto",
                measure: Optional[bool] = None,
                measure_budget_s: float = 300.0,
                topology=None) -> Strategy:
    """Simulated-annealing search (reference model.cc:1093-1144).

    Returns the best Strategy found; ``model.strategy`` is not mutated.

    ``backend``: "native" runs the whole chain (DAG build, event
    simulation, annealing) in C++ (``native/ffsim.cpp``, built by
    ``native_lib.py``; the reference keeps this loop in C++ too); "python"
    forces the in-process implementation; "auto" prefers native when the
    library builds and no custom ``simulator``/``on_iteration`` hooks are
    requested.

    Cost source: without a ``simulator``, per-op costs are measured on the
    CUDA card when one is present (the reference's approach, real kernels,
    simulator.cc:235-273) and analytic elsewhere; ``measure`` (or
    ``FF_SEARCH_MEASURE=0``) overrides that.

    ``topology`` (a :class:`~.cost_model.PodTopology`) makes the search
    hierarchy-aware: the proposal set grows node-aware placement moves
    (:func:`placement_variants`) and, without a ``simulator``, the default
    cost model prices transfers two-level (NVLink within a node,
    InfiniBand across).  A multi-node topology forces the Python backend:
    the native chain's machine model is flat.
    """
    rng = random.Random(seed)
    sliced = topology is not None and topology.num_slices > 1

    # ``measure``: None = auto (measure when a CUDA card is present);
    # False forces the instant analytic model; True forces measurement.
    # FF_SEARCH_MEASURE=0 opts out environment-wide.
    if measure is None:
        env = os.environ.get("FF_SEARCH_MEASURE")
        if env is not None:
            measure = env.strip().lower() not in ("0", "off", "false", "no")
    cost_model = None
    if simulator is None and measure is not False:
        import torch

        from .cost_model import CostModel, H100MachineModel
        if measure or torch.cuda.is_available():
            # measured compute costs; transfers still price through the
            # machine model, so it must know the node structure
            cost_model = CostModel(
                machine=(H100MachineModel(topology=topology)
                         if sliced else None),
                measure=True, measure_budget_s=measure_budget_s)
    if simulator is None and cost_model is None and sliced:
        from .cost_model import CostModel, H100MachineModel
        cost_model = CostModel(
            machine=H100MachineModel(topology=topology))

    # start from data-parallel (reference model.cc:1102)
    current = data_parallel_strategy(model, num_devices)

    candidates = {op.name: legal_configs(op, num_devices,
                                         topology=topology)
                  for op in model.layers}

    if backend == "native" and on_iteration is not None:
        raise ValueError("on_iteration callbacks require backend='python' "
                         "(the native chain reports only the final best)")
    if backend == "native" and sliced:
        raise ValueError("a multi-slice topology requires "
                         "backend='python' (the native chain prices a "
                         "flat machine and would ignore the slice "
                         "structure)")
    want_native = (backend == "native"
                   or (backend == "auto" and simulator is None
                       and on_iteration is None and not sliced))
    if want_native:
        import subprocess

        from .native_sim import NativeSimulator

        # start configs must be inside the candidate sets
        full_cands = {name: list(cs) for name, cs in candidates.items()}
        for op in model.layers:
            pc = current[op.name]
            if not any(tuple(c.dims) == tuple(pc.dims)
                       for c in full_cands[op.name]):
                full_cands[op.name].append(pc)
        nsim = None
        try:
            nsim = NativeSimulator(
                model, num_devices, full_cands,
                cost_model=simulator.costs if simulator else cost_model)
        except (OSError, subprocess.CalledProcessError):
            # build/load failure only — anything else is a real bug and
            # propagates; without a toolchain fall back to Python
            if backend == "native":
                raise
        if nsim is not None:
            best, best_time = nsim.search(current, budget, alpha,
                                          seed=seed)
            nsim.close()
            if verbose:
                print(f"[search] native backend: best "
                      f"{best_time*1e3:.3f} ms over {budget} iters")
            log = active_log()
            if log is not None:
                # the native chain reports only the final best — one
                # summary event records what the search did
                log.emit("search", phase="summary", iterations=budget,
                         best_s=best_time, backend="native")
            return best

    sim = simulator or Simulator(model, num_devices, cost_model=cost_model)
    ops = [op for op in model.layers if len(candidates[op.name]) > 1]

    def copy_strategy(s: Strategy) -> Strategy:
        out = Strategy()
        out.configs = dict(s.configs)
        return out

    current_time = sim.simulate(current)
    best, best_time = copy_strategy(current), current_time
    start_time = current_time
    if verbose:
        print(f"[search] start (data-parallel): {current_time*1e3:.3f} ms")

    log = active_log()
    iterations = accepted_count = 0
    for it in range(budget):
        if not ops:
            break
        # random single-op rewrite (reference rewrite, model.cc:1082-1091)
        op = rng.choice(ops)
        prev_pc = current.configs[op.name]
        new_pc = rng.choice(candidates[op.name])
        current.configs[op.name] = new_pc
        t = sim.simulate(current)
        delta = t - current_time
        accepted = delta <= 0 or rng.random() < math.exp(-alpha * delta * 1e3)
        if accepted:
            current_time = t  # accept
            accepted_count += 1
            if t < best_time:
                best, best_time = copy_strategy(current), t
                if verbose:
                    print(f"[search] it {it}: best {t*1e3:.3f} ms "
                          f"({op.name} -> {new_pc.dims})")
        else:
            current.configs[op.name] = prev_pc  # reject
        iterations += 1
        if log is not None:
            # one trajectory event per proposal (the persisted view of
            # what the simulator-guided search actually did — reference
            # FFModel::optimize only prints; docs/telemetry.md)
            log.emit("search", phase="iteration", it=it, op=op.name,
                     dims=list(new_pc.dims),
                     # the placement is part of the proposal on a
                     # sliced pod (within- vs cross-slice device lists
                     # price differently); flat searches omit it —
                     # every placement is equivalent there
                     **({"devices": list(new_pc.device_ids)}
                        if sliced and new_pc.device_ids else {}),
                     accepted=bool(accepted),
                     current_s=current_time, best_s=best_time)
        if on_iteration is not None:
            on_iteration(it, current_time, best_time)

    if log is not None:
        log.emit("search", phase="summary", iterations=iterations,
                 best_s=best_time, start_s=start_time,
                 accepted_count=accepted_count,
                 acceptance_rate=accepted_count / max(iterations, 1),
                 backend="python")
    best.best_simulated_time = best_time
    return best
