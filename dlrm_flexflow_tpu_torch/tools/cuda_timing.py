"""Timing of a Python callable on one CUDA card, shared by
``chip_smoke.py`` and the A/B tools beside this file
(``row_update_calls.py``, ``forward_calls.py``).  Imports only torch, so
that a tool can time another checkout's package with it: the tools,
run by path, import it as the top-level module ``cuda_timing``."""

from __future__ import annotations

import time

import torch


def graph_ms(fn, arg_sets, reps: int = 5, windows: int = 3) -> float:
    """Device time of one call of ``fn``: the calls over every argument
    set are captured once in a CUDA graph (no host launch cost between
    them), the graph is replayed ``reps`` times between CUDA events in
    each of ``windows`` windows, and the median window's total is divided
    by the calls.  Cycling many id sets touches more table rows than the
    50 MB L2 holds at the large buckets."""
    for args in arg_sets[:3]:
        fn(*args)  # warm the allocator and the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (reps * len(arg_sets)))
    return sorted(times)[len(times) // 2]


def wall_ms(fn, arg_sets) -> float:
    """Wall time of one call as the host issues it, launch cost included:
    three warm-up calls, then every argument set once between two
    synchronizations."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(arg_sets)


def launches_per_call(fn, arg_sets):
    """Device operations (kernels and copies) per call of ``fn`` from
    torch.profiler's CUDA activity over one call per argument set, and
    each operation's count per call.  The tracer can miss the launches
    that follow its start, so one uncounted call runs first, then, after
    a pause, the counted calls inside a ``record_function`` range; only
    device operations that start inside that range or after it are
    counted.  Even so the tracer can drop a record or two: in a process
    that has profiled many times before, the bag kernel has read 63 of
    64 calls.  So a reading just under a whole number is a dropped
    record, not a missed launch; an exact count of one kernel's launches
    is its wrapper's counter.  Returns ("not measured", {}) when the
    profiler saw none."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*arg_sets[0])
        torch.cuda.synchronize()
        time.sleep(0.05)
        with record_function("counted_calls"):
            for args in arg_sets:
                fn(*args)
        torch.cuda.synchronize()
        time.sleep(0.05)  # lets the tracer collect the last kernels
    events = prof.events()
    start = min((e.time_range.start for e in events
                 if e.name == "counted_calls"), default=None)
    ops = [e for e in events if start is not None
           and str(e.device_type).endswith("CUDA")
           and e.name != "counted_calls"  # the range's own device span
           and e.time_range.start >= start]
    if not ops:
        return "not measured", {}
    calls = len(arg_sets)
    per_call = {}
    for e in ops:  # names cut to 60 characters, counts summed
        per_call[e.name[:60]] = per_call.get(e.name[:60], 0) + 1 / calls
    return len(ops) / calls, per_call
