"""Telemetry report CLI: summarize one run's event JSONL.

The counterpart of ``dlrm_flexflow_tpu/telemetry/report.py``.

    python -m dlrm_flexflow_tpu_torch.telemetry report <run.jsonl> [--format json]

Prints (sections appear only when the run emitted the matching events):
  * throughput summary        — from ``step`` events (fenced vs dispatch)
  * per-op time table         — from ``op_time`` events (OpTimer)
  * sim-vs-measured calibration — op_time events carrying both the
    measured and the analytic simulator's times
  * compile-event timeline    — from ``compile`` events (the CUDA-graph
    captures and kernel builds ``torch_hooks`` records)
  * memory watermarks         — from ``memory`` events, per device
  * search trajectory         — from ``search`` events (MCMC proposals,
    acceptance rate, best-cost trajectory, calibration fits)
  * tuning loop               — from ``calibration`` + ``search``
    phase=promote events (sim/tune.py: calibration error before/after,
    candidate-vs-incumbent verdicts, strategy lineage)
  * serving, tail and SLO     — from ``serve`` and ``slo`` events
  * span summary              — from ``span`` events (telemetry/trace.py)

``--format json`` emits the same sections as ONE machine-readable
object (``report_data``).  The renderers are the JAX package's, so the
two packages print the same text and the same object for the same
events.  Sibling subcommands: ``export-trace`` (Perfetto/Chrome-trace
JSON, telemetry/exporter.py) and ``regress`` (perf-regression gate,
telemetry/regress.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from .schema import validate_event


def load_events(path: str, strict: bool = False) -> List[dict]:
    """Parse a telemetry JSONL.  Malformed/invalid lines are skipped
    (``strict=True`` raises instead) so a report still renders from a
    partially-written file of a crashed run.

    A DIRECTORY is accepted anywhere a single file is: it merges every
    per-process ``*.jsonl`` sink inside (telemetry/fleet.py — the
    ``telemetry_pNNN.jsonl`` files a pod run writes), time-ordered and
    attributed by ``pidx``.  Single-file behavior is bit-identical to
    before."""
    if os.path.isdir(path):
        from .fleet import load_fleet_events

        return load_fleet_events(path, strict=strict)
    out: List[dict] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
                errs = validate_event(ev)
                if errs:
                    raise ValueError("; ".join(errs))
            except ValueError as e:
                if strict:
                    raise ValueError(f"{path}:{i + 1}: {e}") from e
                continue
            out.append(ev)
    return out


def _by_type(events: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for e in events:
        out.setdefault(e.get("type", "?"), []).append(e)
    return out


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GiB"


def _step_sps(e: dict) -> float:
    return e.get("samples_per_s",
                 e["samples"] / max(e["wall_s"], 1e-12))


def _best_fenced(fenced: List[dict]) -> Tuple[dict, float]:
    """THE best-fenced-window selection — shared by the text report and
    ``report_data`` so the number dashboards consume can never drift
    from the one the text report prints."""
    best = max(fenced, key=_step_sps)
    return best, _step_sps(best)


def throughput_summary(events: List[dict]) -> List[str]:
    steps = [e for e in events if e.get("type") == "step"]
    if not steps:
        return []
    lines = ["== throughput =="]
    fenced = [e for e in steps if e.get("fenced")]
    total = sum(int(e.get("samples", 0)) for e in steps)
    lines.append(f"step events: {len(steps)} ({len(fenced)} fenced), "
                 f"{total} samples total")
    if fenced:
        best, bsps = _best_fenced(fenced)
        lines.append(f"best fenced window: {bsps:,.0f} samples/s "
                     f"({best.get('phase', '?')}, "
                     f"wall {best['wall_s'] * 1e3:.2f} ms)")
    losses = [e["loss"] for e in steps if "loss" in e]
    if losses:
        lines.append(f"loss: first {losses[0]:.6f} -> last {losses[-1]:.6f} "
                     f"over {len(losses)} recorded steps")
    return lines


def _op_err_pct(e: dict) -> Optional[float]:
    """Measured-vs-predicted relative error of one op_time event,
    percent; None when the event carries no sim prediction."""
    sf = e.get("sim_forward_s")
    if sf is None:
        return None
    return 100.0 * abs(sf - e["forward_s"]) / max(e["forward_s"], 1e-12)


def latest_op_times(events: List[dict]) -> Dict[str, dict]:
    """THE newest-``op_time``-event-per-op selection (a rerun within
    one log supersedes) — the per-op table here and the calibration
    fit (sim/tune.py::pair_op_times) share it, so the error an op is
    reported with and the measurement it is calibrated by can never
    come from different events."""
    latest: Dict[str, dict] = {}
    for e in events:
        if e.get("type") == "op_time":
            latest[e["op"]] = e
    return latest


def _per_op_rows(events: List[dict]) -> List[dict]:
    """THE per-op row selection + ranking (text table and
    ``report_data`` share it so the two forms can never order
    differently): newest event per op wins; rows carrying a sim
    prediction rank by percent error WORST-FIRST (calibration drift is
    what the table exists to surface), rows without one follow by
    measured forward time."""
    latest = latest_op_times(events)

    def rank(e: dict):
        err = _op_err_pct(e)
        if err is None:
            return (1, -e["forward_s"], 0.0)
        return (0, -err, -e["forward_s"])

    return sorted(latest.values(), key=rank)


def per_op_table(events: List[dict]) -> List[str]:
    rows = _per_op_rows(events)
    if not rows:
        return []
    has_sim = any("sim_forward_s" in e for e in rows)
    head = f"{'op':28s} {'fwd(us)':>10s} {'bwd(us)':>10s}"
    if has_sim:
        head += f" {'sim fwd(us)':>12s} {'sim/meas':>9s} {'err%':>8s}"
    lines = ["== per-op time table ==", head]
    for e in rows:
        line = (f"{e['op']:28s} {e['forward_s'] * 1e6:10.1f} "
                f"{e.get('backward_s', 0.0) * 1e6:10.1f}")
        if has_sim:
            sf = e.get("sim_forward_s")
            if sf is not None:
                ratio = sf / max(e["forward_s"], 1e-12)
                line += (f" {sf * 1e6:12.1f} {ratio:9.2f} "
                         f"{_op_err_pct(e):8.1f}")
            else:
                line += f" {'-':>12s} {'-':>9s} {'-':>8s}"
        lines.append(line)
    return lines


def calibration_summary(events: List[dict]) -> List[str]:
    """Sim-vs-measured calibration error over the ops that carry both
    numbers (op_time events), plus any simulator calibration fits
    (search phase=calibrate events)."""
    latest: Dict[str, dict] = {}
    for e in events:
        if e.get("type") == "op_time" and "sim_forward_s" in e:
            latest[e["op"]] = e
    cal = [e for e in events
           if e.get("type") == "search" and e.get("phase") == "calibrate"]
    if not latest and not cal:
        return []
    lines = ["== sim-vs-measured calibration =="]
    if latest:
        errs = [abs(e["sim_forward_s"] - e["forward_s"])
                / max(e["forward_s"], 1e-12) for e in latest.values()]
        lines.append(f"per-op forward: {len(errs)} ops, mean abs relative "
                     f"error {100.0 * sum(errs) / len(errs):.1f}%, "
                     f"worst {100.0 * max(errs):.1f}%")
    for e in cal:
        lines.append(f"simulator fit: simulated {e['simulated_s'] * 1e3:.3f} "
                     f"ms vs measured {e['measured_s'] * 1e3:.3f} ms "
                     f"-> scale {e['scale']:.3f}")
    return lines


def compile_timeline(events: List[dict]) -> List[str]:
    comps = [e for e in events if e.get("type") == "compile"]
    if not comps:
        return []
    t0 = min(e["ts"] for e in events)
    # the headline counts the JAX package's two kinds as it does (a
    # backend compile and an AOT build of the same program overlap);
    # every event, the port's capture and build kinds included, is listed
    misses = [e for e in comps if e["kind"] == "backend_compile"]
    aots = [e for e in comps if e["kind"] == "aot"]
    head = (f"{len(misses)} backend compiles (jit cache misses), "
            f"{sum(e['duration_s'] for e in misses):.2f}s total compile "
            f"wall")
    if aots:
        head += (f"; {len(aots)} AOT builds "
                 f"({sum(e['duration_s'] for e in aots):.2f}s "
                 f"lower+compile, overlaps the misses above)")
    lines = ["== compile events ==", head]
    for e in comps:
        extra = ""
        if "fn" in e:
            extra += f" fn={e['fn']}"
        if "donated_args" in e:
            extra += f" donated_args={e['donated_args']}"
        lines.append(f"  t+{e['ts'] - t0:8.2f}s  {e['kind']:16s} "
                     f"{e['duration_s'] * 1e3:10.1f} ms{extra}")
    return lines


def memory_summary(events: List[dict]) -> List[str]:
    mems = [e for e in events if e.get("type") == "memory"]
    if not mems:
        return []
    lines = ["== memory watermarks =="]
    per_dev: Dict[str, List[dict]] = {}
    for e in mems:
        per_dev.setdefault(e["device"], []).append(e)
    for dev, evs in sorted(per_dev.items()):
        hi = max(int(e["bytes_in_use"]) for e in evs)
        peak = max((int(e["peak_bytes"]) for e in evs if "peak_bytes" in e),
                   default=None)
        line = (f"  {dev}: max live {_fmt_bytes(hi)} "
                f"over {len(evs)} samples ({evs[0].get('source', '?')})")
        if peak is not None:
            line += f", allocator peak {_fmt_bytes(peak)}"
        lines.append(line)
    return lines


def distributed_summary(events: List[dict]) -> List[str]:
    """The ``== distributed ==`` section (distributed.initialize,
    docs/distributed.md): which process of how many produced this
    run's telemetry, over how many devices and DCN slices — the
    per-host identity a pod run's JSONL must carry so N host sinks
    can be told apart."""
    inits = [e for e in events if e.get("type") == "distributed"]
    if not inits:
        return []
    lines = ["== distributed =="]
    for e in inits:
        line = (f"process {e.get('process_index', '?')}/"
                f"{e.get('process_count', '?')}")
        if "global_devices" in e:
            line += (f": {e['global_devices']} global device(s), "
                     f"{e.get('local_devices', '?')} local")
        if e.get("slices"):
            line += f", {e['slices']} slice(s)"
        lines.append(line)
    return lines


def _phase_mean(evs: List[dict], key: str) -> Optional[float]:
    vals = [float(e[key]) for e in evs if key in e]
    return sum(vals) / len(vals) if vals else None


def phase_summary(events: List[dict]) -> List[str]:
    """The ``== step phases ==`` section (``phase_time`` events,
    docs/telemetry.md): mean per-phase walls over the attributed steps,
    then each fit summary's exposed-comm share and its cost-model
    predicted vs measured grad-sync wall — summaries render WORST
    prediction error first, same convention as the per-op table."""
    pts = [e for e in events if e.get("type") == "phase_time"]
    if not pts:
        return []
    lines = ["== step phases =="]
    per = [e for e in pts if e.get("phase") == "step"]
    if per:
        wall = _phase_mean(per, "step_wall_ms") or 0.0
        parts = []
        for key, label in (("data_wait_ms", "data wait"),
                           ("dispatch_ms", "dispatch"),
                           ("forward_ms", "forward"),
                           ("backward_ms", "backward"),
                           ("sync_wait_ms", "sync wait")):
            v = _phase_mean(per, key)
            if v is not None:
                parts.append(f"{label} {v:.2f}")
        line = (f"{len(per)} attributed step(s): "
                f"wall mean {wall:.2f} ms")
        if parts:
            line += " (" + ", ".join(parts) + " ms)"
        lines.append(line)
    rows = []
    for e in pts:
        if e.get("phase") == "step":
            continue
        line = (f"{e.get('phase', 'fit')}: {e.get('steps', 1)} step(s) "
                f"to step {e['step']}, wall {e['step_wall_ms']:.1f} ms")
        if "exposed_comm_pct" in e:
            line += f", exposed comm {e['exposed_comm_pct']:.1f}%"
        pred = e.get("predicted_sync_ms")
        meas = e.get("sync_wait_ms")
        err = None
        if pred is not None and meas is not None and float(meas) > 0:
            err = 100.0 * abs(float(pred) - float(meas)) / float(meas)
            line += (f", grad-sync predicted {float(pred):.2f} ms vs "
                     f"measured {float(meas):.2f} ms (err {err:.0f}%)")
        rows.append((-1.0 if err is None else err, line))
    rows.sort(key=lambda r: -r[0])  # worst prediction error first
    lines.extend(line for _, line in rows)
    return lines


def search_summary(events: List[dict]) -> List[str]:
    its = [e for e in events
           if e.get("type") == "search" and e.get("phase") == "iteration"]
    sums = [e for e in events
            if e.get("type") == "search" and e.get("phase") == "summary"]
    if not its and not sums:
        return []
    lines = ["== strategy search =="]
    if its:
        acc = sum(1 for e in its if e.get("accepted"))
        best0, bestN = its[0]["best_s"], its[-1]["best_s"]
        lines.append(f"{len(its)} recorded iterations, {acc} accepted "
                     f"({100.0 * acc / len(its):.0f}%)")
        lines.append(f"best simulated cost: {best0 * 1e3:.3f} ms -> "
                     f"{bestN * 1e3:.3f} ms")
    for e in sums:
        line = (f"summary: {e['iterations']} iterations, best "
                f"{e['best_s'] * 1e3:.3f} ms")
        if "acceptance_rate" in e:
            line += f", acceptance {100.0 * e['acceptance_rate']:.0f}%"
        if "start_s" in e:
            line += f" (start {e['start_s'] * 1e3:.3f} ms)"
        if "backend" in e:
            line += f" [{e['backend']}]"
        lines.append(line)
    return lines


def tuning_summary(events: List[dict]) -> List[str]:
    """The ``== tuning ==`` section (sim/tune.py closed loop,
    docs/tuning.md): calibration error before/after each fit,
    whole-step real-vs-sim measurements, candidate-vs-incumbent
    promotion verdicts, and the strategy version lineage the promote
    events record."""
    cals = [e for e in events if e.get("type") == "calibration"]
    promos = [e for e in events
              if e.get("type") == "search" and e.get("phase") == "promote"]
    if not cals and not promos:
        return []
    lines = ["== tuning =="]
    for e in cals:
        ph = e.get("phase")
        if ph == "fit":
            line = f"calibration fit: {e['ops']} ops"
            if "op_classes" in e:
                line += f" ({e['op_classes']} classes)"
            line += (f", mean error {e['mae_pct_before']:.1f}% -> "
                     f"{e['mae_pct_after']:.1f}%")
            if "source" in e:
                line += f" [{e['source']}]"
            lines.append(line)
        elif ph == "measure":
            line = (f"calibration measure: real {e['real_ms']:.3f} ms "
                    f"vs sim {e['sim_ms']:.3f} ms "
                    f"(ratio {e['ratio']:.3f})")
            if "rows" in e and "batch" in e:
                line += f" [rows={e['rows']}, batch={e['batch']}]"
            lines.append(line)
        elif ph == "persist":
            lines.append(f"calibration artifact: {e['artifact']}")
    for e in promos:
        line = f"candidate v{e.get('version', '?')}"
        if "app" in e and "num_devices" in e:
            line += f" [{e['app']}/{e['num_devices']}dev]"
        if "candidate_s" in e:
            line += f" ({e['candidate_s'] * 1e3:.3f} ms)"
        if "incumbent_version" in e:
            line += f" vs incumbent v{e['incumbent_version']}"
            if "incumbent_s" in e:
                line += f" ({e['incumbent_s'] * 1e3:.3f} ms)"
        line += f": {e.get('verdict', '?')}"
        if "tolerance_pct" in e:
            line += f" (tolerance {e['tolerance_pct']:.1f}%)"
        lines.append(line)
    # one lineage PER topology: incumbents are scoped per
    # (app, num_devices) (sim/tune.py::incumbent_path), so chaining
    # across topologies would invent successions that never happened —
    # a shared append-mode sink holds parallel lineages
    chains: Dict[object, List[int]] = {}
    for e in promos:
        if e.get("verdict") in ("first", "promoted") and "version" in e:
            key = (e.get("app"), e.get("num_devices"))
            chains.setdefault(key, []).append(e["version"])
    for (app, ndev), chain in sorted(
            chains.items(),
            key=lambda kv: (str(kv[0][0]),
                            kv[0][1] if isinstance(kv[0][1], int)
                            else -1)):
        scope = (f" [{app}/{ndev}dev]"
                 if app is not None and ndev is not None else "")
        lines.append(f"strategy lineage{scope}: "
                     + " -> ".join(f"v{v}" for v in chain))
    return lines


def resilience_summary(events: List[dict]) -> List[str]:
    """Checkpoint actions, sentinel anomalies, and injected faults of
    one run (resilience subsystem events — docs/resilience.md)."""
    ckpts = [e for e in events if e.get("type") == "checkpoint"]
    anoms = [e for e in events if e.get("type") == "anomaly"]
    faults = [e for e in events if e.get("type") == "fault"]
    if not ckpts and not anoms and not faults:
        return []
    lines = ["== resilience =="]
    if ckpts:
        by_act: Dict[str, int] = {}
        for e in ckpts:
            by_act[e["action"]] = by_act.get(e["action"], 0) + 1
        saves = [e for e in ckpts if e["action"] == "save"]
        parts = [f"{by_act.get('save', 0)} saves"]
        if by_act.get("retry"):
            parts.append(f"{by_act['retry']} retries")
        if by_act.get("save_failed"):
            parts.append(f"{by_act['save_failed']} FAILED saves "
                         f"(run continued)")
        if by_act.get("restore"):
            parts.append(f"{by_act['restore']} restores")
        gcs = [e for e in ckpts if e["action"] == "gc"]
        if gcs:
            parts.append(f"gc removed "
                         f"{sum(e.get('removed_ckpts', 0) for e in gcs)} "
                         f"ckpts + "
                         f"{sum(e.get('removed_tmp', 0) for e in gcs)} tmp")
        lines.append("checkpoints: " + ", ".join(parts))
        if saves:
            last = saves[-1]
            line = f"last save: step {last.get('step', '?')}"
            if "duration_s" in last:
                line += f" ({last['duration_s'] * 1e3:.1f} ms)"
            if "path" in last:
                line += f" at {last['path']}"
            lines.append(line)
    if anoms:
        by_kind: Dict[str, int] = {}
        for e in anoms:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        kinds = ", ".join(f"{n} {k}" for k, n in sorted(by_kind.items()))
        pol = anoms[-1].get("policy", "?")
        lines.append(f"anomalies: {kinds} — "
                     f"{max(e.get('rollbacks', 0) for e in anoms)} "
                     f"rollbacks (policy {pol})")
    if faults:
        by_f: Dict[str, int] = {}
        for e in faults:
            key = f"{e['kind']}@{e['point']}" + (
                f"={e['step']}" if "step" in e else "")
            by_f[key] = by_f.get(key, 0) + 1
        lines.append("faults injected: " + "; ".join(
            f"{k} x{n}" for k, n in sorted(by_f.items())))
    return lines


def serving_summary(events: List[dict]) -> List[str]:
    """Online-serving telemetry (serving/, docs/serving.md): dispatch
    batching efficiency from per-dispatch events, p50/p95/p99 latency +
    QPS from the summary event(s) a batcher drain or serve_bench run
    emits."""
    serves = [e for e in events if e.get("type") == "serve"]
    if not serves:
        return []
    disp = [e for e in serves if e.get("phase") == "dispatch"]
    rejects = [e for e in serves if e.get("phase") == "reject"]
    sums = [e for e in serves if e.get("phase") == "summary"]
    lines = ["== serving =="]
    if disp:
        rows = sum(int(e["batch"]) for e in disp)
        fill = [e["fill"] for e in disp if "fill" in e]
        line = (f"{len(disp)} dispatches, {rows} rows")
        if fill:
            line += f", mean batch fill {100.0 * sum(fill) / len(fill):.0f}%"
        buckets = sorted({int(e["bucket"]) for e in disp})
        line += f" (buckets hit: {buckets})"
        lines.append(line)
        qw = [e["queue_wait_us"] for e in disp]
        cu = [e["compute_us"] for e in disp]
        lines.append(f"per dispatch: queue wait mean "
                     f"{sum(qw) / len(qw):.0f} us, compute mean "
                     f"{sum(cu) / len(cu):.0f} us")
    if rejects:
        by_r: Dict[str, int] = {}
        for e in rejects:
            by_r[e.get("reason", "?")] = by_r.get(e.get("reason", "?"),
                                                  0) + 1
        lines.append("shed: " + ", ".join(f"{n} {r}"
                                          for r, n in sorted(by_r.items())))
    for e in sums:
        line = (f"summary: {e['requests']} requests, "
                f"{e['qps']:,.0f} QPS")
        if "wall_s" in e:
            line += f" over {e['wall_s']:.2f}s"
        if "p50_us" in e:
            line += (f"; latency p50 {e['p50_us']:.0f} us"
                     f" / p95 {e.get('p95_us', float('nan')):.0f} us"
                     f" / p99 {e.get('p99_us', float('nan')):.0f} us")
        parts = []
        if e.get("rejected"):
            parts.append(f"{e['rejected']} rejected")
        if e.get("deadline_misses"):
            parts.append(f"{e['deadline_misses']} deadline misses")
        if parts:
            line += f" ({', '.join(parts)})"
        lines.append(line)
    return lines


#: exemplar phase keys -> the attributed-phase names the tail section
#: ranks (the order is display order for the breakdown column)
_TAIL_PHASES = (("queue_wait", "queue_wait_us"), ("pad", "pad_us"),
                ("engine_forward", "compute_us"),
                ("miss_stall", "stall_us"))


def _tail_rows(events: List[dict]) -> List[dict]:
    """THE tail-exemplar row selection + ranking (text section and
    ``report_data`` share it so the two forms can never order
    differently — the `_per_op_rows` discipline): one row per
    ``serve`` ``phase="tail"`` exemplar, deduped by trace id (a
    re-emitted summary must not double a request; the slowest
    observation wins), ranked by end-to-end latency WORST-FIRST."""
    latest: Dict[str, dict] = {}
    anon: List[dict] = []
    for e in events:
        if e.get("type") != "serve" or e.get("phase") != "tail":
            continue
        tid = e.get("trace_id") or ""
        if not tid:
            anon.append(e)
        elif (tid not in latest
                or float(e["lat_us"]) > float(latest[tid]["lat_us"])):
            latest[tid] = e
    rows = list(latest.values()) + anon
    rows.sort(key=lambda e: -float(e["lat_us"]))
    return rows


def _tail_phase_ranking(rows: List[dict]) -> List[Tuple[str, float]]:
    """(phase, attributed us) summed across the exemplar rows,
    worst-first — the 'what makes the p99 slow' answer both renderers
    share."""
    sums = {name: 0.0 for name, _k in _TAIL_PHASES}
    for e in rows:
        for name, key in _TAIL_PHASES:
            sums[name] += float(e.get(key, 0.0))
    return sorted(sums.items(), key=lambda kv: -kv[1])


def tail_summary(events: List[dict]) -> List[str]:
    """Tail-latency exemplars (serving/stats.py top-K — docs/slo.md):
    the slowest recorded requests with their span-derived phase
    decomposition, plus the phase ranking that names what the p99 is
    made of."""
    rows = _tail_rows(events)
    if not rows:
        return []
    lines = ["== tail =="]
    ranking = _tail_phase_ranking(rows)
    total = sum(v for _n, v in ranking) or 1.0
    lines.append("p99 contributors by attributed phase (worst-first): "
                 + ", ".join(f"{n} {100.0 * v / total:.0f}%"
                             for n, v in ranking))
    lines.append(f"{'lat(us)':>10s} {'bucket':>7s} {'dominant':>15s} "
                 f"{'queue(us)':>10s} {'pad(us)':>8s} {'fwd(us)':>10s} "
                 f"{'stall(us)':>10s}  trace")
    for e in rows:
        lines.append(
            f"{float(e['lat_us']):10.1f} {int(e.get('bucket', 0)):7d} "
            f"{e.get('dominant', '?'):>15s} "
            f"{float(e.get('queue_wait_us', 0.0)):10.1f} "
            f"{float(e.get('pad_us', 0.0)):8.1f} "
            f"{float(e.get('compute_us', 0.0)):10.1f} "
            f"{float(e.get('stall_us', 0.0)):10.1f}  "
            f"{e.get('trace_id', '')}")
    return lines


def slo_summary(events: List[dict]) -> List[str]:
    """SLO engine readout (telemetry/slo.py — docs/slo.md): per
    objective, the newest evaluation's budget/burn plus the breach and
    recover tallies."""
    slos = [e for e in events if e.get("type") == "slo"]
    if not slos:
        return []
    latest: Dict[str, dict] = {}
    breaches: Dict[str, int] = {}
    recovers: Dict[str, int] = {}
    for e in slos:
        name = e.get("slo", "?")
        latest[name] = e
        if e.get("phase") == "breach":
            breaches[name] = breaches.get(name, 0) + 1
        elif e.get("phase") == "recover":
            recovers[name] = recovers.get(name, 0) + 1
    lines = ["== slo =="]
    for name in sorted(latest):
        e = latest[name]
        line = (f"{name}: budget {float(e.get('budget_pct', 0.0)):.2f}% "
                f"remaining, burn fast "
                f"{float(e.get('burn_fast', 0.0)):.2f} / slow "
                f"{float(e.get('burn_slow', 0.0)):.2f}")
        nb, nr = breaches.get(name, 0), recovers.get(name, 0)
        if nb or nr:
            line += f" ({nb} breach(es), {nr} recover(s)"
            doms = [x.get("dominant") for x in slos
                    if x.get("slo") == name and x.get("phase") == "breach"
                    and x.get("dominant")]
            if doms:
                line += f"; dominant tail phase {doms[-1]}"
            line += ")"
        lines.append(line)
    return lines


def span_summary(events: List[dict]) -> List[str]:
    """Span roll-up (telemetry/trace.py): per-name counts and mean
    duration, trace count, and the non-ok status tally — the quick
    'what did the traced requests actually do' view; the full timeline
    lives in ``export-trace``."""
    spans = [e for e in events if e.get("type") == "span"]
    if not spans:
        return []
    lines = ["== spans =="]
    traces = {e["trace_id"] for e in spans}
    lines.append(f"{len(spans)} spans across {len(traces)} traces")
    by_name: Dict[str, List[dict]] = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    lines.append(f"{'span':28s} {'count':>7s} {'mean(us)':>10s} "
                 f"{'max(us)':>10s}")
    for name, evs in sorted(by_name.items()):
        durs = [e["dur_us"] for e in evs]
        lines.append(f"{name:28s} {len(evs):7d} "
                     f"{sum(durs) / len(durs):10.1f} {max(durs):10.1f}")
    bad: Dict[str, int] = {}
    for e in spans:
        st = e.get("status", "ok")
        if st != "ok":
            bad[st] = bad.get(st, 0) + 1
    if bad:
        lines.append("non-ok: " + ", ".join(
            f"{n} {s}" for s, n in sorted(bad.items())))
    return lines


def find_analysis_artifacts(near: str = ".") -> List[str]:
    """Every ``artifacts/analysis_*.json`` sink (the static analyzer's
    output, ffcheck) near a run —
    looked up under ``<near>/artifacts`` and ``./artifacts`` — newest
    first.  Index 0 is the run to report; index 1 (when present) is
    the previous run the ``== analysis ==`` delta compares against."""
    import glob

    cands: List[str] = []
    seen = set()
    for base in dict.fromkeys((near or ".", ".")):
        for p in glob.glob(os.path.join(base, "artifacts",
                                        "analysis_*.json")):
            # dedupe by REAL path: `near` spelled absolutely while
            # CWD is the same directory must not list (and delta
            # against) the same sink twice under two spellings
            real = os.path.realpath(p)
            if real in seen or not os.path.isfile(p):
                continue
            seen.add(real)
            cands.append(p)
    return sorted(cands, key=os.path.getmtime, reverse=True)


def find_analysis_artifact(near: str = ".") -> Optional[str]:
    """The newest sink, or None when no analyzer run left one."""
    found = find_analysis_artifacts(near)
    return found[0] if found else None


def load_analysis(path: str) -> Optional[dict]:
    """Parse one analyzer JSON sink; None when unreadable/not ffcheck
    output (the report must render regardless)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and doc.get("tool") == "ffcheck" \
        else None


def _per_pass_counts(doc: dict) -> Dict[str, Dict[str, int]]:
    """``by_pass`` from the sink (ffcheck v2 writes it), reconstructed
    from the finding lists for pre-v2 sinks so the delta still works."""
    bp = doc.get("by_pass")
    if isinstance(bp, dict) and bp:
        return {k: {"findings": int(v.get("findings", 0)),
                    "waived": int(v.get("waived", 0))}
                for k, v in bp.items()}
    out: Dict[str, Dict[str, int]] = {
        p: {"findings": 0, "waived": 0} for p in doc.get("passes", [])}
    for f in doc.get("findings", []):
        out.setdefault(f.get("pass", "?"),
                       {"findings": 0, "waived": 0})["findings"] += 1
    for f in doc.get("waived", []):
        out.setdefault(f.get("pass", "?"),
                       {"findings": 0, "waived": 0})["waived"] += 1
    return out


def comparable_sinks(doc: dict, prev: dict) -> bool:
    """Two sinks delta meaningfully only when they cover the same
    scope: a ``--changed-only`` run's counts are filtered by the diff,
    so comparing it against a full-tree run (or a differently-scoped
    one) reports movement that is pure scope, not change."""
    return doc.get("changed_only") == prev.get("changed_only")


def analysis_delta(doc: dict, prev: dict) -> Dict[str, object]:
    """This run vs the previous sink: total finding/waived deltas plus
    the per-pass breakdown for passes whose counts moved (a pass absent
    from one side counts as zero — a NEW pass's findings are a delta,
    not a blind spot).  Callers gate on :func:`comparable_sinks` —
    scoped and full-tree runs must not delta against each other."""
    cur, old = _per_pass_counts(doc), _per_pass_counts(prev)
    per_pass: Dict[str, Dict[str, int]] = {}
    for name in sorted(set(cur) | set(old)):
        c = cur.get(name, {"findings": 0, "waived": 0})
        o = old.get(name, {"findings": 0, "waived": 0})
        df = c["findings"] - o["findings"]
        dw = c["waived"] - o["waived"]
        if df or dw:
            per_pass[name] = {"findings": df, "waived": dw}
    cs, os_ = doc.get("summary", {}), prev.get("summary", {})
    return {
        "findings": int(cs.get("findings", 0)) - int(os_.get("findings", 0)),
        "waived": int(cs.get("waived", 0)) - int(os_.get("waived", 0)),
        "per_pass": per_pass,
    }


def analysis_summary(doc: dict, src: str,
                     prev: Optional[Tuple[dict, str]] = None
                     ) -> List[str]:
    """The ``== analysis ==`` section: one ffcheck headline, per-pass
    finding counts, the delta vs the previous sink (when one exists),
    plus the first few findings/stale waivers when the run was not
    clean."""
    s = doc.get("summary", {})
    lines = ["== analysis =="]
    status = "OK" if s.get("ok") else "FAIL"
    lines.append(f"ffcheck: {status} — {s.get('findings', 0)} "
                 f"finding(s), {s.get('waived', 0)} waived, "
                 f"{s.get('unused_waivers', 0)} stale waiver(s); "
                 f"{len(doc.get('passes', []))} passes over "
                 f"{doc.get('modules', '?')} modules ({src})")
    per = _per_pass_counts(doc)
    if per:
        lines.append("per-pass: " + ", ".join(
            f"{name} {c['findings']}"
            + (f" (+{c['waived']} waived)" if c["waived"] else "")
            for name, c in sorted(per.items())))
    if prev is not None:
        pdoc, psrc = prev
        d = analysis_delta(doc, pdoc)
        moved = ", ".join(
            f"{name} {v['findings']:+d}/{v['waived']:+d}"
            for name, v in d["per_pass"].items())
        lines.append(
            f"delta vs {os.path.basename(psrc)}: "
            f"findings {d['findings']:+d}, waived {d['waived']:+d}"
            + (f" ({moved})" if moved else ""))
    shown = 0
    for f in doc.get("findings", []):
        if shown >= 8:
            lines.append(f"  ... {len(doc['findings']) - shown} more")
            break
        lines.append(f"  {f.get('path')}:{f.get('line')}: "
                     f"[{f.get('pass')}/{f.get('code')}] "
                     f"{f.get('message')}")
        shown += 1
    for w in doc.get("unused_waivers", [])[:4]:
        lines.append(f"  stale waiver: {w.get('key')}")
    return lines


#: section name -> text renderer; report_data mirrors these keys so the
#: text and JSON forms can never disagree about which sections a run has
def _fleet_section(events: List[dict]) -> List[str]:
    from .fleet import fleet_section

    return fleet_section(events)


def _row_freq_section(events: List[dict]) -> List[str]:
    from .rowfreq import row_freq_summary

    return row_freq_summary(events)


SECTIONS = (
    ("throughput", throughput_summary),
    ("fleet", _fleet_section),
    ("distributed", distributed_summary),
    ("phases", phase_summary),
    ("per_op", per_op_table),
    ("calibration", calibration_summary),
    ("compile", compile_timeline),
    ("memory", memory_summary),
    ("row_freq", _row_freq_section),
    ("search", search_summary),
    ("tuning", tuning_summary),
    ("resilience", resilience_summary),
    ("serving", serving_summary),
    ("tail", tail_summary),
    ("slo", slo_summary),
    ("spans", span_summary),
)


def format_report(events: List[dict],
                  analysis: Optional[Tuple] = None) -> str:
    if not events and analysis is None:
        return "(no events)"
    by = _by_type(events)
    if events:
        t0 = min(e["ts"] for e in events)
        t1 = max(e["ts"] for e in events)
        lines = ["== run summary ==",
                 f"{len(events)} events over {t1 - t0:.1f}s: "
                 + ", ".join(f"{len(v)} {k}"
                             for k, v in sorted(by.items()))]
    else:
        lines = ["== run summary ==", "(no events)"]
    for _name, section in SECTIONS:
        part = section(events)
        if part:
            lines.append("")
            lines.extend(part)
    if analysis is not None:
        lines.append("")
        lines.extend(analysis_summary(*analysis))
    return "\n".join(lines)


def _attach_analysis(out: Dict[str, object],
                     analysis: Optional[Tuple]) -> None:
    """THE analysis-key attach (both report_data exits use it, so the
    shape cannot drift between the empty- and populated-run paths).
    ``analysis`` is ``(doc, src)`` or ``(doc, src, (prev_doc,
    prev_src))`` — same tuple the text renderer takes, so the JSON
    form carries the identical per-pass counts and delta."""
    if analysis is not None:
        doc, src = analysis[0], analysis[1]
        prev = analysis[2] if len(analysis) > 2 else None
        data = {**doc.get("summary", {}), "source": src,
                "per_pass": _per_pass_counts(doc),
                "lines": analysis_summary(doc, src, prev)[1:]}
        if prev is not None:
            data["delta"] = {**analysis_delta(doc, prev[0]),
                             "previous": prev[1]}
        out["analysis"] = data


def report_data(events: List[dict],
                analysis: Optional[Tuple] = None
                ) -> Dict[str, object]:
    """The ``--format json`` object: one ``run`` header plus, for every
    section the text report would print, that section's lines as
    structured data — section presence is IDENTICAL to the text report
    (both iterate :data:`SECTIONS`, and both gate the ``analysis``
    section on the same discovered artifact), and each section carries
    its headline numbers next to the rendered lines so dashboards and
    the regress gate can consume values without re-parsing text."""
    out: Dict[str, object] = {}
    if not events:
        out = {"run": {"events": 0}}
        _attach_analysis(out, analysis)
        return out
    by = _by_type(events)
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] for e in events)
    out["run"] = {"events": len(events), "wall_s": t1 - t0,
                  "by_type": {k: len(v) for k, v in sorted(by.items())}}
    headline: Dict[str, Dict[str, object]] = {k: {} for k, _ in SECTIONS}
    steps = by.get("step", [])
    fenced = [e for e in steps if e.get("fenced")]
    if steps:
        h = headline["throughput"]
        h["step_events"] = len(steps)
        h["fenced"] = len(fenced)
        h["samples"] = sum(int(e.get("samples", 0)) for e in steps)
        if fenced:
            h["best_fenced_samples_per_s"] = _best_fenced(fenced)[1]
        losses = [e["loss"] for e in steps if "loss" in e]
        if losses:
            h["loss_first"], h["loss_last"] = losses[0], losses[-1]
    ops = by.get("op_time", [])
    if ops:
        per_rows = []
        for e in _per_op_rows(ops):
            row = {k: e[k] for k in ("op", "forward_s", "backward_s",
                                     "sim_forward_s", "sim_backward_s")
                   if k in e}
            err = _op_err_pct(e)
            if err is not None:
                row["err_pct"] = err
            per_rows.append(row)
        headline["per_op"]["ops"] = per_rows
    comps = by.get("compile", [])
    if comps:
        misses = [e for e in comps if e["kind"] == "backend_compile"]
        aots = [e for e in comps if e["kind"] == "aot"]
        headline["compile"] = {
            "backend_compiles": len(misses),
            "backend_compile_s": sum(e["duration_s"] for e in misses),
            "aot_builds": len(aots),
            "aot_s": sum(e["duration_s"] for e in aots)}
    fits = [e for e in by.get("calibration", [])
            if e.get("phase") == "fit"]
    promos = [e for e in by.get("search", [])
              if e.get("phase") == "promote"]
    if fits:
        headline["tuning"].update(
            {k: fits[-1][k] for k in ("mae_pct_before", "mae_pct_after",
                                      "ops", "op_classes")
             if k in fits[-1]})
    if promos:
        headline["tuning"].update(
            {k: promos[-1][k]
             for k in ("verdict", "version", "incumbent_version",
                       "candidate_s", "incumbent_s")
             if k in promos[-1]})
    pts = by.get("phase_time", [])
    if pts:
        h = headline["phases"]
        h["attributed_steps"] = sum(1 for e in pts
                                    if e.get("phase") == "step")
        sums = [e for e in pts if e.get("phase") != "step"]
        exposed = [e for e in sums if "exposed_comm_pct" in e]
        if exposed:
            h["exposed_comm_pct"] = exposed[-1]["exposed_comm_pct"]
        preds = [e for e in sums
                 if "predicted_sync_ms" in e and "sync_wait_ms" in e]
        if preds:
            e = preds[-1]
            h["predicted_sync_ms"] = e["predicted_sync_ms"]
            h["measured_sync_ms"] = e["sync_wait_ms"]
    if len({e["pidx"] for e in events if "pidx" in e}) >= 2:
        from .fleet import fleet_data

        headline["fleet"] = fleet_data(events)
    rfs = by.get("row_freq", [])
    if rfs:
        latest: Dict[str, dict] = {}
        for e in rfs:
            latest[e["table"]] = e
        headline["row_freq"]["tables"] = {
            t: {k: e[k] for k in ("rows_seen", "unique_ids", "top_ids",
                                  "top_counts", "bucket_counts")
                if k in e}
            for t, e in latest.items()}
    inits = by.get("distributed", [])
    if inits:
        headline["distributed"] = {
            k: inits[-1][k]
            for k in ("process_index", "process_count",
                      "global_devices", "local_devices", "slices")
            if k in inits[-1]}
    serves = by.get("serve", [])
    sums = [e for e in serves if e.get("phase") == "summary"]
    if sums:
        headline["serving"] = {
            k: sums[-1][k] for k in ("requests", "qps", "p50_us", "p95_us",
                                     "p99_us", "rejected",
                                     "deadline_misses", "dispatches")
            if k in sums[-1]}
    tail_rows = _tail_rows(events)
    if tail_rows:
        # the SAME selection the text section renders (ordering cannot
        # drift between --format json and the text table)
        headline["tail"] = {
            "rows": [{k: e[k] for k in ("bucket", "lat_us", "trace_id",
                                        "dominant", "queue_wait_us",
                                        "pad_us", "compute_us",
                                        "stall_us")
                      if k in e}
                     for e in tail_rows],
            "phase_ranking": [
                {"phase": n, "us": v}
                for n, v in _tail_phase_ranking(tail_rows)]}
    slos = by.get("slo", [])
    if slos:
        latest_slo: Dict[str, dict] = {}
        for e in slos:
            latest_slo[e.get("slo", "?")] = e
        headline["slo"] = {
            "objectives": {
                n: {k: e[k] for k in ("phase", "value", "burn_fast",
                                      "burn_slow", "budget_pct",
                                      "dominant", "flight")
                    if k in e}
                for n, e in sorted(latest_slo.items())},
            "breaches": sum(1 for e in slos
                            if e.get("phase") == "breach")}
    spans = by.get("span", [])
    if spans:
        names: Dict[str, int] = {}
        for e in spans:
            names[e["name"]] = names.get(e["name"], 0) + 1
        headline["spans"] = {
            "spans": len(spans),
            "traces": len({e["trace_id"] for e in spans}),
            "by_name": names}
    for name, section in SECTIONS:
        lines = section(events)
        if lines:
            out[name] = {**headline.get(name, {}), "lines": lines[1:]}
    _attach_analysis(out, analysis)
    return out


def main(argv=None) -> int:
    import argparse
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["regress"]:
        # forwarded VERBATIM so regress's options are declared once, in
        # regress.py's own parser (argparse.REMAINDER cannot forward
        # leading optionals — bpo-17050)
        from .regress import main as regress_main

        return regress_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="python -m dlrm_flexflow_tpu_torch.telemetry",
        description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd")
    rep = sub.add_parser("report", help="summarize a telemetry JSONL")
    rep.add_argument("path", nargs="?", default=None,
                     help="one telemetry JSONL, or a directory of "
                          "per-process telemetry_pNNN.jsonl sinks "
                          "(merged and attributed by pidx)")
    rep.add_argument("--strict", action="store_true",
                     help="fail on malformed/invalid lines instead of "
                          "skipping them")
    rep.add_argument("--format", choices=("text", "json"), default="text",
                     help="text sections (default) or one JSON object "
                          "with the same sections")
    rep.add_argument("--fleet", metavar="DIR", default=None,
                     help="merge a directory of per-process sinks and "
                          "render the fleet view (same as passing the "
                          "directory as PATH)")
    rep.add_argument("--flight", metavar="PATH", default=None,
                     help="render one flight-recorder artifact "
                          "(artifacts/flightrecorder_<ts>.json): the "
                          "last seconds before the run died")
    exp = sub.add_parser("export-trace",
                         help="render spans + step/compile/op_time "
                              "events as Chrome-trace JSON for "
                              "ui.perfetto.dev")
    exp.add_argument("path")
    exp.add_argument("-o", "--output", default=None,
                     help="output path (default: <path>.trace.json)")
    sub.add_parser("regress",
                   help="perf-regression gate over bench artifacts "
                        "(handled above — options live in regress.py; "
                        "see `regress --help`)")
    args = p.parse_args(argv)
    if args.cmd == "report":
        if args.flight is not None:
            from .fleet import load_flight_record, render_flight

            print("\n".join(render_flight(
                load_flight_record(args.flight))))
            return 0
        src = args.fleet if args.fleet is not None else args.path
        if src is None:
            rep.error("a telemetry PATH, --fleet DIR, or "
                      "--flight PATH is required")
        events = load_events(src, strict=args.strict)
        # the == analysis == section rides along when an ffcheck sink
        # (artifacts/analysis_*.json) sits next to the run or the CWD;
        # the second-newest sink (when present) feeds the delta line
        analysis = None
        sinks = find_analysis_artifacts(
            src if os.path.isdir(src)
            else (os.path.dirname(src) or "."))
        if sinks:
            doc = load_analysis(sinks[0])
            if doc is not None:
                prev = None
                for p in sinks[1:]:
                    pdoc = load_analysis(p)
                    if pdoc is not None and comparable_sinks(doc, pdoc):
                        prev = (pdoc, p)
                        break
                analysis = (doc, sinks[0], prev) if prev is not None \
                    else (doc, sinks[0])
        if args.format == "json":
            print(json.dumps(report_data(events, analysis=analysis),
                             indent=1, default=str))
        else:
            print(format_report(events, analysis=analysis))
        return 0
    if args.cmd == "export-trace":
        from .exporter import export_trace

        out = args.output or (args.path + ".trace.json")
        stats = export_trace(args.path, out)
        print(f"export-trace: {stats['events']} events "
              f"({stats['spans']} spans) -> {stats['trace_events']} "
              f"trace events in {out} (open in https://ui.perfetto.dev)")
        return 0
    p.print_help()
    return 2
