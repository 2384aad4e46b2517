"""Fleet observability: cross-process telemetry aggregation, straggler
attribution and the crash flight recorder (counterpart of
``dlrm_flexflow_tpu/telemetry/fleet.py``).

* **Per-process sinks**: :func:`fleet_event_log` gives each process its
  own ``telemetry_pNNN.jsonl`` and stamps every event with the
  producer's ``pidx``/``slice``, so merged streams stay attributable.
  One process: the plain path and no stamp, the output unchanged.
* **Fleet merge**: :func:`load_fleet_events` merges a directory of
  per-process sinks; :func:`fleet_data` aligns ``phase_time`` events by
  global step and computes each step's straggler skew (slowest minus
  median wall, the worst process named), throughput per slice and the
  measured exposed-communication share that ``report --fleet`` renders.
* **Flight recorder**: :func:`dump_flight_record` writes the EventLog
  ring, the still-open spans and a metrics snapshot to
  ``artifacts/flightrecorder_<ts>.json`` when a run dies (atomic tmp +
  rename, best effort, never masking the original exception);
  ``report --flight`` renders the last seconds before the death.

A process's identity comes from ``torch.distributed`` when a process
group is initialised (rank and world size), and is process 0 of 1
otherwise.  A GPU has no TPU ``slice_index``: a process is its own slice
when there are several, as the JAX package does where that metadata is
missing, and one process is slice 0.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

from .events import EventLog, active_log, set_event_log

#: filename prefix of flight-recorder artifacts (globbed by
#: :func:`find_flight_records`; the trailing ``.tmp`` of an in-flight
#: write never matches, so a partial dump is never parsed)
FLIGHT_PREFIX = "flightrecorder_"

_PIDX_RE = re.compile(r"_p(\d+)\.jsonl$")


def process_identity():
    """(process index, process count): the torch.distributed rank and
    world size when a process group is up, else (0, 1)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:
        pass
    return 0, 1


# ------------------------------------------------------------ per-host sinks
def fleet_stamp(pidx: Optional[int] = None,
                slice_id: Optional[int] = None,
                nproc: Optional[int] = None) -> Dict[str, int]:
    """This process' fleet identity as an event stamp (``{"pidx": ...,
    "slice": ...}``, schema COMMON_OPTIONAL).  ``slice`` is the process
    index when there are several processes and 0 for one; explicit
    arguments override discovery (how tests doctor a 3-process fleet from
    one interpreter)."""
    rank, world = process_identity()
    if pidx is None:
        pidx = rank
    if nproc is None:
        nproc = world
    if slice_id is None:
        slice_id = pidx if nproc > 1 else 0
    return {"pidx": int(pidx), "slice": int(slice_id)}


def process_sink_path(path: str, pidx: Optional[int] = None,
                      nproc: Optional[int] = None) -> str:
    """Rewrite a telemetry sink path for this process: ``telemetry.jsonl``
    -> ``telemetry_p002.jsonl`` with more than one process, unchanged with
    one, so a single-process run keeps its single file."""
    rank, world = process_identity()
    if nproc is None:
        nproc = world
    if nproc <= 1:
        return path
    if pidx is None:
        pidx = rank
    root, ext = os.path.splitext(path)
    return f"{root}_p{int(pidx):03d}{ext or '.jsonl'}"


@contextlib.contextmanager
def fleet_event_log(path: Optional[str] = None, ring: int = 4096,
                    mode: str = "a",
                    pidx: Optional[int] = None,
                    slice_id: Optional[int] = None,
                    nproc: Optional[int] = None):
    """``event_log`` for a fleet: the sink lands at this process'
    :func:`process_sink_path` and every event carries the
    :func:`fleet_stamp`, with more than one process.  With one it is
    exactly ``event_log(path, ring, mode)``: the same path, no stamp."""
    if nproc is None:
        nproc = process_identity()[1]
    stamp = (fleet_stamp(pidx=pidx, slice_id=slice_id, nproc=nproc)
             if nproc > 1 else None)
    sink = (process_sink_path(path, pidx=pidx, nproc=nproc)
            if path else None)
    log = EventLog(path=sink, ring=ring, mode=mode, stamp=stamp)
    prev = set_event_log(log)
    try:
        yield log
    finally:
        set_event_log(prev)
        log.close()


# ------------------------------------------------------------- fleet merge
def load_fleet_events(directory: str, strict: bool = False) -> List[dict]:
    """Merge every ``*.jsonl`` in ``directory`` into one time-ordered
    event list.  Events from a per-process sink that predate stamping
    (or were written by a process that crashed before its stamp stuck)
    inherit ``pidx`` from the ``_pNNN`` filename so attribution still
    works; events that already carry a stamp keep it."""
    from .report import load_events

    names = sorted(n for n in os.listdir(directory)
                   if n.endswith(".jsonl"))
    if not names:
        raise FileNotFoundError(
            f"no .jsonl telemetry sinks in {directory!r}")
    merged: List[dict] = []
    for name in names:
        evs = load_events(os.path.join(directory, name), strict=strict)
        m = _PIDX_RE.search(name)
        if m is not None:
            pidx = int(m.group(1))
            for e in evs:
                e.setdefault("pidx", pidx)
        merged.extend(evs)
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return merged


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def fleet_data(events: List[dict]) -> Dict[str, Any]:
    """The ``== fleet ==`` numbers from a merged event stream (also the
    ``--format json`` payload — both render from this one dict so text
    and JSON cannot disagree).

    * ``steps``: per aligned global step (``phase_time`` events with
      ``phase="step"`` from >= 2 hosts), the median and slowest host
      wall, their difference (the straggler skew), and which ``pidx``
      was slowest.
    * ``straggler``: the host that owns the most total skew.
    * ``exposed_comm_pct``: wall-weighted measured exposed-comm share
      (sum of ``sync_wait_ms`` over sum of ``step_wall_ms`` across
      per-step events; falls back to summary events' own
      ``exposed_comm_pct`` wall-weighted when no per-step walls carry
      sync).
    * ``per_slice``: samples/s per DCN slice (each host's last fenced
      ``step`` event, summed within its slice).

    Best-effort folds the newest skew / exposed-comm readings into the
    ``dlrm_step_skew_ms`` / ``dlrm_exposed_comm_pct`` gauges.
    """
    pts = [e for e in events if e.get("type") == "phase_time"]
    steps = [e for e in events if e.get("type") == "step"]
    hosts = sorted({e["pidx"] for e in pts + steps if "pidx" in e})

    per_step = [e for e in pts if e.get("phase") == "step"]
    by_step: Dict[int, Dict[int, dict]] = {}
    for e in per_step:
        if "pidx" not in e:
            continue
        by_step.setdefault(int(e["step"]), {})[int(e["pidx"])] = e
    rows: List[Dict[str, Any]] = []
    for s, per in sorted(by_step.items()):
        if len(per) < 2:
            continue  # a step one host saw cannot have skew
        walls = {p: float(ev["step_wall_ms"]) for p, ev in per.items()}
        worst = max(walls, key=lambda p: (walls[p], p))
        med = _median(list(walls.values()))
        rows.append({"step": s, "hosts": len(walls),
                     "median_ms": med, "slowest_ms": walls[worst],
                     "skew_ms": walls[worst] - med, "worst_pidx": worst})

    straggler: Optional[Dict[str, Any]] = None
    if rows:
        skew_by_host: Counter = Counter()
        steps_by_host: Counter = Counter()
        for r in rows:
            skew_by_host[r["worst_pidx"]] += r["skew_ms"]
            steps_by_host[r["worst_pidx"]] += 1
        pidx = max(skew_by_host,
                   key=lambda p: (skew_by_host[p], steps_by_host[p], -p))
        straggler = {"pidx": pidx,
                     "worst_steps": steps_by_host[pidx],
                     "of_steps": len(rows),
                     "total_skew_ms": skew_by_host[pidx],
                     "max_skew_ms": max(r["skew_ms"] for r in rows
                                        if r["worst_pidx"] == pidx)}

    sync_evs = [e for e in per_step if "sync_wait_ms" in e]
    if sync_evs:
        num = sum(float(e["sync_wait_ms"]) for e in sync_evs)
        den = sum(float(e["step_wall_ms"]) for e in sync_evs)
        exposed = 100.0 * num / den if den else None
    else:
        sums = [e for e in pts if e.get("phase") != "step"
                and "exposed_comm_pct" in e]
        if sums:
            den = sum(float(e["step_wall_ms"]) for e in sums)
            num = sum(float(e["exposed_comm_pct"])
                      * float(e["step_wall_ms"]) for e in sums)
            exposed = num / den if den else None
        else:
            exposed = None

    per_slice: Dict[int, float] = {}
    slice_hosts: Dict[int, set] = {}
    last_fenced: Dict[int, dict] = {}
    for e in steps:  # newest fenced step event per host wins
        if e.get("fenced") and "pidx" in e:
            last_fenced[int(e["pidx"])] = e
    for pidx, e in last_fenced.items():
        sl = int(e.get("slice", 0))
        sps = e.get("samples_per_s")
        if sps is None:
            sps = float(e.get("samples", 0)) / max(float(e["wall_s"]),
                                                   1e-12)
        per_slice[sl] = per_slice.get(sl, 0.0) + float(sps)
        slice_hosts.setdefault(sl, set()).add(pidx)

    out: Dict[str, Any] = {
        "hosts": hosts,
        "aligned_steps": len(rows),
        "steps": rows,
        "straggler": straggler,
        "exposed_comm_pct": exposed,
        "per_slice": {s: {"samples_per_s": per_slice[s],
                          "hosts": len(slice_hosts[s])}
                      for s in sorted(per_slice)},
    }
    if rows:
        skews = [r["skew_ms"] for r in rows]
        out["skew"] = {"mean_ms": sum(skews) / len(skews),
                       "max_ms": max(skews), "last_ms": skews[-1]}
    try:  # fold newest readings into the fleet gauges
        from . import metrics as _m
        if rows:
            _m.STEP_SKEW_MS.set(rows[-1]["skew_ms"])
        if exposed is not None:
            _m.EXPOSED_COMM_PCT.set(exposed)
    except Exception:
        pass
    return out


def render_fleet(data: Dict[str, Any]) -> List[str]:
    """The ``== fleet ==`` text section from :func:`fleet_data` output
    (empty when the stream carries no multi-host signal).  Skew rows
    render worst-first, same convention as the per-op table."""
    hosts = data.get("hosts") or []
    if len(hosts) < 2:
        return []
    lines = ["== fleet =="]
    names = " ".join(f"p{p:03d}" for p in hosts)
    n_slices = len(data.get("per_slice") or {}) or 1
    lines.append(f"{len(hosts)} host(s) ({names}), {n_slices} slice(s), "
                 f"{data['aligned_steps']} aligned step(s)")
    st = data.get("straggler")
    if st is not None:
        lines.append(
            f"straggler: p{st['pidx']:03d} — slowest on "
            f"{st['worst_steps']}/{st['of_steps']} aligned steps, "
            f"max skew {st['max_skew_ms']:.1f} ms, total "
            f"{st['total_skew_ms']:.1f} ms")
    sk = data.get("skew")
    if sk is not None:
        lines.append(f"per-step skew (slowest - median): mean "
                     f"{sk['mean_ms']:.1f} ms, max {sk['max_ms']:.1f} ms")
    rows = sorted(data.get("steps") or [],
                  key=lambda r: -r["skew_ms"])[:5]
    if rows:
        lines.append("  step    hosts   median(ms)  slowest(ms)  "
                     "skew(ms)  worst")
        for r in rows:
            lines.append(f"  {r['step']:>6}  {r['hosts']:>5}   "
                         f"{r['median_ms']:>10.1f}  "
                         f"{r['slowest_ms']:>11.1f}  "
                         f"{r['skew_ms']:>8.1f}  p{r['worst_pidx']:03d}")
    if data.get("exposed_comm_pct") is not None:
        lines.append(f"exposed comm: {data['exposed_comm_pct']:.1f}% of "
                     f"step wall (measured grad-sync wait, "
                     f"wall-weighted)")
    for sl, d in (data.get("per_slice") or {}).items():
        lines.append(f"slice {sl}: {d['samples_per_s']:,.0f} samples/s "
                     f"over {d['hosts']} host(s)")
    return lines


def fleet_section(events: List[dict]) -> List[str]:
    """SECTIONS-shaped renderer: the fleet section appears exactly when
    the merged stream carries events from >= 2 distinct hosts."""
    if len({e["pidx"] for e in events if "pidx" in e}) < 2:
        return []
    return render_fleet(fleet_data(events))


# --------------------------------------------------- cost-model prediction
def predicted_sync_ms(params=None,
                      bytes_per_chip: Optional[float] = None
                      ) -> Optional[float]:
    """The two-level cost model's price for one step's data-parallel grad
    all-reduce over the process group's ranks, in ms (JAX
    ``telemetry/fleet.py:325-347``): the PREDICTED column beside the
    measured ``sync_wait_ms``.  ``params`` (a ``{op: {param: tensor}}``
    tree) sizes the gradients; ``bytes_per_chip`` overrides.  None when
    unpriceable: one rank, or no parameters."""
    try:
        rank, n = process_identity()
        if n <= 1:
            return None
        if bytes_per_chip is None:
            def leaves(tree):
                if isinstance(tree, dict):
                    return [x for v in tree.values() for x in leaves(v)]
                return [tree]
            bytes_per_chip = float(sum(
                t.numel() * t.element_size() for t in leaves(params or {})
                if hasattr(t, "element_size")))
        if not bytes_per_chip:
            return None
        from ..distributed import pod_topology
        from ..sim.cost_model import H100MachineModel
        machine = H100MachineModel(topology=pod_topology())
        return machine.all_reduce_time(bytes_per_chip, n) * 1e3
    except Exception:
        return None


# ------------------------------------------------------- flight recorder
def dump_flight_record(exc: Optional[BaseException] = None,
                       log: Optional[EventLog] = None,
                       out_dir: Optional[str] = None) -> Optional[str]:
    """Dump the crash flight record: the EventLog ring, the still-open
    spans and a metrics snapshot, as ``<out_dir>/flightrecorder_<ts>.json``
    through an atomic tmp + rename (JAX ``telemetry/fleet.py:355``).

    Best effort by contract: it runs inside the exception handling of a
    dying run, so it never raises — any failure (disk full, an
    unserializable attr) degrades to one stderr line and ``None``, and
    the caller re-raises the original exception.  ``out_dir`` defaults to
    ``$FF_FLIGHT_DIR`` or ``artifacts/``.  Returns the artifact's path, or
    None when nothing was written (telemetry off, or the write failed)."""
    log = log if log is not None else active_log()
    if log is None:
        return None
    try:
        from .trace import open_span_records

        try:
            from .metrics import REGISTRY
            metrics_text = REGISTRY.render()
        except Exception:
            metrics_text = None
        ts = time.time()
        stamp = getattr(log, "stamp", None)
        doc = {
            "kind": "flightrecorder",
            "schema_version": 1,
            "ts": ts,
            "exception": (None if exc is None else
                          {"type": type(exc).__name__,
                           "message": str(exc)}),
            "stamp": stamp,
            "events": log.events(),
            "open_spans": open_span_records(),
            "metrics": metrics_text,
        }
        out_dir = out_dir or os.environ.get("FF_FLIGHT_DIR") or "artifacts"
        os.makedirs(out_dir, exist_ok=True)
        stem = f"{FLIGHT_PREFIX}{int(ts * 1000)}"
        if stamp and "pidx" in stamp:
            stem += f"_p{int(stamp['pidx']):03d}"
        final = os.path.join(out_dir, stem + ".json")
        k = 0
        while os.path.exists(final):  # same-ms re-dump: don't clobber
            k += 1
            final = os.path.join(out_dir, f"{stem}-{k}.json")
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        return final
    except Exception as e:  # never mask the exception being handled
        print(f"# flight recorder dump failed: {e!r}", file=sys.stderr)
        return None


def find_flight_records(directory: str = "artifacts") -> List[str]:
    """Flight-recorder artifacts in ``directory``, newest first.  The
    ``flightrecorder_*.json`` glob can never match an in-flight
    ``.tmp``, so a partially-written dump is never picked up."""
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith(FLIGHT_PREFIX) and n.endswith(".json")]
    except OSError:
        return []
    return [os.path.join(directory, n) for n in sorted(names,
                                                       reverse=True)]


def load_flight_record(path: str) -> Dict[str, Any]:
    """Parse one flight-recorder artifact.  Refuses ``.tmp`` paths (a
    partial write is not a record) and non-flightrecorder JSON."""
    if path.endswith(".tmp"):
        raise ValueError(
            f"{path!r} is a partial flight-recorder write (.tmp) — "
            f"the atomic rename never happened; refusing to parse it")
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("kind") != "flightrecorder":
        raise ValueError(f"{path!r} is not a flight-recorder artifact")
    return doc


def render_flight(doc: Dict[str, Any], last_s: float = 5.0,
                  max_events: int = 20) -> List[str]:
    """The ``report --flight`` text: what the run died of, which spans
    were still open, and the last seconds of the ring before death."""
    lines = ["== flight record =="]
    exc = doc.get("exception")
    if exc:
        lines.append(f"died: {exc.get('type', '?')}: "
                     f"{exc.get('message', '')}")
    stamp = doc.get("stamp")
    if stamp:
        lines.append(f"process: p{int(stamp.get('pidx', 0)):03d} "
                     f"(slice {stamp.get('slice', '?')})")
    events = doc.get("events") or []
    by: Counter = Counter(e.get("type", "?") for e in events)
    lines.append(f"ring: {len(events)} event(s)"
                 + (" (" + ", ".join(f"{n} {t}"
                                     for t, n in sorted(by.items()))
                    + ")" if by else ""))
    spans = doc.get("open_spans") or []
    if spans:
        lines.append(f"open spans at death ({len(spans)}):")
        for sp in sorted(spans, key=lambda s: -s.get("age_us", 0.0)):
            lines.append(f"  {sp.get('name', '?')} "
                         f"(open {sp.get('age_us', 0.0) / 1e6:.3f} s, "
                         f"thread {sp.get('thread', '?')})")
    t_death = float(doc.get("ts") or (events[-1]["ts"] if events else 0.0))
    tail = [e for e in events
            if t_death - float(e.get("ts", 0.0)) <= last_s][-max_events:]
    if tail:
        lines.append(f"last {last_s:.1f} s before death:")
        for e in tail:
            dt = t_death - float(e.get("ts", 0.0))
            detail = " ".join(
                f"{k}={e[k]}" for k in ("kind", "phase", "step", "action",
                                        "name", "loss") if k in e)
            lines.append(f"  t-{dt:7.3f}s  {e.get('type', '?'):<11}"
                         f" {detail}".rstrip())
    return lines
