"""Perf-regression gate over bench artifacts.

The counterpart of ``dlrm_flexflow_tpu/telemetry/regress.py``.

    python -m dlrm_flexflow_tpu_torch.telemetry regress \\
        --baseline bench_history.json --new BENCH_r06.json --tolerance 5

Diffs the HEADLINE metrics two bench artifacts share — wall-clock
throughput (samples/s or requests/s), busy-equivalent throughput
(samples per device-busy second, the queue-lottery-proof number
PERF.md trusts), MFU, the host-overhead share of the wall
(``:host_overhead_pct`` — docs/pipeline.md; gates a host-path
regression that an unchanged busy number would hide), and the serving
tail-latency headline (``dlrm_serving_p99_ms``) — and exits nonzero
naming each metric that regressed more than ``tolerance`` percent.
Wall and busy gate side by side: both rows must hold.  Throughput
metrics regress DOWNWARD; latency/overhead metrics
(``*_ms``/``*_us``/percentile/overhead/stall names,
:func:`lower_is_better`) regress UPWARD.

Accepted file shapes (auto-detected):

* ``bench_history.json`` — the append-only list ``bench.py`` maintains;
  the NEWEST fenced entry per metric anchors (derived busy/MFU metrics
  ride along when the entry carries ``device_busy_ms`` / ``mfu_pct``);
* ``BENCH_rNN.json`` — a per-round bench record with a ``parsed``
  one-line-protocol object;
* a bare ``{"metric": ..., "value": ...}`` protocol line saved as JSON.

GPU entries anchor apart from TPU ones: an entry (history entry or
protocol line) with a ``device`` field, the card's name as ``nvidia-smi``
gives it, is keyed ``<metric>:device=<name>`` after every other
qualifier, so an H100 number never gates against a TPU one or the
reverse.  An entry without the field is from the TPU era and keeps
exactly the JAX package's key, so every bench file written before the
port loads to the same metrics in both packages.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple


def _history_metric_name(entry: dict) -> str:
    """The one-line-protocol metric name a history entry was emitted
    under.  Newer entries carry it explicitly (``"metric"`` — bench.py
    records it for headlines beyond the app's historical one, e.g. the
    serving p99); older entries map from the app name (bench.py:
    main() vs bench_app() vs bench_serving())."""
    m = entry.get("metric")
    if m:
        return str(m)
    app = entry.get("app", "dlrm")
    if app == "dlrm":
        return "dlrm_synthetic_samples_per_sec"
    if app == "dlrm_serving":
        return "dlrm_serving_qps"
    return f"{app}_samples_per_sec"


def lower_is_better(name: str) -> bool:
    """Latency-style headlines regress UPWARD: ``dlrm_serving_p99_ms``
    and friends gate on the new value RISING past tolerance, where the
    throughput metrics gate on falling.  Host-overhead/stall shares
    (``host_overhead_pct``, ``data_stall_pct`` — docs/pipeline.md) are
    likewise better when smaller, as are SLO burn rates
    (``dlrm_slo_burn_rate`` — docs/slo.md: a rising burn spends error
    budget faster).  Checked per ``:``-qualifier segment (names may
    carry suffixes like ``:quantize=int8``)."""
    for seg in name.lower().split(":"):
        if (seg.endswith("_ms") or seg.endswith("_us")
                or "latency" in seg or "_p99" in seg or "_p95" in seg
                or "_p50" in seg or "overhead" in seg or "stall" in seg
                or "burn_rate" in seg):
            return True
    return False


def _history_metrics(entries: List[dict]) -> Dict[str, float]:
    """Newest fenced value per metric (append order = chronology), plus
    the derived busy-equivalent and MFU metrics when the entry carries
    the provenance fields."""
    out: Dict[str, float] = {}
    for h in entries:
        if not isinstance(h, dict) or not h.get("value"):
            continue
        if not h.get("fenced"):
            continue  # pre-fence-fix methodology: never comparable
        name = _history_metric_name(h)
        # quantized serving entries anchor separately in bench.py's key
        # (numerics differ); keep them apart here too, or an int8 run
        # would gate against the newest f32 entry of the same metric
        q = h.get("quantize")
        if q and q != "off":
            name = f"{name}:quantize={q}"
        # overlapped-exchange entries anchor separately too (bench.py
        # keys "overlap" the same way): the microbatched pipeline
        # reorders collective reductions, so an overlapped run is
        # tolerance-equivalent — not bit-identical — to the serial
        # exchange and must never gate a serial baseline
        ov = h.get("overlap")
        if ov and ov != "off":
            name = f"{name}:overlap={ov}"
        # tiered-storage entries anchor separately as well (bench.py
        # keys "storage" the same way): a hot-cache run pays miss
        # stalls by design, so it must never gate the fully-resident
        # baseline — nor inherit its anchor (entries predating the
        # field count as resident)
        st = h.get("storage")
        if st and st != "resident":
            name = f"{name}:storage={st}"
        # per-bucket latency headlines likewise: the largest dispatched
        # bucket is load-dependent, and a bucket-8 p99 must never
        # anchor a bucket-64 run (bench.py keys the entry the same way)
        b = h.get("bucket")
        if b is not None:
            name = f"{name}:bucket={b}"
        # serving topology: an N-replica router run and a mesh-native
        # run measure different serving shapes — neither may gate
        # against the single-replica / single-device baseline (entries
        # predating the fields count as replicas=1, no mesh)
        r = h.get("replicas")
        if r is not None and int(r) != 1:
            name = f"{name}:replicas={r}"
        ms = h.get("mesh")
        if ms:
            name = f"{name}:mesh={ms}"
        # multi-host / pod entries anchor per physical topology too
        # (bench.py keys "hosts"/"slices" the same way): an N-host or
        # N-slice run's collectives ride different links, so it never
        # gates a single-host baseline (entries predating the fields
        # count as 1)
        hosts = h.get("hosts")
        if hosts is not None and int(hosts) != 1:
            name = f"{name}:hosts={hosts}"
        sl = h.get("slices")
        if sl is not None and int(sl) != 1:
            name = f"{name}:slices={sl}"
        name = _device_key(name, h)
        # later entries overwrite: the NEWEST anchors the gate.  Only
        # THIS entry's own derived riders are replaced — a plain-name
        # prefix sweep would also delete the ":quantize=..." anchors a
        # newer unquantized entry must never touch
        for suffix in ("", ":mfu_pct", ":busy_samples_per_s",
                       ":host_overhead_pct"):
            out.pop(name + suffix, None)
        out[name] = float(h["value"])
        if h.get("mfu_pct"):
            out[f"{name}:mfu_pct"] = float(h["mfu_pct"])
        busy_ms = h.get("device_busy_ms")
        if busy_ms and all(k in h for k in ("batch", "num_batches",
                                            "epochs")):
            samples = (int(h["batch"]) * int(h["num_batches"])
                       * int(h["epochs"]))
            out[f"{name}:busy_samples_per_s"] = samples / (busy_ms * 1e-3)
        # the host share of the wall rides next to the busy-equivalent
        # gate (lower is better): the wall headline is gated on its own
        # row, and this rider pins the host PATH — a host-side
        # regression cannot hide behind an unchanged busy number or an
        # anchor whose wall was measured in a noisier queue era
        if h.get("host_overhead_pct") is not None:
            out[f"{name}:host_overhead_pct"] = float(h["host_overhead_pct"])
    return out


def _device_key(name: str, entry: dict) -> str:
    """``name`` qualified by the entry's card (``:device=<name>``); an
    entry without a ``device`` field keeps ``name`` as it is."""
    dev = entry.get("device")
    return f"{name}:device={dev}" if dev else name


def load_metrics(path: str) -> Dict[str, float]:
    """{metric: value} from any accepted bench artifact shape."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        return _history_metrics(data)
    if isinstance(data, dict):
        parsed = data.get("parsed")
        if isinstance(parsed, dict) and "metric" in parsed:
            data = parsed
        if "metric" in data and "value" in data:
            return {_device_key(str(data["metric"]), data):
                    float(data["value"])}
    raise ValueError(
        f"{path!r}: not a recognized bench artifact (want a "
        f"bench_history.json list, a BENCH_rNN.json record with a "
        f"'parsed' object, or a one-line-protocol JSON object)")


def compare(base: Dict[str, float], new: Dict[str, float],
            tolerance_pct: float
            ) -> Tuple[List[Tuple[str, float, float, float]],
                       List[Tuple[str, float, float, float]]]:
    """(all shared rows, regressed rows) as (metric, base, new,
    delta_pct).  A throughput metric regresses when the new value is
    more than ``tolerance_pct`` percent BELOW the baseline; a latency
    metric (:func:`lower_is_better`) regresses when it rises more than
    ``tolerance_pct`` percent ABOVE it.  Improvements of any size
    pass."""
    rows, regressions = [], []
    for name in sorted(set(base) & set(new)):
        b, n = float(base[name]), float(new[name])
        if b <= 0:
            continue  # nothing to anchor against
        delta_pct = 100.0 * (n - b) / b
        row = (name, b, n, delta_pct)
        rows.append(row)
        if lower_is_better(name):
            if delta_pct > float(tolerance_pct):
                regressions.append(row)
        elif delta_pct < -float(tolerance_pct):
            regressions.append(row)
    return rows, regressions


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m dlrm_flexflow_tpu_torch.telemetry regress",
        description=__doc__.split("\n")[0])
    p.add_argument("--baseline", required=True,
                   help="bench_history.json or a BENCH_rNN.json")
    p.add_argument("--new", required=True, dest="new_path",
                   help="the fresh result to gate")
    p.add_argument("--tolerance", type=float, default=5.0,
                   help="allowed regression, percent (default 5)")
    args = p.parse_args(argv)
    try:
        base = load_metrics(args.baseline)
        new = load_metrics(args.new_path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"regress: ERROR loading inputs: {e}")
        return 2
    rows, regressions = compare(base, new, args.tolerance)
    if not rows:
        print(f"regress: ERROR: no shared metrics between "
              f"{args.baseline!r} ({sorted(base) or 'none'}) and "
              f"{args.new_path!r} ({sorted(new) or 'none'})")
        return 2
    for name, b, n, d in rows:
        print(f"regress: {name}: baseline {b:,.2f} -> new {n:,.2f} "
              f"({d:+.2f}%)")
    for name, b, n, d in regressions:
        print(f"regress: REGRESSION {name}: {n:,.2f} is {-d:.2f}% below "
              f"baseline {b:,.2f} (tolerance {args.tolerance:.1f}%)")
    if regressions:
        return 1
    print(f"regress: OK ({len(rows)} metric(s) within "
          f"{args.tolerance:.1f}% tolerance)")
    return 0
