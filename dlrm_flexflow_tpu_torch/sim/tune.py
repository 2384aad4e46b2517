"""Closed-loop SOAP tuning: telemetry-calibrated search with gated
strategy promotion (counterpart of ``dlrm_flexflow_tpu/sim/tune.py``).

  1. **ingest** — a run's ``op_time`` telemetry (each op's measured wall
     on the card next to the analytic simulator's prediction,
     ``profiling.OpTimer``) is read back from its EventLog JSONL sink;
  2. **recalibrate** — per-op-CLASS correction factors are fitted so
     the analytic H100 cost model tracks the measured times
     (:func:`fit_calibration` -> :class:`Calibration`, persisted as a
     schema-checked ``calibration_vNNNN.json``);
  3. **re-search** — ``mcmc_search`` runs again under the recalibrated
     simulator (``CostModel(calibration=...)``);
  4. **emit** — the winning per-op ``ParallelConfig`` set lands as a
     versioned, schema-checked strategy artifact with its provenance
     (source telemetry file, calibration artifact, simulated step time,
     parent version);
  5. **gate** — the candidate is benched against the incumbent and
     promoted only when the regress comparator (``telemetry/regress.py``)
     passes; the verdict is one ``search`` ``phase="promote"`` event and
     the incumbent pointer (``strategy_incumbent_<app>_<n>dev.json``, one
     per topology) moves atomically.

Every phase emits ``search``/``calibration`` telemetry, the report CLI
renders it as the ``== tuning ==`` section, and ``/metrics`` exposes the
simulator-accuracy and strategy-freshness gauges
(``dlrm_sim_calibration_error_pct``, ``dlrm_strategy_age_s``,
``dlrm_strategy_version``).  The artifacts' field tables and the fit are
the JAX module's (pure Python on the same floats), so an artifact either
package wrote loads and validates in the other, and the same telemetry
fits the same scales.  Driver: ``tools/search_tune.py``.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..parallel.parallel_config import ParallelConfig, Strategy
from ..telemetry import emit

#: artifact schema versions (bumped on incompatible layout changes;
#: loaders refuse unknown versions instead of misreading them)
CALIBRATION_SCHEMA_VERSION = 1
STRATEGY_SCHEMA_VERSION = 1

#: the one-line-protocol metric name the promotion gate compares under —
#: ``_ms``-suffixed so telemetry/regress.py::lower_is_better gates it
#: UPWARD (a slower candidate regresses)
TUNE_METRIC = "dlrm_tune_step_ms"

#: calibration artifact: field -> declared type (the JAX package's, so
#: an artifact either package wrote validates alike in both)
CALIBRATION_FIELDS: Dict[str, type] = {
    "schema": int,        # CALIBRATION_SCHEMA_VERSION
    "kind": str,          # "calibration"
    "version": int,       # artifact version (next free vNNNN in the dir)
    "fitted_ts": float,   # time.time() of the fit
    "source": str,        # telemetry JSONL the fit ingested
    "ops": int,           # op_time samples the fit used
    "scales": dict,       # op class -> [forward_scale, backward_scale]
    "mae_pct_before": float,  # mean abs relative error, raw analytic
    "mae_pct_after": float,   # same error under the fitted scales
}

#: strategy artifact: field -> declared type
STRATEGY_FIELDS: Dict[str, type] = {
    "schema": int,        # STRATEGY_SCHEMA_VERSION
    "kind": str,          # "strategy"
    "version": int,       # monotone per artifacts dir
    "created_ts": float,  # time.time() at emission
    "app": str,           # workload the search ran over
    "num_devices": int,   # device count the strategy targets
    "sim_step_s": float,  # the winning strategy's simulated step time
    "strategy": dict,     # {"ops": [{"name", "dims", ...}]} — the same
                          # shape Strategy.save writes
    "provenance": dict,   # PROVENANCE_FIELDS
}

#: strategy ``provenance`` sub-object: field -> declared type.
#: ``telemetry``/``calibration`` may be None (a search run without a
#: recorded run to calibrate from); ``parent_version`` is None for the
#: first version in a lineage.
PROVENANCE_FIELDS: Dict[str, type] = {
    "telemetry": str,        # source op_time JSONL (or null)
    "calibration": str,      # calibration artifact path (or null)
    "parent_version": int,   # incumbent version at search time (or null)
    "seed": int,             # MCMC seed
    "budget": int,           # MCMC iteration budget
    "mae_pct_before": float,  # calibration error before the fit
    "mae_pct_after": float,   # and after — the recalibration's win
}
_NULLABLE_PROVENANCE = ("telemetry", "calibration", "parent_version")

_ARTIFACT_RE = {
    "calibration": re.compile(r"calibration_v(\d+)\.json$"),
    "strategy": re.compile(r"strategy_v(\d+)\.json$"),
}


# ------------------------------------------------------------- calibration
@dataclass
class Calibration:
    """Per-op-class multiplicative correction of the analytic cost model,
    fitted from a run's measured-vs-predicted ``op_time`` telemetry.

    ``scales`` maps an op CLASS name (``type(op).__name__`` — Linear,
    RaggedStackedEmbedding, ...) to ``(forward_scale, backward_scale)``
    multipliers on the analytic estimate.  Classes absent from the fit
    keep scale 1.0 (the raw roofline)."""

    scales: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    source: Optional[str] = None
    fitted_ts: float = 0.0
    ops: int = 0
    mae_pct_before: float = 0.0
    mae_pct_after: float = 0.0

    def scale_for(self, op) -> Tuple[float, float]:
        return self.scales.get(type(op).__name__, (1.0, 1.0))

    def to_json(self, version: int = 0) -> dict:
        return {
            "schema": CALIBRATION_SCHEMA_VERSION,
            "kind": "calibration",
            "version": int(version),
            "fitted_ts": float(self.fitted_ts),
            "source": self.source,
            "ops": int(self.ops),
            "scales": {k: [float(f), float(b)]
                       for k, (f, b) in sorted(self.scales.items())},
            "mae_pct_before": float(self.mae_pct_before),
            "mae_pct_after": float(self.mae_pct_after),
        }

    @staticmethod
    def from_json(doc: dict) -> "Calibration":
        errs = validate_calibration_artifact(doc)
        if errs:
            raise ValueError("invalid calibration artifact: "
                             + "; ".join(errs))
        return Calibration(
            scales={k: (float(v[0]), float(v[1]))
                    for k, v in doc["scales"].items()},
            source=doc.get("source"),
            fitted_ts=float(doc["fitted_ts"]),
            ops=int(doc["ops"]),
            mae_pct_before=float(doc["mae_pct_before"]),
            mae_pct_after=float(doc["mae_pct_after"]))

    @staticmethod
    def load(path: str) -> "Calibration":
        with open(path) as f:
            return Calibration.from_json(json.load(f))


def _check_fields(doc: dict, fields: Dict[str, type], ctx: str,
                  nullable: Tuple[str, ...] = ()) -> List[str]:
    errs = []
    for name, decl in fields.items():
        if name not in doc:
            errs.append(f"{ctx}: missing field {name!r}")
            continue
        v = doc[name]
        if v is None and name in nullable:
            continue
        ok = (int, float) if decl is float else decl
        if isinstance(v, bool) or not isinstance(v, ok):
            errs.append(f"{ctx}.{name}: type {type(v).__name__}, "
                        f"want {decl.__name__}")
    for name in doc:
        if name not in fields:
            errs.append(f"{ctx}: unknown field {name!r} (artifact drift "
                        f"— update sim/tune.py and docs/tuning.md "
                        f"together)")
    return errs


def validate_calibration_artifact(doc: dict) -> List[str]:
    """Errors for one calibration artifact (empty list = valid)."""
    if not isinstance(doc, dict):
        return [f"calibration artifact is not a dict: "
                f"{type(doc).__name__}"]
    errs = _check_fields(doc, CALIBRATION_FIELDS, "calibration",
                         nullable=("source",))
    if doc.get("kind") not in (None, "calibration"):
        errs.append(f"calibration.kind is {doc['kind']!r}")
    if isinstance(doc.get("schema"), int) \
            and doc["schema"] != CALIBRATION_SCHEMA_VERSION:
        errs.append(f"calibration.schema {doc['schema']} unsupported "
                    f"(this build reads {CALIBRATION_SCHEMA_VERSION})")
    scales = doc.get("scales")
    if isinstance(scales, dict):  # a non-dict is already a named
        for k, v in scales.items():  # _check_fields type violation
            if (not isinstance(v, (list, tuple)) or len(v) != 2
                    or not all(isinstance(x, (int, float))
                               and not isinstance(x, bool) for x in v)):
                errs.append(f"calibration.scales[{k!r}]: want "
                            f"[forward_scale, backward_scale]")
    return errs


def validate_strategy_artifact(doc: dict) -> List[str]:
    """Errors for one strategy artifact (empty list = valid): field
    presence/types, provenance sub-object, and every op entry must
    parse as a ParallelConfig with a name."""
    if not isinstance(doc, dict):
        return [f"strategy artifact is not a dict: {type(doc).__name__}"]
    errs = _check_fields(doc, STRATEGY_FIELDS, "strategy")
    if doc.get("kind") not in (None, "strategy"):
        errs.append(f"strategy.kind is {doc['kind']!r}")
    if isinstance(doc.get("schema"), int) \
            and doc["schema"] != STRATEGY_SCHEMA_VERSION:
        errs.append(f"strategy.schema {doc['schema']} unsupported "
                    f"(this build reads {STRATEGY_SCHEMA_VERSION})")
    prov = doc.get("provenance")
    if isinstance(prov, dict):
        errs.extend(_check_fields(prov, PROVENANCE_FIELDS,
                                  "strategy.provenance",
                                  nullable=_NULLABLE_PROVENANCE))
    strat = doc.get("strategy")
    if isinstance(strat, dict):
        ops = strat.get("ops")
        if not isinstance(ops, list):
            errs.append("strategy.strategy.ops: want a list of op "
                        "configs")
        else:
            for i, op in enumerate(ops):
                if not isinstance(op, dict) or "name" not in op:
                    errs.append(f"strategy.strategy.ops[{i}]: missing "
                                f"op name")
                    continue
                try:
                    ParallelConfig.from_json(op)
                except (KeyError, TypeError, ValueError,
                        AssertionError) as e:
                    errs.append(f"strategy.strategy.ops[{i}] "
                                f"({op.get('name')!r}): not a "
                                f"ParallelConfig: {e!r}")
    return errs


def pair_op_times(events: List[dict],
                  class_of: Optional[Dict[str, str]] = None
                  ) -> List[dict]:
    """The fit's input: for each op whose NEWEST ``op_time`` event
    carries both the measured and the sim-predicted time, one pair dict
    ``{op, cls, fwd, sim_fwd, bwd?, sim_bwd?}``.  The newest event per
    op is selected FIRST — an op whose latest rerun dropped the sim
    prediction is excluded, never calibrated against its stale older
    pair.  ``class_of`` maps op name -> op class (``op_class_map``);
    ops it does not name come back with ``cls=None`` and the fit skips
    them: a correction keyed by a name the tuned model does not have
    could never be applied by :meth:`Calibration.scale_for`, so
    counting it would overstate the fit's accuracy."""
    from ..telemetry.report import latest_op_times

    latest = latest_op_times(events)
    pairs = []
    for name, e in sorted(latest.items()):
        if "sim_forward_s" not in e or not e.get("forward_s"):
            continue
        cls = class_of.get(name) if class_of is not None else name
        p = {"op": name, "cls": cls,
             "fwd": float(e["forward_s"]),
             "sim_fwd": float(e["sim_forward_s"])}
        if e.get("backward_s") and e.get("sim_backward_s") is not None:
            p["bwd"] = float(e["backward_s"])
            p["sim_bwd"] = float(e["sim_backward_s"])
        pairs.append(p)
    return pairs


def op_class_map(model) -> Dict[str, str]:
    """op name -> op class name for every layer of ``model`` — how the
    fit generalizes: a correction fitted on linear_3 applies to every
    Linear the simulator prices."""
    return {op.name: type(op).__name__ for op in model.layers}


def mean_abs_rel_error_pct(pairs: List[dict],
                           calibration: Optional[Calibration] = None
                           ) -> float:
    """Mean |sim - measured| / measured over every forward (and, when
    present, backward) sample, percent — THE simulator-accuracy number
    (acceptance: recalibration must strictly reduce it on the recorded
    run)."""
    scales = calibration.scales if calibration is not None else {}
    errs = []
    for p in pairs:
        sf, sb = scales.get(p["cls"], (1.0, 1.0))
        errs.append(abs(p["sim_fwd"] * sf - p["fwd"]) / p["fwd"])
        if "bwd" in p:
            errs.append(abs(p["sim_bwd"] * sb - p["bwd"]) / p["bwd"])
    if not errs:
        raise ValueError("no measured-vs-predicted op_time pairs")
    return 100.0 * sum(errs) / len(errs)


def _best_scale(meas: List[float], sims: List[float]) -> float:
    """The multiplier minimizing sum |s*sim - meas|/meas.  The objective
    is piecewise linear in ``s`` with kinks exactly at the per-sample
    ratios, so scanning the ratios (plus 1.0, so the fit can never be
    WORSE than no correction) finds the global minimum."""
    ratios = [m / s for m, s in zip(meas, sims) if s > 0]
    if not ratios:
        return 1.0
    cands = sorted(set(ratios + [1.0]))

    def err(s: float) -> float:
        return sum(abs(s * sim - m) / m for m, sim in zip(meas, sims))

    return min(cands, key=err)


def fit_calibration(events: List[dict], model,
                    source: Optional[str] = None) -> Calibration:
    """Fit per-op-class correction factors from a run's ``op_time``
    telemetry.  Only pairs naming ops of ``model`` participate — both
    in the fit AND in the before/after error, so the reported accuracy
    (and the ``dlrm_sim_calibration_error_pct`` gauge) describes
    exactly the correction the simulator will apply, never one keyed
    by names it can't look up.  Emits one ``calibration``
    ``phase="fit"`` event.  Raises ValueError when the events carry no
    measured-vs-predicted pairs for this model."""
    all_pairs = pair_op_times(events, op_class_map(model))
    pairs = [p for p in all_pairs if p["cls"] is not None]
    if not pairs:
        where = f" in {source}" if source else ""
        if all_pairs:
            raise ValueError(
                f"none of the {len(all_pairs)} measured-vs-predicted "
                f"op_time pairs{where} name ops of this model — the "
                f"telemetry was recorded from a different architecture")
        raise ValueError(
            f"no op_time events carrying sim predictions{where}"
            " — record a run with profiling.OpTimer under an active "
            "EventLog first")
    by_cls: Dict[str, List[dict]] = {}
    for p in pairs:
        by_cls.setdefault(p["cls"], []).append(p)
    scales: Dict[str, Tuple[float, float]] = {}
    for cls, ps in by_cls.items():
        sf = _best_scale([p["fwd"] for p in ps],
                         [p["sim_fwd"] for p in ps])
        bps = [p for p in ps if "bwd" in p]
        sb = _best_scale([p["bwd"] for p in bps],
                         [p["sim_bwd"] for p in bps]) if bps else sf
        scales[cls] = (sf, sb)
    cal = Calibration(scales=scales, source=source, fitted_ts=time.time(),
                      ops=len(pairs))
    cal.mae_pct_before = mean_abs_rel_error_pct(pairs)
    cal.mae_pct_after = mean_abs_rel_error_pct(pairs, cal)
    emit("calibration", phase="fit", source=source, ops=len(pairs),
         op_classes=len(scales),
         mae_pct_before=round(cal.mae_pct_before, 3),
         mae_pct_after=round(cal.mae_pct_after, 3))
    from ..telemetry.metrics import note_calibration

    note_calibration(cal.mae_pct_after)
    return cal


# ---------------------------------------------------------------- artifacts
def _atomic_write_json(path: str, doc: dict, exclusive: bool = False
                       ) -> None:
    """tmp + fsync + rename — a reader (the serving side's freshness
    poll, a concurrent report) never sees a torn artifact.  With
    ``exclusive`` the final name is claimed by ``os.link`` (atomic,
    fails if it exists) instead of ``os.replace`` — a concurrent
    writer racing for the same version number gets FileExistsError
    instead of silently destroying the other's artifact."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if not exclusive:
        os.replace(tmp, path)
        return
    try:
        os.link(tmp, path)
    finally:
        os.unlink(tmp)


def list_artifacts(artifacts_dir: str, kind: str) -> List[Tuple[int, str]]:
    """``(version, path)`` of every ``<kind>_vNNNN.json`` in the dir,
    ascending by version."""
    rx = _ARTIFACT_RE[kind]
    out = []
    for p in glob.glob(os.path.join(artifacts_dir, f"{kind}_v*.json")):
        mo = rx.search(os.path.basename(p))
        if mo:
            out.append((int(mo.group(1)), p))
    return sorted(out)


def next_version(artifacts_dir: str, kind: str) -> int:
    found = list_artifacts(artifacts_dir, kind)
    return (found[-1][0] + 1) if found else 1


def _claim_next_version(artifacts_dir: str, kind: str,
                        make_doc: Callable[[int], dict],
                        validate: Callable[[dict], List[str]],
                        attempts: int = 16) -> Tuple[str, dict]:
    """Allocate the next free version number race-free: the final name
    is created exclusively, so two concurrent tune runs that both saw
    the same newest version collide on the filename and the loser
    simply retries with the next number — never silently overwriting
    the winner's artifact (lineage stays monotone per directory)."""
    os.makedirs(artifacts_dir, exist_ok=True)
    for _ in range(attempts):
        version = next_version(artifacts_dir, kind)
        path = os.path.join(artifacts_dir,
                            f"{kind}_v{version:04d}.json")
        doc = make_doc(version)
        errs = validate(doc)
        if errs:  # a bug here must never persist a bad artifact
            raise ValueError(f"refusing to write invalid {kind} "
                             "artifact: " + "; ".join(errs))
        try:
            _atomic_write_json(path, doc, exclusive=True)
            return path, doc
        except FileExistsError:
            continue  # lost the race — rescan and take the next slot
    raise RuntimeError(
        f"could not allocate a {kind} artifact version in "
        f"{artifacts_dir} after {attempts} attempts")


def save_calibration_artifact(artifacts_dir: str,
                              cal: Calibration) -> str:
    path, doc = _claim_next_version(
        artifacts_dir, "calibration", cal.to_json,
        validate_calibration_artifact)
    emit("calibration", phase="persist", artifact=path, ops=cal.ops,
         op_classes=len(cal.scales))
    return path


def save_strategy_artifact(artifacts_dir: str, strategy: Strategy, *,
                           app: str, num_devices: int, sim_step_s: float,
                           seed: int, budget: int,
                           telemetry: Optional[str] = None,
                           calibration: Optional[str] = None,
                           parent_version: Optional[int] = None,
                           mae_pct_before: float = 0.0,
                           mae_pct_after: float = 0.0
                           ) -> Tuple[str, dict]:
    """Persist the search winner as the next ``strategy_vNNNN.json``;
    returns ``(path, doc)``.  The embedded strategy uses the same
    ``{"ops": [...]}`` shape ``Strategy.save`` writes, so the artifact
    doubles as a loadable strategy file."""
    def make_doc(version: int) -> dict:
        return {
            "schema": STRATEGY_SCHEMA_VERSION,
            "kind": "strategy",
            "version": version,
            "created_ts": time.time(),
            "app": app,
            "num_devices": int(num_devices),
            "sim_step_s": float(sim_step_s),
            "strategy": {"ops": [
                {"name": k, **v.to_json()}
                for k, v in sorted(strategy.configs.items())]},
            "provenance": {
                "telemetry": telemetry,
                "calibration": calibration,
                "parent_version": parent_version,
                "seed": int(seed),
                "budget": int(budget),
                "mae_pct_before": float(mae_pct_before),
                "mae_pct_after": float(mae_pct_after),
            },
        }

    return _claim_next_version(artifacts_dir, "strategy", make_doc,
                               validate_strategy_artifact)


def load_strategy_artifact(path: str) -> dict:
    """Parse + schema-check one strategy artifact; raises ValueError
    naming every violation (a half-written or drifted artifact must
    never silently steer a bench or a promotion)."""
    with open(path) as f:
        doc = json.load(f)
    errs = validate_strategy_artifact(doc)
    if errs:
        raise ValueError(f"{path}: invalid strategy artifact: "
                         + "; ".join(errs))
    return doc


def strategy_from_artifact(doc: dict) -> Strategy:
    s = Strategy()
    for op in doc["strategy"]["ops"]:
        s.configs[op["name"]] = ParallelConfig.from_json(op)
    return s


def incumbent_path(artifacts_dir: str, app: str,
                   num_devices: int, topology=None) -> str:
    """The incumbent pointer is TOPOLOGY-SCOPED — one pointer per
    (app, device count), so a tune run on a laptop mesh can never
    evict the production 8-chip incumbent without ever benching
    against it.  The scope key grows the SLICE shape when the tune
    ran under a multi-slice :class:`~.cost_model.PodTopology`
    (``..._2x4pod.json`` — docs/tuning.md): a strategy whose
    placements were chosen for one ICI/DCN hierarchy is priced wrong
    on another, so pod lineages never share a pointer with flat ones
    (single-slice topologies keep the legacy name unchanged)."""
    pod = ""
    if topology is not None and topology.num_slices > 1:
        pod = f"_{topology.num_slices}x{topology.chips_per_slice}pod"
    return os.path.join(
        artifacts_dir,
        f"strategy_incumbent_{app}_{int(num_devices)}dev{pod}.json")


def load_incumbent(artifacts_dir: str, app: str,
                   num_devices: int, topology=None) -> Optional[dict]:
    """The currently-promoted strategy artifact for this topology, or
    None before its first promotion."""
    p = incumbent_path(artifacts_dir, app, num_devices, topology)
    if not os.path.exists(p):
        return None
    return load_strategy_artifact(p)


def promote(artifacts_dir: str, doc: dict, topology=None) -> str:
    """Move the artifact's topology's incumbent pointer to ``doc`` (an
    atomic whole-artifact copy — the pointer file IS a valid strategy
    artifact, so consumers never chase a dangling path) and refresh
    the strategy-freshness gauges."""
    errs = validate_strategy_artifact(doc)
    if errs:
        raise ValueError("refusing to promote invalid strategy "
                         "artifact: " + "; ".join(errs))
    p = incumbent_path(artifacts_dir, doc["app"], doc["num_devices"],
                       topology)
    _atomic_write_json(p, doc)
    from ..telemetry.metrics import note_strategy_promotion

    note_strategy_promotion(doc["version"], ts=doc["created_ts"])
    return p


# --------------------------------------------------------------- promotion
def gate_candidate(candidate: dict, incumbent: Optional[dict],
                   bench_fn: Callable[[dict], float],
                   tolerance_pct: float = 5.0
                   ) -> Tuple[str, float, Optional[float]]:
    """Bench the candidate strategy against the incumbent under the
    regress comparator; returns ``(verdict, candidate_s,
    incumbent_s)``.

    ``bench_fn(artifact_doc) -> step seconds`` prices one strategy —
    a real fenced run, the calibrated simulator, or a test's
    doctored stand-in.  The CANDIDATE is priced first, so any residual
    process warmup a real bench has not amortized lands on the
    challenger — the bias penalizes the candidate, never the incumbent.
    Verdicts: ``"first"`` (no incumbent — promote by definition),
    ``"promoted"`` (faster, tied, or within ``tolerance_pct`` slower —
    the same allowance the regress gate grants any headline metric, so
    a deterministic re-run of the incumbent re-promotes instead of
    flapping), ``"rejected"`` (more than the tolerance slower; the
    incumbent stays).  Each decision is one ``search``
    ``phase="promote"`` telemetry event."""
    # the verdict names its topology (the candidate doc carries it) so
    # a shared append-mode sink can render one lineage PER topology —
    # an 8-device v1 and a 4-device v2 are parallel incumbents, never
    # one succession chain
    topo = {k: candidate[k] for k in ("app", "num_devices")
            if k in candidate}
    cand_s = float(bench_fn(candidate))
    if cand_s <= 0:
        raise ValueError(
            f"bench_fn priced candidate v{candidate.get('version')} at "
            f"{cand_s!r} s — a non-positive step time is a bench bug, "
            f"not a result the gate can compare")
    if incumbent is None:
        emit("search", phase="promote", verdict="first",
             version=candidate["version"], candidate_s=cand_s,
             tolerance_pct=float(tolerance_pct), metric=TUNE_METRIC,
             **topo)
        return "first", cand_s, None
    inc_s = float(bench_fn(incumbent))
    if inc_s <= 0:
        # regress.compare skips non-positive baselines, which would
        # FAIL OPEN (any candidate promoted over an unmeasurable
        # incumbent) — the gate fails closed instead
        raise ValueError(
            f"bench_fn priced incumbent v{incumbent.get('version')} at "
            f"{inc_s!r} s — refusing to gate against a non-positive "
            f"baseline (the regress comparator would skip it and "
            f"auto-promote)")
    from ..telemetry.regress import compare

    _rows, regressions = compare({TUNE_METRIC: inc_s * 1e3},
                                 {TUNE_METRIC: cand_s * 1e3},
                                 tolerance_pct)
    verdict = "rejected" if regressions else "promoted"
    emit("search", phase="promote", verdict=verdict,
         version=candidate["version"],
         incumbent_version=incumbent["version"],
         candidate_s=cand_s, incumbent_s=inc_s,
         tolerance_pct=float(tolerance_pct), metric=TUNE_METRIC,
         **topo)
    return verdict, cand_s, inc_s


def search_tune(model, num_devices: int, telemetry_path: str,
                artifacts_dir: str, *, app: str = "dlrm",
                budget: int = 300, seed: int = 0, alpha: float = 0.05,
                bench_fn: Optional[Callable[[dict], float]] = None,
                tolerance_pct: float = 5.0, topology=None) -> dict:
    """The closed loop, end to end: ingest -> recalibrate -> re-search
    -> versioned artifact -> gated promotion.  Returns a summary dict
    (what ``tools/search_tune.py`` prints as its one JSON line).

    ``bench_fn`` defaults to the RECALIBRATED simulator's step
    prediction — deterministic and card-free, so an incumbent found
    under a stale calibration can legitimately beat (and block) a new
    candidate once the cost model moves under it.  Pass a real fenced
    bench (``tools/search_tune.py --bench real``) to gate on the card
    instead.  The machine model is :class:`~.cost_model.H100MachineModel`.

    Incumbents are TOPOLOGY-SCOPED (one pointer per app + device
    count, :func:`incumbent_path`): a strategy for a different
    topology is never comparable (the simulator would silently fold
    its device ids modulo the new count and misprice it), so each
    topology runs its own lineage and gate — the first run on a new
    topology gates as ``"first"`` without touching any other
    topology's incumbent.  A hand-edited pointer whose content
    contradicts its own name is skipped the same way.

    ``topology`` (a :class:`~.cost_model.PodTopology`) runs the whole
    loop hierarchy-aware: the recalibrated simulator prices NVLink within
    a node and InfiniBand across nodes, the search proposes node-aware
    placements, and the
    incumbent pointer's scope key grows the slice shape
    (:func:`incumbent_path`) so pod and flat lineages never gate each
    other."""
    from ..telemetry.report import load_events
    from .cost_model import CostModel, H100MachineModel
    from .search import mcmc_search
    from .simulator import Simulator

    events = load_events(telemetry_path)
    cal = fit_calibration(events, model, source=telemetry_path)
    cal_path = save_calibration_artifact(artifacts_dir, cal)

    machine = (H100MachineModel(topology=topology)
               if topology is not None else None)
    cost = CostModel(machine=machine, calibration=cal)
    sim = Simulator(model, num_devices, cost_model=cost)
    best = mcmc_search(model, num_devices, budget=budget, alpha=alpha,
                       simulator=sim, seed=seed, backend="python",
                       topology=topology)
    sim_step_s = sim.simulate(best)

    incumbent = load_incumbent(artifacts_dir, app, num_devices, topology)
    path, doc = save_strategy_artifact(
        artifacts_dir, best, app=app, num_devices=num_devices,
        sim_step_s=sim_step_s, seed=seed, budget=budget,
        telemetry=telemetry_path, calibration=cal_path,
        parent_version=incumbent["version"] if incumbent else None,
        mae_pct_before=cal.mae_pct_before,
        mae_pct_after=cal.mae_pct_after)

    if bench_fn is None:
        def bench_fn(d: dict) -> float:
            return sim.simulate(strategy_from_artifact(d))

    comparable = (incumbent is not None
                  and incumbent["num_devices"] == int(num_devices)
                  and incumbent["app"] == app)
    verdict, cand_s, inc_s = gate_candidate(
        doc, incumbent if comparable else None, bench_fn,
        tolerance_pct=tolerance_pct)
    promoted = verdict in ("first", "promoted")
    if promoted:
        promote(artifacts_dir, doc, topology)
    return {
        "strategy_path": path,
        "calibration_path": cal_path,
        # the slice shape the loop ran under (None = flat) — provenance
        # for the tool's JSON line; the incumbent pointer name
        # carries the same scope (incumbent_path)
        "pod": (topology.to_json()
                if topology is not None and topology.num_slices > 1
                else None),
        "version": doc["version"],
        "parent_version": doc["provenance"]["parent_version"],
        "verdict": verdict,
        "promoted": promoted,
        "sim_step_s": sim_step_s,
        "candidate_s": cand_s,
        "incumbent_s": inc_s,
        "mae_pct_before": cal.mae_pct_before,
        "mae_pct_after": cal.mae_pct_after,
        "ops_calibrated": cal.ops,
    }


def example_calibration_artifact() -> dict:
    """A minimal valid calibration artifact (the tests validate it, so
    the field tables and the validator cannot drift apart)."""
    return Calibration(scales={"Linear": (1.5, 2.0)}, source="run.jsonl",
                       fitted_ts=1.0, ops=1, mae_pct_before=50.0,
                       mae_pct_after=5.0).to_json(version=1)


def example_strategy_artifact() -> dict:
    """A minimal valid strategy artifact (the same check)."""
    return {
        "schema": STRATEGY_SCHEMA_VERSION,
        "kind": "strategy",
        "version": 1,
        "created_ts": 1.0,
        "app": "dlrm",
        "num_devices": 8,
        "sim_step_s": 0.001,
        "strategy": {"ops": [{"name": "linear_1", "dims": [8, 1],
                              "device_type": "tpu",
                              "device_ids": list(range(8))}]},
        "provenance": {"telemetry": "run.jsonl",
                       "calibration": "calibration_v0001.json",
                       "parent_version": None, "seed": 0, "budget": 300,
                       "mae_pct_before": 50.0, "mae_pct_after": 5.0},
    }
