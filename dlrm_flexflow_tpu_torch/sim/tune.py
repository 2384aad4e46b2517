"""The strategy-artifact validator of the JAX package's closed-loop
tuning (counterpart of ``dlrm_flexflow_tpu/sim/tune.py``, that part
only): ``Strategy.load`` reads a search-tune strategy artifact through
it.  The loop itself (calibration fits from ``op_time`` telemetry,
re-search, the promotion gate) needs the telemetry reports and comes
with them (ROADMAP.md item 6).

The field tables are the JAX module's, so an artifact either package
wrote validates alike in both.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..parallel.parallel_config import ParallelConfig

#: the artifact schema version this build reads (an unknown one is
#: refused, never misread)
STRATEGY_SCHEMA_VERSION = 1

#: strategy artifact: field -> declared type
STRATEGY_FIELDS: Dict[str, type] = {
    "schema": int,        # STRATEGY_SCHEMA_VERSION
    "kind": str,          # "strategy"
    "version": int,       # monotone per artifacts dir
    "created_ts": float,  # time.time() at emission
    "app": str,           # workload the search ran over
    "num_devices": int,   # device count the strategy targets
    "sim_step_s": float,  # the winning strategy's simulated step time
    "strategy": dict,     # {"ops": [{"name", "dims", ...}]}, the shape
                          # Strategy.save writes
    "provenance": dict,   # PROVENANCE_FIELDS
}

#: strategy ``provenance`` sub-object: field -> declared type;
#: ``telemetry``, ``calibration`` and ``parent_version`` may be None
PROVENANCE_FIELDS: Dict[str, type] = {
    "telemetry": str,        # source op_time JSONL (or null)
    "calibration": str,      # calibration artifact path (or null)
    "parent_version": int,   # incumbent version at search time (or null)
    "seed": int,             # MCMC seed
    "budget": int,           # MCMC iteration budget
    "mae_pct_before": float,  # calibration error before the fit
    "mae_pct_after": float,   # and after
}
_NULLABLE_PROVENANCE = ("telemetry", "calibration", "parent_version")


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


def validate_strategy_artifact(doc: dict) -> List[str]:
    """Errors for one strategy artifact (empty list = valid): field
    presence and types, the provenance sub-object, and every op entry
    must parse as a ParallelConfig with a name."""
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
