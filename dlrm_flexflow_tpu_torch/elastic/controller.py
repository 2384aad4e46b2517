"""Closing the elastic loop: live replica scaling and strategy re-gating
(counterpart of ``dlrm_flexflow_tpu/elastic/controller.py``, the same
verdicts and events).

``ReplicaRouter.scale_to``/``rebuild`` make the serving tier's replica
count a runtime variable; this module keeps the system honest across the
change: the SOAP strategy being served or tuned is **topology-scoped**
(``sim/tune.py`` keeps one incumbent pointer per (app, device count)),
so a fleet that reshapes must re-resolve which strategy it runs, never
keep the old topology's incumbent as if nothing happened.

:func:`regate_strategy` is that resolution, on ``sim/tune.py``'s
promotion machinery: the NEW topology's incumbent (if one was ever
promoted) wins; a caller-supplied candidate is gated against it through
``gate_candidate`` (verdicts ``first``/``promoted``/``rejected``) and
promoted on pass; with neither the verdict is ``none`` (the caller falls
back to the default data-parallel strategy and should tune the new
shape).  Every resolution emits one ``elastic`` ``phase="regate"``
event.

:class:`ElasticController` bundles both halves for a serving process:
``scale_to(n)`` resizes the router (no accepted request dropped) and
re-gates for the new replica count; ``rebuild(engines, num_devices=...)``
swaps the whole engine set (for example engines over a model recompiled
under a new mesh, the state re-placed by ``elastic.reshard_state``) and
re-gates for the new device count; ``heal()`` ejects dead replicas and
rebuilds capacity through ``scale_to``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..sim.tune import gate_candidate, load_incumbent, promote
from ..telemetry import emit


def regate_strategy(artifacts_dir: str, app: str, num_devices: int,
                    candidate: Optional[dict] = None,
                    bench_fn: Optional[Callable[[dict], float]] = None,
                    tolerance_pct: float = 5.0
                    ) -> "tuple[Optional[dict], str]":
    """Resolve which strategy artifact the (app, ``num_devices``)
    topology should run, re-gating through ``sim/tune.py``'s promotion
    machinery; returns ``(winning artifact doc or None, verdict)``.

    * no ``candidate``: the topology's own incumbent (verdict
      ``"incumbent"``), or None (verdict ``"none"`` — no strategy was
      ever promoted for this shape; serve the default, tune soon);
    * with ``candidate`` (a strategy artifact doc for THIS topology):
      ``gate_candidate`` benches it against the incumbent with
      ``bench_fn`` (required) and the winner is promoted/kept exactly
      as the tune loop would — verdict ``"first"`` / ``"promoted"`` /
      ``"rejected"``.  A candidate naming a different topology is a
      ValueError: gating it here would misprice it (the simulator folds
      device ids modulo the wrong count).

    Emits one ``elastic`` ``phase="regate"`` event carrying the
    verdict, topology, and winning version."""
    incumbent = load_incumbent(artifacts_dir, app, int(num_devices))
    if candidate is None:
        winner = incumbent
        verdict = "incumbent" if incumbent is not None else "none"
    else:
        if (candidate.get("app") != app
                or int(candidate.get("num_devices", -1))
                != int(num_devices)):
            raise ValueError(
                f"candidate strategy targets "
                f"({candidate.get('app')!r}, "
                f"{candidate.get('num_devices')} devices) but the "
                f"topology being re-gated is ({app!r}, "
                f"{int(num_devices)} devices) — gate a candidate built "
                f"FOR the new topology")
        if bench_fn is None:
            raise ValueError(
                "re-gating a candidate needs a bench_fn (the tune "
                "loop's recalibrated simulator, or a real fenced "
                "bench) — gate_candidate cannot price it otherwise")
        verdict, _cand_s, _inc_s = gate_candidate(
            candidate, incumbent, bench_fn, tolerance_pct=tolerance_pct)
        if verdict in ("first", "promoted"):
            promote(artifacts_dir, candidate)
            winner = candidate
        else:
            winner = incumbent
    ev: Dict[str, Any] = dict(phase="regate", verdict=verdict, app=app,
                              num_devices=int(num_devices))
    if winner is not None:
        ev["version"] = int(winner["version"])
    emit("elastic", **ev)
    return winner, verdict


class ElasticController:
    """One serving process's elastic control plane: a
    :class:`~..serving.ReplicaRouter` plus the artifacts directory its
    strategies live in.  Scaling and strategy resolution move TOGETHER
    — a resize is not done until the topology-scoped incumbent question
    is re-answered (``self.strategy`` holds the current answer;
    ``self.verdicts`` the regate history).

    ``artifacts_dir=None`` runs scaling without strategy management
    (the regate step is skipped and ``self.strategy`` stays None)."""

    def __init__(self, router, artifacts_dir: Optional[str] = None,
                 app: str = "dlrm"):
        self.router = router
        self.artifacts_dir = artifacts_dir
        self.app = str(app)
        self.strategy: Optional[dict] = None
        self.verdicts: List[str] = []
        # scale/regate may be driven from a control thread while the
        # serving threads (or another controller caller) read the
        # current strategy — the resolution state is lock-guarded
        self._lock = threading.Lock()
        if artifacts_dir is not None:
            # resolve the CURRENT topology's strategy at attach time —
            # the controller never starts out serving an unexamined one
            # (regate records the winner on self.strategy itself)
            self.regate(num_devices=len(router))

    def regate(self, num_devices: int, candidate: Optional[dict] = None,
               bench_fn: Optional[Callable[[dict], float]] = None,
               tolerance_pct: float = 5.0) -> Optional[dict]:
        """:func:`regate_strategy` against this controller's artifacts
        dir/app; records the winner on ``self.strategy`` and the
        verdict on ``self.verdicts``.  No-op (returns None, no event)
        without an artifacts dir."""
        if self.artifacts_dir is None:
            return None
        winner, verdict = regate_strategy(
            self.artifacts_dir, self.app, num_devices,
            candidate=candidate, bench_fn=bench_fn,
            tolerance_pct=tolerance_pct)
        with self._lock:
            self.strategy = winner
            self.verdicts.append(verdict)
        return winner

    def scale_to(self, n: int, engines: Optional[Sequence] = None,
                 candidate: Optional[dict] = None,
                 bench_fn: Optional[Callable[[dict], float]] = None,
                 tolerance_pct: float = 5.0) -> Dict[str, Any]:
        """Resize the router to ``n`` replicas (zero accepted requests
        dropped — ``ReplicaRouter.scale_to``) then re-gate the
        incumbent strategy for the new topology.  Returns the resize
        dict with the regate ``verdict``/winner folded in."""
        result: Dict[str, Any] = dict(self.router.scale_to(
            n, engines=engines))
        result["strategy"] = self.regate(num_devices=n,
                                         candidate=candidate,
                                         bench_fn=bench_fn,
                                         tolerance_pct=tolerance_pct)
        return result

    def rebuild(self, engines: Sequence,
                num_devices: Optional[int] = None,
                candidate: Optional[dict] = None,
                bench_fn: Optional[Callable[[dict], float]] = None,
                tolerance_pct: float = 5.0) -> Dict[str, Any]:
        """Swap the router's whole engine set (``ReplicaRouter.rebuild``
        — engines typically recompiled under a new mesh with state
        re-placed by ``elastic.reshard_state``) then re-gate for
        ``num_devices`` (default: the new replica count)."""
        result: Dict[str, Any] = dict(self.router.rebuild(engines))
        n = len(engines) if num_devices is None else int(num_devices)
        result["strategy"] = self.regate(num_devices=n,
                                         candidate=candidate,
                                         bench_fn=bench_fn,
                                         tolerance_pct=tolerance_pct)
        return result

    def heal(self, target_replicas: Optional[int] = None,
             max_engine_failures: Optional[int] = None,
             engines: Optional[Sequence] = None) -> Dict[str, Any]:
        """One self-healing pass (docs/serving.md): run the router's
        health probe (``ReplicaRouter.check_health`` — dead-dispatcher
        and, with ``max_engine_failures``, circuit-breaker ejection),
        then, when ejections dropped the live count below
        ``target_replicas``, rebuild capacity through :meth:`scale_to`
        (regate included — replacement replicas never serve an
        unexamined strategy).  Returns ``{"ejected": [labels],
        "rebuilt": scale dict or None}``.  Without ``target_replicas``
        it only ejects — survivors carry the load.  When EVERY replica
        died, rebuilding needs ``engines=`` (there is no live engine
        left to clone)."""
        ejected = self.router.check_health(
            max_engine_failures=max_engine_failures)
        rebuilt: Optional[Dict[str, Any]] = None
        if (ejected and target_replicas is not None
                and len(self.router) < int(target_replicas)):
            if len(self.router) == 0 and not engines:
                raise ValueError(
                    "heal() ejected every replica and has no engines= "
                    "to rebuild from — pass fresh engines (e.g. "
                    "recompiled under the surviving topology)")
            rebuilt = self.scale_to(int(target_replicas),
                                    engines=engines)
        return {"ejected": ejected, "rebuilt": rebuilt}

    def close(self, **kwargs) -> Dict[str, Any]:
        return self.router.close(**kwargs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.router.close()
        return False
