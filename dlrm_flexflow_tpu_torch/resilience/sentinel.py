"""NaN/Inf sentinel: detect a blown-up dispatch, roll back, recover
(counterpart of ``dlrm_flexflow_tpu/resilience/sentinel.py``).

A single NaN batch (a bad record, an overflow after an lr bump) poisons
every parameter it touches; without a guard the run keeps training on
garbage.  The sentinel checks the loss of every dispatch on the host —
and optionally the updated parameters themselves (``check_params=True``,
catching finite-loss / NaN-grad corruption the loss cannot see) — and
on anomaly tells the training loop to REJECT the dispatch: the
pre-dispatch state (still live — the resilient loop steps with
``donate=False`` while a sentinel is armed) is kept, and per ``policy``
the batch is skipped or the learning rate is backed off and the batch
retried.  Total rollbacks are bounded by ``max_rollbacks``; past it
:class:`TrainingDiverged` is raised.

The resilient loop runs this check at lag 1: step k's loss is read on the
host while step k+1 is already in flight, so a rejection also discards
that speculative step, and the adopted trajectory stays bit-identical to
an eager check.  Every rejection emits an ``anomaly`` telemetry event.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..telemetry import emit
from ..telemetry import metrics as _tmetrics


class TrainingDiverged(RuntimeError):
    """More anomalous dispatches than ``max_rollbacks`` allows."""


class NaNSentinel:
    """``policy``: ``"skip"`` drops the offending batch and moves on;
    ``"lr_backoff"`` multiplies the learning rate by ``lr_factor`` and
    retries the same batch.  ``check_params=True`` additionally verifies
    that every float parameter of the post-dispatch state is finite: one
    ``isfinite().all()`` reduction per tensor on its device, stacked, and
    one host read."""

    def __init__(self, policy: str = "skip", max_rollbacks: int = 3,
                 lr_factor: float = 0.5, check_params: bool = False):
        if policy not in ("skip", "lr_backoff"):
            raise ValueError(
                f"policy must be 'skip'|'lr_backoff', got {policy!r}")
        self.policy = policy
        self.max_rollbacks = int(max_rollbacks)
        self.lr_factor = float(lr_factor)
        self.check_params = bool(check_params)
        self.rollbacks = 0

    # --------------------------------------------------------------- checks
    def _params_finite(self, state) -> bool:
        flags = [torch.isfinite(x).all() for d in state.params.values()
                 for x in d.values() if x.is_floating_point()]
        if not flags:
            return True
        return bool(torch.stack(flags).all())

    def classify(self, loss, new_state=None) -> Optional[str]:
        """The anomaly kind of one dispatch result, or None when clean."""
        loss = float(loss)
        if math.isnan(loss):
            return "nan_loss"
        if math.isinf(loss):
            return "inf_loss"
        if self.check_params and new_state is not None \
                and not self._params_finite(new_state):
            return "nonfinite_params"
        return None

    # -------------------------------------------------------------- verdict
    def observe(self, loss, new_state=None, step: Optional[int] = None,
                lr: Optional[float] = None) -> bool:
        """True = adopt the dispatch.  False = REJECT: the caller keeps
        its pre-dispatch state and applies :attr:`policy` (the sentinel
        has already counted the rollback and emitted the ``anomaly``
        event).  Raises :class:`TrainingDiverged` past the budget."""
        kind = self.classify(loss, new_state)
        if kind is None:
            return True
        self.rollbacks += 1
        _tmetrics.SENTINEL_ROLLBACKS.inc()
        action = ("rollback_skip" if self.policy == "skip"
                  else "rollback_lr_backoff")
        emit("anomaly", kind=kind, step=step, action=action,
             rollbacks=self.rollbacks, policy=self.policy,
             loss=float(loss), lr=lr)
        if self.rollbacks > self.max_rollbacks:
            raise TrainingDiverged(
                f"{self.rollbacks} anomalous dispatches exceed "
                f"max_rollbacks={self.max_rollbacks} (last: {kind} at "
                f"step {step})")
        return False
