"""Training metrics (counterpart of ``dlrm_flexflow_tpu/metrics.py``).

``compute_metrics`` returns one batch's sums (not means) plus the sample
count ``train_all``, as 0-dim tensors on the batch's device, so a run
folds them without a host sync per step.  ``MetricsAccumulator`` is the
host-side running aggregate with the reference's printed report.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

import torch


def _class_labels(labels, ndim):
    if labels.dim() == ndim:
        labels = labels.squeeze(-1)
    return labels.long()


def compute_metrics(preds, labels, metrics: Sequence[str],
                    loss_type: str) -> Dict[str, torch.Tensor]:
    """One batch's PerfMetrics: sums plus the sample count."""
    # a fill, not torch.tensor: a host-to-device copy would sync the step
    out = {"train_all": torch.full((), float(preds.shape[0]),
                                   dtype=torch.float32,
                                   device=preds.device)}
    sparse = "sparse" in loss_type
    for m in metrics:
        if m == "accuracy":
            if sparse:
                correct = (torch.argmax(preds, dim=-1)
                           == _class_labels(labels, preds.dim()))
            elif preds.shape[-1] == 1:
                # binary accuracy at 0.5 (the DLRM sigmoid output with
                # MSE, as the reference's dlrm.cc trains it)
                correct = ((preds > 0.5) == (labels > 0.5)).squeeze(-1)
            else:
                correct = (torch.argmax(preds, dim=-1)
                           == torch.argmax(labels, dim=-1))
            out["train_correct"] = torch.sum(correct.float())
        elif m in ("categorical_crossentropy", "cce"):
            out["cce"] = torch.sum(-labels * torch.log(preds + 1e-12))
        elif m in ("sparse_categorical_crossentropy", "sparse_cce"):
            lab = _class_labels(labels, preds.dim())
            logp = torch.log(torch.gather(preds, -1, lab[..., None])
                             + 1e-12)
            out["sparse_cce"] = -torch.sum(logp)
        elif m in ("mean_squared_error", "mse", "root_mean_squared_error",
                   "rmse"):
            out["mse"] = torch.sum(torch.square(preds - labels))
        elif m in ("mean_absolute_error", "mae"):
            out["mae"] = torch.sum(torch.abs(preds - labels))
    return out


@dataclass
class MetricsAccumulator:
    """Host-side running aggregate with the reference's report."""

    metrics: Sequence[str] = ()
    totals: Dict[str, float] = field(default_factory=dict)

    def reset(self):
        self.totals = {}

    def update(self, batch_metrics: Dict[str, torch.Tensor]):
        # accumulate on the device (a float() here would sync every step)
        for k, v in batch_metrics.items():
            self.totals[k] = self.totals.get(k, 0.0) + v

    def _finalized(self):
        """Host-sync the totals; returns (totals, normalizer)."""
        self.totals = {k: float(v) for k, v in self.totals.items()}
        return self.totals, max(self.totals.get("train_all", 0.0), 1.0)

    def report(self) -> str:
        _, n = self._finalized()
        parts = []
        if "train_correct" in self.totals:
            parts.append(
                f"accuracy: {100.0 * self.totals['train_correct'] / n:.2f}% "
                f"({int(self.totals['train_correct'])} / {int(n)})")
        if "cce" in self.totals:
            parts.append(f"cce_loss: {self.totals['cce'] / n:.3f}")
        if "sparse_cce" in self.totals:
            parts.append(
                f"sparse_cce_loss: {self.totals['sparse_cce'] / n:.3f}")
        if "mse" in self.totals:
            parts.append(f"mse_loss: {self.totals['mse'] / n:.3f}")
            if ("root_mean_squared_error" in self.metrics
                    or "rmse" in self.metrics):
                parts.append(
                    f"rmse_loss: {(self.totals['mse'] / n) ** 0.5:.3f}")
        if "mae" in self.totals:
            parts.append(f"mae_loss: {self.totals['mae'] / n:.3f}")
        return "[Metrics] " + " ".join(parts) if parts else "[Metrics] (none)"

    def finalized_means(self) -> Dict[str, float]:
        """Per-sample means of the sums, plus the raw ``train_all``."""
        totals, n = self._finalized()
        return {k: (v if k == "train_all" else v / n)
                for k, v in totals.items()}

    def get_accuracy(self) -> float:
        """Training accuracy in percent."""
        totals, n = self._finalized()
        return 100.0 * totals.get("train_correct", 0.0) / n
