"""Loss functions (counterpart of ``dlrm_flexflow_tpu/losses.py``).

Each loss is a scalar-valued function whose autograd gradient is the
reference's backward kernel, including its ``1/batch`` scaling:
  sparse-CCE grad: (softmax(logits) - onehot) / batch
  CCE grad       : (probs - labels) / batch
  MSE grad       : 2 (pred - label) / batch
which are the mean over the batch of the sum over classes (CE) and the
mean over the batch of the sum over features (squared error).
"""

from __future__ import annotations

import torch

LOSS_FUNCTIONS = {}


def _register(name):
    def deco(f):
        LOSS_FUNCTIONS[name] = f
        return f
    return deco


def _class_labels(labels, ndim):
    if labels.dim() == ndim:
        labels = labels.squeeze(-1)
    return labels.long()


@_register("sparse_categorical_crossentropy")
def sparse_categorical_crossentropy(probs, labels):
    """``labels`` int (batch,) or (batch, 1); ``probs`` are softmax
    outputs."""
    labels = _class_labels(labels, probs.dim())
    picked = torch.gather(probs, -1, labels[..., None])[..., 0]
    return -torch.mean(torch.log(picked + 1e-12))


@_register("sparse_categorical_crossentropy_from_logits")
def sparse_categorical_crossentropy_from_logits(logits, labels):
    """The stable fused softmax + CCE for graphs ending in raw logits."""
    labels = _class_labels(labels, logits.dim())
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - picked)


@_register("categorical_crossentropy")
def categorical_crossentropy(probs, labels):
    """Dense labels, probabilities already softmaxed."""
    ce = -torch.sum(labels * torch.log(probs + 1e-12), dim=-1)
    return torch.mean(ce)


@_register("categorical_crossentropy_from_logits")
def categorical_crossentropy_from_logits(logits, labels):
    ce = -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)
    return torch.mean(ce)


@_register("mean_squared_error")
def mean_squared_error(preds, labels):
    """Mean over the batch of the sum over features of the squared error
    (the reference gradient 2*(y-t)/batch per element), NOT the mean
    over all elements."""
    se = torch.sum(torch.square(preds - labels),
                   dim=tuple(range(1, preds.dim())))
    return torch.mean(se)


@_register("mean_squared_error_sum_reduce")
def mean_squared_error_sum_reduce(preds, labels):
    """Sum over the batch (scale factor 1, not 1/batch): the reference's
    LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE."""
    se = torch.sum(torch.square(preds - labels),
                   dim=tuple(range(1, preds.dim())))
    return torch.sum(se)


# aliases matching the reference LossType spellings
LOSS_FUNCTIONS["sparse_crossentropy"] = sparse_categorical_crossentropy
LOSS_FUNCTIONS["crossentropy"] = categorical_crossentropy
LOSS_FUNCTIONS["mse"] = mean_squared_error


def get_loss(name):
    if callable(name):
        return name
    if name not in LOSS_FUNCTIONS:
        raise ValueError(
            f"unknown loss {name!r}; have {sorted(LOSS_FUNCTIONS)}")
    return LOSS_FUNCTIONS[name]
