"""Optimizers (counterpart of ``dlrm_flexflow_tpu/optim.py``).

The reference kernels' per-element math (``optimizer_kernel.cu``):

  SGD  (:23-43):
      gt = g + lambda*w ; v = mu*v + gt ; next = nesterov ? gt + mu*v : v
      w -= lr * next
  Adam (:134-199):
      m = b1*m + (1-b1)*gt ; v = b2*v + (1-b2)*gt^2
      w -= alpha_t * m / (sqrt(v) + eps),  alpha_t = lr*sqrt(1-b2^t)/(1-b1^t)

The learning rate and the step count live in the optimizer state, as in
the JAX package, so a schedule can change ``lr`` between steps; Adam's
``alpha_t`` is computed on the device from the ``step`` tensor, never
read on the host, so a captured step (``graphs.py``) stays valid.  The
momentum buffers and Adam's moments are f32 beside any table dtype.

``update`` writes the parameters, the slots and ``step`` IN PLACE (the
caller's state is consumed, like the JAX package's donated step): a
captured step reads them by address.

``lazy_embeddings=True`` keeps the row-sparse embedding path for
momentum, weight decay and Adam: ``lazy_slot_rows`` and
``lazy_weight_delta`` are the row-wise pieces that
``FFModel._lazy_update`` applies on touch (torch.optim.SparseAdam
semantics: an untouched row's slots do not decay and the row takes no
step).  Off (the default), those configurations take the dense table
gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


class Optimizer:
    weight_decay = 0.0

    def init(self, params) -> Any:
        raise NotImplementedError

    def update(self, params, grads, opt_state) -> Tuple[Any, Any]:
        raise NotImplementedError

    def lazy_row_gt(self, w, g):
        """The weight-decayed gradient rows both lazy pieces share."""
        return g.float() + self.weight_decay * w.float()


def _device(params) -> torch.device:
    for d in params.values():
        for v in d.values():
            return v.device
    return torch.device("cpu")


def _zeros_like_params(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """An f32 zero tensor of each parameter's shape, on its device."""
    return {op: {k: torch.zeros(w.shape, dtype=torch.float32,
                                device=w.device)
                 for k, w in d.items()}
            for op, d in params.items()}


def _base_state(params, lr) -> Dict[str, Any]:
    dev = _device(params)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "lr": torch.tensor(lr, dtype=torch.float32, device=dev)}


class SGDOptimizer(Optimizer):
    """Plain SGD with optional momentum, nesterov and weight decay.

    ``lazy_embeddings``: apply momentum and weight decay to embedding rows
    on touch (the JAX package's flag): a touched row's velocity decays and
    updates that step, an untouched row's does not."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0,
                 lazy_embeddings: bool = False):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay
        self.lazy_embeddings = lazy_embeddings

    def slot_names(self):
        """The optimizer tables that row-address like the parameter (the
        epoch row cache caches them with the same slots)."""
        return ("v",) if self.momentum != 0.0 else ()

    def lazy_slot_rows(self, w, g, slots, opt_state):
        """The new velocity rows of the touched rows ``w`` (``g`` summed
        over duplicate ids; ``slots`` maps a slot name to its current
        rows): ``{}`` without momentum."""
        if self.momentum == 0.0:
            return {}
        return {"v": self.momentum * slots["v"] + self.lazy_row_gt(w, g)}

    def lazy_weight_delta(self, w, g, slots, opt_state):
        """The rows' weight delta, from the slot rows AS STORED: the
        caller scatters ``lazy_slot_rows`` into the slot tables first and
        gathers ``slots`` again from them (JAX ``model.py:940-966``).  The
        non-nesterov delta is one multiply of stored values."""
        mu = self.momentum
        lr = opt_state.get("lr", self.lr)
        if mu == 0.0:
            return -(lr * self.lazy_row_gt(w, g))
        if self.nesterov:
            return -(lr * (self.lazy_row_gt(w, g) + mu * slots["v"]))
        return -(lr * slots["v"])

    def init(self, params) -> Dict[str, Any]:
        state = _base_state(params, self.lr)
        if self.momentum != 0.0:
            state["v"] = _zeros_like_params(params)
        return state

    def update(self, params, grads, opt_state):
        """Apply one step to every parameter that ``grads`` names, in
        place; returns ``(params, opt_state)``."""
        mu, wd = self.momentum, self.weight_decay
        lr = opt_state.get("lr", self.lr)
        with torch.no_grad():
            for op, gd in grads.items():
                for k, g in gd.items():
                    w = params[op][k]
                    # g + 0 * w is g for a finite w: skip two passes
                    gt = g.float() + wd * w.float() if wd else g.float()
                    if mu == 0.0:
                        w.sub_(lr * gt)
                        continue
                    v = opt_state["v"][op][k]
                    v.mul_(mu).add_(gt)
                    w.sub_(lr * (gt + mu * v if self.nesterov else v))
            opt_state["step"].add_(1)
        return params, opt_state


class AdamOptimizer(Optimizer):
    """Adam (``optimizer_kernel.cu:134-235``), with the bias-corrected
    rate computed on the device from the step count.

    ``lazy_embeddings``: update embedding rows' moments on touch only
    (torch.optim.SparseAdam semantics): an untouched row's ``m``/``v`` do
    not decay and the row takes no step."""

    def __init__(self, lr: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8, lazy_embeddings: bool = False):
        self.lr = lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon
        self.lazy_embeddings = lazy_embeddings

    def slot_names(self):
        return ("m", "v")

    def _alpha_t(self, lr, step):
        """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` at ``t = step + 1``, a
        0-dim f32 tensor on ``step``'s device."""
        tf = (step + 1).float()
        return lr * torch.sqrt(1.0 - self.beta2 ** tf) \
            / (1.0 - self.beta1 ** tf)

    def lazy_slot_rows(self, w, g, slots, opt_state):
        """SparseAdam's row moments (``g`` summed over duplicate ids)."""
        b1, b2 = self.beta1, self.beta2
        gt = self.lazy_row_gt(w, g)
        return {"m": b1 * slots["m"] + (1 - b1) * gt,
                "v": b2 * slots["v"] + (1 - b2) * torch.square(gt)}

    def lazy_weight_delta(self, w, g, slots, opt_state):
        """SparseAdam's row weight delta from the moments AS STORED (see
        ``SGDOptimizer.lazy_weight_delta``); the bias correction uses the
        global step count of ``opt_state`` before this step."""
        alpha = self._alpha_t(opt_state.get("lr", self.lr), opt_state["step"])
        return -(alpha * slots["m"] / (torch.sqrt(slots["v"]) + self.epsilon))

    def init(self, params) -> Dict[str, Any]:
        state = _base_state(params, self.lr)
        state["m"] = _zeros_like_params(params)
        state["v"] = _zeros_like_params(params)
        return state

    def update(self, params, grads, opt_state):
        """One Adam step for every parameter that ``grads`` names, the
        parameters, moments and step count in place; returns ``(params,
        opt_state)``."""
        b1, b2, wd, eps = (self.beta1, self.beta2, self.weight_decay,
                           self.epsilon)
        with torch.no_grad():
            alpha = self._alpha_t(opt_state.get("lr", self.lr),
                                 opt_state["step"])
            for op, gd in grads.items():
                for k, g in gd.items():
                    w = params[op][k]
                    m, v = opt_state["m"][op][k], opt_state["v"][op][k]
                    gt = g.float() + wd * w.float() if wd else g.float()
                    m.mul_(b1).add_((1 - b1) * gt)
                    v.mul_(b2).add_((1 - b2) * torch.square(gt))
                    # f32 math, the result in the parameter's dtype
                    w.sub_(alpha * m / (torch.sqrt(v) + eps))
            opt_state["step"].add_(1)
        return params, opt_state
