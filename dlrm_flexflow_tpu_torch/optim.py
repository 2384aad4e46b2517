"""Optimizers (counterpart of ``dlrm_flexflow_tpu/optim.py``).

SGD with the reference kernel's per-element math
(``optimizer_kernel.cu:23-43``):

    gt = g + lambda*w ; v = mu*v + gt ; next = nesterov ? gt + mu*v : v
    w -= lr * next

The learning rate and the step count live in the optimizer state, as in
the JAX package, so a schedule can change ``lr`` between steps.  Adam and
the row-lazy embedding updates wait for the optimizer and data slice
(ROADMAP.md Queue A).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

_LATER = ("is not ported yet: it comes with the optimizer and data slice "
          "in ROADMAP.md (Queue A)")


class Optimizer:
    def init(self, params) -> Any:
        raise NotImplementedError

    def update(self, params, grads, opt_state) -> Tuple[Any, Any]:
        raise NotImplementedError


def _device(params) -> torch.device:
    for d in params.values():
        for v in d.values():
            return v.device
    return torch.device("cpu")


class SGDOptimizer(Optimizer):
    """Plain SGD with optional momentum, nesterov and weight decay."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0,
                 lazy_embeddings: bool = False):
        if lazy_embeddings:
            raise NotImplementedError(
                f"SGDOptimizer(lazy_embeddings=True) {_LATER}")
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay
        self.lazy_embeddings = False

    def init(self, params) -> Dict[str, Any]:
        dev = _device(params)
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "lr": torch.tensor(self.lr, dtype=torch.float32,
                                    device=dev)}
        if self.momentum != 0.0:
            state["v"] = {op: {k: torch.zeros(w.shape, dtype=torch.float32,
                                              device=w.device)
                               for k, w in d.items()}
                          for op, d in params.items()}
        return state

    def update(self, params, grads, opt_state):
        """Apply one step to every parameter that ``grads`` names.

        The f32 parameters and the momentum buffers are updated IN PLACE
        (the caller's state is consumed, like the JAX package's donated
        step); returns ``(params, new opt_state)``."""
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
        return params, {**opt_state, "step": opt_state["step"] + 1}


class AdamOptimizer(Optimizer):
    """Adam waits for the optimizer and data slice; constructing it
    raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"AdamOptimizer {_LATER}")
