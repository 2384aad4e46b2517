"""reference keras ``optimizers.py`` (python/flexflow/keras/) — SGD /
Adam with keras argument names, implemented as the core optimizers."""

from ... import optim as _optim


class SGD(_optim.SGDOptimizer):
    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False,
                 name="SGD", **kwargs):
        super().__init__(lr=learning_rate, momentum=momentum,
                         nesterov=nesterov,
                         weight_decay=kwargs.get("weight_decay", 0.0))


class Adam(_optim.AdamOptimizer):
    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-07, amsgrad=False, **kwargs):
        assert not amsgrad, "amsgrad is not supported (nor in the reference)"
        super().__init__(lr=learning_rate, beta1=beta_1, beta2=beta_2,
                         epsilon=epsilon,
                         weight_decay=kwargs.get("weight_decay", 0.0))


Optimizer = _optim.Optimizer

__all__ = ["Optimizer", "SGD", "Adam"]
