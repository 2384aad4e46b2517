"""Keras-compatible training callbacks (counterpart of
``dlrm_flexflow_tpu/frontends/keras_callbacks.py``; the reference's
``python/flexflow/keras/callbacks.py:21-90``), driven by the hook protocol
of ``FFModel.fit``.
"""

from __future__ import annotations

import numpy as np


class Callback:
    """The hooks ``fit`` calls; each does nothing here."""

    def __init__(self):
        self.model = None
        self.params = None

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


def _ffmodel_of(model):
    """The FFModel of ``model``: a keras-style model's ``ffmodel``, or
    ``model`` itself."""
    return getattr(model, "ffmodel", None) or model


class LearningRateScheduler(Callback):
    """Set the rate to ``schedule(epoch)`` at each epoch's start: it lands
    in the optimizer state's ``lr`` tensor, which a captured step reads by
    address, so no step is captured again."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        ff = _ffmodel_of(self.model)
        if not hasattr(ff.optimizer, "lr"):
            raise ValueError('Optimizer must have a "lr" attribute.')
        lr = self.schedule(epoch)
        if not isinstance(lr, (float, np.float32, np.float64)):
            raise ValueError('The output of the "schedule" function '
                             'should be float.')
        ff.schedule_learning_rate(lr)
        ff.optimizer.lr = float(lr)  # visible to introspection
        print("set learning rate ", lr)


def _target_value(accuracy) -> float:
    """A plain float, or an enum-like member's ``.value``."""
    return float(getattr(accuracy, "value", accuracy))


class VerifyMetrics(Callback):
    """Assert that the final training accuracy reaches the target."""

    def __init__(self, accuracy):
        super().__init__()
        self.accuracy = _target_value(accuracy)

    def on_train_end(self, logs=None):
        acc = _ffmodel_of(self.model).get_perf_metrics().get_accuracy()
        assert acc >= self.accuracy, (
            f"Accuracy is wrong: {acc:.2f} < {self.accuracy:.2f}")


class EpochVerifyMetrics(Callback):
    """Stop early once an epoch's accuracy reaches the target."""

    def __init__(self, accuracy, early_stop=True):
        super().__init__()
        self.accuracy = _target_value(accuracy)
        self.early_stop = early_stop

    def on_epoch_end(self, epoch, logs=None):
        if not self.early_stop:
            return False
        acc = _ffmodel_of(self.model).get_perf_metrics().get_accuracy()
        return acc >= self.accuracy


class ModelCheckpoint(Callback):
    """Save the whole training state every ``period`` epochs, and the
    final state at the end of training unless the last epoch's save wrote
    it, through ``checkpoint.save_checkpoint`` (npz), with the model's
    host-placed tables.  ``filepath`` may hold ``{epoch}``;
    ``checkpoint.restore_checkpoint`` reads it back."""

    def __init__(self, filepath: str, period: int = 1, verbose: bool = False):
        super().__init__()
        self.filepath = filepath
        self.period = max(1, int(period))
        self.verbose = verbose
        self.saved: list = []
        self._last_epoch = -1        # the last epoch that finished
        self._last_saved_epoch = -1  # the last epoch written

    def _state(self):
        ff = _ffmodel_of(self.model)
        state = getattr(ff, "_fit_state", None)
        if state is None:  # a keras-style model holds it after fit
            state = getattr(self.model, "state", None)
        return state

    def _save(self, epoch):
        from ..checkpoint import save_checkpoint
        state = self._state()
        if state is None:
            return
        path = self.filepath.format(epoch=epoch)
        # the model carries its hetero host tables into the checkpoint
        save_checkpoint(path, state, model=_ffmodel_of(self.model))
        self.saved.append(path)
        if self.verbose:
            print(f"checkpoint saved: {path}")

    def on_epoch_end(self, epoch, logs=None):
        self._last_epoch = epoch
        if (epoch + 1) % self.period == 0:
            self._save(epoch)
            self._last_saved_epoch = epoch

    def on_train_end(self, logs=None):
        if (self._last_epoch >= 0
                and self._last_saved_epoch != self._last_epoch):
            self._save(self._last_epoch)
            self._last_saved_epoch = self._last_epoch
