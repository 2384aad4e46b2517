"""reference python/flexflow/keras/callbacks.py."""

from ...frontends.keras_callbacks import (Callback, EpochVerifyMetrics,
                                          LearningRateScheduler,
                                          ModelCheckpoint, VerifyMetrics)

__all__ = ["Callback", "LearningRateScheduler", "ModelCheckpoint",
           "VerifyMetrics", "EpochVerifyMetrics"]
