"""``from flexflow.core import *`` — the reference's main Python entry
(reference: python/flexflow/core/__init__.py re-exporting the cffi binding
and enum types), on the port (counterpart of ``flexflow/core/``)."""

from ..type import (ActiMode, AggrMode, DataType, LossType, MetricsType,
                    OpType, PoolType, enum_to_int, int_to_enum)
from .flexflow_binding import *  # noqa: F401,F403
from .flexflow_binding import __all__ as _binding_all

__all__ = list(_binding_all)
