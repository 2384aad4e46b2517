"""The reference FlexFlow Python API on the port (counterpart of
``flexflow/``).

Reference: python/flexflow/ (cffi binding flexflow_cbinding.py:564-875 and
the keras/torch/onnx frontends).  The same classes, enums and imperative
verbs as the JAX package's ``flexflow`` compat package, over
:mod:`dlrm_flexflow_tpu_torch`'s model: ``core`` (``from flexflow.core
import *``), ``keras``, ``torch`` and ``onnx``, module for module.  A
reference script runs on it unchanged through ``python -m
dlrm_flexflow_tpu_torch.flexflow script.py`` or inside
``use_port_flexflow()`` (``scope.py``), which map the name ``flexflow``
onto this subpackage.
"""

from . import type  # noqa: F401
from .scope import use_port_flexflow  # noqa: F401
