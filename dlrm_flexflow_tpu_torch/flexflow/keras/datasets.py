"""reference python/flexflow/keras/datasets/ — mnist / cifar10 / reuters.

The impl modules are shared objects (real ModuleType instances defined in
``dlrm_flexflow_tpu_torch.frontends.keras_datasets``), registered here
under this package's names so both reference idioms work and both paths
alias one namespace: ``from flexflow.keras.datasets import mnist`` and
``import flexflow.keras.datasets.mnist`` (``scope.use_port_flexflow``
maps the second name onto the registered module).
"""

import sys as _sys

from ...frontends.keras_datasets import cifar10, mnist, reuters

for _name, _mod in (("mnist", mnist), ("cifar10", cifar10),
                    ("reuters", reuters)):
    _sys.modules[f"{__name__}.{_name}"] = _mod

__all__ = ["mnist", "cifar10", "reuters"]
