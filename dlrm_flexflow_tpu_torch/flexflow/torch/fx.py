"""reference python/flexflow/torch/fx.py — ``torch_to_flexflow(model,
filename)`` serializes a traced torch module for later replay by
:class:`flexflow.torch.model.PyTorchModel`.

The reference writes a custom text op-list; here the module itself is
saved (torch.save) and re-traced at load, which round-trips strictly more
information (weights included).
"""

import torch
import torch.fx as _fx


def torch_to_flexflow(model, filename: str):
    # symbolic-trace first so an untraceable model fails at export time,
    # like the reference (fx.py:44-198 traces during export)
    _fx.symbolic_trace(model)
    torch.save(model, filename)
    return filename


__all__ = ["torch_to_flexflow"]
