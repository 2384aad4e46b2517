"""Where the port's entry points run.

Every entry point (``FFModel.init``, ``FFModel.load_params``,
``InferenceEngine``) takes ``device=None``, which means the CUDA card.
Without one they raise: the port never falls back to the CPU on its own.
Tests and CPU tools ask for the CPU with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {dev}: the port runs on the card unless "
            "the caller passes device='cpu'")
    return dev
