"""The device an entry point runs on: the card unless the caller names
another, and an error when there is no card."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, ``"cuda"`` when it is
    ``None``; raises without a CUDA device unless the CPU is asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return dev
