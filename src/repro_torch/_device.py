"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]
# what ``--device`` of the CLI, and so a fleet's replicas, take
DEVICE_KINDS = ("cuda", "cpu")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA on a machine without a
    usable GPU raises: the port never falls back to the CPU on its own,
    so a number measured "on the card" is always from the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev

