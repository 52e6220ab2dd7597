"""Device selection shared by the port's constructors."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing CUDA where no card is present: the
    port never carries on on the CPU when asked for the card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but torch sees "
                           "no CUDA device")
    return device
