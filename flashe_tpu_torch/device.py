"""Device selection shared by the port's constructors.

Every entry point of the port takes device="cuda" by default and resolves
it here, so it runs on the card unless the caller asks for the CPU
(device="cpu", as the tests do)."""

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
