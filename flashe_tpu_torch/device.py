"""Device selection shared by the port's constructors.

Every entry point of the port takes device="cuda" by default and resolves
it here, so it runs on the card unless the caller asks for the CPU
(device="cpu", as the tests do).  The multi-device entry points
(flashe_tpu_torch/parallel/) default to every visible card.

CAPTURE_LOCK keeps the trainer's CUDA graph captures apart from the work
of other threads that a capture breaks, or that breaks a capture: a wait
for the whole card (`synchronize`, a phase's synchronize), which cannot
wait for a stream being captured; the trainer's warm-up of a step it may
capture next; and building a model on the card (nn/models.py's
build_model and init_params), whose layers draw from the card's default
generator, which a capture holds (a draw from it in another thread raises
meanwhile).  Code that waits for the card calls `synchronize` here, not
torch.cuda.synchronize, and other such work runs through
`outside_captures`."""

from __future__ import annotations

import threading

import torch

__all__ = ["resolve_device", "resolve_devices", "visible_cards",
           "same_device", "CAPTURE_LOCK", "outside_captures",
           "synchronize"]

CAPTURE_LOCK = threading.Lock()


def outside_captures(fn, *args, **kwargs):
    """fn(*args, **kwargs), never while another thread captures a CUDA
    graph."""
    with CAPTURE_LOCK:
        return fn(*args, **kwargs)


def synchronize(device=None):
    """torch.cuda.synchronize(device), never while another thread captures
    a CUDA graph."""
    outside_captures(torch.cuda.synchronize, device)


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing CUDA where no card is present: the
    port never carries on on the CPU when asked for the card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but torch sees "
                           "no CUDA device")
    return device


def visible_cards() -> list:
    """Every CUDA device torch sees, as torch.devices; raises where there
    is none, as resolve_device does."""
    return [resolve_device(f"cuda:{i}")
            for i in range(max(torch.cuda.device_count(), 1))]


def resolve_devices(devices=None) -> list:
    """Each of `devices` resolved (a device may repeat), or every visible
    card where devices is None: the default of the multi-device entry
    points."""
    if devices is None:
        return visible_cards()
    return [resolve_device(d) for d in devices]


def same_device(a, b) -> bool:
    """True where a and b name one device ("cuda" is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (
        current if b.index is None else b.index)
