"""Mod-2^m lane arithmetic on int32 tensors (port of flashe_tpu/ops/lanes.py).

A lane is an int32 tensor element holding a uint32 bit pattern: torch's
uint32 lacks the arithmetic the cipher needs, while int32 add and subtract
wrap mod 2^32, which is exact for any modulus 2^m with m <= 32.  Lanes wider
than 32 bits are little-endian limb vectors of shape (..., L); their carries
and borrows run in int64, where no intermediate wraps.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "nlimbs_for",
    "lane_mask",
    "lane_add",
    "lane_sub",
    "lanes_to_ints",
    "ints_to_lanes",
    "to_i32",
    "as_u32",
]

_U32 = 0xFFFFFFFF


def nlimbs_for(int_bits: int) -> int:
    return (int_bits + 31) // 32


def _i32(v: int) -> int:
    """uint32 value -> the int32 with the same bit pattern."""
    return v - (1 << 32) if v >= 1 << 31 else v


def lane_mask(int_bits: int) -> torch.Tensor:
    """Per-limb AND mask as an (L,) int32 tensor of uint32 bit patterns."""
    nl = nlimbs_for(int_bits)
    top_bits = int_bits - 32 * (nl - 1)
    top = (1 << top_bits) - 1
    return torch.tensor([_i32(_U32)] * (nl - 1) + [_i32(top)],
                        dtype=torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values, as int64."""
    return x.to(torch.int64) & _U32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 bit patterns of their low 32 bits."""
    x = x & _U32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def lane_add(a: torch.Tensor, b: torch.Tensor, int_bits: int) -> torch.Tensor:
    """(a + b) mod 2^int_bits, elementwise over lanes."""
    nl = nlimbs_for(int_bits)
    if nl == 1:
        return (a.to(torch.int32) + b.to(torch.int32)) & _i32(
            (1 << int_bits) - 1)
    out = []
    carry = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for l in range(nl):
        s = as_u32(a[..., l]) + as_u32(b[..., l]) + carry
        out.append(to_i32(s))
        carry = s >> 32
    return torch.stack(out, dim=-1) & lane_mask(int_bits).to(a.device)


def lane_sub(a: torch.Tensor, b: torch.Tensor, int_bits: int) -> torch.Tensor:
    """(a - b) mod 2^int_bits, elementwise over lanes."""
    nl = nlimbs_for(int_bits)
    if nl == 1:
        return (a.to(torch.int32) - b.to(torch.int32)) & _i32(
            (1 << int_bits) - 1)
    out = []
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for l in range(nl):
        s = as_u32(a[..., l]) - as_u32(b[..., l]) - borrow
        out.append(to_i32(s))
        borrow = (s < 0).to(torch.int64)
    return torch.stack(out, dim=-1) & lane_mask(int_bits).to(a.device)


# ---------------------------------------------------------------------------
# Host-side conversions to/from python big ints (tests, wire compat)
# ---------------------------------------------------------------------------

def lanes_to_ints(lanes, int_bits: int) -> np.ndarray:
    """int32 lane/limb tensor (or uint32 array) -> object-dtype python ints."""
    if isinstance(lanes, torch.Tensor):
        lanes = lanes.cpu().numpy()
    lanes = np.asarray(lanes).astype(np.int64) & _U32
    if nlimbs_for(int_bits) == 1:
        return lanes.astype(object)
    out = np.zeros(lanes.shape[:-1], dtype=object)
    for l in range(lanes.shape[-1]):
        out |= lanes[..., l].astype(object) << (32 * l)
    return out


def ints_to_lanes(ints, int_bits: int) -> torch.Tensor:
    """object-dtype python ints -> int32 lane/limb tensor (CPU)."""
    ints = np.asarray(ints, dtype=object)
    nl = nlimbs_for(int_bits)
    flat = [int(v) for v in ints.ravel()]
    limbs = np.array([[_i32((v >> (32 * l)) & _U32) for l in range(nl)]
                      for v in flat], dtype=np.int32).reshape(ints.shape
                                                              + (nl,))
    out = torch.from_numpy(limbs)
    return out[..., 0] if nl == 1 else out
