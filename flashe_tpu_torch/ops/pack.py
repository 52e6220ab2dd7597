"""Wire bit-packing (port of flashe_tpu/ops/pack.py): lane arrays <-> byte
strings with no inflation.

Bits of element i occupy positions [B - (i+1)*int_bits, B - i*int_bits) of
a ceil(B/8)-byte big-endian string, B = n * int_bits: the byte
serialization of the reference's one big int a layer, element 0 most
significant.  The wire is host work: `pack_lanes` and `unpack_lanes` go
through the port's native packer (csrc/packing.cpp, built with g++ at first
use by flashe_tpu_torch/native.py) when it is available, as the JAX
package's go through native/packing.cpp.  The numpy path (`pack_lanes_np`,
`unpack_lanes_np`) is the plain version the native one is held against,
byte for byte, and the fallback where no compiler is at hand.  Only the
low int_bits bits of each element are packed, on either path.
"""

from __future__ import annotations

import numpy as np

from flashe_tpu_torch import native
from flashe_tpu_torch.ops.lanes import nlimbs_for

__all__ = ["pack_lanes", "unpack_lanes", "pack_lanes_np", "unpack_lanes_np",
           "packed_nbytes", "pack_ints_reference"]


def packed_nbytes(n: int, int_bits: int) -> int:
    return (n * int_bits + 7) // 8


def _lane_bits_msb_first(lanes: np.ndarray, int_bits: int) -> np.ndarray:
    """(n,) or (n, L) uint32 -> (n, int_bits) uint8 bit matrix, MSB first."""
    lanes = np.asarray(lanes, dtype=np.uint32)
    if nlimbs_for(int_bits) == 1:
        shifts = np.arange(int_bits - 1, -1, -1, dtype=np.uint32)
        return ((lanes.reshape(-1)[:, None] >> shifts) & 1).astype(np.uint8)
    # limb l holds bits [32l, 32(l+1)) counted from the LSB
    bits = np.empty((lanes.shape[0], int_bits), dtype=np.uint8)
    for b in range(int_bits):
        src = int_bits - 1 - b  # bit position from LSB for output column b
        bits[:, b] = (lanes[:, src >> 5] >> np.uint32(src & 31)) & 1
    return bits


def pack_lanes(lanes: np.ndarray, int_bits: int) -> bytes:
    """Lane array -> big-endian packed bytes (the reference's big-int
    layout)."""
    fast = native.pack_lanes(lanes, int_bits)
    return fast if fast is not None else pack_lanes_np(lanes, int_bits)


def unpack_lanes(data: bytes, n: int, int_bits: int) -> np.ndarray:
    """Packed bytes -> (n,) uint32 (or (n, L) limb) lane array."""
    fast = native.unpack_lanes(data, n, int_bits)
    return fast if fast is not None else unpack_lanes_np(data, n, int_bits)


def pack_lanes_np(lanes: np.ndarray, int_bits: int) -> bytes:
    """pack_lanes in numpy: the plain version."""
    bits = _lane_bits_msb_first(lanes, int_bits).reshape(-1)
    pad = (-bits.size) % 8
    if pad:
        bits = np.concatenate([np.zeros(pad, np.uint8), bits])
    return np.packbits(bits).tobytes()


def unpack_lanes_np(data: bytes, n: int, int_bits: int) -> np.ndarray:
    """unpack_lanes in numpy: the plain version."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    bits = bits[len(bits) - n * int_bits:].reshape(n, int_bits)
    nl = nlimbs_for(int_bits)
    if nl == 1:
        shifts = np.arange(int_bits - 1, -1, -1, dtype=np.uint32)
        return (bits.astype(np.uint32) << shifts).sum(axis=1, dtype=np.uint32)
    lanes = np.zeros((n, nl), dtype=np.uint32)
    for b in range(int_bits):
        src = int_bits - 1 - b
        lanes[:, src >> 5] |= bits[:, b].astype(np.uint32) << np.uint32(
            src & 31)
    return lanes


def pack_ints_reference(values, int_bits: int) -> int:
    """Reference-semantics packer: python big int, element 0 most
    significant (mirrors jzf_weights.py:45-84; used by tests as oracle)."""
    s = 0
    for v in values:
        s = (s << int_bits) | int(v)
    return s
