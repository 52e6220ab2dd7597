"""Quantization codec (port of flashe_tpu/ops/quantize.py, unbatched path).

For a layer clipped at +-alpha with element_bits = eb:

    q  = floor( (clip(x, -a, a) + a) * (2^eb - 1) / (2a) + u ),  u ~ U[0, 1)
    x' = q_sum * 2*(a*n) / ((2^eb - 1) * n) - a*n      # after summing n clients

The uniforms u are an argument: the JAX package draws them from threefry,
the port from a torch.Generator, and tests hand both the same numbers.
Quantized values are int32 lanes holding uint32 bit patterns.

Batching mode (`batch=True`) packs `int_bits // (eb + factor)` quantized
elements into one int_bits-bit lane, element 0 most significant, with
factor = ceil(log2(num_clients)) padding bits per element so that client
sums never carry across fields.  `batch_lanes_np` and `unbatch_lanes_np` are
the same layout in numpy on uint32 arrays, bit for bit, for codecs that
work on the host (the Paillier wire path, whose plaintexts are python ints).
"""

from __future__ import annotations

import numpy as np
import torch

from flashe_tpu_torch.ops.lanes import as_u32, nlimbs_for, to_i32

__all__ = ["quantize_asym", "unquantize_asym", "batch_lanes", "unbatch_lanes",
           "batch_lanes_np", "unbatch_lanes_np", "true_to_two", "two_to_true"]


def quantize_asym(x: torch.Tensor, alpha, element_bits: int,
                  u: torch.Tensor) -> torch.Tensor:
    """Clip/offset/scale/stochastic-round -> int32 in [0, 2^eb - 1]."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    x = torch.clamp(x.to(torch.float32), -a, a) + a
    x = x * (float(np.float32((1 << element_bits) - 1)) / (2.0 * a))
    return torch.floor(x + u).to(torch.int32)


def unquantize_asym(q: torch.Tensor, alpha, element_bits: int,
                    num_clients: int) -> torch.Tensor:
    """Inverse after an n-client sum."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=q.device) \
        * num_clients
    scale = (2.0 * a) / (float(np.float32((1 << element_bits) - 1))
                         * num_clients)
    return as_u32(q).to(torch.float32) * scale - a


def true_to_two(v: torch.Tensor, int_bits: int) -> torch.Tensor:
    """Two's complement encode: v mod 2^b (int64 in and out)."""
    return torch.remainder(v.to(torch.int64), 1 << int_bits)


def two_to_true(v: torch.Tensor, int_bits: int) -> torch.Tensor:
    """Two's complement decode (int64 in and out)."""
    v = v.to(torch.int64)
    return torch.where(v < (1 << (int_bits - 1)), v, v - (1 << int_bits))


def _field_layout(int_bits: int, element_bits: int, factor: int):
    ebf = element_bits + factor
    if ebf > 32:
        raise ValueError("per-element field wider than 32 bits unsupported")
    bs = int_bits // ebf
    if bs < 1:
        raise ValueError("int_bits too small for element_bits + factor")
    return ebf, bs


def _field_offsets(bs: int, ebf: int, device):
    """Limb index and shift of each field: field j sits at bit offset
    (bs - 1 - j) * ebf, so element 0 is the most significant."""
    off = (bs - 1 - torch.arange(bs, device=device, dtype=torch.int64)) * ebf
    return off >> 5, off & 31


def batch_lanes(q: torch.Tensor, int_bits: int, element_bits: int,
                factor: int) -> torch.Tensor:
    """Pack quantized values into int_bits-bit lanes.

    q: (n,) int32 values < 2^(eb + factor).  Returns (nlanes,) int32 when
    int_bits <= 32, else (nlanes, L) int32 little-endian limbs; the padding
    fields of the last lane are zero.  A field that straddles two limbs
    puts its low bits in limb wi and its high bits in limb wi + 1.  The
    fields' bits are disjoint, so the limbs are sums of shifted fields,
    taken in int64.
    """
    ebf, bs = _field_layout(int_bits, element_bits, factor)
    n = q.shape[0]
    nlanes = -(-n // bs)
    nl = nlimbs_for(int_bits)
    qp = torch.zeros(nlanes * bs, dtype=torch.int64, device=q.device)
    qp[:n] = as_u32(q)
    qp = qp.reshape(nlanes, bs)
    wi, sh = _field_offsets(bs, ebf, q.device)
    limbs = torch.zeros(nlanes, nl + 1, dtype=torch.int64, device=q.device)
    limbs.index_add_(1, wi, (qp << sh) & 0xFFFFFFFF)
    limbs.index_add_(1, wi + 1, qp >> (32 - sh))
    out = to_i32(limbs[:, :nl])
    return out[:, 0] if nl == 1 else out


def unbatch_lanes(lanes: torch.Tensor, n: int, int_bits: int,
                  element_bits: int, factor: int) -> torch.Tensor:
    """Inverse of batch_lanes: (n,) int32 field values mod 2^(eb + factor)."""
    ebf, bs = _field_layout(int_bits, element_bits, factor)
    nl = nlimbs_for(int_bits)
    if nl == 1:
        lanes = lanes[:, None]
    nlanes = lanes.shape[0]
    wide = torch.zeros(nlanes, nl + 1, dtype=torch.int64, device=lanes.device)
    wide[:, :nl] = as_u32(lanes)
    wi, sh = _field_offsets(bs, ebf, lanes.device)
    # the high limb supplies at most 31 bits of a field: keep the shift
    # below 2^63
    v = (wide[:, wi] >> sh) | ((wide[:, wi + 1] & 0x7FFFFFFF) << (32 - sh))
    return to_i32(v & ((1 << ebf) - 1)).reshape(nlanes * bs)[:n]


def batch_lanes_np(q: np.ndarray, int_bits: int, element_bits: int,
                   factor: int) -> np.ndarray:
    """batch_lanes on the host: (n,) uint32 values -> (nlanes,) uint32
    lanes, or (nlanes, L) uint32 limbs above 32 bits, the same layout bit
    for bit."""
    ebf, bs = _field_layout(int_bits, element_bits, factor)
    q = np.asarray(q, np.uint32)
    n = q.shape[0]
    nlanes = -(-n // bs)
    qp = np.zeros((nlanes * bs,), np.uint32)
    qp[:n] = q
    qp = qp.reshape(nlanes, bs)
    nl = nlimbs_for(int_bits)
    limbs = [np.zeros((nlanes,), np.uint32) for _ in range(nl)]
    for j in range(bs):
        off = (bs - 1 - j) * ebf
        wi, sh = off >> 5, off & 31
        v = qp[:, j]
        limbs[wi] = limbs[wi] | (v << np.uint32(sh))
        if sh + ebf > 32 and wi + 1 < nl:
            limbs[wi + 1] = limbs[wi + 1] | (v >> np.uint32(32 - sh))
    if nl == 1:
        return limbs[0]
    return np.stack(limbs, axis=-1)


def unbatch_lanes_np(lanes: np.ndarray, n: int, int_bits: int,
                     element_bits: int, factor: int) -> np.ndarray:
    """unbatch_lanes on the host: (n,) uint32 field values mod
    2^(eb + factor)."""
    ebf, bs = _field_layout(int_bits, element_bits, factor)
    nl = nlimbs_for(int_bits)
    lanes = np.asarray(lanes, np.uint32)
    if nl == 1:
        lanes = lanes[:, None]
    nlanes = lanes.shape[0]
    fmask = np.uint32((1 << ebf) - 1) if ebf < 32 else np.uint32(0xFFFFFFFF)
    cols = []
    for j in range(bs):
        off = (bs - 1 - j) * ebf
        wi, sh = off >> 5, off & 31
        v = lanes[:, wi] >> np.uint32(sh)
        if sh + ebf > 32 and wi + 1 < nl:
            v = v | (lanes[:, wi + 1] << np.uint32(32 - sh))
        cols.append(v & fmask)
    out = np.stack(cols, axis=-1).reshape(nlanes * bs)
    return out[:n]
