"""Quantization codec (port of flashe_tpu/ops/quantize.py, unbatched path).

For a layer clipped at +-alpha with element_bits = eb:

    q  = floor( (clip(x, -a, a) + a) * (2^eb - 1) / (2a) + u ),  u ~ U[0, 1)
    x' = q_sum * 2*(a*n) / ((2^eb - 1) * n) - a*n      # after summing n clients

The uniforms u are an argument: the JAX package draws them from threefry,
the port from a torch.Generator, and tests hand both the same numbers.
Quantized values are int32 lanes holding uint32 bit patterns.  batch_lanes /
unbatch_lanes (the batch=True packing) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from flashe_tpu_torch.ops.lanes import as_u32

__all__ = ["quantize_asym", "unquantize_asym", "true_to_two", "two_to_true"]


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
