"""Transport-free cores of the dense FLASHE round (port of
flashe_tpu/protocol/aggregator.py).

    client_upload   -- Client.secure_aggregate, dense branch: scale by the
                       degree, normalize, quantize, encrypt;
    arbiter_reduce  -- Arbiter._reduce: the mod-2^m sum of the ciphertexts;
    client_download -- Client.get_aggregated_model: decrypt over the
                       survivors' idx list, unquantize with the number of
                       summands, divide by the degree, unnormalize.

A client `block` is anything with a FlasheCipher as `.cipher` and a
QuantizingClient as `.quantizer` (see ClientBlock).  The federation
transport, uuid and DH syncs, the seed wrap and the sparse paths are not
ported yet: in this slice the clients share a seed through
FlasheCipher.generate_prp_seed(assigned_seed=...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops.lanes import as_u32, lane_add, nlimbs_for, to_i32
from flashe_tpu_torch.quant.quantizer import QuantizingClient

__all__ = ["ClientBlock", "Upload", "client_upload", "arbiter_reduce",
           "client_download"]


@dataclass
class ClientBlock:
    cipher: FlasheCipher
    quantizer: QuantizingClient


class Upload(NamedTuple):
    lanes: torch.Tensor  # ciphertext lanes
    n_elements: int
    degree: float
    idx_list: list


def client_upload(block, codec: WeightsCodec, flat: torch.Tensor,
                  iter_index: int, degree=None,
                  uniforms: torch.Tensor | None = None) -> Upload:
    """One client's dense upload.  `uniforms` feeds the stochastic rounding
    (drawn from the quantizer's generator when None)."""
    if degree:
        flat = flat * degree
    else:
        degree = 1.0
    block.cipher.set_iter_index(iter_index)
    block.quantizer.set_iter(iter_index)
    q = block.quantizer.quantize(block.quantizer.normalize(flat),
                                 uniforms=uniforms)
    return Upload(block.cipher.encrypt(q), codec.total, degree,
                  block.cipher.get_idx_list())


def arbiter_reduce(lanes_list, int_bits: int) -> torch.Tensor:
    """Sum of the clients' ciphertexts mod 2^int_bits, as int32 lanes: the
    sum runs in int64 and is masked and cast back."""
    if nlimbs_for(int_bits) > 1:
        acc = lanes_list[0]
        for a in lanes_list[1:]:
            acc = lane_add(acc, a, int_bits)
        return acc
    acc = as_u32(lanes_list[0])
    for a in lanes_list[1:]:
        acc += as_u32(a)
    return to_i32(acc & ((1 << int_bits) - 1))


def client_download(block, lanes: torch.Tensor, idx_list, n_elements: int,
                    degrees: float, degree=None) -> torch.Tensor:
    """Decrypt the aggregate of the clients in idx_list and decode it into
    the new global flat vector.  degrees is the survivors' total degree,
    degree this client's own (1.0 when None)."""
    degree = degree or 1.0
    lanes = block.cipher.decrypt(lanes, idx_list)
    n_summed = len(idx_list) if idx_list else None
    flat = block.quantizer.unquantize(lanes, n_elements, n_summed)
    flat = flat / (degrees / degree)
    flat = block.quantizer.unnormalize(flat)
    return flat / degree
