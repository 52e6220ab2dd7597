"""Transport-free cores of the secure-aggregation round (port of
flashe_tpu/protocol/aggregator.py), for the FLASHE and Paillier schemes.

    client_upload   -- Client.secure_aggregate, dense branch: scale by the
                       degree, normalize, quantize, encrypt;
    client_select   -- its sparse branch up to the arbiter's round trip:
                       scale, delta from the last global model, top-s%
                       selection, the encoded locations to send;
    client_upload_sparse -- the rest of it: install the arbiter's masking
                       broadcast, normalize and quantize the compacted
                       values at their locations, encrypt, append the
                       plaintext quantized zero;
    arbiter_reduce  -- Arbiter._reduce: the mod-2^m sum of FLASHE
                       ciphertexts (sparse uploads first densified with
                       each client's filler), or a Paillier arbiter block's
                       add_ciphertexts (the product mod n^2);
    client_download -- Client.get_aggregated_model: decrypt (FLASHE over the
                       survivors' idx list), unquantize with the number of
                       summands, divide by the degree, unnormalize, and
                       after a sparse round add the last global model back.

The sparse upload is two calls because the dynamic masking choice needs
every client's locations before any client encrypts: between them the
arbiter decides (protocol/blocks/flashe.py::arbiter_masking).

A client `block` has a `scheme`, a quantizer as `.quantizer`, and
set_iter_index / encrypt / decrypt / get_idx_list: ClientBlock wraps a
FlasheCipher and a QuantizingClient, and
protocol/blocks/paillier.py holds the Paillier blocks.  The federation
transport, uuid and DH syncs and the key and seed wraps are not ported
yet: in this slice FLASHE clients share a seed through
FlasheCipher.generate_prp_seed(assigned_seed=...), and Paillier sessions
are keyed in-process by blocks.paillier.make_session.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops.lanes import as_u32, lane_add, nlimbs_for, to_i32
from flashe_tpu_torch.protocol.blocks.flashe import client_masking
from flashe_tpu_torch.protocol.sparsify import (
    Sparsifier, SparsifyResult, encode_locations)
from flashe_tpu_torch.quant.quantizer import QuantizingClient

__all__ = ["ClientBlock", "Upload", "Selection", "client_upload",
           "client_select", "client_upload_sparse", "arbiter_reduce",
           "client_download"]


@dataclass
class ClientBlock:
    cipher: FlasheCipher
    quantizer: QuantizingClient
    scheme = "flashe"

    def set_iter_index(self, iter_index: int):
        self.cipher.set_iter_index(iter_index)
        self.quantizer.set_iter(iter_index)

    def encrypt(self, q: torch.Tensor) -> torch.Tensor:
        return self.cipher.encrypt(q)

    def decrypt(self, lanes: torch.Tensor, idx_list) -> torch.Tensor:
        return self.cipher.decrypt(lanes, idx_list)

    def get_idx_list(self):
        return self.cipher.get_idx_list()


class Upload(NamedTuple):
    lanes: object  # FLASHE ciphertext lanes, or Paillier's object ints
    n_elements: int
    degree: float
    idx_list: list
    locations: dict | None = None  # a sparse upload's encoded locations


class Selection(NamedTuple):
    result: SparsifyResult
    encoded: dict  # encode_locations of result.locations, for the arbiter
    degree: float


def client_upload(block, codec: WeightsCodec, flat: torch.Tensor,
                  iter_index: int, degree=None,
                  uniforms: torch.Tensor | None = None) -> Upload:
    """One client's dense upload.  `uniforms` feeds the stochastic rounding
    (drawn from the quantizer's generator when None)."""
    if degree:
        flat = flat * degree
    else:
        degree = 1.0
    block.set_iter_index(iter_index)
    q = block.quantizer.quantize(block.quantizer.normalize(flat),
                                 uniforms=uniforms)
    return Upload(block.encrypt(q), codec.total, degree,
                  block.get_idx_list())


def client_select(block, sparsifier: Sparsifier, flat: torch.Tensor,
                  before: torch.Tensor, degree=None) -> Selection:
    """A sparse upload up to the arbiter's round trip: scale by the degree,
    select the top-s% of the delta from `before` (the last global model)
    with the residual memory, and record the total in the cipher.  The
    selection's encoded locations go to the arbiter."""
    if degree:
        flat = flat * degree
    else:
        degree = 1.0
    res = sparsifier.sparsify(flat - before)
    block.cipher.total = res.total
    return Selection(res, encode_locations(res.locations, res.total), degree)


def client_upload_sparse(block, selection: Selection, broadcast: dict,
                         iter_index: int,
                         uniforms: torch.Tensor | None = None,
                         zero_u: float | None = None) -> Upload:
    """The rest of a sparse upload, once the arbiter's masking broadcast
    is in: install it, normalize and quantize the compacted values with
    their layers' scalars, encrypt them (one launch, compact counters from
    0) and append the plaintext quantized zero that fills the unselected
    positions.  `uniforms` and `zero_u` feed the two stochastic roundings
    (the quantizer's generator when None)."""
    res = selection.result
    block.set_iter_index(iter_index)
    client_masking(block.cipher, broadcast)
    quant = block.quantizer
    values = quant.normalize_gather(res.values, res.locations)
    q = quant.quantize_gather(values, res.locations, uniforms=uniforms)
    enc = block.encrypt(q)
    zero = torch.tensor([quant.quantized_zero(zero_u)], dtype=enc.dtype,
                        device=enc.device)
    return Upload(torch.cat([enc, zero]), int(res.locations.shape[0]),
                  selection.degree, block.get_idx_list(), selection.encoded)


def _densify(lanes: torch.Tensor, loc, total: int) -> torch.Tensor:
    """A sparse upload on the dense lanes: its filler everywhere, its
    ciphertexts at its locations."""
    dense = lanes[-1:].repeat(total)
    dense[torch.as_tensor(loc, dtype=torch.int64, device=lanes.device)] = \
        lanes[:-1]
    return dense


def arbiter_reduce(lanes_list, int_bits: int | None = None, block=None,
                   masks=None, total: int | None = None):
    """The aggregate of the clients' ciphertexts.  With a Paillier arbiter
    `block`, its add_ciphertexts; else the FLASHE sum mod 2^int_bits, as
    int32 lanes: the sum runs in int64 and is masked and cast back.  With
    `masks` (each upload's locations, in the uploads' order) the uploads
    are sparse: each is first expanded to `total` lanes on its device."""
    if block is not None:
        if masks is not None:
            raise NotImplementedError("sparse Paillier uploads are not "
                                      "ported yet")
        return block.add_ciphertexts(list(lanes_list))
    if masks is not None:
        lanes_list = [_densify(lanes, loc, total)
                      for lanes, loc in zip(lanes_list, masks)]
    if nlimbs_for(int_bits) > 1:
        acc = lanes_list[0]
        for a in lanes_list[1:]:
            acc = lane_add(acc, a, int_bits)
        return acc
    acc = as_u32(lanes_list[0])
    for a in lanes_list[1:]:
        acc += as_u32(a)
    return to_i32(acc & ((1 << int_bits) - 1))


def client_download(block, lanes, idx_list, n_elements: int,
                    degrees: float, degree=None,
                    before: torch.Tensor | None = None) -> torch.Tensor:
    """Decrypt the aggregate of the clients in idx_list and decode it into
    the new global flat vector.  degrees is the survivors' total degree,
    degree this client's own (1.0 when None).  A Paillier aggregate has no
    idx_list (None): it is decoded with the registered client count.
    After a sparse round n_elements is the total and `before`, the last
    global model, is added back to the decoded mean delta."""
    degree = degree or 1.0
    if block.scheme == "paillier":
        lanes = block.decrypt(lanes, n_elements)
    else:
        lanes = block.decrypt(lanes, idx_list)
    n_summed = len(idx_list) if idx_list else None
    flat = block.quantizer.unquantize(lanes, n_elements, n_summed)
    flat = flat / (degrees / degree)
    flat = block.quantizer.unnormalize(flat) / degree
    return flat if before is None else flat + before
