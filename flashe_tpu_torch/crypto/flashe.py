"""The FLASHE cipher (port of flashe_tpu/crypto/flashe.py::FlasheCipher).

A ciphertext is an int32 lane tensor holding uint32 bit patterns.  Client
idx encrypts q as (q + a_idx - a_{idx+1}) mod 2^m, where a_s is the AES-256
mask stream s of the current iteration; the sum of all clients' ciphertexts
telescopes to sum(q) + a_n - a_0, and the surviving clients' sum after a
dropout to the run-merged boundaries of `merge_idx_runs`.  Encrypt and
every decrypt boundary pair are one fused mask launch each
(flashe_tpu_torch/ops/flashe_mask.py): the CUDA kernel on the card, the
plain torch version on the CPU.

Not ported yet, and raising NotImplementedError: the single mask, the
sparse (compact-counter) decrypt, local multi-device sharding and, on the
card, lanes wider than 32 bits.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.ops import aes
from flashe_tpu_torch.ops.flashe_mask import mask_apply
from flashe_tpu_torch.ops.lanes import nlimbs_for

__all__ = ["FlasheCipher", "merge_idx_runs"]

_SEED_BITS = 256


def merge_idx_runs(idx_list):
    """Run-merge surviving client indices into non-cancelling telescope
    boundaries: [0, 1, 3] -> add prefixes [2, 4], minus prefixes [0, 3]."""
    adds, minuses = [], []
    for idx in sorted(idx_list):
        if adds and idx == adds[-1]:
            adds[-1] = idx + 1
        else:
            adds.append(idx + 1)
            minuses.append(idx)
    return adds, minuses


class FlasheCipher:
    """Session object owned by one client; the arbiter holds no key."""

    def __init__(self, int_bits: int, mask: str = "double", device="cuda"):
        if mask != "double":
            raise NotImplementedError(
                f"mask={mask!r}: only the double mask is ported; the single "
                "mask is not ported yet")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and nlimbs_for(int_bits) > 1:
            raise NotImplementedError(
                "int_bits > 32 on the card is not ported yet")
        self.int_bits = int_bits
        self.masking_scheme = mask

        self.uuid = None
        self.guest_uuid = None
        self.exchanged_keys = None
        self.idx = None  # ordinal index from the DH exchange

        self.prp_seed = None
        self._round_keys = None  # (15, 16) int32 tensor on self.device

        self.iter_index = -1
        self.num_clients = None
        self.num_params = None

    # -- session setup -----------------------------------------------------

    def set_self_uuid(self, uuid):
        self.uuid = uuid

    def set_exchanged_keys(self, exchanged_keys):
        self.exchanged_keys = exchanged_keys
        for k, v in exchanged_keys.items():
            if k == self.uuid:
                self.idx = v[0]
            elif v[2] == "guest":
                self.guest_uuid = k

    def get_guest_uuid(self):
        return self.guest_uuid

    def set_num_clients(self, num_clients: int):
        self.num_clients = num_clients

    def set_num_params(self, num_params: int):
        self.num_params = num_params

    def set_iter_index(self, iter_index: int):
        self.iter_index = iter_index

    def generate_prp_seed(self, assigned_seed=None):
        if assigned_seed is None:
            seed = os.urandom(_SEED_BITS // 8)
        elif isinstance(assigned_seed, int):
            seed = (assigned_seed & ((1 << _SEED_BITS) - 1)).to_bytes(
                _SEED_BITS // 8, "big")
        else:
            seed = (int.from_bytes(assigned_seed, "big")
                    & ((1 << _SEED_BITS) - 1)).to_bytes(_SEED_BITS // 8, "big")
        self.prp_seed = seed
        self._round_keys = torch.from_numpy(
            aes.key_schedule(seed).astype(np.int32)).to(self.device)

    def get_prp_seed(self):
        return self.prp_seed

    def get_idx_list(self):
        return [self.idx]

    def set_local_devices(self, n_shards=None, devices=None):
        raise NotImplementedError(
            "sharding a party's lanes over local devices is not ported yet")

    def set_masks(self, masks, total):
        if masks is not None:
            raise NotImplementedError(
                "the sparse (compact-counter) decrypt is not ported yet")

    def prepare_encrypt(self):
        """No-op: the fused kernel generates masks cheaper than it could
        read precomputed ones back, as on the TPU."""

    def prepare_decrypt(self):
        """No-op, as prepare_encrypt."""

    # -- encrypt / decrypt -------------------------------------------------

    def encrypt(self, value: torch.Tensor) -> torch.Tensor | None:
        """(n,) int32 lanes (or (n, L) limbs on the CPU) -> ciphertext:
        c = (q + a_idx - a_{idx+1}) mod 2^int_bits."""
        if self.prp_seed is None:
            return None
        return mask_apply(value, self._round_keys, self.iter_index, self.idx,
                          self.idx + 1, self.int_bits)

    def decrypt(self, value: torch.Tensor, idx_list=None) -> torch.Tensor | None:
        """Decrypt an aggregate of the surviving clients in idx_list (all
        num_clients by default): one mask launch per run-merged
        (add, minus) boundary pair."""
        if self.prp_seed is None:
            return None
        if idx_list is None:
            idx_list = list(range(self.num_clients))
        out = value
        for a, b in zip(*merge_idx_runs(idx_list)):
            out = mask_apply(out, self._round_keys, self.iter_index, a, b,
                             self.int_bits)
        return out
