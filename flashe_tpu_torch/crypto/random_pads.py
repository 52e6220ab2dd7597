"""Stock FATE random-padding secure aggregation (port of
flashe_tpu/crypto/random_pads.py; reference
federatedml/framework/homo/procedure/random_padding_cipher.py and
secureprotol/random.py RandomPads).

After the DH exchange every client pair (i, j) shares a secret; client i
adds +pad_ij if uuid_i < uuid_j else -pad_ij for every peer, pad_ij a
stream seeded from the shared secret, so the pairwise pads cancel in the
arbiter's sum: there is no decryption, every client makes one pad a peer,
and a dropped client leaves its pads in the sum.

A stream is seeded by `secret & 0xFFFFFFFF` (the reference's MT19937 seed,
and the JAX package's PRNGKey); each draw takes a fresh torch.Generator on
the stream's device, seeded from (that seed, a counter of draws), as the
JAX package folds the counter into its key (the CPU's generator keeps the
low 32 bits of that 64-bit seed, the card's all of them).  Both members of
a pair draw the same pad, bit for bit, on the same kind of device.
Neither package reproduces the reference's MT19937 pads; the masking is
random either way.
"""

from __future__ import annotations

import hashlib

import torch

from flashe_tpu_torch.device import resolve_device

__all__ = ["RandomPads", "PadsCipher"]


class RandomPads:
    """Seeded pad streams (reference secureprotol/random.py:20-45)."""

    def __init__(self, init_seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self._seed = init_seed & 0xFFFFFFFF
        self._counter = 0

    def _next(self) -> torch.Generator:
        self._counter += 1
        digest = hashlib.blake2b(
            f"{self._seed}:{self._counter}".encode(), digest_size=8).digest()
        g = torch.Generator(device=self.device)
        g.manual_seed(int.from_bytes(digest, "little") >> 1)
        return g

    def rand(self, *shape) -> torch.Tensor:
        """Uniform float32 draws on [0, 1)."""
        return torch.rand(shape, generator=self._next(), device=self.device)

    def randn(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._next(), device=self.device)

    def add_randn_pads(self, a, w) -> torch.Tensor:
        a = torch.as_tensor(a, device=self.device)
        return a + self.randn(*a.shape) * w

    def add_rand_pads(self, a, w) -> torch.Tensor:
        a = torch.as_tensor(a, device=self.device)
        return a + self.rand(*a.shape) * w


class PadsCipher:
    """Pairwise-cancelling additive masking."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.uuid = None
        self._pads = None  # list of (sign, RandomPads)

    def set_self_uuid(self, uuid):
        self.uuid = uuid

    def set_exchanged_keys(self, exchanged_keys: dict):
        """exchanged_keys: {uuid: (idx, shared_secret, role, comm_idx)}."""
        self._pads = []
        for uid, tup in exchanged_keys.items():
            if uid == self.uuid:
                continue
            sign = 1.0 if str(self.uuid) < str(uid) else -1.0
            self._pads.append((sign, RandomPads(int(tup[1]), self.device)))

    def encrypt(self, flat) -> torch.Tensor:
        """Add every pairwise pad; the arbiter's sum cancels them."""
        out = torch.as_tensor(flat, device=self.device).float()
        for sign, pads in self._pads:
            out = out + sign * pads.randn(*out.shape)
        return out

    def decrypt(self, flat, idx_list=None):
        """The aggregate of all clients is already the plaintext sum."""
        return flat
