"""The FLASHE cipher (port of flashe_tpu/crypto/flashe.py::FlasheCipher).

A ciphertext is an int32 lane tensor holding uint32 bit patterns.  Client
idx encrypts q as (q + a_idx - a_{idx+1}) mod 2^m, where a_s is the AES-256
mask stream s of the current iteration; the sum of all clients' ciphertexts
telescopes to sum(q) + a_n - a_0, and the surviving clients' sum after a
dropout to the run-merged boundaries of `merge_idx_runs`.  With the single
mask a client encrypts q + a_idx and the decrypt subtracts each survivor's
a_i.  Lanes wider than 32 bits are (n, L) int32 limbs.

Sparsified uploads (`set_masks`): client i encrypted its compacted top-s%
vector at counters 0 .. len(loc_i) - 1, and the arbiter scattered it to the
dense positions loc_i, so the sparse decrypt undoes -a_i (+ a_{i+1} for the
double mask) of each survivor's compact streams at loc_i.  The JAX package
keeps the same divergence from the reference's dense-counter double-mask
reconstruction (flashe_tpu/crypto/flashe.py:17-22).

Every encrypt, every decrypt boundary pair, each single-mask survivor and
each survivor's sparse scatter is one fused mask launch
(flashe_tpu_torch/ops/flashe_mask.py): the CUDA kernel on the card, the
plain torch version on the CPU.  No mask stream is ever written out, so
there is nothing to precompute.  `set_local_devices` splits a party's dense
lanes over several devices (parallel/party.LocalLaneMesh, one launch a
shard at its counter offset) and fans its sparse decrypt out by client
(parallel/party.sparse_decrypt_fanout); both are bit-identical with the
single-device path, and the limb path (> 32 bits) stays on one device, as
in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.ops import aes
from flashe_tpu_torch.ops.flashe_mask import mask_apply, mask_scatter
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
        if mask not in ("double", "single"):
            raise ValueError(f"mask must be 'double' or 'single', not {mask!r}")
        self.device = resolve_device(device)
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

        # sparsification state (the dynamic-masking broadcast): each
        # client's dense locations, int64 on self.device
        self.masks = None
        self.total = None
        self._party_mesh = None  # parallel/party.LocalLaneMesh, or None

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
        """Give this party several devices (the reference's per-party Pool,
        jzf_flashe.py:436-447): the dense double- and single-mask encrypt
        and decrypt split the lane vector over them, and the sparse decrypt
        fans out by client.  `devices` defaults to every visible card; a
        cipher on the CPU defaults to the CPU n_shards times, as the JAX
        tests' virtual CPU devices.  A 1-device mesh disables the route."""
        from flashe_tpu_torch.parallel.party import LocalLaneMesh

        if devices is None and self.device.type == "cpu":
            devices = [self.device] * (
                1 if n_shards in (None, "all") else int(n_shards))
        m = LocalLaneMesh(n_shards, devices)
        self._party_mesh = m if m.n_shards > 1 else None

    def _party_ok(self, value) -> bool:
        return (self._party_mesh is not None
                and self.masks is None
                and value.dim() == 1
                and nlimbs_for(self.int_bits) == 1)

    def set_masks(self, masks, total):
        """Install the sparsity location lists, one a client by idx (None
        turns the sparse decrypt off).  Each is a strictly increasing
        sequence of positions below `total`, checked here on the host: the
        scatter writes where they point."""
        self.total = total
        if masks is None:
            self.masks = None
            return
        locs = []
        for i, m in enumerate(masks):
            a = np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m,
                           dtype=np.int64)
            if a.ndim != 1 or (a.size and (
                    a[0] < 0 or a[-1] >= total or np.any(np.diff(a) <= 0))):
                raise ValueError(f"locations of client {i} are not strictly "
                                 f"increasing positions below {total}")
            locs.append(torch.from_numpy(a).to(self.device))
        self.masks = locs

    def prepare_encrypt(self):
        """No-op.  The JAX package precomputes mask streams only where its
        fused kernel does not serve; here the kernel serves every path
        (double and single mask, limbs, the sparse scatter), and generates
        a stream cheaper than it could read a precomputed one back."""

    def prepare_decrypt(self):
        """No-op, as prepare_encrypt."""

    # -- encrypt / decrypt -------------------------------------------------

    def encrypt(self, value: torch.Tensor) -> torch.Tensor | None:
        """(n,) int32 lanes or (n, L) limbs -> ciphertext:
        c = (q + a_idx - a_{idx+1}) mod 2^int_bits (double), or
        (q + a_idx) mod 2^int_bits (single); one launch."""
        if self.prp_seed is None:
            return None
        if self._party_ok(value):
            if self.masking_scheme == "double":
                return self._party_mesh.encrypt(
                    self._round_keys, value, self.iter_index, self.idx,
                    self.int_bits)
            return self._party_mesh.encrypt_single(
                self._round_keys, value, self.iter_index, self.idx,
                self.int_bits)
        minus = self.idx + 1 if self.masking_scheme == "double" else None
        return mask_apply(value, self._round_keys, self.iter_index, self.idx,
                          minus, self.int_bits)

    def decrypt(self, value: torch.Tensor, idx_list=None) -> torch.Tensor | None:
        """Decrypt an aggregate of the surviving clients in idx_list (all
        num_clients by default).  Dense double mask: one launch per
        run-merged (add, minus) boundary pair; single mask: one -a_i launch
        per survivor; sparse (masks set): one scatter per survivor."""
        if self.prp_seed is None:
            return None
        if idx_list is None:
            idx_list = list(range(self.num_clients))
        if self.masks is not None:
            return self._decrypt_sparse(value, idx_list)
        if self._party_ok(value):
            if self.masking_scheme == "double":
                adds, minuses = merge_idx_runs(idx_list)
                return self._party_mesh.decrypt_runs(
                    self._round_keys, value, self.iter_index, adds, minuses,
                    self.int_bits)
            return self._party_mesh.decrypt_single(
                self._round_keys, value, self.iter_index, idx_list,
                self.int_bits)
        out = value
        if self.masking_scheme == "single":
            for idx in idx_list:
                out = mask_apply(out, self._round_keys, self.iter_index, None,
                                 idx, self.int_bits)
            return out
        for a, b in zip(*merge_idx_runs(idx_list)):
            out = mask_apply(out, self._round_keys, self.iter_index, a, b,
                             self.int_bits)
        return out

    def _decrypt_sparse(self, value: torch.Tensor, idx_list) -> torch.Tensor:
        """Undo each survivor's compact-counter masks at its locations, on
        a copy of the dense aggregate: one scatter launch a survivor."""
        if nlimbs_for(self.int_bits) > 1:
            raise NotImplementedError(
                "sparsified decryption requires int_bits <= 32 (batch mode "
                "and sparsification are mutually exclusive in the reference "
                "configs as well)")
        if self._party_mesh is not None and len(idx_list) > 1:
            from flashe_tpu_torch.parallel.party import sparse_decrypt_fanout

            return sparse_decrypt_fanout(
                self._party_mesh.devices, self._round_keys, value,
                self.iter_index, [self.masks[i] for i in idx_list],
                list(idx_list), self.int_bits,
                self.masking_scheme == "double")
        out = value.clone()
        for i in idx_list:
            add = i + 1 if self.masking_scheme == "double" else None
            mask_scatter(out, self.masks[i], self._round_keys,
                         self.iter_index, add, i, self.int_bits)
        return out
