"""Additive random-pad session blocks (port of
flashe_tpu/protocol/blocks/additive.py).

The reference imports jzf_additive_mask_block (jzf_aggregator.py:16), but
the file is absent from its repository; the JAX package reconstructs it
from the stock random_padding_cipher.py, and this is that reconstruction:
uuid sync and the DH exchange give every client pair a secret, each client
adds its pairwise-cancelling pads to its float update
(crypto/random_pads.py), and the arbiter's float sum cancels them.  There
is no quantization and no decryption, and a missing client leaves its pads
uncancelled: both are what FLASHE improves on.
"""

from __future__ import annotations

from flashe_tpu_torch.crypto.random_pads import PadsCipher
from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.protocol import dh_sync, uuid_sync

__all__ = ["Arbiter", "Guest", "Host"]


class Arbiter(uuid_sync.Arbiter, dh_sync.Arbiter):
    def __init__(self, args, device="cuda"):
        self.device = resolve_device(device)
        self.int_bits = None
        self.wire_int_bits = None
        self._trv = None

    def register_additive_mask_cipher(self, t):
        self._trv = t
        self.register_identify_uuid(guest_uuid_trv=t.guest_uuid,
                                    host_uuid_trv=t.host_uuid,
                                    conflict_flag_trv=t.uuid_conflict_flag)
        self.register_dh_key_exchange(
            dh_pubkey_trv=t.dh_pubkey,
            dh_ciphertext_host_trv=t.dh_ciphertext_host,
            dh_ciphertext_guest_trv=t.dh_ciphertext_guest,
            dh_ciphertext_bc_trv=t.dh_ciphertext_bc)
        return self

    def create_cipher(self):
        self.validate_uuid()
        self.key_exchange()
        return self

    def set_iter_index(self, it):
        pass

    def help_quantize(self):
        return None

    def dynamic_masking(self, masks, total, suffix):
        return None


class _Client(uuid_sync.Client, dh_sync.Client):
    scheme = "additive"

    def __init__(self, args, device="cuda"):
        self.cipher = PadsCipher(device)
        self.device = self.cipher.device
        self.int_bits = None
        self.wire_int_bits = None
        self._to_arbiter = None
        self._from_arbiter = None

    def set_codec(self, codec):
        pass

    def set_iter_index(self, it):
        pass

    def quantize(self, flat, uniforms=None):
        return flat

    def unquantize(self, v, n_elements=None, n_clients=None):
        return v

    def normalize(self, flat):
        return flat

    def unnormalize(self, flat):
        return flat

    def encrypt(self, flat):
        return self.cipher.encrypt(flat)

    def decrypt(self, v, idx_list=None):
        return v  # the pads cancelled in the arbiter's sum

    def prepare_encrypt(self):
        pass

    def prepare_decrypt(self):
        pass

    def dynamic_masking(self, suffix):
        return None

    def get_idx_list(self):
        return None

    def create_cipher(self):
        uuid = self.generate_uuid()
        exchanged = self.key_exchange(uuid)
        self.cipher.set_self_uuid(uuid)
        self.cipher.set_exchanged_keys(exchanged)
        return self


class Guest(_Client):
    def register_additive_mask_cipher(self, t):
        self._to_arbiter = t.guest_to_arbiter
        self._from_arbiter = t.arbiter_to_guest
        self.register_identify_uuid(
            uuid_transfer_variable=t.guest_uuid,
            conflict_flag_transfer_variable=t.uuid_conflict_flag)
        self.register_dh_key_exchange(
            dh_pubkey_trv=t.dh_pubkey,
            dh_ciphertext_trv=t.dh_ciphertext_guest,
            dh_ciphertext_bc_trv=t.dh_ciphertext_bc)
        return self


class Host(_Client):
    def register_additive_mask_cipher(self, t):
        self._to_arbiter = t.host_to_arbiter
        self._from_arbiter = t.arbiter_to_host
        self.register_identify_uuid(
            uuid_transfer_variable=t.host_uuid,
            conflict_flag_transfer_variable=t.uuid_conflict_flag)
        self.register_dh_key_exchange(
            dh_pubkey_trv=t.dh_pubkey,
            dh_ciphertext_trv=t.dh_ciphertext_host,
            dh_ciphertext_bc_trv=t.dh_ciphertext_bc)
        return self
