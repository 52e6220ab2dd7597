"""CKKS session blocks (port of flashe_tpu/protocol/blocks/ckks.py;
reference jzf_ckks_block.py).

The key choreography of the BFV blocks, with symmetric CKKS: the guest
makes the secret and wraps it for each host, and the arbiter keeps only
the ring context.  As in the reference there is no quantization: the
model's floats go into the encoder (jzf_ckks_block.py:84-94), so
normalize and quantize are identities and `unquantize` returns the
decrypted sum for the aggregator to average.
"""

from __future__ import annotations

from flashe_tpu_torch.crypto.ckks import CKKSCipher
from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.protocol import dh_sync, uuid_sync
from flashe_tpu_torch.protocol.blocks import _keywrap

__all__ = ["Arbiter", "Guest", "Host"]


def _params(args):
    return (args.get("poly_modulus_degree", 8192),
            args.get("global_scale", 2.0 ** 40))


class _NoQuant:
    """Identity quantizer stand-in (CKKS ships floats)."""

    def set_codec(self, codec):
        self.codec = codec

    def set_iter(self, it):
        pass


class Arbiter(uuid_sync.Arbiter, dh_sync.Arbiter):
    """Holds the ring context only: adds ciphertexts."""

    def __init__(self, args, device="cuda"):
        args = args or {}
        N, scale = _params(args)
        self.cipher = CKKSCipher(N, global_scale=scale, device=device)
        self.device = self.cipher.device
        self.wire_int_bits = None
        self.int_bits = None
        self.quantizer = _NoQuant()
        self._trv = None

    def register_ckks_cipher(self, t):
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
        cnt = _keywrap.arbiter_relay(self._trv)
        _keywrap.broadcast_num_clients(self._trv, cnt)
        return self

    def set_iter_index(self, it):
        pass

    def help_quantize(self):
        return None

    def add_ciphertexts(self, ct_arrays):
        return self.cipher.add_ciphertexts(ct_arrays)

    def dynamic_masking(self, masks, total, suffix):
        return None


class _Client(uuid_sync.Client, dh_sync.Client):
    scheme = "ckks"

    def __init__(self, args, device="cuda"):
        self.device = resolve_device(device)
        self.wire_int_bits = None
        self.int_bits = None
        self._ckks_params = _params(args or {})
        self.cipher = None
        self.quantizer = _NoQuant()
        self.num_clients = None
        self._to_arbiter = None
        self._from_arbiter = None

    def _new_cipher(self) -> CKKSCipher:
        N, scale = self._ckks_params
        return CKKSCipher(N, global_scale=scale, device=self.device)

    def set_codec(self, codec):
        self.quantizer.set_codec(codec)

    def set_iter_index(self, it):
        pass

    def quantize(self, flat, uniforms=None):
        return flat  # floats into the slots (jzf_ckks_block.py:84-94)

    def unquantize(self, v, n_elements=None, n_clients=None):
        return v  # the sum: the aggregator divides by the degrees

    def normalize(self, flat):
        return flat

    def unnormalize(self, flat):
        return flat

    def encrypt(self, flat):
        return self.cipher.encrypt(flat)

    def decrypt(self, cts, count=None):
        """The aggregate's first `count` slots, float32."""
        return self.cipher.decrypt(cts, count).float()

    def prepare_encrypt(self):
        pass

    def prepare_decrypt(self):
        pass

    def dynamic_masking(self, suffix):
        return None

    def get_idx_list(self):
        return None

    def _finish(self):
        self.num_clients = _keywrap.receive_num_clients(self._from_arbiter)
        return self


class Guest(_Client):
    def register_ckks_cipher(self, t):
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

    def create_cipher(self):
        uuid = self.generate_uuid()
        exchanged = self.key_exchange(uuid)
        self.cipher = self._new_cipher().generate_keys()
        self._to_arbiter.remote(
            obj=_keywrap.guest_wrap_for_hosts(
                exchanged, self.cipher.serialize_secret()),
            role=consts.ARBITER, idx=0, suffix=("seed",))
        return self._finish()


class Host(_Client):
    def register_ckks_cipher(self, t):
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

    def create_cipher(self):
        uuid = self.generate_uuid()
        exchanged = self.key_exchange(uuid)
        guest_uuid = next(u for u, tup in exchanged.items()
                          if tup[2] == consts.GUEST)
        wrapped = self._from_arbiter.get(idx=0, suffix=("seed",))
        self.cipher = self._new_cipher().load_secret(
            _keywrap.host_unwrap(exchanged, guest_uuid, wrapped))
        return self._finish()
