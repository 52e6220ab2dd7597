"""Paillier session blocks (port of flashe_tpu/protocol/blocks/paillier.py;
reference jzf_paillier_block.py).

Semi-honest shared-keypair model (jzf_paillier.py note at 69): the guest
generates (n, p, q), AES-256-CTR-wraps pickle.dumps((p, q)) for each host
under the pairwise DH secret, and the arbiter relays the blobs while
keeping only the public n: it can multiply ciphertexts mod n^2 but never
decrypt.  `register_paillier_cipher` + `create_cipher()` run that session
setup over a federation (uuid sync, DH exchange, wrap, num_clients
broadcast); the guest's quantizer is seeded with 0 and every host's with
1, as in the JAX package.  `make_session` keys the same blocks in one
process, without transport.
"""

from __future__ import annotations

import pickle

from flashe_tpu_torch.crypto.paillier import (
    PaillierCipher, PaillierPrivateKey, PaillierPublicKey)
from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.ops.lanes import ints_to_lanes, lanes_to_ints
from flashe_tpu_torch.protocol import dh_sync, uuid_sync
from flashe_tpu_torch.protocol.blocks import _keywrap
from flashe_tpu_torch.quant.quantizer import QuantizingArbiter, QuantizingClient

__all__ = ["Arbiter", "Guest", "Host", "make_session"]

_GUEST_SEED, _HOST_SEED = 0, 1


def _qargs(args):
    q = args["quantize"]
    return q["int_bits"], q["batch"], q["element_bits"], \
        q.get("padding", True), q["secure"]


class Arbiter(uuid_sync.Arbiter, dh_sync.Arbiter):
    """Holds the public key only: multiplies ciphertexts mod n^2."""

    def __init__(self, args, device="cuda"):
        self.cipher = PaillierCipher(device)
        self.device = self.cipher.device
        (self.int_bits, self.batch, self.element_bits, _,
         self.secure) = _qargs(args)
        self.wire_int_bits = None  # ciphertexts are big ints, not lanes
        self.quantizer = None
        self._trv = None

    def register_paillier_cipher(self, t):
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
        n = self._trv.guest_to_arbiter.get(idx=0, suffix=("pubkey",))
        self._keyed(n, cnt)
        _keywrap.broadcast_num_clients(self._trv, cnt)
        return self

    def _keyed(self, n: int, num_clients: int):
        self.cipher.set_public_key(PaillierPublicKey(n))
        self.quantizer = QuantizingArbiter(self.int_bits, self.batch,
                                           self.element_bits, self.secure)
        self.quantizer.set_num_clients(num_clients)
        return self

    def set_iter_index(self, it):
        self.quantizer.set_iter(it)

    def help_quantize(self):
        return None  # secure path only

    def get_n(self):
        return self.cipher.get_n()

    def add_ciphertexts(self, ct_arrays):
        return self.cipher.add_ciphertexts(ct_arrays)

    def dynamic_masking(self, masks, total, suffix):
        return None


class _Client(uuid_sync.Client, dh_sync.Client):
    scheme = "paillier"

    def __init__(self, args, device="cuda"):
        self.device = resolve_device(device)
        (self.int_bits, self.batch, self.element_bits, self.padding,
         self.secure) = _qargs(args)
        self.wire_int_bits = None
        self.key_length = args.get("key_length", 2048)
        self.cipher = PaillierCipher(self.device)
        self.quantizer = None
        self._to_arbiter = None
        self._from_arbiter = None

    def set_codec(self, codec):
        self.quantizer.set_codec(codec)

    def set_iter_index(self, it):
        self.quantizer.set_iter(it)

    def quantize(self, flat, uniforms=None):
        return self.quantizer.quantize(flat, uniforms=uniforms)

    def unquantize(self, q_lanes, n_elements=None, n_clients=None):
        return self.quantizer.unquantize(q_lanes, n_elements, n_clients)

    def normalize(self, flat):
        return self.quantizer.normalize(flat)

    def unnormalize(self, flat):
        return self.quantizer.unnormalize(flat)

    def encrypt(self, q_lanes):
        """Batched quantized lanes -> object-int ciphertext vector."""
        return self.cipher.encrypt(lanes_to_ints(q_lanes, self.int_bits))

    def decrypt(self, cts, count=None):
        """Aggregated ciphertexts -> int32 limb lanes of the plaintext sums,
        on the quantizer's device."""
        sums = self.cipher.decrypt(cts)
        return ints_to_lanes(sums, self.int_bits).to(self.quantizer.device)

    def prepare_encrypt(self):
        pass

    def prepare_decrypt(self):
        pass

    def dynamic_masking(self, suffix):
        return None

    def get_idx_list(self):
        return None

    def _finish(self, seed: int, num_clients: int):
        self.quantizer = QuantizingClient(
            self.int_bits, self.batch, self.element_bits, self.padding,
            self.secure, seed=seed, device=self.device)
        self.quantizer.set_num_clients(num_clients)
        return self


class Guest(_Client):
    def register_paillier_cipher(self, t):
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
        """Generate the keypair, send the wrapped (p, q) for the hosts and
        n to the arbiter."""
        uuid = self.generate_uuid()
        exchanged = self.key_exchange(uuid)
        self.cipher.generate_key(self.key_length)
        pub, prv = self.cipher.get_key_pair()
        blob = pickle.dumps((prv.p, prv.q))
        self._to_arbiter.remote(
            obj=_keywrap.guest_wrap_for_hosts(exchanged, blob),
            role=consts.ARBITER, idx=0, suffix=("seed",))
        self._to_arbiter.remote(obj=pub.n, role=consts.ARBITER, idx=0,
                                suffix=("pubkey",))
        return self._finish(_GUEST_SEED,
                            _keywrap.receive_num_clients(self._from_arbiter))

    def key_in_process(self, num_clients: int, keypair=None):
        """make_session's guest: generate the keypair (or take `keypair`,
        a (public, private) pair) without transport."""
        if keypair is None:
            self.cipher.generate_key(self.key_length)
        else:
            self.cipher.set_public_key(keypair[0])
            self.cipher.set_privacy_key(keypair[1])
        return self._finish(_GUEST_SEED, num_clients)


class Host(_Client):
    def register_paillier_cipher(self, t):
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
        """Unwrap the guest's (p, q)."""
        uuid = self.generate_uuid()
        exchanged = self.key_exchange(uuid)
        guest_uuid = next(u for u, tup in exchanged.items()
                          if tup[2] == consts.GUEST)
        wrapped = self._from_arbiter.get(idx=0, suffix=("seed",))
        p, q = pickle.loads(_keywrap.host_unwrap(exchanged, guest_uuid,
                                                 wrapped))
        return self.key_in_process(
            p, q, _keywrap.receive_num_clients(self._from_arbiter))

    def key_in_process(self, p: int, q: int, num_clients: int):
        """Take the guest's primes."""
        pub = PaillierPublicKey(p * q)
        self.cipher.set_public_key(pub)
        self.cipher.set_privacy_key(PaillierPrivateKey(pub, p, q))
        return self._finish(_HOST_SEED, num_clients)


def make_session(args, num_clients: int, device="cuda", keypair=None):
    """One guest, num_clients - 1 hosts and the arbiter, keyed in one
    process as the session setup would key them: returns
    ([guest, *hosts], arbiter)."""
    guest = Guest(args, device).key_in_process(num_clients, keypair)
    _, prv = guest.cipher.get_key_pair()
    hosts = [Host(args, device).key_in_process(prv.p, prv.q, num_clients)
             for _ in range(num_clients - 1)]
    return [guest, *hosts], Arbiter(args, device)._keyed(
        guest.cipher.get_n(), num_clients)
