"""Paillier session blocks without transport (port of
flashe_tpu/protocol/blocks/paillier.py).

Semi-honest shared-keypair model: the guest generates (n, p, q) and hands
(p, q) to every host, and the arbiter keeps only the public n, so it can
multiply ciphertexts mod n^2 but never decrypt.  `make_session` plays that
key distribution in one process.  Not ported yet: the federation transport,
the uuid and DH syncs, and the DH-keyed AES wrap of (p, q) for the hosts.
"""

from __future__ import annotations

from flashe_tpu_torch.crypto.paillier import (
    PaillierCipher, PaillierPrivateKey, PaillierPublicKey)
from flashe_tpu_torch.ops.lanes import ints_to_lanes, lanes_to_ints
from flashe_tpu_torch.quant.quantizer import QuantizingClient

__all__ = ["Arbiter", "Guest", "Host", "make_session"]


def _qargs(args):
    q = args["quantize"]
    return q["int_bits"], q["batch"], q["element_bits"], \
        q.get("padding", True), q["secure"]


class Arbiter:
    """Holds the public key only: multiplies ciphertexts mod n^2."""

    def __init__(self, n: int, device="cuda"):
        self.cipher = PaillierCipher(device)
        self.cipher.set_public_key(PaillierPublicKey(n))

    def add_ciphertexts(self, ct_arrays):
        return self.cipher.add_ciphertexts(ct_arrays)


class _Client:
    scheme = "paillier"

    def __init__(self, args, device="cuda"):
        (self.int_bits, self.batch, self.element_bits, self.padding,
         self.secure) = _qargs(args)
        self.key_length = args.get("key_length", 2048)
        self.cipher = PaillierCipher(device)
        self.quantizer = None

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

    def get_idx_list(self):
        return None

    def _finish(self, seed: int, num_clients: int):
        self.quantizer = QuantizingClient(
            self.int_bits, self.batch, self.element_bits, self.padding,
            self.secure, seed=seed, device=self.cipher.device)
        self.quantizer.set_num_clients(num_clients)


class Guest(_Client):
    def create_cipher(self, num_clients: int, keypair=None):
        """Generate the session's keypair (or take `keypair`, a
        (public, private) pair); the guest's quantizer seed is 0."""
        if keypair is None:
            self.cipher.generate_key(self.key_length)
        else:
            self.cipher.set_public_key(keypair[0])
            self.cipher.set_privacy_key(keypair[1])
        self._finish(seed=0, num_clients=num_clients)
        return self


class Host(_Client):
    def create_cipher(self, p: int, q: int, num_clients: int):
        """Take the guest's primes; every host's quantizer seed is 1."""
        pub = PaillierPublicKey(p * q)
        self.cipher.set_public_key(pub)
        self.cipher.set_privacy_key(PaillierPrivateKey(pub, p, q))
        self._finish(seed=1, num_clients=num_clients)
        return self


def make_session(args, num_clients: int, device="cuda", keypair=None):
    """One guest, num_clients - 1 hosts and the arbiter, keyed as the guest
    would key them: returns ([guest, *hosts], arbiter)."""
    guest = Guest(args, device).create_cipher(num_clients, keypair)
    _, prv = guest.cipher.get_key_pair()
    hosts = [Host(args, device).create_cipher(prv.p, prv.q, num_clients)
             for _ in range(num_clients - 1)]
    return [guest, *hosts], Arbiter(guest.cipher.get_n(), device)
