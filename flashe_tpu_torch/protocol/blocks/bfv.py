"""BFV session blocks (port of flashe_tpu/protocol/blocks/bfv.py; reference
jzf_bfv_block.py:58-95).

The guest makes the context and keys, AES-256-CTR-wraps its secret
polynomial for each host under the pairwise DH secret and sends its public
key; the arbiter relays the wrapped blobs, forwards the public key to the
hosts and keeps only the ring context, enough to add ciphertexts and
never to decrypt.  The guest's quantizer is seeded with 0 and every
host's with 1.  Uploads are (B, 2, k, N) ciphertexts, so they travel
unpacked (wire_int_bits None).
"""

from __future__ import annotations

from flashe_tpu_torch.crypto.bfv import BFVCipher
from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.protocol import dh_sync, uuid_sync
from flashe_tpu_torch.protocol.blocks import _keywrap
from flashe_tpu_torch.quant.quantizer import QuantizingArbiter, QuantizingClient

__all__ = ["Arbiter", "Guest", "Host"]

_GUEST_SEED, _HOST_SEED = 0, 1


def _params(args):
    return (args.get("p", 1964769281), args.get("m", 8192),
            args.get("sec", 128), args.get("flagBatching", True))


def _qargs(args):
    q = args["quantize"]
    return q["int_bits"], q["batch"], q["element_bits"], \
        q.get("padding", True), q["secure"]


class Arbiter(uuid_sync.Arbiter, dh_sync.Arbiter):
    """Holds the ring context only: adds ciphertexts."""

    def __init__(self, args, device="cuda"):
        p, m, sec, batching = _params(args)
        self.cipher = BFVCipher(p, m, sec, batching, device=device)
        self.device = self.cipher.device
        (self.int_bits, self.batch, self.element_bits, _,
         self.secure) = _qargs(args)
        self.wire_int_bits = None
        self.quantizer = None
        self._trv = None

    def register_bfv_cipher(self, t):
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
        # the public key is public material: forward it to the hosts
        pk = self._trv.guest_to_arbiter.get(idx=0, suffix=("pubkey",))
        self._trv.arbiter_to_host.remote(obj=pk, role=consts.HOST, idx=-1,
                                         suffix=("pubkey",))
        self.quantizer = QuantizingArbiter(self.int_bits, self.batch,
                                           self.element_bits, self.secure)
        self.quantizer.set_num_clients(cnt)
        _keywrap.broadcast_num_clients(self._trv, cnt)
        return self

    def set_iter_index(self, it):
        self.quantizer.set_iter(it)

    def help_quantize(self):
        return None

    def add_ciphertexts(self, ct_arrays):
        return self.cipher.add_ciphertexts(ct_arrays)

    def dynamic_masking(self, masks, total, suffix):
        return None


class _Client(uuid_sync.Client, dh_sync.Client):
    scheme = "bfv"

    def __init__(self, args, device="cuda"):
        self.device = resolve_device(device)
        (self.int_bits, self.batch, self.element_bits, self.padding,
         self.secure) = _qargs(args)
        self.wire_int_bits = None
        self._bfv_params = _params(args)
        self.cipher = None
        self.quantizer = None
        self._to_arbiter = None
        self._from_arbiter = None

    def _new_cipher(self) -> BFVCipher:
        return BFVCipher(*self._bfv_params, device=self.device)

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
        return self.cipher.encrypt(q_lanes)

    def decrypt(self, cts, count=None):
        """The aggregate's first `count` slots: the clients' summed
        quantized lanes mod t, int32 on this client's device."""
        return self.cipher.decrypt(cts, count)

    def prepare_encrypt(self):
        pass

    def prepare_decrypt(self):
        pass

    def dynamic_masking(self, suffix):
        return None

    def get_idx_list(self):
        return None

    def _finish(self, seed: int):
        self.quantizer = QuantizingClient(
            self.int_bits, self.batch, self.element_bits, self.padding,
            self.secure, seed=seed, device=self.device)
        self.quantizer.set_num_clients(
            _keywrap.receive_num_clients(self._from_arbiter))
        return self


class Guest(_Client):
    def register_bfv_cipher(self, t):
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
        """Make the keys, send the wrapped secret for the hosts and the
        public key to the arbiter."""
        uuid = self.generate_uuid()
        exchanged = self.key_exchange(uuid)
        self.cipher = self._new_cipher().generate_keys()
        self._to_arbiter.remote(
            obj=_keywrap.guest_wrap_for_hosts(
                exchanged, self.cipher.serialize_secret()),
            role=consts.ARBITER, idx=0, suffix=("seed",))
        self._to_arbiter.remote(obj=self.cipher.public_parts(),
                                role=consts.ARBITER, idx=0,
                                suffix=("pubkey",))
        return self._finish(_GUEST_SEED)


class Host(_Client):
    def register_bfv_cipher(self, t):
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
        """Unwrap the guest's secret; take its public key from the
        arbiter."""
        uuid = self.generate_uuid()
        exchanged = self.key_exchange(uuid)
        guest_uuid = next(u for u, tup in exchanged.items()
                          if tup[2] == consts.GUEST)
        wrapped = self._from_arbiter.get(idx=0, suffix=("seed",))
        self.cipher = self._new_cipher().load_secret(
            _keywrap.host_unwrap(exchanged, guest_uuid, wrapped))
        self.cipher.set_public_parts(
            self._from_arbiter.get(idx=0, suffix=("pubkey",)))
        return self._finish(_HOST_SEED)
