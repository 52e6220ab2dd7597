"""FLASHE session setup and masking broadcast (port of
flashe_tpu/protocol/blocks/flashe.py; reference jzf_flashe_block.py).

Flow (create_cipher, runs once per job):
1. uuid sync (conflict-checked) and DH exchange via arbiter relay; the
   arbiter-assigned ordinal (guest 0, host h -> 1 + h) becomes the mask
   stream index,
2. the guest generates the 256-bit PRP seed, AES-256-CTR-wraps it for each
   host under the pairwise DH secret and sends the dict to the arbiter,
   which relays each blob by comm idx; hosts unwrap with the guest secret
   (protocol/blocks/_keywrap.py),
3. the arbiter counts clients and broadcasts num_clients,
4. each client makes its quantizer, seeded with its ordinal; the
   precompute bootstrap of the configuration is a no-op in the port
   (crypto/flashe.py::FlasheCipher.prepare_encrypt).

The non-secure quantizer asks the arbiter for its clip thresholds: each
client sends its per-layer min and max (the layer sizes once), the arbiter
answers with the ACIQ alphas of the global range.

With sparsification the arbiter collects every client's locations, chooses
single or double masking by the cost of the sparse decrypt
(`choose_masking`, mask="dynamic") and broadcasts {"choice", "masks"}; each
client installs both in its cipher (`client_masking`).  Because
C = sum |m_i & m_{i+1}| over consecutive clients is below S = sum |m_i|,
double_cost = 4 S - 2 C always exceeds single_cost = 2 S: the dynamic
choice is always "single".  The JAX package broadcasts only under
mask="dynamic", so there a sparsified round with mask="double" installs no
locations and decrypts on the dense path; the port's blocks broadcast them
for every mask (`arbiter_masking`), so that the sparse double round
decrypts.

`local_lane_shards` gives each client's cipher that many local devices
(FlasheCipher.set_local_devices: every visible card by default, the CPU
repeated for a cipher on the CPU); the lane-sharded ciphertexts and
decrypts are the single-device ones, bit for bit.
"""

from __future__ import annotations

import torch

from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.protocol import dh_sync, uuid_sync
from flashe_tpu_torch.protocol.blocks import _keywrap
from flashe_tpu_torch.quant.quantizer import QuantizingArbiter, QuantizingClient

__all__ = ["Arbiter", "Guest", "Host", "choose_masking", "arbiter_masking",
           "client_masking"]


def _parse_args(args):
    q = args["quantize"]
    return {
        "int_bits": q["int_bits"],
        "batch": q["batch"],
        "element_bits": q["element_bits"],
        "padding": q.get("padding", True),
        "secure": q["secure"],
        "mask": args.get("mask", "double"),
        "precompute": args.get("precompute", {"enable": False}),
        # >1 (or "all"): the party shards encrypt/decrypt over that many
        # local devices (FlasheCipher.set_local_devices, parallel/party.py)
        "local_lane_shards": args.get("local_lane_shards"),
    }


def choose_masking(masks, total: int, device="cuda") -> str:
    """The arbiter's single-or-double decision from the clients' location
    lists, in client order: a single-mask decrypt regenerates one stream a
    selected position (2 S), a double-mask one two, less the positions
    that consecutive clients share (4 S - 2 C).  The overlaps are counted
    with bool tensors on `device`."""
    device = resolve_device(device)
    single_cost = 2 * sum(len(m) for m in masks)
    double_cost = 2 * single_cost
    cancelled = torch.zeros((), dtype=torch.int64, device=device)
    prev = None
    for m in masks:
        hot = torch.zeros(total, dtype=torch.bool, device=device)
        hot[torch.as_tensor(m, dtype=torch.int64, device=device)] = True
        if prev is not None:
            cancelled += (prev & hot).sum()
        prev = hot
    double_cost -= 2 * int(cancelled)
    return "single" if single_cost <= double_cost else "double"


def arbiter_masking(masks, total: int, mask: str, device="cuda") -> dict:
    """What the arbiter broadcasts once it holds every client's locations:
    the masking to use (the cost decision under mask="dynamic", else the
    configured mask) and the locations."""
    choice = (choose_masking(masks, total, device) if mask == "dynamic"
              else mask)
    return {"choice": choice, "masks": masks}


def client_masking(cipher, broadcast: dict):
    """A client's application of the broadcast: its cipher's masking
    scheme and every client's locations (its total was set when the client
    selected)."""
    cipher.masking_scheme = broadcast["choice"]
    cipher.set_masks(broadcast["masks"], cipher.total)


class Arbiter(uuid_sync.Arbiter, dh_sync.Arbiter):
    def __init__(self, args, device="cuda"):
        self.device = resolve_device(device)
        a = _parse_args(args)
        self.int_bits = a["int_bits"]
        self.wire_int_bits = a["int_bits"]
        self.batch = a["batch"]
        self.element_bits = a["element_bits"]
        self.secure = a["secure"]
        self.mask = a["mask"]
        self.quantizer = None
        self._trv = None
        self._layer_sizes_known = False

    def register_flashe_cipher(self, transfer_variables):
        t = transfer_variables
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
        client_cnt = _keywrap.arbiter_relay(self._trv)
        self.quantizer = QuantizingArbiter(self.int_bits, self.batch,
                                           self.element_bits, self.secure)
        self.quantizer.set_num_clients(client_cnt)
        _keywrap.broadcast_num_clients(self._trv, client_cnt)
        return self

    def set_iter_index(self, iter_index):
        self.quantizer.set_iter(iter_index)

    def help_quantize(self):
        """Non-secure arbiter-assisted clipping (jzf_quantize.py:308-333)."""
        if self.secure:
            return
        it = self.quantizer.iter
        if not self._layer_sizes_known:
            sizes = self._trv.guest_to_arbiter.get(idx=0, suffix=(it, -1))
            self.quantizer.set_layer_sizes(sizes)
            self._layer_sizes_known = True
        guest_mm = self._trv.guest_to_arbiter.get(idx=0, suffix=(it, 0))
        host_mms = self._trv.host_to_arbiter.get(idx=-1, suffix=(it, 0))
        mins = [guest_mm[0]] + [m[0] for m in host_mms]
        maxs = [guest_mm[1]] + [m[1] for m in host_mms]
        alphas = self.quantizer.help_quantize(mins, maxs)
        self._trv.arbiter_to_guest.remote(obj=alphas, role=consts.GUEST,
                                          idx=0, suffix=(it, 0))
        self._trv.arbiter_to_host.remote(obj=alphas, role=consts.HOST,
                                         idx=-1, suffix=(it, 0))

    def dynamic_masking(self, masks, total, suffix):
        """Broadcast the masking choice and every client's locations
        (`arbiter_masking`), under every mask."""
        d = arbiter_masking(masks, total, self.mask, self.device)
        self._trv.arbiter_to_guest.remote(obj=d, role=consts.GUEST, idx=0,
                                          suffix=suffix + ("choice",))
        self._trv.arbiter_to_host.remote(obj=d, role=consts.HOST, idx=-1,
                                         suffix=suffix + ("choice",))
        return d


class _Client(uuid_sync.Client, dh_sync.Client):
    """A client's FLASHE block: the cipher and the quantizer, with the
    interface of the round's cores (protocol/aggregator.py)."""

    scheme = "flashe"

    def __init__(self, args, device="cuda"):
        self.device = resolve_device(device)
        a = _parse_args(args)
        self.int_bits = a["int_bits"]
        self.wire_int_bits = a["int_bits"]
        self.batch = a["batch"]
        self.element_bits = a["element_bits"]
        self.padding = a["padding"]
        self.secure = a["secure"]
        self.mask = a["mask"]
        self.precompute = a["precompute"].get("enable", False)
        self.num_params = a["precompute"].get("num_params")
        self.local_lane_shards = a["local_lane_shards"]
        self.cipher: FlasheCipher | None = None
        self.quantizer: QuantizingClient | None = None
        self._to_arbiter = None
        self._from_arbiter = None
        self._sent_layer_sizes = False

    def _new_cipher(self, uuid, exchanged_keys) -> FlasheCipher:
        cipher = FlasheCipher(self.int_bits, mask=(
            "double" if self.mask == "dynamic" else self.mask),
            device=self.device)
        cipher.set_self_uuid(uuid)
        cipher.set_exchanged_keys(exchanged_keys)
        return cipher

    # the cores' interface
    def encrypt(self, value):
        return self.cipher.encrypt(value)

    def decrypt(self, value, idx_list=None):
        return self.cipher.decrypt(value, idx_list)

    def get_idx_list(self):
        return self.cipher.get_idx_list()

    def set_iter_index(self, iter_index):
        self.cipher.set_iter_index(iter_index)
        self.quantizer.set_iter(iter_index)

    def set_codec(self, codec):
        self.quantizer.set_codec(codec)
        if self.precompute and self.cipher.num_params is None:
            self.cipher.set_num_params(codec.total)

    def quantize(self, flat, uniforms=None):
        if not self.secure:
            it = self.quantizer.iter
            if not self._sent_layer_sizes:
                self._to_arbiter.remote(obj=self.quantizer.codec.sizes,
                                        role=consts.ARBITER, idx=0,
                                        suffix=(it, -1))
                self._sent_layer_sizes = True
            mm = self.quantizer.local_min_max(flat)
            self._to_arbiter.remote(obj=mm, role=consts.ARBITER, idx=0,
                                    suffix=(it, 0))
            alphas = self._from_arbiter.get(idx=0, suffix=(it, 0))
            return self.quantizer.quantize(flat, alpha_override=alphas,
                                           uniforms=uniforms)
        return self.quantizer.quantize(flat, uniforms=uniforms)

    def unquantize(self, q, n_elements=None, n_clients=None):
        return self.quantizer.unquantize(q, n_elements, n_clients)

    def normalize(self, flat):
        return self.quantizer.normalize(flat)

    def unnormalize(self, flat):
        return self.quantizer.unnormalize(flat)

    def prepare_encrypt(self):
        if self.precompute:
            self.cipher.prepare_encrypt()

    def prepare_decrypt(self):
        if self.precompute:
            self.cipher.prepare_decrypt()

    def dynamic_masking(self, suffix) -> dict:
        """The arbiter's masking broadcast of a sparsified round; the
        round's core installs it (`client_masking`)."""
        return self._from_arbiter.get(idx=0, suffix=suffix + ("choice",))

    def _finish_setup(self):
        self.quantizer = QuantizingClient(
            self.int_bits, self.batch, self.element_bits, self.padding,
            self.secure, seed=self.cipher.idx, device=self.device)
        num_clients = _keywrap.receive_num_clients(self._from_arbiter)
        self.quantizer.set_num_clients(num_clients)
        self.cipher.set_num_clients(num_clients)
        if self.local_lane_shards is not None:
            self.cipher.set_local_devices(self.local_lane_shards)
        if self.precompute and self.num_params is not None:
            self.cipher.set_num_params(self.num_params)
            self.cipher.prepare_encrypt()  # round-0 bootstrap, a no-op


class Guest(_Client):
    def register_flashe_cipher(self, transfer_variables):
        t = transfer_variables
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
        exchanged_keys = self.key_exchange(uuid)
        self.cipher = self._new_cipher(uuid, exchanged_keys)
        self.cipher.generate_prp_seed()
        self._to_arbiter.remote(
            obj=_keywrap.guest_wrap_for_hosts(exchanged_keys,
                                              self.cipher.get_prp_seed()),
            role=consts.ARBITER, idx=0, suffix=("seed",))
        self._finish_setup()
        return self


class Host(_Client):
    def register_flashe_cipher(self, transfer_variables):
        t = transfer_variables
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
        exchanged_keys = self.key_exchange(uuid)
        self.cipher = self._new_cipher(uuid, exchanged_keys)
        wrapped = self._from_arbiter.get(idx=0, suffix=("seed",))
        self.cipher.generate_prp_seed(assigned_seed=_keywrap.host_unwrap(
            exchanged_keys, self.cipher.get_guest_uuid(), wrapped))
        self._finish_setup()
        return self
