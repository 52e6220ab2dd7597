"""Plaintext aggregation block (port of flashe_tpu/protocol/blocks/plain.py;
reference jzf_plain_block.py).

No cipher: only the quantizer (when `quantize` is configured) and the
num_clients broadcast.  Used for the plaintext baselines (cnn_plain,
cnn_plain_q16_pad, ...).  A client block's encrypt and decrypt return their
lanes, so that the round runs the same cores as the ciphers' blocks.
"""

from __future__ import annotations

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.protocol.blocks import _keywrap
from flashe_tpu_torch.quant.quantizer import QuantizingArbiter, QuantizingClient

__all__ = ["Arbiter", "Guest", "Host"]


class Arbiter:
    def __init__(self, args, device="cuda"):
        self.device = resolve_device(device)
        self.args = args or {}
        q = self.args.get("quantize")
        self.has_quantize = q is not None
        self.int_bits = q["int_bits"] if q else None
        self.wire_int_bits = self.int_bits
        self.quantizer = None
        self._trv = None

    def register_plain_cipher(self, transfer_variables):
        self._trv = transfer_variables
        return self

    def create_quantizer(self):
        n_hosts = len(self._trv.federation.roles_to_parties([consts.HOST]))
        client_cnt = 1 + n_hosts
        if self.has_quantize:
            q = self.args["quantize"]
            self.quantizer = QuantizingArbiter(
                q["int_bits"], q["batch"], q["element_bits"], q["secure"])
            self.quantizer.set_num_clients(client_cnt)
        _keywrap.broadcast_num_clients(self._trv, client_cnt)
        return self

    def set_iter_index(self, iter_index):
        if self.quantizer is not None:
            self.quantizer.set_iter(iter_index)

    def help_quantize(self):
        return None

    def dynamic_masking(self, masks, total, suffix):
        return None


class _Client:
    scheme = "plain"

    def __init__(self, args, device="cuda"):
        self.device = resolve_device(device)
        self.args = args or {}
        q = self.args.get("quantize")
        self.has_quantize = q is not None
        self.int_bits = q["int_bits"] if q else None
        self.wire_int_bits = self.int_bits
        self.quantizer = None
        self.num_clients = None
        self._to_arbiter = None
        self._from_arbiter = None

    def _create(self, seed):
        num_clients = _keywrap.receive_num_clients(self._from_arbiter)
        if self.has_quantize:
            q = self.args["quantize"]
            self.quantizer = QuantizingClient(
                q["int_bits"], q["batch"], q["element_bits"],
                q.get("padding", True), q["secure"], seed=seed,
                device=self.device)
            self.quantizer.set_num_clients(num_clients)
        self.num_clients = num_clients
        return self

    def set_codec(self, codec):
        if self.quantizer is not None:
            self.quantizer.set_codec(codec)

    def set_iter_index(self, iter_index):
        if self.quantizer is not None:
            self.quantizer.set_iter(iter_index)

    def quantize(self, flat, uniforms=None):
        return (self.quantizer.quantize(flat, uniforms=uniforms)
                if self.quantizer else flat)

    def unquantize(self, q, n_elements=None, n_clients=None):
        return (self.quantizer.unquantize(q, n_elements, n_clients)
                if self.quantizer else q)

    def normalize(self, flat):
        return self.quantizer.normalize(flat) if self.quantizer else flat

    def unnormalize(self, flat):
        return self.quantizer.unnormalize(flat) if self.quantizer else flat

    def encrypt(self, lanes):
        return lanes

    def decrypt(self, lanes, idx_list=None):
        return lanes

    def prepare_encrypt(self):
        pass

    def prepare_decrypt(self):
        pass

    def dynamic_masking(self, suffix):
        return None

    def get_idx_list(self):
        return None


class Guest(_Client):
    def register_plain_cipher(self, transfer_variables):
        self._to_arbiter = transfer_variables.guest_to_arbiter
        self._from_arbiter = transfer_variables.arbiter_to_guest
        return self

    def create_quantizer(self):
        return self._create(seed=0)


class Host(_Client):
    def register_plain_cipher(self, transfer_variables):
        self._to_arbiter = transfer_variables.host_to_arbiter
        self._from_arbiter = transfer_variables.arbiter_to_host
        return self

    def create_quantizer(self):
        return self._create(seed=1)
