"""The secure-aggregation engine (port of flashe_tpu/protocol/aggregator.py).

Transport-free cores of the round, for every scheme of the JAX package
(FLASHE, Paillier, BFV, CKKS, the additive random pads, plain):

    client_upload   -- Client.secure_aggregate, dense branch: scale by the
                       degree, normalize, quantize, encrypt;
    client_select   -- its sparse branch up to the arbiter's round trip:
                       scale, delta from the last global model, top-s%
                       selection, the encoded locations to send;
    client_upload_sparse -- the rest of it: install the arbiter's masking
                       broadcast (FLASHE), normalize and quantize the
                       compacted values at their locations, encrypt, append
                       the quantized zero that fills the unselected
                       positions (in plaintext; a ciphertext for Paillier);
    arbiter_reduce  -- Arbiter._reduce: the mod-2^m sum of FLASHE or
                       quantized plain lanes, the float sum of plain ones
                       and of the additive scheme's padded ones, or an
                       arbiter block's add_ciphertexts (Paillier's product
                       mod n^2, the residue sums of BFV and CKKS); sparse
                       uploads are first densified with each client's
                       filler;
    client_download -- Client.get_aggregated_model: decrypt (FLASHE over the
                       survivors' idx list; Paillier, BFV and CKKS the
                       aggregate's n_elements values), unquantize with the
                       number of summands, divide by the degree,
                       unnormalize, and after a sparse round add the last
                       global model back.

The sparse upload is two calls because the dynamic masking choice needs
every client's locations before any client encrypts: between them the
arbiter decides (protocol/blocks/flashe.py::arbiter_masking).  Sparse
rounds run under FLASHE, Paillier and plain only (runtime/config.py).

A client `block` has a `scheme`, a `.quantizer`, and set_iter_index /
normalize / quantize / encrypt / decrypt / unquantize / unnormalize /
get_idx_list: ClientBlock wraps a FlasheCipher and a QuantizingClient for
the cores alone, and protocol/blocks/{flashe,paillier,bfv,ckks,additive,
plain}.py hold the session blocks.

Around the cores, the roles over a federation (reference
jzf_aggregator.py): `with_role` builds a Guest, Host or Arbiter, whose
block runs the session setup (uuid sync, DH, the wrapped seed or key).

Client round (jzf_aggregator.py:673-828):
  [sparsify + location upload + masking broadcast] -> client_upload(_sparse)
  -> upload handshake -> download -> client_download

Arbiter round (jzf_aggregator.py:220-544):
  [collect masks + masking broadcast] -> flow-controlled collect ->
  arbiter_reduce -> dispatch with per-party ACKs.

Flow-control modes mirror the reference: mode='parallel' collects everyone
concurrently (with per-partition barriers when num_partitions > 1, needed
for Paillier's ciphertext inflation); mode='serial' polls one client at a
time with allow_upload grants.  With upload_timeout_s a host that misses
its deadline is dropped for the round and answered with a dropped frame
that carries the aggregate, so it keeps its quantizer statistics in step
and rejoins at the next round.

In memory, uploads and the aggregate pass by reference and stay on the
card; over TCP they arrive as host numpy (protocol/payload.py), and each
role moves what it receives onto its own device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.fed import consts
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops.lanes import as_u32, lane_add, nlimbs_for, to_i32
from flashe_tpu_torch.protocol import loss_sync
from flashe_tpu_torch.protocol.blocks import additive as additive_block
from flashe_tpu_torch.protocol.blocks import bfv as bfv_block
from flashe_tpu_torch.protocol.blocks import ckks as ckks_block
from flashe_tpu_torch.protocol.blocks import flashe as flashe_block
from flashe_tpu_torch.protocol.blocks import paillier as paillier_block
from flashe_tpu_torch.protocol.blocks import plain as plain_block
from flashe_tpu_torch.protocol.blocks.flashe import client_masking
from flashe_tpu_torch.protocol.payload import (
    ModelPayload, merge_lane_parts, partition_lanes)
from flashe_tpu_torch.protocol.sparsify import (
    Sparsifier, SparsifyResult, decode_locations, encode_locations)
from flashe_tpu_torch.quant.quantizer import QuantizingClient
from flashe_tpu_torch.runtime.tracking import phase, set_round

__all__ = ["ClientBlock", "Upload", "Selection", "client_upload",
           "client_select", "client_upload_sparse", "arbiter_reduce",
           "client_download", "Arbiter", "Client", "Guest", "Host",
           "with_role", "LossPayload", "is_dropped_marker", "to_device"]

# the schemes whose arbiter block adds ciphertexts, and whose client
# decrypts the aggregate's n_elements values
_CIPHERTEXT_SCHEMES = ("paillier", "bfv", "ckks")


# ---------------------------------------------------------------------------
# transport-free cores
# ---------------------------------------------------------------------------

@dataclass
class ClientBlock:
    cipher: FlasheCipher
    quantizer: QuantizingClient
    scheme = "flashe"

    def set_iter_index(self, iter_index: int):
        self.cipher.set_iter_index(iter_index)
        self.quantizer.set_iter(iter_index)

    def normalize(self, flat: torch.Tensor) -> torch.Tensor:
        return self.quantizer.normalize(flat)

    def quantize(self, flat: torch.Tensor, uniforms=None) -> torch.Tensor:
        return self.quantizer.quantize(flat, uniforms=uniforms)

    def unquantize(self, q, n_elements=None, n_clients=None):
        return self.quantizer.unquantize(q, n_elements, n_clients)

    def unnormalize(self, flat: torch.Tensor) -> torch.Tensor:
        return self.quantizer.unnormalize(flat)

    def encrypt(self, q: torch.Tensor) -> torch.Tensor:
        return self.cipher.encrypt(q)

    def decrypt(self, lanes: torch.Tensor, idx_list) -> torch.Tensor:
        return self.cipher.decrypt(lanes, idx_list)

    def get_idx_list(self):
        return self.cipher.get_idx_list()


class Upload(NamedTuple):
    # ciphertext or plain lanes, Paillier's object ints, or BFV's and
    # CKKS's (B, 2, k, N) residues
    lanes: object
    n_elements: int
    degree: float
    idx_list: list
    locations: dict | None = None  # a sparse upload's encoded locations


class Selection(NamedTuple):
    result: SparsifyResult
    encoded: dict  # encode_locations of result.locations, for the arbiter
    degree: float


def client_upload(block, codec: WeightsCodec, flat: torch.Tensor,
                  iter_index: int, degree=None,
                  uniforms: torch.Tensor | None = None) -> Upload:
    """One client's dense upload.  `uniforms` feeds the stochastic rounding
    (drawn from the quantizer's generator when None)."""
    if degree:
        flat = flat * degree
    else:
        degree = 1.0
    block.set_iter_index(iter_index)
    with phase("encoding"):
        q = block.quantize(block.normalize(flat), uniforms=uniforms)
    with phase("encryption"):
        enc = block.encrypt(q)
    return Upload(enc, codec.total, degree, block.get_idx_list())


def client_select(block, sparsifier: Sparsifier, flat: torch.Tensor,
                  before: torch.Tensor, degree=None) -> Selection:
    """A sparse upload up to the arbiter's round trip: scale by the degree,
    select the top-s% of the delta from `before` (the last global model)
    with the residual memory, and record the total in a FLASHE cipher.  The
    selection's encoded locations go to the arbiter."""
    if degree:
        flat = flat * degree
    else:
        degree = 1.0
    res = sparsifier.sparsify(flat - before)
    if block.scheme == "flashe":
        block.cipher.total = res.total
    return Selection(res, encode_locations(res.locations, res.total), degree)


def client_upload_sparse(block, selection: Selection, broadcast: dict | None,
                         iter_index: int,
                         uniforms: torch.Tensor | None = None,
                         zero_u: float | None = None) -> Upload:
    """The rest of a sparse upload, once the arbiter's masking broadcast
    is in (FLASHE; None for the other schemes): install it, normalize and
    quantize the compacted values with their layers' scalars, encrypt them
    (for FLASHE one launch, compact counters from 0) and append the
    quantized zero that fills the unselected positions: in plaintext, or
    for Paillier encrypted.  `uniforms` and `zero_u` feed the two
    stochastic roundings (the quantizer's generator when None)."""
    res = selection.result
    block.set_iter_index(iter_index)
    if broadcast is not None:
        client_masking(block.cipher, broadcast)
    quant = block.quantizer
    with phase("encoding"):
        values = quant.normalize_gather(res.values, res.locations)
        q = quant.quantize_gather(values, res.locations, uniforms=uniforms)
    zero = torch.tensor([quant.quantized_zero(zero_u)], dtype=q.dtype,
                        device=q.device)
    with phase("encryption"):
        if block.scheme == "paillier":  # one batch, the zero last
            lanes = block.encrypt(torch.cat([q, zero]))
        else:
            lanes = torch.cat([block.encrypt(q), zero])
    return Upload(lanes, int(res.locations.shape[0]), selection.degree,
                  block.get_idx_list(), selection.encoded)


def _densify(lanes, loc, total: int):
    """A sparse upload on the dense lanes: its filler everywhere, its
    ciphertexts at its locations (a tensor on its device, or an object
    array of Paillier ciphertexts on the host)."""
    if isinstance(lanes, np.ndarray):
        dense = np.full(total, lanes[-1], dtype=lanes.dtype)
        dense[np.asarray(loc, dtype=np.int64)] = lanes[:-1]
        return dense
    dense = lanes[-1:].repeat(total)
    dense[torch.as_tensor(loc, dtype=torch.int64, device=lanes.device)] = \
        lanes[:-1]
    return dense


def arbiter_reduce(lanes_list, int_bits: int | None = None, block=None,
                   masks=None, total: int | None = None):
    """The aggregate of the clients' uploads.  With `masks` (each upload's
    locations, in the uploads' order) the uploads are sparse: each is first
    expanded to `total` lanes by `_densify`.  Then, with the arbiter
    `block` of a Paillier, BFV or CKKS session, its add_ciphertexts; else
    with int_bits the sum mod 2^int_bits as int32 lanes (up to 32 bits the
    sum runs in int64 and is masked and cast back); else (plain or padded
    float lanes) the float sum."""
    if masks is not None:
        lanes_list = [_densify(lanes, loc, total)
                      for lanes, loc in zip(lanes_list, masks)]
    if block is not None:
        return block.add_ciphertexts(list(lanes_list))
    if int_bits is None:
        return functools.reduce(lambda x, y: x + y, lanes_list)
    if nlimbs_for(int_bits) > 1:
        acc = lanes_list[0]
        for a in lanes_list[1:]:
            acc = lane_add(acc, a, int_bits)
        return acc
    acc = as_u32(lanes_list[0])
    for a in lanes_list[1:]:
        acc += as_u32(a)
    return to_i32(acc & ((1 << int_bits) - 1))


def client_download(block, lanes, idx_list, n_elements: int,
                    degrees: float, degree=None,
                    before: torch.Tensor | None = None) -> torch.Tensor:
    """Decrypt the aggregate of the clients in idx_list and decode it into
    the new global flat vector.  degrees is the survivors' total degree,
    degree this client's own (1.0 when None).  An aggregate of the other
    schemes has no idx_list (None): it is decoded with the registered
    client count, and Paillier, BFV and CKKS decrypt its n_elements
    values.  After a sparse round n_elements is the total and
    `before`, the last global model, is added back to the decoded mean
    delta."""
    degree = degree or 1.0
    with phase("decryption"):
        if block.scheme in _CIPHERTEXT_SCHEMES:
            lanes = block.decrypt(lanes, n_elements)
        else:
            lanes = block.decrypt(lanes, idx_list)
    n_summed = len(idx_list) if idx_list else None
    with phase("decoding"):
        flat = block.unquantize(lanes, n_elements, n_summed)
        flat = flat / (degrees / degree)
        flat = block.unnormalize(flat) / degree
    return flat if before is None else flat + before


def to_device(lanes, device: torch.device):
    """What a role received, on its device: tensors moved there, host
    numpy lanes (uint32 bit patterns, or floats) made tensors there;
    object arrays (Paillier ciphertexts) stay on the host."""
    if isinstance(lanes, torch.Tensor):
        return lanes.to(device)
    arr = np.asarray(lanes)
    if arr.dtype == object:
        return arr
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# ---------------------------------------------------------------------------
# the roles over a federation
# ---------------------------------------------------------------------------

_DROPPED_KEY = "__flashe_dropped__"


def _dropped_marker(iter_index, payload=None) -> dict:
    """Control frame sent to a host that missed the upload deadline.

    The arbiter answers every channel the slow host blocks on, so a
    slow-but-alive host unblocks immediately and rejoins at round r+1 (the
    arbiter re-collects from all registered hosts every round).

    The frame carries the aggregated payload when available: FLASHE
    decryption needs only the survivor idx-list, so a dropped host can
    still install the survivors' global model.  That is required for
    rejoining: the secure quantizer derives each round's clip threshold
    from running statistics of the previous global model
    (jzf_quantize.py:394-424), and a host that skipped a global update
    would quantize its next upload on a different alpha scale, corrupting
    the aggregate for every participant."""
    return {_DROPPED_KEY: int(iter_index), "payload": payload}


def is_dropped_marker(obj) -> bool:
    return isinstance(obj, dict) and _DROPPED_KEY in obj


class LossPayload:
    """NumericWeights stand-in for the loss channel (jzf_weights.py:372-394)."""

    def __init__(self, value: float, degree: Optional[float] = None):
        self.unboxed = float(value)
        self._degree = degree

    def get_degree(self, default=None):
        return self._degree if self._degree is not None else default


_SCHEMES = {
    "flashe": (flashe_block, "register_flashe_cipher", "create_cipher"),
    "plain": (plain_block, "register_plain_cipher", "create_quantizer"),
    "paillier": (paillier_block, "register_paillier_cipher",
                 "create_cipher"),
    "bfv": (bfv_block, "register_bfv_cipher", "create_cipher"),
    "ckks": (ckks_block, "register_ckks_cipher", "create_cipher"),
    "additive": (additive_block, "register_additive_mask_cipher",
                 "create_cipher"),
}


def _make_block(role, secure_aggregate, args, transfer_variables,
                device="cuda"):
    if secure_aggregate not in _SCHEMES:
        raise ValueError(f"unknown secure_aggregate scheme {secure_aggregate}")
    mod, reg, create = _SCHEMES[secure_aggregate]
    cls = {"guest": mod.Guest, "host": mod.Host, "arbiter": mod.Arbiter}[role]
    block = cls(args, device)
    getattr(block, reg)(transfer_variables)
    return getattr(block, create)()


def _default_args(args):
    return args or {"mode": "parallel", "num_partitions": 1}


class Arbiter:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.sparsity = 1.0
        self.secure_aggregate = None
        self.secure_aggregate_args = None
        self._block = None
        self._loss_sync = None
        self._converge_sync = None
        self._trv = None
        self.num_hosts = None
        self.dropped_hosts = []

    def register_aggregator(self, transfer_variables, sparsity=1.0,
                            secure_aggregate="plain",
                            secure_aggregate_args=None):
        self.sparsity = sparsity
        self.secure_aggregate = secure_aggregate
        self.secure_aggregate_args = _default_args(secure_aggregate_args)
        self._trv = transfer_variables
        self.num_hosts = len(
            transfer_variables.federation.roles_to_parties([consts.HOST]))
        self._block = _make_block("arbiter", secure_aggregate,
                                  secure_aggregate_args, transfer_variables,
                                  self.device)
        self._loss_sync = loss_sync.LossArbiter().register_loss_transfer(
            host_loss_transfer=transfer_variables.host_loss,
            guest_loss_transfer=transfer_variables.guest_loss)
        self._converge_sync = loss_sync.ConvergeArbiter().register_is_converge(
            is_converge_variable=transfer_variables.is_converge)
        return self

    # -- collection --------------------------------------------------------

    def _collect(self, suffix):
        """Flow-controlled upload collection (jzf_aggregator.py:248-361)."""
        t = self._trv
        mode = self.secure_aggregate_args.get("mode", "parallel")
        nparts = self.secure_aggregate_args.get("num_partitions", 1)
        timeout = self.secure_aggregate_args.get("upload_timeout_s")
        payloads = []
        self.dropped_hosts = []

        if mode == "parallel" and nparts > 1:
            # per-partition barrier with per-host deadlines: a host that
            # misses its slot for any partition is dropped for the round
            # (its earlier parts are discarded) and notified on the
            # upload_result channel it blocks on next
            guest_parts = []
            host_parts = {h: [] for h in range(self.num_hosts)}
            for p in range(nparts):
                t.arbiter_to_guest.remote(obj="allow_upload", role=consts.GUEST,
                                          idx=0, suffix=suffix + ("allow_upload", p))
                for h in range(self.num_hosts):
                    if h in self.dropped_hosts:
                        continue
                    t.arbiter_to_host.remote(
                        obj="allow_upload", role=consts.HOST, idx=h,
                        suffix=suffix + ("allow_upload", p))
                guest_parts.append(
                    t.guest_to_arbiter.get(idx=0, suffix=suffix + ("upload_model", p)))
                for h in range(self.num_hosts):
                    if h in self.dropped_hosts:
                        continue
                    try:
                        host_parts[h].append(t.host_to_arbiter.get(
                            idx=h, suffix=suffix + ("upload_model", p),
                            timeout=timeout if timeout else 600.0))
                    except TimeoutError:
                        if not timeout:
                            raise
                        self.dropped_hosts.append(h)
                        host_parts.pop(h)
                        t.arbiter_to_host.remote(
                            obj=_dropped_marker(p), role=consts.HOST, idx=h,
                            suffix=suffix + ("upload_result", p))
                t.arbiter_to_guest.remote(obj="finish", role=consts.GUEST,
                                          idx=0, suffix=suffix + ("upload_result", p))
                for h in range(self.num_hosts):
                    if h in self.dropped_hosts:
                        continue
                    t.arbiter_to_host.remote(
                        obj="finish", role=consts.HOST, idx=h,
                        suffix=suffix + ("upload_result", p))
            payloads = [merge_lane_parts(guest_parts)] + [
                merge_lane_parts(host_parts[h])
                for h in range(self.num_hosts) if h not in self.dropped_hosts]
        elif mode == "parallel":
            # optional dropout tolerance: a host that misses the upload
            # deadline is dropped from this round; FLASHE's double masking
            # keeps the survivors' aggregate decryptable via the run-merged
            # idx list
            payloads.append(
                t.guest_to_arbiter.get(idx=0, suffix=suffix + ("upload_model", 0)))
            for h in range(self.num_hosts):
                try:
                    payloads.append(t.host_to_arbiter.get(
                        idx=h, suffix=suffix + ("upload_model", 0),
                        timeout=timeout if timeout else 600.0))
                except TimeoutError:
                    if not timeout:
                        raise
                    self.dropped_hosts.append(h)
        else:  # serial: one party at a time
            t.arbiter_to_guest.remote(obj="allow_upload", role=consts.GUEST,
                                      idx=0, suffix=suffix + ("allow_upload",))
            payloads.append(
                t.guest_to_arbiter.get(idx=0, suffix=suffix + ("upload_model", 0)))
            t.arbiter_to_guest.remote(obj="finish", role=consts.GUEST,
                                      idx=0, suffix=suffix + ("upload_result", 0))
            for h in range(self.num_hosts):
                t.arbiter_to_host.remote(obj="allow_upload", role=consts.HOST,
                                         idx=h, suffix=suffix + ("allow_upload",))
                payloads.append(
                    t.host_to_arbiter.get(idx=h, suffix=suffix + ("upload_model", 0)))
                t.arbiter_to_host.remote(obj="finish", role=consts.HOST,
                                         idx=h, suffix=suffix + ("upload_result", 0))
        return [p.unpack() for p in payloads]

    # -- reduction ---------------------------------------------------------

    def _reduce(self, payloads, masks=None, total=None):
        """Scheme-specific reduce (jzf_aggregator.py:386-450), through
        arbiter_reduce, on the arbiter's device."""
        arrays = [to_device(p.lanes, self.device) for p in payloads]
        if self.secure_aggregate in _CIPHERTEXT_SCHEMES:
            return arbiter_reduce(arrays, block=self._block, masks=masks,
                                  total=total)
        return arbiter_reduce(arrays, payloads[0].int_bits, masks=masks,
                              total=total)

    def aggregate_model(self, iter_index, suffix=tuple()):
        set_round(iter_index)
        self._block.set_iter_index(iter_index)
        self._block.help_quantize()

        masks = None
        total = None
        if self.sparsity != 1.0:
            t = self._trv
            host_objs = t.host_to_arbiter.get(idx=-1, suffix=suffix + ("mask",))
            guest_obj = t.guest_to_arbiter.get(idx=0, suffix=suffix + ("mask",))
            masks = [decode_locations(guest_obj)] + [
                decode_locations(o) for o in host_objs]
            total = guest_obj["total"]
            self._block.dynamic_masking(masks, total, suffix)

        with phase("collect"):
            payloads = self._collect(suffix)
        degrees = [p.degree for p in payloads]
        idx_lists = [p.idx_list for p in payloads]
        total_degree = float(np.sum([d for d in degrees if d is not None]))
        if masks is not None and self.dropped_hosts:
            masks = [masks[0]] + [m for h, m in enumerate(masks[1:])
                                  if h not in self.dropped_hosts]

        with phase("aggregate"):
            acc = self._reduce(payloads, masks, total)

        if self.secure_aggregate == "flashe":
            total_idx_list = functools.reduce(
                lambda x, y: x + y, [il for il in idx_lists if il])
        else:
            total_idx_list = None

        out = ModelPayload(
            lanes=acc,
            n_elements=total if masks is not None else payloads[0].n_elements,
            int_bits=payloads[0].int_bits,
            degree=total_degree,
            idx_list=total_idx_list,
        )
        return out, total_degree, total_idx_list

    def aggregate_and_broadcast(self, iter_index, suffix=tuple()):
        model, total_degree, total_idx_list = self.aggregate_model(
            iter_index=iter_index, suffix=suffix)
        t = self._trv
        mode = self.secure_aggregate_args.get("mode", "parallel")
        nparts = self.secure_aggregate_args.get("num_partitions", 1)

        dropped = self.dropped_hosts
        with phase("dispatch"):
            if mode == "parallel" and nparts > 1:
                parts = partition_lanes(model, nparts)
                for p, part in enumerate(parts):
                    part.degree = total_degree
                    part.idx_list = total_idx_list
                    part.n_elements = model.n_elements
                    t.arbiter_to_guest.remote(part, role=consts.GUEST, idx=0,
                                              suffix=suffix + ("agg_model", p))
                    for h in range(self.num_hosts):
                        # dropped hosts get the same parts, wrapped in the
                        # dropped frame; their ACKs are not awaited (they
                        # may be dead, and a live one needs no flow
                        # control for a model it only reads)
                        t.arbiter_to_host.remote(
                            part if h not in dropped
                            else _dropped_marker(iter_index, part),
                            role=consts.HOST, idx=h,
                            suffix=suffix + ("agg_model", p))
                    t.guest_to_arbiter.get(idx=0, suffix=suffix + ("dispatch_result", p))
                    for h in range(self.num_hosts):
                        if h in dropped:
                            continue
                        t.host_to_arbiter.get(
                            idx=h, suffix=suffix + ("dispatch_result", p))
            else:
                t.arbiter_to_guest.remote(model, role=consts.GUEST, idx=0,
                                          suffix=suffix + ("agg_model", 0))
                t.guest_to_arbiter.get(idx=0, suffix=suffix + ("dispatch_result", 0))
                for h in range(self.num_hosts):
                    t.arbiter_to_host.remote(
                        model if h not in dropped
                        else _dropped_marker(iter_index, model),
                        role=consts.HOST, idx=h,
                        suffix=suffix + ("agg_model", 0))
                    if h in dropped:
                        continue
                    t.host_to_arbiter.get(
                        idx=h, suffix=suffix + ("dispatch_result", 0))
        return model

    def aggregate_loss(self, idx=None, suffix=tuple()):
        if idx is None and self.dropped_hosts:
            idx = [h for h in range(self.num_hosts)
                   if h not in self.dropped_hosts]
        losses = self._loss_sync.get_losses(idx=idx, suffix=suffix)
        total_loss, total_degree = 0.0, 0.0
        for loss in losses:
            total_loss += loss.unboxed
            total_degree += loss.get_degree(1.0)
        return total_loss / total_degree

    def send_converge_status(self, converge_func, converge_args,
                             suffix=tuple()):
        return self._converge_sync.check_converge_status(
            converge_func=converge_func, converge_args=converge_args,
            suffix=suffix)


class Client:
    """A client's side of the round; Guest and Host wire its channels."""

    _role = None  # "guest" or "host"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._block = None
        self._loss_sync = None
        self._converge_sync = None
        self._sparsity = 1.0
        self._sparsifier: Optional[Sparsifier] = None
        self._secure_aggregate = "plain"
        self._secure_aggregate_args = None
        self.codec = None
        self.degree = None
        self.weights_last_round = None
        self.to_arbiter = None
        self.from_arbiter = None
        # set by get_aggregated_model: True when the arbiter dropped this
        # client's upload for the round (the model it returns is still the
        # valid survivors' aggregate; only loss reporting is skipped)
        self.was_dropped = False

    def register_aggregator(self, transfer_variables, sparsity=1.0,
                            secure_aggregate="plain",
                            secure_aggregate_args=None):
        t = transfer_variables
        self._sparsity = sparsity
        self._secure_aggregate = secure_aggregate
        self._secure_aggregate_args = _default_args(secure_aggregate_args)
        self._block = _make_block(self._role, secure_aggregate,
                                  secure_aggregate_args, t, self.device)
        self._loss_sync = loss_sync.LossClient().register_loss_transfer(
            loss_transfer=getattr(t, f"{self._role}_loss"))
        self._converge_sync = loss_sync.ConvergeClient().register_is_converge(
            is_converge_variable=t.is_converge)
        self.from_arbiter = getattr(t, f"arbiter_to_{self._role}")
        self.to_arbiter = getattr(t, f"{self._role}_to_arbiter")
        return self

    def set_codec(self, codec):
        self.codec = codec
        self._block.set_codec(codec)
        if self._sparsity != 1.0:
            self._sparsifier = Sparsifier(codec, self._sparsity)

    # -- upload ------------------------------------------------------------

    def _upload(self, payload: ModelPayload, suffix):
        t_to, t_from = self.to_arbiter, self.from_arbiter
        mode = self._secure_aggregate_args.get("mode", "parallel")
        nparts = self._secure_aggregate_args.get("num_partitions", 1)
        wire_pack = self._secure_aggregate_args.get("wire_pack", False)

        def maybe_pack(p):
            return p.pack() if wire_pack else p

        with phase("upload"):
            if mode == "parallel" and nparts > 1:
                parts = partition_lanes(payload, nparts)
                for p, part in enumerate(parts):
                    if is_dropped_marker(
                        t_from.get(idx=0, suffix=suffix + ("allow_upload", p))
                    ):
                        return False
                    t_to.remote(obj=maybe_pack(part), role=consts.ARBITER,
                                idx=0, suffix=suffix + ("upload_model", p))
                    if is_dropped_marker(
                        t_from.get(idx=0, suffix=suffix + ("upload_result", p))
                    ):
                        return False
            elif mode == "parallel":
                t_to.remote(obj=maybe_pack(payload), role=consts.ARBITER,
                            idx=0, suffix=suffix + ("upload_model", 0))
            else:
                t_from.get(idx=0, suffix=suffix + ("allow_upload",))
                t_to.remote(obj=maybe_pack(payload), role=consts.ARBITER,
                            idx=0, suffix=suffix + ("upload_model", 0))
                t_from.get(idx=0, suffix=suffix + ("upload_result", 0))
        return True

    def secure_aggregate(self, flat, before=None, iter_index=0,
                         suffix=tuple(), degree=None):
        """Model upload path (jzf_aggregator.py:673-807), through the
        cores: client_upload, or client_select, the masking broadcast and
        client_upload_sparse."""
        flat = to_device(flat, self.device)
        if self._sparsity != 1.0:
            before = to_device(before, self.device)
            self.weights_last_round = before
            sel = client_select(self._block, self._sparsifier, flat, before,
                                degree)
            self.to_arbiter.remote(obj=sel.encoded, role=consts.ARBITER,
                                   idx=0, suffix=suffix + ("mask",))
            broadcast = self._block.dynamic_masking(suffix)
            up = client_upload_sparse(self._block, sel, broadcast, iter_index)
        else:
            up = client_upload(self._block, self.codec, flat, iter_index,
                               degree)
        self.degree = up.degree
        payload = ModelPayload(
            lanes=up.lanes, n_elements=up.n_elements,
            int_bits=self._block.wire_int_bits, degree=up.degree,
            idx_list=up.idx_list)
        return self._upload(payload, suffix)

    def send_model(self, flat, before, iter_index, degree=None,
                   suffix=tuple()):
        return self.secure_aggregate(flat, before=before,
                                     iter_index=iter_index, suffix=suffix,
                                     degree=degree)

    def aggregate_then_get(self, flat, iter_index, before=None, degree=None,
                           suffix=tuple()):
        """One round: upload, download.

        Returns the new global flat vector, or None if the arbiter dropped
        this client for the round and sent no aggregate; a host dropped
        mid-upload still downloads, since the dropped frames carry the
        aggregate (see _dropped_marker)."""
        set_round(iter_index)
        self.send_model(flat=flat, before=before, iter_index=iter_index,
                        degree=degree, suffix=suffix)
        if self._secure_aggregate == "flashe":
            # no-ops in the port: the kernel makes the masks in the launch
            self._block.prepare_decrypt()
            self._block.prepare_encrypt()
        return self.get_aggregated_model(suffix=suffix)

    # -- download ----------------------------------------------------------

    def get_aggregated_model(self, suffix=tuple()):
        t_to, t_from = self.to_arbiter, self.from_arbiter
        mode = self._secure_aggregate_args.get("mode", "parallel")
        nparts = self._secure_aggregate_args.get("num_partitions", 1)

        self.was_dropped = False
        with phase("download"):
            if mode == "parallel" and nparts > 1:
                parts = []
                for p in range(nparts):
                    part = t_from.get(idx=0, suffix=suffix + ("agg_model", p))
                    if is_dropped_marker(part):
                        self.was_dropped = True
                        part = part["payload"]
                        if part is None:
                            return None
                    else:
                        t_to.remote(obj="finish", role=consts.ARBITER, idx=0,
                                    suffix=suffix + ("dispatch_result", p))
                    parts.append(part)
                payload = merge_lane_parts(parts)
            else:
                payload = t_from.get(idx=0, suffix=suffix + ("agg_model", 0))
                if is_dropped_marker(payload):
                    self.was_dropped = True
                    payload = payload["payload"]
                    if payload is None:
                        return None
                else:
                    t_to.remote(obj="finish", role=consts.ARBITER, idx=0,
                                suffix=suffix + ("dispatch_result", 0))
        payload = payload.unpack()
        before = self.weights_last_round if self._sparsity != 1.0 else None
        return client_download(
            self._block, to_device(payload.lanes, self.device),
            payload.idx_list, payload.n_elements, payload.degree,
            self.degree, before)

    # -- loss / convergence ------------------------------------------------

    def send_loss(self, loss, degree=None, suffix=tuple()):
        self._loss_sync.send_loss(LossPayload(loss, degree), suffix)

    def get_converge_status(self, suffix=tuple()):
        return self._converge_sync.get_converge_status(suffix=suffix)


class Guest(Client):
    _role = consts.GUEST


class Host(Client):
    _role = consts.HOST


def with_role(role, transfer_variable, sparsity=1.0,
              secure_aggregate="plain", secure_aggregate_args=None,
              device="cuda"):
    """Factory matching the reference entry point (jzf_aggregator.py:1038);
    the role and its block run on `device`."""
    cls = {consts.GUEST: Guest, consts.HOST: Host,
           consts.ARBITER: Arbiter}.get(role)
    if cls is None:
        raise ValueError(f"role {role} not found")
    return cls(device).register_aggregator(transfer_variable, sparsity,
                                           secure_aggregate,
                                           secure_aggregate_args)
