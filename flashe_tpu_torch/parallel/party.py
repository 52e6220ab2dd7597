"""A federated party that owns several devices (port of
flashe_tpu/parallel/party.py).

The reference spreads one silo's crypto over its CPU cores with a
`multiprocessing.Pool` over contiguous index chunks
(federatedml/secureprotol/jzf_flashe.py:436-447).  Here the protocol path
stays as it is, while each party's encrypt and decrypt split its lane
vector over its local devices: every shard is one mask launch on its
device at the counter offset of its first block (parallel/sharded.py), so
the sharded ciphertext is the single-device one, bit for bit.  The sparse
decrypt fans out by client instead (`sparse_decrypt_fanout`).

This is the scaling story of the JAX package (1 card -> 1 host -> N hosts
per party): a silo with 4 cards encrypts on all four and speaks the same
wire protocol.  A host with one card may still give a party a mesh of
that card repeated, which runs the same launches one after another.
"""

from __future__ import annotations

import torch

from flashe_tpu_torch.device import resolve_devices
from flashe_tpu_torch.ops.flashe_mask import mask_apply, mask_scatter
from flashe_tpu_torch.ops.lanes import lane_add
from flashe_tpu_torch.parallel.sharded import (
    decrypt_shard_runs, encrypt_shard, padded_lane_count)
from flashe_tpu_torch.ops.masks import merge_size

__all__ = ["LocalLaneMesh", "sparse_decrypt_fanout"]


def sparse_decrypt_fanout(devices, rk, value, iter_index, locs_list,
                          idx_list, int_bits, double):
    """Sparse-aggregate decrypt fanned out over local devices by client
    (the reference regenerates each client's masks in pool workers,
    jzf_flashe.py:431-454).  Device d takes a round-robin share of the
    surviving clients and scatters each one's compact-counter streams
    (-a_i, and + a_{i+1} with the double mask) into a zeroed int32 vector
    with the mask kernel's scatter mode, one launch a client.  The partials
    are summed with wrapping int32 adds on the aggregate's device and
    applied to it, which is exact mod 2^int_bits (2^int_bits divides
    2^32): bit-identical with the single-device decrypt."""
    n_dev = min(len(devices), len(idx_list))
    total = None
    for d in range(n_dev):
        dev = devices[d]
        rk_d = rk.to(dev)
        part = torch.zeros(value.shape[0], dtype=torch.int32, device=dev)
        for row in range(d, len(idx_list), n_dev):
            i = idx_list[row]
            mask_scatter(part, locs_list[row].to(dev), rk_d, iter_index,
                         i + 1 if double else None, i, int_bits)
        part = part.to(value.device)
        total = part if total is None else total + part
    return lane_add(value, total, int_bits)


class LocalLaneMesh:
    """A 1-D `lanes` mesh over a party's local devices (every visible card
    by default; a device may repeat).

    Install it on a FlasheCipher with `cipher.set_local_devices(...)`: the
    cipher then routes its dense double- and single-mask encrypt and
    decrypt through it, and its sparse decrypt through
    sparse_decrypt_fanout over the same devices, leaving the protocol and
    the limb (> 32-bit) path as they are.  Results come back on the
    device of the vector given.
    """

    def __init__(self, n_shards=None, devices=None):
        devices = resolve_devices(devices)
        if n_shards in (None, "all"):
            n_shards = len(devices)
        n_shards = int(n_shards)
        if n_shards > len(devices):
            raise ValueError(f"local_lane_shards={n_shards} > {len(devices)} "
                             f"local devices")
        self.n_shards = n_shards
        self.devices = devices[:n_shards]

    def _pad(self, v, int_bits):
        """v padded to padded_lane_count, as one contiguous shard a
        device."""
        n = v.shape[0]
        n_pad = padded_lane_count(n, int_bits, self.n_shards)
        if n_pad != n:
            v = torch.cat([v, v.new_zeros(n_pad - n)])
        ns = n_pad // self.n_shards
        return [v[s * ns:(s + 1) * ns].to(dev)
                for s, dev in enumerate(self.devices)]

    @staticmethod
    def _gather(shards, like, n):
        return torch.cat([s.to(like.device) for s in shards])[:n]

    def encrypt(self, rk, q, iter_index, stream_idx, int_bits):
        out = [encrypt_shard(rk, qs, iter_index, stream_idx, s, int_bits)
               for s, qs in enumerate(self._pad(q, int_bits))]
        return self._gather(out, q, q.shape[0])

    def decrypt_runs(self, rk, agg, iter_index, adds, minuses, int_bits):
        out = [decrypt_shard_runs(rk, a, iter_index, adds, minuses, s,
                                  int_bits)
               for s, a in enumerate(self._pad(agg, int_bits))]
        return self._gather(out, agg, agg.shape[0])

    def encrypt_single(self, rk, q, iter_index, stream_idx, int_bits):
        """Single-mask encrypt, c = q + a_idx (reference jzf_flashe.py:
        306-343): one add-stream launch a shard."""
        out = []
        for s, qs in enumerate(self._pad(q, int_bits)):
            begin = s * (qs.shape[0] // merge_size(int_bits))
            out.append(mask_apply(qs, rk.to(qs.device), iter_index,
                                  stream_idx, None, int_bits, begin))
        return self._gather(out, q, q.shape[0])

    def decrypt_single(self, rk, agg, iter_index, idx_list, int_bits):
        """Single-mask aggregate decrypt: every survivor's stream
        subtracted, one launch a survivor and a shard."""
        return self.decrypt_runs(rk, agg, iter_index, (), idx_list, int_bits)
