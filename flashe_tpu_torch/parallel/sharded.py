"""Sharded encrypted aggregation over a grid of devices (port of
flashe_tpu/parallel/sharded.py).

Clients map to the rows of a (clients, lanes) grid and the flattened lane
vector splits across its columns.  Each (client, lane shard) cell makes
exactly its slice of the client's mask streams: counter-mode AES is
parallel by block, so a shard whose mask launch starts at counter block
`base_block = shard_id * (shard lanes // merge_size)` yields the lanes of
the single-device stream bit for bit (ops/masks.py).  Client c uses
stream idx c, as in the federated protocol, so a grid round is
bit-compatible with FlasheCipher's.

Every shard's encrypt and decrypt is one launch of the mask kernel
(ops/flashe_mask.py).  The JAX package's `shard_map` + `psum` becomes a
loop over the cells: the ciphertexts of a lane shard are summed over the
clients on the int32 carrier on the device of that shard's first row.

Divergence: `make_mesh` may repeat a device, so that a host with one card
runs a 10 x 2 grid of `cuda:0` (the JAX tests do the same with virtual
CPU devices); the cells then run one after another on that card.
"""

from __future__ import annotations

import torch

from flashe_tpu_torch.crypto.flashe import merge_idx_runs
from flashe_tpu_torch.device import resolve_devices
from flashe_tpu_torch.ops.flashe_mask import mask_apply
from flashe_tpu_torch.ops.masks import merge_size

__all__ = ["Mesh", "make_mesh", "padded_lane_count", "encrypted_aggregate",
           "encrypt_shard", "decrypt_shard", "decrypt_shard_runs",
           "carrier_mask"]


class Mesh:
    """A (clients, lanes) grid of torch.devices; `shape` names the axes as
    a jax Mesh does."""

    def __init__(self, grid):
        self.devices = [[torch.device(d) for d in row] for row in grid]
        if not self.devices or not self.devices[0] or len(
                {len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.shape = {"clients": len(self.devices),
                      "lanes": len(self.devices[0])}


def make_mesh(n_clients_axis: int, n_lane_shards: int,
              devices=None) -> Mesh:
    """The first n_clients_axis x n_lane_shards of `devices` (every visible
    card by default), row by row; a device may appear more than once."""
    devices = resolve_devices(devices)
    need = n_clients_axis * n_lane_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[r * n_lane_shards:(r + 1) * n_lane_shards]
                 for r in range(n_clients_axis)])


def padded_lane_count(n: int, int_bits: int, n_shards: int) -> int:
    """Round lanes up so every shard starts on a 32-aligned AES block."""
    quantum = merge_size(int_bits) * 32 * n_shards
    return -(-n // quantum) * quantum


def carrier_mask(int_bits: int) -> int:
    """2^int_bits - 1 as the int32 bit pattern that masks a wrapped int32
    sum (int_bits <= 32)."""
    m = (1 << int_bits) - 1
    return m - (1 << 32) if m >= 1 << 31 else m


def _begin(shard: torch.Tensor, shard_id: int, int_bits: int) -> int:
    return shard_id * (shard.shape[0] // merge_size(int_bits))


def encrypt_shard(rk, q_shard, iter_index, stream_idx, shard_id, int_bits):
    """Double-mask encrypt of one lane shard, its counters offset by the
    shard's first block: one mask launch on the shard's device."""
    return mask_apply(q_shard, rk.to(q_shard.device), iter_index, stream_idx,
                      stream_idx + 1, int_bits,
                      _begin(q_shard, shard_id, int_bits))


def decrypt_shard(rk, agg_shard, iter_index, num_clients, shard_id,
                  int_bits):
    """Boundary-mask decrypt (n, 0) of an aggregated lane shard."""
    return mask_apply(agg_shard, rk.to(agg_shard.device), iter_index,
                      num_clients, 0, int_bits,
                      _begin(agg_shard, shard_id, int_bits))


def decrypt_shard_runs(rk, agg_shard, iter_index, adds, minuses, shard_id,
                       int_bits):
    """Decrypt an aggregated lane shard given run-merged telescope
    boundaries (merge_idx_runs over the survivors): one launch for each
    (add, minus) pair, and one single-stream launch for each boundary
    left without a partner."""
    rk = rk.to(agg_shard.device)
    begin = _begin(agg_shard, shard_id, int_bits)
    adds, minuses = list(adds), list(minuses)
    npairs = min(len(adds), len(minuses))
    out = agg_shard
    for a, b in zip(adds[:npairs], minuses[:npairs]):
        out = mask_apply(out, rk, iter_index, a, b, int_bits, begin)
    for a in adds[npairs:]:
        out = mask_apply(out, rk, iter_index, a, None, int_bits, begin)
    for b in minuses[npairs:]:
        out = mask_apply(out, rk, iter_index, None, b, int_bits, begin)
    return out


def encrypted_aggregate(mesh: Mesh, rk, q, iter_index, int_bits: int,
                        num_clients: int, survivors=None) -> torch.Tensor:
    """One encrypted-aggregation round on a mesh.

    q: (num_clients, N) int32 quantized lanes, one row a mesh row, N a
    multiple of merge_size x the lane shards (padded_lane_count).  Returns
    the decrypted mod-2^m sum, (N,) int32, on the device of the mesh's
    first cell.

    survivors: the client indices that completed the round (dropout);
    the others' ciphertexts are zeroed before the sum, which removes
    their values and their masks, and the decrypt takes the run-merged
    survivor boundaries instead of (num_clients, 0).

    int_bits <= 32 only, and num_clients * 2^int_bits <= 2^32, as in the
    JAX package.
    """
    if num_clients << int_bits > (1 << 32):
        raise ValueError("num_clients * 2^int_bits must fit in uint32 psum")
    n_rows, n_shards = mesh.shape["clients"], mesh.shape["lanes"]
    q = torch.as_tensor(q)
    if q.dim() != 2 or q.shape[0] != n_rows:
        raise ValueError(f"q must be ({n_rows}, N), one row a mesh row; got "
                         f"{tuple(q.shape)}")
    n = q.shape[1]
    if n % (merge_size(int_bits) * n_shards):
        raise ValueError(f"{n} lanes do not split into {n_shards} shards of "
                         f"whole AES blocks: pad with padded_lane_count")
    ns = n // n_shards
    alive = set(range(n_rows) if survivors is None else survivors)
    if survivors is not None:
        adds, minuses = merge_idx_runs(list(survivors))
    m = carrier_mask(int_bits)
    outs = []
    for s in range(n_shards):
        home = mesh.devices[0][s]
        agg = None
        for c in range(n_rows):
            ct = encrypt_shard(rk, q[c, s * ns:(s + 1) * ns].to(
                mesh.devices[c][s]), iter_index, c, s, int_bits)
            if c not in alive:
                ct = torch.zeros_like(ct)
            ct = ct.to(home)
            agg = ct if agg is None else agg + ct  # int32 adds wrap
        agg = agg & m
        # every JAX row decrypts the same aggregate; decrypting each lane
        # shard once, on its first row's device, computes the same lanes
        if survivors is None:
            outs.append(decrypt_shard(rk, agg, iter_index, num_clients, s,
                                      int_bits))
        else:
            outs.append(decrypt_shard_runs(rk, agg, iter_index, adds,
                                           minuses, s, int_bits))
    first = mesh.devices[0][0]
    return torch.cat([o.to(first) for o in outs])
