"""FLASHE PRP mask streams in plain torch (port of flashe_tpu/ops/masks.py).

The contract is that of the JAX package, bit for bit:

    index  = iter_index(4B, BE) || stream_idx(4B, BE) || counter(8B, BE)
    block  = AES256_ECB(seed, index)            # 128 bits, big-endian
    lane_j = (block >> (j * int_bits)) & (2^int_bits - 1),  j < 128//int_bits

where counter is the global block index.  Lanes wider than 32 bits are
little-endian int32 limb vectors.  The JAX package computes the stream with
a bitsliced AES whose counters must be 32-aligned; that layout is a TPU
choice, and this stream takes any begin_block.  It is the plain version
that the CUDA mask kernel (flashe_tpu_torch/ops/flashe_mask.py) is held to.
"""

from __future__ import annotations

import numpy as np
import torch

from flashe_tpu_torch.ops import aes
from flashe_tpu_torch.ops.lanes import nlimbs_for, to_i32

__all__ = [
    "merge_size",
    "num_blocks",
    "index_blocks",
    "lanes_from_blocks",
    "lanes_from_words",
    "prp_lane_stream",
    "flashe_mask_pair",
    "reference_mask_stream_host",
]

_U32 = 0xFFFFFFFF


def merge_size(int_bits: int) -> int:
    """Lanes extracted per AES block."""
    return 128 // int_bits


def num_blocks(count: int, int_bits: int) -> int:
    """Blocks needed for `count` lanes."""
    return (count - 1) // merge_size(int_bits) + 1


def index_blocks(iter_index: int, stream_idx: int, begin_block: int,
                 nblocks: int, device=None) -> torch.Tensor:
    """The (nblocks, 16) int64 byte matrix of PRP indices for blocks
    begin_block .. begin_block + nblocks - 1 (64-bit counters)."""
    counter = begin_block + torch.arange(nblocks, dtype=torch.int64,
                                         device=device)
    head = [((v & _U32) >> s) & 0xFF for v in (iter_index, stream_idx)
            for s in (24, 16, 8, 0)]
    cols = [torch.full((nblocks,), b, dtype=torch.int64, device=device)
            for b in head]
    cols += [(counter >> s) & 0xFF for s in range(56, -8, -8)]
    return torch.stack(cols, dim=-1)


def lanes_from_blocks(out_bytes: torch.Tensor, int_bits: int) -> torch.Tensor:
    """LSB-first lanes of AES output bytes.

    out_bytes: (N, 16) byte values.  Returns (N * merge, L) int32 limbs;
    lane j of block i is element i * merge + j.
    """
    n = out_bytes.shape[0]
    merge = merge_size(int_bits)
    nl = nlimbs_for(int_bits)
    b = out_bytes.to(torch.int64)
    # 32-bit words, w[0] least significant (bytes 12..15 big-endian)
    words = [
        (b[:, 12 - 4 * w] << 24) | (b[:, 13 - 4 * w] << 16)
        | (b[:, 14 - 4 * w] << 8) | b[:, 15 - 4 * w]
        for w in range(4)
    ]
    words.append(torch.zeros_like(words[0]))  # overflow word for shifts

    def extract32(bitpos: int) -> torch.Tensor:
        wi, off = bitpos >> 5, bitpos & 31
        if off == 0:
            return words[wi]
        return ((words[wi] >> off) | (words[wi + 1] << (32 - off))) & _U32

    top_bits = int_bits - 32 * (nl - 1)
    top_mask = (1 << top_bits) - 1
    lanes = []
    for j in range(merge):
        limbs = [extract32(j * int_bits + 32 * l) for l in range(nl)]
        limbs[-1] = limbs[-1] & top_mask
        lanes.append(torch.stack(limbs, dim=-1))  # (N, L)
    return to_i32(torch.stack(lanes, dim=1).reshape(n * merge, nl))


def lanes_from_words(cols: torch.Tensor, int_bits: int) -> torch.Tensor:
    """LSB-first lanes (int_bits <= 32) of AES output column words, cut as
    the CUDA mask kernel cuts them: lane i of the run lies in block
    i // merge at bit (i % merge) * int_bits of its 128, in 32-bit word
    bit // 32 (word 0 the least significant, column 3) and, where it
    straddles, the next word: a funnel shift of the two.

    cols: (N, 4) words, word c = bytes 4c .. 4c + 3 of the block,
    big-endian.  Returns (N * merge,) int32.
    """
    if nlimbs_for(int_bits) != 1:
        raise ValueError("lanes_from_words takes int_bits <= 32")
    n, merge = cols.shape[0], merge_size(int_bits)
    w = torch.cat([cols.to(torch.int64).flip(-1) & _U32,
                   torch.zeros((n, 1), dtype=torch.int64,
                               device=cols.device)], dim=-1)  # (N, 5)
    i = torch.arange(n * merge, device=cols.device)
    blk, bit = i // merge, (i % merge) * int_bits
    lo, hi = w[blk, bit >> 5], w[blk, (bit >> 5) + 1]
    return to_i32(((lo | (hi << 32)) >> (bit & 31)) & ((1 << int_bits) - 1))


def prp_lane_stream(round_keys, iter_index: int, stream_idx: int, count: int,
                    int_bits: int, begin_block: int = 0) -> torch.Tensor:
    """Mask lanes for elements [0, count) of stream (iter_index, stream_idx),
    counting AES blocks from `begin_block` (any value, aligned or not).

    Runs on round_keys' device.  Returns (count,) int32 for int_bits <= 32,
    else (count, L) int32 limbs.
    """
    rk = torch.as_tensor(round_keys)
    nb = num_blocks(count, int_bits)
    blocks = index_blocks(iter_index, stream_idx, begin_block, nb, rk.device)
    lanes = lanes_from_blocks(aes.aes_encrypt_blocks(blocks, rk),
                              int_bits)[:count]
    return lanes[:, 0] if nlimbs_for(int_bits) == 1 else lanes


def flashe_mask_pair(round_keys, iter_index: int, add_idx: int,
                     minus_idx: int, count: int, int_bits: int,
                     begin_block: int = 0):
    """The (add, minus) mask streams used by double masking.

    Encrypt uses (idx, idx+1); decrypt-after-aggregate uses (num_clients, 0)
    — the non-cancelling telescope ends (jzf_flashe.py:599-666).
    """
    add = prp_lane_stream(round_keys, iter_index, add_idx, count, int_bits,
                          begin_block)
    minus = prp_lane_stream(round_keys, iter_index, minus_idx, count,
                            int_bits, begin_block)
    return add, minus


def reference_mask_stream_host(seed: bytes, iter_index: int, stream_idx: int,
                               count: int, int_bits: int) -> np.ndarray:
    """Host oracle of the same stream through the `cryptography` AES.

    Returns object-dtype ints (any int_bits).  `cryptography` is imported
    here so that the module loads where it is not installed.
    """
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    enc = Cipher(algorithms.AES(seed), modes.ECB()).encryptor()
    merge = merge_size(int_bits)
    prefix = iter_index.to_bytes(4, "big") + stream_idx.to_bytes(4, "big")
    out = []
    mask = (1 << int_bits) - 1
    for i in range(num_blocks(count, int_bits)):
        val = int.from_bytes(enc.update(prefix + i.to_bytes(8, "big")), "big")
        for _ in range(merge):
            out.append(val & mask)
            val >>= int_bits
    return np.array(out[:count], dtype=object)
