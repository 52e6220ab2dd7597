"""AES-256 for the mask streams (port of flashe_tpu/ops/aes.py).

The S-box and key schedule run on the host in numpy, once per session.  They
are copies of the JAX package's, whose module imports jax.  Block encryption
is a plain torch program over an (N, 16) batch of byte values with a
table-lookup S-box: the reference that the CUDA mask kernel
(flashe_tpu_torch/csrc/flashe_mask.cu) is checked against.  The JAX
package's gather-free Boyar-Peralta circuit is a TPU choice and is not
ported.

The kernel itself runs a T-table AES on big-endian column words.  Its one
table is made here, `te0_words`, and uploaded by the kernel's wrapper;
`aes_encrypt_blocks_ttable` is the same round structure in plain torch, which
the tests hold against `aes_encrypt_blocks`, FIPS-197 and the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SBOX", "key_schedule", "aes_encrypt_blocks", "te0_words",
           "aes_encrypt_blocks_ttable"]


def _gf_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


def _derive_sbox() -> np.ndarray:
    # multiplicative inverse via x^254 (Fermat in GF(2^8)); 0 -> 0
    inv = [0] * 256
    for x in range(1, 256):
        v = x
        r = 1
        e = 254
        while e:
            if e & 1:
                r = _gf_mul(r, v)
            v = _gf_mul(v, v)
            e >>= 1
        inv[x] = r
    sbox = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        b = inv[x]
        s = 0
        for i in range(8):
            bit = (
                (b >> i)
                ^ (b >> ((i + 4) % 8))
                ^ (b >> ((i + 5) % 8))
                ^ (b >> ((i + 6) % 8))
                ^ (b >> ((i + 7) % 8))
                ^ (0x63 >> i)
            ) & 1
            s |= bit << i
        sbox[x] = s
    return sbox


SBOX = _derive_sbox()

# ShiftRows permutation on flat byte index i = row + 4*col (FIPS-197
# column-major state): out[r + 4c] = in[r + 4*((c + r) % 4)].
_SHIFT_ROWS = np.array(
    [(i % 4) + 4 * (((i // 4) + (i % 4)) % 4) for i in range(16)], dtype=np.int64
)

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C]


def key_schedule(key: bytes) -> np.ndarray:
    """AES-256 key expansion (FIPS-197) -> (15, 16) uint8 round keys."""
    if len(key) != 32:
        raise ValueError(f"AES-256 key must be 32 bytes, got {len(key)}")
    nk = 8
    words = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    for i in range(nk, 60):
        temp = list(words[i - 1])
        if i % nk == 0:
            temp = temp[1:] + temp[:1]  # RotWord
            temp = [int(SBOX[b]) for b in temp]  # SubWord
            temp[0] ^= _RCON[i // nk - 1]
        elif i % nk == 4:
            temp = [int(SBOX[b]) for b in temp]
        words.append([a ^ b for a, b in zip(words[i - nk], temp)])
    return np.array(words, dtype=np.uint8).reshape(15, 16)


def _xtime(a: torch.Tensor) -> torch.Tensor:
    return ((a << 1) & 0xFF) ^ (0x1B * ((a >> 7) & 1))


def _mix_columns(state: torch.Tensor) -> torch.Tensor:
    # state (..., 16) with byte i = row i%4 of column i//4
    s = state.reshape(state.shape[:-1] + (4, 4))  # (..., col, row)
    s0, s1, s2, s3 = s.unbind(-1)
    x0, x1, x2, x3 = _xtime(s0), _xtime(s1), _xtime(s2), _xtime(s3)
    o0 = x0 ^ x1 ^ s1 ^ s2 ^ s3
    o1 = s0 ^ x1 ^ x2 ^ s2 ^ s3
    o2 = s0 ^ s1 ^ x2 ^ x3 ^ s3
    o3 = x0 ^ s0 ^ s1 ^ s2 ^ x3
    return torch.stack([o0, o1, o2, o3], dim=-1).reshape(state.shape)


def aes_encrypt_blocks(blocks: torch.Tensor, round_keys) -> torch.Tensor:
    """AES-256-ECB encrypt a batch of blocks.

    blocks: (..., 16) integer byte values; round_keys: (15, 16) round keys
    (numpy or tensor).  Returns (..., 16) int64 byte values on blocks'
    device.
    """
    dev = blocks.device
    sbox = torch.as_tensor(SBOX, dtype=torch.int64, device=dev)
    shift = torch.as_tensor(_SHIFT_ROWS, device=dev)
    rk = torch.as_tensor(round_keys).to(dev, torch.int64)
    state = blocks.to(torch.int64) ^ rk[0]
    for r in range(1, 14):
        state = sbox[state][..., shift]
        state = _mix_columns(state) ^ rk[r]
    return sbox[state][..., shift] ^ rk[14]


def te0_words() -> np.ndarray:
    """The T-table of SubBytes + MixColumns for a row-0 byte: 256 uint32,
    Te0[x] = (2 S(x), S(x), S(x), 3 S(x)), most significant byte first.
    The tables of rows 1-3 are Te0 rotated right by 8, 16 and 24 bits."""
    s = SBOX.astype(np.uint32)
    s2 = ((s << 1) ^ (0x1B * (s >> 7))) & 0xFF
    return (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s)


def _ror(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def aes_encrypt_blocks_ttable(cols: torch.Tensor, round_keys) -> torch.Tensor:
    """AES-256-ECB on column words, round for round as the CUDA mask kernel
    computes it.

    cols: (..., 4) integer words, word c = bytes 4c .. 4c + 3 of the block,
    big-endian; round_keys: (15, 16) round keys.  Returns (..., 4) int64
    words of the same layout.  A main round's column c is
    Te0[s_c >> 24] ^ Te2[(s_c+2 >> 8) & 255] ^ rk
    ^ ror8(Te0[(s_c+1 >> 16) & 255] ^ Te2[s_c+3 & 255]) with Te2 = ror16(Te0);
    the last round takes S(x) from the tables' own bytes.
    """
    dev = cols.device
    te0 = torch.as_tensor(te0_words().astype(np.int64), device=dev)
    te2 = _ror(te0, 16)
    rk = torch.as_tensor(round_keys).to(dev, torch.int64) & 0xFF
    rkw = (rk[:, 0::4] << 24) | (rk[:, 1::4] << 16) | (rk[:, 2::4] << 8) \
        | rk[:, 3::4]  # (15, 4) big-endian words
    s = [(cols[..., c].to(torch.int64) & 0xFFFFFFFF) ^ rkw[0, c]
         for c in range(4)]
    for r in range(1, 14):
        s = [te0[s[c] >> 24] ^ te2[(s[(c + 2) % 4] >> 8) & 0xFF] ^ rkw[r, c]
             ^ _ror(te0[(s[(c + 1) % 4] >> 16) & 0xFF]
                    ^ te2[s[(c + 3) % 4] & 0xFF], 8)
             for c in range(4)]
    # S(x) is byte 3 and byte 0 of Te2[x], byte 2 and byte 1 of Te0[x]
    out = [((te2[s[c] >> 24] & 0xFF000000)
            | (te0[(s[(c + 1) % 4] >> 16) & 0xFF] & 0x00FF0000)
            | (te0[(s[(c + 2) % 4] >> 8) & 0xFF] & 0x0000FF00)
            | (te2[s[(c + 3) % 4] & 0xFF] & 0x000000FF)) ^ rkw[14, c]
           for c in range(4)]
    return torch.stack(out, dim=-1)
