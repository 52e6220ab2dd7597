"""Host-side AES-256-CTR for wrapping session secrets (port of
flashe_tpu/crypto/aes_host.py).

Mirrors the reference AESCipher (federatedml/secureprotol/jzf_aes.py) in
CTR mode with a zero initial counter, which wraps the FLASHE PRP seed and
Paillier's (p, q) for each host, with the same key-derivation rule for int
and bytes secrets.  The JAX package takes AES from the `cryptography`
library; the port runs its own AES-256 (ops/aes.py, held to FIPS-197), on
the host, as the JAX package does: a wrap is once-a-job session work of a
few blocks.

CTR semantics are those of `cryptography`'s CTR mode: the counter block
starts at sixteen zero bytes and increments as one 128-bit big-endian
integer; the keystream is the AES encryption of the successive counter
blocks.  Encryption and decryption each keep their own stream, and each
`encrypt` / `decrypt` call continues its stream where the last one stopped,
inside a keystream block too, so a message split over several calls
encrypts as it would whole.

ECB mode, which the JAX package offers for PRP evaluation and never calls,
is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flashe_tpu_torch.ops import aes

__all__ = ["AESCipher", "derive_key_bytes"]

_BLOCK = 16


def derive_key_bytes(secret, key_len_bytes: int) -> bytes:
    """Mask an int or bytes secret to the key length (jzf_aes.py:21-28)."""
    if isinstance(secret, bytes):
        secret = int.from_bytes(secret, "big")
    return (int(secret) & (256 ** key_len_bytes - 1)).to_bytes(
        key_len_bytes, "big"
    )


class _CtrStream:
    """One AES-256-CTR keystream from a zero counter block, consumed in
    order across calls."""

    def __init__(self, round_keys: np.ndarray):
        self._rk = round_keys
        self._counter = 0  # the next counter block, as a 128-bit integer
        self._left = b""  # unused keystream bytes of the last block made

    def _blocks(self, n: int) -> bytes:
        ctrs = [(self._counter + i) % (1 << 128) for i in range(n)]
        self._counter = (self._counter + n) % (1 << 128)
        raw = np.frombuffer(b"".join(c.to_bytes(_BLOCK, "big") for c in ctrs),
                            dtype=np.uint8).reshape(n, _BLOCK)
        out = aes.aes_encrypt_blocks(torch.from_numpy(raw.copy()), self._rk)
        return out.to(torch.uint8).numpy().tobytes()

    def update(self, data: bytes) -> bytes:
        need = len(data) - len(self._left)
        ks = self._left
        if need > 0:
            ks += self._blocks(-(-need // _BLOCK))
        self._left = ks[len(data):]
        stream = np.frombuffer(ks[:len(data)], dtype=np.uint8)
        return (np.frombuffer(bytes(data), dtype=np.uint8) ^ stream).tobytes()


class AESCipher:
    """AES-256 in CTR mode with a zero initial counter (jzf_aes.py:14-48)."""

    def __init__(self):
        self.key = None
        self._enc = None
        self._dec = None

    def generate_key(self, key_length: int = 256, assigned_key=None,
                     mode: str = "CTR"):
        if key_length != 256:
            raise ValueError(f"the port's AES is AES-256, not {key_length}")
        if mode != "CTR":
            raise ValueError(f"unsupported AES mode {mode}: the port has CTR "
                             "only")
        nbytes = key_length // 8
        if assigned_key is None:
            key = os.urandom(nbytes)
        else:
            key = derive_key_bytes(assigned_key, nbytes)
        self.key = key
        rk = aes.key_schedule(key)
        self._enc = _CtrStream(rk)
        self._dec = _CtrStream(rk)

    def encrypt(self, plaintext: bytes) -> bytes:
        return self._enc.update(plaintext)

    def decrypt(self, ciphertext: bytes) -> bytes:
        return self._dec.update(ciphertext)

    def get_key(self) -> bytes:
        return self.key
