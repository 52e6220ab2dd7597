"""Paillier baseline cipher (port of flashe_tpu/crypto/paillier.py).

Textbook Paillier with CRT decryption and a keypair shared by the clients
(semi-honest model: the arbiter holds only n and multiplies ciphertexts mod
n^2).  The batch work runs as Montgomery products on (B, L) limb tensors
(ops/modmath.py), on the cipher's device: for encryption r^n mod n^2 of
every obfuscator, for the arbiter's sum a product chain mod n^2, and for
decryption both CRT exponentiations (mod p^2 and mod q^2) as one batch.
The big-int assembly (1 + n m, the L function, the CRT combine) stays on
the host.  The key code is a copy of the JAX package's, which needs no JAX,
and so is the float facade (PaillierEncryptedNumber, FloatPaillier: the
python-paillier surface over crypto/fixedpoint.py that
crypto/encrypt_mode.py drives), scalar host code on python ints that
launches no kernel, as in the JAX package.

`set_local_devices` fans a batch encrypt or decrypt over several devices
(parallel/fanout.DeviceFanout): the rows are independent, so each
contiguous chunk runs its modexp on its own device, against a Montgomery
context of its own there.
"""

from __future__ import annotations

import random

import numpy as np

from flashe_tpu_torch.crypto.fixedpoint import FixedPointNumber
import torch

from flashe_tpu_torch.device import resolve_device, same_device
from flashe_tpu_torch.ops import modmath

__all__ = ["PaillierKeypair", "PaillierPublicKey", "PaillierPrivateKey",
           "PaillierEncryptedNumber", "FloatPaillier", "PaillierCipher",
           "getprimeover"]

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47]


def _is_probable_prime(n: int, rounds: int = 30) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    rng = random.SystemRandom()
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def getprimeover(bits: int) -> int:
    """Random prime with the top bit set."""
    rng = random.SystemRandom()
    while True:
        cand = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(cand):
            return cand


class PaillierPublicKey:
    def __init__(self, n: int):
        self.n = n
        self.g = n + 1
        self.nsquare = n * n
        self.max_int = n // 3 - 1

    def get_n(self):
        return self.n

    def encrypt_scalar(self, m: int, r: int | None = None) -> int:
        """Host-side scalar encrypt (the oracle for the device path)."""
        if r is None:
            r = random.SystemRandom().randrange(1, self.n)
        c = (self.n * m + 1) % self.nsquare
        return (c * pow(r, self.n, self.nsquare)) % self.nsquare


class PaillierPrivateKey:
    def __init__(self, public_key: PaillierPublicKey, p: int, q: int):
        if p * q != public_key.n:
            raise ValueError("keypair mismatch")
        self.public_key = public_key
        self.p, self.q = (q, p) if q < p else (p, q)
        self.psquare = self.p * self.p
        self.qsquare = self.q * self.q
        self.q_inverse = pow(self.q, -1, self.p)
        self.hp = self._h(self.p, self.psquare)
        self.hq = self._h(self.q, self.qsquare)

    def _l(self, x: int, p: int) -> int:
        return (x - 1) // p

    def _h(self, x: int, xsquare: int) -> int:
        return pow(self._l(pow(self.public_key.g, x - 1, xsquare), x), -1, x)

    def decrypt_scalar(self, c: int) -> int:
        mp = self._l(pow(c, self.p - 1, self.psquare), self.p) * self.hp % self.p
        mq = self._l(pow(c, self.q - 1, self.qsquare), self.q) * self.hq % self.q
        u = (mp - mq) * self.q_inverse % self.p
        return (mq + u * self.q) % self.public_key.n


class PaillierEncryptedNumber:
    """Float-valued Paillier ciphertext (python-paillier semantics, the
    surface the reference's stock secureprotol exposes for hetero-FL:
    fixed-point encoding + homomorphic float add / scalar mul).  The
    FLASHE pipeline itself moves quantized int vectors through the limb
    kernels instead; this type backs EncryptModeCalculator parity.  Host
    code on python ints: it launches no kernel."""

    def __init__(self, public_key: PaillierPublicKey, ciphertext: int,
                 exponent: int):
        self.public_key = public_key
        self.ciphertext = ciphertext
        self.exponent = exponent

    @classmethod
    def encrypt(cls, public_key: PaillierPublicKey, value,
                r: int | None = None) -> "PaillierEncryptedNumber":
        fp = FixedPointNumber.encode(value, public_key.n,
                                     public_key.max_int)
        return cls(public_key, public_key.encrypt_scalar(fp.encoding, r),
                   fp.exponent)

    def decrypt(self, privacy_key: PaillierPrivateKey) -> float:
        enc = privacy_key.decrypt_scalar(self.ciphertext)
        return FixedPointNumber(enc, self.exponent, self.public_key.n,
                                self.public_key.max_int).decode()

    def _decrease_exponent_to(self, new_exponent: int
                              ) -> "PaillierEncryptedNumber":
        if new_exponent > self.exponent:
            raise ValueError("cannot decrease exponent upward")
        factor = pow(FixedPointNumber.BASE, self.exponent - new_exponent)
        ct = pow(self.ciphertext, factor, self.public_key.nsquare)
        return PaillierEncryptedNumber(self.public_key, ct, new_exponent)

    def __add__(self, other):
        if not isinstance(other, PaillierEncryptedNumber):
            other = PaillierEncryptedNumber.encrypt(self.public_key,
                                                    float(other))
        a, b = self, other
        if a.exponent > b.exponent:
            a = a._decrease_exponent_to(b.exponent)
        elif b.exponent > a.exponent:
            b = b._decrease_exponent_to(a.exponent)
        ct = (a.ciphertext * b.ciphertext) % self.public_key.nsquare
        return PaillierEncryptedNumber(self.public_key, ct, a.exponent)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (other * -1 if isinstance(
            other, PaillierEncryptedNumber) else -float(other))

    def __mul__(self, scalar):
        fp = FixedPointNumber.encode(float(scalar), self.public_key.n,
                                     self.public_key.max_int)
        enc = fp.encoding
        if enc >= self.public_key.n - self.public_key.max_int:
            # negative scalar: multiply by |scalar| via the inverse ct
            neg_ct = pow(self.ciphertext, -1, self.public_key.nsquare)
            ct = pow(neg_ct, self.public_key.n - enc,
                     self.public_key.nsquare)
        else:
            ct = pow(self.ciphertext, enc, self.public_key.nsquare)
        return PaillierEncryptedNumber(self.public_key, ct,
                                       self.exponent + fp.exponent)

    __rmul__ = __mul__


class FloatPaillier:
    """python-paillier-style facade used by EncryptModeCalculator."""

    def __init__(self, public_key: PaillierPublicKey,
                 privacy_key: PaillierPrivateKey | None = None):
        self.public_key = public_key
        self.privacy_key = privacy_key

    def encrypt(self, value) -> PaillierEncryptedNumber:
        return PaillierEncryptedNumber.encrypt(self.public_key, value)

    def decrypt(self, number: PaillierEncryptedNumber) -> float:
        if self.privacy_key is None:
            raise ValueError("no private key on this party")
        return number.decrypt(self.privacy_key)


class PaillierKeypair:
    @staticmethod
    def generate_keypair(n_length: int = 2048):
        n_len = 0
        while n_len != n_length:
            p = getprimeover(n_length // 2)
            q = p
            while q == p:
                q = getprimeover(n_length // 2)
            n = p * q
            n_len = n.bit_length()
        pub = PaillierPublicKey(n)
        return pub, PaillierPrivateKey(pub, p, q)


class PaillierCipher:
    """Batched Paillier over limb tensors on `device`.

    Values and ciphertexts at this interface are object arrays of python
    ints (the batching quantizer's lanes as big ints)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.public_key: PaillierPublicKey | None = None
        self.privacy_key: PaillierPrivateKey | None = None
        self.n = None
        self._ctx2: modmath.MontCtx | None = None
        self._ndigits = None
        self._fanout = None
        self._replicas: dict = {}  # (context, device) -> its copy there

    def set_local_devices(self, n_shards=None, devices=None):
        """Fan this party's batch encrypt and decrypt over several devices
        (the reference's per-silo Pool over contiguous chunks,
        jzf_paillier.py:190-237), every visible card by default: a batch of
        at least 2 x n_shards rows splits into one chunk a device, each
        launched before any is awaited.  A 1-device fan-out disables the
        route."""
        from flashe_tpu_torch.parallel.fanout import DeviceFanout

        f = DeviceFanout(n_shards, devices)
        self._fanout = f if f.n_shards > 1 else None

    def _fanned(self, rows: int) -> bool:
        return self._fanout is not None and rows >= 2 * self._fanout.n_shards

    def _on(self, name: str, device):
        """The Montgomery context `name` ("ctx2" or "pair") on `device`: the
        cipher's own on its device, else a copy made there once."""
        ctx = self._ctx2 if name == "ctx2" else self._pair_ctx
        if same_device(device, ctx.device):
            return ctx
        key = (name, torch.device(device))
        if key not in self._replicas:
            sk = self.privacy_key
            self._replicas[key] = (
                modmath.MontCtx(self.public_key.nsquare, device=device)
                if name == "ctx2" else
                modmath.PairMontCtx(sk.psquare, sk.qsquare, device=device))
        return self._replicas[key]

    # -- key management ----------------------------------------------------

    def generate_key(self, n_length: int = 2048):
        pub, priv = PaillierKeypair.generate_keypair(n_length)
        self.set_public_key(pub)
        self.set_privacy_key(priv)

    def set_public_key(self, public_key: PaillierPublicKey):
        self.public_key = public_key
        self.n = public_key.n
        self._replicas = {}
        self._ctx2 = modmath.MontCtx(public_key.nsquare, device=self.device)
        self._ndigits = modmath.exponent_digits(self.n, self.n.bit_length())

    def set_privacy_key(self, privacy_key: PaillierPrivateKey):
        self.privacy_key = privacy_key
        self._replicas = {k: v for k, v in self._replicas.items()
                          if k[0] == "ctx2"}
        sk = privacy_key
        # both CRT exponentiations run as one per-row-modulus batch
        self._pair_ctx = modmath.PairMontCtx(sk.psquare, sk.qsquare,
                                             device=self.device)
        nbits = max(sk.p.bit_length(), sk.q.bit_length())
        self._ep = modmath.exponent_digits(sk.p - 1, nbits)
        self._eq = modmath.exponent_digits(sk.q - 1, nbits)

    def get_n(self):
        return self.n

    def get_key_pair(self):
        return self.public_key, self.privacy_key

    # -- batched encrypt / decrypt ----------------------------------------

    def _obfuscators(self, count: int) -> list:
        # r must be cryptographically random: a torch.Generator is not
        rng = random.SystemRandom()
        return [rng.randrange(1, self.n) for _ in range(count)]

    def encrypt(self, values) -> np.ndarray:
        """values: object ints in [0, n) -> object-int ciphertexts mod n^2.

        The device computes s = r^n mod n^2 for the whole batch; the host
        assembles c = (1 + n*m) * s mod n^2."""
        vals = [int(v) for v in np.asarray(values, dtype=object).ravel()]
        r = modmath.to_limbs(self._obfuscators(len(vals)), self._ctx2.L)

        def job(i, r_chunk):
            ctx = self._on("ctx2", r_chunk.device)
            return modmath.mont_to(ctx, modmath.mont_exp_window(
                ctx, modmath.mont_from(ctx, r_chunk), self._ndigits))

        if self._fanned(len(vals)):
            s = torch.from_numpy(self._fanout.run(job, r))
        else:
            s = job(0, r.to(self.device))
        nsq = self.public_key.nsquare
        out = [((self.n * m + 1) % nsq) * si % nsq
               for m, si in zip(vals, modmath.from_limbs(s))]
        return np.array(out, dtype=object)

    def decrypt(self, ciphertexts) -> np.ndarray:
        """Aggregated ciphertexts -> plaintext sums (CRT, device modexp)."""
        cts = [int(c) for c in np.asarray(ciphertexts, dtype=object).ravel()]
        sk = self.privacy_key
        L = self._pair_ctx.L
        cp = modmath.to_limbs([c % sk.psquare for c in cts], L)
        cq = modmath.to_limbs([c % sk.qsquare for c in cts], L)

        def job(i, cp_chunk, cq_chunk):
            # chunks of 8 rows or more take mont_exp_rows, smaller ones the
            # mont_mul_vec chain (PairMontCtx.exp_pair)
            return self._on("pair", cp_chunk.device).exp_pair(
                cp_chunk, cq_chunk, self._ep, self._eq)

        if self._fanned(len(cts)):
            xp, xq = map(torch.from_numpy, self._fanout.run(job, cp, cq))
        else:
            xp, xq = job(0, cp.to(self.device), cq.to(self.device))
        out = []
        for xpi, xqi in zip(modmath.from_limbs(xp), modmath.from_limbs(xq)):
            mp = sk._l(xpi, sk.p) * sk.hp % sk.p
            mq = sk._l(xqi, sk.q) * sk.hq % sk.q
            u = (mp - mq) * sk.q_inverse % sk.p
            out.append((mq + u * sk.q) % self.n)
        return np.array(out, dtype=object)

    def add_ciphertexts(self, ct_arrays) -> np.ndarray:
        """Homomorphic aggregate: the elementwise product mod n^2.

        Distinct host arrays are converted and copied to the device once
        (id-dedup, with the host object kept alive so that its id cannot be
        recycled mid-iteration); the chain runs in the Montgomery domain."""
        ctx = self._ctx2
        dev = {}
        seq = []
        for arr in ct_arrays:
            entry = dev.get(id(arr))
            if entry is None:
                ints = [int(c) for c in np.asarray(arr, dtype=object).ravel()]
                d = modmath.to_limbs(ints, ctx.L).to(self.device)
                dev[id(arr)] = (arr, d)
            else:
                d = entry[1]
            seq.append(d)
        monts = [modmath.mont_from(ctx, x) for x in seq]
        acc = monts[0]
        for m in monts[1:]:
            acc = modmath.mont_mul(ctx, acc, m)
        out = modmath.from_limbs(modmath.mont_to(ctx, acc))
        return np.array(out, dtype=object)
