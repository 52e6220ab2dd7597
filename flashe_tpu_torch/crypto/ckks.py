"""CKKS baseline cipher (port of flashe_tpu/crypto/ckks.py; reference
federatedml/secureprotol/jzf_ckks.py, a TenSEAL wrapper): approximate HE
for floats, symmetric encryption, vector encrypt / decrypt and ciphertext
addition, the operations the aggregation uses.

Encode and decode are the canonical embedding with slots on the 5^j orbit,
by FFT in complex128 (torch.fft, on the cipher's device): evaluation at
zeta^(5^j) is DFT bin (5^j - 1) / 2 after a zeta^i pre-twist, and the
conjugate roots land at bins N - 1 - that.  pocketfft's last bits differ,
so an encoded coefficient can differ from the JAX package's by 1.  The ring
arithmetic is the port's RNS/NTT (ops/ntt.py).

Key generation draws what the JAX package draws from a numpy
RandomState(seed): one integer that seeds the encryption draws, then the
ternary secret, so the same seed gives the same secret.  Encryption draws
`a` uniform mod each prime and e = round(N(0, 1) x 3.2) clipped to +-19 on
the cipher's device from a torch.Generator seeded with that integer: the
JAX package's distributions, not its values.

Decryption reconstructs each centred coefficient from its residues as
sum_i c_i (q / p_i) - A q with A = round(sum_i c_i / p_i): exact mod 2^64,
which holds the coefficient whenever |coefficient| < 2^63 (it is about
scale x |value|).  The products wrap in int64, two's complement, as
torch's int64 multiply does on the CPU and on the card; the JAX package
computes the same in uint32 pairs.  The result is float64 (the JAX
package's is float32).

`set_local_devices` fans the ciphertext batch over several devices as BFV
does (crypto/bfv.py): each encrypt chunk draws from a generator of its
own, and each decrypt chunk reconstructs its coefficients on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from flashe_tpu_torch.crypto.bfv import (
    add_ciphertexts, centered_noise, fanout_for, ring_on)
from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.ops import ntt as nttmod
from flashe_tpu_torch.ops.ntt import residues

__all__ = ["CKKSCipher"]


def _k_for_degree(m: int) -> int:
    return {1024: 2, 2048: 2, 4096: 4, 8192: 6}.get(m, 6)


def _signed64(v: int) -> int:
    """v mod 2^64 as a two's-complement int64."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


class CKKSCipher:
    def __init__(self, poly_modulus_degree: int = 8192,
                 global_scale: float = 2.0 ** 40, seed: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.N = int(poly_modulus_degree)
        self.slots = self.N // 2
        self.scale = float(global_scale)
        self.k = _k_for_degree(self.N)
        primes = nttmod.find_ntt_primes(self.k, 30, 2 * self.N)
        self.ctx = nttmod.RnsContext(self.N, primes, self.device)
        self.q = self.ctx.q
        self._rng = np.random.RandomState(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(self._rng.randint(0, 2**31 - 1)))
        self.sk_ntt = None
        self.sk_coeffs = None

        r = np.empty(self.slots, np.int64)
        cur = 1
        for j in range(self.slots):
            r[j] = cur
            cur = (cur * 5) % (2 * self.N)
        self._bins = ((r - 1) // 2).astype(np.int64)
        self._twist = np.exp(1j * np.pi * np.arange(self.N) / self.N)
        self._bins_t = torch.from_numpy(self._bins).to(self.device)
        self._conj_bins_t = self.N - 1 - self._bins_t
        self._twist_t = torch.from_numpy(self._twist).to(self.device)

        # the centred reconstruction's constants: inv_i = ((q / p_i) mod
        # p_i)^-1, and q / p_i and q mod 2^64
        self._crt_inv = torch.tensor(
            [pow((self.q // p) % p, -1, p) for p in primes],
            dtype=torch.int64, device=self.device)[:, None]
        self._crt_qi64 = torch.tensor(
            [_signed64(self.q // p) for p in primes], dtype=torch.int64,
            device=self.device)[:, None]
        self._q64 = _signed64(self.q)
        self._fanout = None
        self._rings: dict = {}  # device -> the RNS context there

    def set_local_devices(self, n_shards=None, devices=None):
        """Fan this party's ciphertext batch over several devices (every
        visible card by default): encrypt and decrypt split a batch of at
        least 2 x n_shards rows into one chunk a device.  A 1-device
        fan-out disables the route."""
        self._fanout = fanout_for(n_shards, devices)

    def _fanned(self, rows: int) -> bool:
        return self._fanout is not None and rows >= 2 * self._fanout.n_shards

    # -- keys --------------------------------------------------------------

    def generate_keys(self):
        self._set_secret(self._rng.randint(-1, 2, self.N).astype(np.int64))
        return self

    def _set_secret(self, s: np.ndarray):
        self.sk_coeffs = s
        self.sk_ntt = nttmod.ntt(self.ctx, self.ctx.from_signed(s))

    def serialize_secret(self) -> bytes:
        return self.sk_coeffs.astype(np.int8).tobytes()

    def load_secret(self, blob: bytes):
        self._set_secret(np.frombuffer(blob, np.int8).astype(np.int64))
        return self

    # -- encode / decode (float64 and complex128) --------------------------

    def _encode(self, values) -> torch.Tensor:
        """(B, slots) floats -> (B, N) int64 coefficients, scaled."""
        v = torch.as_tensor(values, device=self.device).to(torch.complex128)
        spec = torch.zeros(v.shape[0], self.N, dtype=torch.complex128,
                           device=self.device)
        spec[:, self._bins_t] = v
        spec[:, self._conj_bins_t] = v.conj()
        coeffs = (torch.fft.fft(spec, dim=-1) / self.N / self._twist_t).real
        return torch.round(coeffs * self.scale).long()

    def _decode(self, coeffs) -> torch.Tensor:
        """(B, N) coefficients -> (B, slots) float64."""
        c = torch.as_tensor(coeffs, device=self.device).double()
        evals = torch.fft.ifft(c * self._twist_t, dim=-1) * self.N
        return evals[:, self._bins_t].real / self.scale

    # -- encrypt / decrypt / add -------------------------------------------

    def _pad(self, values, width: int) -> torch.Tensor:
        vals = torch.as_tensor(values, device=self.device).double().reshape(
            -1)
        n_ct = -(-vals.shape[0] // width)
        padded = torch.zeros(n_ct * width, dtype=torch.float64,
                             device=self.device)
        padded[: vals.shape[0]] = vals
        return padded.view(n_ct, width)

    def encrypt(self, values) -> torch.Tensor:
        """(n,) floats -> (ceil(n / slots), 2, k, N) ciphertexts."""
        return self._encrypt_polys(self._encode(self._pad(values,
                                                          self.slots)))

    def draw_noise(self, B: int, generator=None):
        """(a, e): a (B, k, N) uniform mod each prime, e (B, N) int64, from
        `generator` on its device (the cipher's generator by default)."""
        g = self._gen if generator is None else generator
        a = torch.stack([
            torch.randint(0, p, (B, self.N), generator=g, device=g.device,
                          dtype=torch.int64)
            for p in self.ctx.primes], dim=1).int()
        return a, centered_noise((B, self.N), g, g.device)

    def _encrypt_polys(self, pt, noise=None):
        """(B, N) int64 scaled coefficients -> (B, 2, k, N) ciphertexts:
            c0 = -a s + e + m,   c1 = a,   in the NTT domain.
        `noise` is (a, e) as draw_noise gives them, or None to draw them.
        Fanned out (noise drawn), each chunk draws from its own generator
        and the batch returns as host int32 numpy."""
        pt = torch.as_tensor(pt, device=self.device)
        if noise is None and self._fanned(pt.shape[0]):
            gens = self._fanout.generators(self._gen)
            return self._fanout.run(lambda i, chunk: self._encrypt_on(
                chunk, self.draw_noise(chunk.shape[0], gens[i])), pt)
        return self._encrypt_on(pt, noise if noise is not None
                                else self.draw_noise(pt.shape[0]))

    def _encrypt_on(self, pt, noise) -> torch.Tensor:
        dev = pt.device
        ctx = ring_on(self, dev)
        m_res = ctx.from_signed(pt)
        a, e = noise
        a_ntt = nttmod.ntt(ctx, residues(a, dev))
        em_ntt = nttmod.ntt(ctx, ctx.add(ctx.from_signed(
            torch.as_tensor(e).to(dev)), m_res))
        c0 = ctx.add(ctx.neg(ctx.mul(a_ntt, self.sk_ntt.to(dev))), em_ntt)
        return torch.stack([c0, a_ntt], dim=1)

    def _decrypt_coeff(self, cts) -> torch.Tensor:
        """(B, 2, k, N) -> (B, N) centred coefficients, float64, on the
        cipher's device; fanned out, each chunk on its device."""
        cts = residues(cts, self.device)
        if self._fanned(cts.shape[0]):
            return torch.from_numpy(self._fanout.run(
                lambda i, chunk: self._coeff_on(chunk), cts)).to(
                    self.device).double()
        return self._coeff_on(cts).double()

    def _coeff_on(self, cts) -> torch.Tensor:
        ctx = ring_on(self, cts.device)
        v = nttmod.intt(ctx, ctx.add(cts[:, 0], ctx.mul(
            cts[:, 1], self.sk_ntt.to(cts.device))))
        return self._centred(v)

    def _centred(self, v) -> torch.Tensor:
        """(B, k, N) residues -> (B, N) int64 centred values on v's device,
        exact for values below 2^63 in magnitude: sum_i c_i (q / p_i) - A q
        mod 2^64, the products wrapping."""
        v = torch.as_tensor(v)
        dev = v.device
        p = ring_on(self, dev).p
        c = v.long() * self._crt_inv.to(dev) % p
        A = torch.round((c.double() / p.double()).sum(dim=-2)).long()
        return (c * self._crt_qi64.to(dev)).sum(dim=-2) - A * self._q64

    def decrypt(self, cts, count: int) -> torch.Tensor:
        """The first `count` slot values, float64."""
        return self._decode(self._decrypt_coeff(cts)).reshape(-1)[:count]

    def encrypt_no_batch(self, values) -> torch.Tensor:
        """One value a ciphertext, in slot 0 (the reference's _no_batch
        variants, jzf_ckks.py:60-84)."""
        vals = torch.as_tensor(values, device=self.device).double().reshape(
            -1)
        pts = torch.zeros(vals.shape[0], self.slots, dtype=torch.float64,
                          device=self.device)
        pts[:, 0] = vals
        return self._encrypt_polys(self._encode(pts))

    def decrypt_no_batch(self, cts, count: int) -> torch.Tensor:
        return self._decode(self._decrypt_coeff(cts))[:, 0][:count]

    def add_ciphertexts(self, ct_arrays) -> torch.Tensor:
        return add_ciphertexts(self.ctx, ct_arrays)
