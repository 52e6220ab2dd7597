"""BFV baseline cipher (port of flashe_tpu/crypto/bfv.py; reference
federatedml/secureprotol/jzf_bfv.py, a Pyfhel/SEAL wrapper).

Textbook BFV (Fan-Vercauteren) with public-key encryption over the port's
RNS/NTT ring (ops/ntt.py): q is k NTT primes of 30 bits, k set by the ring
degree and by t as in the JAX package, and ciphertexts (B, 2, k, N) int32
live in the NTT domain, so the arbiter's aggregate is an elementwise sum
mod each prime.  Batching packs N slots mod t into a ciphertext by the
inverse slot NTT on the one-prime context t.

Key generation draws what the JAX package draws, in its order, from a
numpy RandomState(seed): first one integer that seeds the encryption
noise, then the ternary secret, `a` prime by prime, and `e`.  The same seed
gives the same keys, bit for bit.  The encryption noise (u ternary, e1 and
e2 round(N(0, 1) x 3.2) clipped to +-19) is drawn on the cipher's device
from a torch.Generator seeded with that first integer: the distributions
of the JAX package's threefry draws, not their values.  `encrypt_polys`
takes the noise from its caller instead, so that both packages can be fed
the same draws.

Decryption rounds t [c0 + c1 s] / q without big integers (`_round_crt`):
with c_i = |v_i inv_i|_{p_i}, the result is sum_i floor(c_i t / p_i) plus
the rounded float64 sum of the fractions, mod t; on the card this runs
where the intt left its residues.

`set_local_devices` fans the ciphertext batch over several devices
(parallel/fanout.DeviceFanout), as the JAX package does: encrypt draws each
chunk's noise from a torch.Generator of its own, seeded from the cipher's
(so the ciphertexts differ from the unfanned ones, as the JAX package's
do), and the decrypts take each chunk's c0 + c1 s on its device.  A
device other than the cipher's gets an RNS context of its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device, same_device
from flashe_tpu_torch.ops import ntt as nttmod
from flashe_tpu_torch.ops.ntt import residues

__all__ = ["BFVCipher"]


def _k_for_degree(m: int) -> int:
    if m <= 2048:
        return 2
    if m <= 4096:
        return 4
    return 6


def centered_noise(shape, generator, device) -> torch.Tensor:
    """round(N(0, 1) x 3.2) clipped to +-19, int64."""
    e = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return torch.clamp(torch.round(e * 3.2), -19, 19).long()


class BFVCipher:
    """Context, keys and batched encrypt / decrypt (reference
    jzf_bfv.py:55-233)."""

    def __init__(self, p: int, m: int = 2048, sec: int = 128,
                 flagBatching: bool = False, seed: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.t = int(p)
        self.N = int(m)
        self.sec = sec
        self.batching = flagBatching
        # q must dominate the decrypt rounding term m (q mod t) / q ~ t^2/q
        # as well as the noise: q >= t^2 2^30
        k_for_t = -(-(2 * self.t.bit_length() + 30) // 30)
        self.k = max(_k_for_degree(self.N), k_for_t)
        primes = nttmod.find_ntt_primes(self.k, 30, 2 * self.N)
        self.ctx = nttmod.RnsContext(self.N, primes, self.device)
        self.q = self.ctx.q
        self.delta = self.q // self.t
        self._delta_res = torch.tensor(
            [self.delta % p for p in primes], dtype=torch.int64,
            device=self.device)[:, None]
        if flagBatching:
            if (self.t - 1) % (2 * self.N) != 0:
                raise ValueError(
                    "batching requires plaintext modulus = 1 mod 2m")
            self.slot_ctx = nttmod.RnsContext(self.N, [self.t], self.device)
        self._rng = np.random.RandomState(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(self._rng.randint(0, 2**31 - 1)))
        self.sk_coeffs = None
        self.sk_ntt = None
        self.pk = None
        # the CRT constant of _round_crt: inv_i = ((q / p_i) mod p_i)^-1
        self._crt_inv = torch.tensor(
            [pow((self.q // p) % p, -1, p) for p in primes],
            dtype=torch.int64, device=self.device)[:, None]
        self._fanout = None
        self._rings: dict = {}  # device -> the RNS context there

    def set_local_devices(self, n_shards=None, devices=None):
        """Fan this party's ciphertext batch over several devices (the
        reference's per-silo per-ciphertext Pool, jzf_bfv.py:116-173),
        every visible card by default: encrypt and decrypt split a batch
        of at least 2 x n_shards rows into one chunk a device.  A 1-device
        fan-out disables the route."""
        self._fanout = fanout_for(n_shards, devices)

    def _fanned(self, rows: int) -> bool:
        return self._fanout is not None and rows >= 2 * self._fanout.n_shards

    # -- keys (the guest makes them; hosts receive the secret AES-wrapped) -

    def generate_keys(self):
        rng = self._rng
        s = rng.randint(-1, 2, self.N).astype(np.int64)
        a = np.stack([rng.randint(0, p, self.N, dtype=np.int64)
                      for p in self.ctx.primes])
        e = np.clip(np.round(rng.randn(self.N) * 3.2), -19, 19).astype(
            np.int64)
        self._set_secret(s)
        ctx = self.ctx
        a_ntt = nttmod.ntt(ctx, residues(a.astype(np.int32), self.device))
        e_ntt = nttmod.ntt(ctx, ctx.from_signed(e))
        pk0 = ctx.neg(ctx.add(ctx.mul(a_ntt, self.sk_ntt), e_ntt))
        self.pk = (pk0, a_ntt)  # both halves in the NTT domain
        return self

    def _set_secret(self, s: np.ndarray):
        self.sk_coeffs = s
        self.sk_ntt = nttmod.ntt(self.ctx, self.ctx.from_signed(s))

    def serialize_secret(self) -> bytes:
        return self.sk_coeffs.astype(np.int8).tobytes()

    def load_secret(self, blob: bytes):
        self._set_secret(np.frombuffer(blob, np.int8).astype(np.int64))
        return self

    def public_parts(self):
        """(pk0, a) as host uint32 numpy, the JAX package's form, so that
        they travel over any transport."""
        return tuple(x.cpu().numpy().view(np.uint32) for x in self.pk)

    def set_public_parts(self, pk):
        self.pk = tuple(residues(x, self.device) for x in pk)
        return self

    # -- encode / encrypt --------------------------------------------------

    def _encode_batch(self, values) -> torch.Tensor:
        """(B, N) slot values mod t -> (B, N) coefficients mod t: the inverse
        slot NTT on the one-prime context t."""
        slots = residues(values, self.device)[..., None, :]
        return nttmod.intt(self.slot_ctx, slots)[..., 0, :]

    def _decode_batch(self, coeffs) -> torch.Tensor:
        x = residues(coeffs, self.device)[..., None, :]
        return nttmod.ntt(self.slot_ctx, x)[..., 0, :]

    def draw_noise(self, B: int, generator=None):
        """(u, e1, e2), each (B, N) int64, from `generator` on its device
        (the cipher's generator by default)."""
        g = self._gen if generator is None else generator
        shape, d = (B, self.N), g.device
        return (torch.randint(-1, 2, shape, generator=g, device=d),
                centered_noise(shape, g, d), centered_noise(shape, g, d))

    def encrypt_polys(self, pt_coeffs, noise=None):
        """(B, N) plaintext coefficients mod t -> (B, 2, k, N) ciphertexts
        in the NTT domain, on the cipher's device:
            ct0 = pk0 u + e1 + delta m,   ct1 = a u + e2.
        `noise` is (u, e1, e2), each (B, N) signed integers, or None to
        draw them.  Fanned out (set_local_devices, noise drawn), each chunk
        draws from its own generator and the batch returns as host int32
        numpy, as the JAX package's fan-out returns it."""
        pt = torch.as_tensor(pt_coeffs, device=self.device).long()
        B = pt.shape[0]
        if noise is None and self._fanned(B):
            gens = self._fanout.generators(self._gen)
            return self._fanout.run(lambda i, chunk: self._encrypt_on(
                chunk, self.draw_noise(chunk.shape[0], gens[i])), pt)
        return self._encrypt_on(pt, noise if noise is not None
                                else self.draw_noise(B))

    def _encrypt_on(self, pt, noise) -> torch.Tensor:
        """encrypt_polys on pt's device.  The NTT is linear, so e1 +
        delta m and e2 each take one transform."""
        dev = pt.device
        ctx = ring_on(self, dev)
        pk0, pk1 = (x.to(dev) for x in self.pk)
        u, e1, e2 = (torch.as_tensor(x).to(dev) for x in noise)
        u_ntt = nttmod.ntt(ctx, ctx.from_signed(u))
        dm = pt[:, None, :] % ctx.p * self._delta_res.to(dev) % ctx.p
        ct0 = nttmod.ntt(ctx, ctx.add(dm, ctx.from_signed(e1)))
        ct0 = ctx.add(ctx.mul(pk0, u_ntt), ct0)
        ct1 = nttmod.ntt(ctx, ctx.from_signed(e2))
        ct1 = ctx.add(ctx.mul(pk1, u_ntt), ct1)
        return torch.stack([ct0, ct1], dim=1)

    def encrypt(self, values) -> torch.Tensor:
        """Values < t -> ciphertexts: N slots a ciphertext with batching,
        else one value a ciphertext in coefficient 0 (the reference's
        no-batch inflation)."""
        vals = residues(values, self.device).reshape(-1)
        if self.batching:
            n_ct = -(-vals.shape[0] // self.N)
            padded = torch.zeros(n_ct * self.N, dtype=torch.int32,
                                 device=self.device)
            padded[: vals.shape[0]] = vals
            pt = self._encode_batch(padded.view(n_ct, self.N))
        else:
            pt = torch.zeros(vals.shape[0], self.N, dtype=torch.int32,
                             device=self.device)
            pt[:, 0] = vals
        return self.encrypt_polys(pt)

    # -- decrypt -----------------------------------------------------------

    def _phase(self, cts, coeffs=None) -> torch.Tensor:
        """c0 + c1 s, back in the coefficient domain: (B, k, N), or its
        first `coeffs` coefficients (B, k, coeffs).  Fanned out, each chunk
        on its device, gathered to the cipher's."""
        cts = residues(cts, self.device)
        if self._fanned(cts.shape[0]):
            return residues(self._fanout.run(
                lambda i, chunk: self._phase_on(chunk, coeffs), cts),
                self.device)
        return self._phase_on(cts, coeffs)

    def _phase_on(self, cts, coeffs=None) -> torch.Tensor:
        ctx = ring_on(self, cts.device)
        v = nttmod.intt(ctx, ctx.add(cts[:, 0], ctx.mul(
            cts[:, 1], self.sk_ntt.to(cts.device))))
        return v if coeffs is None else v[:, :, :coeffs]

    def decrypt_polys(self, cts) -> torch.Tensor:
        """(B, 2, k, N) -> (B, N) plaintext coefficients mod t, int64."""
        return self._round_crt(self._phase(cts))

    def _round_crt(self, v) -> torch.Tensor:
        """(B, k, N) residues of c0 + c1 s -> round(t v / q) mod t, (B, N)
        int64.  With c_i = |v_i inv_i|_{p_i}, t v / q = sum_i c_i t / p_i
        - A t for an integer A: the quotients floor(c_i t / p_i) are exact
        in int64 (c_i t < 2^62) and the fractions' float64 sum is rounded."""
        p, t = self.ctx.p, self.t
        c = residues(v, self.device).long() * self._crt_inv % p
        ct_prod = c * t
        u = (ct_prod // p) % t
        frac = (ct_prod % p).double() / p.double()
        m = u.sum(dim=-2) + torch.round(frac.sum(dim=-2)).long()
        return m % t

    def decrypt(self, cts, count: int) -> torch.Tensor:
        """The first `count` values, int32 (each below t < 2^31)."""
        if self.batching:
            pt = self.decrypt_polys(cts)
            return self._decode_batch(pt.int()).reshape(-1)[:count]
        # no batching: only coefficient 0 of each ciphertext carries a value
        v0 = self._phase(cts, coeffs=1)
        return self._round_crt(v0)[:count, 0].int()

    def add_ciphertexts(self, ct_arrays) -> torch.Tensor:
        return add_ciphertexts(self.ctx, ct_arrays)

    def noise_level(self, cts) -> float:
        """Remaining noise budget in bits (reference jzf_bfv.py:228-233),
        on host python ints."""
        v = self._phase(cts).cpu().numpy()
        q, t = self.q, self.t
        worst = 1
        for b in range(v.shape[0]):
            ints = _crt_to_int(v[b], self.ctx.primes, q)
            m = (ints * t + q // 2) // q % t
            noise = (ints - m * self.delta) % q
            centered = [int(x) if x < q // 2 else int(x) - q for x in noise]
            worst = max(worst, max(abs(c) for c in centered))
        return math.log2(q / (2 * t)) - math.log2(max(worst, 1))


def fanout_for(n_shards, devices):
    """A DeviceFanout over `devices`, or None where it has one device."""
    from flashe_tpu_torch.parallel.fanout import DeviceFanout

    f = DeviceFanout(n_shards, devices)
    return f if f.n_shards > 1 else None


def ring_on(cipher, device) -> nttmod.RnsContext:
    """The cipher's RNS context on `device`: its own on its device, else a
    copy built there once."""
    if same_device(device, cipher.device):
        return cipher.ctx
    device = torch.device(device)
    if device not in cipher._rings:
        cipher._rings[device] = nttmod.RnsContext(cipher.N, cipher.ctx.primes,
                                                  device)
    return cipher._rings[device]


def _crt_to_int(res: np.ndarray, primes, q: int) -> np.ndarray:
    """(k, N) residues -> object ints in [0, q)."""
    total = np.zeros(res.shape[-1], dtype=object)
    for ki, p in enumerate(primes):
        qi = q // p
        total += res[ki].astype(object) * (qi * pow(qi % p, -1, p))
    return total % q


def add_ciphertexts(ctx: nttmod.RnsContext, ct_arrays) -> torch.Tensor:
    """The aggregate of ciphertexts on ctx's device.  Each distinct host
    array is moved there once (an upload that appears twice is added twice
    but copied once)."""
    moved, seq = {}, []
    for ct in ct_arrays:
        if id(ct) not in moved:
            moved[id(ct)] = (ct, residues(ct, ctx.device))
        seq.append(moved[id(ct)][1])
    return seq[0] if len(seq) == 1 else ctx.sum(seq)
