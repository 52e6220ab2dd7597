"""RNS / NTT ring arithmetic for the BFV and CKKS baselines (port of
flashe_tpu/ops/ntt.py).

The ring is R_q = Z_q[X]/(X^N + 1) with q a product of NTT-friendly primes
below 2^31, held as residue tensors shaped (..., k, N): int32, each value a
canonical residue in [0, p), so the same bits as the JAX package's uint32
tensors.  Arithmetic runs in int64, where a product of two residues is
below 2^62 and `(a * b) % p` is exact: the JAX package's 16-bit-split
products and 32-bit Montgomery reductions are there only because the TPU's
vector unit has no 32x32 -> 64 multiply, and give the same canonical values.

`ntt` is the JAX package's transform stage for stage: a negacyclic forward
NTT by the psi twist, then decimation in frequency, natural order in and
bit-reversed order out; `intt` is decimation in time from that order back
to natural order, then N^-1 psi^-i.  Ciphertexts live and travel in that
bit-reversed NTT domain, so a ciphertext of the port is the same array as
one of the JAX package for the same key, plaintext and noise.  The stages
are torch ops; the twiddles of every stage are computed once a context, on
its device.
"""

from __future__ import annotations

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device

__all__ = ["RnsContext", "ntt", "intt", "find_ntt_primes", "residues"]


# ---------------------------------------------------------------------------
# host: prime and root discovery (copied from the JAX package, so that the
# primes and roots are the same)
# ---------------------------------------------------------------------------

def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(count: int, bits: int, two_n: int) -> list[int]:
    """`count` primes p ~ 2^bits with p = 1 mod two_n (for 2N-th roots)."""
    out = []
    p = ((1 << bits) // two_n) * two_n + 1
    while len(out) < count:
        if p.bit_length() <= bits and _is_prime(p):
            out.append(p)
        p -= two_n
        if p < (1 << (bits - 1)):
            raise RuntimeError("not enough NTT primes")
    return out


def _primitive_2n_root(p: int, two_n: int) -> int:
    """A primitive two_n-th root of unity mod p."""
    for g in range(2, 1000):
        r = pow(g, (p - 1) // two_n, p)
        if pow(r, two_n // 2, p) == p - 1:  # order exactly two_n
            return r
    raise RuntimeError("no 2N-th root found")


def _powers(base: int, n: int, p: int) -> np.ndarray:
    """base^i mod p for i < n, as int64, by doubling: every product of two
    residues below 2^31 fits in int64."""
    out = np.ones(n, np.int64)
    step, m = base % p, 1
    while m < n:
        take = min(m, n - m)
        out[m:m + take] = out[:take] * step % p
        step, m = step * step % p, 2 * m
    return out


# ---------------------------------------------------------------------------
# device: residue tensors
# ---------------------------------------------------------------------------

def residues(x, device) -> torch.Tensor:
    """A residue tensor on `device`: tensors moved there, host numpy (the
    JAX package's uint32, or int32) viewed as int32."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.ascontiguousarray(x)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    arr = arr.astype(np.int32, copy=False)
    if not arr.flags.writeable:  # torch shares the buffer, writably
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


class RnsContext:
    """An RNS basis with its NTT tables on `device`.

    `p` is (k, 1) int64, so that it broadcasts over (..., k, N); `psi` and
    `ipsi_ninv` are the (k, N) twist tables (psi^i, and psi^-i N^-1); `tw`
    and `itw` the (k, 1, half) twiddles of each stage, omega^(span j) and
    its inverse, omega = psi^2, as the JAX package's tables hold them
    (there in the Montgomery domain)."""

    def __init__(self, N: int, primes: list[int], device="cuda"):
        self.device = resolve_device(device)
        self.N = N
        self.logN = N.bit_length() - 1
        if 1 << self.logN != N:
            raise ValueError("N must be a power of two")
        self.primes = [int(p) for p in primes]
        self.k = len(primes)
        self.q = int(np.prod(self.primes, dtype=object))

        psi, ipsi_ninv, omega, iomega = [], [], [], []
        for p in self.primes:
            root = _primitive_2n_root(p, 2 * N)
            iroot = pow(root, -1, p)
            psi.append(_powers(root, N, p))
            ipsi_ninv.append(_powers(iroot, N, p) * pow(N, -1, p) % p)
            omega.append(_powers(root * root % p, N // 2, p))
            iomega.append(_powers(iroot * iroot % p, N // 2, p))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.p = dev(np.array(self.primes, np.int64)[:, None])
        self.psi = dev(np.stack(psi))
        self.ipsi_ninv = dev(np.stack(ipsi_ninv))
        omega, iomega = np.stack(omega), np.stack(iomega)
        self.tw, self.itw = [], []
        for s in range(self.logN):
            # stage s has `span` blocks; omega^span has order 2^(s + 1)
            span = N >> (s + 1)
            self.tw.append(dev(omega[:, ::span][:, None, :]))
            self.itw.append(dev(iomega[:, ::span][:, None, :]))

    # -- elementwise ring ops over (..., k, N) int32 residues --------------

    def mul(self, a, b) -> torch.Tensor:
        return (a.long() * b.long() % self.p).int()

    def add(self, a, b) -> torch.Tensor:
        s = a.long() + b.long()
        return torch.where(s >= self.p, s - self.p, s).int()

    def sub(self, a, b) -> torch.Tensor:
        d = a.long() - b.long()
        return torch.where(d < 0, d + self.p, d).int()

    def neg(self, a) -> torch.Tensor:
        return torch.where(a == 0, a.long(), self.p - a.long()).int()

    def sum(self, xs) -> torch.Tensor:
        """The sum of residue tensors: added in int64 (each below 2^31, so
        2^32 of them cannot overflow) and reduced once, the same canonical
        residues as a chain of `add`."""
        acc = xs[0].long()
        for x in xs[1:]:
            acc = acc + x.long()
        return (acc % self.p).int()

    def from_signed(self, coeffs) -> torch.Tensor:
        """Signed integer coefficients (..., N) -> (..., k, N) residues."""
        c = torch.as_tensor(coeffs, device=self.device).long()
        return torch.remainder(c[..., None, :], self.p).int()


def ntt(ctx: RnsContext, x: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward NTT: (..., k, N) int32 -> (..., k, N) int32.

    Decimation in frequency: natural input, bit-reversed output.  Pointwise
    products and `intt` (DIT, bit-reversed in, natural out) use the same
    order, so intt(ntt(a) * ntt(b)) is the negacyclic convolution."""
    N, lead = ctx.N, x.shape[:-1]
    p3 = ctx.p[:, :, None]
    y = x.long() * ctx.psi % ctx.p
    for s in reversed(range(ctx.logN)):
        half = 1 << s
        yr = y.view(*lead, N // (2 * half), 2, half)
        a, b = yr[..., 0, :], yr[..., 1, :]
        top = a + b
        top = torch.where(top >= p3, top - p3, top)
        bot = torch.remainder((a - b) * ctx.tw[s], p3)
        y = torch.stack([top, bot], dim=-2).view(*lead, N)
    return y.int()


def intt(ctx: RnsContext, x: torch.Tensor) -> torch.Tensor:
    """Negacyclic inverse NTT (DIT; the inverse of `ntt` exactly)."""
    N, lead = ctx.N, x.shape[:-1]
    p3 = ctx.p[:, :, None]
    y = x.long()
    for s in range(ctx.logN):
        half = 1 << s
        yr = y.view(*lead, N // (2 * half), 2, half)
        a = yr[..., 0, :]
        t = yr[..., 1, :] * ctx.itw[s] % p3
        top = a + t
        top = torch.where(top >= p3, top - p3, top)
        bot = a - t
        bot = torch.where(bot < 0, bot + p3, bot)
        y = torch.stack([top, bot], dim=-2).view(*lead, N)
    return (y * ctx.ipsi_ninv % ctx.p).int()
