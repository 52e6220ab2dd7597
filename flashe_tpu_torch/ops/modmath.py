"""Fixed-limb modular bignum arithmetic (port of flashe_tpu/ops/modmath.py).

Big numbers are (B, L) int32 tensors of uint32 little-endian limbs,
L = ceil(bits / 32) and R = 2^(32 L).  The JAX package uses 16-bit limbs,
R = 2^(16 ceil(bits / 16)): the two R agree exactly when ceil(bits / 16) is
even, which holds for every Paillier modulus of a standard key, so only
there does a Montgomery-form value equal the JAX package's.  Plain-domain
results (products leaving the domain, modexp outputs) always agree.

Every Montgomery product goes through ops/montgomery.py: the hand-written
CUDA kernels for a CUDA tensor, their plain torch versions for a CPU tensor.
Host conversions to and from python ints are copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.ops import montgomery

__all__ = ["MontCtx", "PairMontCtx", "to_limbs", "from_limbs",
           "exponent_digits", "mont_mul", "mont_from", "mont_to",
           "mont_mul_v", "mont_exp_window"]

_LIMB_BITS = 32
_W = montgomery.WINDOW


def _nlimbs(n: int) -> int:
    return -(-n.bit_length() // _LIMB_BITS)


def _n_prime(n: int) -> int:
    """-n^-1 mod 2^32, as the int32 bit pattern the kernels take."""
    v = (-pow(n, -1, 1 << _LIMB_BITS)) % (1 << _LIMB_BITS)
    return v - (1 << 32) if v >= 1 << 31 else v


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def to_limbs(values, L: int) -> torch.Tensor:
    """python ints -> (B, L) int32 CPU tensor of uint32 limbs."""
    nbytes = 4 * L
    if len(values) == 0:
        return torch.zeros((0, L), dtype=torch.int32)
    try:
        buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    except OverflowError as e:
        raise ValueError("value does not fit in L limbs") from e
    return torch.from_numpy(np.frombuffer(buf, dtype="<i4").reshape(
        len(values), L).astype(np.int32))


def from_limbs(limbs: torch.Tensor) -> list:
    """(B, L) int32 limb tensor (any device) -> python ints."""
    a = np.ascontiguousarray(limbs.cpu().numpy().astype("<i4"))
    nbytes = 4 * a.shape[1]
    buf = a.tobytes()
    return [int.from_bytes(buf[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(a.shape[0])]


def exponent_digits(e: int, nbits: int) -> np.ndarray:
    """MSB-first base-2^w digit array of an exponent (nbits padded),
    w = 4 (montgomery.WINDOW)."""
    ndig = -(-nbits // _W)
    return np.array(
        [(e >> (_W * (ndig - 1 - i))) & ((1 << _W) - 1) for i in range(ndig)],
        np.int32)


# ---------------------------------------------------------------------------
# Montgomery contexts and products
# ---------------------------------------------------------------------------

class MontCtx:
    """Montgomery context for an odd modulus n over L 32-bit limbs."""

    def __init__(self, n: int, device="cuda"):
        if n % 2 == 0:
            raise ValueError("modulus must be odd")
        self.n = n
        self.device = resolve_device(device)
        self.L = _nlimbs(n)
        if self.L > montgomery.MAX_LIMBS:
            raise ValueError(f"modulus too large (L > {montgomery.MAX_LIMBS})")
        self.R = 1 << (_LIMB_BITS * self.L)
        self.n_prime = _n_prime(n) & 0xFFFFFFFF
        self.r2 = (self.R * self.R) % n
        self.n_limbs, self.r2_limbs, self.one_mont = to_limbs(
            [n, self.r2, self.R % n], self.L).to(self.device)


def mont_mul(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod n; a, b (B, L) limbs below n."""
    return montgomery.mont_mul(a, b, ctx.n_limbs, ctx.n_prime)


def _limb_one(x: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(x)
    one[:, 0] = 1
    return one


def mont_from(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    """Enter the Montgomery domain: x*R mod n."""
    return mont_mul(ctx, x, ctx.r2_limbs.expand_as(x).contiguous())


def mont_to(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    """Leave the Montgomery domain: x*R^-1 mod n."""
    return mont_mul(ctx, x, _limb_one(x))


def mont_mul_v(a: torch.Tensor, b: torch.Tensor, n_limbs: torch.Tensor,
               n_prime: torch.Tensor) -> torch.Tensor:
    """Montgomery product with a per-row modulus: n_limbs (B, L), n_prime
    (B,) int32 bit patterns of -n^-1 mod 2^32."""
    return montgomery.mont_mul_vec(a, b, n_limbs, n_prime)


def mont_exp_window(ctx: MontCtx, base_mont: torch.Tensor,
                    edigits) -> torch.Tensor:
    """Fixed-window (w = 4) modexp in the Montgomery domain: 2^w - 1 table
    products, then w squarings and one table multiply per MSB-first digit.

    edigits is a PUBLIC exponent (Paillier's n): the table entry is taken
    by a host index on the digit.  The secret CRT exponents of decryption
    go through PairMontCtx.exp_pair, which selects in constant time."""
    table = [ctx.one_mont.expand_as(base_mont).contiguous()]
    for _ in range((1 << _W) - 1):
        table.append(mont_mul(ctx, table[-1], base_mont))
    acc = table[0]
    for d in np.asarray(edigits).tolist():
        for _ in range(_W):
            acc = mont_mul(ctx, acc, acc)
        acc = mont_mul(ctx, acc, table[d])
    return acc


class PairMontCtx:
    """Two same-width moduli run as one per-row-modulus batch.

    Paillier CRT decryption runs c^(p-1) mod p^2 and c^(q-1) mod q^2, two
    windowed exponent scans of identical depth; rows [0:B) reduce mod n1 and
    rows [B:2B) mod n2, which halves the sequential chain.
    """

    def __init__(self, n1: int, n2: int, device="cuda"):
        self.device = resolve_device(device)
        L = max(_nlimbs(n1), _nlimbs(n2))
        if L > montgomery.MAX_LIMBS:
            raise ValueError(f"modulus too large (L > {montgomery.MAX_LIMBS})")
        self.L = L
        R = 1 << (_LIMB_BITS * L)
        dev = self.device
        self.n_pat = to_limbs([n1, n2], L).to(dev)                    # (2, L)
        self.npr_pat = torch.tensor([_n_prime(n1), _n_prime(n2)],
                                    dtype=torch.int32, device=dev)    # (2,)
        self.r2_pat = to_limbs([(R * R) % n1, (R * R) % n2], L).to(dev)
        self.one_pat = to_limbs([R % n1, R % n2], L).to(dev)

    def exp_pair(self, c1: torch.Tensor, c2: torch.Tensor, ed1, ed2):
        """(c1^e1 mod n1, c2^e2 mod n2), plain domain in and out.

        c1, c2: (B, L) limbs; ed1, ed2: (ndig,) MSB-first base-16 digits of
        equal length (pad the shorter exponent).  B >= 8 runs the fused
        modexp (one mont_exp_rows launch); B < 8 a chain of per-row-modulus
        products, as the JAX package routes them."""
        B = c1.shape[0]
        a = torch.cat([c1, c2])
        mod_idx = torch.cat([
            torch.zeros(B, dtype=torch.int32, device=a.device),
            torch.ones(B, dtype=torch.int32, device=a.device)])
        digits = torch.as_tensor(np.stack([np.asarray(ed1, np.int32),
                                           np.asarray(ed2, np.int32)]),
                                 device=a.device)                 # (2, ndig)
        if B >= 8:
            out = montgomery.mont_exp_rows(a, mod_idx, self.n_pat,
                                           self.npr_pat, self.r2_pat,
                                           self.one_pat, digits)
        else:
            out = self._exp_chain(a, mod_idx.long(), digits)
        return out[:B], out[B:]

    def _exp_chain(self, a, idx, digits):
        """The windowed scan as single products (mont_mul_v); each digit's
        table entry is selected on the device over all 16 entries."""
        nl, npr = self.n_pat[idx], self.npr_pat[idx]
        base = mont_mul_v(a, self.r2_pat[idx], nl, npr)
        one = self.one_pat[idx]
        table = [one]
        for _ in range((1 << _W) - 1):
            table.append(mont_mul_v(table[-1], base, nl, npr))
        tbl = torch.stack(table)                                  # (16, 2B, L)
        row_digits = digits.long()[idx]                           # (2B, ndig)
        acc = one
        for s in range(row_digits.shape[1]):
            for _ in range(_W):
                acc = mont_mul_v(acc, acc, nl, npr)
            acc = mont_mul_v(acc, montgomery.select_entry(
                tbl, row_digits[:, s]), nl, npr)
        return mont_mul_v(acc, _limb_one(acc), nl, npr)
