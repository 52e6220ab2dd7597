"""PyTorch port: Montgomery arithmetic against the JAX package and python
oracles, on the CPU (the plain versions of the three CUDA kernels).

The port's limbs are 32 bits, R = 2^(32 L); the JAX package's are 16 bits.
At 256- and 512-bit moduli the two R agree, so Montgomery-form values
compare bit-exact with the JAX package.  At 250 bits they differ, and the
port is held to python oracles: a*b*R^-1 mod n and pow.  Every comparison
is bit-exact.  The JAX side runs its XLA path (no Pallas on the CPU); each
JAX shape compiles once, so the cases share shapes.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.ops import modmath as jm
from flashe_tpu_torch.ops import modmath as pm
from flashe_tpu_torch.ops import montgomery

RNG_SEED = 0x3D0D


def _modulus(rng, bits, top_ones=False):
    n = rng.getrandbits(bits) | 1 | (1 << (bits - 1))
    if top_ones:  # the top 32-bit limb all ones
        n |= 0xFFFFFFFF << (bits - 32)
    return n


def _operands(rng, n, count):
    """count values below n, led by the edges 0, 1 and n - 1."""
    vals = [0, 1, n - 1] + [rng.randrange(n) for _ in range(count)]
    return vals[:count]


def _j(vals, L):
    return jnp.asarray(jm.to_limbs(vals, L))


def _ints(x):
    return pm.from_limbs(x) if isinstance(x, torch.Tensor) else \
        jm.from_limbs(np.asarray(x))


def test_limbs_roundtrip_and_digits():
    vals = [0, 1, (1 << 500) - 3, 123456789 ** 5, (1 << 512) - 1]
    limbs = pm.to_limbs(vals, 16)
    assert limbs.dtype == torch.int32 and tuple(limbs.shape) == (5, 16)
    assert pm.from_limbs(limbs) == vals
    # the same bits as the JAX package's 16-bit limbs
    j16 = jm.to_limbs(vals, 32).reshape(5, 16, 2).astype(np.int64)
    np.testing.assert_array_equal(
        limbs.numpy().view(np.uint32), (j16[..., 0] | (j16[..., 1] << 16)))
    assert pm.from_limbs(pm.to_limbs([], 4)) == []
    with pytest.raises(ValueError):
        pm.to_limbs([1 << 128], 4)
    e = (1 << 1023) | 0x1234567
    np.testing.assert_array_equal(pm.exponent_digits(e, 1024),
                                  jm.exponent_digits(e, 1024))


@pytest.mark.parametrize("bits,B", [(256, 3), (512, 9)])
def test_mont_mul_from_to_match_jax(bits, B):
    rng = random.Random(RNG_SEED + bits)
    n = _modulus(rng, bits)
    pc, jc = pm.MontCtx(n, device="cpu"), jm.MontCtx(n)
    assert pc.R == jc.R and pc.L * 2 == jc.L
    a, b = _operands(rng, n, B), _operands(rng, n, B)[::-1]
    pa, pb = pm.to_limbs(a, pc.L), pm.to_limbs(b, pc.L)
    ja, jb = _j(a, jc.L), _j(b, jc.L)
    got = pm.mont_mul(pc, pa, pb)
    assert _ints(got) == _ints(jm.mont_mul(jc, ja, jb))
    assert _ints(got) == [x * y * pow(pc.R, -1, n) % n for x, y in zip(a, b)]
    assert _ints(pm.mont_from(pc, pa)) == _ints(jm.mont_from(jc, ja))
    assert _ints(pm.mont_to(pc, pa)) == _ints(jm.mont_to(jc, ja))
    assert _ints(pm.mont_to(pc, pm.mont_mul(pc, pm.mont_from(pc, pa),
                                             pm.mont_from(pc, pb)))) == [
        x * y % n for x, y in zip(a, b)]


def test_mont_mul_v_matches_jax():
    rng = random.Random(RNG_SEED + 1)
    n1, n2 = _modulus(rng, 256), _modulus(rng, 256)
    B = 5
    a = _operands(rng, n1, B) + _operands(rng, n2, B)
    b = _operands(rng, n1, B)[::-1] + _operands(rng, n2, B)[::-1]
    mods = [n1] * B + [n2] * B
    npr16 = [(-pow(m, -1, 1 << 16)) % (1 << 16) for m in mods]
    want = jm.mont_mul_v(_j(a, 16), _j(b, 16), _j(mods, 16),
                         jnp.asarray(np.array(npr16, np.uint32)))
    npr32 = torch.tensor([pm._n_prime(m) for m in mods], dtype=torch.int32)
    got = pm.mont_mul_v(pm.to_limbs(a, 8), pm.to_limbs(b, 8),
                        pm.to_limbs(mods, 8), npr32)
    assert _ints(got) == _ints(want)


def test_mont_exp_window_matches_jax():
    rng = random.Random(RNG_SEED + 2)
    n = _modulus(rng, 256)
    pc, jc = pm.MontCtx(n, device="cpu"), jm.MontCtx(n)
    base = _operands(rng, n, 3)
    e = rng.getrandbits(64) | (1 << 63)
    digits = pm.exponent_digits(e, 64)
    jbase = jm.mont_from(jc, _j(base, jc.L))
    want = jm.mont_exp_window(jc, jbase, jnp.asarray(digits))
    got = pm.mont_exp_window(pc, pm.mont_from(pc, pm.to_limbs(base, pc.L)),
                             digits)
    assert _ints(got) == _ints(want)
    assert _ints(pm.mont_to(pc, got)) == [pow(x, e, n) for x in base]


@pytest.mark.parametrize("B", [3, 9])  # the product chain, then the fused exp
def test_exp_pair_matches_jax(B):
    rng = random.Random(RNG_SEED + 3)
    n1, n2 = _modulus(rng, 256), _modulus(rng, 256)
    c1, c2 = _operands(rng, n1, B), _operands(rng, n2, B)
    e1, e2 = rng.getrandbits(64), rng.getrandbits(60)
    d1, d2 = pm.exponent_digits(e1, 64), pm.exponent_digits(e2, 64)
    jp, pp = jm.PairMontCtx(n1, n2), pm.PairMontCtx(n1, n2, device="cpu")
    jx1, jx2 = jp.exp_pair(_j(c1, jp.L), _j(c2, jp.L), d1, d2)
    x1, x2 = pp.exp_pair(pm.to_limbs(c1, pp.L), pm.to_limbs(c2, pp.L), d1, d2)
    assert _ints(x1) == _ints(jx1) == [pow(c, e1, n1) for c in c1]
    assert _ints(x2) == _ints(jx2) == [pow(c, e2, n2) for c in c2]


@pytest.mark.parametrize("bits,top_ones", [(250, False), (256, True),
                                           (1024, True)])
def test_products_against_oracles(bits, top_ones):
    """R = 2^(32 L) where the JAX package's differs (250 bits), and moduli
    whose top limb is 0xFFFFFFFF, where the CIOS result most often needs
    its overflow limb; operands include 0, 1 and n - 1."""
    rng = random.Random(RNG_SEED + bits)
    n = _modulus(rng, bits, top_ones)
    ctx = pm.MontCtx(n, device="cpu")
    Rinv = pow(ctx.R, -1, n)
    a = _operands(rng, n, 6)
    b = [n - 1, n - 1, n - 1, 1, 0, rng.randrange(n)]
    pa, pb = pm.to_limbs(a, ctx.L), pm.to_limbs(b, ctx.L)
    want = [x * y * Rinv % n for x, y in zip(a, b)]
    assert _ints(pm.mont_mul(ctx, pa, pb)) == want
    n2 = _modulus(rng, bits, top_ones)
    a2, b2 = [x % n2 for x in a], [x % n2 for x in b]
    npr = torch.tensor([pm._n_prime(n)] * 6 + [pm._n_prime(n2)] * 6,
                       dtype=torch.int32)
    got = pm.mont_mul_v(pm.to_limbs(a + a2, ctx.L), pm.to_limbs(b + b2, ctx.L),
                        pm.to_limbs([n] * 6 + [n2] * 6, ctx.L), npr)
    Rinv2 = pow(ctx.R, -1, n2)
    assert _ints(got) == want + [x * y * Rinv2 % n2 for x, y in zip(a2, b2)]
    e = rng.getrandbits(40)
    got = pm.mont_to(ctx, pm.mont_exp_window(
        ctx, pm.mont_from(ctx, pa), pm.exponent_digits(e, 40)))
    assert _ints(got) == [pow(x, e, n) for x in a]


@pytest.mark.parametrize("B", [1, 8])
def test_exp_pair_against_pow_with_overflow_moduli(B):
    rng = random.Random(RNG_SEED + 4)
    n1, n2 = _modulus(rng, 250, True), _modulus(rng, 250)
    pp = pm.PairMontCtx(n1, n2, device="cpu")
    c1, c2 = _operands(rng, n1, B), _operands(rng, n2, B)
    e1, e2 = rng.getrandbits(32), 1
    d1, d2 = pm.exponent_digits(e1, 32), pm.exponent_digits(e2, 32)
    x1, x2 = pp.exp_pair(pm.to_limbs(c1, pp.L), pm.to_limbs(c2, pp.L), d1, d2)
    assert _ints(x1) == [pow(c, e1, n1) for c in c1]
    assert _ints(x2) == c2


def test_mont_exp_rows_mixes_moduli_per_row():
    """Rows of three moduli, interleaved, in one call of the fused modexp's
    plain version; the B = 0 edge returns no rows."""
    rng = random.Random(RNG_SEED + 5)
    mods = [_modulus(rng, 128) for _ in range(3)]
    L = 4
    R = 1 << (32 * L)
    exps = [rng.getrandbits(24) for _ in range(3)]
    idx = [0, 2, 1, 1, 0, 2, 2]
    a = [rng.randrange(mods[k]) for k in idx]
    tabs = dict(
        n_tab=pm.to_limbs(mods, L),
        npr_tab=torch.tensor([pm._n_prime(m) for m in mods],
                             dtype=torch.int32),
        r2_tab=pm.to_limbs([R * R % m for m in mods], L),
        one_tab=pm.to_limbs([R % m for m in mods], L),
        dig_tab=torch.from_numpy(np.stack(
            [pm.exponent_digits(e, 24) for e in exps])))
    got = montgomery.mont_exp_rows(
        pm.to_limbs(a, L), torch.tensor(idx, dtype=torch.int32), **tabs)
    assert _ints(got) == [pow(x, exps[k], mods[k]) for x, k in zip(a, idx)]
    empty = montgomery.mont_exp_rows(
        pm.to_limbs([], L), torch.zeros(0, dtype=torch.int32), **tabs)
    assert tuple(empty.shape) == (0, L)


def test_select_entry_reads_the_digit_entry():
    tbl = torch.arange(16 * 3 * 2, dtype=torch.int32).reshape(16, 3, 2) - 40
    digit = torch.tensor([15, 0, 7])
    want = torch.stack([tbl[15, 0], tbl[0, 1], tbl[7, 2]])
    assert torch.equal(montgomery.select_entry(tbl, digit), want)


def test_cpu_runs_plain_versions_and_other_devices_raise():
    before = dict(montgomery.launches)
    ctx = pm.MontCtx(_modulus(random.Random(7), 64), device="cpu")
    x = pm.to_limbs([3, 5], ctx.L)
    pm.mont_to(ctx, pm.mont_from(ctx, x))
    assert montgomery.launches == before
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        montgomery.mont_mul(x.to("meta"), x.to("meta"),
                            ctx.n_limbs.to("meta"), ctx.n_prime)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.MontCtx(0xFFFFFFFB, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.PairMontCtx(0xFFFFFFFB, 0xFFFFFFF1, device="cuda")
