"""PyTorch port: the RNS/NTT ring (flashe_tpu_torch/ops/ntt.py) against
flashe_tpu/ops/ntt.py on the CPU.

- find_ntt_primes and the primitive 2N-th roots equal the JAX package's;
- ntt and intt equal the JAX transforms bit for bit (jitted there, so that
  each shape compiles once) at N in {64, 1024} and k in {1 (the BFV slot
  prime t), 2, 6}, over batch dimensions, and intt inverts ntt;
- intt(ntt(a) * ntt(b)) is the negacyclic convolution, against python
  ints;
- RnsContext.mul / add / sub / neg / sum equal the JAX context's ops (and
  python ints), bit for bit, including the operands 0 and p - 1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.ops import ntt as jntt
from flashe_tpu_torch.ops import ntt as pntt

T_SLOT = 1964769281  # the BFV plaintext modulus of the configurations


def _primes(N, k):
    return [T_SLOT] if k == 1 else jntt.find_ntt_primes(k, 30, 2 * N)


@functools.lru_cache(maxsize=None)
def _contexts(N, k):
    primes = _primes(N, k)
    return jntt.RnsContext(N, primes), pntt.RnsContext(N, primes,
                                                       device="cpu")


def _random_residues(rng, primes, shape):
    return np.stack([rng.randint(0, p, shape, dtype=np.int64)
                     for p in primes], axis=-2).astype(np.uint32)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("N", [64, 1024, 8192])
@pytest.mark.parametrize("k", [2, 4, 6])
def test_primes_and_roots_match_jax(N, k):
    primes = pntt.find_ntt_primes(k, 30, 2 * N)
    assert primes == jntt.find_ntt_primes(k, 30, 2 * N)
    for p in primes + [T_SLOT]:
        assert pntt._is_prime(p) and (p - 1) % (2 * N) == 0
        root = pntt._primitive_2n_root(p, 2 * N)
        assert root == jntt._primitive_2n_root(p, 2 * N)
        assert pow(root, N, p) == p - 1


@pytest.mark.parametrize("N,k,batch", [
    (64, 1, (5,)), (64, 2, (2, 3)), (64, 6, ()), (1024, 1, (3,)),
    (1024, 2, (2,)), (1024, 6, (2, 2))])
def test_ntt_intt_match_jax_bit_for_bit(N, k, batch):
    jctx, pctx = _contexts(N, k)
    rng = np.random.RandomState(N + k)
    x = _random_residues(rng, jctx.primes, batch + (N,))
    want = np.asarray(jax.jit(lambda v: jntt.ntt(jctx, v))(jnp.asarray(x)))
    got = pntt.ntt(pctx, pntt.residues(x, "cpu"))
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(_u32(got), want)
    back_want = np.asarray(jax.jit(lambda v: jntt.intt(jctx, v))(
        jnp.asarray(want)))
    back = pntt.intt(pctx, got)
    np.testing.assert_array_equal(_u32(back), back_want)
    np.testing.assert_array_equal(_u32(back), x)


def test_pointwise_product_is_the_negacyclic_convolution():
    N = 64
    _, ctx = _contexts(N, 2)
    rng = np.random.RandomState(2)
    a_int = [int(v) for v in rng.randint(-1000, 1000, N)]
    b_int = [int(v) for v in rng.randint(-1000, 1000, N)]
    conv = [0] * N
    for i in range(N):
        for j in range(N):
            sign = 1 if i + j < N else -1  # X^N = -1
            conv[(i + j) % N] += sign * a_int[i] * b_int[j]
    fa = pntt.ntt(ctx, ctx.from_signed(np.array(a_int)))
    fb = pntt.ntt(ctx, ctx.from_signed(np.array(b_int)))
    got = pntt.intt(ctx, ctx.mul(fa, fb)).numpy()
    for ki, p in enumerate(ctx.primes):
        assert got[ki].tolist() == [c % p for c in conv]


@pytest.mark.parametrize("k", [1, 2, 6])
def test_ring_ops_match_jax_bit_for_bit(k):
    N = 64
    jctx, pctx = _contexts(N, k)
    rng = np.random.RandomState(10 + k)
    a = _random_residues(rng, jctx.primes, (3, N))
    b = _random_residues(rng, jctx.primes, (3, N))
    p = np.array(jctx.primes, np.uint32)[:, None]
    a[0, :, :2] = 0  # the edges of every op
    b[0, :, 0] = 0
    a[1, :, :] = p - 1
    b[1, :, :N // 2] = p - 1
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pa, pb = pntt.residues(a, "cpu"), pntt.residues(b, "cpu")
    for name in ("mul", "add", "sub"):
        want = np.asarray(getattr(jctx, name)(ja, jb))
        np.testing.assert_array_equal(_u32(getattr(pctx, name)(pa, pb)),
                                      want, err_msg=name)
    np.testing.assert_array_equal(_u32(pctx.neg(pa)),
                                  np.asarray(jctx.neg(ja)))
    want = np.asarray(functools.reduce(jctx.add, [ja, jb, ja, jb, jb]))
    np.testing.assert_array_equal(_u32(pctx.sum([pa, pb, pa, pb, pb])),
                                  want)
    a64, b64 = a.astype(object), b.astype(object)
    pp = np.array(pctx.primes, dtype=object)[:, None]
    np.testing.assert_array_equal(pctx.mul(pa, pb).numpy().astype(object),
                                  a64 * b64 % pp)


def test_from_signed_is_the_residues_of_signed_coefficients():
    _, ctx = _contexts(64, 2)
    c = np.array([-(2**62), -19, -1, 0, 1, 19, 2**62 - 1] + [0] * 57)
    got = ctx.from_signed(c).numpy()
    for ki, p in enumerate(ctx.primes):
        assert got[ki].tolist() == [int(v) % p for v in c]
