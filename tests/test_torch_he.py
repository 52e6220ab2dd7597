"""PyTorch port: the BFV and CKKS ciphers (flashe_tpu_torch/crypto/bfv.py,
ckks.py) against flashe_tpu/crypto/{bfv,ckks}.py on the CPU.

BFV at (t = 1032193, m = 64) and (t = 1964769281, m = 64), batching; CKKS
at N = 64, scale 2^40.  Each JAX cipher is built once for the module, and
while the module runs the JAX package's ntt and intt are called through
jax.jit (one compile a context and shape, where its eager key generation
compiles every op of every stage): integer ops give the same bits either
way.

- The same seed gives the same keys, bit for bit: BFV's secret, its NTT
  and the public key; CKKS's secret.
- With the noise injected (u, e1, e2 for BFV; a, e for CKKS) the port's
  ciphertexts equal the JAX package's encryption formula on the same draws,
  bit for bit, in the same bit-reversed NTT order.
- A JAX ciphertext decrypts in the port, and a port ciphertext in the JAX
  package; a mixed 3-ciphertext sum decrypts to the sum in both.
- BFV: batch encode and decode, `_round_crt` and `noise_level` equal the
  JAX package's; the no-batch path (one value a ciphertext, coefficient 0)
  round-trips and decrypts in the JAX package.
- CKKS: the encode is within +-1 of the JAX package's coefficients (two
  FFT libraries' last bits); decoding the same coefficients agrees within
  1e-12; decrypted slots lie within 1e-7 of the values (JAX's own float32
  decrypt within 1e-6); the no-batch path round-trips; the centred
  reconstruction is exact against python ints near +-2^62.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.crypto.bfv import BFVCipher as JBFV
from flashe_tpu.crypto.ckks import CKKSCipher as JCKKS
from flashe_tpu.ops import ntt as jntt
from flashe_tpu_torch.crypto.bfv import BFVCipher
from flashe_tpu_torch.crypto.ckks import CKKSCipher

N = 64
BFV_T = (1032193, 1964769281)
BFV_SEED, CKKS_SEED = 5, 3
CKKS_TOL = 1e-7  # a decrypted slot against its value: noise / scale


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_transforms():
    jitted = {}

    def through_jit(fn):
        def call(ctx, x):
            key = (fn, id(ctx))
            if key not in jitted:  # keeps ctx alive, so its id stays unique
                jitted[key] = (ctx, jax.jit(functools.partial(fn, ctx)))
            return jitted[key][1](x)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jntt, "ntt", through_jit(jntt.ntt))
        mp.setattr(jntt, "intt", through_jit(jntt.intt))
        yield


@functools.lru_cache(maxsize=None)
def _bfv(t):
    """(JAX cipher, port cipher), same seed, keys made."""
    return (JBFV(t, N, flagBatching=True, seed=BFV_SEED).generate_keys(),
            BFVCipher(t, N, flagBatching=True, seed=BFV_SEED,
                      device="cpu").generate_keys())


@functools.lru_cache(maxsize=None)
def _ckks():
    return (JCKKS(N, seed=CKKS_SEED).generate_keys(),
            CKKSCipher(N, seed=CKKS_SEED, device="cpu").generate_keys())


@pytest.fixture(scope="module", params=BFV_T, ids=["t20", "t31"])
def bfv(request):
    return _bfv(request.param)


@pytest.fixture(scope="module")
def ckks():
    return _ckks()


# -- BFV -------------------------------------------------------------------

def test_bfv_same_seed_keys_match_jax(bfv):
    j, p = bfv
    assert p.k == j.k and p.ctx.primes == j.ctx.primes and p.q == j.q
    np.testing.assert_array_equal(p.sk_coeffs, j.sk_coeffs)
    np.testing.assert_array_equal(_u32(p.sk_ntt), np.asarray(j.sk_ntt))
    for mine, ref in zip(p.public_parts(), j.pk):
        assert mine.dtype == np.uint32
        np.testing.assert_array_equal(mine, ref)
    assert p.serialize_secret() == j.serialize_secret()


def _jax_bfv_formula(j, pt, u, e1, e2):
    """flashe_tpu/crypto/bfv.py::encrypt_polys's chain on given noise."""
    ctx = j.ctx

    def res(x):
        return jnp.asarray(j._to_res(np.asarray(x, np.int64)))

    @jax.jit
    def run(pt_res, u, e1, e2, pk0, a_ntt, delta):
        u_ntt = jntt.ntt(ctx, u)
        ct0 = ctx.add(ctx.add(ctx.mul(pk0, u_ntt), jntt.ntt(ctx, e1)),
                      jntt.ntt(ctx, ctx.mul(pt_res, delta)))
        ct1 = ctx.add(ctx.mul(a_ntt, u_ntt), jntt.ntt(ctx, e2))
        return jnp.stack([ct0, ct1], axis=1)

    delta = jnp.asarray(np.broadcast_to(j._delta_res, (j.k, j.N)).copy())
    return np.asarray(run(res(pt), res(u), res(e1), res(e2),
                          jnp.asarray(j.pk[0]), jnp.asarray(j.pk[1]), delta))


def test_bfv_injected_noise_ciphertexts_match_jax_formula(bfv):
    j, p = bfv
    rng = np.random.RandomState(1)
    B = 3
    pt = rng.randint(0, j.t, (B, N)).astype(np.int64)
    u = rng.randint(-1, 2, (B, N))
    e1, e2 = (np.clip(np.round(rng.randn(B, N) * 3.2), -19, 19).astype(
        np.int64) for _ in range(2))
    got = p.encrypt_polys(pt, noise=(u, e1, e2))
    assert got.shape == (B, 2, p.k, N) and got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got),
                                  _jax_bfv_formula(j, pt, u, e1, e2))


def test_bfv_ciphertexts_decrypt_across_packages(bfv):
    j, p = bfv
    rng = np.random.RandomState(2)
    n = 150  # three ciphertexts, the last partly filled
    m = [rng.randint(0, 1 << 16, n).astype(np.uint32) for _ in range(3)]
    jct = np.asarray(j.encrypt(m[0]))
    pct = [p.encrypt(m[1]), p.encrypt(torch.from_numpy(m[2].view(np.int32)))]
    assert jct.shape == tuple(pct[0].shape) == (3, 2, p.k, N)
    np.testing.assert_array_equal(p.decrypt(jct, n).numpy(), m[0])
    np.testing.assert_array_equal(j.decrypt(_u32(pct[0]), n), m[1])
    want = sum(x.astype(np.int64) for x in m) % j.t
    agg = p.add_ciphertexts([pct[0], jct, pct[1]])
    np.testing.assert_array_equal(p.decrypt(agg, n).numpy(), want)
    np.testing.assert_array_equal(j.decrypt(_u32(agg), n), want)


def test_bfv_batch_encode_decode_match_jax(bfv):
    j, p = bfv
    rng = np.random.RandomState(3)
    slots = rng.randint(0, j.t, (2, N)).astype(np.uint32)
    slots[0, :3] = (0, 1, j.t - 1)
    coeffs = j._encode_batch(slots)
    np.testing.assert_array_equal(_u32(p._encode_batch(slots)), coeffs)
    np.testing.assert_array_equal(_u32(p._decode_batch(coeffs)),
                                  j._decode_batch(coeffs))
    np.testing.assert_array_equal(_u32(p._decode_batch(coeffs)), slots)


def test_bfv_round_crt_and_noise_level_match_jax(bfv):
    j, p = bfv
    rng = np.random.RandomState(4)
    primes = np.array(j.ctx.primes, np.int64)[:, None]
    v = (rng.randint(0, 1 << 31, (4, j.k, N)) % primes).astype(np.uint32)
    v[0, :, 0] = 0
    v[1] = (primes - 1).astype(np.uint32)
    got = p._round_crt(v)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), j._round_crt(v))
    ct = p.encrypt(rng.randint(0, 1 << 16, N).astype(np.uint32))
    assert p.noise_level(ct) == j.noise_level(_u32(ct)) > 10


def test_bfv_no_batch_paths():
    t = BFV_T[0]
    p = BFVCipher(t, N, flagBatching=False, seed=BFV_SEED,
                  device="cpu").generate_keys()
    msgs = np.array([0, 1, 5, t - 1, 77777], np.uint32)
    cts = p.encrypt(msgs)
    assert cts.shape == (5, 2, p.k, N)
    np.testing.assert_array_equal(p.decrypt(cts, 5).numpy(), msgs)
    # the same key (same seed) in the JAX package's no-batch decrypt
    jn = JBFV(t, N, flagBatching=False, seed=BFV_SEED)
    jn.load_secret(p.serialize_secret())
    np.testing.assert_array_equal(jn.decrypt(_u32(cts), 5), msgs)
    agg = p.add_ciphertexts([cts, cts, p.encrypt(msgs)])
    np.testing.assert_array_equal(p.decrypt(agg, 4).numpy(),
                                  3 * msgs[:4].astype(np.int64) % t)


def test_bfv_batching_needs_t_one_mod_2m():
    with pytest.raises(ValueError, match="1 mod 2m"):
        BFVCipher(1000003, N, flagBatching=True, device="cpu")


def test_bfv_set_local_devices_raises():
    """set_local_devices is ported (fanned rounds:
    tests/test_torch_parallel.py): more shards than devices raise, and a
    one-device fan-out leaves the route off."""
    p = _bfv(BFV_T[1])[1]
    with pytest.raises(ValueError, match="3 > 2 local devices"):
        p.set_local_devices(3, ["cpu"] * 2)
    p.set_local_devices(1, ["cpu"])
    assert p._fanout is None
    p.set_local_devices(2, ["cpu"] * 2)
    assert p._fanout.n_shards == 2
    p.set_local_devices(1, ["cpu"])


# -- CKKS ------------------------------------------------------------------

def test_ckks_same_seed_keys_match_jax(ckks):
    j, p = ckks
    assert p.ctx.primes == j.ctx.primes and p.k == j.k == 6
    np.testing.assert_array_equal(p.sk_coeffs, j.sk_coeffs)
    np.testing.assert_array_equal(_u32(p.sk_ntt), np.asarray(j.sk_ntt))
    np.testing.assert_array_equal(p._bins, j._bins)


def test_ckks_encode_within_one_and_decode_match_jax(ckks):
    j, p = ckks
    rng = np.random.RandomState(5)
    vals = rng.randn(4, N // 2) * np.array([[1e-3], [0.5], [30.0], [1e3]])
    coeffs = p._encode(vals)
    assert coeffs.dtype == torch.int64
    assert np.max(np.abs(coeffs.numpy() - j._encode(vals))) <= 1
    ref = j._encode(vals)
    np.testing.assert_allclose(p._decode(ref).numpy(), j._decode(ref),
                               rtol=0, atol=1e-12)


def _jax_ckks_formula(j, pt, a, e):
    """flashe_tpu/crypto/ckks.py::_encrypt_polys's chain on given noise
    (the residues of the plaintext taken on the host)."""
    ctx = j.ctx

    @jax.jit
    def run(m_res, a, e_res, sk):
        a_ntt = jntt.ntt(ctx, a)
        c0 = ctx.add(ctx.neg(ctx.mul(a_ntt, sk)),
                     ctx.add(jntt.ntt(ctx, e_res), jntt.ntt(ctx, m_res)))
        return jnp.stack([c0, a_ntt], axis=1)

    return np.asarray(run(jnp.asarray(j._to_res(pt)), jnp.asarray(a),
                          jnp.asarray(j._to_res(e)), j.sk_ntt))


def test_ckks_injected_noise_ciphertexts_match_jax_formula(ckks):
    j, p = ckks
    rng = np.random.RandomState(6)
    B = 2
    pt = j._encode(rng.randn(B, N // 2))
    primes = np.array(j.ctx.primes, np.int64)[:, None]
    a = (rng.randint(0, 1 << 31, (B, j.k, N)) % primes).astype(np.uint32)
    e = np.clip(np.round(rng.randn(B, N) * 3.2), -19, 19).astype(np.int64)
    got = p._encrypt_polys(torch.from_numpy(pt), noise=(a, e))
    np.testing.assert_array_equal(_u32(got), _jax_ckks_formula(j, pt, a, e))


def test_ckks_ciphertexts_decrypt_across_packages(ckks):
    j, p = ckks
    rng = np.random.RandomState(7)
    n = 80  # three ciphertexts of 32 slots
    v = [rng.randn(n) * 0.5 for _ in range(3)]
    jct = np.asarray(j.encrypt(v[0]))
    pct = [p.encrypt(v[1]), p.encrypt(torch.from_numpy(v[2]))]
    assert jct.shape == tuple(pct[0].shape) == (3, 2, 6, N)
    got = p.decrypt(jct, n)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), v[0], rtol=0, atol=CKKS_TOL)
    np.testing.assert_allclose(j.decrypt(_u32(pct[0]), n), v[1], rtol=0,
                               atol=1e-6)
    agg = p.add_ciphertexts([pct[0], jct, pct[1]])
    want = v[0] + v[1] + v[2]
    np.testing.assert_allclose(p.decrypt(agg, n).numpy(), want, rtol=0,
                               atol=CKKS_TOL)
    np.testing.assert_allclose(j.decrypt(_u32(agg), n), want, rtol=0,
                               atol=1e-6)


def test_ckks_no_batch_paths(ckks):
    _, p = ckks
    vals = np.array([0.0, 1.5, -2.25, 1e-4, 123.456])
    cts = p.encrypt_no_batch(vals)
    assert cts.shape == (5, 2, 6, N)
    np.testing.assert_allclose(p.decrypt_no_batch(cts, 5).numpy(), vals,
                               rtol=0, atol=CKKS_TOL)
    agg = p.add_ciphertexts([cts, cts])
    np.testing.assert_allclose(p.decrypt_no_batch(agg, 3).numpy(),
                               2 * vals[:3], rtol=0, atol=CKKS_TOL)


def test_ckks_centred_reconstruction_exact_near_2_62(ckks):
    _, p = ckks
    rng = np.random.RandomState(8)
    xs = [0, 1, -1, 2**62, -(2**62), 2**62 + 12345, -(2**62) - 6789,
          2**63 - 1, -(2**63) + 1, 2**40 * 3 + 7, -(2**40) * 5 - 3]
    xs += [int(v) for v in rng.randint(-(2**62), 2**62, N - len(xs),
                                       dtype=np.int64)]
    v = np.array([[x % pr for x in xs] for pr in p.ctx.primes],
                 np.int64)[None].astype(np.int32)
    got = p._centred(torch.from_numpy(v))
    assert got[0].tolist() == xs


def test_ckks_set_local_devices_raises(ckks):
    """As BFV's: too many shards raise, one device leaves the route off."""
    p = ckks[1]
    with pytest.raises(ValueError, match="3 > 2 local devices"):
        p.set_local_devices(3, ["cpu"] * 2)
    p.set_local_devices(2, ["cpu"] * 2)
    assert p._fanout.n_shards == 2
    p.set_local_devices(1, ["cpu"])
    assert p._fanout is None
