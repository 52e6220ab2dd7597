"""PyTorch port: the stock FATE random pads (flashe_tpu_torch/crypto/
random_pads.py) on the CPU, as tests/test_random_pads.py holds the JAX
package's.

- Three clients' pairwise pads cancel in the sum (within 1e-5 of the plain
  sum, float32 rounding of pads of size ~1), while each masked vector lies
  far from its plaintext; the JAX package's pads cancel the same way on
  the same inputs.
- The two members of a pair draw the same pad, bit for bit, with opposite
  signs set by uuid order; each draw of a stream is a fresh pad.
- A stream is deterministic in its secret (and only in its low 32 bits,
  the reference's MT19937 seed): the same secret gives the same draws,
  another secret others.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from flashe_tpu.crypto.random_pads import PadsCipher as JPadsCipher
from flashe_tpu_torch.crypto.random_pads import PadsCipher, RandomPads

UUIDS = ["a-1", "b-2", "c-3"]


def _exchanged(seed=0):
    """Each client's exchanged_keys: {uuid: (idx, secret, role, comm_idx)},
    the secret of a pair the same on both sides."""
    rng = np.random.RandomState(seed)
    secrets = {}
    for i, u in enumerate(UUIDS):
        for v in UUIDS[i:]:
            secrets[tuple(sorted((u, v)))] = int(rng.randint(1, 1 << 30))
    return {me: {other: (idx, secrets[tuple(sorted((me, other)))], "host",
                         idx)
                 for idx, other in enumerate(UUIDS)} for me in UUIDS}


def _ciphers(cls, exchanged, **kw):
    out = []
    for u in UUIDS:
        c = cls(**kw)
        c.set_self_uuid(u)
        c.set_exchanged_keys(exchanged[u])
        out.append(c)
    return out


def test_pads_cancel_in_the_sum():
    rng = np.random.RandomState(1)
    flats = [rng.randn(257).astype(np.float32) for _ in UUIDS]
    exchanged = _exchanged()
    want = np.sum(flats, axis=0)
    for rnd in range(2):  # a fresh pad every round
        masked = [c.encrypt(torch.from_numpy(f)) for c, f in zip(
            _ciphers(PadsCipher, exchanged, device="cpu"), flats)]
        for m, f in zip(masked, flats):
            assert m.dtype == torch.float32
            assert float((m - torch.from_numpy(f)).abs().max()) > 0.1
        agg = sum(masked)
        np.testing.assert_allclose(agg.numpy(), want, rtol=0, atol=1e-5)
        assert np.array_equal(
            PadsCipher(device="cpu").decrypt(agg).numpy(), agg.numpy())
    jmasked = [np.asarray(c.encrypt(jnp.asarray(f))) for c, f in zip(
        _ciphers(JPadsCipher, exchanged), flats)]
    np.testing.assert_allclose(np.sum(jmasked, axis=0), want, rtol=0,
                               atol=1e-5)


def test_a_pairs_streams_agree_with_opposite_signs():
    exchanged = _exchanged(2)
    a, b, _ = _ciphers(PadsCipher, exchanged, device="cpu")
    sign_a, pads_a = a._pads[0]  # a's pad with b
    sign_b, pads_b = b._pads[0]  # b's pad with a
    assert (sign_a, sign_b) == (1.0, -1.0)  # "a-1" < "b-2"
    first = pads_a.randn(1000)
    assert torch.equal(first, pads_b.randn(1000))
    second = pads_a.randn(1000)
    assert torch.equal(second, pads_b.randn(1000))
    assert not torch.equal(first, second)
    assert abs(float(first.std()) - 1.0) < 0.1


def test_streams_are_deterministic_per_secret():
    a, b = RandomPads(42, device="cpu"), RandomPads(42, device="cpu")
    assert torch.equal(a.randn(8), b.randn(8))
    assert torch.equal(a.randn(3, 4), b.randn(3, 4))
    # the seed is the secret's low 32 bits, as the reference's MT19937
    high = RandomPads(42 + (7 << 32), device="cpu")
    assert torch.equal(RandomPads(42, device="cpu").randn(8), high.randn(8))
    assert not torch.equal(RandomPads(43, device="cpu").randn(8),
                           RandomPads(42, device="cpu").randn(8))
