"""PyTorch port: the fixed-point float codec, the Paillier float facade and
re-encryption scheduling (flashe_tpu_torch/crypto/{fixedpoint,
encrypt_mode}.py, PaillierEncryptedNumber / FloatPaillier in
crypto/paillier.py), as tests/test_fixedpoint_encrypt_mode.py holds the JAX
package's; plus, where both packages are deterministic, the same encodings
and the same ciphertexts for the same obfuscator, and decrypts across the
packages under one key; and the calculator over a storage node's table,
whose maps and joins run in the node's egg processor."""

import random

import numpy as np
import pytest

from flashe_tpu.crypto.fixedpoint import FixedPointNumber as JFixedPointNumber
from flashe_tpu.crypto.paillier import FloatPaillier as JFloatPaillier
from flashe_tpu.crypto.paillier import (
    PaillierEncryptedNumber as JPaillierEncryptedNumber)
from flashe_tpu.crypto.paillier import PaillierPrivateKey as JPrivateKey
from flashe_tpu.crypto.paillier import PaillierPublicKey as JPublicKey
from flashe_tpu_torch.crypto.encrypt_mode import EncryptModeCalculator
from flashe_tpu_torch.crypto.fixedpoint import FixedPointNumber
from flashe_tpu_torch.crypto.paillier import (
    FloatPaillier, PaillierEncryptedNumber, PaillierKeypair,
)
from flashe_tpu_torch.data.remote_kv import StorageNode
from flashe_tpu_torch.data.table import init

VALUES = (0.0, 1.0, -1.0, 3.14159265, -2.71828e-7, 123456.789, 1e-12, 42,
          -7, 2.5e30)


def test_fixedpoint_roundtrip_and_arithmetic():
    for v in (0.0, 1.0, -1.0, 3.14159265, -2.71828e-7, 123456.789, 1e-12):
        assert FixedPointNumber.encode(v).decode() == pytest.approx(
            v, rel=1e-14)
    a = FixedPointNumber.encode(1.25)
    b = FixedPointNumber.encode(-0.75)
    assert (a + b).decode() == pytest.approx(0.5)
    assert (a - b).decode() == pytest.approx(2.0)
    assert (a * 4).decode() == pytest.approx(5.0)
    assert (a * b).decode() == pytest.approx(-0.9375)
    assert (a / 2).decode() == pytest.approx(0.625)
    assert (2.0 + a).decode() == pytest.approx(3.25)
    assert a > b and b < a and a >= 1.25 and a == 1.25 and a != 1.0
    # integer encoding keeps exponent 0
    assert FixedPointNumber.encode(42).exponent == 0
    # exponent alignment across magnitudes
    c = FixedPointNumber.encode(1e9) + FixedPointNumber.encode(1e-9)
    assert c.decode() == pytest.approx(1e9 + 1e-9)


@pytest.mark.parametrize("value", VALUES)
def test_fixedpoint_encodings_match_jax(value):
    port, ref = FixedPointNumber.encode(value), JFixedPointNumber.encode(value)
    assert (port.encoding, port.exponent) == (ref.encoding, ref.exponent)
    assert port.decode() == ref.decode()
    for precision in (1e-3, 2.0 ** -20):
        p = FixedPointNumber.encode(value, precision=precision)
        r = JFixedPointNumber.encode(value, precision=precision)
        assert (p.encoding, p.exponent) == (r.encoding, r.exponent)
    q = port.increase_exponent_to(port.exponent + 2)
    r = ref.increase_exponent_to(ref.exponent + 2)
    assert (q.encoding, q.exponent) == (r.encoding, r.exponent)
    s, t = port * -3.5 + 0.125, ref * -3.5 + 0.125
    assert (s.encoding, s.exponent) == (t.encoding, t.exponent)


@pytest.fixture(scope="module")
def small_keypair():
    # 512-bit: fast enough for unit tests, semantics identical
    return PaillierKeypair.generate_keypair(512)


def test_paillier_float_homomorphism(small_keypair):
    pub, priv = small_keypair
    cipher = FloatPaillier(pub, priv)
    x = cipher.encrypt(1.5)
    y = cipher.encrypt(-0.25)
    assert cipher.decrypt(x) == pytest.approx(1.5)
    assert cipher.decrypt(x + y) == pytest.approx(1.25)
    assert cipher.decrypt(x + 2.0) == pytest.approx(3.5)
    assert cipher.decrypt(x * 3.0) == pytest.approx(4.5)
    assert cipher.decrypt(x * -2.0) == pytest.approx(-3.0)
    assert cipher.decrypt(x - y) == pytest.approx(1.75)
    assert cipher.decrypt(sum([x, y, cipher.encrypt(0.75)], 0.0)
                          ) == pytest.approx(2.0)
    with pytest.raises(ValueError, match="no private key"):
        FloatPaillier(pub).decrypt(x)


def test_float_facade_across_the_packages(small_keypair):
    """Under one key, the same value and obfuscator give the same
    ciphertext and exponent in both packages, a JAX ciphertext decrypts in
    the port and the other way round, and the homomorphic ops agree."""
    pub, priv = small_keypair
    jpub = JPublicKey(pub.n)
    jpriv = JPrivateKey(jpub, priv.p, priv.q)
    rng = random.Random(11)
    for v in (1.5, -0.25, 3.0e-5, 12345.678, -9):
        r = rng.randrange(1, pub.n)
        port = PaillierEncryptedNumber.encrypt(pub, v, r)
        ref = JPaillierEncryptedNumber.encrypt(jpub, v, r)
        assert (port.ciphertext, port.exponent) == (ref.ciphertext,
                                                    ref.exponent)
        from_jax = PaillierEncryptedNumber(pub, ref.ciphertext, ref.exponent)
        assert from_jax.decrypt(priv) == ref.decrypt(jpriv)
        assert JFloatPaillier(jpub, jpriv).decrypt(
            JPaillierEncryptedNumber(jpub, port.ciphertext, port.exponent)
        ) == FloatPaillier(pub, priv).decrypt(port)
        for got, want in ((port * -2.5, ref * -2.5), (port + port, ref + ref),
                          (port * 4, ref * 4)):
            assert (got.ciphertext, got.exponent) == (want.ciphertext,
                                                      want.exponent)


@pytest.mark.parametrize("mode", ["strict", "fast", "balance",
                                  "confusion_opt"])
def test_encrypt_mode_calculator(small_keypair, mode):
    pub, priv = small_keypair
    cipher = FloatPaillier(pub, priv)
    calc = EncryptModeCalculator(cipher, mode=mode, re_encrypted_rate=0.5,
                                 rng=random.Random(0))
    s = init("emc")
    round1 = s.parallelize([1.0, -2.0, 3.5])
    enc1 = calc.encrypt(round1)
    got1 = sorted(cipher.decrypt(v) for _, v in enc1.collect())
    assert got1 == pytest.approx([-2.0, 1.0, 3.5])

    # second round with changed values must track the new plaintexts in
    # every mode (fast adds the diff homomorphically)
    round2 = s.parallelize([2.0, -1.0, 4.0])
    enc2 = calc.encrypt(round2)
    got2 = sorted(cipher.decrypt(v) for _, v in enc2.collect())
    assert got2 == pytest.approx([-1.0, 2.0, 4.0])


def test_encrypt_mode_calculator_arrays(small_keypair):
    pub, priv = small_keypair
    cipher = FloatPaillier(pub, priv)
    calc = EncryptModeCalculator(cipher, mode="fast")
    s = init("emc2")
    t1 = s.parallelize([np.array([1.0, 2.0]), np.array([3.0, 4.0])])
    e1 = calc.encrypt(t1)
    t2 = s.parallelize([np.array([1.5, 2.5]), np.array([3.5, 4.5])])
    e2 = calc.encrypt(t2)
    vals = [[cipher.decrypt(c) for c in row] for _, row in
            sorted(e2.collect())]
    assert vals == [pytest.approx([1.5, 2.5]), pytest.approx([3.5, 4.5])]
    assert len(e1.collect()) == 2


@pytest.mark.parametrize("mode", ["strict", "balance", "fast",
                                  "confusion_opt"])
def test_encrypt_mode_on_a_storage_node(small_keypair, tmp_path, mode):
    """The calculator over a storage node's tables: its encrypts, copies
    and joins run server-side in two rounds, and the second round's
    decrypts track the new values.  'strict' and 'balance' re-encrypt
    the second round in full, which fails with the JAX package's bound
    method (it cloudpickles the calculator and its tables' sockets)."""
    pub, priv = small_keypair
    cipher = FloatPaillier(pub, priv)
    node = StorageNode(str(tmp_path), native=False)
    try:
        s = init("emc_node", storage_addr=node.address)
        calc = EncryptModeCalculator(cipher, mode=mode)
        got = []
        for rnd, vals in enumerate(([0.5, -1.25, 8.0], [1.5, -0.25, 9.0])):
            t = s.table(f"round{rnd}", "ns", partition=2)
            t.put_all(enumerate(vals))
            enc = calc.encrypt(t)
            assert enc._remote()
            got.append({k: cipher.decrypt(v) for k, v in enc.collect()})
        assert got[0] == pytest.approx({0: 0.5, 1: -1.25, 2: 8.0})
        assert got[1] == pytest.approx({0: 1.5, 1: -0.25, 2: 9.0})
        s.stop()
    finally:
        node.shutdown()
