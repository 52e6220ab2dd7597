"""PyTorch port: the session setup (uuid sync, DH, the seed and key wraps)
on the CPU.

- crypto/dh.py agrees with the JAX package's on every group and on the same
  secrets;
- the port's AES-256-CTR (crypto/aes_host.py, on its own AES) is bit-exact
  with flashe_tpu.crypto.aes_host (the `cryptography` library) for 32-byte
  seeds and for odd-length blobs split over several calls, and the key
  wraps of protocol/blocks/_keywrap.py equal the JAX ones;
- a whole session over run_roles, 1 guest + 3 hosts: the ordinals are
  guest 0 and hosts 1-3, every client ends with the guest's PRP seed (or
  Paillier's (p, q) under a 512-bit key, the arbiter with n alone), and
  the exchanged-key dicts have the JAX shape
  {uuid: (idx, secret, role, comm_idx)}.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pytest
import torch

from flashe_tpu.crypto import aes_host as jaes
from flashe_tpu.crypto import dh as jdh
from flashe_tpu.protocol.blocks import _keywrap as jkeywrap
from flashe_tpu_torch.crypto import aes_host as paes
from flashe_tpu_torch.crypto import dh as pdh
from flashe_tpu_torch.protocol.blocks import _keywrap as pkeywrap
from flashe_tpu_torch.protocol.blocks import flashe as fblocks
from flashe_tpu_torch.protocol.blocks import paillier as pblocks
from flashe_tpu_torch.runtime.simulate import run_roles

N_HOSTS = 3
Q = {"int_bits": 20, "batch": False, "element_bits": 16, "padding": True,
     "secure": True}


def test_dh_groups_and_exchange_match_jax():
    assert pdh._GROUPS == jdh._GROUPS
    rng = np.random.default_rng(5)
    for name in pdh._GROUPS:
        p, g = pdh.DiffieHellman.key_pair(name)
        assert (p, g) == jdh.DiffieHellman.key_pair(name)
        ra, rb = (int.from_bytes(rng.bytes(128), "big") % p for _ in "ab")
        ga = pdh.DiffieHellman.encrypt(g, ra, p)
        gb = pdh.DiffieHellman.encrypt(g, rb, p)
        assert ga == jdh.DiffieHellman.encrypt(g, ra, p)
        shared = pdh.DiffieHellman.decrypt(gb, ra, p)
        assert shared == pdh.DiffieHellman.decrypt(ga, rb, p)
        assert shared == jdh.DiffieHellman.decrypt(gb, ra, p)
    p, _ = pdh.DiffieHellman.key_pair()
    assert 0 <= pdh.DiffieHellman.generate_secret(p) < p


def _pair(secret):
    port, ref = paes.AESCipher(), jaes.AESCipher()
    port.generate_key(256, assigned_key=secret, mode="CTR")
    ref.generate_key(256, assigned_key=secret, mode="CTR")
    return port, ref


@pytest.mark.parametrize("secret_kind", ["int", "bytes", "long_int"])
def test_ctr_wrap_of_a_seed_matches_jax(secret_kind):
    rng = np.random.default_rng(len(secret_kind))
    secret = {"int": int.from_bytes(rng.bytes(20), "big"),
              "bytes": rng.bytes(32),
              "long_int": int.from_bytes(rng.bytes(128), "big")}[secret_kind]
    assert paes.derive_key_bytes(secret, 32) == jaes.derive_key_bytes(
        secret, 32)
    port, ref = _pair(secret)
    assert port.get_key() == ref.get_key()
    seed = rng.bytes(32)
    wrapped = port.encrypt(seed)
    assert wrapped == ref.encrypt(seed)
    assert port.decrypt(wrapped) == seed


def test_ctr_stream_runs_on_across_calls_and_partial_blocks():
    """An odd-length blob split over several calls encrypts as it would
    whole: the counter and the offset inside the current keystream block
    carry over, as the `cryptography` CTR context's do."""
    rng = np.random.default_rng(9)
    secret = int.from_bytes(rng.bytes(128), "big")
    blob = pickle.dumps((int.from_bytes(rng.bytes(128), "big"),
                         int.from_bytes(rng.bytes(128), "big")))
    assert len(blob) % 16
    cuts = [0, 1, 1, 7, 16, 17, 40, 41, len(blob) - 3, len(blob)]
    port, ref = _pair(secret)
    got = [port.encrypt(blob[a:b]) for a, b in zip(cuts, cuts[1:])]
    want = [ref.encrypt(blob[a:b]) for a, b in zip(cuts, cuts[1:])]
    assert got == want
    whole, _ = _pair(secret)
    assert b"".join(got) == whole.encrypt(blob)
    # decryption keeps its own stream
    assert port.decrypt(b"".join(got)) == blob


def test_ctr_counter_carries_as_a_128_bit_big_endian_integer():
    """Past 2^8 blocks the counter's low byte wraps into the next one."""
    port, ref = _pair(12345)
    data = os.urandom(16 * 300 + 5)
    assert port.encrypt(data) == ref.encrypt(data)


def test_keywrap_matches_jax():
    rng = np.random.default_rng(3)
    keys = {f"u{i}": (i, int.from_bytes(rng.bytes(128), "big"),
                      "guest" if i == 0 else "host", max(i - 1, 0))
            for i in range(4)}
    blob = rng.bytes(37)
    wrapped = pkeywrap.guest_wrap_for_hosts(keys, blob)
    assert wrapped == jkeywrap.guest_wrap_for_hosts(keys, blob)
    assert sorted(wrapped) == [0, 1, 2]
    for comm, w in wrapped.items():
        host_keys = {u: (t[0], keys[f"u{comm + 1}"][1]) + t[2:]
                     for u, t in keys.items()}
        assert pkeywrap.host_unwrap(host_keys, "u0", w) == blob


def _session(make_block):
    def guest(trv):
        return make_block("guest", trv)

    def host(trv, h):
        return make_block("host", trv)

    def arbiter(trv):
        return make_block("arbiter", trv)

    return run_roles(N_HOSTS, guest, host, arbiter, timeout=120)


def _check_exchanged_keys(dicts):
    """The JAX shape {uuid: (idx, secret, role, comm_idx)}, one entry a
    client, the same ordinals everywhere, one secret a pair."""
    uuids = set(dicts[0])
    assert len(uuids) == N_HOSTS + 1
    for d in dicts:
        assert set(d) == uuids
        for u, tup in d.items():
            assert len(tup) == 4
            idx, secret, role, comm = tup
            assert isinstance(idx, int) and isinstance(secret, int)
            assert (role, comm) == (("guest", 0) if idx == 0
                                    else ("host", idx - 1))
            assert (idx, role, comm) == (dicts[0][u][0], dicts[0][u][2],
                                         dicts[0][u][3])
    by_idx = {t[0]: u for u, t in dicts[0].items()}
    for i, di in enumerate(dicts):
        for j, dj in enumerate(dicts):
            assert di[by_idx[j]][1] == dj[by_idx[i]][1]


def test_flashe_session_over_run_roles():
    args = {"quantize": Q, "mask": "double"}

    def make(role, trv):
        cls = {"guest": fblocks.Guest, "host": fblocks.Host,
               "arbiter": fblocks.Arbiter}[role]
        return cls(args, device="cpu").register_flashe_cipher(
            trv).create_cipher()

    res = _session(make)
    clients = [res["guest"]] + [res[f"host{h}"] for h in range(N_HOSTS)]
    assert [c.cipher.idx for c in clients] == [0, 1, 2, 3]
    seed = clients[0].cipher.get_prp_seed()
    assert isinstance(seed, bytes) and len(seed) == 32
    for c in clients:
        assert c.cipher.get_prp_seed() == seed
        assert torch.equal(c.cipher._round_keys, clients[0].cipher._round_keys)
        assert c.cipher.num_clients == N_HOSTS + 1
        assert c.quantizer.num_clients == N_HOSTS + 1
        assert c.quantizer.generator.initial_seed() == c.cipher.idx
    for c in clients[1:]:
        assert c.cipher.get_guest_uuid() == clients[0].cipher.uuid
    _check_exchanged_keys([c.cipher.exchanged_keys for c in clients])
    assert res["arbiter"].quantizer.num_clients == N_HOSTS + 1


def test_paillier_session_over_run_roles():
    args = {"key_length": 512, "quantize": Q}

    def make(role, trv):
        cls = {"guest": pblocks.Guest, "host": pblocks.Host,
               "arbiter": pblocks.Arbiter}[role]
        return cls(args, device="cpu").register_paillier_cipher(
            trv).create_cipher()

    res = _session(make)
    clients = [res["guest"]] + [res[f"host{h}"] for h in range(N_HOSTS)]
    guest = clients[0].cipher
    assert guest.get_n().bit_length() == 512
    for c in clients:
        k = c.cipher.privacy_key
        assert (k.p, k.q) == (guest.privacy_key.p, guest.privacy_key.q)
        assert c.quantizer.num_clients == N_HOSTS + 1
    assert [c.quantizer.generator.initial_seed() for c in clients] == [
        0, 1, 1, 1]
    arb = res["arbiter"]
    assert arb.get_n() == guest.get_n()
    assert arb.cipher.privacy_key is None
    assert arb.quantizer.num_clients == N_HOSTS + 1
    # a ciphertext under the guest's key decrypts at every host
    ct = guest.public_key.encrypt_scalar(12345)
    for c in clients[1:]:
        assert c.cipher.privacy_key.decrypt_scalar(ct) == 12345
