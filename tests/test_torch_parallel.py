"""PyTorch port: multi-device aggregation and the parties' local devices
(flashe_tpu_torch/parallel/, the ciphers' set_local_devices) on the CPU,
held against flashe_tpu.parallel on the conftest's 8 virtual CPU devices.
The port's grids are the CPU repeated.

- padded_lane_count equals the JAX function's.
- encrypt_shard, decrypt_shard and decrypt_shard_runs equal the JAX XLA
  path bit for bit at 700 and 4,000 lanes over 2, 4 and 8 shards, and the
  shards joined equal FlasheCipher's single-device ciphertext.
- encrypted_aggregate on 4 clients x 2 shards, with and without
  survivors, equals the JAX program's worker run cell by cell and the
  plain sum mod 2^20; the guard num_clients << int_bits <= 2^32 raises as
  the JAX one does.
- FlasheCipher.set_local_devices (LocalLaneMesh): the dense double and
  single masks and the sparse decrypt (single and double mask) equal the
  unsharded port cipher bit for bit (which the other test files hold
  against the JAX cipher), a shard of a ciphertext the JAX party's worker,
  and every decrypt the plain sum; a one-device mesh turns the route off;
  more shards than devices raise.
- DeviceFanout.spans equals the JAX one; run keeps the row order.
- PaillierCipher.set_local_devices: a 256-bit key's fanned decrypt equals
  the unfanned one and python pow, its fanned encrypt decrypts exactly,
  and a batch under 2 x n_shards rows stays on one device.
- BFV and CKKS fanned: encrypt, sum of 10 and decrypt exact (BFV) or
  within 1e-7 of the float64 sum (CKKS).
The protocol round with two-shard parties is in tests/test_torch_protocol.py
(test_local_lane_shards_raise); processes in tests/test_torch_multihost.py.

The JAX package's shard_map programs (its encrypted_aggregate, its
LocalLaneMesh, its sparse fan-out) take 10-25 s each to compile on a
CPU, so the tests call the JAX functions those programs run on each shard
(encrypt_shard, decrypt_shard, decrypt_shard_runs), composed as the
programs compose them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.ops import aes as jaes
from flashe_tpu.parallel import fanout as jfanout
from flashe_tpu.parallel import sharded as jsharded
from flashe_tpu_torch.crypto.bfv import BFVCipher
from flashe_tpu_torch.crypto.ckks import CKKSCipher
from flashe_tpu_torch.crypto.flashe import FlasheCipher, merge_idx_runs
from flashe_tpu_torch.crypto.paillier import PaillierCipher, PaillierKeypair
from flashe_tpu_torch.ops import aes, lanes
from flashe_tpu_torch.parallel import sharded
from flashe_tpu_torch.parallel.fanout import DeviceFanout
from flashe_tpu_torch.parallel.party import LocalLaneMesh

SEED = bytes(range(32))
INT_BITS = 20


def _rk():
    return torch.from_numpy(aes.key_schedule(SEED).astype(np.int32))


def _jrk():
    return jnp.asarray(jaes.key_schedule(SEED).astype(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _q(rng, *shape):
    return rng.integers(0, 1 << 16, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n,bits,shards", [
    (1, 20, 1), (700, 20, 2), (4000, 20, 8), (1206590, 20, 2),
    (100, 32, 4), (100, 1, 3), (5000, 7, 5)])
def test_padded_lane_count_matches_jax(n, bits, shards):
    assert sharded.padded_lane_count(n, bits, shards) == \
        jsharded.padded_lane_count(n, bits, shards)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX XLA path on one vector of padded_lane_count(4000, 20, 8)
    lanes, whole (shard 0 of one): encrypt_shard, decrypt_shard and
    decrypt_shard_runs over two boundary sets.  A lane shard's result is a
    slice of these, since its counters start at its first block, and so
    is every shorter vector's (a prefix)."""
    n_pad = jsharded.padded_lane_count(4000, INT_BITS, 8)
    q = _q(np.random.default_rng(4000), n_pad)
    jq, jrk = jnp.asarray(q), _jrk()
    ref = {"q": q,
           "enc": np.asarray(jsharded.encrypt_shard(jrk, jq, IT, IDX, 0,
                                                    INT_BITS)),
           "dec": np.asarray(jsharded.decrypt_shard(jrk, jq, IT, N_CLIENTS,
                                                    0, INT_BITS))}
    for k, (a, b) in enumerate(RUNS):
        ref[f"runs{k}"] = np.asarray(jsharded.decrypt_shard_runs(
            jrk, jq, IT, tuple(a), tuple(b), 0, INT_BITS))
    return ref


IT, IDX, N_CLIENTS = 3, 2, 5
# one shard length that the JAX functions are also called at directly
# (4,000 lanes over 8 shards, and the grid round's 1,152 over 2): each new
# length costs the JAX package's eager ops a compile
SHARD = 576
# the pairs of merge_idx_runs, and boundaries left without a partner
RUNS = (merge_idx_runs([0, 1, 3]), ([4, 2], [0]))


@pytest.mark.parametrize("n", [700, 4000])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shards_match_jax_and_the_single_device_cipher(jax_ref, n, n_shards):
    n_pad = sharded.padded_lane_count(n, INT_BITS, n_shards)
    ns = n_pad // n_shards
    q, rk = jax_ref["q"][:n_pad], _rk()
    got = {"enc": [], "dec": [], "runs0": [], "runs1": []}
    for s in range(n_shards):
        qs = _i32(q[s * ns:(s + 1) * ns])
        got["enc"].append(sharded.encrypt_shard(rk, qs, IT, IDX, s,
                                                INT_BITS))
        got["dec"].append(sharded.decrypt_shard(rk, qs, IT, N_CLIENTS, s,
                                                INT_BITS))
        for k, (a, b) in enumerate(RUNS):
            got[f"runs{k}"].append(sharded.decrypt_shard_runs(
                rk, qs, IT, a, b, s, INT_BITS))
    for key, shards in got.items():
        np.testing.assert_array_equal(_u32(torch.cat(shards)),
                                      jax_ref[key][:n_pad], err_msg=key)
    if ns == SHARD:  # the JAX function itself at the last shard's offset
        s = n_shards - 1
        np.testing.assert_array_equal(_u32(got["enc"][s]), np.asarray(
            jsharded.encrypt_shard(_jrk(), jnp.asarray(q[s * ns:]), IT, IDX,
                                   s, INT_BITS)))
    c = FlasheCipher(INT_BITS, device="cpu")
    c.idx = IDX
    c.set_num_clients(N_CLIENTS)
    c.generate_prp_seed(assigned_seed=SEED)
    c.set_iter_index(IT)
    assert torch.equal(torch.cat(got["enc"]), c.encrypt(_i32(q)))


@pytest.fixture(scope="module")
def jax_mesh_round():
    """q of 4 clients and their ciphertexts from the JAX encrypt_shard on
    a 4 x 2 grid, as JAX's encrypted_aggregate computes them."""
    n_clients, n_shards = 4, 2
    n = SHARD * n_shards
    ns = n // n_shards
    q = _q(np.random.default_rng(7), n_clients, n)
    cts = [[np.asarray(jsharded.encrypt_shard(
        _jrk(), jnp.asarray(q[c, s * ns:(s + 1) * ns]), 5, c, s, INT_BITS))
        for s in range(n_shards)] for c in range(n_clients)]
    return q, cts


@pytest.mark.parametrize("survivors", [None, (0, 1, 2), (0, 2, 3)],
                         ids=["all", "last-dropped", "1-dropped"])
def test_encrypted_aggregate_matches_jax_and_the_plain_sum(jax_mesh_round,
                                                           survivors):
    """The port's grid round against JAX's shard_map worker, run cell by
    cell: its encrypt_shard, the zeroed non-survivors, the mod-2^20 sum
    over the clients and decrypt_shard / decrypt_shard_runs."""
    q, jcts = jax_mesh_round
    n_clients, n_shards = len(jcts), len(jcts[0])
    mesh = sharded.make_mesh(n_clients, n_shards, ["cpu"] * 8)
    assert mesh.shape == {"clients": 4, "lanes": 2}
    got = sharded.encrypted_aggregate(mesh, _rk(), _i32(q), 5, INT_BITS,
                                      n_clients, survivors=survivors)
    alive = list(range(n_clients)) if survivors is None else list(survivors)
    want = []
    for s in range(n_shards):
        agg = jnp.asarray(sum(jcts[c][s].astype(np.int64) for c in alive)
                          % (1 << INT_BITS), jnp.uint32)
        if survivors is None:
            out = jsharded.decrypt_shard(_jrk(), agg, 5, n_clients, s,
                                         INT_BITS)
        else:
            adds, minuses = merge_idx_runs(alive)
            out = jsharded.decrypt_shard_runs(_jrk(), agg, 5, tuple(adds),
                                              tuple(minuses), s, INT_BITS)
        want.append(np.asarray(out))
    np.testing.assert_array_equal(_u32(got), np.concatenate(want))
    np.testing.assert_array_equal(
        got.numpy(), q[alive].astype(np.int64).sum(0) % (1 << INT_BITS))


def test_encrypted_aggregate_guard_raises_as_jax():
    q = np.zeros((2, 256), np.uint32)
    with pytest.raises(ValueError, match="must fit in uint32 psum"):
        jsharded.encrypted_aggregate(jsharded.make_mesh(2, 1), _jrk(),
                                     jnp.asarray(q), jnp.int32(0), 32, 2)
    with pytest.raises(ValueError, match="must fit in uint32 psum"):
        sharded.encrypted_aggregate(sharded.make_mesh(2, 1, ["cpu"] * 2),
                                    _rk(), _i32(q), 0, 32, 2)
    # at the bound it runs: 16 clients x 2^28
    mesh = sharded.make_mesh(16, 1, ["cpu"] * 16)
    q = _q(np.random.default_rng(1), 16, 256)
    got = sharded.encrypted_aggregate(mesh, _rk(), _i32(q), 0, 28, 16)
    np.testing.assert_array_equal(got.numpy(),
                                  q.astype(np.int64).sum(0) % (1 << 28))


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="need 6 devices, have 4"):
        sharded.make_mesh(3, 2, ["cpu"] * 4)
    with pytest.raises(ValueError, match="whole AES blocks"):
        sharded.encrypted_aggregate(sharded.make_mesh(1, 2, ["cpu"] * 2),
                                    _rk(), torch.zeros(1, 100,
                                                       dtype=torch.int32),
                                    0, 20, 1)


def _ciphers(mask, idx, n_clients, it, n_shards):
    """(port cipher sharded over the CPU n_shards times, the same
    unsharded)."""
    out = []
    for _ in range(2):
        c = FlasheCipher(INT_BITS, mask=mask, device="cpu")
        c.idx = idx
        c.set_num_clients(n_clients)
        c.generate_prp_seed(assigned_seed=SEED)
        c.set_iter_index(it)
        out.append(c)
    out[0].set_local_devices(n_shards)
    assert out[0]._party_mesh.n_shards == n_shards
    return out


@pytest.mark.parametrize("mask", ["double", "single"])
def test_local_lane_mesh_dense_matches_unsharded_and_jax(mask):
    """Each client's sharded ciphertext is its unsharded one and, shard by
    shard, the JAX party's worker (encrypt_shard for the double mask);
    the sharded decrypt equals the unsharded one and the plain sum."""
    n, n_clients, it, n_shards = 2300, 3, 2, 4  # 576-lane shards
    rng = np.random.default_rng(3)
    qs = [_q(rng, n) for _ in range(n_clients)]
    cts = []
    for i in range(n_clients):
        sh, one = _ciphers(mask, i, n_clients, it, n_shards)
        ct = sh.encrypt(_i32(qs[i]))
        assert torch.equal(ct, one.encrypt(_i32(qs[i])))
        cts.append(ct)
    if mask == "double":  # the last shard through the JAX worker
        n_pad = sharded.padded_lane_count(n, INT_BITS, n_shards)
        ns = n_pad // n_shards
        s = n_shards - 1
        qp = np.concatenate([qs[1], np.zeros(n_pad - n, np.uint32)])
        want = np.asarray(jsharded.encrypt_shard(
            _jrk(), jnp.asarray(qp[s * ns:]), it, 1, s, INT_BITS))
        np.testing.assert_array_equal(_u32(cts[1])[s * ns:], want[:n - s * ns])
    for survivors in ([0, 1, 2], [0, 2]):
        agg = cts[survivors[0]]
        for i in survivors[1:]:
            agg = lanes.lane_add(agg, cts[i], INT_BITS)
        sh, one = _ciphers(mask, 0, n_clients, it, n_shards)
        got = sh.decrypt(agg, survivors)
        assert torch.equal(got, one.decrypt(agg, survivors))
        np.testing.assert_array_equal(
            got.numpy(), sum(qs[i].astype(np.int64) for i in survivors)
            % (1 << INT_BITS))


@pytest.mark.parametrize("mask", ["double", "single"])
def test_sparse_decrypt_fanout_matches_unsharded_and_jax(mask):
    """The sparse decrypt fanned out by client over 2 devices equals the
    unsharded one (tests/test_torch_sparse.py holds that against the JAX
    cipher) and undoes the clients' compact encrypts exactly."""
    total, n_clients, it = 900, 3, 1
    rng = np.random.default_rng(5)
    locs = [np.sort(rng.choice(total, 120, replace=False)) for _ in
            range(n_clients)]
    qs = [_q(rng, 120) for _ in range(n_clients)]
    for survivors in ([0, 1, 2], [1, 2]):
        agg = np.zeros(total, np.int64)
        for i in survivors:
            enc = _ciphers(mask, i, n_clients, it, 2)[1]
            agg[locs[i]] += enc.encrypt(_i32(qs[i])).numpy().view(np.uint32)
        value = _i32(agg % (1 << INT_BITS))
        sh, one = _ciphers(mask, 0, n_clients, it, 2)
        for c in (sh, one):
            c.set_masks(locs, total)
        got = sh.decrypt(value, survivors)
        assert torch.equal(got, one.decrypt(value, survivors))
        want = np.zeros(total, np.int64)
        for i in survivors:
            want[locs[i]] += qs[i]
        np.testing.assert_array_equal(got.numpy(), want % (1 << INT_BITS))


def test_one_device_mesh_is_off_and_too_many_shards_raise():
    c = FlasheCipher(INT_BITS, device="cpu")
    c.set_local_devices(1)
    assert c._party_mesh is None
    c.set_local_devices("all", ["cpu"] * 3)
    assert c._party_mesh.n_shards == 3
    with pytest.raises(ValueError, match="local_lane_shards=5 > 4 local"):
        LocalLaneMesh(5, ["cpu"] * 4)
    with pytest.raises(ValueError, match="n_shards=3 > 2 local devices"):
        DeviceFanout(3, ["cpu"] * 2)
    # wide lanes keep the single-device path
    wide = FlasheCipher(40, device="cpu")
    wide.set_local_devices(2)
    assert not wide._party_ok(torch.zeros(8, 2, dtype=torch.int32))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_fanout_spans_match_jax(n_shards):
    port = DeviceFanout(n_shards, ["cpu"] * n_shards)
    ref = jfanout.DeviceFanout(n_shards, jax.devices()[:n_shards])
    for B in (0, 1, 2, 7, 8, 24, 101):
        assert port.spans(B) == ref.spans(B)
    a = torch.arange(30).reshape(10, 3)
    got = port.run(lambda i, x, y: (x * 2, y + i * 0), a, a[:, 0])
    np.testing.assert_array_equal(got[0], (a * 2).numpy())
    np.testing.assert_array_equal(got[1], a[:, 0].numpy())


@pytest.fixture(scope="module")
def paillier():
    pub, priv = PaillierKeypair.generate_keypair(256)
    one, fan = (PaillierCipher(device="cpu") for _ in range(2))
    for c in (one, fan):
        c.set_public_key(pub)
        c.set_privacy_key(priv)
    fan.set_local_devices(2, ["cpu"] * 2)
    return one, fan, priv


def test_paillier_fanout_exact(paillier, monkeypatch):
    one, fan, priv = paillier
    rng = np.random.default_rng(9)
    vals = [int(v) for v in rng.integers(0, 1 << 62, 17)]
    cts = np.array([priv.public_key.encrypt_scalar(v) for v in vals],
                   dtype=object)
    got = fan.decrypt(cts)
    assert list(got) == list(one.decrypt(cts)) == vals
    assert [priv.decrypt_scalar(int(c)) for c in cts] == vals
    assert list(fan.decrypt(fan.encrypt(vals))) == vals
    # a batch under 2 x n_shards rows stays on one device
    calls = []
    monkeypatch.setattr(fan._fanout, "run",
                        lambda *a: calls.append(a) or pytest.fail("fanned"))
    assert list(fan.decrypt(cts[:3])) == vals[:3]
    assert calls == []


def test_bfv_fanned_round_is_exact():
    t, m, n_clients = 1032193, 64, 10
    guest = BFVCipher(t, m, flagBatching=True, seed=11,
                      device="cpu").generate_keys()
    guest.set_local_devices(2, ["cpu"] * 2)
    rng = np.random.default_rng(2)
    vals = [rng.integers(0, 1 << 16, 300) for _ in range(n_clients)]
    cts = [guest.encrypt(v) for v in vals]
    assert isinstance(cts[0], np.ndarray)
    assert cts[0].shape == (5, 2, guest.k, m)
    agg = guest.add_ciphertexts(cts)
    got = guest.decrypt(agg, 300)
    np.testing.assert_array_equal(got.numpy(), np.sum(vals, 0) % t)
    # without batching too (one value a ciphertext, coefficient 0)
    plain = BFVCipher(t, m, seed=11, device="cpu").generate_keys()
    plain.set_local_devices(2, ["cpu"] * 2)
    ct = plain.encrypt(vals[0][:6])
    np.testing.assert_array_equal(plain.decrypt(ct, 6).numpy(), vals[0][:6])


def test_ckks_fanned_round_within_1e7():
    n_clients = 10
    guest = CKKSCipher(64, seed=13, device="cpu").generate_keys()
    guest.set_local_devices(2, ["cpu"] * 2)
    rng = np.random.default_rng(4)
    vals = [rng.normal(size=200) for _ in range(n_clients)]
    cts = [guest.encrypt(v) for v in vals]
    assert isinstance(cts[0], np.ndarray) and cts[0].shape[0] == 7
    got = guest.decrypt(guest.add_ciphertexts(cts), 200)
    assert float(np.max(np.abs(got.numpy() - np.sum(vals, 0)))) < 1e-7
