"""PyTorch port: the fused mask apply and FlasheCipher against the JAX
package on the CPU (its XLA path; the Pallas kernel runs on a TPU only).
On the CPU the port's mask_apply runs its plain version; the CUDA kernel is
checked against that same plain version by chip_smoke.py on the card.
Tolerance: bit-exact throughout."""

import numpy as np
import pytest
import torch

from flashe_tpu.crypto import flashe as jflashe
from flashe_tpu.ops import aes as jaes
from flashe_tpu.ops import masks as jmasks
from flashe_tpu.ops.lanes import lane_add as jlane_add
from flashe_tpu.ops.lanes import lane_sub as jlane_sub
from flashe_tpu_torch.crypto.flashe import FlasheCipher, merge_idx_runs
from flashe_tpu_torch.ops import aes, flashe_mask
from flashe_tpu_torch.ops.lanes import lane_add, lanes_to_ints, nlimbs_for
from flashe_tpu_torch.quant.quantizer import QuantizingClient

SEED = bytes(range(32))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _q(rng, shape, int_bits):
    return rng.integers(0, 1 << min(int_bits, 32), shape,
                        dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("int_bits", [16, 20, 32])
@pytest.mark.parametrize("count", [1, 5, 7, 3000])
def test_mask_apply_matches_jax_xla(int_bits, count):
    rng = np.random.default_rng(count)
    q = _q(rng, count, int_bits)
    rk = aes.key_schedule(SEED)
    got = flashe_mask.mask_apply(_i32(q), torch.from_numpy(rk.astype(np.int32)),
                                 4, 2, 7, int_bits)
    jrk = jaes.key_schedule(SEED)
    add = jmasks.prp_lane_stream(jrk, 4, 2, count, int_bits)
    minus = jmasks.prp_lane_stream(jrk, 4, 7, count, int_bits)
    want = np.asarray(jflashe._mask_apply(q, add, minus, int_bits))
    np.testing.assert_array_equal(_u32(got), want)


def test_mask_apply_base_block_matches_host_oracle():
    int_bits, base, count = 20, 3, 40
    merge = 128 // int_bits
    rng = np.random.default_rng(1)
    q = _q(rng, count, int_bits)
    rk = torch.from_numpy(aes.key_schedule(SEED).astype(np.int32))
    got = flashe_mask.mask_apply(_i32(q), rk, 4, 2, 3, int_bits, base_block=base)
    n = base * merge + count
    add = jmasks.reference_mask_stream_host(SEED, 4, 2, n, int_bits)[-count:]
    minus = jmasks.reference_mask_stream_host(SEED, 4, 3, n, int_bits)[-count:]
    want = (q.astype(object) + add - minus) % (1 << int_bits)
    np.testing.assert_array_equal(_u32(got).astype(object), want)


def _ciphers(int_bits, n_clients, it):
    port, ref = [], []
    for i in range(n_clients):
        for c, out in ((FlasheCipher(int_bits, device="cpu"), port),
                       (jflashe.FlasheCipher(int_bits), ref)):
            c.idx = i
            c.set_num_clients(n_clients)
            c.generate_prp_seed(assigned_seed=SEED)
            c.set_iter_index(it)
            out.append(c)
    return port, ref


@pytest.mark.parametrize("int_bits", [20, 32, 40])
def test_cipher_encrypt_matches_jax(int_bits):
    count, nl = 301, nlimbs_for(int_bits)
    rng = np.random.default_rng(int_bits)
    q = _q(rng, (count, nl) if nl > 1 else count, 32)
    if nl > 1:
        q[:, -1] &= (1 << (int_bits - 32)) - 1
    (p,), (r,) = _ciphers(int_bits, 1, 5)
    np.testing.assert_array_equal(_u32(p.encrypt(_i32(q))),
                                  np.asarray(r.encrypt(q)))


@pytest.mark.parametrize("survivors", [[0, 1, 2, 3, 4], [0, 1, 3]])
def test_round_trip_and_dropout_decrypt_match_jax(survivors):
    int_bits, count, it = 20, 257, 2
    rng = np.random.default_rng(len(survivors))
    qs = [_q(rng, count, 16) for _ in range(5)]
    port, ref = _ciphers(int_bits, 5, it)
    agg = jagg = None
    for i in survivors:
        c = port[i].encrypt(_i32(qs[i]))
        jc = ref[i].encrypt(qs[i])
        np.testing.assert_array_equal(_u32(c), np.asarray(jc))
        agg = c if agg is None else lane_add(agg, c, int_bits)
        jagg = jc if jagg is None else jlane_add(jagg, jc, int_bits)
    dec = port[0].decrypt(agg, survivors)
    np.testing.assert_array_equal(_u32(dec),
                                  np.asarray(ref[0].decrypt(jagg, survivors)))
    want = sum(qs[i].astype(np.int64) for i in survivors) % (1 << int_bits)
    np.testing.assert_array_equal(lanes_to_ints(dec, int_bits).astype(np.int64),
                                  want)


def test_merge_idx_runs_matches_jax():
    for idx_list in ([0, 1, 3], [0, 1, 2, 3, 4], [2], [4, 0, 2, 3]):
        assert merge_idx_runs(idx_list) == jflashe.merge_idx_runs(idx_list)


def test_decrypt_launches_one_mask_pass_per_boundary_pair(monkeypatch):
    calls = []
    real = flashe_mask.mask_apply

    def spy(q, rk, it, a, b, m, base_block=0):
        calls.append((a, b))
        return real(q, rk, it, a, b, m, base_block)

    import flashe_tpu_torch.crypto.flashe as pflashe
    monkeypatch.setattr(pflashe, "mask_apply", spy)
    c = _ciphers(20, 5, 0)[0][0]
    c.decrypt(torch.zeros(4, dtype=torch.int32), [0, 1, 3])
    assert calls == [(2, 0), (4, 3)]


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlasheCipher(20, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuantizingClient(20, False, 16, True, True, device="cuda")


def test_mask_apply_refuses_other_devices():
    q = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flashe_mask.mask_apply(q, torch.zeros(15, 16, dtype=torch.int32),
                               0, 1, 2, 20)


def test_unported_paths_raise():
    """Only the sparse decrypt above 32 bits raises, and local sharding
    onto more shards than devices (set_local_devices is ported: a CPU
    cipher shards over the CPU repeated; tests/test_torch_parallel.py)."""
    # the single mask, the location lists and wide lanes are ported
    assert FlasheCipher(20, mask="single", device="cpu").masking_scheme == \
        "single"
    c = FlasheCipher(20, device="cpu")
    c.set_masks([[0, 1]], 4)
    assert c.masks[0].tolist() == [0, 1]
    assert FlasheCipher(120, device="cpu").int_bits == 120
    with pytest.raises(ValueError, match="3 > 2 local devices"):
        c.set_local_devices(3, devices=["cpu"] * 2)
    c.set_local_devices(2)
    assert c._party_mesh.n_shards == 2
    c.set_local_devices(1)  # one device: the route is off
    assert c._party_mesh is None
    wide = FlasheCipher(40, device="cpu")
    wide.generate_prp_seed(assigned_seed=SEED)
    wide.set_masks([[0]], 2)
    with pytest.raises(NotImplementedError, match="int_bits <= 32"):
        wide.decrypt(torch.zeros(2, 2, dtype=torch.int32), [0])
    # batch=True lane packing is ported (tests/test_torch_quant_codec.py)
    assert QuantizingClient(20, True, 16, True, True, device="cpu").batch


def test_mask_apply_refuses_calls_without_a_stream():
    q = torch.zeros(4, dtype=torch.int32)
    rk = torch.zeros(15, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="add stream, the minus"):
        flashe_mask.mask_apply(q, rk, 0, None, None, 20)
    with pytest.raises(ValueError, match="subtracts a client's stream"):
        flashe_mask.mask_scatter(q, torch.zeros(1, dtype=torch.int64), rk, 0,
                                 1, None, 20)
    with pytest.raises(ValueError, match="subtracts a client's stream"):
        flashe_mask.mask_scatter(torch.zeros(4, 2, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int64), rk, 0,
                                 None, 1, 40)


def _jax_stream(idx, count, int_bits, it=4):
    return jmasks.prp_lane_stream(jaes.key_schedule(SEED), it, idx, count,
                                  int_bits)


@pytest.mark.parametrize("streams", ["add", "minus"])
def test_one_stream_matches_jax_xla(streams):
    int_bits, count = 20, 301
    q = _q(np.random.default_rng(2), count, 16)
    rk = torch.from_numpy(aes.key_schedule(SEED).astype(np.int32))
    add, minus = (2, None) if streams == "add" else (None, 7)
    got = flashe_mask.mask_apply(_i32(q), rk, 4, add, minus, int_bits)
    if streams == "add":
        want = jflashe._mask_apply_single(q, _jax_stream(2, count, int_bits),
                                          int_bits)
    else:
        want = jlane_sub(q, _jax_stream(7, count, int_bits), int_bits)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def _limb_q(rng, count, int_bits):
    nl = nlimbs_for(int_bits)
    q = _q(rng, (count, nl), 32)
    if int_bits % 32:
        q[:, -1] &= (1 << (int_bits % 32)) - 1
    return q


@pytest.mark.parametrize("int_bits", [33, 64, 120, 128])
def test_limbs_match_jax_xla_and_host_oracle(int_bits):
    """Multi-limb lanes with both streams, the add stream alone and the
    minus stream alone: against the JAX package's XLA streams and lane
    algebra, and against python ints from the `cryptography` AES."""
    count, mod = 7, 1 << int_bits
    q = _limb_q(np.random.default_rng(int_bits), count, int_bits)
    rk = torch.from_numpy(aes.key_schedule(SEED).astype(np.int32))
    jadd, jminus = (_jax_stream(i, count, int_bits) for i in (2, 3))
    host = [jmasks.reference_mask_stream_host(SEED, 4, i, count, int_bits)
            for i in (2, 3)]
    qi = lanes_to_ints(q, int_bits)
    for add, minus in ((2, 3), (2, None), (None, 3)):
        got = flashe_mask.mask_apply(_i32(q), rk, 4, add, minus, int_bits)
        assert got.shape == (count, nlimbs_for(int_bits))
        want, ints = q, qi.copy()
        if add is not None:
            want = jlane_add(want, jadd, int_bits)
            ints = (ints + host[0]) % mod
        if minus is not None:
            want = jlane_sub(want, jminus, int_bits)
            ints = (ints - host[1]) % mod
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
        assert list(lanes_to_ints(got, int_bits)) == list(ints)


def test_limbs_base_block_matches_host_oracle():
    int_bits, base, count = 40, 5, 8  # 3 lanes a block
    q = _limb_q(np.random.default_rng(3), count, int_bits)
    rk = torch.from_numpy(aes.key_schedule(SEED).astype(np.int32))
    got = flashe_mask.mask_apply(_i32(q), rk, 4, 2, 3, int_bits,
                                 base_block=base)
    n = base * 3 + count
    add = jmasks.reference_mask_stream_host(SEED, 4, 2, n, int_bits)[-count:]
    minus = jmasks.reference_mask_stream_host(SEED, 4, 3, n, int_bits)[-count:]
    want = (lanes_to_ints(q, int_bits) + add - minus) % (1 << int_bits)
    assert list(lanes_to_ints(got, int_bits)) == list(want)


@pytest.mark.parametrize("kind", ["empty", "one", "dense", "random"])
def test_scatter_matches_jax_sparse_accumulate(kind):
    """out[loc[k]] -= a[k] (+= b[k] with the add stream) in place, against
    the JAX cipher's _scatter_accumulate of the same compact streams."""
    int_bits, n = 20, 301
    rng = np.random.default_rng(len(kind))
    loc = {"empty": np.zeros(0, np.int64), "one": np.array([150]),
           "dense": np.arange(n),
           "random": np.sort(rng.choice(n, 30, replace=False))}[kind]
    agg = _q(rng, n, int_bits)
    rk = torch.from_numpy(aes.key_schedule(SEED).astype(np.int32))
    for add in (None, 8):
        out = _i32(agg.copy())
        got = flashe_mask.mask_scatter(out, torch.from_numpy(loc), rk, 4, add,
                                       7, int_bits)
        assert got is out
        want = agg
        if len(loc):
            zero = np.zeros(n, np.uint32)
            acc = jflashe._scatter_accumulate(
                zero, _jax_stream(7, len(loc), int_bits), loc, int_bits)
            want = jlane_sub(want, acc, int_bits)
            if add is not None:
                acc = jflashe._scatter_accumulate(
                    zero, _jax_stream(8, len(loc), int_bits), loc, int_bits)
                want = jlane_add(want, acc, int_bits)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
        if kind == "dense":  # every position: the dense apply
            np.testing.assert_array_equal(
                _u32(got), _u32(flashe_mask.mask_apply(_i32(agg), rk, 4, add,
                                                       7, int_bits)))


def test_prepared_encrypt_equals_unprepared():
    """The JAX cipher precomputes the next round's streams off its fused
    kernel's path; the port's prepare is a no-op.  Both encrypt alike."""
    int_bits, count, it = 40, 301, 3  # the JAX streams of the encrypt test
    q = _limb_q(np.random.default_rng(6), count, int_bits)
    (p,), (r,) = _ciphers(int_bits, 1, it - 1)
    for c in (p, r):
        c.set_num_params(count)
        c.prepare_encrypt()
        c.set_iter_index(it)
    assert ("enc", it) in r._prepared and p.prepare_encrypt() is None
    np.testing.assert_array_equal(_u32(p.encrypt(_i32(q))),
                                  np.asarray(r.encrypt(q)))
    assert ("enc", it) not in r._prepared
    (fresh,) = _ciphers(int_bits, 1, it)[1]
    np.testing.assert_array_equal(_u32(p.encrypt(_i32(q))),
                                  np.asarray(fresh.encrypt(q)))


@pytest.mark.slow
def test_mask_apply_matches_pallas_interpret():
    from flashe_tpu.ops import pallas_flashe as pf

    int_bits, count = 20, 3000
    rng = np.random.default_rng(0)
    q = _q(rng, count, 16)
    rk = aes.key_schedule(SEED).astype(np.int32)
    got = flashe_mask.mask_apply(_i32(q), torch.from_numpy(rk), 4, 2, 3,
                                 int_bits)
    want = np.asarray(pf.pallas_encrypt(q, rk, 4, 2, int_bits, interpret=True))
    np.testing.assert_array_equal(_u32(got), want)


def test_encrypt_decrypt_helpers_telescope():
    int_bits, count = 16, 333
    rng = np.random.default_rng(4)
    rk = torch.from_numpy(aes.key_schedule(SEED).astype(np.int32))
    qs = [_q(rng, count, 12) for _ in range(3)]
    agg = None
    for i, q in enumerate(qs):
        c = flashe_mask.encrypt(_i32(q), rk, 9, i, int_bits, base_block=5)
        agg = c if agg is None else lane_add(agg, c, int_bits)
    dec = flashe_mask.decrypt(agg, rk, 9, 3, int_bits, base_block=5)
    want = sum(q.astype(np.int64) for q in qs) % (1 << int_bits)
    np.testing.assert_array_equal(_u32(dec).astype(np.int64), want)
