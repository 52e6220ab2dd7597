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
    with pytest.raises(NotImplementedError, match="single"):
        FlasheCipher(20, mask="single", device="cpu")
    c = FlasheCipher(20, device="cpu")
    with pytest.raises(NotImplementedError, match="sparse"):
        c.set_masks([[0, 1]], 4)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        c.set_local_devices(2)
    # batch=True lane packing is ported (tests/test_torch_quant_codec.py)
    assert QuantizingClient(20, True, 16, True, True, device="cpu").batch


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
