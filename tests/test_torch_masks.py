"""PyTorch port: lane algebra, AES-256 and the mask stream against the JAX
package and the `cryptography` oracle.  Tolerance: bit-exact throughout."""

import numpy as np
import pytest
import torch

from flashe_tpu.ops import aes as jaes
from flashe_tpu.ops import lanes as jlanes
from flashe_tpu.ops import masks as jmasks
from flashe_tpu_torch.ops import aes, lanes, masks

SEED = bytes(range(11, 43))


def _i32(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy lanes -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _random_lanes(rng, n, int_bits):
    nl = lanes.nlimbs_for(int_bits)
    x = rng.integers(0, 1 << 32, (n, nl), dtype=np.uint64).astype(np.uint32)
    x &= np.asarray(jlanes.lane_mask(int_bits))
    edges = [0, (1 << int_bits) - 1]
    if int_bits == 32:
        edges += [(1 << 31) - 1, 1 << 31]
    x = np.concatenate([x, np.asarray(jlanes.ints_to_lanes(
        np.array(edges, dtype=object), int_bits)).reshape(-1, nl)])
    return x[:, 0] if nl == 1 else x


@pytest.mark.parametrize("int_bits", [16, 20, 32, 40, 120])
def test_lane_add_sub_match_jax(int_bits):
    rng = np.random.default_rng(int_bits)
    a = _random_lanes(rng, 64, int_bits)
    b = _random_lanes(rng, 64, int_bits)[::-1].copy()  # edges meet edges
    for port_op, jax_op in ((lanes.lane_add, jlanes.lane_add),
                            (lanes.lane_sub, jlanes.lane_sub)):
        got = port_op(_i32(a), _i32(b), int_bits)
        want = np.asarray(jax_op(a, b, int_bits))
        np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("int_bits", [20, 32, 40, 120])
def test_ints_lanes_roundtrip(int_bits):
    vals = np.array([0, 1, (1 << int_bits) - 1, (1 << int_bits) // 3],
                    dtype=object)
    t = lanes.ints_to_lanes(vals, int_bits)
    np.testing.assert_array_equal(_u32(t), jlanes.ints_to_lanes(vals, int_bits))
    np.testing.assert_array_equal(lanes.lanes_to_ints(t, int_bits), vals)


def test_key_schedule_and_sbox_match_jax():
    np.testing.assert_array_equal(aes.SBOX, jaes.SBOX)
    np.testing.assert_array_equal(aes.key_schedule(SEED),
                                  jaes.key_schedule(SEED))


def test_aes_fips197_vector():
    # FIPS-197 appendix C.3 (AES-256)
    key = bytes(range(32))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = aes.aes_encrypt_blocks(torch.tensor([list(pt)]),
                                aes.key_schedule(key))
    assert bytes(ct[0].tolist()).hex() == "8ea2b7ca516745bfeafc49904b496089"


def test_aes_matches_cryptography():
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    rng = np.random.default_rng(7)
    pts = rng.integers(0, 256, (33, 16), dtype=np.uint8)
    got = aes.aes_encrypt_blocks(torch.from_numpy(pts.astype(np.int64)),
                                 aes.key_schedule(SEED))
    enc = Cipher(algorithms.AES(SEED), modes.ECB()).encryptor()
    want = np.frombuffer(enc.update(pts.tobytes()), np.uint8).reshape(33, 16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("int_bits", [16, 20, 32, 40, 120, 128])
def test_lane_stream_matches_host_oracle_and_jax(int_bits):
    rk = aes.key_schedule(SEED)
    count = 53 if int_bits <= 32 else 7
    got = masks.prp_lane_stream(rk, 3, 2, count, int_bits)
    want = masks.reference_mask_stream_host(SEED, 3, 2, count, int_bits)
    np.testing.assert_array_equal(lanes.lanes_to_ints(got, int_bits), want)
    np.testing.assert_array_equal(
        want, jmasks.reference_mask_stream_host(SEED, 3, 2, count, int_bits))
    jax_got = np.asarray(jmasks.prp_lane_stream(
        jaes.key_schedule(SEED), 3, 2, count, int_bits))
    np.testing.assert_array_equal(_u32(got), jax_got)


@pytest.mark.parametrize("int_bits", [20, 40])
@pytest.mark.parametrize("begin_block", [3, 64])
def test_begin_block_slices_full_stream(int_bits, begin_block):
    # a stream starting at block b reproduces that slice of the full stream,
    # aligned to the JAX package's 32-block groups or not
    merge = masks.merge_size(int_bits)
    rk = aes.key_schedule(SEED)
    full = masks.prp_lane_stream(rk, 0, 1, (begin_block + 5) * merge, int_bits)
    part = masks.prp_lane_stream(rk, 0, 1, 5 * merge - 1, int_bits,
                                 begin_block=begin_block)
    torch.testing.assert_close(part, full[begin_block * merge:][:5 * merge - 1],
                               rtol=0, atol=0)
    jax_part = np.asarray(jmasks.prp_lane_stream(
        jaes.key_schedule(SEED), 0, 1, 5 * merge - 1, int_bits,
        begin_block=begin_block))
    np.testing.assert_array_equal(_u32(part), jax_part)


def test_index_blocks_carry_64bit_counters():
    # counters past 2^32 fill the high counter bytes, big-endian
    blocks = masks.index_blocks(0x01020304, 0x0A0B0C0D, (1 << 40) + 255, 2)
    assert blocks[0].tolist() == [1, 2, 3, 4, 10, 11, 12, 13,
                                  0, 0, 1, 0, 0, 0, 0, 255]
    assert blocks[1].tolist()[8:] == [0, 0, 1, 0, 0, 0, 1, 0]


# ---------------------------------------------------------------------------
# the T-table AES on column words that the CUDA mask kernel runs
# ---------------------------------------------------------------------------

def _xtime(s):
    return ((s << 1) ^ (0x1B if s & 0x80 else 0)) & 0xFF


def _cols(blocks: np.ndarray) -> torch.Tensor:
    """(N, 16) bytes -> (N, 4) big-endian column words."""
    return torch.from_numpy(np.ascontiguousarray(blocks, np.uint8).view(
        ">u4").astype(np.int64))


def _bytes(cols: torch.Tensor) -> np.ndarray:
    return cols.numpy().astype(">u4").view(np.uint8).reshape(-1, 16)


def test_te0_words_are_2s_s_s_3s():
    te0 = aes.te0_words()
    assert te0.dtype == np.uint32 and te0.shape == (256,)
    for x in range(256):
        sx = int(aes.SBOX[x])
        want = bytes([_xtime(sx), sx, sx, _xtime(sx) ^ sx])
        assert int(te0[x]).to_bytes(4, "big") == want


def test_ttable_aes_fips197_vector():
    # FIPS-197 appendix C.3 (AES-256)
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)[None]
    ct = aes.aes_encrypt_blocks_ttable(_cols(pt),
                                       aes.key_schedule(bytes(range(32))))
    assert _bytes(ct).tobytes().hex() == "8ea2b7ca516745bfeafc49904b496089"


@pytest.mark.parametrize("seed", [7, 8])
def test_ttable_aes_matches_plain_aes_and_jax(seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    pts = rng.integers(0, 256, (65, 16), dtype=np.uint8)
    pts[0], pts[1] = 0, 255
    rk = aes.key_schedule(key)
    got = _bytes(aes.aes_encrypt_blocks_ttable(_cols(pts), rk))
    want = aes.aes_encrypt_blocks(torch.from_numpy(pts.astype(np.int64)), rk)
    np.testing.assert_array_equal(got, want.numpy())
    jwant = jaes.aes_encrypt_blocks(pts.astype(np.int32),
                                    jaes.key_schedule(key))
    np.testing.assert_array_equal(got, np.asarray(jwant))


def test_ttable_aes_takes_int32_round_keys_and_leading_dims():
    # the kernel's wrapper holds the round keys as int32; words may come as
    # int32 bit patterns too
    rk = aes.key_schedule(SEED)
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 256, (2, 3, 16), dtype=np.uint8)
    cols = torch.from_numpy(pts.view(">u4").astype(np.uint32).view(np.int32))
    got = aes.aes_encrypt_blocks_ttable(
        cols, torch.from_numpy(rk.astype(np.int32)))
    want = aes.aes_encrypt_blocks(torch.from_numpy(pts.astype(np.int64)), rk)
    assert got.shape == (2, 3, 4)
    np.testing.assert_array_equal(_bytes(got.reshape(-1, 4)),
                                  want.reshape(-1, 16).numpy())


@pytest.mark.parametrize("begin_block", [0, 2**32 - 2, -3])
@pytest.mark.parametrize("int_bits", [1, 8, 16, 20, 25, 31, 32])
def test_lanes_from_ttable_words_match_lane_stream(int_bits, begin_block):
    # the kernel's path end to end in plain torch: counter blocks as column
    # words (iter, idx, ctr >> 32, ctr), the T-table AES, lanes cut from the
    # words; the low counter word wraps inside the run at 2**32 - 2
    rk = aes.key_schedule(SEED)
    merge = masks.merge_size(int_bits)
    nb = 5
    count = nb * merge - 1
    ctr = (begin_block + np.arange(nb, dtype=object)) % (1 << 64)
    cols = torch.tensor([[3, 2, int(c) >> 32, int(c) & 0xFFFFFFFF]
                         for c in ctr], dtype=torch.int64)
    got = masks.lanes_from_words(aes.aes_encrypt_blocks_ttable(cols, rk),
                                 int_bits)[:count]
    want = masks.prp_lane_stream(rk, 3, 2, count, int_bits,
                                 begin_block=begin_block)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if begin_block >= 0 and int_bits in (20, 32):
        blocks = [(3).to_bytes(4, "big") + (2).to_bytes(4, "big")
                  + int(c).to_bytes(8, "big") for c in ctr]
        from cryptography.hazmat.primitives.ciphers import (
            Cipher, algorithms, modes)
        enc = Cipher(algorithms.AES(SEED), modes.ECB()).encryptor()
        vals = [int.from_bytes(enc.update(b), "big") for b in blocks]
        oracle = [(v >> (j * int_bits)) & ((1 << int_bits) - 1)
                  for v in vals for j in range(merge)][:count]
        assert _u32(got).tolist() == oracle


def test_lanes_from_words_refuses_wide_lanes():
    with pytest.raises(ValueError, match="int_bits <= 32"):
        masks.lanes_from_words(torch.zeros((1, 4), dtype=torch.int64), 40)
