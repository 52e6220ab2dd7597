"""PyTorch port: the sparsified FLASHE round against the JAX package.

The top-s% Sparsifier with its residual memory, the wire encoding of the
locations, the quantizer's gathers, the arbiter's dynamic masking choice,
the single mask and the sparse (compact-counter) decrypt of FlasheCipher,
and the whole sparse round with a dropout, single and double mask.  The
JAX side runs through its XLA path on the CPU and gets the port's inputs
(numpy, seeded) and its own uniforms, which the port is handed too.
Bit-exact throughout, except the new global model: rtol and atol 1e-6
(the float decode differs only in rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.crypto.flashe import FlasheCipher as JCipher
from flashe_tpu.nn import models as jmodels
from flashe_tpu.nn.weights import WeightsCodec as JCodec
from flashe_tpu.ops import masks as jmasks
from flashe_tpu.ops.lanes import lane_add as jlane_add
from flashe_tpu.protocol import sparsify as jsparsify
from flashe_tpu.protocol.blocks import flashe as jblocks
from flashe_tpu.quant.quantizer import QuantizingClient as JQuant
from flashe_tpu.quant.quantizer import quantized_zero as jquantized_zero
from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops import flashe_mask
from flashe_tpu_torch.ops.lanes import lane_add, lanes_to_ints
from flashe_tpu_torch.protocol import sparsify
from flashe_tpu_torch.protocol.aggregator import (
    ClientBlock, arbiter_reduce, client_download, client_select,
    client_upload_sparse)
from flashe_tpu_torch.protocol.blocks import flashe as pblocks
from flashe_tpu_torch.quant.quantizer import QuantizingClient

SEED = 0x5EED_F1A5_E
HOST_SEED = bytes(range(100, 132))
INT_BITS, EB, N_CLIENTS, SPARSITY = 20, 16, 3, 0.1


def _u32(t):
    return t.numpy().view(np.uint32)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _mlp():
    params = jmodels.init_params(jmodels.MLP(features=(32, 8)),
                                 jnp.zeros((2, 12)), seed=0)
    names = {f"{l}/{k}": np.array(v) for l, d in params.items()
             for k, v in d.items()}
    jcodec = JCodec(params)
    pcodec = WeightsCodec({k: torch.from_numpy(v) for k, v in names.items()},
                          device="cpu")
    return jcodec, pcodec


def _jax_uniform(jq, shape):
    """The uniforms the JAX quantizer's next draw takes."""
    _, k = jax.random.split(jq._key)
    u = jax.random.uniform(k, shape, dtype=jnp.float32)
    return np.array(u) if shape else float(u)


# -- selection and the wire ----------------------------------------------

def test_sparsifier_matches_jax_over_two_iterations():
    jcodec, pcodec = _mlp()
    port = sparsify.Sparsifier(pcodec, SPARSITY)
    ref = jsparsify.Sparsifier(jcodec, SPARSITY)
    # a layer of 8 selects max(1, floor(0.8)) = 1 position
    assert port.counts() == [3, 38, 1, 25]
    rng = np.random.default_rng(5)
    for _ in range(2):  # the second selection carries the first's residual
        delta = rng.standard_normal(pcodec.total).astype(np.float32)
        got = port.sparsify(torch.from_numpy(delta))
        want = ref.sparsify(delta)
        np.testing.assert_array_equal(got.locations.numpy(), want.locations)
        np.testing.assert_array_equal(got.values.numpy(), want.values)
        np.testing.assert_array_equal(port.residual.numpy(), ref.residual)
        assert got.total == want.total == pcodec.total


@pytest.mark.parametrize("total", [37, 1_206_590])
def test_locations_encode_like_jax(total):
    rng = np.random.default_rng(total)
    locs = np.sort(rng.choice(total, size=min(total, 300), replace=False))
    got = sparsify.encode_locations(torch.from_numpy(locs), total)
    want = jsparsify.encode_locations(locs, total)
    assert got == want
    np.testing.assert_array_equal(sparsify.decode_locations(got), locs)
    np.testing.assert_array_equal(sparsify.decode_locations(want),
                                  jsparsify.decode_locations(want))


# -- the quantizer's gathers ---------------------------------------------

def _quantizers(jcodec, pcodec):
    pq = QuantizingClient(INT_BITS, False, EB, True, True, seed=1,
                          device="cpu")
    jq = JQuant(INT_BITS, False, EB, True, True, seed=1)
    pq.set_codec(pcodec)
    jq.set_codec(jcodec)
    rng = np.random.default_rng(8)
    mean = (rng.standard_normal(pcodec.n_layers) * 0.1).astype(np.float32)
    std = (rng.random(pcodec.n_layers) + 0.05).astype(np.float32)
    for q in (pq, jq):
        q.set_num_clients(N_CLIENTS)
        q.past_mean, q.past_std = mean.copy(), std.copy()
    return pq, jq


def test_gathers_match_jax():
    jcodec, pcodec = _mlp()
    pq, jq = _quantizers(jcodec, pcodec)
    rng = np.random.default_rng(9)
    locs = np.sort(rng.choice(pcodec.total, 40, replace=False))
    vals = (rng.standard_normal(40) * 0.5).astype(np.float32)
    got = pq.normalize_gather(torch.from_numpy(vals), torch.from_numpy(locs))
    want = np.asarray(jq.normalize_gather(vals, locs))
    np.testing.assert_array_equal(got.numpy(), want)

    u = _jax_uniform(jq, (40,))
    want = np.asarray(jq.quantize_gather(want, locs))
    got = pq.quantize_gather(got, torch.from_numpy(locs),
                             uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(pq.alpha, jq.alpha)

    u = _jax_uniform(jq, ())
    assert pq.quantized_zero(u) == jq.quantized_zero()


def test_local_min_max_matches_jax():
    jcodec, pcodec = _mlp()
    pq, jq = _quantizers(jcodec, pcodec)
    flat = np.random.default_rng(10).standard_normal(pcodec.total).astype(
        np.float32)
    for got, want in zip(pq.local_min_max(torch.from_numpy(flat)),
                         jq.local_min_max(jnp.asarray(flat))):
        np.testing.assert_array_equal(got, want)


def test_quantized_zero_takes_its_uniform():
    key = jax.random.PRNGKey(3)
    u = float(jax.random.uniform(key, ()))
    from flashe_tpu_torch.quant.quantizer import quantized_zero
    assert quantized_zero(EB, u) == jquantized_zero(EB, key)


# -- the dynamic masking choice ------------------------------------------

class _Recorder:
    def __init__(self):
        self.sent = []

    def remote(self, obj, **kw):
        self.sent.append(obj)


def _jax_choice(masks, total):
    arb = jblocks.Arbiter({"quantize": {"int_bits": INT_BITS, "batch": False,
                                        "element_bits": EB, "secure": True},
                           "mask": "dynamic"})
    arb._trv = type("Trv", (), {})()
    arb._trv.arbiter_to_guest, arb._trv.arbiter_to_host = (_Recorder(),
                                                           _Recorder())
    arb.dynamic_masking(masks, total, suffix=(0,))
    (guest,), (host,) = (arb._trv.arbiter_to_guest.sent,
                         arb._trv.arbiter_to_host.sent)
    assert guest == host
    return guest["choice"]


@pytest.mark.parametrize("kind", ["disjoint", "identical", "random", "one"])
def test_dynamic_choice_matches_jax_and_is_always_single(kind):
    total, rng = 500, np.random.default_rng(11)
    if kind == "disjoint":
        masks = [np.arange(i * 50, i * 50 + 50) for i in range(4)]
    elif kind == "identical":
        masks = [np.arange(0, 500, 3)] * 4
    elif kind == "one":
        masks = [np.arange(100)]
    else:
        masks = [np.sort(rng.choice(total, rng.integers(1, 200),
                                    replace=False)) for _ in range(6)]
    got = pblocks.choose_masking(masks, total, device="cpu")
    assert got == _jax_choice(masks, total) == "single"
    d = pblocks.arbiter_masking(masks, total, "dynamic", device="cpu")
    assert d["choice"] == "single" and d["masks"] is masks
    # without mask="dynamic" the configured mask is broadcast with the
    # locations
    assert pblocks.arbiter_masking(masks, total, "double",
                                   device="cpu")["choice"] == "double"


def test_parse_args_matches_jax():
    args = {"quantize": {"int_bits": 20, "batch": False, "element_bits": 16,
                         "padding": True, "secure": True},
            "mask": "dynamic", "precompute": {"enable": False}}
    assert pblocks._parse_args(args) == jblocks._parse_args(args)


# -- FlasheCipher: single mask and the sparse decrypt ---------------------

def _setup_cipher(c, idx, n_clients, it, seed):
    c.idx = idx
    c.set_num_clients(n_clients)
    c.generate_prp_seed(assigned_seed=seed)
    c.set_iter_index(it)
    return c


def _cipher(mask, idx, n_clients, it, seed=SEED):
    return _setup_cipher(FlasheCipher(INT_BITS, mask=mask, device="cpu"), idx,
                         n_clients, it, seed)


def _cipher_pair(mask, idx, n_clients, it, seed=SEED):
    return (_cipher(mask, idx, n_clients, it, seed),
            _setup_cipher(JCipher(INT_BITS, mask=mask), idx, n_clients, it,
                          seed))


def test_single_mask_encrypt_and_dense_decrypt_match_jax():
    count, it, n = 301, 4, 3
    rng = np.random.default_rng(12)
    qs = [rng.integers(0, 1 << 16, count, dtype=np.uint64).astype(np.uint32)
          for _ in range(n)]
    cts, jcts = [], []
    for i in range(n):
        p, j = _cipher_pair("single", i, n, it)
        cts.append(p.encrypt(_i32(qs[i])))
        jcts.append(np.asarray(j.encrypt(qs[i])))
        np.testing.assert_array_equal(_u32(cts[i]), jcts[i])
    for survivors in ([0, 1, 2], [0, 2]):
        agg, jagg = cts[survivors[0]], jcts[survivors[0]]
        for i in survivors[1:]:
            agg = lane_add(agg, cts[i], INT_BITS)
            jagg = np.asarray(jlane_add(jagg, jcts[i], INT_BITS))
        p, j = _cipher_pair("single", 0, n, it)
        got = p.decrypt(agg, survivors)
        np.testing.assert_array_equal(_u32(got),
                                      np.asarray(j.decrypt(jagg, survivors)))
        want = sum(qs[i].astype(np.int64) for i in survivors)
        np.testing.assert_array_equal(_u32(got).astype(np.int64),
                                      want % (1 << INT_BITS))


@pytest.mark.parametrize("mask", ["single", "double"])
def test_sparse_decrypt_matches_host_golden(mask):
    """The port's sparse encrypt and decrypt against tests/
    test_sparse_golden.py's host oracle: every mask from the `cryptography`
    AES, python ints throughout (the sparse round below holds the same
    decrypt against the JAX cipher)."""
    total, it, qz, n = 37, 5, 77, 3
    rng = np.random.RandomState(7)
    locs = [np.sort(rng.choice(total, size=cnt, replace=False))
            for cnt in (9, 14, 6)]
    qs = [rng.randint(0, 1 << 16, size=len(l)).astype(np.uint32)
          for l in locs]
    mod = 1 << INT_BITS
    dense_agg = np.zeros(total, dtype=object)
    expected = np.zeros(total, dtype=object)
    jdense = None
    for i, (q, loc) in enumerate(zip(qs, locs)):
        add = jmasks.reference_mask_stream_host(HOST_SEED, it, i, len(loc),
                                                INT_BITS)
        ct = (q.astype(object) + add) % mod
        if mask == "double":
            ct = (ct - jmasks.reference_mask_stream_host(
                HOST_SEED, it, i + 1, len(loc), INT_BITS)) % mod
        p = _cipher(mask, i, n, it, HOST_SEED)
        got = p.encrypt(_i32(q))
        np.testing.assert_array_equal(_u32(got).astype(object), ct)
        dense = np.full(total, qz, dtype=object)
        dense[loc] = ct
        dense_agg = (dense_agg + dense) % mod
        plain = np.full(total, qz, dtype=object)
        plain[loc] = q
        expected = (expected + plain) % mod
    p = _cipher(mask, 0, n, it, HOST_SEED)
    p.set_masks(locs, total)
    agg = _i32(dense_agg.astype(np.uint32))
    got = p.decrypt(agg, list(range(n)))
    np.testing.assert_array_equal(_u32(got).astype(object), expected)
    # the aggregate the caller holds is left as it was
    np.testing.assert_array_equal(_u32(agg), dense_agg.astype(np.uint32))


def test_set_masks_refuses_locations_the_scatter_cannot_take():
    c = FlasheCipher(INT_BITS, device="cpu")
    for bad in ([0, 4], [2, 1], [1, 1], [-1, 2]):
        with pytest.raises(ValueError, match="strictly increasing"):
            c.set_masks([[0, 1], bad], 4)
    c.set_masks([[], [3]], 4)
    assert [m.tolist() for m in c.masks] == [[], [3]] and c.total == 4
    c.set_masks(None, 4)
    assert c.masks is None


def test_sparse_decrypt_launches_one_scatter_a_survivor(monkeypatch):
    calls = []
    real = flashe_mask.mask_scatter

    def spy(out, loc, rk, it, add, minus, m, base_block=0):
        calls.append((len(loc), add, minus))
        return real(out, loc, rk, it, add, minus, m, base_block)

    import flashe_tpu_torch.crypto.flashe as pflashe
    monkeypatch.setattr(pflashe, "mask_scatter", spy)
    for mask, want in (("single", [(2, None, 0), (1, None, 2)]),
                       ("double", [(2, 1, 0), (1, 3, 2)])):
        calls.clear()
        c, _ = _cipher_pair(mask, 0, 3, 0)
        c.set_masks([[0, 3], [1], [2]], 4)
        c.decrypt(torch.zeros(4, dtype=torch.int32), [0, 2])
        assert calls == want


# -- the whole sparse round ----------------------------------------------

def _setup_round(mask):
    jcodec, pcodec = _mlp()
    rng = np.random.default_rng(21)
    before = (rng.standard_normal(pcodec.total) * 0.2).astype(np.float32)
    port, ref = [], []
    cipher_mask = "double" if mask == "dynamic" else mask
    for i in range(N_CLIENTS):
        pc, jc = _cipher_pair(cipher_mask, i, N_CLIENTS, 0)
        pq = QuantizingClient(INT_BITS, False, EB, True, True, seed=i,
                              device="cpu")
        jq = JQuant(INT_BITS, False, EB, True, True, seed=i)
        for q, codec in ((pq, pcodec), (jq, jcodec)):
            q.set_num_clients(N_CLIENTS)
            q.set_codec(codec)
        port.append((ClientBlock(pc, pq), sparsify.Sparsifier(pcodec,
                                                              SPARSITY)))
        ref.append((jc, jq, jsparsify.Sparsifier(jcodec, SPARSITY)))
    return pcodec, port, ref, before, rng


def _sparse_round(it, survivors, mask, pcodec, port, ref, before, rng):
    flats = [before + (rng.standard_normal(pcodec.total) * 0.05).astype(
        np.float32) for _ in range(N_CLIENTS)]
    total = pcodec.total
    # every client selects and sends its locations
    sels, jres = [], []
    for i in range(N_CLIENTS):
        block, sp = port[i]
        sels.append(client_select(block, sp, torch.from_numpy(flats[i]),
                                  torch.from_numpy(before)))
        jc, jq, jsp = ref[i]
        jres.append(jsp.sparsify(flats[i] - before))
        jc.total = jres[i].total
        assert sels[i].encoded == jsparsify.encode_locations(
            jres[i].locations, total)
        np.testing.assert_array_equal(sels[i].result.values.numpy(),
                                      jres[i].values)
    masks = [sparsify.decode_locations(s.encoded) for s in sels]
    broadcast = pblocks.arbiter_masking(masks, total, mask, device="cpu")
    if mask == "dynamic":
        assert broadcast["choice"] == _jax_choice(masks, total) == "single"
    # every client quantizes and encrypts its compacted values
    ups, jcts, qs = [], [], []
    for i in range(N_CLIENTS):
        (block, _), (jc, jq, _) = port[i], ref[i]
        jc.set_iter_index(it)
        jc.masking_scheme = broadcast["choice"]
        jc.set_masks(masks, total)
        loc = jres[i].locations
        u = _jax_uniform(jq, (len(loc),))
        q = jq.quantize_gather(jq.normalize_gather(jnp.asarray(jres[i].values),
                                                   loc), loc)
        enc = jc.encrypt(q)
        zero_u = _jax_uniform(jq, ())
        qz = jq.quantized_zero()
        jcts.append(np.concatenate([np.asarray(enc), [qz]]).astype(np.uint32))
        qs.append((np.asarray(q).astype(np.int64), qz))
        ups.append(client_upload_sparse(block, sels[i], broadcast, it,
                                        uniforms=torch.from_numpy(u),
                                        zero_u=zero_u))
        np.testing.assert_array_equal(_u32(ups[i].lanes), jcts[i])
        assert ups[i].n_elements == len(loc) and ups[i].idx_list == [i]
        assert block.cipher.masking_scheme == broadcast["choice"]
    # the arbiter densifies the survivors' uploads with their fillers
    agg = arbiter_reduce([ups[i].lanes for i in survivors], INT_BITS,
                         masks=[masks[i] for i in survivors], total=total)
    jagg = None
    for i in survivors:
        d = np.full(total, jcts[i][-1], np.uint32)
        d[masks[i]] = jcts[i][:-1]
        jagg = d if jagg is None else np.asarray(jlane_add(jagg, d, INT_BITS))
    np.testing.assert_array_equal(_u32(agg), jagg)
    # the decrypt is the survivors' dense plaintext sum
    jdec = np.asarray(ref[0][0].decrypt(jnp.asarray(jagg), survivors))
    dec = port[0][0].cipher.decrypt(agg, survivors)
    np.testing.assert_array_equal(_u32(dec), jdec)
    want = np.zeros(total, np.int64)
    for i in survivors:
        d = np.full(total, qs[i][1], np.int64)
        d[masks[i]] = qs[i][0]
        want += d
    np.testing.assert_array_equal(jdec.astype(np.int64),
                                  want % (1 << INT_BITS))
    # every client installs the new model
    degrees = float(len(survivors))
    new = None
    for i in range(N_CLIENTS):
        (block, _), (jc, jq, _) = port[i], ref[i]
        jflat = jq.unquantize(jnp.asarray(jdec), total, len(survivors))
        jflat = np.asarray(jq.unnormalize(jflat / degrees)) + before
        flat = client_download(block, agg, survivors, total, degrees,
                               before=torch.from_numpy(before))
        np.testing.assert_allclose(flat.numpy(), jflat, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(block.quantizer.past_std, jq.past_std,
                                   rtol=1e-5)
        block.quantizer.past_mean = np.asarray(jq.past_mean).copy()
        block.quantizer.past_std = np.asarray(jq.past_std).copy()
        new = jflat
    return new.astype(np.float32)


@pytest.mark.parametrize("mask", ["dynamic", "double"])
def test_sparse_round_matches_jax_then_dropout_round(mask):
    pcodec, port, ref, before, rng = _setup_round(mask)
    before = _sparse_round(0, [0, 1, 2], mask, pcodec, port, ref, before, rng)
    # client 1 missed the deadline; the residuals carry over
    _sparse_round(1, [0, 2], mask, pcodec, port, ref, before, rng)
    assert port[1][1].residual is not None
    np.testing.assert_array_equal(port[1][1].residual.numpy(),
                                  ref[1][2].residual)


def test_sparse_decrypt_above_32_bits_raises():
    c = FlasheCipher(40, device="cpu")
    c.generate_prp_seed(assigned_seed=SEED)
    c.set_num_clients(1)
    c.set_masks([[0]], 2)
    with pytest.raises(NotImplementedError, match="int_bits <= 32"):
        c.decrypt(torch.zeros(2, 2, dtype=torch.int32), [0])


def test_decrypted_lanes_are_python_ints_of_the_sum():
    # lanes_to_ints of a sparse decrypt: the plain sums as python ints
    p, _ = _cipher_pair("single", 0, 1, 0)
    q = np.array([5, 9, 1 << 19], np.uint32)
    p.set_masks([[0, 2]], 3)
    c = p.encrypt(_i32(q[[0, 2]]))
    agg = _i32(np.array([0, 9, 0], np.uint32))
    agg[[0, 2]] = c
    assert list(lanes_to_ints(p.decrypt(agg, [0]), INT_BITS)) == [5, 9,
                                                                 1 << 19]
