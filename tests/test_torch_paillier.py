"""PyTorch port: the Paillier cipher and one Paillier round against the JAX
package, on the CPU (the plain versions of the Montgomery kernels).

One 256-bit keypair, built from numpy-seeded primes, serves both packages;
the obfuscators r are fixed through the `_obfuscators` seam, as the JAX
package's own tests fix them.  Ciphertexts, aggregates and decrypted sums
are bit-exact; the new global vector matches to rtol 1e-6 and atol 1e-6
(the float decode differs only in rounding).  One JAX cipher is built per
module and shared, so that each JAX shape compiles once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.crypto import paillier as jp
from flashe_tpu.nn import models as jmodels
from flashe_tpu.nn.weights import WeightsCodec as JCodec
from flashe_tpu.ops.lanes import lanes_to_ints as jlanes_to_ints
from flashe_tpu.protocol.blocks import paillier as jblocks
from flashe_tpu.quant.quantizer import QuantizingClient as JQuant
from flashe_tpu_torch.crypto import paillier as pp
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops import quantize as pq
from flashe_tpu_torch.protocol.aggregator import (
    arbiter_reduce, client_download, client_upload)
from flashe_tpu_torch.protocol.blocks import paillier as pblocks

INT_BITS, EB, N_CLIENTS = 240, 16, 3
ARGS = {"key_length": 256, "quantize": {
    "int_bits": INT_BITS, "batch": True, "element_bits": EB, "padding": True,
    "secure": True}}
N_LANES = 53  # MLP(features=(32, 8)) on 12 inputs: 680 weights, 13 a lane


def _prime(rng, bits):
    """The first probable prime at or above a seeded odd number whose top
    two bits are set (so that p * q has exactly 2 * bits bits)."""
    cand = int.from_bytes(rng.bytes(bits // 8), "big") | (3 << (bits - 2)) | 1
    while not pp._is_probable_prime(cand):
        cand += 2
    return cand


def _obfuscators(rng, n, count):
    return [int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1
            for _ in range(count)]


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(21)
    p, q = _prime(rng, 128), _prime(rng, 128)
    jpub = jp.PaillierPublicKey(p * q)
    ppub = pp.PaillierPublicKey(p * q)
    assert ppub.n.bit_length() == 256
    jc = jp.PaillierCipher()
    jc.set_public_key(jpub)
    jc.set_privacy_key(jp.PaillierPrivateKey(jpub, p, q))
    return dict(p=p, q=q, jcipher=jc, jpriv=jc.privacy_key,
                pkeys=(ppub, pp.PaillierPrivateKey(ppub, p, q)))


def test_key_code_matches_jax(keys):
    ppub, ppriv = keys["pkeys"]
    jpriv = keys["jpriv"]
    assert (ppriv.p, ppriv.q, ppriv.hp, ppriv.hq, ppriv.q_inverse) == (
        jpriv.p, jpriv.q, jpriv.hp, jpriv.hq, jpriv.q_inverse)
    assert ppub.max_int == jpriv.public_key.max_int
    with pytest.raises(ValueError, match="mismatch"):
        pp.PaillierPrivateKey(ppub, keys["p"], keys["q"] + 2)
    assert [pp._is_probable_prime(v) for v in (2, 9, 97, 561, 2**61 - 1)] \
        == [True, False, True, False, True]
    assert pp.getprimeover(40).bit_length() == 40


def test_cipher_matches_jax(keys):
    rng = np.random.default_rng(22)
    ppub, ppriv = keys["pkeys"]
    jc = keys["jcipher"]
    pc = pp.PaillierCipher(device="cpu")
    pc.set_public_key(ppub)
    pc.set_privacy_key(ppriv)
    msgs = [np.array([int.from_bytes(rng.bytes(30), "big")
                      for _ in range(N_LANES)], dtype=object)
            for _ in range(2)]
    msgs[0][:3] = [0, 1, ppub.n - 1]
    cts, jcts = [], []
    for m in msgs:
        rs = _obfuscators(rng, ppub.n, N_LANES)
        pc._obfuscators = jc._obfuscators = lambda count, rs=rs: rs[:count]
        cts.append(pc.encrypt(m))
        jcts.append(jc.encrypt(m))
        assert list(cts[-1]) == list(jcts[-1]) == [
            ppub.encrypt_scalar(int(v), r) for v, r in zip(m, rs)]
    # three uploads, one of them twice (the id-dedup path)
    agg = pc.add_ciphertexts([cts[0], cts[1], cts[0]])
    jagg = jc.add_ciphertexts([jcts[0], jcts[1], jcts[0]])
    assert list(agg) == list(jagg)
    dec = pc.decrypt(agg)  # 53 rows: the fused modexp
    assert list(dec) == list(jc.decrypt(jagg)) == [
        (2 * int(a) + int(b)) % ppub.n for a, b in zip(*msgs)]
    dec5 = pc.decrypt(agg[:5])  # 5 rows: the chain of single products
    assert list(dec5) == [ppriv.decrypt_scalar(int(c)) for c in agg[:5]]


def _mlp_weights():
    params = jmodels.init_params(jmodels.MLP(features=(32, 8)),
                                 jnp.zeros((2, 12)), seed=0)
    names = {f"{l}/{k}": np.array(v) for l, d in params.items()
             for k, v in d.items()}
    rng = np.random.default_rng(23)
    weights = [{k: (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
                for k, v in names.items()} for _ in range(N_CLIENTS)]
    return params, names, weights


def test_paillier_round_matches_jax(keys):
    """Guest and two hosts upload, the arbiter multiplies, every client
    decrypts and decodes: the JAX blocks' steps against the port's cores."""
    params, names, weights = _mlp_weights()
    jcodec = JCodec(params)
    pcodec = WeightsCodec({k: torch.from_numpy(v) for k, v in names.items()},
                          device="cpu")
    assert -(-pcodec.total // (INT_BITS // (EB + 2))) == N_LANES
    clients, arbiter = pblocks.make_session(ARGS, N_CLIENTS,
                                            keypair=keys["pkeys"], device="cpu")
    assert arbiter.cipher.privacy_key is None
    jclients = []
    for i in range(N_CLIENTS):
        jb = (jblocks.Guest if i == 0 else jblocks.Host)(ARGS)
        jb.cipher = keys["jcipher"]  # one JAX cipher: one compile a shape
        jb.quantizer = JQuant(INT_BITS, True, EB, True, True,
                              seed=0 if i == 0 else 1)
        jb.quantizer.set_num_clients(N_CLIENTS)
        jb.set_codec(jcodec)
        clients[i].set_codec(pcodec)
        jclients.append(jb)
    jarb = jblocks.Arbiter(ARGS)
    jarb.cipher = keys["jcipher"]

    rng = np.random.default_rng(24)
    ups, jcts, packed, jqs = [], [], [], []
    for i, (pb, jb) in enumerate(zip(clients, jclients)):
        jflat = jcodec.flatten({l: {k: jnp.asarray(weights[i][f"{l}/{k}"])
                                    for k in d} for l, d in params.items()})
        pflat = pcodec.flatten({k: torch.from_numpy(v)
                                for k, v in weights[i].items()})
        _, k = jax.random.split(jb.quantizer._key)
        u = np.array(jax.random.uniform(k, (pcodec.total,), dtype=jnp.float32))
        rs = _obfuscators(rng, keys["p"] * keys["q"], N_LANES)
        pb.cipher._obfuscators = lambda count, rs=rs: rs[:count]
        jb.cipher._obfuscators = lambda count, rs=rs: rs[:count]
        jb.set_iter_index(0)
        jq = jb.quantize(jb.normalize(jflat))
        jqs.append(np.asarray(jq))
        packed.append(jlanes_to_ints(jqs[-1], INT_BITS))
        jcts.append(jb.encrypt(jq))
        ups.append(client_upload(pb, pcodec, pflat, 0,
                                 uniforms=torch.from_numpy(u)))
        assert list(ups[-1].lanes) == list(jcts[-1])
        assert ups[-1].idx_list is None and ups[-1].n_elements == pcodec.total

    agg = arbiter_reduce([u.lanes for u in ups], block=arbiter)
    jagg = jarb.add_ciphertexts(jcts)
    assert list(agg) == list(jagg)
    sums = clients[0].cipher.decrypt(agg)
    assert list(sums) == list(sum(packed))  # fields never carry

    degrees = float(N_CLIENTS)
    for pb, jb in zip(clients, jclients):
        jlanes = jb.decrypt(np.asarray(jagg), pcodec.total)
        np.testing.assert_array_equal(
            pb.decrypt(agg).numpy().view(np.uint32), np.asarray(jlanes))
        jflat = jb.unnormalize(jb.unquantize(jlanes, pcodec.total, None)
                               / degrees)
        flat = client_download(pb, agg, None, pcodec.total, degrees)
        np.testing.assert_allclose(flat.numpy(), np.asarray(jflat),
                                   rtol=1e-6, atol=1e-6)
    # the unpacked fields are the per-element sums of the clients' q
    fields = pq.unbatch_lanes(clients[0].decrypt(agg), pcodec.total,
                              INT_BITS, EB, 2)
    want = sum(pq.unbatch_lanes(torch.from_numpy(q.view(np.int32).copy()),
                                pcodec.total, INT_BITS, EB, 2).long()
               for q in jqs)
    assert torch.equal(fields.long(), want)


def test_make_session_keys_hosts_from_the_guest():
    """Without a keypair the guest generates one; the hosts get its primes
    and the arbiter only n."""
    args = dict(ARGS, key_length=128)
    clients, arbiter = pblocks.make_session(args, 3, device="cpu")
    guest = clients[0].cipher
    assert guest.get_n().bit_length() == 128
    for c in clients[1:]:
        assert (c.cipher.privacy_key.p, c.cipher.privacy_key.q) == (
            guest.privacy_key.p, guest.privacy_key.q)
    assert arbiter.cipher.get_n() == guest.get_n()
    assert arbiter.cipher.privacy_key is None
    assert [c.quantizer.generator.initial_seed() for c in clients] == [0, 1, 1]
    assert all(c.quantizer.num_clients == 3 and c.quantizer.batch
               for c in clients)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.PaillierCipher(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pblocks.Arbiter(ARGS, device="cuda")
