"""PyTorch port: one FLASHE round as a whole against the JAX package.

Three clients with their own numpy-seeded MLP(features=(32, 8)) weights,
int_bits 20, element_bits 16, the secure ACIQ quantizer and the double mask.
The JAX side runs the steps of Client.secure_aggregate (dense branch),
Arbiter._reduce and Client.get_aggregated_model without their transport;
the port runs client_upload, arbiter_reduce and client_download.  Both get
the same uniforms, drawn with jax.random from each JAX client's key.
Ciphertexts, aggregate and decrypted lanes are bit-exact; the new global
vector matches to rtol 1e-6 and atol 1e-6 (the float decode differs only in
rounding).  The same round runs at int_bits 120 with batch packing
(examples/configs/cnn_flashe_q16_b6_pad.json at this size): lanes of 6
fields, 4 limbs each.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.crypto.flashe import FlasheCipher as JCipher
from flashe_tpu.nn import models as jmodels
from flashe_tpu.nn.weights import WeightsCodec as JCodec
from flashe_tpu.ops.lanes import lane_add as jlane_add
from flashe_tpu.quant.quantizer import QuantizingClient as JQuant
from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.ops.lanes import lanes_to_ints
from flashe_tpu_torch.protocol.aggregator import (
    ClientBlock, arbiter_reduce, client_download, client_upload)
from flashe_tpu_torch.quant.quantizer import QuantizingClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0x5EED_F1A5_E
INT_BITS, EB, N_CLIENTS = 20, 16, 3


def _u32(t):
    return t.numpy().view(np.uint32)


def _setup(int_bits=INT_BITS, batch=False):
    params = jmodels.init_params(jmodels.MLP(features=(32, 8)),
                                 jnp.zeros((2, 12)), seed=0)
    names = {f"{l}/{k}": np.array(v) for l, d in params.items()
             for k, v in d.items()}
    rng = np.random.default_rng(11)
    weights = [{k: (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
                for k, v in names.items()} for _ in range(N_CLIENTS)]
    jcodec = JCodec(params)
    pcodec = WeightsCodec({k: torch.from_numpy(v) for k, v in names.items()},
                          device="cpu")
    port, ref = [], []
    for i in range(N_CLIENTS):
        pc, jc = FlasheCipher(int_bits, device="cpu"), JCipher(int_bits)
        pq = QuantizingClient(int_bits, batch, EB, True, True, seed=i,
                              device="cpu")
        jq = JQuant(int_bits, batch, EB, True, True, seed=i)
        for c, q, codec in ((pc, pq, pcodec), (jc, jq, jcodec)):
            c.idx = i
            c.set_num_clients(N_CLIENTS)
            c.generate_prp_seed(assigned_seed=SEED)
            q.set_num_clients(N_CLIENTS)
            q.set_codec(codec)
        port.append(ClientBlock(pc, pq))
        ref.append((jc, jq))
    jflats = [jcodec.flatten({l: {k: jnp.asarray(w[f"{l}/{k}"]) for k in d}
                              for l, d in params.items()}) for w in weights]
    pflats = [pcodec.flatten({k: torch.from_numpy(v) for k, v in w.items()})
              for w in weights]
    return pcodec, port, ref, pflats, jflats


def _round(it, survivors, pcodec, port, ref, pflats, jflats,
           int_bits=INT_BITS):
    uploads, jcts, qs = [], [], []
    for i in range(N_CLIENTS):  # every client uploads; the arbiter drops
        jc, jq = ref[i]
        jc.set_iter_index(it)
        _, k = jax.random.split(jq._key)
        u = np.array(jax.random.uniform(k, (pcodec.total,), dtype=jnp.float32))
        q = jq.quantize(jq.normalize(jflats[i]))
        qs.append(lanes_to_ints(np.asarray(q).view(np.int32), int_bits))
        jcts.append(jc.encrypt(q))
        uploads.append(client_upload(port[i], pcodec, pflats[i], it,
                                     uniforms=torch.from_numpy(u)))
        np.testing.assert_array_equal(_u32(uploads[i].lanes),
                                      np.asarray(jcts[i]))
        assert uploads[i].idx_list == [i] and uploads[i].degree == 1.0

    agg = arbiter_reduce([uploads[i].lanes for i in survivors], int_bits)
    jagg = jcts[survivors[0]]
    for i in survivors[1:]:
        jagg = jlane_add(jagg, jcts[i], int_bits)
    np.testing.assert_array_equal(_u32(agg), np.asarray(jagg))

    jc0, _ = ref[0]
    jdec = np.asarray(jc0.decrypt(jagg, survivors))
    np.testing.assert_array_equal(_u32(port[0].cipher.decrypt(agg, survivors)),
                                  jdec)
    want = sum(qs[i] for i in survivors) % (1 << int_bits)
    assert list(lanes_to_ints(jdec.view(np.int32), int_bits)) == list(want)

    degrees = float(len(survivors))
    for i in range(N_CLIENTS):  # every client installs the new model
        jc, jq = ref[i]
        jflat = jq.unquantize(jnp.asarray(jc.decrypt(jagg, survivors)),
                              pcodec.total, len(survivors))
        jflat = jq.unnormalize(jflat / (degrees / 1.0)) / 1.0
        flat = client_download(port[i], agg, survivors, pcodec.total, degrees)
        np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=1e-6,
                                   atol=1e-6)
        # the layer statistics are segment sums taken in another order: they
        # agree to rounding, and the next round starts from the same ones
        np.testing.assert_allclose(port[i].quantizer.past_std, jq.past_std,
                                   rtol=1e-5)
        port[i].quantizer.past_mean = np.asarray(jq.past_mean).copy()
        port[i].quantizer.past_std = np.asarray(jq.past_std).copy()


def test_round_matches_jax_then_dropout_round():
    state = _setup()
    _round(0, [0, 1, 2], *state)
    _round(1, [0, 2], *state)  # client 1 missed the upload deadline


def test_batched_120_bit_round_matches_jax_then_dropout_round():
    # factor ceil(log2 3) = 2: 6 fields of 18 bits a 120-bit lane
    state = _setup(120, batch=True)
    pcodec, port = state[0], state[1]
    assert port[0].quantizer.factor == 2
    _round(0, [0, 1, 2], *state, int_bits=120)
    _round(1, [0, 2], *state, int_bits=120)


def test_round_with_degrees_gives_weighted_mean():
    pcodec, port, ref, pflats, jflats = _setup()
    uploads = [client_upload(port[i], pcodec, pflats[i], 0, degree=2.0 + i,
                             uniforms=torch.zeros(pcodec.total))
               for i in range(N_CLIENTS)]
    agg = arbiter_reduce([u.lanes for u in uploads], INT_BITS)
    total = sum(u.degree for u in uploads)
    flat = client_download(port[1], agg, [0, 1, 2], pcodec.total, total,
                           degree=3.0)
    # the degree-weighted mean of the clients' vectors: each client's
    # rounding error is under one quantization step 2 * alpha / 65535, and
    # the decode divides their sum by the total degree
    want = sum((2.0 + i) * pflats[i] for i in range(N_CLIENTS)) / total
    step = 2 * 5.938345 / 65535  # alpha for 16 bits at the prior std of 1
    assert float((flat - want).abs().max()) <= N_CLIENTS * step / total


def test_arbiter_reduce_matches_jax_lane_add_on_limbs():
    rng = np.random.default_rng(12)
    cts = [rng.integers(0, 1 << 32, (9, 2), dtype=np.uint64).astype(np.uint32)
           for _ in range(4)]
    for c in cts:
        c[:, 1] &= 0xFF  # 40-bit lanes
    cts[0][0] = [0xFFFFFFFF, 0xFF]  # carries out of both limbs
    want = cts[0]
    for c in cts[1:]:
        want = np.asarray(jlane_add(want, c, 40))
    got = arbiter_reduce([torch.from_numpy(c.view(np.int32)) for c in cts], 40)
    np.testing.assert_array_equal(_u32(got), want)


def test_arbiter_reduce_at_32_bits_wraps():
    edges = torch.tensor([0, 2**31 - 1, -2**31, -1], dtype=torch.int32)
    got = arbiter_reduce([edges, edges, torch.full((4,), -1, dtype=torch.int32)],
                         32)
    want = [(2 * v - 1) % 2**32 for v in (0, 2**31 - 1, 2**31, 2**32 - 1)]
    np.testing.assert_array_equal(_u32(got), np.array(want, np.uint32))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flashe_tpu_torch\n"
        "for m in pkgutil.walk_packages(flashe_tpu_torch.__path__,"
        " 'flashe_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(ROOT, "chip_smoke.py")) as src, \
                open(script, "w") as dst:
            dst.write(src.read())
    res = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
