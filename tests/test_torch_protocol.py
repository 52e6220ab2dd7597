"""PyTorch port: the federated round (protocol/aggregator.py's roles over the
in-memory federation) on the CPU.

The port's counterpart of tests/test_protocol_e2e.py and
tests/test_dropout_protocol.py, at their shapes: a guest and two hosts over
run_roles, a 13x7 + 7 model, int_bits 20, element_bits 16, the secure ACIQ
quantizer.  Every case asserts that all clients end with the same model
and that it lies within 5e-4 of what the round should give (FedAvg of the
clients' vectors for a dense round), as the JAX tests do; FLASHE, the
batched 120-bit lanes, plain, Paillier (a 512-bit key dense, 256-bit
sparse) and the sparse rounds; a host that crashes, and a slow host that
is dropped, notified, and rejoins, in one and in two partitions.  The
general-HE baselines at small rings: BFV (m = 64, in one and in two
partitions), CKKS (N = 64) and the additive pads, within the tolerances
of tests/test_protocol_baselines.py (5e-4, 1e-4, 1e-4), the BFV aggregate
equal to the clients' summed quantized values.

The slice as a whole:
- the federated FLASHE round equals, bit for bit, the round that the
  transport-free cores compute with the same PRP seed (read from the
  guest's block after its session setup), idx assignment and quantizer
  seeds, dense and sparse; so does the sparse Paillier round, keyed by
  make_session with the session's keypair, whose decrypted aggregate
  equals the sum of the clients' densified quantized values;
- the same inputs through the JAX protocol (flashe_tpu's run_roles, as
  tests/test_protocol_e2e.py runs it) and through the port give new models
  within 5e-4 of each other and of FedAvg (the quantizers draw their
  uniforms from different generators, so the match is statistical: each
  side is within one quantization step, about 1.5e-4 here, per client);
- with `local_lane_shards` 2 (each client's lanes over the CPU twice) the
  round's models equal the single-device round's, bit for bit;
- ModelPayload.pack() bytes equal the JAX payload's at int_bits 20 and 120,
  and a (B, 2, k, N) ring-ciphertext payload splits and joins as the JAX
  payload's does.
"""

from __future__ import annotations

import pickle
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.nn.weights import WeightsCodec as JCodec
from flashe_tpu.protocol import aggregator as jaggregator
from flashe_tpu.protocol.payload import ModelPayload as JPayload
from flashe_tpu.protocol.payload import partition_lanes as jpartition_lanes
from flashe_tpu.runtime.simulate import run_roles as jrun_roles
from flashe_tpu_torch.crypto.flashe import FlasheCipher
from flashe_tpu_torch.nn.weights import WeightsCodec
from flashe_tpu_torch.protocol import aggregator
from flashe_tpu_torch.protocol.aggregator import (
    ClientBlock, arbiter_reduce, client_download, client_select,
    client_upload, client_upload_sparse)
from flashe_tpu_torch.protocol.blocks import paillier as paillier_blocks
from flashe_tpu_torch.protocol.blocks.flashe import arbiter_masking
from flashe_tpu_torch.protocol.payload import (
    ModelPayload, host_lanes, merge_lane_parts, partition_lanes)
from flashe_tpu_torch.protocol.sparsify import Sparsifier, decode_locations
from flashe_tpu_torch.quant.quantizer import QuantizingClient
from flashe_tpu_torch.runtime.simulate import run_roles

N_HOSTS = 2
N_CLIENTS = N_HOSTS + 1
TOL = 5e-4  # as tests/test_protocol_e2e.py: a few quantization steps
Q = {"int_bits": 20, "batch": False, "element_bits": 16, "padding": True,
     "secure": True}


def _template(seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(13, 7).astype(np.float32) * scale,
            "b1": rng.randn(7).astype(np.float32) * scale}


def _flat(t):
    return np.concatenate([t[k].ravel() for k in sorted(t)]).astype(
        np.float32)


def _codec(t):
    return WeightsCodec({k: torch.from_numpy(v) for k, v in t.items()},
                        device="cpu")


def _args(mode="parallel", num_partitions=1, **kw):
    return {"quantize": dict(Q), "precompute": {"enable": False},
            "mode": mode, "num_partitions": num_partitions, **kw}


def _one_at_a_time(block, lock):
    """Run a block's encrypt and decrypt under `lock`.  The CPU's plain
    Montgomery product is thousands of small torch ops a Paillier
    encrypt; three role threads running them at once contend for the GIL
    and take longer in all than one after the other."""
    for name in ("encrypt", "decrypt"):
        def locked(*a, _fn=getattr(block, name)):
            with lock:
                return _fn(*a)
        setattr(block, name, locked)


def _roles(scheme, args, flats, codec, sparsity=1.0, rounds=1, before=None,
           keep=None):
    """Guest, hosts and arbiter over run_roles, `rounds` rounds; each
    client returns its new model of every round (and `keep(agg)` if
    given), the arbiter its dropped hosts of every round."""
    lock = threading.Lock()

    def client(agg, flat0):
        agg.set_codec(codec)
        if scheme == "paillier":
            _one_at_a_time(agg._block, lock)
        flat, outs = torch.from_numpy(flat0), []
        for r in range(rounds):
            prev = flat if before is None else torch.from_numpy(before)
            out = agg.aggregate_then_get(flat, iter_index=r, before=prev,
                                         degree=1.0, suffix=(r,))
            agg.send_loss(0.5, degree=1.0, suffix=(r,))
            assert agg.get_converge_status(suffix=(r, "conv")) is False
            flat = out
            outs.append(out.numpy())
        return (outs, keep(agg)) if keep else outs

    def guest(trv):
        return client(aggregator.with_role("guest", trv, sparsity, scheme,
                                           args, device="cpu"), flats[0])

    def host(trv, h):
        return client(aggregator.with_role("host", trv, sparsity, scheme,
                                           args, device="cpu"), flats[1 + h])

    def arbiter(trv):
        agg = aggregator.with_role("arbiter", trv, sparsity, scheme, args,
                                   device="cpu")
        dropped, losses = [], []
        for r in range(rounds):
            agg.aggregate_and_broadcast(iter_index=r, suffix=(r,))
            dropped.append(list(agg.dropped_hosts))
            losses.append(agg.aggregate_loss(suffix=(r,)))
            agg.send_converge_status(lambda: False, (), suffix=(r, "conv"))
        assert losses == [0.5] * rounds
        return dropped

    return run_roles(N_HOSTS, guest, host, arbiter, timeout=240)


def _clients(res):
    return [res["guest"]] + [res[f"host{h}"] for h in range(N_HOSTS)]


def _dense_inputs():
    templates = [_template(i) for i in range(N_CLIENTS)]
    return [_flat(t) for t in templates], _codec(templates[0])


@pytest.mark.parametrize("args", [
    _args(),
    _args(precompute={"enable": True, "num_params": 13 * 7 + 7}),
    _args(num_partitions=2, wire_pack=True),
    _args(mode="serial"),
    _args(quantize=dict(Q, secure=False)),
    _args(quantize=dict(Q, int_bits=120, batch=True), wire_pack=True),
], ids=["basic", "precompute", "partitioned+wire", "serial", "nonsecure",
        "batched120+wire"])
def test_flashe_round_matches_fedavg(args):
    flats, codec = _dense_inputs()
    res = _roles("flashe", args, flats, codec, rounds=2)
    want = np.mean(flats, axis=0)
    for outs in _clients(res):
        assert np.max(np.abs(outs[0] - want)) < TOL
        np.testing.assert_array_equal(outs[1], res["guest"][1])
    assert res["arbiter"] == [[], []]


@pytest.mark.parametrize("quantize", [dict(Q), None], ids=["q16", "float"])
def test_plain_round(quantize):
    flats, codec = _dense_inputs()
    args = _args(quantize=quantize) if quantize else {"mode": "parallel",
                                                      "num_partitions": 1}
    res = _roles("plain", args, flats, codec)
    want = np.mean(flats, axis=0)
    for outs in _clients(res):
        assert np.max(np.abs(outs[0] - want)) < (TOL if quantize else 1e-6)


def test_flashe_round_equals_the_cores_bit_for_bit():
    """Two federated rounds against the transport-free cores with the
    session's PRP seed, ordinals 0..2 and quantizer seeds 0..2."""
    flats, codec = _dense_inputs()
    res = _roles("flashe", _args(), flats, codec, rounds=2,
                 keep=lambda agg: (agg._block.cipher.idx,
                                   agg._block.cipher.get_prp_seed()))
    seeds = {keep[1] for _, keep in _clients(res)}
    assert len(seeds) == 1
    assert [keep[0] for _, keep in _clients(res)] == [0, 1, 2]
    seed = seeds.pop()
    blocks = []
    for i in range(N_CLIENTS):
        c = FlasheCipher(20, device="cpu")
        c.idx = i
        c.set_num_clients(N_CLIENTS)
        c.generate_prp_seed(assigned_seed=seed)
        q = QuantizingClient(20, False, 16, True, True, seed=i, device="cpu")
        q.set_num_clients(N_CLIENTS)
        q.set_codec(codec)
        blocks.append(ClientBlock(c, q))
    cur = [torch.from_numpy(f) for f in flats]
    for r in range(2):
        ups = [client_upload(b, codec, f, r, degree=1.0)
               for b, f in zip(blocks, cur)]
        agg = arbiter_reduce([u.lanes for u in ups], 20)
        cur = [client_download(b, agg, [0, 1, 2], codec.total, 3.0, 1.0)
               for b in blocks]
        for (outs, _), new in zip(_clients(res), cur):
            assert np.array_equal(outs[r], new.numpy())


def test_flashe_round_matches_the_jax_protocol():
    """The same inputs through flashe_tpu's protocol and the port's: both
    within 5e-4 of FedAvg and of each other."""
    templates = [_template(i) for i in range(N_CLIENTS)]
    flats, codec = [_flat(t) for t in templates], _codec(templates[0])
    args = _args()
    res = _roles("flashe", args, flats, codec)
    jcodec = JCodec(templates[0])

    def jclient(agg, flat0):
        agg.set_codec(jcodec)
        return np.asarray(agg.aggregate_then_get(
            jnp.asarray(flat0), iter_index=0, degree=1.0, suffix=(0,)))

    def jarbiter(trv):
        jaggregator.Arbiter().register_aggregator(
            trv, secure_aggregate="flashe",
            secure_aggregate_args=args).aggregate_and_broadcast(
                iter_index=0, suffix=(0,))

    jres = jrun_roles(
        N_HOSTS,
        lambda trv: jclient(jaggregator.Guest().register_aggregator(
            trv, secure_aggregate="flashe", secure_aggregate_args=args),
            flats[0]),
        lambda trv, h: jclient(jaggregator.Host().register_aggregator(
            trv, secure_aggregate="flashe", secure_aggregate_args=args),
            flats[1 + h]),
        jarbiter)
    want = np.mean(flats, axis=0)
    for role in ("guest", "host0", "host1"):
        port = res[role][0]
        assert np.max(np.abs(port - want)) < TOL
        assert np.max(np.abs(jres[role] - want)) < TOL
        assert np.max(np.abs(port - jres[role])) < TOL


def _sparse_inputs(seed):
    base_t = _template(100 + seed)
    base = _flat(base_t)
    rng = np.random.RandomState(7 + seed)
    flats = [base + 0.05 * rng.randn(base.size).astype(np.float32)
             for _ in range(N_CLIENTS)]
    return base, flats, _codec(base_t)


@pytest.mark.parametrize("mask", ["dynamic", "double"])
def test_flashe_sparse_round_equals_the_cores(mask):
    """Sparsity 0.3: the federated round, whose arbiter broadcasts the
    choice and the locations under every mask, equals the cores' sparse
    round bit for bit; the dynamic choice is single."""
    base, flats, codec = _sparse_inputs(0)
    args = _args(mask=mask)
    res = _roles("flashe", args, flats, codec, sparsity=0.3, before=base,
                 keep=lambda agg: (agg._block.cipher.get_prp_seed(),
                                   agg._block.cipher.masking_scheme))
    seed, scheme = res["guest"][1]
    assert scheme == ("single" if mask == "dynamic" else "double")
    blocks, sps = [], []
    for i in range(N_CLIENTS):
        c = FlasheCipher(20, device="cpu")
        c.idx = i
        c.set_num_clients(N_CLIENTS)
        c.generate_prp_seed(assigned_seed=seed)
        q = QuantizingClient(20, False, 16, True, True, seed=i, device="cpu")
        q.set_num_clients(N_CLIENTS)
        q.set_codec(codec)
        blocks.append(ClientBlock(c, q))
        sps.append(Sparsifier(codec, 0.3))
    before = torch.from_numpy(base)
    sels = [client_select(b, sp, torch.from_numpy(f), before, 1.0)
            for b, sp, f in zip(blocks, sps, flats)]
    masks = [decode_locations(s.encoded) for s in sels]
    broadcast = arbiter_masking(masks, codec.total, mask, device="cpu")
    ups = [client_upload_sparse(b, s, broadcast, 0)
           for b, s in zip(blocks, sels)]
    agg = arbiter_reduce([u.lanes for u in ups], 20, masks=masks,
                         total=codec.total)
    for (outs, _), b in zip(_clients(res), blocks):
        new = client_download(b, agg, [0, 1, 2], codec.total, 3.0, 1.0,
                              before=before)
        assert np.array_equal(outs[0], new.numpy())
    assert np.max(np.abs(res["guest"][0][0] - base)) < 0.2


def test_paillier_dense_round():
    """512-bit key from the guest, wrapped to the hosts; 500-bit lanes of
    27 packed fields, 4 ciphertexts a client."""
    flats, codec = _dense_inputs()
    args = _args(key_length=512, quantize=dict(Q, int_bits=500, batch=True))
    res = _roles("paillier", args, flats, codec)
    g = res["guest"][0]
    for outs in _clients(res):
        np.testing.assert_array_equal(outs[0], g)
    assert np.max(np.abs(g - np.mean(flats, axis=0))) < TOL


def test_paillier_sparse_round_equals_the_cores():
    """Sparsity 0.3 at int_bits 20 with the guest's key (256 bits, as
    tests/test_torch_paillier.py: the sparse round needs no wide lanes).
    Each upload ends in an encrypted quantized zero that the arbiter
    densifies with.  The federated round equals, bit for bit, the cores'
    sparse round keyed by make_session with the session's keypair and the
    same quantizer seeds (0 for the guest, 1 for each host); the decrypted
    aggregate equals the sum of the clients' densified quantized values;
    and the new model lies within one quantization step of the last global
    model plus the mean of the selected deltas."""
    base, flats, codec = _sparse_inputs(1)
    args = _args(key_length=256)
    res = _roles("paillier", args, flats, codec, sparsity=0.3, before=base,
                 keep=lambda agg: agg._block.cipher.get_key_pair())
    clients, arbiter = paillier_blocks.make_session(
        args, N_CLIENTS, device="cpu", keypair=res["guest"][1])
    plain = []
    for b in clients:
        b.set_codec(codec)
        encrypt = b.encrypt
        b.encrypt = lambda q, _enc=encrypt: (plain.append(q.clone()),
                                             _enc(q))[1]
    before = torch.from_numpy(base)
    sels = [client_select(b, Sparsifier(codec, 0.3), torch.from_numpy(f),
                          before, 1.0) for b, f in zip(clients, flats)]
    ups = [client_upload_sparse(b, s, None, 0) for b, s in zip(clients, sels)]
    masks = [decode_locations(s.encoded) for s in sels]
    agg = arbiter_reduce([u.lanes for u in ups], block=arbiter, masks=masks,
                         total=codec.total)
    want_sum = np.zeros(codec.total, np.int64)
    want_delta = np.zeros(codec.total, np.float64)
    for q, s in zip(plain, sels):
        dense = np.full(codec.total, int(q[-1]), np.int64)
        loc = s.result.locations.numpy()
        dense[loc] = q[:-1].numpy()
        want_sum += dense
        want_delta[loc] += s.result.values.numpy()
    np.testing.assert_array_equal(
        clients[0].decrypt(agg, codec.total).numpy(), want_sum)
    step = 2 * float(np.max(clients[0].quantizer.alpha)) / ((1 << 16) - 1)
    for (outs, _), b in zip(_clients(res), clients):
        new = client_download(b, agg, None, codec.total, 3.0, 1.0,
                              before=before)
        np.testing.assert_array_equal(outs[0], new.numpy())
    g = res["guest"][0][0]
    assert np.max(np.abs(g - (base + want_delta / N_CLIENTS))) < step


def test_host_crash_survivors_decrypt():
    """Host 1 takes part in the session setup, then dies: the arbiter
    drops it at the deadline and the survivors decrypt their 2-party
    FedAvg."""
    rng = np.random.RandomState(0)
    template = {"w": rng.randn(11, 3).astype(np.float32) * 0.1}
    codec = _codec(template)
    flats = [template["w"].ravel() + 0.02 * rng.randn(33).astype(np.float32)
             for _ in range(N_CLIENTS)]
    args = _args(upload_timeout_s=2.0)

    def client(agg, flat):
        agg.set_codec(codec)
        return agg.aggregate_then_get(torch.from_numpy(flat), iter_index=0,
                                      degree=1.0, suffix=(0,)).numpy()

    def guest(trv):
        return client(aggregator.with_role("guest", trv, 1.0, "flashe",
                                           args, device="cpu"), flats[0])

    def host(trv, h):
        agg = aggregator.with_role("host", trv, 1.0, "flashe", args,
                                   device="cpu")
        return "crashed" if h == 1 else client(agg, flats[1 + h])

    def arbiter(trv):
        agg = aggregator.with_role("arbiter", trv, 1.0, "flashe", args,
                                   device="cpu")
        agg.aggregate_and_broadcast(iter_index=0, suffix=(0,))
        return list(agg.dropped_hosts)

    res = run_roles(N_HOSTS, guest, host, arbiter, timeout=60)
    assert res["arbiter"] == [1]
    want = np.mean(flats[:2], axis=0)
    assert np.max(np.abs(res["guest"] - want)) < TOL
    np.testing.assert_array_equal(res["guest"], res["host0"])


@pytest.mark.parametrize("num_partitions", [1, 2])
def test_slow_host_dropped_notified_rejoins(num_partitions):
    """Host 1 sleeps through round 0's deadline (alive), is dropped, still
    receives the survivors' aggregate in the dropped frame (keeping its
    quantizer statistics in step) and contributes again at round 1.  The
    survivors sleep as long before round 1 (standing in for local
    training), so that the arbiter's round-1 window opens after the slow
    host has woken.  Under two partitions the host misses its partition-0
    slot, is answered on upload_result and drains both agg_model parts."""
    timeout_s, sleep_s = 2.0, 3.0
    rng = np.random.RandomState(42)
    template = {"w": rng.randn(11, 3).astype(np.float32) * 0.1}
    codec = _codec(template)
    base = template["w"].ravel()
    deltas = [0.02 * rng.randn(33).astype(np.float32)
              for _ in range(N_CLIENTS)]
    args = _args(num_partitions=num_partitions, upload_timeout_s=timeout_s)

    def client_rounds(agg, delta, slow=False):
        agg.set_codec(codec)
        flat, outs = base.copy(), []
        for r in range(2):
            if (r == 0) == slow:
                time.sleep(sleep_s)
            out = agg.aggregate_then_get(torch.from_numpy(flat + delta),
                                         iter_index=r, degree=1.0,
                                         suffix=(r,))
            flat = out.numpy()
            outs.append((flat, agg.was_dropped))
        return outs

    def guest(trv):
        return client_rounds(aggregator.with_role(
            "guest", trv, 1.0, "flashe", args, device="cpu"), deltas[0])

    def host(trv, h):
        return client_rounds(aggregator.with_role(
            "host", trv, 1.0, "flashe", args, device="cpu"), deltas[1 + h],
            slow=h == 1)

    def arbiter(trv):
        agg = aggregator.with_role("arbiter", trv, 1.0, "flashe", args,
                                   device="cpu")
        dropped = []
        for r in range(2):
            agg.aggregate_and_broadcast(iter_index=r, suffix=(r,))
            dropped.append(list(agg.dropped_hosts))
        return dropped

    res = run_roles(N_HOSTS, guest, host, arbiter, timeout=60)
    assert res["arbiter"] == [[1], []]
    (g0, g0_dropped), (s0, s0_dropped) = res["guest"][0], res["host1"][0]
    assert s0_dropped and not g0_dropped
    assert np.max(np.abs(g0 - (base + np.mean(deltas[:2], axis=0)))) < TOL
    np.testing.assert_array_equal(s0, g0)
    global1 = g0 + np.mean(deltas, axis=0)
    for role in ("guest", "host0", "host1"):
        flat1, dropped1 = res[role][1]
        assert not dropped1
        np.testing.assert_array_equal(flat1, res["guest"][1][0])
    assert np.max(np.abs(res["guest"][1][0] - global1)) < 2 * TOL


@pytest.mark.parametrize("int_bits", [20, 120])
def test_payload_pack_bytes_match_jax(int_bits):
    rng = np.random.default_rng(int_bits)
    n, nl = 37, (int_bits + 31) // 32
    lanes = rng.integers(0, 1 << 32, (n, nl), dtype=np.uint32)
    lanes[:, -1] &= np.uint32((1 << (int_bits - 32 * (nl - 1))) - 1)
    lanes = lanes[:, 0] if nl == 1 else lanes
    port = ModelPayload(torch.from_numpy(lanes.view(np.int32)), n, int_bits,
                        degree=2.0, idx_list=[0])
    ref = JPayload(jnp.asarray(lanes), n, int_bits, degree=2.0, idx_list=[0])
    packed = port.pack()
    assert packed.packed == ref.pack().packed
    assert packed.wire_bytes() == ref.pack().wire_bytes() == (
        n * int_bits + 7) // 8
    assert port.wire_bytes() == ref.wire_bytes()
    back = packed.unpack()
    assert back.lanes.dtype == np.uint32
    np.testing.assert_array_equal(back.lanes, lanes)
    # partitions split as np.array_split does, on the device or the host
    for src in (port, back):
        parts = partition_lanes(src, 3)
        assert [p.n_lanes for p in parts] == [13, 12, 12]
        merged = merge_lane_parts([p.pack() for p in parts])
        np.testing.assert_array_equal(merged.lanes, lanes)


def test_payload_pickles_lanes_from_the_host():
    """A pickled payload (the TCP transport) carries host numpy, whether
    packed or not; in memory it keeps the tensor."""
    lanes = torch.tensor([1, -1, 7], dtype=torch.int32)
    p = ModelPayload(lanes, 3, 20, degree=1.0)
    assert p.lanes is lanes
    back = pickle.loads(pickle.dumps(p))
    assert isinstance(back.lanes, np.ndarray) and back.lanes.dtype == np.uint32
    np.testing.assert_array_equal(back.lanes, [1, 0xFFFFFFFF, 7])
    assert torch.equal(aggregator.to_device(back.lanes, torch.device("cpu")),
                       lanes)
    f = ModelPayload(torch.ones(2), 2, None)
    assert pickle.loads(pickle.dumps(f)).lanes.dtype == np.float32
    assert f.wire_bytes() == 8


# the general-HE baselines at small rings, with the tolerances of
# tests/test_protocol_baselines.py: BFV quantizes (a few quantization
# steps), CKKS's slots carry noise / scale ~1e-11 and the additive pads
# float32 rounding
_HE_ROUNDS = {
    "bfv": (_args(p=1964769281, m=64), 5e-4),
    "bfv-partitioned": (_args(p=1964769281, m=64, num_partitions=2), 5e-4),
    "ckks": ({"poly_modulus_degree": 64, "mode": "parallel",
              "num_partitions": 1}, 1e-4),
    "additive": ({"mode": "parallel", "num_partitions": 1}, 1e-4),
}


@pytest.mark.parametrize("case", list(_HE_ROUNDS))
def test_general_he_round_matches_fedavg(case):
    """Two rounds of guest + 2 hosts through with_role / run_roles, every
    role's session setup included (BFV: the guest's keys, its secret
    wrapped to the hosts, its public key forwarded by the arbiter; CKKS:
    the wrapped secret; additive: the pairwise DH secrets): every client
    holds the same model, within the scheme's tolerance of FedAvg."""
    scheme = case.split("-")[0]
    args, atol = _HE_ROUNDS[case]
    flats, codec = _dense_inputs()
    keep = {"bfv": lambda agg: agg._block.cipher.public_parts(),
            "ckks": lambda agg: agg._block.cipher.serialize_secret(),
            "additive": lambda agg: len(agg._block.cipher._pads)}[scheme]
    res = _roles(scheme, args, flats, codec, rounds=2, keep=keep)
    want = np.mean(flats, axis=0)
    g = res["guest"][0]
    for outs, kept in _clients(res):
        assert np.max(np.abs(outs[0] - want)) < atol
        for r in range(2):
            np.testing.assert_array_equal(outs[r], g[r])
        if scheme == "bfv":
            for mine, guest in zip(kept, res["guest"][1]):
                np.testing.assert_array_equal(mine, guest)
        elif scheme == "ckks":
            assert kept == res["guest"][1]
        else:
            assert kept == N_HOSTS  # a pad with every other client
    assert res["arbiter"] == [[], []]


def test_bfv_round_sums_the_quantized_uploads():
    """The BFV aggregate that every client decrypts equals the clients'
    summed quantized values (mod t, which they never reach)."""
    flats, codec = _dense_inputs()
    args, _ = _HE_ROUNDS["bfv"]

    def keep(agg):
        return agg._block.last

    def record(agg):
        block = agg._block
        quantize, decrypt = block.quantize, block.decrypt

        def recorded_quantize(flat, uniforms=None):
            block.q = quantize(flat, uniforms=uniforms)
            return block.q

        def recorded_decrypt(cts, count=None):
            block.last = (block.q, decrypt(cts, count))
            return block.last[1]

        block.quantize, block.decrypt = recorded_quantize, recorded_decrypt
        return agg

    real = aggregator.with_role

    def with_role(role, *a, **kw):
        agg = real(role, *a, **kw)
        return agg if role == "arbiter" else record(agg)

    aggregator.with_role = with_role
    try:
        res = _roles("bfv", args, flats, codec, keep=keep)
    finally:
        aggregator.with_role = real
    qs = [kept[0] for _, kept in _clients(res)]
    want = sum(q.long() for q in qs)
    assert int(want.max()) < (1 << 20)
    for _, (_, dec) in _clients(res):
        assert dec.dtype == torch.int32 and dec.shape == want.shape
        assert torch.equal(dec.long(), want)


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="unknown secure_aggregate"):
        aggregator._make_block("guest", "rsa", {}, None, device="cpu")


def test_payload_of_ring_ciphertexts():
    """A BFV or CKKS upload is a (B, 2, k, N) int32 tensor: on the host it
    is the same uint32 array, to_device gives the tensor back, it splits
    and joins along its B ciphertexts as the JAX payload does (in memory
    and pickled), and its wire bytes are its bytes."""
    rng = np.random.default_rng(3)
    cts = rng.integers(0, 1 << 31, (5, 2, 3, 64), dtype=np.uint32)
    cts[0, 0, 0, :2] = (0x80000001, 0xFFFFFFFF)  # negative as int32
    port = ModelPayload(torch.from_numpy(cts.view(np.int32)), 300, None,
                        degree=1.0)
    on_host = host_lanes(port.lanes)
    assert on_host.dtype == np.uint32 and on_host.shape == cts.shape
    np.testing.assert_array_equal(on_host, cts)
    back = aggregator.to_device(on_host, torch.device("cpu"))
    assert back.dtype == torch.int32 and torch.equal(back, port.lanes)
    ref = JPayload(jnp.asarray(cts), 300, None, degree=1.0)
    assert port.wire_bytes() == ref.wire_bytes() == cts.nbytes
    assert port.pack() is port and port.n_lanes == ref.n_lanes == 5
    parts = partition_lanes(port, 2)
    ref_parts = jpartition_lanes(ref, 2)
    assert parts[0].shape_list == ref_parts[0].shape_list == [3, 2]
    assert parts[0].n_elements == 300 and parts[1].n_elements == 0
    for mine, theirs in zip(parts, ref_parts):
        np.testing.assert_array_equal(host_lanes(mine.lanes),
                                      np.asarray(theirs.lanes))
    assert torch.equal(merge_lane_parts(parts).lanes, port.lanes)
    wired = merge_lane_parts([pickle.loads(pickle.dumps(p)) for p in parts])
    np.testing.assert_array_equal(wired.lanes, cts)


def test_local_lane_shards_raise():
    """`local_lane_shards` is ported (the counterpart of
    tests/test_party_mesh.py::test_protocol_with_multi_device_parties_
    matches_single): two rounds where every client's cipher splits its
    lanes over 2 devices (the CPU twice) end on the single-device round's
    models, bit for bit, with the mesh installed; more shards than the
    devices given raise."""
    flats, codec = _dense_inputs()
    keep = lambda agg: agg._block.cipher._party_mesh  # noqa: E731
    sharded = _roles("flashe", _args(local_lane_shards=2), flats, codec,
                     rounds=2, keep=keep)
    single = _roles("flashe", _args(), flats, codec, rounds=2)
    for (outs, mesh), ref in zip(_clients(sharded), _clients(single)):
        assert mesh is not None and mesh.n_shards == 2
        for got, want in zip(outs, ref):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="local devices"):
        FlasheCipher(20, device="cpu").set_local_devices(3, ["cpu"] * 2)
