"""PyTorch port: the benchmark harness (flashe_tpu_torch/tools/bench.py).

On the CPU at small sizes, passed as arguments (the command line keeps
bench.py's defaults): the numpy lane packers bit for bit against the JAX
package's; the headline round's ciphertexts against the JAX package's mask
streams for the same key, its decrypt and its guard; each mode that runs on
the CPU printing bench.py's metric name and keys; table2's byte columns
against bench.py's formulas on the JAX package's objects; the roofline
mode's refusal of the CPU; the ceiling kernels' plain versions against
bench.py's chain; the mask bound moved from chip_smoke.py to
tools/roofline.py, with chip_smoke.py's numbers.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.crypto.bfv import BFVCipher as JBFV
from flashe_tpu.crypto.ckks import CKKSCipher as JCKKS
from flashe_tpu.ops import aes as jaes
from flashe_tpu.ops import masks as jmasks
from flashe_tpu.ops import pack as jpack
from flashe_tpu.ops import quantize as jquant
from flashe_tpu_torch.crypto.paillier import PaillierKeypair
from flashe_tpu_torch.ops import quantize as pquant
from flashe_tpu_torch.tools import bench, ceiling, roofline, schemes, timing

CPU = torch.device("cpu")
CARD = roofline.Card("H100", "700.00 W", 1980.0, 132)
BENCH_ROW_KEYS = {"algorithm", "elements", "plaintext_bytes",
                  "ciphertext_bytes", "inflation_x", "encrypt_s", "add10_s",
                  "decrypt_s", "encrypt_amortized_s", "add10_amortized_s",
                  "decrypt_amortized_s", "correct"}


@pytest.fixture(scope="module")
def small_key():
    """A 64-bit Paillier key: n^2 of 128 bits, three 20-bit fields a
    lane, so the plain Montgomery chains stay short on the CPU."""
    return PaillierKeypair.generate_keypair(64)


# -- the numpy packers ----------------------------------------------------

@pytest.mark.parametrize("int_bits,n", [
    (20, 7), (32, 9), (64, 7), (120, 13), (2000, 205), (2048, 1000),
    (2048, 102), (64, 2)])
def test_numpy_packers_are_the_jax_packages(int_bits, n):
    """batch_lanes_np / unbatch_lanes_np bit for bit against the JAX
    package's, n a multiple of the fields a lane or not."""
    q = np.random.RandomState(n).randint(0, 1 << 20, n).astype(np.uint32)
    got = pquant.batch_lanes_np(q, int_bits, 16, 4)
    want = jquant.batch_lanes_np(q, int_bits, 16, 4)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    back = pquant.unbatch_lanes_np(got, n, int_bits, 16, 4)
    assert np.array_equal(back, jquant.unbatch_lanes_np(want, n, int_bits,
                                                       16, 4))
    assert np.array_equal(back, q)
    # and the torch packer's layout
    t = pquant.batch_lanes(torch.from_numpy(q.view(np.int32)), int_bits, 16,
                           4)
    assert np.array_equal(t.numpy().view(np.uint32), got)


# -- the headline round ---------------------------------------------------

def test_headline_round_is_the_jax_packages_masks():
    """At 4,096 lanes: each client's ciphertext is (q_i + a_i - a_{i+1})
    mod 2^20 with the JAX package's streams of bench.py's key, and the
    decrypt is sum(q) mod 2^20."""
    n, it, m = 4096, 3, bench.M
    q = bench.make_q(CPU, schemes.N_CLIENTS, n)
    assert q.dtype == torch.int32 and int(q.min()) >= 0 \
        and int(q.max()) < 1 << 16
    cts, agg, out = bench.flashe_round(q, bench.round_keys(CPU), it, m)
    jrk = jnp.asarray(jaes.key_schedule(schemes.FLASHE_SEED).astype(
        np.int32))
    # the byte-plane AES: the same streams as the bitsliced one, and far
    # quicker to compile on the CPU
    stream = jax.jit(lambda i: jmasks.prp_lane_stream(jrk, it, i, n, m,
                                                      impl="byteplane"))
    a = [np.asarray(stream(jnp.int32(i))).astype(np.int64)
         for i in range(schemes.N_CLIENTS + 1)]
    qn = q.numpy().astype(np.int64)
    for i, ct in enumerate(cts):
        want = (qn[i] + a[i] - a[i + 1]) % (1 << m)
        assert np.array_equal(ct.numpy().astype(np.int64), want)
    assert np.array_equal(out.numpy().astype(np.int64),
                          qn.sum(0) % (1 << m))
    assert np.array_equal(agg.numpy().astype(np.int64),
                          (qn.sum(0) + a[0] - a[schemes.N_CLIENTS])
                          % (1 << m))


def test_guard_raises_on_a_tampered_ciphertext():
    q = bench.make_q(CPU, schemes.N_CLIENTS, 4096, seed=1)
    rk = bench.round_keys(CPU)

    def tamper(cts):
        cts[3] = cts[3].clone()
        cts[3][17] ^= 1
        return cts

    with pytest.raises(bench.RoundMismatch, match="at 1 lanes"):
        bench.flashe_round(q, rk, 0, bench.M, tamper=tamper)


def test_headline_prints_bench_pys_line(capsys):
    assert bench.main(["--cpu", "--elements", "4096", "--reps", "1",
                       "--stats", "3", "--verbose"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "flashe_enc_agg_dec_elements_per_sec_per_chip"
    assert out["unit"] == "elements/s" and out["value"] > 0
    assert out["vs_baseline"] == round(
        out["value"] / bench.BASELINE_ELEMENTS_PER_SEC, 2)
    assert round(bench.BASELINE_ELEMENTS_PER_SEC) == 21540
    s = out["spread"]
    assert s["n_samples"] == 3 and s["min"] <= out["value"] <= s["max"]
    d = out["detail"]
    assert {"elements", "clients", "int_bits", "t_encrypt_all_clients_s",
            "t_aggregate_s", "t_decrypt_s", "device"} <= set(d)
    assert (d["elements"], d["clients"], d["int_bits"]) == (4096, 10, 20)
    # the CPU run names its platform, has no card and no graph, and its
    # plain versions launch no kernel
    assert d["platform"] == "cpu" and d["card"] is None
    assert d["graph"] is None and d["launches"] == {}


# -- the other modes on the CPU --------------------------------------------

MODE_CASES = {
    "roundtrip1m": (lambda key: bench.run_roundtrip1m(CPU, 4096, reps=1),
                    "flashe64_roundtrip_elements_per_sec", "elements/s"),
    "precompute": (lambda key: bench.run_precompute(CPU, 5000, reps=1),
                   "flashe_online_round_seconds_10clients_10m", "s"),
    "paillier": (lambda key: bench.run_paillier(CPU, 8, keypair=key,
                                                reps=1),
                 "paillier2048_modexp_ciphertexts_per_sec", "ct/s"),
    "model100m": (lambda key: bench.run_model100m(CPU, 5000),
                  "flashe_100m_full_round_elements_per_sec", "elements/s"),
    "party": (lambda key: bench.run_party(CPU, ["cpu", "cpu"], 4096,
                                          party_batch=4, keypair=key,
                                          reps=1),
              "party_shard_scaling", "x vs 1 device (flashe)"),
}


@pytest.mark.parametrize("mode", sorted(MODE_CASES))
def test_mode_prints_bench_pys_metric(mode, small_key):
    run, metric, unit = MODE_CASES[mode]
    out = run(small_key)
    json.dumps(out)  # one JSON line
    assert out["metric"] == metric and out["unit"] == unit
    assert out["value"] > 0 and isinstance(out["vs_baseline"], float)
    assert out["detail"]["platform"] == "cpu"
    assert out["detail"]["launches"] == {}
    if mode == "model100m":
        assert {"round_seconds", "clients"} <= set(out["detail"])
    if mode == "party":
        assert out["detail"]["shard_counts"] == [1, 2]
        assert set(out["speedup_x"]) == set(out["rows"]) == {
            "flashe", "paillier", "bfv", "ckks"}
        for rows in out["rows"].values():
            assert [r["shards"] for r in rows] == [1, 2]
            assert [r["repeated_device"] for r in rows] == [False, True]
            assert all(r["correct"] for r in rows)


def test_table2_rows_are_bench_pys(small_key):
    """Every row bench.py prints, in its order, correct, with bench.py's
    keys, and its byte columns equal to bench.py's formulas on the JAX
    package's objects (pack_lanes, batch_lanes_np, the BFV and CKKS N and
    q)."""
    sizes = (16, 40)
    out = bench.run_table2(CPU, sizes=sizes, keypair=small_key, bfv_sub=2,
                           ckks_sub=1)
    assert out["metric"] == "table2" and out["unit"] == "see rows"
    rows = out["rows"]
    assert out["value"] == len(rows)
    assert [r["algorithm"] for r in rows] == (
        ["flashe"] * 2 + ["paillier+batch"] * 2 + ["paillier",
                                                   "paillier (extrapolated)"]
        + ["bfv+batch"] * 2 + ["bfv (extrapolated)"] + ["ckks+batch"] * 2
        + ["ckks (extrapolated)"])
    assert all(r["correct"] is True for r in rows)
    assert all(BENCH_ROW_KEYS <= set(r) for r in rows)
    key_bits = small_key[0].n.bit_length()
    ct_per = 2 * key_bits // 8
    bfv = JBFV(schemes.BFV_T, 8192, flagBatching=True, seed=0)
    bfv_nb = JBFV(schemes.BFV_T, 2048, flagBatching=False, seed=0)
    ck = JCKKS(8192, global_scale=2.0 ** 40, seed=0)

    def ct_bytes(c):
        return 2 * c.N * ((c.q.bit_length() + 7) // 8)

    for r in rows:
        n, alg = r["elements"], r["algorithm"]
        want = {
            "flashe": len(jpack.pack_lanes(np.zeros(n, np.uint32), 20)),
            "paillier+batch": len(jquant.batch_lanes_np(
                np.zeros(n, np.uint32), key_bits, 16, 4)) * ct_per,
            "paillier": n * ct_per, "paillier (extrapolated)": n * ct_per,
            "bfv+batch": -(-n // bfv.N) * ct_bytes(bfv),
            "bfv (extrapolated)": n * ct_bytes(bfv_nb),
            "ckks+batch": -(-n // (ck.N // 2)) * ct_bytes(ck),
            "ckks (extrapolated)": n * ct_bytes(ck),
        }[alg]
        assert r["ciphertext_bytes"] == want, alg
        assert r["plaintext_bytes"] == n * 20 // 8
        assert r["inflation_x"] == round(want / (n * 20 / 8), 2)
        assert (r["calls"] is None) == (alg == "paillier (extrapolated)")
    # the extrapolated Paillier row is the measured one scaled by 40 / 16
    meas, extra = rows[4], rows[5]
    assert extra["encrypt_s"] == pytest.approx(meas["encrypt_s"] * 40 / 16)
    assert out["detail"]["launches"] == {}


CELLS = {
    "flashe": lambda key, rng: schemes.flashe_cell(
        rng.randint(0, 1 << 16, (schemes.N_CLIENTS, 50)), CPU),
    "paillier+batch": lambda key, rng: schemes.paillier_batch_cell(
        schemes.paillier_cipher(CPU, keypair=key), rng.randint(0, 1 << 16,
                                                               7)),
    "paillier": lambda key, rng: schemes.paillier_cell(
        schemes.paillier_cipher(CPU, keypair=key), rng.randint(0, 1 << 16,
                                                               3)),
    "bfv": lambda key, rng: schemes.bfv_cell(
        schemes.bfv_cipher(CPU, batching=False), rng.randint(0, 1 << 16, 5)),
    "ckks": lambda key, rng: schemes.ckks_cell(schemes.ckks_cipher(CPU),
                                               rng.randn(3), batch=False),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_checks_the_decrypt(name, small_key):
    """Each scheme's cell, which table2 and the paper's comparison both
    run: its encrypt, add of 10 and decrypt pass its check, and the check
    fails on a decrypt moved in one value."""
    cell = CELLS[name](small_key, np.random.RandomState(5))
    calls = []

    def measure(f):
        calls.append(f)
        return f(), len(calls)

    stats, ct, ok = schemes.run_cell(cell, measure)
    assert ok and stats == ((1,), (2,), (3,)) and len(ct) > 0
    out = cell.decrypt(cell.add10(ct))
    assert cell.check(out)
    if isinstance(out, torch.Tensor):
        moved = out.clone()
        moved[1] += 1
    else:
        moved = np.array(out, copy=True)
        moved[1] += 1
    assert not cell.check(moved)


def test_roofline_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no CPU form"):
        bench.run_roofline(CPU)
    with pytest.raises(RuntimeError, match="no CPU form"):
        bench.main(["--cpu", "--mode", "roofline"])


@pytest.mark.parametrize("run", [
    bench.run_flashe, bench.run_roundtrip1m, bench.run_precompute,
    bench.run_paillier, bench.run_model100m, bench.run_table2,
    bench.run_roofline, bench.run_multihost, bench.run_party])
def test_modes_ask_for_the_card_by_default(run):
    """Every mode defaults to the card and raises where torch sees none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()


def test_bench_rounds_takes_the_childrens_lines():
    outs = ["process 0: backend gloo\nBENCH process=0 round_s=0.250000 "
            "elements=8 clients=2\nOK process=0 launches="
            '{"double":40,"single":0,"limbs":0,"scatter":0}\n',
            "BENCH process=1 round_s=0.500000 elements=8 clients=2\nOK "
            'process=1 launches={"double":40,"single":0,"limbs":0,'
            '"scatter":0}\n']
    assert bench.bench_rounds(outs) == ([0.25, 0.5], {"mask double": 80})


# -- the ceiling kernels' plain versions -----------------------------------

def test_int_chain_is_bench_pys_chain():
    """The plain version the card's kernel is held against: bench.py's
    chain (bench.py:906-917) in numpy uint32, its constants included."""
    consts = np.random.RandomState(7).randint(1, 1 << 31, 64,
                                              dtype=np.uint32)
    assert np.array_equal(ceiling.CHAIN_CONSTS, consts)
    x = np.arange(5000, dtype=np.uint32) * np.uint32(2654435761)
    want = x.copy()
    for c in consts:
        want = want ^ c
        want = want + (want >> np.uint32(7))
        want = want ^ (want << np.uint32(3))
    got = ceiling.int_chain(torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert ceiling.CHAIN_OPS == 64 * 5


def test_lds_chain_walks_its_table():
    """The load chains in plain python on a few elements, lanes offset."""
    x = np.random.RandomState(3).randint(0, 1 << 31, 70).astype(np.uint32)
    tbl = [(j * 2654435761 & 0xFFFFFFFF) ^ 0x5BD1E995 for j in range(1024)]
    want = []
    for i, v in enumerate(x.tolist()):
        lane4 = ((i + 33) & 31) << 2
        chains = [v ^ (0x9E3779B9 * c & 0xFFFFFFFF) for c in range(4)]
        for _ in range(64):
            chains = [tbl[((w & 0xF80) | lane4) >> 2] for w in chains]
        want.append(chains[0] ^ chains[1] ^ chains[2] ^ chains[3])
    got = ceiling.lds_chain_ref(torch.from_numpy(x.view(np.int32)), first=33)
    assert got.numpy().view(np.uint32).tolist() == want
    assert ceiling.LDS_LOADS == 256


def test_ceiling_counts_take_the_busier_integer_pipe(monkeypatch):
    """The ceiling kernels' SASS as the card's toolkit printed it: IMAD on
    the FMA pipe, the other integer opcodes on the ALU pipe; without
    cuobjdump, the source's counts."""
    from collections import Counter

    sass = {"int_chain_kernel": Counter(IMAD=67, LOP3=65, LEA=64, ULDC=36,
                                        NOP=9, IADD3=4, ISETP=2, SHF=1,
                                        LDG=1, STG=1),
            "lds_chain_kernel": Counter(LOP3=289, LDS=256, VIADD=36, STS=29,
                                        IMAD=11, ISETP=9, IADD3=6, LEA=3,
                                        SHF=1, VIMNMX=1)}
    monkeypatch.setattr(ceiling._build, "sass_opcodes", lambda name: sass)
    assert ceiling.per_element() == {"int_chain": (136, 0),
                                     "lds_chain": (344, 256)}
    monkeypatch.setattr(ceiling._build, "sass_opcodes", lambda name: None)
    assert ceiling.per_element() == {"int_chain": (320, 0),
                                     "lds_chain": (256, 256)}


def test_timing_on_the_cpu_is_the_host_clock():
    calls = []
    assert timing.host_run_s(lambda: calls.append(1), 3, CPU) >= 0
    assert timing.device_run_ms(lambda: calls.append(1), 2, CPU) >= 0
    assert len(calls) == 5


# -- the bounds moved from chip_smoke.py -----------------------------------

@pytest.mark.parametrize("args,kw,want", [
    ((1_206_590,), {}, (0.01077206152433425, "operations")),
    ((4_194_304,), {}, (0.03744533976124885, "operations")),
    ((120_655,), {"streams": 1}, (0.0005386057545148454, "operations")),
    ((201_099,), {"m": 120}, (0.01077206152433425, "operations")),
    ((120_655,), {"streams": 1, "sectors": 85_771},
     (0.0019267414925373135, "bytes")),
    ((1_048_576,), {"m": 64}, (0.028083991429445974, "operations")),
    ((100_000_000,), {}, (0.8927660621365167, "operations")),
    ((10_000_000,), {"streams": 1}, (0.04463831114172023, "operations")),
])
def test_mask_bound_keeps_chip_smokes_numbers(args, kw, want):
    """The numbers chip_smoke.py's own mask_bound gave before the move."""
    import chip_smoke

    assert roofline.mask_bound(*args, CARD, **kw) == want
    assert chip_smoke.mask_bound is roofline.mask_bound
    assert roofline.AES_TTABLE_INT_OPS == 348
    assert roofline.AES_TTABLE_LOADS == 224


def test_measured_rates_replace_the_published_ones():
    m = roofline.Card("H100", "700.00 W", 1980.0, 132, measured={
        "int32_per_s": CARD.int32_per_s / 2, "lds_per_s": CARD.lds_per_s,
        "hbm_bytes_per_s": roofline.HBM_BYTES_PER_S / 4})
    assert roofline.bound_ms(1e9, 0, m)[0] == pytest.approx(
        2 * roofline.bound_ms(1e9, 0, CARD)[0])
    assert roofline.bound_ms(0, 3.35e9, m) == (pytest.approx(4.0), "bytes")
    assert "measured" in m.describe() and "measured" not in CARD.describe()
