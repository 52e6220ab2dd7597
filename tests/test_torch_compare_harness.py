"""PyTorch port: the scheme-comparison harness
(flashe_tpu_torch/tools/compare_schemes.py) against the JAX harness
(examples/compare_schemes.py, loaded by path: its module level imports no
jax).

- `wire_bytes` equals the JAX harness's byte expressions, evaluated on the
  JAX package's own ciphers and lanes; at full width the six figures of
  docs/COMPARISON.md.
- `row` and `claims` equal what the JAX harness's main writes for the same
  measurements.
- A `--cpu --params 2048` run of all six rows is correct with exact wire
  bytes (the Paillier row at a 256-bit key through measure_scheme's
  key_bits: the plain Montgomery product at 2048 bits costs minutes here).
- The FLASHE check is real: a corrupted aggregate fails it.
- Without --cpu the harness asks for the card.
"""

from __future__ import annotations

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.crypto.bfv import BFVCipher as JBFVCipher
from flashe_tpu.crypto.ckks import CKKSCipher as JCKKSCipher
from flashe_tpu.ops import quantize as jqops
from flashe_tpu_torch.tools import compare_schemes as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_KEY = 256


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_compare_schemes", os.path.join(REPO, "examples",
                                            "compare_schemes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_q_bits():
    return {"bfv+batch": JBFVCipher(1964769281, 8192, flagBatching=True,
                                    seed=0).q.bit_length(),
            "ckks+batch": JCKKSCipher(8192, global_scale=2.0 ** 40,
                                      seed=0).q.bit_length()}


def _jax_bytes(scheme, n, q_bits):
    """The JAX harness's expressions (examples/compare_schemes.py:113-186)
    on the JAX package's objects."""
    if scheme == "plain":
        return 4 * n
    if scheme in ("flashe", "flashe+sparse"):
        eff_n = n if scheme == "flashe" else max(1, n // 10)
        nbytes = eff_n * 20 // 8
        if scheme == "flashe+sparse":
            nbytes += eff_n * 21 // 8
        return nbytes
    if scheme == "paillier+batch":
        packed = jqops.batch_lanes(jnp.zeros(n, jnp.uint32), 2048, 16, 4)
        return packed.shape[0] * (2 * 2048) // 8
    n_ct = -(-n // (8192 if scheme == "bfv+batch" else 4096))
    return n_ct * 2 * 8192 * ((q_bits[scheme] + 7) // 8)


@pytest.mark.parametrize("n", [1, 2048, 20_000, 1_206_590])
def test_wire_bytes_equal_the_jax_formulas(n, jax_q_bits):
    for scheme in cs.SCHEMES:
        q_bits = jax_q_bits.get(scheme)
        assert cs.wire_bytes(scheme, n, q_bits=q_bits) == _jax_bytes(
            scheme, n, jax_q_bits), scheme


def test_full_width_wire_figures():
    """docs/COMPARISON.md's wire MB a client at 1,206,590 parameters, with
    the port's own ciphers' moduli."""
    from flashe_tpu_torch.crypto.bfv import BFVCipher
    from flashe_tpu_torch.crypto.ckks import CKKSCipher

    q_bits = {"bfv+batch": BFVCipher(cs.BFV_T, cs.BFV_N, flagBatching=True,
                                     device="cpu").q.bit_length(),
              "ckks+batch": CKKSCipher(cs.CKKS_N, device="cpu"
                                       ).q.bit_length()}
    want = {"plain": 9.653, "flashe": 6.033, "flashe+sparse": 1.237,
            "paillier+batch": 12.114, "bfv+batch": 111.542,
            "ckks+batch": 222.331}
    got = {s: round(2 * cs.wire_bytes(s, 1_206_590,
                                      q_bits=q_bits.get(s)) / 1e6, 3)
           for s in cs.SCHEMES}
    assert got == want
    assert cs.paillier_lanes(1_206_590) == 11_830
    assert -(-1_206_590 // cs.BFV_N) == 148
    assert -(-1_206_590 // (cs.CKKS_N // 2)) == 295


MEASUREMENTS = [
    {"plain": (0.0, 0.0, 4 * 5000, True),
     "flashe": (0.1029, 0.0525, 12_500, True),
     "flashe+sparse": (0.101, 0.0583, 2562, True),
     "paillier+batch": (15.2206, 0.5791, 25_088, True),
     "bfv+batch": (1.3802, 0.0496, 376_832, True),
     "ckks+batch": (0.8575, 0.0494, 753_664, False)},
    {"plain": (0.0, 0.0, 4_826_360, True),
     "flashe": (0.0123456, 0.00098765, 3_016_475, True),
     "flashe+sparse": (0.0031, 0.0011, 618_377, True),
     "paillier+batch": (3.3, 0.0677, 6_056_960, True),
     "bfv+batch": (0.4, 0.01, 55_771_136, True),
     "ckks+batch": (0.25, 0.02, 111_165_440, True)},
]


@pytest.mark.parametrize("case", range(len(MEASUREMENTS)))
def test_rows_and_claims_equal_the_jax_harness(case, tmp_path):
    canned = {s: {"client_crypto_s": c, "server_add_s": a, "up_bytes": b,
                  "down_bytes": b, "correct": ok}
              for s, (c, a, b, ok) in MEASUREMENTS[case].items()}
    jax_mod = _jax_harness()
    jax_mod.measure_scheme = lambda scheme, n, rng: dict(canned[scheme])
    out = tmp_path / "jax.json"
    args = ["--cpu", "--train-s", "1.337", "--bandwidth-mbps", "37.5",
            "--rounds", "321", "--out", str(out)]
    assert jax_mod.main(args) == 0
    ref = json.loads(out.read_text())
    rows = [cs.row(s, canned[s], 1.337, 37.5, 321) for s in cs.SCHEMES]
    assert rows == ref["rows"]
    assert cs.claims(rows) == ref["claims"]
    claimed = dict(ref["reference_claims"])
    assert claimed.pop("source").endswith("README.md:21-27")
    assert {k: v for k, v in cs.REFERENCE_CLAIMS.items()
            if k != "source"} == claimed
    for sub in (["plain", "flashe"], ["flashe+sparse", "bfv+batch"]):
        part = [r for r in rows if r["scheme"] in sub]
        jax_mod.main(args + ["--schemes", ",".join(sub)])
        assert cs.claims(part) == json.loads(out.read_text())["claims"]


def test_cpu_run_of_all_six_rows(tmp_path, monkeypatch):
    measure = cs.measure_scheme
    monkeypatch.setattr(cs, "measure_scheme", lambda s, n, rng, dev: measure(
        s, n, rng, dev, key_bits=SMALL_KEY))
    out = tmp_path / "port.json"
    assert cs.main(["--cpu", "--params", "2048", "--train-s", "1.0",
                    "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["config"]["platform"] == "cpu"
    assert doc["config"]["card"] is None
    rows = {r["scheme"]: r for r in doc["rows"]}
    assert list(rows) == list(cs.SCHEMES)
    assert all(r["correct"] is True for r in rows.values())
    q_bits = 180  # both HE ciphers' q at N 8192 (6 primes of 30 bits)
    for s, r in rows.items():
        nbytes = cs.wire_bytes(s, 2048, SMALL_KEY, q_bits)
        assert r["wire_mb_per_client"] == round(2 * nbytes / 1e6, 3), s
        assert r["launches"] == {}  # the plain versions, on the CPU
    assert doc["claims"] == cs.claims(doc["rows"])
    assert rows["flashe"]["client_crypto_s"] > 0


def test_flashe_check_is_real():
    """Ten clients' decrypted sum equals the sum of their q; one flipped
    bit in one lane of the aggregate fails the check."""
    assert cs.check_flashe_sum(1000, "cpu")

    def corrupt(agg):
        agg = agg.clone()
        agg[417] ^= 1 << 7
        return agg

    assert not cs.check_flashe_sum(1000, "cpu", tamper=corrupt)
    assert not cs.check_flashe_sum(1000, "cpu", tamper=lambda a: a.roll(1))


def test_measure_train_step_on_the_cpu():
    assert 0 < cs.measure_train_step(1, batch_size=16, device="cpu") < 60


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.main(["--params", "16", "--train-s", "1.0",
                 "--schemes", "plain"])


def test_docs_go_to_a_file_of_their_own(tmp_path, monkeypatch, capsys):
    assert os.path.basename(cs.DOCS) == "COMPARISON_TORCH.md"
    assert os.path.dirname(cs.DOCS) == os.path.join(REPO, "docs")
    path = tmp_path / "cmp.md"
    monkeypatch.setattr(cs, "DOCS", str(path))
    assert cs.main(["--cpu", "--params", "64", "--train-s", "1.0",
                    "--schemes", "plain,flashe,flashe+sparse",
                    "--write-docs"]) == 0
    doc = json.loads(capsys.readouterr().out)
    text = path.read_text()
    assert "platform: cpu" in text
    assert "| flashe | " in text and "overhead vs plaintext" in text
    assert doc["rows"][1]["correct"] is True
