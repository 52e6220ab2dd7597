"""PyTorch port: the Shakespeare workload and the last helpers against the
JAX package, on the CPU.

- data/shakespeare.py against flashe_tpu.data.shakespeare on a seeded
  corpus in shakespeare_10's CSV format: equal arrays and dtypes, with and
  without `limit` (exact);
- tools/shakespeare_experiment.py against examples/shakespeare_experiment.py
  (loaded by path): gru_define's dicts equal; overhead_stats' dicts equal
  on seeded round times with 1 and 3 reps; write_docs' table rows equal,
  each written under tmp_path (docs/CONVERGENCE.md untouched);
  count_params_define equal to JAX's on the FEMNIST, GRU(512, 256) and
  GRU(64, 64) defines (1,206,590 / 654,675 / 35,539);
- the experiment: JAX's run_scheme("plain") once (embed 8, hidden 8, 3
  clients, 32 rows a shard, batch 32 — a full batch, so the shuffle cannot
  matter — 2 rounds), and the port's plain and flashe arms at the same
  settings from the JAX initial parameters (params_from_flax in place
  of the port's init_params): fed_loss,
  train_loss and eval_loss within 1e-4 absolute of the JAX plain run's;
  main --cpu end to end on a seeded corpus;
- tools/render_table2.py's rows equal to examples/render_table2.py's for
  the same row dicts (exact strings); --write-docs writes its own file;
- ops/masks.flashe_mask_pair bit for bit with the JAX one at int_bits 16,
  20 and 32; ops/pack.pack_ints_reference equal to JAX's and to the wire
  packer's bytes;
- RandomPads.rand / add_rand_pads / add_randn_pads: shapes, dtypes,
  determinism per seed, the uniform's mean and variance within 3 standard
  errors (statistical parity, as for randn).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashe_tpu.crypto.random_pads import RandomPads as JRandomPads
from flashe_tpu.data import shakespeare as jshakespeare
from flashe_tpu.nn.keras_define import count_params_define as jcount
from flashe_tpu.nn.keras_define import from_nn_define as jfrom_nn_define
from flashe_tpu.nn.models import build_model as jbuild_model
from flashe_tpu.nn.models import init_params as jinit_params
from flashe_tpu.ops import aes as jaes
from flashe_tpu.ops import masks as jmasks
from flashe_tpu.ops import pack as jpack
from flashe_tpu_torch.crypto.random_pads import RandomPads
from flashe_tpu_torch.data import shakespeare
from flashe_tpu_torch.nn.keras_define import (count_params_define,
                                              from_nn_define)
from flashe_tpu_torch.ops import aes, masks, pack
from flashe_tpu_torch.tools import render_table2 as rt
from flashe_tpu_torch.tools import shakespeare_experiment as se

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = bytes(range(11, 43))

FEMNIST_CNN = {"class_name": "Sequential", "config": {
    "name": "sequential", "layers": [
        {"class_name": "Reshape",
         "config": {"name": "reshape", "target_shape": [28, 28, 1]}},
        {"class_name": "Conv2D",
         "config": {"name": "conv2d", "filters": 32, "kernel_size": [3, 3],
                    "activation": "relu"}},
        {"class_name": "Conv2D",
         "config": {"name": "conv2d_1", "filters": 64,
                    "kernel_size": [3, 3], "activation": "relu"}},
        {"class_name": "MaxPooling2D",
         "config": {"name": "max_pooling2d", "pool_size": [2, 2]}},
        {"class_name": "Dropout", "config": {"name": "dropout",
                                             "rate": 0.25}},
        {"class_name": "Flatten", "config": {"name": "flatten"}},
        {"class_name": "Dense",
         "config": {"name": "dense", "units": 128, "activation": "relu"}},
        {"class_name": "Dropout", "config": {"name": "dropout_1",
                                             "rate": 0.5}},
        {"class_name": "Dense",
         "config": {"name": "dense_1", "units": 62,
                    "activation": "softmax"}}]}}

# the experiment's test size
EMBED, HIDDEN, CLIENTS, ROWS, BATCH, ROUNDS, LR = 8, 8, 3, 32, 32, 2, 0.01
LOSS_ATOL = 1e-4


def _load_example(name, path=None):
    """examples/<name>.py as a module (from `path` where given)."""
    path = path or os.path.join(REPO, "examples", f"{name}.py")
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def jexp():
    return _load_example("shakespeare_experiment")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shakespeare_10"))
    shakespeare.write_markov_corpus(root, n_clients=CLIENTS, rows=ROWS,
                                    seed=5)
    return root


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# -- the loader ---------------------------------------------------------------

@pytest.mark.parametrize("limit", [None, 7])
def test_loader_matches_jax(corpus, limit):
    got = shakespeare.load_clients(corpus, CLIENTS, limit)
    want = jshakespeare.load_clients(corpus, CLIENTS, limit)
    assert len(got) == len(want) == CLIENTS
    for (x, y), (jx, jy) in zip(got + [shakespeare.load_eval(corpus, limit)],
                                want + [jshakespeare.load_eval(corpus,
                                                               limit)]):
        assert x.shape == (limit or ROWS, shakespeare.SEQ_LEN)
        assert x.dtype == jx.dtype == y.dtype == jy.dtype == np.int32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(y[:, :-1], x[:, 1:])
    assert (shakespeare.VOCAB, shakespeare.SEQ_LEN) == (jshakespeare.VOCAB,
                                                        jshakespeare.SEQ_LEN)
    assert shakespeare.DEFAULT_ROOT.endswith(
        os.path.join("examples", "dataset", "shakespeare_10"))


def test_markov_corpus_is_shakespeare_10_shaped(corpus):
    with open(os.path.join(corpus, "b.csv")) as f:
        header = f.readline().strip().split(",")
        first = f.readline().strip().split(",")
    assert header == ["id"] + [f"x{i}" for i in range(1, 82)]
    assert len(first) == 82
    x, y = shakespeare.load_eval(corpus)
    assert x.min() >= 0 and x.max() < shakespeare.VOCAB
    assert (y == 0).any()  # zero-padded tails: pad targets to mask out
    # a row is a prefix of tokens 1..82 followed by its zero pad
    seq = np.concatenate([x, y[:, -1:]], axis=1)
    nonzero = seq != 0
    assert (nonzero[:, :-1] >= nonzero[:, 1:]).all()
    # the same seed writes the same bytes
    other = os.path.join(os.path.dirname(corpus), "again")
    shakespeare.write_markov_corpus(other, n_clients=CLIENTS, rows=ROWS,
                                    seed=5)
    for name in ("0_a.csv", "b.csv"):
        assert _sha(os.path.join(other, name)) == _sha(os.path.join(corpus,
                                                                    name))


# -- the experiment's helpers -------------------------------------------------

@pytest.mark.parametrize("embed,hidden", [(512, 256), (64, 64), (8, 8)])
def test_gru_define_matches_jax(jexp, embed, hidden):
    assert se.gru_define(embed, hidden) == jexp.gru_define(embed, hidden)


@pytest.mark.parametrize("define,want", [
    (FEMNIST_CNN, 1_206_590),
    (se.gru_define(512, 256), 654_675),
    (se.gru_define(64, 64), 35_539)])
def test_count_params_define_matches_jax(define, want):
    first = define["config"]["layers"][0]["class_name"]
    example = (np.zeros((1, 784), np.float32) if first == "Reshape"
               else np.zeros((1, 80), np.int32))
    got = count_params_define(from_nn_define(define, device="cpu"), example)
    assert got == want
    assert jcount(jfrom_nn_define(define), jnp.asarray(example)) == want


@pytest.mark.parametrize("reps", [1, 3])
def test_overhead_stats_matches_jax(jexp, reps):
    rng = np.random.RandomState(reps)
    if reps == 1:  # a record without the rep lists: round_s, round 0 first
        pl = {"round_s": list(1.0 + rng.rand(5))}
        fl = {"round_s": list(1.05 + rng.rand(5))}
    else:
        # enough pairs that the bootstrap's percentiles depend on its draws
        pl = {"round_s_reps": [list(1.0 + rng.rand(19))
                               for _ in range(reps)]}
        fl = {"round_s_reps": [list(1.03 + rng.rand(19))
                               for _ in range(reps)]}
    assert se.overhead_stats(pl, fl) == jexp.overhead_stats(pl, fl)


def _results(reps):
    rng = np.random.RandomState(7)
    out = {"config": {"rounds": 4, "small": True, "clients": 9,
                      "params": 35_539, "batch_size": 128,
                      "learning_rate": 0.01, "reps": reps},
           "schemes": {}}
    for name in ("plain", "flashe"):
        steady = [list(1.0 + rng.rand(3)) for _ in range(reps)]
        out["schemes"][name] = {
            "eval_loss": list(4.0 - rng.rand(4)),
            "eval_acc": list(rng.rand(4)),
            "mean_round_s": float(np.mean(steady[0])),
            "mean_round_s_reps": [float(np.mean(s)) for s in steady],
            "round_s_reps": steady}
    out["schemes"]["flashe"]["eval_loss"] = out["schemes"]["flashe"][
        "eval_loss"][:3]  # a missing cell renders as a dash
    out.update(se.overhead_stats(out["schemes"]["plain"],
                                 out["schemes"]["flashe"]))
    return out


@pytest.mark.parametrize("reps", [1, 3])
def test_write_docs_rows_match_jax(tmp_path, reps):
    out = _results(reps)
    # the JAX function writes ../docs/CONVERGENCE.md beside its own file:
    # run a copy of it under tmp_path
    (tmp_path / "examples").mkdir()
    (tmp_path / "docs").mkdir()
    shutil.copy(os.path.join(REPO, "examples", "shakespeare_experiment.py"),
                tmp_path / "examples")
    jmod = _load_example("shakespeare_experiment",
                         str(tmp_path / "examples"
                             / "shakespeare_experiment.py"))
    committed = os.path.join(REPO, "docs", "CONVERGENCE.md")
    before = _sha(committed)
    jmod.write_docs(out)
    se.write_docs(out, str(tmp_path / "port.md"))
    assert _sha(committed) == before
    want = (tmp_path / "docs" / "CONVERGENCE.md").read_text().splitlines()
    got = (tmp_path / "port.md").read_text().splitlines()
    rows = [ln for ln in got if ln.startswith("|")]
    assert len(rows) == 2 + 4
    assert rows == [ln for ln in want if ln.startswith("|")]
    text = "\n".join(got)
    assert "tunnel" not in text
    assert f"{out['flashe_overhead_pct']:+.2f}%" in text or (
        f"**{out['flashe_overhead_pct']}%**" in text)
    assert se.DOCS.endswith(os.path.join("docs", "CONVERGENCE_TORCH.md"))


# -- the experiment -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_plain(jexp, corpus):
    """JAX run_scheme("plain") at the test size, and the initial
    parameters every JAX client starts from."""
    shards = jshakespeare.load_clients(corpus, CLIENTS)
    eval_xy = jshakespeare.load_eval(corpus)
    define = jexp.gru_define(EMBED, HIDDEN)
    init = jinit_params(jbuild_model("nn_define", nn_define=define),
                        jnp.asarray(shards[0][0][:1]), seed=0)
    rec = jexp.run_scheme("plain", shards, eval_xy, define, ROUNDS, LR,
                          BATCH, n_hosts=CLIENTS - 1)
    return rec, jax.tree_util.tree_map(np.asarray, init)


@pytest.mark.parametrize("scheme", ["plain", "flashe"])
def test_experiment_matches_the_jax_plain_run(corpus, jax_plain, scheme,
                                               monkeypatch):
    want, init = jax_plain

    def jax_init(model, example, seed=0):
        # every client starts from the JAX clients' initial parameters
        se_init(model, example, seed)
        model.params_from_flax(init)
        return model.params_to_flax()

    se_init = se.init_params
    monkeypatch.setattr(se, "init_params", jax_init)
    rec = se.run_scheme(scheme, shakespeare.load_clients(corpus, CLIENTS),
                        shakespeare.load_eval(corpus),
                        se.gru_define(EMBED, HIDDEN), ROUNDS, LR, BATCH,
                        n_hosts=CLIENTS - 1, device="cpu")
    for key in ("fed_loss", "train_loss", "eval_loss"):
        assert len(rec[key]) == ROUNDS
        np.testing.assert_allclose(rec[key], want[key], rtol=0,
                                   atol=LOSS_ATOL, err_msg=key)
    assert len(rec["round_s"]) == len(rec["train_s"]) == ROUNDS
    assert all(0 < t <= r for t, r in zip(rec["train_s"], rec["round_s"]))


def test_main_runs_on_the_cpu(corpus, tmp_path, capsys):
    path = tmp_path / "results.json"
    assert se.main(["--dataset", corpus, "--cpu", "--small", "--rounds", "2",
                    "--clients", str(CLIENTS), "--limit", "16",
                    "--eval-limit", "16", "--batch-size", "16", "--reps",
                    "2", "--out", str(path)]) == 0
    out = json.loads(path.read_text())
    cfg = out["config"]
    assert cfg["params"] == 35_539 and cfg["device"] == "cpu"
    assert cfg["card"] is None and corpus in cfg["corpus"]
    for name in ("plain", "flashe"):
        rec = out["schemes"][name]
        assert len(rec["fed_loss_reps"]) == 2
        assert all(math.isfinite(v) for v in rec["fed_loss"])
        assert rec["launches_reps"] == [{}, {}]  # the CPU launches nothing
        assert len(rec["round_s_reps"]) == 2
    assert out["flashe_overhead_n_pairs"] == 2
    printed = capsys.readouterr().out
    assert "model parameters: 35,539" in printed
    assert printed.index("scheme plain (rep 1/2)") < printed.index(
        "scheme flashe (rep 1/2)") < printed.index(
        "scheme flashe (rep 2/2)") < printed.index("scheme plain (rep 2/2)")
    assert se.OUT.endswith(os.path.join("build", "flashe_tpu_torch",
                                        "shakespeare_results.json"))


# -- render_table2 ------------------------------------------------------------

def _table2_rows():
    rng = np.random.RandomState(3)
    rows = []
    for k, ((alg, n), ref) in enumerate(sorted(rt.REF.items())):
        t = [float(np.round(rng.rand() * 2, 4)) for _ in range(3)]
        am = [float(v / 3) if k % 3 else None for v in t]
        rows.append({"algorithm": alg if k % 4 else f"{alg} (extrapolated)",
                     "elements": n, "ciphertext_bytes": int(rng.randint(
                         1, 1 << 33)), "inflation_x": round(rng.rand() * 9,
                                                            2),
                     "encrypt_s": None if k == 5 else t[0],
                     "add10_s": t[1], "decrypt_s": t[2],
                     "encrypt_amortized_s": am[0],
                     "add10_amortized_s": am[1],
                     "decrypt_amortized_s": am[2],
                     "correct": k != 7})
    rows.append(dict(rows[0], algorithm="bfv", elements=123))  # no ref cell
    return rows


def test_render_table2_rows_match_jax(tmp_path, capsys, monkeypatch):
    line = {"metric": "table2", "unit": "see rows", "rows": _table2_rows(),
            "detail": {"platform": "cpu", "card": None}}
    path = tmp_path / "t2.json"
    path.write_text("# a verbose line\n" + json.dumps(line) + "\n")
    jrt = _load_example("render_table2")
    assert jrt.REF == rt.REF
    assert jrt.main([str(path)]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("| ") and not ln.startswith("| Vector")]
    got = rt.table_rows(line["rows"])
    assert len(got) == len(line["rows"])
    assert got == want
    assert rt.main([str(path)]) == 0
    printed = capsys.readouterr().out
    assert all(r in printed for r in got) and "tunnel" not in printed
    # --write-docs writes the port's own file
    monkeypatch.setattr(rt, "DOCS", str(tmp_path / "TABLE2_TORCH.md"))
    committed = os.path.join(REPO, "docs", "TABLE2.md")
    before = _sha(committed)
    assert rt.main([str(path), "--write-docs"]) == 0
    assert _sha(committed) == before
    assert (tmp_path / "TABLE2_TORCH.md").read_text() == rt.render(line)


def test_render_table2_needs_a_table2_line(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text('{"metric": "headline"}\n')
    with pytest.raises(SystemExit, match="no table2 JSON line"):
        rt.main([str(path)])


# -- the helpers --------------------------------------------------------------

def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("int_bits", [16, 20, 32])
@pytest.mark.parametrize("begin_block", [0, 64])
def test_flashe_mask_pair_matches_jax(int_bits, begin_block):
    count = 53
    add, minus = masks.flashe_mask_pair(aes.key_schedule(SEED), 3, 9, 0,
                                        count, int_bits, begin_block)
    jadd, jminus = jmasks.flashe_mask_pair(jaes.key_schedule(SEED), 3, 9, 0,
                                           count, int_bits, begin_block)
    assert add.shape == minus.shape == (count,)
    np.testing.assert_array_equal(_u32(add), np.asarray(jadd))
    np.testing.assert_array_equal(_u32(minus), np.asarray(jminus))
    assert not np.array_equal(_u32(add), _u32(minus))


@pytest.mark.parametrize("int_bits", [1, 20, 32])
def test_pack_ints_reference_matches_jax(int_bits):
    rng = np.random.RandomState(int_bits)
    values = rng.randint(0, 1 << min(int_bits, 31), 37).astype(np.uint32)
    got = pack.pack_ints_reference(values, int_bits)
    assert got == jpack.pack_ints_reference(values, int_bits)
    # the wire's bytes are the same big int
    assert int.from_bytes(pack.pack_lanes_np(values, int_bits), "big") == got


def test_random_pads_rand_and_pads():
    n = 100_000
    a, b, other = RandomPads(7, "cpu"), RandomPads(7, "cpu"), RandomPads(
        8, "cpu")
    u = a.rand(n)
    assert u.shape == (n,) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    torch.testing.assert_close(b.rand(n), u, rtol=0, atol=0)
    assert not torch.equal(other.rand(n), u)
    assert not torch.equal(a.rand(n), u)  # every draw is a fresh pad
    # the uniform's moments within 3 standard errors, as JAX's draws
    for draws in (u.double().numpy(),
                  np.asarray(JRandomPads(7).rand(n), np.float64)):
        assert abs(draws.mean() - 0.5) < 3 * math.sqrt(1 / 12 / n)
        assert abs(draws.var() - 1 / 12) < 3 * math.sqrt(1 / 180 / n)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for add, draw in (("add_rand_pads", "rand"), ("add_randn_pads",
                                                  "randn")):
        got = getattr(RandomPads(9, "cpu"), add)(x, 0.5)
        want = x + getattr(RandomPads(9, "cpu"), draw)(3, 4) * 0.5
        assert got.shape == (3, 4) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert not torch.equal(got, x)
        jgot = getattr(JRandomPads(9), add)(jnp.asarray(x.numpy()), 0.5)
        assert jgot.shape == got.shape and jgot.dtype == jnp.float32
