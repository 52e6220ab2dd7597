"""PyTorch port: the DSL job layer (flashe_tpu_torch/runtime/dsl.py), the
Evaluation metrics (nn/evaluation.py) and cross-validation
(nn/cross_validation.py) against the JAX package, on the CPU.

- parse_dsl's order and errors, JobConf's per-party indexing, and
  translate_homo_nn(...).to_dict() equal to the JAX package's for
  examples/dsl/train_job_conf.json and the test defines;
- evaluate_classification, binary_auc, binary_ks and kfold_indices equal
  to the JAX package's on seeded inputs;
- run_dsl_job in this process on the CPU: 3 parties, an MLP nn_define,
  FLASHE, 2 iterations, every client on one model bit for bit after the
  last aggregation and an Evaluation result at every client; a
  cross-validation job; the LSTM create-label job (next-token targets,
  (n, T - 1) labels); a train job that publishes to the port's model store
  and a predict job that loads it back.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest

from flashe_tpu.nn import cross_validation as jcv
from flashe_tpu.nn import evaluation as jev
from flashe_tpu.runtime import dsl as jdsl
from flashe_tpu_torch.data.store import DataStore
from flashe_tpu_torch.nn import cross_validation as pcv
from flashe_tpu_torch.nn import evaluation as pev
from flashe_tpu_torch.runtime import dsl as pdsl
from flashe_tpu_torch.runtime.dsl import JobConf, parse_dsl, run_dsl_job

from test_dsl import DSL, FLASHE_ARGS, make_conf, mlp_define

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "dsl")

LSTM_DEFINE = {"class_name": "Sequential", "config": {
    "name": "lstm", "layers": [
        {"class_name": "Embedding",
         "config": {"name": "e", "input_dim": 5, "output_dim": 4}},
        {"class_name": "GRU",
         "config": {"name": "g", "units": 8, "return_sequences": True}},
        {"class_name": "Dense",
         "config": {"name": "d", "units": 5, "activation": "linear"}},
    ]}}


def _example(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        return json.load(f)


def seed_store(tmp_path, n_parties=3, n=48, dim=8, classes=3, seq=False):
    store = DataStore(str(tmp_path / "tables"))
    rng = np.random.RandomState(7)
    tables = []
    for i in range(n_parties):
        if seq:
            x = rng.randint(0, classes, (n, dim)).astype(np.float32)
            y = None
        else:
            x = rng.randn(n, dim).astype(np.float32)
            y = rng.randint(0, classes, n).astype(np.int64)
        store.put("t", f"p{i}", x, y)
        tables.append({"namespace": "t", "name": f"p{i}"})
    return store, tables

# ----------------------------------------------------------------- parsing


def test_parse_dsl_order_matches_jax():
    for dsl in (DSL, _example("train_job_dsl.json")):
        assert ([c.name for c in parse_dsl(dsl)]
                == [c.name for c in jdsl.parse_dsl(dsl)])
        for port, ref in zip(parse_dsl(dsl), jdsl.parse_dsl(dsl)):
            assert (port.module, port.data_inputs, port.data_outputs) == (
                ref.module, ref.data_inputs, ref.data_outputs)
    comps = [c.name for c in parse_dsl(DSL)]
    assert comps.index("dataio_0") < comps.index("homo_nn_0") < \
        comps.index("evaluation_0")


@pytest.mark.parametrize("dsl, match", [
    ({"components": {
        "a": {"module": "DataIO", "input": {"data": {"data": ["b.out"]}},
              "output": {"data": ["out"]}},
        "b": {"module": "DataIO", "input": {"data": {"data": ["a.out"]}},
              "output": {"data": ["out"]}}}}, "cycle"),
    ({"components": {
        "a": {"module": "DataIO",
              "input": {"data": {"data": ["nosuch.out"]}},
              "output": {"data": ["out"]}}}}, "unknown upstream"),
    ({"components": {"a": {"module": "HeteroLR"}}}, "unsupported module"),
])
def test_parse_dsl_rejects_like_jax(dsl, match):
    for parse in (parse_dsl, jdsl.parse_dsl):
        with pytest.raises(ValueError, match=match):
            parse(dsl)


def test_conf_per_party_indexing_matches_jax():
    raw = make_conf([{"namespace": "t", "name": n}
                     for n in ("g", "h0", "h1")], {"model": "mlp"})
    for conf in (JobConf.parse(raw), jdsl.JobConf.parse(raw)):
        assert conf.n_hosts == 2
        assert conf.args_data("host", 1, "train_data")["name"] == "h1"
        assert conf.component_param("dataio_0", "guest", 0)[
            "with_label"] is True
    port, ref = JobConf.parse(raw), jdsl.JobConf.parse(raw)
    for role, n in (("guest", 1), ("host", 2)):
        for i in range(n + 1):  # past the list: its last entry
            assert port.args_data(role, i, "train_data") == \
                ref.args_data(role, i, "train_data")
            assert port.component_param("dataio_0", role, i) == \
                ref.component_param("dataio_0", role, i)
    with pytest.raises(ValueError, match="arbiter"):
        JobConf.parse({"role": {"guest": [1]}})


def _translations():
    ap = {"config_type": "keras", "nn_define": mlp_define(),
          "batch_size": 128,
          "optimizer": {"optimizer": "Adam", "learning_rate": 0.0005},
          "early_stop": {"early_stop": "diff", "eps": 0.0001},
          "loss": "categorical_crossentropy", "metrics": ["accuracy"],
          "max_iter": 2, "secure_aggregate": "flashe",
          "secure_aggregate_args": FLASHE_ARGS}
    return {
        "train_job_conf": _example("train_job_conf.json")[
            "algorithm_parameters"]["homo_nn_0"],
        "mlp": ap,
        "lstm": dict(ap, nn_define=LSTM_DEFINE),
        "registry_sgd": {"model": "mlp", "optimizer": "sgd",
                         "early_stop": "abs", "secure_aggregate": "plain"},
        "cv_paillier": dict(ap, secure_aggregate="paillier",
                            cv_param={"n_splits": 3, "random_seed": 5}),
    }


@pytest.mark.parametrize("case", sorted(_translations()))
def test_translate_homo_nn_matches_jax(case):
    ap = _translations()[case]
    port, create = pdsl.translate_homo_nn(copy.deepcopy(ap))
    ref, ref_create = jdsl.translate_homo_nn(copy.deepcopy(ap))
    assert port.to_dict() == ref.to_dict()
    assert (port.secure_aggregate_args.to_dict()
            == ref.secure_aggregate_args.to_dict())
    assert create == ref_create == (case == "lstm")


def test_translate_needs_a_model():
    with pytest.raises(ValueError, match="nn_define"):
        pdsl.translate_homo_nn({"max_iter": 1})

# ------------------------------------------------- evaluation, k-fold


def _score_cases():
    rng = np.random.default_rng(11)
    y2 = rng.integers(0, 2, 40)
    s2 = rng.random(40).round(1)  # ties
    y5 = rng.integers(0, 5, 60)
    s5 = rng.random((60, 5))
    seq_y = rng.integers(0, 4, (6, 3))
    seq_s = rng.random((6, 3, 4))
    return {"binary_1d": (y2, s2), "binary_2col": (y2, np.stack(
        [1 - s2, s2], -1)), "multiclass": (y5, s5),
            "one_class": (np.zeros(5, int), rng.random((5, 3))),
            "sequence": (seq_y, seq_s)}


@pytest.mark.parametrize("case", sorted(_score_cases()))
def test_evaluation_matches_jax(case):
    y, s = _score_cases()[case]
    port = pev.evaluate_classification(y, s)
    ref = jev.evaluate_classification(y, s)
    assert port.keys() == ref.keys()
    for k in port:
        np.testing.assert_equal(port[k], ref[k])
    if s.ndim == 1:
        assert pev.binary_auc(y, s) == jev.binary_auc(y, s)
        assert pev.binary_ks(y, s) == jev.binary_ks(y, s)
    assert pev.binary_auc(np.array([0, 0, 1, 1]),
                          np.array([0.1, 0.4, 0.35, 0.8])) == 0.75


@pytest.mark.parametrize("n, k, shuffle, seed", [
    (24, 2, True, 3), (10, 3, True, 0), (7, 7, False, 0), (31, 5, True, 9)])
def test_kfold_indices_match_jax(n, k, shuffle, seed):
    port = pcv.kfold_indices(n, k, shuffle, seed)
    ref = jcv.kfold_indices(n, k, shuffle, seed)
    assert len(port) == len(ref) == k
    for (ptr, pte), (rtr, rte) in zip(port, ref):
        np.testing.assert_array_equal(ptr, rtr)
        np.testing.assert_array_equal(pte, rte)
    with pytest.raises(ValueError, match="folds"):
        pcv.kfold_indices(2, 3)

# ------------------------------------------------------------- end-to-end


def _recording_pipeline(monkeypatch):
    """Keep each client's final parameters, which run_dsl_job drops with
    the client."""
    models = {}
    inner = pdsl.client_pipeline

    def client_pipeline(trv, components, conf, role, ordinal, *args, **kw):
        out = inner(trv, components, conf, role, ordinal, *args, **kw)
        models[f"{role}{ordinal}"] = out["_client"].trainer.params
        return out

    monkeypatch.setattr(pdsl, "client_pipeline", client_pipeline)
    return models


def test_run_dsl_job_flashe_mlp(tmp_path, monkeypatch):
    store, tables = seed_store(tmp_path)
    conf = make_conf(tables, {
        "config_type": "keras", "nn_define": mlp_define(8, 12, 3),
        "batch_size": 16, "max_iter": 2,
        "optimizer": {"optimizer": "Adam", "learning_rate": 0.01},
        "secure_aggregate": "flashe",
        "secure_aggregate_args": FLASHE_ARGS,
    })
    models = _recording_pipeline(monkeypatch)
    res = run_dsl_job(DSL, conf, store=store, device="cpu")
    losses = res["arbiter"]["homo_nn_0"]["loss_history"]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert sorted(models) == ["guest0", "host0", "host1"]
    for name, params in models.items():
        for k, v in params.items():
            assert v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(),
                                          models["guest0"][k].numpy())
    for role in ("guest", "host0", "host1"):
        ev = res[role]["evaluation_0"]
        assert 0.0 <= ev["accuracy"] <= 1.0 and "macro_f1" in ev
        assert [h["iter"] for h in res[role]["homo_nn_0"]["history"]] == \
            [0, 1]
        assert "_client" not in res[role]


def test_run_dsl_job_cross_validation(tmp_path):
    """Each fold a federated fit in its own federation scope; the DSL has
    no Evaluation, since a cross-validated component passes no scores on
    (as in the JAX package)."""
    store, tables = seed_store(tmp_path, n_parties=2, n=24)
    conf = make_conf(tables, {
        "model": "mlp", "model_kwargs": {"features": [8, 3]},
        "secure_aggregate": "flashe",
        "secure_aggregate_args": FLASHE_ARGS,
        "max_iter": 2, "batch_size": 8,
        "cv_param": {"need_cv": True, "n_splits": 2, "shuffle": True,
                     "random_seed": 3}})
    cv_dsl = {"components": {k: v for k, v in DSL["components"].items()
                             if k != "evaluation_0"}}
    out = run_dsl_job(cv_dsl, conf, store=store, device="cpu")
    for role in ("guest", "host0"):
        cv = out[role]["homo_nn_0"]["cv"]
        assert cv["n_splits"] == 2 and len(cv["folds"]) == 2
        for fold in cv["folds"]:
            assert fold["n_train"] + fold["n_test"] == 24
            assert np.isfinite(fold["loss"])
        assert 0.0 <= cv["mean_acc"] <= 1.0
    arb = out["arbiter"]["homo_nn_0"]
    assert arb["n_splits"] == 2
    assert [len(h) for h in arb["loss_histories"]] == [2, 2]


def test_run_dsl_job_lstm_create_label(tmp_path, monkeypatch):
    """nn_define config.name == 'lstm': next-token targets from the
    sequence, (n, T - 1) labels through the trainer's cross-entropy."""
    store, tables = seed_store(tmp_path, n_parties=2, dim=7, classes=5,
                               seq=True)
    conf = make_conf(tables, {
        "nn_define": LSTM_DEFINE, "batch_size": 16, "max_iter": 1,
        "optimizer": {"optimizer": "Adam", "learning_rate": 0.01},
        "secure_aggregate": "plain"})
    conf["role_parameters"]["guest"]["dataio_0"] = {"with_label": [False]}
    conf["role_parameters"]["host"]["dataio_0"] = {"with_label": [False]}
    models = _recording_pipeline(monkeypatch)
    res = run_dsl_job(DSL, conf, store=store, device="cpu")
    losses = res["arbiter"]["homo_nn_0"]["loss_history"]
    assert len(losses) == 1 and np.isfinite(losses[0])
    # 48 sequences x 6 next tokens scored position by position
    assert 0.0 <= res["guest"]["evaluation_0"]["accuracy"] <= 1.0
    assert models["guest0"]["d/kernel"].shape == (8, 5)


def test_train_publish_then_predict_job(tmp_path, monkeypatch):
    """job_parameters.publish saves the guest's model in the port's model
    store; a job_type=predict job loads and scores with it."""
    monkeypatch.setenv("FLASHE_TORCH_MODELS_DIR", str(tmp_path / "models"))
    store, tables = seed_store(tmp_path, n_parties=2)
    ap = {"model": "mlp", "model_kwargs": {"features": [8, 3]},
          "batch_size": 16, "max_iter": 1,
          "optimizer": {"optimizer": "Adam", "learning_rate": 0.01},
          "secure_aggregate": "plain"}
    conf = make_conf(tables, ap)
    conf["job_parameters"] = {"job_type": "train", "publish": "dslmodel",
                              "model_version": "job42"}
    res = run_dsl_job(DSL, conf, store=store, device="cpu")
    pub = res["guest"]["homo_nn_0"]["published"]
    assert (pub["namespace"], pub["version"], pub["aggregate_iter"]) == (
        "dslmodel", "job42", 1)

    conf_pred = make_conf(tables, ap)
    conf_pred["job_parameters"] = {"job_type": "predict",
                                   "model": {"namespace": "dslmodel"}}
    res2 = run_dsl_job(DSL, conf_pred, store=store, device="cpu")
    assert res2["guest"]["homo_nn_0"]["model"]["version"] == "job42"
    assert res2["guest"]["homo_nn_0"]["aggregate_iter"] == 1
    assert "homo_nn_0" not in res2["arbiter"]
    for role in ("guest", "host0"):
        assert 0.0 <= res2[role]["evaluation_0"]["accuracy"] <= 1.0
