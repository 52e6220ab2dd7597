"""PyTorch port: the cluster deployment (runtime/cluster.py, the CLI's
`broker`, `party` and `cluster`) on the CPU, held against the JAX package.

- plan_commands of deploy/cluster_conf.yml and of a param conf equal the JAX
  plans, `-m flashe_tpu` read as `-m flashe_tpu_torch`.
- build_party_cfg equals the JAX function's config plus "device"; both
  refuse the same malformed arguments, and load_cluster_conf the same
  malformed confs.
- A mesh conf plans one `mesh-party` a host as the JAX package plans it
  (its tests/test_cluster_mode.py::test_mesh_conf_plan, and
  deploy/mesh_conf.yml), `--cpu` added for a CPU conf; run_local of a
  mesh conf asks for the card (tests/test_torch_multihost.py runs one on
  the CPU).
- `cluster --run-local --cpu` of an MLP FLASHE job (broker, guest, host and
  arbiter, one process each, on the CPU): the broker native, every return
  code 0, the two clients on one model, losses within 1e-5 relative of the
  in-process `submit` of the same config, and no broker left listening
  after it returns.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import sys

import numpy as np
import pytest
import torch

from flashe_tpu.runtime import cluster as jcluster
from flashe_tpu_torch.__main__ import main as cli_main
from flashe_tpu_torch.data import federated_dataset
from flashe_tpu_torch.runtime import cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy")


def _jax_plan(conf, conf_dir):
    return {k: {"host": v["host"],
                "cmd": v["cmd"].replace(" -m flashe_tpu ",
                                        " -m flashe_tpu_torch ")}
            for k, v in jcluster.plan_commands(conf, conf_dir).items()}


def _param_conf(tmp_path, cpu=True):
    return {"broker": {"host": "10.0.0.9", "port": 9555},
            "job": {"id": "pjob", "config": "job.json"},
            "parties": {"guest": [{"host": "a", "data": "/d/c0.npz",
                                   "out": str(tmp_path / "g.out")}],
                        "host": [{"host": "b", "data": "/d/c1.npz"},
                                 {"host": "c", "data_root": "/r"}],
                        "arbiter": [{"data": "/ignored"}]},
            "python": "/srv/venv/bin/python", "cpu": cpu}


@pytest.mark.parametrize("which", ["deploy/cluster_conf.yml", "param conf",
                                   "param conf on the card"])
def test_plan_matches_jax(which, tmp_path):
    if which == "deploy/cluster_conf.yml":
        conf, conf_dir = (cluster.load_cluster_conf(
            os.path.join(DEPLOY, "cluster_conf.yml")), DEPLOY)
        assert conf == jcluster.load_cluster_conf(
            os.path.join(DEPLOY, "cluster_conf.yml"))
    else:
        conf, conf_dir = _param_conf(tmp_path, cpu="card" not in which), \
            str(tmp_path)
    plan = cluster.plan_commands(conf, conf_dir)
    assert plan == _jax_plan(conf, conf_dir)
    assert plan["broker"]["cmd"].split()[1:3] == ["-m", "flashe_tpu_torch"]
    for key, entry in plan.items():
        assert "flashe_tpu " not in entry["cmd"] + " "
    assert [r for r, _, _ in cluster.party_roles(conf)] == \
        [r for r, _, _ in jcluster.party_roles(conf)]


def _dsl_pair():
    with open(os.path.join(REPO, "examples/dsl/train_job_dsl.json")) as f:
        dsl = json.load(f)
    with open(os.path.join(REPO, "examples/dsl/train_job_conf.json")) as f:
        conf = json.load(f)
    return dsl, conf


_PARAM = {"model": "mlp", "secure_aggregate": "flashe"}

_CFGS = {
    "dsl guest": lambda: (("guest", 0, ("h", 1), "j"),
                          dict(zip(("dsl", "conf"), _dsl_pair()),
                               data_root="/d", out="/o")),
    "dsl host": lambda: (("host", 1, ("10.0.0.1", "9370"), "j"),
                         dict(zip(("dsl", "conf"), _dsl_pair()))),
    "dsl arbiter": lambda: (("arbiter", 0, ("h", 1), "j"),
                            dict(zip(("dsl", "conf"), _dsl_pair()),
                                 out="/o")),
    "param guest": lambda: (("guest", 0, ("h", 1), "j"),
                            dict(param=_PARAM, n_hosts=2, data="/c0.npz",
                                 checkpoint="/g.ckpt", out="/o")),
    "param host": lambda: (("host", 1, ("h", 1), "j"),
                           dict(param=_PARAM, n_hosts=2, data="/c2.npz",
                                out="/o")),
    "param arbiter": lambda: (("arbiter", 0, ("h", 1), "j"),
                              dict(param=_PARAM, n_hosts=2, data="/x",
                                   checkpoint="/x")),
}


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_build_party_cfg_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default "out" lies in the cwd
    args, kw = _CFGS[name]()
    cfg = cluster.build_party_cfg(*args, **kw, device="cpu")
    assert cfg == dict(jcluster.build_party_cfg(*args, **kw), device="cpu")


@pytest.mark.parametrize("args,kw,match", [
    (("guest", 0, ("h", 1), "j"), {}, "exactly one of dsl / param"),
    (("judge", 0, ("h", 1), "j"), {"param": _PARAM, "n_hosts": 1},
     "unknown role"),
    (("host", 5, ("h", 1), "j"), "dsl", "out of range"),
    (("host", 0, ("h", 1), "j"), {"param": _PARAM}, "need n_hosts"),
    (("guest", 0, ("h", 1), "j"), {"param": _PARAM, "n_hosts": 1},
     "need --data"),
])
def test_build_party_cfg_refusals_match_jax(args, kw, match):
    if kw == "dsl":
        kw = dict(zip(("dsl", "conf"), _dsl_pair()))
    for fn in (jcluster.build_party_cfg,
               lambda *a, **k: cluster.build_party_cfg(*a, **k,
                                                       device="cpu")):
        with pytest.raises(ValueError, match=match):
            fn(*args, **kw)


@pytest.mark.parametrize("conf,match", [
    ({"job": {"config": "x"}, "parties": {}}, "missing section 'broker'"),
    ({"broker": {}, "job": {"dsl": "d"}, "parties": {}}, "dsl\\+conf"),
    ({"broker": {}, "job": {"config": "x"}, "parties": {"guest": [{}]}},
     "guest and arbiter"),
    ({"broker": {}, "job": {"config": "x"},
      "parties": {"guest": [{}, {}], "arbiter": [{}]}},
     "exactly one guest"),
    ({"mesh": {"hosts": []}}, "non-empty hosts"),
])
def test_load_cluster_conf_refusals_match_jax(conf, match, tmp_path):
    path = str(tmp_path / "conf.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    for load in (jcluster.load_cluster_conf, cluster.load_cluster_conf):
        with pytest.raises(ValueError, match=match):
            load(path)


def test_mesh_conf_raises_naming_multi_gpu():
    """The mesh conf is ported (multi-GPU): the port twin of
    tests/test_cluster_mode.py::test_mesh_conf_plan, and
    deploy/mesh_conf.yml's plan equal to the JAX one.  Without a card,
    running a mesh conf that does not say cpu raises, naming the card."""
    conf = {"mesh": {
        "coordinator": "10.0.0.2:9401",
        "hosts": [{"host": "10.0.0.2", "data": "/d/s0.npz"}, "10.0.0.3"],
        "rounds": 7, "model": "mlp"}}
    plan = cluster.plan_commands(conf)
    assert set(plan) == {"mesh_0", "mesh_1"}
    assert "broker" not in plan
    c0 = plan["mesh_0"]["cmd"]
    assert c0.startswith("python -m flashe_tpu_torch mesh-party ")
    assert "--coordinator 10.0.0.2:9401" in c0
    assert "--num-processes 2" in c0
    assert "--process-id 0" in c0
    assert "--rounds 7" in c0
    assert "--data /d/s0.npz" in c0
    assert "--data" not in plan["mesh_1"]["cmd"]
    assert plan["mesh_1"]["host"] == "10.0.0.3"
    assert plan == _jax_plan(conf, ".")
    yml = cluster.load_cluster_conf(os.path.join(DEPLOY, "mesh_conf.yml"))
    assert cluster.plan_commands(yml) == _jax_plan(
        jcluster.load_cluster_conf(os.path.join(DEPLOY, "mesh_conf.yml")),
        ".")
    cpu = cluster.plan_commands(dict(yml, cpu=True))
    assert all(e["cmd"].endswith(" --cpu") for e in cpu.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cluster.run_local(yml)


def test_cluster_run_local(tmp_path, monkeypatch, capsys):
    """The broker and three party processes on the CPU, through the CLI,
    against the in-process submit of the same config."""
    monkeypatch.chdir(REPO)
    job = {"param": {
        "model": "mlp", "model_kwargs": {"features": [8, 10]},
        "secure_aggregate": "flashe",
        "secure_aggregate_args": {
            "quantize": {"int_bits": 20, "element_bits": 16}},
        "max_iter": 1, "batch_size": 32, "learning_rate": 0.005},
        "n_clients": 2, "samples_per_client": 64}
    with open(tmp_path / "job.json", "w") as f:
        json.dump(job, f)
    for i, (x, y) in enumerate(federated_dataset("mlp", 2, 64, seed=0)):
        np.savez(tmp_path / f"c{i}.npz", x=x, y=y)
    outs = {r: str(tmp_path / f"{r}.out")
            for r in ("guest", "host", "arbiter")}
    conf = {"broker": {"host": "127.0.0.1", "port": 0},
            "job": {"id": "clustertest", "config": "job.json"},
            "parties": {"guest": [{"data": str(tmp_path / "c0.npz"),
                                   "out": outs["guest"]}],
                        "host": [{"data": str(tmp_path / "c1.npz"),
                                  "out": outs["host"]}],
                        "arbiter": [{"out": outs["arbiter"]}]},
            "python": sys.executable}
    with open(tmp_path / "cluster.json", "w") as f:
        json.dump(conf, f)
    assert cli_main(["cluster", "-c", str(tmp_path / "cluster.json"),
                     "--run-local", "--timeout", "300", "--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rcs = json.loads(lines[-1])
    assert rcs == {"guest_0": 0, "host_0": 0, "arbiter_0": 0}
    said = [ln for ln in lines if ln.startswith("cluster: the broker")]
    assert len(said) == 1 and "(native)" in said[0]
    # the broker process (and its native child) ended with the command:
    # nothing listens on its port
    port = int(said[0].rsplit(":", 1)[1])
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
    res = {}
    for role, path in outs.items():
        with open(path, "rb") as f:
            res[role] = pickle.load(f)
        assert res[role]["device"] == "cpu"
    assert res["guest"]["model_sha256"] == res["host"]["model_sha256"]
    assert res["guest"]["mask_launches"] == \
        {k: 0 for k in res["guest"]["mask_launches"]}

    assert cli_main(["submit", "-c", str(tmp_path / "job.json"), "--cpu",
                     "--json"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(res["arbiter"]["loss_history"],
                               want["loss_per_round"], rtol=1e-5, atol=0)
