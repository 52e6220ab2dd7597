"""PyTorch port: the job runtime on the CPU — the job registry
(runtime/job_manager.py), the dataset store (data/store.py, data/io.py),
the model store (runtime/model_manager.py), the privilege store
(runtime/permission.py), the multi-process job runner (runtime/job.py over
runtime/task_executor.py) and the CLI's commands over them.

- The registry's lifecycle; `stop` kills an exact recorded PID; every
  job id or task name that would leave the registry is refused.
- A table that the JAX package's DataStore wrote loads in the port's, and
  the other way round, CSV export included; upload_csv and to_dtable give
  a session the same Instances as the JAX package's.
- ModelManager publish / bind / load_latest; a JAX checkpoint is refused
  with an error that names it; the port's store does not default to the
  JAX package's root.
- A revoked variable raises PermissionError in run_roles, in both
  packages, from the one privilege file they share.
- submit_job with 2 clients (3 processes), MLP, FLASHE, 1 iteration on the
  CPU over the native broker; a host whose data is corrupt fails and
  aborts the job.
- `python -m flashe_tpu_torch` submit --processes --cpu --json (with
  --checkpoint-dir and --publish), predict --cpu from that checkpoint and
  from the model store, submit-dsl --cpu, keygen, upload / download /
  tables, models / bind, permission, jobs / query / logs / stop.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from flashe_tpu.data import table as jtable
from flashe_tpu.data.store import DataStore as JDataStore
from flashe_tpu.runtime.checkpoint import save_checkpoint as jsave_checkpoint
from flashe_tpu.runtime.simulate import run_roles as jrun_roles
from flashe_tpu_torch.__main__ import main as cli_main
from flashe_tpu_torch.data import federated_dataset
from flashe_tpu_torch.data.io import read_dense_csv, upload_csv
from flashe_tpu_torch.data.store import DataStore
from flashe_tpu_torch.data.table import init
from flashe_tpu_torch.runtime import job as pjob
from flashe_tpu_torch.runtime.checkpoint import save_checkpoint
from flashe_tpu_torch.runtime.config import (
    HomoNNParam, QuantizeConfig, SecureAggregateArgs,
)
from flashe_tpu_torch.runtime.job_manager import JobRegistry
from flashe_tpu_torch.runtime.model_manager import ModelManager
from flashe_tpu_torch.runtime.permission import PrivilegeStore
from flashe_tpu_torch.runtime.simulate import run_roles

from test_dsl import DSL, make_conf, mlp_define

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _param(max_iter=1):
    return HomoNNParam(
        model="mlp", model_kwargs={"features": (8, 10)},
        secure_aggregate="flashe",
        secure_aggregate_args=SecureAggregateArgs(
            quantize=QuantizeConfig(int_bits=20, element_bits=16)),
        max_iter=max_iter, batch_size=16, learning_rate=5e-3)


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Every store of both packages under tmp_path."""
    for var, sub in (("FLASHE_JOBS_DIR", "jobs"), ("FLASHE_DATA_DIR", "data"),
                     ("FLASHE_TORCH_MODELS_DIR", "models"),
                     ("FLASHE_MODELS_DIR", "jax_models"),
                     ("FLASHE_PERMISSIONS_PATH", "permissions.json")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    return tmp_path

# -- the job registry ---------------------------------------------------------


def test_registry_lifecycle(tmp_path):
    reg = JobRegistry(str(tmp_path / "jobs"))
    reg.create("j1", {"n_hosts": 1})
    reg.set_task("j1", "guest_0", pid=999999, status="running")
    with open(os.path.join(reg.log_dir("j1"), "guest_0.log"), "w") as f:
        f.write("line1\nline2\nline3\n")
    rec = reg.query("j1")
    assert rec["status"] == "running"
    assert rec["tasks"]["guest_0"]["pid"] == 999999
    assert [r["job_id"] for r in reg.list_jobs()] == ["j1"]
    assert reg.read_log("j1", task="guest_0", tail=2) == {
        "guest_0": "line2\nline3"}
    assert set(reg.read_log("j1")) == {"guest_0"}
    reg.finish("j1", "success")
    assert reg.query("j1")["status"] == "success"
    assert reg.query("j1")["tasks"]["guest_0"]["status"] == "success"
    assert reg.stop("j1")["status"] == "success"  # finished: a no-op
    with pytest.raises(KeyError):
        reg.query("nope")
    # a stop that raced a queued job's create survives the create
    reg.create("j2", {})
    reg.stop("j2")
    assert reg.create("j2", {})["status"] == "canceled"


def test_registry_stop_kills_exact_pid(tmp_path):
    reg = JobRegistry(str(tmp_path / "jobs"))
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(300)"])
    try:
        reg.create("j2", {})
        reg.set_task("j2", "host_0", pid=proc.pid)
        rec = reg.stop("j2")
        assert rec["status"] == "canceled"
        assert rec["tasks"]["host_0"]["status"] == "canceled"
        assert reg.is_canceled("j2")
        proc.wait(timeout=10)
        assert proc.returncode == -15  # SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("bad", ["../j1", "..", ".", "a/b", "", "j1\0",
                                 "/etc", "j 1"])
def test_registry_refuses_ids_that_leave_it(tmp_path, bad):
    reg = JobRegistry(str(tmp_path / "jobs"))
    reg.create("j1", {})
    with open(tmp_path / "secret.log", "w") as f:
        f.write("secret\n")
    for call in (lambda: reg.query(bad), lambda: reg.stop(bad),
                 lambda: reg.read_log(bad), lambda: reg.log_dir(bad),
                 lambda: reg.read_log("j1", task=bad or "../x")):
        with pytest.raises(ValueError, match="invalid"):
            call()
    with pytest.raises(ValueError, match="invalid"):
        reg.read_log("j1", task="../../secret")

# -- the dataset store ------------------------------------------------------


def test_data_store_interchange_with_jax(tmp_path):
    root = str(tmp_path / "data")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 4, 3)).astype(np.float32)
    y = rng.integers(0, 5, 6).astype(np.int32)
    JDataStore(root).put("ns", "jax_wrote", x, y)
    px, py, meta = DataStore(root).load("ns", "jax_wrote")
    np.testing.assert_array_equal(px, x)
    np.testing.assert_array_equal(py, y)
    assert meta["feature_shape"] == [4, 3] and meta["labeled"]

    DataStore(root).put("ns", "port_wrote", x[:, 0])
    jx, jy, jmeta = JDataStore(root).load("ns", "port_wrote")
    np.testing.assert_array_equal(jx, x[:, 0])
    assert jy is None and not jmeta["labeled"]
    assert [(m["namespace"], m["name"]) for m in DataStore(root)
            .list_tables()] == [("ns", "jax_wrote"), ("ns", "port_wrote")]

    for store, name in ((DataStore(root), "p"), (JDataStore(root), "j")):
        store.download_csv("ns", "jax_wrote", str(tmp_path / f"{name}.csv"))
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    meta = DataStore(root).upload_csv(str(tmp_path / "p.csv"), "ns", "csv")
    cx, cy, _ = DataStore(root).load("ns", "csv")
    np.testing.assert_array_equal(cx, x.reshape(6, -1))
    np.testing.assert_array_equal(cy, y)
    assert meta["count"] == 6
    assert DataStore(root).delete("ns", "csv")
    with pytest.raises(KeyError):
        DataStore(root).load("ns", "csv")
    with pytest.raises(ValueError, match="invalid"):
        DataStore(root).load("..", "x")
    # into a session: a table of Instances, as the JAX package builds it
    table = upload_csv(init("up"), str(tmp_path / "p.csv"), "t", "ns")
    assert table.count() == 6 and table.get(5).label == int(y[5])
    np.testing.assert_array_equal(table.get(5).features, x[5].reshape(-1))
    dt = DataStore(root).to_dtable(init("dt"), "ns", "jax_wrote")
    ref = JDataStore(root).to_dtable(jtable.init("dt"), "ns", "jax_wrote")
    assert dt.count() == ref.count() == 6
    for i in range(6):
        np.testing.assert_array_equal(dt.get(i).features,
                                      ref.get(i).features)
        assert dt.get(i).label == ref.get(i).label == int(y[i])
    ux, uy = read_dense_csv(str(tmp_path / "p.csv"), label_index=None)
    assert uy is None and ux.shape == (6, 13)

# -- the model store ----------------------------------------------------------


def test_model_manager_publish_bind_latest(tmp_path, monkeypatch):
    monkeypatch.delenv("FLASHE_TORCH_MODELS_DIR", raising=False)
    monkeypatch.setenv("FLASHE_MODELS_DIR", str(tmp_path / "jax"))
    assert ModelManager().root != os.environ["FLASHE_MODELS_DIR"]
    assert ".flashe_tpu_torch" in ModelManager().root

    mm = ModelManager(str(tmp_path / "models"))
    params = {"Dense_0/kernel": torch.arange(6.0).reshape(2, 3),
              "Dense_0/bias": torch.ones(3)}
    mm.save("ns", "v1", params, 3, param_dict={"model": "mlp"})
    ckpt = str(tmp_path / "guest_0.ckpt")
    save_checkpoint(ckpt, {k: v * 2 for k, v in params.items()}, 5)
    time.sleep(0.01)
    meta = mm.publish_checkpoint("ns", "job7", ckpt)
    assert (meta["version"], meta["aggregate_iter"]) == ("job7", 5)
    assert [m["version"] for m in mm.list_versions("ns")] == ["v1", "job7"]
    assert mm.load_latest("ns")["aggregate_iter"] == 5  # the newest
    mm.bind("ns", "v1")
    latest = mm.load_latest("ns")
    assert latest["aggregate_iter"] == 3 and latest["meta"]["version"] == "v1"
    np.testing.assert_array_equal(latest["params"]["Dense_0/kernel"],
                                  params["Dense_0/kernel"].numpy())
    assert mm.delete("ns", "v1") and mm.bound_version("ns") is None
    assert mm.latest_version("ns") == "job7"
    with pytest.raises(KeyError):
        mm.load_latest("empty")
    with pytest.raises(ValueError, match="invalid"):
        mm.load("..", "v1")


def test_model_manager_refuses_a_jax_checkpoint(tmp_path):
    jckpt = str(tmp_path / "jax.ckpt")
    jsave_checkpoint(jckpt, {"Dense_0": {"kernel": np.zeros((2, 3),
                                                             np.float32)}}, 2)
    mm = ModelManager(str(tmp_path / "models"))
    with pytest.raises(ValueError, match="JAX package"):
        mm.publish_checkpoint("ns", "v1", jckpt)
    os.makedirs(os.path.join(mm.root, "ns", "v2"))
    os.replace(jckpt, mm.checkpoint_path("ns", "v2"))
    with open(os.path.join(mm.root, "ns", "v2", "meta.json"), "w") as f:
        json.dump({"version": "v2", "created": 0}, f)
    with pytest.raises(ValueError, match="JAX package"):
        mm.load("ns", "v2")

# -- the privilege store ------------------------------------------------------


def _roles():
    def guest(trv):
        trv.guest_to_arbiter.remote("hello", role="arbiter", idx=0)

    def arbiter(trv):
        return trv.guest_to_arbiter.get(idx=0, timeout=20)

    return guest, (lambda trv, h: None), arbiter


@pytest.mark.parametrize("package", ["port", "jax"])
def test_revoked_variable_fails_run_roles(stores, package):
    runner = run_roles if package == "port" else jrun_roles
    guest, host, arbiter = _roles()
    assert runner(1, guest, host, arbiter)["arbiter"] == "hello"
    store = PrivilegeStore()
    store.revoke("guest_to_arbiter", "guest", "arbiter")
    assert store.has_overrides()
    with pytest.raises(RuntimeError) as e:
        runner(1, guest, host, arbiter)
    assert isinstance(e.value.__cause__, PermissionError)
    store.grant("guest_to_arbiter", "guest", "arbiter")
    assert runner(1, guest, host, arbiter)["arbiter"] == "hello"

# -- the multi-process runner ----------------------------------------------------


def test_submit_job_processes(stores):
    shards = federated_dataset("mlp", 2, 32, seed=0)
    reg = JobRegistry()
    res = pjob.submit_job(_param(), shards, timeout=300, device="cpu",
                          checkpoint_dir=str(stores / "ckpt"))
    assert sorted(res) == ["__job__", "arbiter_0", "guest_0", "host_0"]
    assert res["__job__"]["broker"] == "native"
    assert len(res["arbiter_0"]["loss_history"]) == 1
    for task in ("guest_0", "host_0"):
        out = res[task]
        assert out["device"] == "cpu" and out["history"][0]["loss"] > 0
        assert "encryption" in out["phases"]
        assert "local train" in dict(out["phase_log"])
        assert out["mask_launches"] == {k: 0 for k in out["mask_launches"]}
        assert out["startup_s"] > 0 and out["peak_memory_bytes"] == 0
    assert res["guest_0"]["model_sha256"] == res["host_0"]["model_sha256"]
    a = pickle.load(open(stores / "ckpt" / "guest_0.ckpt", "rb"))
    b = pickle.load(open(stores / "ckpt" / "host_0.ckpt", "rb"))
    for k, v in a["params"].items():
        np.testing.assert_array_equal(v, b["params"][k])
    rec = reg.query(res["__job__"]["job_id"])
    assert rec["status"] == "success" and rec["device"] == "cpu"
    assert {t: s["status"] for t, s in rec["tasks"].items()} == {
        "guest_0": "success", "host_0": "success", "arbiter_0": "success"}
    # a stopped job never spawns
    reg.create("queued", {})
    reg.stop("queued")
    with pytest.raises(pjob.JobCanceled):
        pjob.submit_job(_param(), shards, job_id="queued", device="cpu")
    assert reg.query("queued")["tasks"] == {}


def test_failed_task_aborts_the_job(stores, monkeypatch):
    """A dead task aborts the job and the registry records the failure
    (reference job_detector / TaskScheduler.check_task_status)."""
    shards = federated_dataset("mlp", 2, 32, seed=0)
    orig_savez = np.savez

    def sabotage(path, **arrays):
        orig_savez(path, **arrays)
        if "host_0" in str(path):
            with open(path, "wb") as f:
                f.write(b"not-an-npz")

    monkeypatch.setattr(np, "savez", sabotage)
    with pytest.raises(RuntimeError, match="host_0 failed"):
        pjob.submit_job(_param(), shards, timeout=300, device="cpu")
    rec, = JobRegistry().list_jobs()
    assert rec["status"] == "failed"
    assert rec["tasks"]["host_0"]["status"] == "failed"
    assert rec["tasks"]["guest_0"]["status"] != "running"
    log = JobRegistry().read_log(rec["job_id"], task="host_0")["host_0"]
    assert "Error" in log

# -- the CLI -------------------------------------------------------------------


def _cli(capsys, *argv):
    assert cli_main(list(argv)) == 0
    return capsys.readouterr().out


def test_cli_submit_processes_publish_and_predict(stores, capsys):
    cfg = {"param": _param().to_dict(), "n_clients": 2,
           "dataset": "mlp", "samples_per_client": 32}
    path = str(stores / "job.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    out = json.loads(_cli(capsys, "submit", "-c", path, "--processes",
                          "--cpu", "--json", "--checkpoint-dir",
                          str(stores / "ckpt"), "--publish", "mlpns"))
    assert len(out["loss_per_round"]) == 1
    assert "encryption" in out["phases"] and "__total__" in \
        out["guest_transfer"]
    job_id = out["job"]["job_id"]

    models = json.loads(_cli(capsys, "models", "-n", "mlpns", "--json"))
    assert [m["version"] for m in models["versions"]] == [job_id]
    assert json.loads(_cli(capsys, "bind", "-n", "mlpns", "-v", job_id)) == {
        "namespace": "mlpns", "bound": job_id}

    preds = str(stores / "preds.npy")
    by_ckpt = json.loads(_cli(capsys, "predict", "-c", path, "--cpu",
                              "--checkpoint",
                              str(stores / "ckpt" / "guest_0.ckpt"),
                              "--out", preds))
    by_model = json.loads(_cli(capsys, "predict", "-c", path, "--cpu",
                               "--model", "mlpns"))
    assert by_ckpt["aggregate_iter"] == by_model["aggregate_iter"] == 1
    assert by_ckpt["accuracy"] == by_model["accuracy"]
    assert by_ckpt["n"] == 32 and np.load(preds).shape == (32, 10)

    rows = json.loads(_cli(capsys, "jobs", "--json"))
    assert [r["job_id"] for r in rows] == [job_id]
    assert json.loads(_cli(capsys, "query", "-j", job_id))["status"] == \
        "success"
    assert "===== arbiter_0 =====" in _cli(capsys, "logs", "-j", job_id)
    assert json.loads(_cli(capsys, "stop", "-j", job_id))["status"] == \
        "success"


def test_cli_submit_dsl_in_process(stores, capsys):
    store = DataStore()
    rng = np.random.RandomState(7)
    tables = []
    for i in range(2):
        store.put("t", f"p{i}", rng.randn(32, 8).astype(np.float32),
                  rng.randint(0, 3, 32).astype(np.int64))
        tables.append({"namespace": "t", "name": f"p{i}"})
    conf = make_conf(tables, {
        "config_type": "keras", "nn_define": mlp_define(8, 12, 3),
        "batch_size": 16, "max_iter": 1, "secure_aggregate": "plain"})
    paths = {}
    for name, obj in (("dsl", DSL), ("conf", conf)):
        paths[name] = str(stores / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    out = json.loads(_cli(capsys, "submit-dsl", "-d", paths["dsl"], "-c",
                          paths["conf"], "--cpu", "--json"))
    assert len(out["arbiter"]["homo_nn_0"]["loss_per_round"]) == 1
    for role in ("guest", "host0"):
        assert 0.0 <= out[role]["evaluation_0"]["accuracy"] <= 1.0


def test_cli_stores_and_keygen(stores, capsys):
    key = _cli(capsys, "keygen").strip()
    assert len(bytes.fromhex(key)) == 32
    csv = stores / "in.csv"
    csv.write_text("y,a,b\n1,0.5,2.0\n0,1.5,-1.0\n")
    meta = json.loads(_cli(capsys, "upload", "-f", str(csv), "-n", "ns",
                           "-t", "tb"))
    assert meta["count"] == 2 and meta["labeled"]
    assert json.loads(_cli(capsys, "tables", "--json"))[0]["name"] == "tb"
    out_csv = str(stores / "out.csv")
    _cli(capsys, "download", "-n", "ns", "-t", "tb", "-o", out_csv)
    x, y = read_dense_csv(out_csv)
    np.testing.assert_array_equal(x, [[0.5, 2.0], [1.5, -1.0]])
    np.testing.assert_array_equal(y, [1, 0])
    # the JAX package's store sees the port's upload
    assert JDataStore().load("ns", "tb")[2]["count"] == 2

    revoked = json.loads(_cli(capsys, "permission", "revoke", "--variable",
                              "guest_loss", "--src-role", "guest",
                              "--dst-role", "arbiter"))
    assert revoked == {"revoked": ["guest_loss", "guest", "arbiter"]}
    rows = json.loads(_cli(capsys, "permission", "query", "--src-role",
                           "guest"))["privileges"]
    assert {"variable": "guest_loss", "src_role": "guest",
            "dst_role": "arbiter"} not in rows and rows
