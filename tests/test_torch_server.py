"""PyTorch port: the HTTP job server and its apps on the CPU — the server
(runtime/server.py), its client (runtime/client.py), the tracking and
pipeline views (runtime/apps.py) and both boards (runtime/board.py,
runtime/webboard.py), held against the JAX package.

- summarize_result, render_job, render_index_html and render_job_html equal
  the JAX functions' output on the same records and results, and every
  apps.* view the JAX view over one registry directory.
- The JAX client against the port's server, and the port's client against
  the JAX server, on every route that runs no job: the stores all three
  share (jobs, tables, privileges) and the port's model store.
- 400 and 404; the bounded job queue; close() cancels the jobs still
  waiting, which never run, and waits for the running one.
- One MLP DSL job over HTTP, one process a party on the CPU, whose losses
  equal the port's submit_dsl_job of the same DSL; the CLI's --server
  commands, `board`, `tracking` and `dag` on it.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from flashe_tpu.runtime import apps as japps
from flashe_tpu.runtime import board as jboard
from flashe_tpu.runtime import webboard as jwebboard
from flashe_tpu.runtime.client import FlasheClient as JClient
from flashe_tpu.runtime.client import ServerError as JServerError
from flashe_tpu.runtime.job_manager import JobRegistry as JRegistry
from flashe_tpu.runtime.server import JobServer as JJobServer
from flashe_tpu.runtime.server import summarize_result as jsummarize
from flashe_tpu_torch.__main__ import main as cli_main
from flashe_tpu_torch.data.store import DataStore
from flashe_tpu_torch.runtime import apps, board, webboard
from flashe_tpu_torch.runtime import job as pjob
from flashe_tpu_torch.runtime.client import FlasheClient, ServerError
from flashe_tpu_torch.runtime.job_manager import JobRegistry
from flashe_tpu_torch.runtime.model_manager import ModelManager
from flashe_tpu_torch.runtime.server import JobServer, summarize_result

from test_dsl import DSL, make_conf, mlp_define

CONF = make_conf([{"namespace": "ns", "name": "g"},
                  {"namespace": "ns", "name": "h"}],
                 {"model": "mlp", "batch_size": 16, "max_iter": 2,
                  "secure_aggregate": "flashe"})
CONF["role_parameters"]["host"]["homo_nn_0"] = {"batch_size": [8]}

# a job's outputs as the party processes leave them: numpy scalars and
# arrays beside Python values
OUTPUTS = {
    "__job__": {"job_id": "tjob", "workdir": "/w", "logs": "/w/logs"},
    "arbiter_0": {"role": "arbiter", "party_id": 0, "device": "cpu",
                  "homo_nn_0": {"loss_history": [np.float64(2.0), 1.5,
                                                 np.float32(1.0)]},
                  "phases": {"collect": {"total_s": np.float64(1.0),
                                         "count": 3}},
                  "transfer_stats": {"__total__": {"sent_msgs": 3,
                                                   "sent_bytes": 999}},
                  "mask_launches": {"double": 0}},
    "guest_0": {"role": "guest", "party_id": 0,
                "homo_nn_0": {"history": [
                    {"iter": 0, "loss": 2.1, "acc": 0.5},
                    {"iter": 1, "loss": np.float64(1.4), "acc": 0.8}]},
                "evaluation_0": {"accuracy": 0.9, "auc": 0.95, "n": 32,
                                 "name": "binary"},
                "dataio_0": {"n": 32},
                "phases": {"encryption": {"total_s": 1.5, "count": 2}},
                "model_sha256": "ab"},
    "host_0": {"loss_history": [2.2, 1.6], "transfer_stats": {}},
    "ignored": [1, 2],
}


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Every store of both packages under tmp_path."""
    for var, sub in (("FLASHE_JOBS_DIR", "jobs"), ("FLASHE_DATA_DIR", "data"),
                     ("FLASHE_TORCH_MODELS_DIR", "models"),
                     ("FLASHE_MODELS_DIR", "jax_models"),
                     ("FLASHE_PERMISSIONS_PATH", "permissions.json")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    return tmp_path


def _url(srv) -> str:
    return f"http://{srv.address[0]}:{srv.address[1]}"


@pytest.fixture
def port_server(stores):
    srv = JobServer("127.0.0.1", 0, device="cpu").start()
    yield srv
    srv.close()


def _seed_job(reg, job_id="tjob", dsl=DSL, conf=CONF):
    meta = {"n_hosts": 1}
    if dsl is not None:
        meta.update(dsl=dsl, conf=conf)
    reg.create(job_id, meta)
    reg.set_task(job_id, "guest_0", pid=1, status="success")
    with open(os.path.join(reg.root, job_id, "result.json"), "w") as f:
        json.dump(summarize_result(OUTPUTS), f)
    reg.finish(job_id, "success")
    return job_id

# -- pure functions against the JAX package -----------------------------------


def test_summarize_result_matches_jax():
    got = summarize_result(OUTPUTS)
    assert got == jsummarize(OUTPUTS)
    assert json.loads(json.dumps(got)) == got
    assert got["arbiter_0"]["homo_nn_0"]["loss_history"] == [2.0, 1.5, 1.0]
    assert got["host_0"] == {"loss_history": [2.2, 1.6]}
    assert "ignored" not in got and got["job"]["job_id"] == "tjob"


_RECORDS = {
    "finished": ({"job_id": "j1", "status": "success", "created": 900.0,
                  "updated": 990.0,
                  "tasks": {"guest_0": {"status": "success", "pid": 1},
                            "arbiter_0": {"status": "success", "pid": 2}}},
                 {"result": summarize_result(OUTPUTS)}),
    "failed": ({"job_id": "j2", "status": "failed", "created": -7000.0,
                "updated": 0, "error": "task host_0 failed rc=1 <&>",
                "tasks": {"host_0": {"status": "failed", "pid": 3}}}, None),
    "waiting": ({"job_id": "j3", "status": "waiting", "created": None,
                 "updated": 500.0, "tasks": {}}, {"result": None}),
}


@pytest.mark.parametrize("name", sorted(_RECORDS))
def test_boards_match_jax(name, monkeypatch):
    """The terminal board, the index page and the job page render the same
    text as the JAX package's (its clock fixed for both)."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    rec, result = _RECORDS[name]
    assert board.render_job(rec, result) == jboard.render_job(rec, result)
    summary = summarize_result(OUTPUTS)
    tracking = {"dag": {"component_list": ["dataio_0", "homo_nn_0"],
                        "component_module": {"dataio_0": "DataIO",
                                             "homo_nn_0": "JZFHomoNN"},
                        "dependencies": {"dataio_0": [],
                                         "homo_nn_0": ["dataio_0"]}},
                "metrics": {k: apps._component_series(summary[k])
                            for k in ("guest_0", "arbiter_0")}}
    for trk in (None, tracking):
        assert webboard.render_job_html(rec, result, tracking=trk) == \
            jwebboard.render_job_html(rec, result, tracking=trk)
    recs = [r for r, _ in _RECORDS.values()]
    queue = {"max_concurrent": 5, "waiting": ["j3"], "running": ["j1"]}
    for q in (None, queue):
        assert webboard.render_index_html(recs, queue=q) == \
            jwebboard.render_index_html(recs, queue=q)
    assert webboard.render_index_html([]) == jwebboard.render_index_html([])
    values = [3.0, 1.0, 2.0] * 40
    assert board.sparkline(values) == jboard.sparkline(values)


_VIEWS = {
    "load_result": lambda m, reg: m.load_result(reg, "tjob"),
    "job_data_view": lambda m, reg: m.job_data_view(reg, "tjob"),
    "metric_all": lambda m, reg: m.metric_all(reg, "tjob"),
    "metric_names": lambda m, reg: m.metric_names(reg, "tjob"),
    "metric_data": lambda m, reg: m.metric_data(reg, "tjob", "homo_nn_0"),
    "metric_data role": lambda m, reg: m.metric_data(
        reg, "tjob", "homo_nn_0", role="arbiter", metric_name="loss"),
    "metric_data train": lambda m, reg: m.metric_data(reg, "tjob", "train"),
    "component_parameters guest": lambda m, reg: m.component_parameters(
        reg, "tjob", "homo_nn_0", "guest"),
    "component_parameters host": lambda m, reg: m.component_parameters(
        reg, "tjob", "homo_nn_0", "host", 0),
    "dag_dependency": lambda m, reg: m.dag_dependency(reg, "tjob"),
    "failed job": lambda m, reg: m.job_data_view(reg, "failing"),
    "no result yet": lambda m, reg: (m.load_result(reg, "queued"),
                                     m.metric_all(reg, "queued")),
}


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_apps_views_match_jax(view, tmp_path):
    """Every tracking / pipeline view over one registry directory (a
    hand-written result.json) equals the JAX view."""
    reg = JobRegistry(str(tmp_path))
    _seed_job(reg)
    reg.create("failing", {"conf": CONF})
    reg.finish("failing", "failed", "boom")
    reg.create("queued", {"status": "waiting"})
    got = _VIEWS[view](apps, reg)
    assert got == _VIEWS[view](japps, JRegistry(str(tmp_path)))
    assert got == (None, {}) if view == "no result yet" else got


def test_apps_refusals_match_jax(tmp_path):
    reg = JobRegistry(str(tmp_path))
    _seed_job(reg, "param", dsl=None)
    for m, r in ((apps, reg), (japps, JRegistry(str(tmp_path)))):
        with pytest.raises(ValueError, match="no stored DSL"):
            m.dag_dependency(r, "param")
        with pytest.raises(ValueError, match="no stored runtime conf"):
            m.component_parameters(r, "param", "homo_nn_0", "guest")
        with pytest.raises(KeyError):
            m.metric_all(r, "nope")

# -- the wire: either client against either server -----------------------------


@pytest.mark.parametrize("pair", ["jax client, port server",
                                  "port client, jax server"])
def test_clients_and_servers_interoperate(pair, stores):
    if pair == "jax client, port server":
        srv = JobServer("127.0.0.1", 0, device="cpu").start()
        client, error, name = JClient(_url(srv)), JServerError, \
            "flashe_tpu_torch"
    else:
        srv = JJobServer("127.0.0.1", 0, force_cpu=True).start()
        client, error, name = FlasheClient(_url(srv)), ServerError, \
            "flashe_tpu"
    try:
        v = client.version()
        assert set(v) == {"name", "version"} and v["name"] == name
        meta = client.upload("wire", "t1", "y,f0,f1\n0,1.0,2.0\n1,3.0,4.0\n")
        assert meta["count"] == 2 and meta["labeled"]
        assert [(t["namespace"], t["name"]) for t in client.list_tables()] \
            == [("wire", "t1")]
        assert client.table_info("wire", "t1")["count"] == 2
        lines = client.download("wire", "t1").strip().splitlines()
        assert lines[0].split(",")[0] == "y" and len(lines) == 3
        x, y, _ = DataStore().load("wire", "t1")
        np.testing.assert_array_equal(x, [[1.0, 2.0], [3.0, 4.0]])
        np.testing.assert_array_equal(y, [0, 1])
        assert client.delete_table("wire", "t1")["deleted"]
        with pytest.raises(error, match="404"):
            client.table_info("wire", "t1")

        q = client._call("POST", "/v1/permission/query/privilege",
                         {"src_role": "guest"})
        assert {"variable": "guest_loss", "src_role": "guest",
                "dst_role": "arbiter"} in q["privileges"]
        client._call("POST", "/v1/permission/delete/privilege",
                     {"variable": "guest_loss", "src_role": "guest",
                      "dst_role": "arbiter"})
        q = client._call("POST", "/v1/permission/query/privilege", {})
        assert {"variable": "guest_loss", "src_role": "guest",
                "dst_role": "arbiter"} not in q["privileges"]

        assert client.list_models("none") == {"versions": [], "bound": None}
        assert client._call("GET", "/v1/schedule/queue") == {
            "max_concurrent": 5, "waiting": [], "running": []}
        _seed_job(JobRegistry())
        assert [r["job_id"] for r in client.list_jobs()] == ["tjob"]
        assert client.query_job("tjob")["status"] == "success"
        assert client.job_config("tjob")["dsl"] == DSL
        assert client.job_result("tjob")["result"] == \
            summarize_result(OUTPUTS)
        with pytest.raises(error, match="404"):
            client.query_job("nope")
    finally:
        srv.close()


def test_port_model_store_over_http(port_server):
    """models / bind reach the port's own model store."""
    ModelManager().save("ns", "v1", {"w": np.ones(3, np.float32)}, 1)
    client = FlasheClient(_url(port_server))
    assert [m["version"] for m in client.list_models("ns")["versions"]] == \
        ["v1"]
    assert client.bind_model("ns", "v1") == {"namespace": "ns",
                                             "bound": "v1"}
    assert client.list_models("ns")["bound"] == "v1"


@pytest.mark.parametrize("method,path,body,code", [
    ("GET", "/v1/nosuch", None, 404),
    ("POST", "/v1/nosuch", {}, 404),
    ("POST", "/v1/job/query", {"job_id": "missing"}, 404),
    ("GET", "/v1/job/result?job_id=missing", None, 404),
    ("GET", "/board/missing", None, 404),
    ("POST", "/v1/tracking/nosuch", {"job_id": "x"}, 404),
    ("POST", "/v1/job/submit", {"dsl": DSL}, 400),
    ("POST", "/v1/job/submit", {"dsl": {"components": {
        "a": {"module": "Bogus"}}}, "conf": CONF}, 400),
    ("POST", "/v1/job/submit", {"dsl": DSL, "conf": {
        "role": {"guest": [1]}}}, 400),
])
def test_error_codes(port_server, method, path, body, code):
    req = urllib.request.Request(
        _url(port_server) + path, method=method,
        data=None if body is None else json.dumps(body).encode())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == code
    assert json.loads(e.value.read())["error"]


def test_web_board_pages(port_server):
    _seed_job(port_server.registry)
    base = _url(port_server)
    page = urllib.request.urlopen(f"{base}/", timeout=10)
    assert page.headers["Content-Type"].startswith("text/html")
    assert "queue: 0 running / 0 waiting" in page.read().decode()
    text = urllib.request.urlopen(f"{base}/board/tjob",
                                  timeout=10).read().decode()
    for part in ("job tjob", "pipeline DAG", "JZFHomoNN", "tracked metrics",
                 "loss per round", "guest_0"):
        assert part in text

# -- the job queue ----------------------------------------------------------------


def _fake_runs(monkeypatch, release):
    started = []

    def fake_run(self, job_id, body):
        started.append(job_id)
        rec = self.registry.query(job_id)
        rec["status"] = "running"
        self.registry._write(job_id, rec)
        release.wait(timeout=30)
        self.registry.finish(job_id, "success")

    monkeypatch.setattr(JobServer, "_run_job", fake_run)
    return started


def _wait(cond, timeout=15.0):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError("condition not reached in time")
        time.sleep(0.02)


def test_job_queue_bounded_concurrency(stores, monkeypatch):
    """Submissions beyond max_concurrent wait in FIFO order; stopping a
    waiting job dequeues it without running (DAGScheduler +
    MAX_CONCURRENT_JOB_RUN semantics, fate_flow_server.py:101)."""
    release = threading.Event()
    started = _fake_runs(monkeypatch, release)
    srv = JobServer("127.0.0.1", 0, device="cpu", max_concurrent=1).start()
    try:
        client = FlasheClient(_url(srv))
        jids = [client.submit_job(DSL, CONF)["job_id"] for _ in range(3)]
        _wait(lambda: started)
        assert started == [jids[0]]
        qv = client._call("GET", "/v1/schedule/queue")
        assert qv == {"max_concurrent": 1, "running": [jids[0]],
                      "waiting": jids[1:]}
        assert client.query_job(jids[1])["status"] == "waiting"
        client.stop_job(jids[1])
        release.set()
        _wait(lambda: client.query_job(jids[2])["status"] == "success")
        assert [client.query_job(j)["status"] for j in jids] == [
            "success", "canceled", "success"]
        assert started == [jids[0], jids[2]]
    finally:
        release.set()
        srv.close()


def test_env_sets_max_concurrent(stores, monkeypatch):
    monkeypatch.setenv("FLASHE_MAX_CONCURRENT_JOB_RUN", "2")
    srv = JobServer("127.0.0.1", 0, device="cpu")
    try:
        assert srv.queue_view()["max_concurrent"] == 2
    finally:
        srv.close()


def test_close_cancels_waiting_jobs(stores, monkeypatch):
    """close() marks every waiting job canceled at once (it never runs),
    lets the running one finish, and takes no job after."""
    release = threading.Event()
    started = _fake_runs(monkeypatch, release)
    srv = JobServer("127.0.0.1", 0, device="cpu", max_concurrent=1).start()
    client = FlasheClient(_url(srv))
    jids = [client.submit_job(DSL, CONF)["job_id"] for _ in range(3)]
    _wait(lambda: started)
    closer = threading.Thread(target=srv.close)
    try:
        closer.start()
        reg = JobRegistry()
        _wait(lambda: all(reg.query(j)["status"] == "canceled"
                          for j in jids[1:]))
        assert srv.queue_view()["waiting"] == []
        assert reg.query(jids[0])["status"] == "running"
        assert closer.is_alive()  # waits for the running job
    finally:
        release.set()
        closer.join(timeout=30)
    assert not closer.is_alive()
    assert started == [jids[0]]
    assert [reg.query(j)["status"] for j in jids] == [
        "success", "canceled", "canceled"]
    assert all(reg.query(j)["tasks"] == {} for j in jids[1:])
    with pytest.raises(RuntimeError, match="closing"):
        srv._submit({"dsl": DSL, "conf": CONF})
    assert [r["job_id"] for r in reg.list_jobs()] == sorted(jids)

# -- a real job over HTTP -----------------------------------------------------------


def _mlp_job(stores):
    store = DataStore()
    rng = np.random.RandomState(7)
    tables = []
    for i in range(2):
        store.put("t", f"p{i}", rng.randn(32, 8).astype(np.float32),
                  rng.randint(0, 3, 32).astype(np.int64))
        tables.append({"namespace": "t", "name": f"p{i}"})
    return make_conf(tables, {
        "config_type": "keras", "nn_define": mlp_define(8, 12, 3),
        "batch_size": 16, "max_iter": 1, "secure_aggregate": "flashe"})


def _cli(capsys, *argv):
    assert cli_main(list(argv)) == 0
    return capsys.readouterr().out


def test_dsl_job_over_http_matches_submit_dsl_job(port_server, stores,
                                                  capsys):
    """An MLP DSL job (guest, host, arbiter: 3 processes on the CPU)
    submitted over HTTP: its losses equal the port's direct
    submit_dsl_job; the tracking views, the board and the CLI's --server
    commands read it."""
    conf = _mlp_job(stores)
    paths = {}
    for name, obj in (("dsl", DSL), ("conf", conf)):
        paths[name] = str(stores / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    url = _url(port_server)
    out = json.loads(_cli(capsys, "submit-dsl", "-d", paths["dsl"], "-c",
                          paths["conf"], "--server", url, "--json"))
    job_id = out["job_id"]
    assert out["status"] == "success"
    rec = JobRegistry().query(job_id)
    assert rec["device"] == "cpu"
    assert {t: v["status"] for t, v in rec["tasks"].items()} == {
        "guest_0": "success", "host_0": "success", "arbiter_0": "success"}
    losses = out["result"]["arbiter_0"]["homo_nn_0"]["loss_history"]

    direct = pjob.submit_dsl_job(DSL, conf, device="cpu", timeout=300)
    want = direct["arbiter_0"]["homo_nn_0"]["loss_history"]
    assert len(losses) == 1
    np.testing.assert_allclose(losses, want, rtol=1e-6, atol=0)

    view = json.loads(_cli(capsys, "tracking", "-j", job_id, "--what",
                           "data-view", "--server", url))
    assert view["tasks"] == {t: "success" for t in rec["tasks"]}
    metric = json.loads(_cli(capsys, "tracking", "-j", job_id, "--what",
                             "metric-data", "--component", "homo_nn_0",
                             "--role", "arbiter", "--metric", "loss",
                             "--server", url))
    assert metric == {"arbiter_0": {"loss": [[0, losses[0]]]}}
    local = json.loads(_cli(capsys, "tracking", "-j", job_id))
    assert local == json.loads(_cli(capsys, "tracking", "-j", job_id,
                                    "--server", url))
    assert set(local) == {"arbiter_0", "guest_0", "host_0"}
    dag = json.loads(_cli(capsys, "dag", "-j", job_id, "--server", url))
    assert dag["component_list"] == ["dataio_0", "homo_nn_0", "evaluation_0"]
    for argv in (["board", "-j", job_id], ["board", "-j", job_id,
                                           "--server", url]):
        text = _cli(capsys, *argv)
        assert f"job {job_id}  [success]" in text and "arbiter_0" in text
    logs = _cli(capsys, "logs", "-j", job_id, "--server", url)
    assert "===== guest_0 =====" in logs
    assert json.loads(_cli(capsys, "queue", "--server", url))["running"] == []
    rows = json.loads(_cli(capsys, "jobs", "--server", url, "--json"))
    assert job_id in [r["job_id"] for r in rows]


def test_cli_store_commands_over_http(port_server, stores, capsys):
    url = _url(port_server)
    csv = stores / "in.csv"
    csv.write_text("1,0.5,2.0\n0,1.5,-1.0\n")
    meta = json.loads(_cli(capsys, "upload", "-f", str(csv), "-n", "ns",
                           "-t", "tb", "--no-header", "--server", url))
    assert meta["count"] == 2
    assert json.loads(_cli(capsys, "tables", "--json", "--server", url)
                      )[0]["name"] == "tb"
    out_csv = str(stores / "out.csv")
    got = json.loads(_cli(capsys, "download", "-n", "ns", "-t", "tb", "-o",
                          out_csv, "--server", url))
    assert got == {"namespace": "ns", "name": "tb", "count": 2,
                   "out": out_csv}
    assert len(open(out_csv).read().strip().splitlines()) == 3
    rows = json.loads(_cli(capsys, "permission", "query", "--src-role",
                           "host", "--server", url))["privileges"]
    assert rows and all(r["src_role"] == "host" for r in rows)
    ModelManager().save("m", "v1", {"w": np.ones(2, np.float32)}, 1)
    assert json.loads(_cli(capsys, "bind", "-n", "m", "-v", "v1", "--server",
                           url)) == {"namespace": "m", "bound": "v1"}
    assert json.loads(_cli(capsys, "models", "-n", "m", "--json",
                           "--server", url))["bound"] == "v1"
    _seed_job(JobRegistry(), "q1")
    assert json.loads(_cli(capsys, "query", "-j", "q1", "--server", url)
                      )["status"] == "success"
    assert json.loads(_cli(capsys, "stop", "-j", "q1", "--server", url)) == \
        {"job_id": "q1", "status": "success"}
