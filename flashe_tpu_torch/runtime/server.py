"""HTTP job server — the fate_flow server analogue (port of
flashe_tpu/runtime/server.py, which needs no JAX; the port keeps its own
copy over the port's registry, stores and job runner).

The reference exposes job orchestration over a Flask HTTP API
(fate_flow/fate_flow_server.py:57-126; apps: job/data/table/tracking/
model) that fate_flow_client.py talks to (`-f submit_job/query_job/
stop_job/upload/...`).  This module reproduces that control surface with
the stdlib ThreadingHTTPServer — no new dependencies, JSON in/out, the
JAX package's routes and bodies, so either package's client works against
either server:

    POST /v1/job/submit    {"dsl": ..., "conf": ...}   -> {"job_id": ...}
    POST /v1/job/query     {"job_id": ...}             -> registry record
    POST /v1/job/stop      {"job_id": ...}             -> {"status": ...}
    GET  /v1/job/list                                  -> [records]
    GET  /v1/job/result?job_id=                        -> summarized result
    POST /v1/data/upload   {"namespace","name","csv"}  -> table meta
    GET  /v1/table/list                                -> [table metas]
    GET  /v1/model/list?namespace=                     -> versions + bound
    POST /v1/model/bind    {"namespace","version"}     -> bind record
    GET  /v1/version                                   -> build info

Jobs run asynchronously through a bounded-concurrency queue (the
reference's DAGScheduler pulls submissions from a job queue with
MAX_CONCURRENT_JOB_RUN=5 workers, fate_flow_server.py:101,
settings.py:44; FLASHE_MAX_CONCURRENT_JOB_RUN here); excess submissions
wait in FIFO order with status "waiting".  query/result poll the
registry.  Each job runs through runtime/job.py::submit_dsl_job, one OS
process a party on the server's device: the card unless the server was
made with device="cpu" (`serve --cpu`).  The server process itself never
touches the card: the party outputs hold numpy and Python values only
(runtime/task_executor.py), and summarize_result turns them into JSON.

`close()` stops the HTTP server, cancels every job still waiting in the
queue (marked "canceled" in the registry, never run), and waits for the
jobs already running to end.  (The JAX copy queues its workers' shutdown
behind the waiting jobs, so those jobs still run after close() returns.)

Beyond the job/data/table/model groups above, the remaining fate_flow
app groups are served too (apps/{tracking,pipeline,permission,
schedule}_app.py):

    POST /v1/tracking/job/data_view          {"job_id"}
    POST /v1/tracking/component/metric/all   {"job_id"}
    POST /v1/tracking/component/metrics      {"job_id"}
    POST /v1/tracking/component/metric_data  {"job_id","component_name",
                                              "role"?, "metric_name"?}
    POST /v1/tracking/component/parameters   {"job_id","component_name",
                                              "role","ordinal"?}
    POST /v1/pipeline/dag/dependency         {"job_id"}
    GET  /v1/job/log?job_id=&task=&tail=     per-task log text
    GET  /v1/job/config?job_id=              submitted dsl + conf
    GET  /v1/table/info?namespace=&name=     one table's metadata
    POST /v1/table/delete                    {"namespace","name"}
    POST /v1/data/download                   {"namespace","name"} -> csv
    POST /v1/permission/grant/privilege      {"variable","src_role","dst_role"}
    POST /v1/permission/delete/privilege     {"variable","src_role","dst_role"}
    POST /v1/permission/query/privilege      {"src_role"?}
    GET  /v1/schedule/queue                  -> waiting/running/max_concurrent
"""

from __future__ import annotations

import json
import os
import queue
import threading
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.runtime.job_manager import JobRegistry, default_registry

__all__ = ["JobServer", "serve", "summarize_result"]


def summarize_result(results: dict) -> dict:
    """JSON-safe summary of per-role job outputs (loss curves, metrics,
    phase profiles) for the tracking/result endpoints and the board."""
    out = {}
    for key, res in results.items():
        if key == "__job__":
            out["job"] = res
            continue
        if not isinstance(res, dict):
            continue
        role_out = {}
        for comp, val in res.items():
            if not isinstance(val, dict):
                continue
            if "loss_history" in val:
                role_out[comp] = {"loss_history": [
                    float(v) for v in val["loss_history"]]}
            elif "history" in val:
                role_out[comp] = {"history": [
                    {k: (float(v) if isinstance(v, (int, float)) else v)
                     for k, v in h.items()} for h in val["history"]]}
            elif "accuracy" in val:  # evaluation metrics
                role_out[comp] = {
                    k: (float(v) if isinstance(v, (int, float)) else v)
                    for k, v in val.items()}
        if "phases" in res:
            role_out["phases"] = {
                k: {"total_s": float(v["total_s"]), "count": v["count"]}
                for k, v in res["phases"].items()}
        if res.get("transfer_stats"):
            role_out["transfer_stats"] = res["transfer_stats"]
        if "loss_history" in res:  # non-DSL arbiter output
            role_out["loss_history"] = [float(v)
                                        for v in res["loss_history"]]
        out[key] = role_out
    return out


class JobServer:
    """Serves the job API; submissions execute on worker threads, each
    job's parties on `device` (resolved once, here)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9380,
                 registry: Optional[JobRegistry] = None,
                 device="cuda",
                 max_concurrent: Optional[int] = None):
        self.device = str(resolve_device(device))
        self.registry = registry or default_registry()
        self.max_concurrent = int(
            max_concurrent
            if max_concurrent is not None
            else os.environ.get("FLASHE_MAX_CONCURRENT_JOB_RUN", "5"))
        self._queue: "queue.Queue" = queue.Queue()
        self._queue_lock = threading.Lock()
        self._waiting: list = []   # FIFO of queued job ids
        self._running: set = set()
        self._workers: list = []
        self._closing = False
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                if not n:
                    return {}
                return json.loads(self.rfile.read(n) or b"{}")

            def _reply_html(self, code: int, text: str):
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    url = urlparse(self.path)
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    page = server.handle_board(url.path)
                    if page is not None:
                        self._reply_html(200, page)
                        return
                    self._reply(200, server.handle_get(url.path, q))
                except KeyError as e:
                    self._reply(404, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 - API boundary
                    self._reply(500, {"error": str(e),
                                      "trace": traceback.format_exc()})

            def do_POST(self):
                try:
                    url = urlparse(self.path)
                    self._reply(200, server.handle_post(url.path,
                                                        self._body()))
                except KeyError as e:
                    self._reply(404, {"error": str(e)})
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 - API boundary
                    self._reply(500, {"error": str(e),
                                      "trace": traceback.format_exc()})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self.httpd.server_address

    # ------------------------------------------------------------ routing

    def handle_board(self, path: str) -> Optional[str]:
        """HTML views (FATEBoard analogue; see runtime/webboard.py).
        Returns None for non-board paths so JSON routing proceeds."""
        from flashe_tpu_torch.runtime import apps, webboard

        if path in ("/", "/board", "/board/"):
            return webboard.render_index_html(self.registry.list_jobs(),
                                              queue=self.queue_view())
        if path.startswith("/board/"):
            job_id = path[len("/board/"):].strip("/")
            rec = self.registry.query(job_id)  # KeyError -> 404
            result = None
            if os.path.exists(self._result_path(job_id)):
                result = self._load_result(job_id)
            # board pages consume the same tracking/pipeline views the
            # HTTP tracking endpoints serve (runtime/apps.py)
            tracking = {}
            try:
                tracking["dag"] = apps.dag_dependency(self.registry,
                                                      job_id)
            except (ValueError, KeyError):
                pass
            tracking["metrics"] = apps.metric_all(self.registry, job_id)
            return webboard.render_job_html(rec, result,
                                            tracking=tracking)
        return None

    def handle_get(self, path: str, q: dict):
        if path == "/v1/version":
            import flashe_tpu_torch

            return {"name": "flashe_tpu_torch",
                    "version": getattr(flashe_tpu_torch, "__version__",
                                       "0")}
        if path == "/v1/job/list":
            return self.registry.list_jobs()
        if path == "/v1/job/result":
            return self._load_result(q["job_id"])
        if path == "/v1/table/list":
            from flashe_tpu_torch.data.store import default_store

            return default_store().list_tables()
        if path == "/v1/model/list":
            from flashe_tpu_torch.runtime.model_manager import (
                default_model_manager,
            )

            mm = default_model_manager()
            ns = q["namespace"]
            return {"versions": mm.list_versions(ns),
                    "bound": mm.bound_version(ns)}
        if path == "/v1/schedule/queue":
            return self.queue_view()
        if path == "/v1/job/log":
            # reference job_app.py:112 /job/log (per-task log tree)
            return self.registry.read_log(
                q["job_id"], task=q.get("task"),
                tail=int(q.get("tail", 0)))
        if path == "/v1/job/config":
            # reference job_app.py:94 /job/config (submitted dsl + conf)
            rec = self.registry.query(q["job_id"])
            return {"job_id": q["job_id"], "dsl": rec.get("dsl"),
                    "conf": rec.get("conf")}
        if path == "/v1/table/info":
            # reference table_app.py:52 /table/table_info
            from flashe_tpu_torch.data.store import default_store

            for t in default_store().list_tables():
                if (t["namespace"] == q["namespace"]
                        and t["name"] == q["name"]):
                    return t
            raise KeyError(
                f"no table {q['namespace']}.{q['name']}")
        raise KeyError(f"no route GET {path}")

    def handle_post(self, path: str, body: dict):
        if path == "/v1/job/submit":
            return self._submit(body)
        if path == "/v1/job/query":
            return self.registry.query(body["job_id"])
        if path == "/v1/job/stop":
            rec = self.registry.stop(body["job_id"])
            return {"job_id": rec["job_id"], "status": rec["status"]}
        if path == "/v1/data/upload":
            return self._upload(body)
        if path == "/v1/model/bind":
            from flashe_tpu_torch.runtime.model_manager import (
                default_model_manager,
            )

            return default_model_manager().bind(body["namespace"],
                                                body["version"])
        if path == "/v1/table/delete":
            # reference table_app.py:33 /table/delete
            from flashe_tpu_torch.data.store import default_store

            ok = default_store().delete(body["namespace"], body["name"])
            return {"namespace": body["namespace"],
                    "name": body["name"], "deleted": bool(ok)}
        if path == "/v1/data/download":
            # reference data_access_app.py:36 download: table -> CSV text
            import tempfile

            from flashe_tpu_torch.data.store import default_store

            with tempfile.NamedTemporaryFile("r", suffix=".csv",
                                             delete=False) as f:
                out_path = f.name
            try:
                default_store().download_csv(body["namespace"],
                                             body["name"], out_path)
                with open(out_path) as f:
                    csv_text = f.read()
            finally:
                os.unlink(out_path)
            return {"namespace": body["namespace"], "name": body["name"],
                    "csv": csv_text}
        if path.startswith("/v1/tracking/"):
            return self._handle_tracking(path, body)
        if path == "/v1/pipeline/dag/dependency":
            from flashe_tpu_torch.runtime import apps

            return apps.dag_dependency(self.registry, body["job_id"])
        if path.startswith("/v1/permission/"):
            return self._handle_permission(path, body)
        raise KeyError(f"no route POST {path}")

    def _handle_tracking(self, path: str, body: dict):
        from flashe_tpu_torch.runtime import apps

        if path == "/v1/tracking/job/data_view":
            return apps.job_data_view(self.registry, body["job_id"])
        if path == "/v1/tracking/component/metric/all":
            return apps.metric_all(self.registry, body["job_id"])
        if path == "/v1/tracking/component/metrics":
            return apps.metric_names(self.registry, body["job_id"])
        if path == "/v1/tracking/component/metric_data":
            return apps.metric_data(
                self.registry, body["job_id"], body["component_name"],
                role=body.get("role"),
                metric_name=body.get("metric_name"))
        if path == "/v1/tracking/component/parameters":
            return apps.component_parameters(
                self.registry, body["job_id"], body["component_name"],
                body["role"], int(body.get("ordinal", 0)))
        raise KeyError(f"no route POST {path}")

    def _handle_permission(self, path: str, body: dict):
        from flashe_tpu_torch.runtime.permission import (
            default_privilege_store,
        )

        store = default_privilege_store()
        if path == "/v1/permission/grant/privilege":
            return store.grant(body["variable"], body["src_role"],
                               body["dst_role"])
        if path == "/v1/permission/delete/privilege":
            return store.revoke(body["variable"], body["src_role"],
                                body["dst_role"])
        if path == "/v1/permission/query/privilege":
            return {"privileges": store.query(body.get("src_role"))}
        raise KeyError(f"no route POST {path}")

    # ------------------------------------------------------------ actions

    def _result_path(self, job_id: str) -> str:
        return os.path.join(self.registry.root, job_id, "result.json")

    def _load_result(self, job_id: str) -> dict:
        rec = self.registry.query(job_id)  # raises KeyError if unknown
        path = self._result_path(job_id)
        if not os.path.exists(path):
            return {"job_id": job_id, "status": rec["status"],
                    "result": None}
        with open(path) as f:
            return {"job_id": job_id, "status": rec["status"],
                    "result": json.load(f)}

    def _submit(self, body: dict) -> dict:
        if "dsl" not in body or "conf" not in body:
            raise ValueError("submit body needs 'dsl' and 'conf'")
        from flashe_tpu_torch.runtime.dsl import JobConf, parse_dsl

        parse_dsl(body["dsl"])  # validate synchronously: bad DSL -> 400
        jc = JobConf.parse(body["conf"])
        job_id = uuid.uuid4().hex[:12]
        # create the record BEFORE returning, so an immediate query works
        # (submit_dsl_job re-creates it with the full metadata once a
        # worker picks the job up); dsl/conf are stored for the
        # tracking/pipeline endpoints even while waiting; under the lock,
        # so that no job is queued once close() has begun
        with self._queue_lock:
            if self._closing:
                raise RuntimeError("the job server is closing")
            self.registry.create(job_id, {"n_hosts": jc.n_hosts,
                                          "dsl": body["dsl"],
                                          "conf": body["conf"],
                                          "queued": True,
                                          "status": "waiting"})
            self._waiting.append(job_id)
        self._queue.put((job_id, body))
        self._ensure_workers()
        return {"job_id": job_id, "status": "waiting"}

    # ------------------------------------------------- job queue workers

    def _ensure_workers(self):
        with self._queue_lock:
            need = self.max_concurrent - len(self._workers)
            for i in range(need):
                t = threading.Thread(
                    target=self._worker,
                    name=f"job-worker-{len(self._workers)}", daemon=True)
                self._workers.append(t)
                t.start()

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is None:  # close() sentinel
                return
            job_id, body = item
            # claiming a job and close()'s cancel of the waiting ones
            # exclude each other: a job is either run or canceled
            with self._queue_lock:
                claimed = job_id in self._waiting
                if claimed:
                    self._waiting.remove(job_id)
                    self._running.add(job_id)
            if not claimed:
                continue  # canceled by close() while queued
            try:
                if self.registry.query(job_id)["status"] == "waiting":
                    self._run_job(job_id, body)
                # else: stopped while queued, never starts
            except KeyError:
                pass
            finally:
                with self._queue_lock:
                    self._running.discard(job_id)

    def _run_job(self, job_id: str, body: dict):
        from flashe_tpu_torch.runtime.job import submit_dsl_job

        try:
            results = submit_dsl_job(
                body["dsl"], body["conf"], registry=self.registry,
                job_id=job_id, device=self.device,
                timeout=float(body.get("timeout", 900.0)))
        except Exception as e:  # noqa: BLE001 - record terminal state
            try:
                if self.registry.query(job_id)["status"] == "running":
                    self.registry.finish(job_id, "failed", str(e))
            except KeyError:
                pass
            return
        # atomic write: tracking endpoints and board refreshes read this
        # file concurrently and must never see a torn JSON document
        path = self._result_path(job_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(summarize_result(results), f)
        os.replace(tmp, path)

    def queue_view(self) -> dict:
        with self._queue_lock:
            return {"max_concurrent": self.max_concurrent,
                    "waiting": list(self._waiting),
                    "running": sorted(self._running)}

    def _upload(self, body: dict) -> dict:
        import numpy as np

        from flashe_tpu_torch.data.io import read_dense_csv
        from flashe_tpu_torch.data.store import default_store

        store = default_store()
        tmp = None
        if "csv" in body:  # inline CSV text
            import tempfile

            with tempfile.NamedTemporaryFile(
                    "w", suffix=".csv", delete=False) as f:
                f.write(body["csv"])
                tmp = path = f.name
        else:
            path = body["path"]
        label_index = body.get("label_index", 0)
        try:
            x, y = read_dense_csv(
                path,
                label_index=None if body.get("unlabeled") else label_index,
                has_header=body.get("has_header", True))
        finally:
            if tmp is not None:
                os.unlink(tmp)
        return store.put(body["namespace"], body["name"],
                         np.asarray(x), y,
                         partition=int(body.get("partition", 1)))

    # ----------------------------------------------------------- lifecycle

    def start(self):
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="flashe-http",
            daemon=True)
        self._serve_thread.start()
        return self

    def close(self):
        """Stop serving, cancel every waiting job (it never runs), then
        wait for the running jobs to end."""
        with self._queue_lock:
            self._closing = True
            waiting, self._waiting = self._waiting, []
            workers = list(self._workers)
        for job_id in waiting:
            try:
                if self.registry.query(job_id)["status"] == "waiting":
                    self.registry.stop(job_id)
            except KeyError:
                pass
        if self._serve_thread is not None:  # serve() runs its own loop
            self.httpd.shutdown()
        self.httpd.server_close()
        for _ in workers:
            self._queue.put(None)  # behind the queued items, now skipped
        for t in workers:
            t.join()


def serve(host: str = "127.0.0.1", port: int = 9380, device="cuda"):
    """Run the job server in the foreground (the `serve` CLI command).
    Prints the address it bound (`--port 0` takes a free one); on an
    interrupt it closes: waiting jobs are canceled, running ones end."""
    server = JobServer(host, port, device=device)
    bound_host, bound_port = server.address[:2]
    print(f"flashe_tpu_torch job server on http://{bound_host}:{bound_port}"
          f" (jobs on {server.device})", flush=True)
    try:
        server.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
