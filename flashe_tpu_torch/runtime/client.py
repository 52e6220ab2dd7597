"""HTTP client for the job server (fate_flow_client.py analogue; port of
flashe_tpu/runtime/client.py, which needs no JAX: the same JSON over the
same routes, so either package's client speaks to either server).

Thin urllib wrapper used by the CLI's --server paths: every fate_flow
client verb (`-f submit_job/query_job/stop_job/upload/...`,
fate_flow/fate_flow_client.py:196-225) maps to one small method here.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional


class ServerError(RuntimeError):
    pass


class FlasheClient:
    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              timeout: Optional[float] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:  # noqa: BLE001
                detail = ""
            raise ServerError(f"{method} {path}: HTTP {e.code} {detail}")
        except urllib.error.URLError as e:
            raise ServerError(f"cannot reach {self.base}: {e.reason}")

    # ---- job verbs ----
    def submit_job(self, dsl: dict, conf: dict, timeout: float = 900.0):
        return self._call("POST", "/v1/job/submit",
                          {"dsl": dsl, "conf": conf, "timeout": timeout})

    def query_job(self, job_id: str):
        return self._call("POST", "/v1/job/query", {"job_id": job_id})

    def stop_job(self, job_id: str):
        return self._call("POST", "/v1/job/stop", {"job_id": job_id})

    def list_jobs(self):
        return self._call("GET", "/v1/job/list")

    def job_result(self, job_id: str):
        return self._call("GET", f"/v1/job/result?job_id={job_id}")

    def wait_job(self, job_id: str, timeout: float = 900.0,
                 poll: float = 0.5):
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            rec = self.query_job(job_id)
            if rec["status"] not in ("waiting", "running"):
                return rec
            time.sleep(poll)
        raise TimeoutError(f"job {job_id} still running after {timeout}s")

    # ---- data / model verbs ----
    def upload(self, namespace: str, name: str, csv_text: str,
               label_index: int = 0, unlabeled: bool = False):
        return self._call("POST", "/v1/data/upload", {
            "namespace": namespace, "name": name, "csv": csv_text,
            "label_index": label_index, "unlabeled": unlabeled})

    def list_tables(self):
        return self._call("GET", "/v1/table/list")

    def table_info(self, namespace: str, name: str):
        return self._call(
            "GET", f"/v1/table/info?namespace={namespace}&name={name}")

    def delete_table(self, namespace: str, name: str):
        return self._call("POST", "/v1/table/delete",
                          {"namespace": namespace, "name": name})

    def download(self, namespace: str, name: str) -> str:
        """Table contents as CSV text (reference download access module)."""
        return self._call("POST", "/v1/data/download",
                          {"namespace": namespace, "name": name})["csv"]

    def job_log(self, job_id: str, task: str = None, tail: int = 0):
        q = f"job_id={job_id}" + (f"&task={task}" if task else "") + \
            (f"&tail={tail}" if tail else "")
        return self._call("GET", f"/v1/job/log?{q}")

    def job_config(self, job_id: str):
        return self._call("GET", f"/v1/job/config?job_id={job_id}")

    def list_models(self, namespace: str):
        return self._call("GET", f"/v1/model/list?namespace={namespace}")

    def bind_model(self, namespace: str, version: str):
        return self._call("POST", "/v1/model/bind",
                          {"namespace": namespace, "version": version})

    def version(self):
        return self._call("GET", "/v1/version")
