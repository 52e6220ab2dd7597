"""Persistent job registry: query / stop / logs for submitted jobs (port of
flashe_tpu/runtime/job_manager.py, which needs no JAX; the port keeps its
own copy).

The analogue of fate_flow's job bookkeeping (fate_flow/driver/
job_controller.py state machine in MySQL, `fate_flow_client -f
query_job/stop_job` and the per-job log tree logs/<job_id>/<role>/...,
arch/api/utils/log_utils.py:25-166).  Here a job is a directory of JSON
status + per-task log files; `stop` kills the exact recorded PIDs (never
patterns), mirroring TaskScheduler.kill_job (task_scheduler.py:430).

The registry is shared with the JAX package: the same JSON layout under the
same root (FLASHE_JOBS_DIR, else ~/.flashe_tpu/jobs), so either package's
`jobs` / `query` / `stop` / `logs` sees both packages' jobs.

A job id or task name becomes a path under the root, so every one that
comes in from a caller must match [A-Za-z0-9_.-]+ and be neither "." nor
"..": `query("../x")` or `read_log(job, task="../../etc/passwd")` raise
ValueError instead of reading outside the registry.
"""

from __future__ import annotations

import json
import os
import re
import signal
import time
from typing import Dict, List, Optional

__all__ = ["JobRegistry", "default_registry"]

_TERMINAL = ("success", "failed", "canceled", "timeout")
_ID = re.compile(r"[A-Za-z0-9_.-]+")


def _safe(part: str, what: str) -> str:
    if (not isinstance(part, str) or not _ID.fullmatch(part)
            or part in (".", "..")):
        raise ValueError(f"invalid {what} {part!r}: must match "
                         "[A-Za-z0-9_.-]+ and not be . or ..")
    return part


class JobRegistry:
    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(
            "FLASHE_JOBS_DIR",
            os.path.join(os.path.expanduser("~"), ".flashe_tpu", "jobs"))

    def _dir(self, job_id: str) -> str:
        return os.path.join(self.root, _safe(job_id, "job id"))

    def _status_path(self, job_id: str) -> str:
        return os.path.join(self._dir(job_id), "job.json")

    def log_dir(self, job_id: str) -> str:
        return os.path.join(self._dir(job_id), "logs")

    # -- lifecycle (called by the job runner) -------------------------------

    def create(self, job_id: str, meta: dict) -> dict:
        os.makedirs(self.log_dir(job_id), exist_ok=True)
        rec = {
            "job_id": job_id,
            "status": "running",
            "created": time.time(),
            "updated": time.time(),
            "tasks": {},  # "<role>_<party>" -> {"pid": int, "status": str}
        }
        rec.update(meta)
        try:
            # a stop() that raced this re-create must not be erased: a
            # queued job canceled between the scheduler's status check
            # and the runner's create would otherwise run to completion
            if self.query(job_id)["status"] == "canceled":
                rec["status"] = "canceled"
        except (KeyError, json.JSONDecodeError):
            pass
        self._write(job_id, rec)
        return rec

    def _write(self, job_id: str, rec: dict):
        rec["updated"] = time.time()
        tmp = self._status_path(job_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(tmp, self._status_path(job_id))

    def set_task(self, job_id: str, task: str, pid: int,
                 status: str = "running"):
        rec = self.query(job_id)
        rec["tasks"][_safe(task, "task")] = {"pid": pid, "status": status}
        self._write(job_id, rec)

    def set_task_status(self, job_id: str, task: str, status: str):
        rec = self.query(job_id)
        if task in rec["tasks"]:
            rec["tasks"][task]["status"] = status
            self._write(job_id, rec)

    def finish(self, job_id: str, status: str, error: str = ""):
        rec = self.query(job_id)
        # a cancel that raced the runner's own failure path wins
        if rec["status"] == "canceled" and status != "success":
            status = "canceled"
        rec["status"] = status
        if error:
            rec["error"] = error
        for t in rec["tasks"].values():
            if t["status"] == "running":
                t["status"] = status
        self._write(job_id, rec)

    # -- client surface ------------------------------------------------------

    def query(self, job_id: str) -> dict:
        path = self._status_path(job_id)
        if not os.path.exists(path):
            raise KeyError(f"unknown job {job_id} under {self.root}")
        with open(path) as f:
            return json.load(f)

    def list_jobs(self) -> List[dict]:
        out = []
        if not os.path.isdir(self.root):
            return out
        for job_id in sorted(os.listdir(self.root)):
            try:
                out.append(self.query(job_id))
            except (KeyError, ValueError):  # JSONDecodeError included
                continue
        return out

    def stop(self, job_id: str) -> dict:
        """Kill every recorded live task PID (exact PIDs only)."""
        rec = self.query(job_id)
        if rec["status"] in _TERMINAL:
            return rec
        rec["status"] = "canceled"
        for t in rec["tasks"].values():
            if t["status"] != "running":
                continue
            try:
                os.kill(t["pid"], signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            t["status"] = "canceled"
        self._write(job_id, rec)
        return rec

    def is_canceled(self, job_id: str) -> bool:
        try:
            return self.query(job_id)["status"] == "canceled"
        except (KeyError, json.JSONDecodeError):
            return False

    def read_log(self, job_id: str, task: Optional[str] = None,
                 tail: int = 0) -> Dict[str, str]:
        """Per-task log text; task=None returns every task's log."""
        d = self.log_dir(job_id)
        out = {}
        names = ([_safe(task, "task") + ".log"] if task
                 else sorted(os.listdir(d)) if os.path.isdir(d) else [])
        for fn in names:
            path = os.path.join(d, fn)
            if not os.path.exists(path):
                raise KeyError(f"no log {fn} for job {job_id}")
            with open(path, errors="replace") as f:
                text = f.read()
            if tail:
                text = "\n".join(text.splitlines()[-tail:])
            out[fn[:-4]] = text
        return out


def default_registry() -> JobRegistry:
    return JobRegistry()
