"""Job runner: submit a federated training job across OS processes (port
of flashe_tpu/runtime/job.py, over the port's native FedBroker).

The library-sized replacement for fate_flow's JobController/TaskScheduler
(fate_flow/driver/job_controller.py:42, task_scheduler.py:286-315): start
the federation broker (fed/tcp.py: the native C++ exchange, a child
process that ends with this one, or the Python one where it cannot be
built), write per-party task configs and data shards, spawn one
task-executor process per (role, party) (`python -m
flashe_tpu_torch.runtime.task_executor`, with its working directory at the
repository root), watch liveness, collect outputs.  Kill-job semantics: any dead child aborts the rest (the
reference's job_detector / kill-file watch), and a job stopped before it
starts spawns nothing.

Every party runs on `device`, the card unless the caller asks for the CPU
(device="cpu"); each executor resolves it itself and raises where no card
is present.  On the card all the parties share it, each process with its
own context.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Sequence, Tuple

import numpy as np

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.fed.tcp import FedBroker
from flashe_tpu_torch.runtime.config import HomoNNParam
from flashe_tpu_torch.runtime.job_manager import JobRegistry, default_registry

__all__ = ["submit_job", "submit_dsl_job", "JobCanceled", "EXECUTOR"]

EXECUTOR = "flashe_tpu_torch.runtime.task_executor"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class JobCanceled(RuntimeError):
    """The job was stopped via the registry (stop_job analogue)."""


def _run_party_processes(job_id: str, reg: JobRegistry, workdir: str,
                         task_cfgs: List[dict], timeout: float) -> None:
    """Spawn one task-executor process per config and watch liveness.

    Each cfg must carry "role"/"party_id"/"out"; the broker's address is
    added by the caller.  Raises on timeout, cancellation or task failure
    (TaskScheduler.check_task_status / kill_job semantics)."""
    procs: List[subprocess.Popen] = []
    names: Dict[int, str] = {}
    status, err = "success", ""
    try:
        for cfg in task_cfgs:
            task = f"{cfg['role']}_{cfg['party_id']}"
            cfg_path = os.path.join(workdir, task + ".json")
            cfg["spawned_at"] = time.time()
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            log_path = os.path.join(reg.log_dir(job_id), task + ".log")
            with open(log_path, "ab") as logf:
                proc = subprocess.Popen(
                    [sys.executable, "-m", EXECUTOR, "-c", cfg_path],
                    stdout=logf, stderr=subprocess.STDOUT, cwd=_REPO)
            procs.append(proc)
            names[proc.pid] = task
            reg.set_task(job_id, task, proc.pid)

        deadline = time.time() + timeout
        pending = list(procs)
        while pending:
            if time.time() > deadline:
                raise TimeoutError(f"job {job_id} timed out")
            if reg.is_canceled(job_id):
                raise JobCanceled(f"job {job_id} was stopped")
            for p in list(pending):
                rc = p.poll()
                if rc is None:
                    continue
                pending.remove(p)
                reg.set_task_status(job_id, names[p.pid],
                                    "success" if rc == 0 else "failed")
                if rc != 0:
                    log = os.path.join(reg.log_dir(job_id),
                                       names[p.pid] + ".log")
                    raise RuntimeError(f"job {job_id}: task {names[p.pid]} "
                                       f"failed rc={rc} (log: {log})")
            time.sleep(0.2)
    except BaseException as e:
        status = ("canceled" if isinstance(e, JobCanceled)
                  else "timeout" if isinstance(e, TimeoutError)
                  else "failed")
        err = str(e)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        reg.finish(job_id, status, err)


def _run(job_id: str, reg: JobRegistry, workdir: str, roles, make_cfg,
         timeout: float) -> Dict[str, dict]:
    """One executor per (role, party id, extra) in `roles` over a broker
    of this process; make_cfg(i, role, pid, extra, broker) -> its task
    config.  Returns {"<role>_<pid>": its output} and "__job__", which
    names the broker the job ran over ("native" or "python")."""
    if reg.is_canceled(job_id):
        # stopped while queued (create() preserved the cancel): never
        # spawn any executor
        raise JobCanceled(f"job {job_id} was stopped before it started")
    broker = FedBroker()
    outs = {}
    try:
        cfgs = []
        for i, (role, pid, extra) in enumerate(roles):
            cfg = make_cfg(i, role, pid, extra, list(broker.address))
            cfg["out"] = os.path.join(workdir, f"{role}_{pid}.out")
            cfgs.append(cfg)
            outs[f"{role}_{pid}"] = cfg["out"]
        _run_party_processes(job_id, reg, workdir, cfgs, timeout)
    finally:
        broker.close()

    results = {"__job__": {"job_id": job_id, "workdir": workdir,
                           "logs": reg.log_dir(job_id),
                           "broker": ("native" if broker.native
                                      else "python")}}
    for key, path in outs.items():
        with open(path, "rb") as f:
            results[key] = pickle.load(f)
    return results


def submit_job(param: HomoNNParam,
               shards: Sequence[Tuple[np.ndarray, np.ndarray]],
               workdir: str | None = None,
               timeout: float = 900.0,
               checkpoint_dir: str | None = None,
               registry: JobRegistry | None = None,
               job_id: str | None = None,
               device="cuda") -> Dict[str, dict]:
    """Run guest + hosts + arbiter as subprocesses; return per-role outputs.

    shards[0] is the guest's data; shards[1:] go to hosts.  Party i of
    guest, hosts, arbiter trains with seed i (the guest 0, host h 1 + h).
    checkpoint_dir: each client saves its final model + aggregate_iter
    there as <role>_<party>.ckpt (reference save_output_model analogue).
    Job state + per-task logs persist under the registry (`python -m
    flashe_tpu_torch jobs/query/stop/logs`).
    """
    param.check()
    device = str(resolve_device(device))
    job_id = job_id or uuid.uuid4().hex[:12]
    n_hosts = len(shards) - 1
    workdir = workdir or tempfile.mkdtemp(prefix=f"flashe_job_{job_id}_")
    os.makedirs(workdir, exist_ok=True)
    reg = registry or default_registry()
    reg.create(job_id, {"param": param.to_dict(), "n_hosts": n_hosts,
                        "workdir": workdir, "device": device})

    roles = [("guest", 0, shards[0])]
    roles += [("host", h, shards[1 + h]) for h in range(n_hosts)]
    roles += [("arbiter", 0, None)]

    def make_cfg(i, role, pid, shard, broker):
        cfg = {"job_id": job_id, "role": role, "party_id": pid,
               "n_hosts": n_hosts, "broker": broker,
               "param": param.to_dict(), "seed": i, "device": device}
        if shard is not None:
            cfg["data"] = os.path.join(workdir, f"{role}_{pid}.npz")
            np.savez(cfg["data"], x=shard[0], y=shard[1])
            if checkpoint_dir:
                os.makedirs(checkpoint_dir, exist_ok=True)
                cfg["checkpoint"] = os.path.join(checkpoint_dir,
                                                 f"{role}_{pid}.ckpt")
        return cfg

    return _run(job_id, reg, workdir, roles, make_cfg, timeout)


def submit_dsl_job(dsl: dict, conf: dict,
                   workdir: str | None = None,
                   timeout: float = 900.0,
                   registry: JobRegistry | None = None,
                   data_root: str | None = None,
                   job_id: str | None = None,
                   device="cuda") -> Dict[str, dict]:
    """Run a FATE-style DSL job with one OS process per (role, party).

    The process-mode counterpart of runtime/dsl.py::run_dsl_job — the
    full fate_flow shape: submit(dsl, conf) -> per-party task executors
    over the federation broker, each walking the component DAG
    (task_scheduler.py:133-315).  data_root overrides the dataset-store
    location the executors read DataIO tables from.
    """
    from flashe_tpu_torch.runtime.dsl import JobConf, parse_dsl

    parse_dsl(dsl)  # validate before spawning anything
    jc = JobConf.parse(conf)
    device = str(resolve_device(device))
    job_id = job_id or uuid.uuid4().hex[:12]
    workdir = workdir or tempfile.mkdtemp(prefix=f"flashe_job_{job_id}_")
    os.makedirs(workdir, exist_ok=True)
    reg = registry or default_registry()
    reg.create(job_id, {"dsl": dsl, "conf": conf, "n_hosts": jc.n_hosts,
                        "workdir": workdir, "device": device})

    roles = [("guest", 0, 0)]
    roles += [("host", h, h) for h in range(jc.n_hosts)]
    roles += [("arbiter", 0, 0)]

    def make_cfg(i, role, pid, ordinal, broker):
        cfg = {"job_id": job_id, "kind": "dsl", "role": role,
               "party_id": pid, "ordinal": ordinal, "n_hosts": jc.n_hosts,
               "broker": broker, "dsl": dsl, "conf": conf, "seed": i,
               "device": device}
        if data_root:
            cfg["data_root"] = data_root
        return cfg

    return _run(job_id, reg, workdir, roles, make_cfg, timeout)
