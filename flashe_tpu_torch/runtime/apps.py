"""Tracking / pipeline HTTP app backends (port of
flashe_tpu/runtime/apps.py over the port's JobRegistry and runtime/dsl.py).

The reference's fate_flow splits its HTTP surface into app modules
(fate_flow/apps/: tracking_app.py, pipeline_app.py, permission_app.py,
schedule_app.py ...).  This module holds the read-side view functions for
the tracking and pipeline groups — pure functions over the job registry
and the persisted per-job result.json — which runtime/server.py routes
to, and the webboard consumes (one implementation for HTTP clients and
HTML views alike):

- job data_view        (tracking_app.py:44-63  /job/data_view)
- component metric/all (tracking_app.py:66-86  /component/metric/all)
- component metrics    (tracking_app.py:88-99  /component/metrics)
- component metric_data(tracking_app.py:101-113 /component/metric_data)
- component parameters (tracking_app.py:135-157 /component/parameters)
- dag dependency       (pipeline_app.py:30-41  /dag/dependency)
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from flashe_tpu_torch.runtime.job_manager import JobRegistry

__all__ = ["load_result", "job_data_view", "metric_all", "metric_names",
           "metric_data", "component_parameters", "dag_dependency"]


def load_result(registry: JobRegistry, job_id: str) -> Optional[dict]:
    """The summarized result.json written on job completion (or None
    while the job is still queued/running)."""
    registry.query(job_id)  # raises KeyError for unknown jobs
    path = os.path.join(registry.root, job_id, "result.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def job_data_view(registry: JobRegistry, job_id: str) -> dict:
    """Job-level view: status, per-task states, party layout, and the
    dataset/partition info the reference's data_view reports."""
    rec = registry.query(job_id)
    view = {
        "job_id": job_id,
        "status": rec.get("status"),
        "created": rec.get("created"),
        "updated": rec.get("updated"),
        "n_hosts": rec.get("n_hosts"),
        "tasks": {name: t.get("status", "running")
                  for name, t in rec.get("tasks", {}).items()},
    }
    if rec.get("error"):
        view["error"] = rec["error"]
    conf = rec.get("conf")
    if isinstance(conf, dict):
        view["roles"] = conf.get("role", {})
        args = {}
        for role, rp in conf.get("role_parameters", {}).items():
            data = rp.get("args", {}).get("data", {})
            if data:
                args[role] = data
        if args:
            view["dataset"] = args
    return view


def _component_series(role_out: dict) -> Dict[str, Dict[str, list]]:
    """{component -> {metric_name -> [[step, value], ...]}} from one
    role's summarized output."""
    comps: Dict[str, Dict[str, list]] = {}
    for comp, val in role_out.items():
        if not isinstance(val, dict):
            continue
        series: Dict[str, list] = {}
        if "loss_history" in val:
            series["loss"] = [[i, float(v)]
                              for i, v in enumerate(val["loss_history"])]
        elif "history" in val:
            for i, row in enumerate(val["history"]):
                for k, v in row.items():
                    if isinstance(v, (int, float)):
                        series.setdefault(k, []).append([i, float(v)])
        elif comp not in ("phases", "transfer_stats"):
            # evaluation-style flat metrics: single-point series
            for k, v in val.items():
                if isinstance(v, (int, float)):
                    series[k] = [[0, float(v)]]
        if series:
            comps[comp] = series
    # the non-DSL arbiter writes loss_history at the top level
    if "loss_history" in role_out:
        comps.setdefault("train", {})["loss"] = [
            [i, float(v)] for i, v in enumerate(role_out["loss_history"])]
    return comps


def metric_all(registry: JobRegistry, job_id: str) -> dict:
    """Every metric series, keyed role_party -> component -> metric."""
    result = load_result(registry, job_id) or {}
    out = {}
    for role_key, role_out in result.items():
        if not isinstance(role_out, dict) or role_key == "job":
            continue
        comps = _component_series(role_out)
        if comps:
            out[role_key] = comps
    return out


def metric_names(registry: JobRegistry, job_id: str) -> dict:
    """role_party -> component -> [metric names] (tracking 'metrics')."""
    return {rk: {comp: sorted(series)
                 for comp, series in comps.items()}
            for rk, comps in metric_all(registry, job_id).items()}


def metric_data(registry: JobRegistry, job_id: str, component_name: str,
                role: Optional[str] = None,
                metric_name: Optional[str] = None) -> dict:
    """Data points for one component (optionally one role / metric)."""
    out = {}
    for role_key, comps in metric_all(registry, job_id).items():
        if role is not None and not role_key.startswith(role):
            continue
        series = comps.get(component_name)
        if not series:
            continue
        if metric_name is not None:
            if metric_name not in series:
                continue
            out[role_key] = {metric_name: series[metric_name]}
        else:
            out[role_key] = series
    return out


def component_parameters(registry: JobRegistry, job_id: str,
                         component_name: str, role: str,
                         ordinal: int = 0) -> dict:
    """The resolved runtime parameters of one component for one party
    (algorithm_parameters overlaid with role_parameters — the same merge
    the executors run with; reference component_parameters re-runs the
    runtime-conf merge the same way)."""
    from flashe_tpu_torch.runtime.dsl import JobConf

    rec = registry.query(job_id)
    conf = rec.get("conf")
    if not isinstance(conf, dict):
        raise ValueError(f"job {job_id} has no stored runtime conf")
    jc = JobConf.parse(conf)
    return {"job_id": job_id, "component_name": component_name,
            "role": role, "ordinal": ordinal,
            "parameters": jc.component_param(component_name, role, ordinal)}


def dag_dependency(registry: JobRegistry, job_id: str) -> dict:
    """Component DAG of a submitted DSL job: topologically-ordered
    component list plus per-component upstream dependencies (the shape
    fate_flow's dsl_parser.get_dependency returns to FATEBoard)."""
    from flashe_tpu_torch.runtime.dsl import parse_dsl

    rec = registry.query(job_id)
    dsl = rec.get("dsl")
    if not isinstance(dsl, dict):
        raise ValueError(f"job {job_id} has no stored DSL (param-mode job)")
    comps = parse_dsl(dsl)
    deps: Dict[str, List[str]] = {}
    for c in comps:
        ups = sorted({r.split(".", 1)[0] for r in c.input_refs()
                      if not r.startswith("args.")})
        deps[c.name] = ups
    return {
        "component_list": [c.name for c in comps],
        "component_module": {c.name: c.module for c in comps},
        "dependencies": deps,
    }
