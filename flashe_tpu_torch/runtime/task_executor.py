"""Per-(job, role, party) task executor process (port of
flashe_tpu/runtime/task_executor.py).

The analogue of fate_flow/driver/task_executor.py:39-160: the job runner
(runtime/job.py) spawns `python -m flashe_tpu_torch.runtime.task_executor
-c task.json` per role; the executor joins the federation over the
runner's broker, runs its HomoNN component or walks the DSL's component
DAG, and saves its outputs (history / loss curve / model checkpoint) for
the runner to collect.

The task config carries "device", "cuda" (also where it has none) or
"cpu", resolved with device.resolve_device: a task that asks for the card
on a host without one raises, and none carries on on the CPU by itself.

The output, a pickle at cfg["out"], holds numpy and Python values only,
never a tensor, so that the runner unpickles it without touching the card.
Besides what the JAX package's executor writes (role, party_id, history /
loss_history / cv or the DSL components' results, "phases",
"transfer_stats"), it holds what the port can report:
- "device": where the component's parameters lay (the arbiter's device for
  the arbiter);
- "mask_launches": ops/flashe_mask.mode_launches, the mask kernel's launches
  by mode in this process; "mont_launches": ops/montgomery.launches;
- "model_sha256": a digest of a client's final parameters (its flax names
  in sorted order and their float32 bytes), the same at every client that
  holds the same model bit for bit;
- "phase_log": every phase in the order it ended, (name, seconds), on the
  host clock with a synchronize of this process's card work at each
  phase's ends;
- "startup_s": seconds from the runner's spawn of this process (the
  config's "spawned_at") to its having imported its modules and joined the
  federation; the card's context is made later, in the first iteration;
- "peak_memory_bytes": torch.cuda.max_memory_allocated() (0 on the CPU).
chip_smoke.py reads these fields.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pickle
import time

import numpy as np
import torch

from flashe_tpu_torch.device import resolve_device
from flashe_tpu_torch.fed.tcp import TcpFederation
from flashe_tpu_torch.fed.transport import Party, default_parties
from flashe_tpu_torch.fed.variables import HomoTransferVariables
from flashe_tpu_torch.nn.homo_nn import HomoNNArbiter, HomoNNGuest, HomoNNHost
from flashe_tpu_torch.ops import flashe_mask, montgomery
from flashe_tpu_torch.runtime.checkpoint import _to_numpy, save_checkpoint
from flashe_tpu_torch.runtime.config import HomoNNParam
from flashe_tpu_torch.runtime.permission import effective_authorization
from flashe_tpu_torch.runtime.tracking import Tracker, set_tracker, tracker

__all__ = ["run_task", "main"]


def model_sha256(params) -> str:
    """sha256 over {flax name: tensor}: names sorted, float32 bytes."""
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(np.ascontiguousarray(
            params[name].detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _client_fields(client) -> dict:
    params = client.trainer.params
    return {"device": str(next(iter(params.values())).device),
            "model_sha256": model_sha256(params)}


def run_task(cfg: dict) -> dict:
    """Run one party's task; write its output to cfg["out"] and return
    it."""
    device = resolve_device(cfg.get("device", "cuda"))
    role = cfg["role"]
    party_id = cfg["party_id"]
    set_tracker(Tracker(f"{role}_{party_id}", synchronize=(
        torch.cuda.synchronize if device.type == "cuda" else None)))
    fed = TcpFederation(tuple(cfg["broker"]), cfg["job_id"],
                        Party(role, party_id),
                        default_parties(cfg["n_hosts"]),
                        effective_authorization())
    trv = HomoTransferVariables(fed)
    out = {"role": role, "party_id": party_id, "device": str(device)}
    if "spawned_at" in cfg:
        out["startup_s"] = time.time() - cfg["spawned_at"]

    if cfg.get("kind") == "dsl":
        # FATE-style component-DAG task (see runtime/dsl.py)
        from flashe_tpu_torch.data.store import DataStore
        from flashe_tpu_torch.runtime.dsl import (
            JobConf, arbiter_pipeline, client_pipeline, parse_dsl,
        )

        components = parse_dsl(cfg["dsl"])
        jc = JobConf.parse(cfg["conf"])
        store = DataStore(cfg["data_root"]) if cfg.get("data_root") else None
        if role == "arbiter":
            out.update(arbiter_pipeline(trv, components, jc, device))
        else:
            res = client_pipeline(trv, components, jc, role,
                                  cfg.get("ordinal", party_id), store,
                                  seed=cfg.get("seed", 0), device=device)
            client = res.pop("_client", None)
            out.update(res)
            if client is not None:
                out.update(_client_fields(client))
    elif role == "arbiter":
        param = HomoNNParam.from_dict(cfg["param"])
        if param.cv.need_cv:
            from flashe_tpu_torch.nn.cross_validation import cv_fit_arbiter

            out["cv"] = cv_fit_arbiter(HomoNNArbiter, param, trv,
                                       device=device)
        else:
            out["loss_history"] = HomoNNArbiter(param, device=device).fit(
                trv)
    else:
        param = HomoNNParam.from_dict(cfg["param"])
        with np.load(cfg["data"]) as data:
            x, y = data["x"], data["y"]
        cls = HomoNNGuest if role == "guest" else HomoNNHost
        if param.cv.need_cv:
            from flashe_tpu_torch.nn.cross_validation import cv_fit_client

            out["cv"] = cv_fit_client(cls, param, trv, x, y,
                                      seed=cfg.get("seed", 0), device=device)
        else:
            comp = cls(param, seed=cfg.get("seed", 0), device=device)
            comp.fit(trv, x, y)
            out["history"] = comp.history
            out.update(_client_fields(comp))
            if cfg.get("checkpoint"):
                save_checkpoint(cfg["checkpoint"], comp.trainer.params,
                                comp.aggregate_iter, quantizer_stats={})
    out["phases"] = tracker().summary()
    out["phase_log"] = list(tracker().phase_log)
    out["transfer_stats"] = fed.stats.summary()
    out["mask_launches"] = dict(flashe_mask.mode_launches)
    out["mont_launches"] = dict(montgomery.launches)
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out = _to_numpy(out)
    with open(cfg["out"], "wb") as f:
        pickle.dump(out, f)
    fed.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flashe_tpu_torch.runtime.task_executor",
        description="run one party's task of a job (started by the job "
                    "runner, runtime/job.py)")
    ap.add_argument("-c", "--config", required=True)
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    run_task(cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
