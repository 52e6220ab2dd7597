"""Package CLI (port of flashe_tpu/__main__.py).

    python -m flashe_tpu_torch submit -c examples/configs/cnn_flashe_q16_b1_pad.json
    python -m flashe_tpu_torch submit -c CFG --processes --publish NS --json
    python -m flashe_tpu_torch submit-dsl -d train_job_dsl.json -c train_job_conf.json
    python -m flashe_tpu_torch predict -c CFG --model NS[:VERSION]
    python -m flashe_tpu_torch keygen
    python -m flashe_tpu_torch serve --port 9380          # the job server
    python -m flashe_tpu_torch submit-dsl -d DSL -c CONF --server URL
    python -m flashe_tpu_torch cluster -c deploy/cluster_conf.yml --plan

One JSON config selects a workload (model, scheme, clients, data); a
FATE-style DSL and job conf pair runs through `submit-dsl` (a Keras
`nn_define` interpreted directly).  Without --processes a job runs in this
process, the guest, the hosts and the arbiter one thread each over the
in-memory federation (runtime/simulate.run_roles); with --processes each
party is an OS process of its own over the port's native C++ TCP broker
(runtime/job.py; csrc/fedbroker.cpp, built with g++ at first use, the
Python broker where it cannot be built).  Every party runs on the card, or on the CPU with --cpu;
every command takes --cpu, and none carries on on the CPU without it.
`submit` prints the arbiter's mean loss per round and the guest's phase
profile, or both as one JSON line with --json (with --processes also the
job's id, work directory and logs).  The profile is the host's clock; in
this process it does not synchronize the card, so a phase measures the
enqueue of its work and the device time lands in whichever later phase
waits on it (runtime/tracking.py); a party process synchronizes its own
work at each phase's ends.

The local stores: `jobs` / `query` / `stop` / `logs` (the job registry,
shared with the JAX package), `upload` / `download` / `tables` (the
dataset store, shared), `permission` (the privilege store, shared),
`models` / `bind` (the model store, the port's own: its checkpoints are
not the JAX package's; runtime/model_manager.py).  `board`, `tracking` and
`dag` read the registry too.  With --server URL each of these commands asks
a running job server instead (runtime/client.py); `serve` runs one
(runtime/server.py: each submitted DSL job one process a party, on the card
unless `serve --cpu`), and `queue` reads its job queue.  The cluster
deployment (runtime/cluster.py): `broker` runs the federation exchange
(the native C++ broker, or the Python one with --python), `party` one party of a job against it, `cluster` plans a cluster conf or
runs it on this machine.  `storage-node` runs a persistent storage node
(data/remote_kv.py: the native C++ server of csrc/kvserver.cpp, or the
python one with --python), which sessions bind with
`data.table.init(storage_addr=...)`; it is host code and touches no card.
`mesh-party` runs one client of the SPMD mesh federation
(parallel/mesh_party.py) in a torch.distributed group; `cluster --run-local`
of a mesh conf starts one a host on the local machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

def _client(args):
    """The job server's client where the command was given --server, else
    None (the local stores)."""
    if not getattr(args, "server", None):
        return None
    from flashe_tpu_torch.runtime.client import FlasheClient

    return FlasheClient(args.server)


def _device(args):
    from flashe_tpu_torch.device import resolve_device

    return resolve_device("cpu" if args.cpu else "cuda")


def _shards(cfg: dict, param):
    from flashe_tpu_torch.data import federated_dataset, partition_iid

    n_clients = cfg.get("n_clients", 3)
    dataset = cfg.get("dataset", param.model)
    if isinstance(dataset, dict):
        # an uploaded table: {"namespace": ..., "name": ...}
        from flashe_tpu_torch.data.store import default_store

        x, y, _meta = default_store().load(dataset["namespace"],
                                           dataset["name"])
        return partition_iid(x, y, n_clients, seed=cfg.get("seed", 0))
    return federated_dataset(dataset, n_clients,
                             cfg.get("samples_per_client", 128),
                             seed=cfg.get("seed", 0))


def cmd_submit(args) -> int:
    with open(args.config) as f:
        cfg = json.load(f)

    from flashe_tpu_torch.runtime.config import HomoNNParam

    device = _device(args)
    param = HomoNNParam.from_dict(cfg["param"])
    shards = _shards(cfg, param)
    out = {}
    if args.processes:
        import tempfile

        from flashe_tpu_torch.runtime.job import submit_job

        ckpt_dir = args.checkpoint_dir
        if args.publish and not ckpt_dir:
            ckpt_dir = tempfile.mkdtemp(prefix="flashe_publish_")
        results = submit_job(param, shards, checkpoint_dir=ckpt_dir,
                             device=device)
        losses = results["arbiter_0"]["loss_history"]
        phases = results["guest_0"]["phases"]
        job = results["__job__"]
        if args.publish:
            from flashe_tpu_torch.runtime.model_manager import (
                default_model_manager,
            )

            meta = default_model_manager().publish_checkpoint(
                args.publish, job["job_id"],
                os.path.join(ckpt_dir, "guest_0.ckpt"),
                param_dict=param.to_dict())
            print(json.dumps({"published": meta}), file=sys.stderr)
        out["guest_transfer"] = results["guest_0"]["transfer_stats"]
        out["job"] = job
    else:
        if args.checkpoint_dir or args.publish:
            raise SystemExit("--checkpoint-dir and --publish need "
                             "--processes")
        from flashe_tpu_torch.nn.homo_nn import (
            HomoNNArbiter, HomoNNGuest, HomoNNHost,
        )
        from flashe_tpu_torch.runtime.simulate import run_roles
        from flashe_tpu_torch.runtime.tracking import tracker

        def guest(trv):
            c = HomoNNGuest(param, seed=0, device=device)
            c.fit(trv, *shards[0])
            return {"history": c.history, "phases": tracker().summary()}

        def host(trv, hid):
            c = HomoNNHost(param, seed=1 + hid, device=device)
            c.fit(trv, *shards[1 + hid])
            return c.history

        def arbiter(trv):
            return HomoNNArbiter(param, device=device).fit(trv)

        results = run_roles(len(shards) - 1, guest, host, arbiter)
        losses = results["arbiter"]
        phases = results["guest"]["phases"]

    out = {
        "loss_per_round": [round(float(v), 6) for v in losses],
        "phases": {k: {"total_s": round(v["total_s"], 4),
                       "count": v["count"]}
                   for k, v in phases.items()},
        **out,
    }
    if args.json:
        print(json.dumps(out))
    else:
        print("mean loss per round:",
              [round(v, 4) for v in out["loss_per_round"]])
        print("guest phase profile:")
        for name, stat in out["phases"].items():
            print(f"  {name:<18} {stat['total_s']:8.3f}s x{stat['count']}")
    return 0


def cmd_submit_dsl(args) -> int:
    """FATE-style submission: -d train_job_dsl.json -c train_job_conf.json
    (fate_flow_client.py:196-225).  Reference job confs work unchanged —
    nn_define JSON is interpreted directly.  With --server the job runs
    on the server, on its device."""
    with open(args.dsl) as f:
        dsl = json.load(f)
    with open(args.config) as f:
        conf = json.load(f)
    client = _client(args)
    if client is not None:
        sub = client.submit_job(dsl, conf)
        job_id = sub["job_id"]
        if args.no_wait:
            print(json.dumps(sub))
            return 0
        rec = client.wait_job(job_id)
        res = client.job_result(job_id)
        print(json.dumps({"job_id": job_id, "status": rec["status"],
                          "result": res.get("result")},
                         indent=None if args.json else 1))
        return 0 if rec["status"] == "success" else 1
    device = _device(args)
    if args.processes:
        from flashe_tpu_torch.runtime.job import submit_dsl_job

        results = submit_dsl_job(dsl, conf, device=device)
    else:
        from flashe_tpu_torch.runtime.dsl import run_dsl_job

        results = run_dsl_job(dsl, conf, device=device)

    out = {}
    for role_key, res in results.items():
        if role_key == "__job__":
            out["job"] = res
            continue
        if not isinstance(res, dict):
            continue
        role_out = {}
        for comp, val in res.items():
            if isinstance(val, dict) and "loss_history" in val:
                role_out[comp] = {"loss_per_round": [
                    round(float(v), 6) for v in val["loss_history"]]}
            elif isinstance(val, dict) and "history" in val:
                role_out[comp] = {"final": val["history"][-1]
                                  if val["history"] else None}
            elif isinstance(val, dict) and "accuracy" in val:
                role_out[comp] = {k: (round(v, 6)
                                      if isinstance(v, float) else v)
                                  for k, v in val.items()}
        if role_out:
            out[role_key] = role_out
    print(json.dumps(out) if args.json else json.dumps(out, indent=1))
    return 0


def cmd_predict(args) -> int:
    import numpy as np

    with open(args.config) as f:
        cfg = json.load(f)

    from flashe_tpu_torch.nn.homo_nn import HomoNNGuest
    from flashe_tpu_torch.runtime.config import HomoNNParam

    device = _device(args)
    param = HomoNNParam.from_dict(cfg["param"])
    if args.csv:
        from flashe_tpu_torch.data.io import read_dense_csv

        x, y = read_dense_csv(args.csv,
                              label_index=None if args.unlabeled else 0)
    elif isinstance(cfg.get("dataset"), dict):
        from flashe_tpu_torch.data.store import default_store

        x, y, _meta = default_store().load(cfg["dataset"]["namespace"],
                                           cfg["dataset"]["name"])
    else:
        from flashe_tpu_torch.data import synthetic_dataset

        x, y = synthetic_dataset(cfg.get("dataset", param.model),
                                 cfg.get("samples_per_client", 128),
                                 seed=cfg.get("seed", 0))

    ckpt = args.checkpoint
    if ckpt is None:
        if not args.model:
            print("predict: one of --checkpoint / --model is required",
                  file=sys.stderr)
            return 2
        from flashe_tpu_torch.runtime.model_manager import (
            default_model_manager,
        )

        mm = default_model_manager()
        ns, _, ver = args.model.partition(":")
        try:
            ver = ver or mm.latest_version(ns)
        except KeyError as e:
            print(f"predict: {e.args[0]}", file=sys.stderr)
            return 2
        ckpt = mm.checkpoint_path(ns, ver)
    client = HomoNNGuest(param, device=device)
    client.load_model(ckpt, x[:1])
    preds = np.asarray(client.predict(x))
    labels = preds.argmax(axis=-1)
    if args.out:
        np.save(args.out, preds)
    result = {"n": int(len(x)), "aggregate_iter": client.aggregate_iter,
              "device": str(device)}
    if y is not None:
        result["accuracy"] = round(float((labels == y).mean()), 4)
    if args.out:
        result["out"] = args.out
    print(json.dumps(result))
    return 0


def cmd_keygen(args) -> int:
    print(os.urandom(32).hex())
    return 0


# -- job management (fate_flow_client -f query_job/stop_job analogues) ------


def cmd_jobs(args) -> int:
    client = _client(args)
    if client is not None:
        rows = client.list_jobs()
    else:
        from flashe_tpu_torch.runtime.job_manager import default_registry

        rows = default_registry().list_jobs()
    if args.json:
        print(json.dumps(rows))
        return 0
    for rec in rows:
        print(f"{rec['job_id']}  {rec['status']:<9} "
              f"tasks={len(rec.get('tasks', {}))}")
    return 0


def cmd_query(args) -> int:
    client = _client(args)
    if client is not None:
        rec = client.query_job(args.job_id)
    else:
        from flashe_tpu_torch.runtime.job_manager import default_registry

        rec = default_registry().query(args.job_id)
    print(json.dumps(rec, indent=1))
    return 0


def cmd_stop(args) -> int:
    client = _client(args)
    if client is not None:
        rec = client.stop_job(args.job_id)
    else:
        from flashe_tpu_torch.runtime.job_manager import default_registry

        rec = default_registry().stop(args.job_id)
    print(json.dumps({"job_id": rec["job_id"], "status": rec["status"]}))
    return 0


def cmd_logs(args) -> int:
    client = _client(args)
    if client is not None:
        logs = client.job_log(args.job_id, task=args.task, tail=args.tail)
    else:
        from flashe_tpu_torch.runtime.job_manager import default_registry

        logs = default_registry().read_log(args.job_id, task=args.task,
                                           tail=args.tail)
    for task, text in logs.items():
        print(f"===== {task} =====")
        print(text)
    return 0


def cmd_permission(args) -> int:
    """Privilege grant/revoke/query (permission_app analogue)."""
    if args.action in ("grant", "revoke") and not (
            args.variable and args.src_role and args.dst_role):
        raise SystemExit(
            "grant/revoke need --variable --src-role --dst-role")
    client = _client(args)
    if client is not None:
        if args.action == "query":
            out = client._call("POST", "/v1/permission/query/privilege",
                               {"src_role": args.src_role})
        else:
            route = ("/v1/permission/grant/privilege"
                     if args.action == "grant"
                     else "/v1/permission/delete/privilege")
            out = client._call("POST", route,
                               {"variable": args.variable,
                                "src_role": args.src_role,
                                "dst_role": args.dst_role})
    else:
        from flashe_tpu_torch.runtime.permission import (
            default_privilege_store,
        )

        store = default_privilege_store()
        if args.action == "query":
            out = {"privileges": store.query(args.src_role)}
        elif args.action == "grant":
            out = store.grant(args.variable, args.src_role, args.dst_role)
        else:
            out = store.revoke(args.variable, args.src_role,
                               args.dst_role)
    print(json.dumps(out, indent=1))
    return 0


# -- the job server and its views (fate_flow server, tracking, pipeline,
#    schedule apps and FATEBoard analogues) ----------------------------------


def cmd_serve(args) -> int:
    from flashe_tpu_torch.runtime.server import serve

    serve(args.host, args.port, device=_device(args))
    return 0


def cmd_board(args) -> int:
    """Terminal dashboard for one job (FATEBoard analogue)."""
    from flashe_tpu_torch.runtime.board import render_job

    client = _client(args)
    if client is not None:
        rec = client.query_job(args.job_id)
        result = client.job_result(args.job_id)
    else:
        from flashe_tpu_torch.runtime.apps import load_result
        from flashe_tpu_torch.runtime.job_manager import default_registry

        reg = default_registry()
        rec = reg.query(args.job_id)
        summary = load_result(reg, args.job_id)
        result = None if summary is None else {"result": summary}
    print(render_job(rec, result))
    return 0


def cmd_tracking(args) -> int:
    """Tracking queries (fate_flow tracking_app analogue)."""
    if args.what == "metric-data" and not args.component:
        raise SystemExit("metric-data needs --component")
    client = _client(args)
    if client is not None:
        if args.what == "data-view":
            out = client._call("POST", "/v1/tracking/job/data_view",
                               {"job_id": args.job_id})
        elif args.what == "metrics":
            out = client._call("POST", "/v1/tracking/component/metric/all",
                               {"job_id": args.job_id})
        else:
            out = client._call("POST",
                               "/v1/tracking/component/metric_data",
                               {"job_id": args.job_id,
                                "component_name": args.component,
                                "role": args.role,
                                "metric_name": args.metric})
    else:
        from flashe_tpu_torch.runtime import apps
        from flashe_tpu_torch.runtime.job_manager import default_registry

        reg = default_registry()
        if args.what == "data-view":
            out = apps.job_data_view(reg, args.job_id)
        elif args.what == "metrics":
            out = apps.metric_all(reg, args.job_id)
        else:
            out = apps.metric_data(reg, args.job_id, args.component,
                                   role=args.role, metric_name=args.metric)
    print(json.dumps(out, indent=1))
    return 0


def cmd_dag(args) -> int:
    """Pipeline DAG of a submitted DSL job (pipeline_app analogue)."""
    client = _client(args)
    if client is not None:
        out = client._call("POST", "/v1/pipeline/dag/dependency",
                           {"job_id": args.job_id})
    else:
        from flashe_tpu_torch.runtime import apps
        from flashe_tpu_torch.runtime.job_manager import default_registry

        out = apps.dag_dependency(default_registry(), args.job_id)
    print(json.dumps(out, indent=1))
    return 0


def cmd_queue(args) -> int:
    """Job queue of a running server (schedule_app analogue)."""
    print(json.dumps(_client(args)._call("GET", "/v1/schedule/queue"),
                     indent=1))
    return 0


# -- the cluster deployment (deployment/ analogue) ---------------------------


def cmd_broker(args) -> int:
    """Run the federation exchange standalone (proxy/route-table
    analogue): the port's native C++ broker, or with --python its Python
    one."""
    from flashe_tpu_torch.runtime.cluster import run_broker

    run_broker(args.host, args.port,
               native=False if args.python else "auto")
    return 0


def cmd_party(args) -> int:
    """Join a cluster job as one party from this machine."""
    host, _, port = args.broker.rpartition(":")
    if not host:
        print("party: --broker must be host:port", file=sys.stderr)
        return 2

    from flashe_tpu_torch.runtime.cluster import build_party_cfg, run_party

    dsl = conf = param = None
    n_hosts = None
    data = args.data
    if args.dsl:
        with open(args.dsl) as f:
            dsl = json.load(f)
        with open(args.config) as f:
            conf = json.load(f)
    else:
        with open(args.config) as f:
            job_cfg = json.load(f)
        param = job_cfg["param"]
        n_hosts = int(job_cfg.get("n_clients", 3)) - 1
        if data and data.endswith(".csv") and args.role != "arbiter":
            import tempfile

            import numpy as np

            from flashe_tpu_torch.data.io import read_dense_csv

            x, y = read_dense_csv(data)
            data = os.path.join(tempfile.mkdtemp(prefix="flashe_party_"),
                                "data.npz")
            np.savez(data, x=x, y=y)

    cfg = build_party_cfg(
        args.role, args.party_id, (host, int(port)), args.job_id,
        dsl=dsl, conf=conf, param=param, n_hosts=n_hosts, data=data,
        data_root=args.data_root, out=args.out,
        checkpoint=args.checkpoint, device="cpu" if args.cpu else "cuda")
    out = run_party(cfg)
    brief = {k: v for k, v in out.items()
             if k in ("role", "party_id", "device", "loss_history")}
    brief["out"] = cfg["out"]
    print(json.dumps(brief, default=str))
    return 0


def cmd_cluster(args) -> int:
    from flashe_tpu_torch.runtime.cluster import main as cluster_main

    argv = ["-c", args.config, "--timeout", str(args.timeout)]
    argv.append("--plan" if args.plan
                else "--run-local" if args.run_local else "--run")
    return cluster_main(argv + ["--cpu"] * args.cpu)


# -- model manager (fate_flow_client -f load/bind analogues) ----------------


def cmd_models(args) -> int:
    client = _client(args)
    if client is not None:
        listed = client.list_models(args.namespace)
        rows, bound = listed["versions"], listed["bound"]
    else:
        from flashe_tpu_torch.runtime.model_manager import (
            default_model_manager,
        )

        mm = default_model_manager()
        rows = mm.list_versions(args.namespace)
        bound = mm.bound_version(args.namespace)
    if args.json:
        print(json.dumps({"versions": rows, "bound": bound}))
        return 0
    for meta in rows:
        star = "*" if meta["version"] == bound else " "
        print(f"{star} {meta['namespace']}/{meta['version']}  "
              f"iter={meta['aggregate_iter']}")
    return 0


def cmd_bind(args) -> int:
    client = _client(args)
    if client is not None:
        out = client.bind_model(args.namespace, args.version)
    else:
        from flashe_tpu_torch.runtime.model_manager import (
            default_model_manager,
        )

        out = default_model_manager().bind(args.namespace, args.version)
    print(json.dumps(out))
    return 0


# -- data store (fate_flow_client -f upload/download analogues) -------------


def cmd_upload(args) -> int:
    client = _client(args)
    if client is not None:
        # the CSV's text travels in the body (the server's store)
        with open(args.file) as f:
            meta = client._call("POST", "/v1/data/upload", {
                "namespace": args.namespace, "name": args.name,
                "csv": f.read(), "label_index": args.label_index,
                "unlabeled": args.unlabeled,
                "has_header": not args.no_header,
                "partition": args.partition})
    else:
        from flashe_tpu_torch.data.store import default_store

        meta = default_store().upload_csv(
            args.file, args.namespace, args.name,
            label_index=None if args.unlabeled else args.label_index,
            has_header=not args.no_header, partition=args.partition)
    print(json.dumps(meta))
    return 0


def cmd_download(args) -> int:
    client = _client(args)
    if client is not None:
        with open(args.out, "w") as f:
            f.write(client.download(args.namespace, args.name))
        meta = client.table_info(args.namespace, args.name)
    else:
        from flashe_tpu_torch.data.store import default_store

        meta = default_store().download_csv(args.namespace, args.name,
                                            args.out)
    print(json.dumps({"namespace": meta["namespace"], "name": meta["name"],
                      "count": meta["count"], "out": args.out}))
    return 0


def cmd_tables(args) -> int:
    client = _client(args)
    if client is not None:
        rows = client.list_tables()
    else:
        from flashe_tpu_torch.data.store import default_store

        rows = default_store().list_tables()
    if args.json:
        print(json.dumps(rows))
        return 0
    for meta in rows:
        print(f"{meta['namespace']}.{meta['name']}  n={meta['count']} "
              f"features={meta['feature_shape']} labeled={meta['labeled']}")
    return 0


def cmd_storage_node(args) -> int:
    """Run a persistent storage node (eggroll storage-service analogue);
    sessions bind with data.table.init(storage_addr=...).  It prints which
    server runs (native or python) and its address, then serves until
    interrupted."""
    import time

    from flashe_tpu_torch.data.remote_kv import StorageNode

    node = StorageNode(args.dir, port=args.port, native=not args.python)
    kind = "native" if node.native else "python"
    print(f"storage node ({kind}) serving {args.dir} at {node.address}",
          flush=True)
    try:
        while True:
            if node._proc is not None and node._proc.poll() is not None:
                return node._proc.returncode or 0
            time.sleep(1.0)
    except KeyboardInterrupt:
        node.shutdown()
    return 0


def cmd_mesh_party(args) -> int:
    """One client process of an SPMD mesh federation
    (parallel/mesh_party.py; run one per host): on --device (the card by
    default) or the CPU with --cpu, in a group of --backend (NCCL on a
    card, gloo on the CPU, by default)."""
    from flashe_tpu_torch.parallel.mesh_party import run_mesh_training

    out = run_mesh_training(
        args.coordinator, args.num_processes, args.process_id,
        model=args.model, model_kwargs=json.loads(args.model_kwargs),
        rounds=args.rounds, samples=args.samples, data=args.data,
        learning_rate=args.learning_rate, int_bits=args.int_bits,
        verbose=args.verbose, device="cpu" if args.cpu else args.device,
        backend=args.backend)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flashe_tpu_torch",
        description="FLASHE secure-aggregation framework, PyTorch on CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cpu", action="store_true",
                        help="run every party on the CPU (default: the "
                             "card)")

    def command(name, fn, help_text, server=False):
        p = sub.add_parser(name, help=help_text, parents=[common])
        p.set_defaults(fn=fn)
        if server:
            p.add_argument("--server",
                           help="ask a running job server "
                                "(http://host:port) instead of the local "
                                "stores")
        return p

    p = command("submit", cmd_submit,
                "run a federated training job from a JSON config")
    p.add_argument("-c", "--config", required=True,
                   help="job config JSON (see examples/configs/)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable result on stdout")
    p.add_argument("--processes", action="store_true",
                   help="one OS process per party over the native "
                        "federation broker")
    p.add_argument("--checkpoint-dir",
                   help="with --processes: each client saves its final "
                        "model there (<role>_<id>.ckpt)")
    p.add_argument("--publish",
                   help="with --processes: register the guest's final model "
                        "in the model store under this namespace (version "
                        "= job id)")

    p = command("submit-dsl", cmd_submit_dsl,
                "run a FATE-style DSL job (-d dsl.json -c conf.json)",
                server=True)
    p.add_argument("-d", "--dsl", required=True,
                   help="component-DAG DSL JSON (train_job_dsl.json)")
    p.add_argument("-c", "--config", required=True,
                   help="job conf JSON (train_job_conf.json)")
    p.add_argument("--processes", action="store_true",
                   help="one OS process per party over the native "
                        "federation broker")
    p.add_argument("--json", action="store_true")
    p.add_argument("--no-wait", action="store_true",
                   help="with --server: return the job id immediately")

    p = command("predict", cmd_predict,
                "run predictions with a checkpointed model")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--checkpoint",
                   help="checkpoint written by submit --checkpoint-dir or "
                        "save_checkpoint")
    p.add_argument("--model",
                   help="stored model 'namespace[:version]' (default "
                        "version: the bound / newest one)")
    p.add_argument("--csv", help="dense CSV to predict on (default: the "
                                 "config's dataset)")
    p.add_argument("--unlabeled", action="store_true",
                   help="the CSV has no label column")
    p.add_argument("--out", help="write raw prediction scores (.npy)")

    command("keygen", cmd_keygen, "generate a fresh 256-bit PRP seed (hex)")

    p = command("broker", cmd_broker,
                "run the federation exchange standalone (one per cluster; "
                "parties dial it)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9370,
                   help="0 = ephemeral (the bound port is printed)")
    p.add_argument("--python", action="store_true",
                   help="force the pure-Python broker instead of the native "
                        "C++ one")

    p = command("party", cmd_party,
                "join a multi-host job as one party (run on each silo's "
                "machine)")
    p.add_argument("--broker", required=True,
                   help="host:port of the running broker")
    p.add_argument("--role", required=True,
                   choices=["guest", "host", "arbiter"])
    p.add_argument("--party-id", type=int, default=0,
                   help="host ordinal 0..n_hosts-1 (guest/arbiter: 0)")
    p.add_argument("--job-id", required=True,
                   help="shared across all parties of one job")
    p.add_argument("-d", "--dsl",
                   help="DSL JSON (DSL job; omit for a param job)")
    p.add_argument("-c", "--config", required=True,
                   help="job conf JSON (DSL) or job config with 'param' "
                        "(param job)")
    p.add_argument("--data", help="param jobs: this party's local training "
                                  "data (.npz x/y or .csv)")
    p.add_argument("--data-root",
                   help="DSL jobs: local dataset-store root the DataIO "
                        "component reads from")
    p.add_argument("--out", help="output pickle path")
    p.add_argument("--checkpoint", help="param jobs: save the final local "
                                        "model here")

    p = command("cluster", cmd_cluster,
                "expand/run a multi-host cluster conf "
                "(deploy/cluster_conf.yml)")
    p.add_argument("-c", "--config", required=True)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--plan", action="store_true",
                      help="print per-machine commands")
    mode.add_argument("--run", action="store_true",
                      help="execute through the conf's runner template")
    mode.add_argument("--run-local", action="store_true",
                      help="validate the conf on this machine (its parties "
                           "on the card unless the conf says cpu)")
    p.add_argument("--timeout", type=float, default=900.0)

    p = command("jobs", cmd_jobs, "list submitted jobs", server=True)
    p.add_argument("--json", action="store_true")
    for name, fn, help_text in (("query", cmd_query, "query a job's status"),
                                ("stop", cmd_stop, "stop a running job"),
                                ("board", cmd_board,
                                 "terminal job dashboard (FATEBoard "
                                 "analogue)"),
                                ("dag", cmd_dag,
                                 "pipeline DAG of a submitted DSL job")):
        p = command(name, fn, help_text, server=True)
        p.add_argument("-j", "--job-id", required=True)

    p = command("serve", cmd_serve,
                "run the HTTP job server (fate_flow server analogue)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9380,
                   help="0 = ephemeral (the bound address is printed)")

    p = command("logs", cmd_logs, "print a job's task logs", server=True)
    p.add_argument("-j", "--job-id", required=True)
    p.add_argument("--task", help="one task, e.g. guest_0")
    p.add_argument("--tail", type=int, default=0,
                   help="only the last N lines")

    p = command("tracking", cmd_tracking,
                "tracking queries (metrics/data-view)", server=True)
    p.add_argument("-j", "--job-id", required=True)
    p.add_argument("--what", default="metrics",
                   choices=["data-view", "metrics", "metric-data"])
    p.add_argument("--component")
    p.add_argument("--role")
    p.add_argument("--metric")

    p = command("permission", cmd_permission,
                "grant/revoke/query transfer privileges", server=True)
    p.add_argument("action", choices=["grant", "revoke", "query"])
    p.add_argument("--variable")
    p.add_argument("--src-role")
    p.add_argument("--dst-role")

    p = command("queue", cmd_queue, "job-queue status of a running server")
    p.add_argument("--server", required=True)

    p = command("upload", cmd_upload,
                "ingest a dense CSV into the dataset store", server=True)
    p.add_argument("-f", "--file", required=True)
    p.add_argument("-n", "--namespace", required=True)
    p.add_argument("-t", "--name", required=True)
    p.add_argument("--label-index", type=int, default=0)
    p.add_argument("--unlabeled", action="store_true")
    p.add_argument("--no-header", action="store_true")
    p.add_argument("--partition", type=int, default=1)

    p = command("download", cmd_download,
                "export a stored table back to CSV", server=True)
    p.add_argument("-n", "--namespace", required=True)
    p.add_argument("-t", "--name", required=True)
    p.add_argument("-o", "--out", required=True)

    p = command("tables", cmd_tables, "list stored tables", server=True)
    p.add_argument("--json", action="store_true")

    p = command("models", cmd_models, "list stored model versions",
                server=True)
    p.add_argument("-n", "--namespace", required=True)
    p.add_argument("--json", action="store_true")

    p = command("bind", cmd_bind,
                "mark a model version as the serving default", server=True)
    p.add_argument("-n", "--namespace", required=True)
    p.add_argument("-v", "--version", required=True)

    p = command("storage-node", cmd_storage_node,
                "run a persistent KV storage node (tables bind via "
                "storage_addr)")
    p.add_argument("--dir", required=True, help="storage root directory")
    p.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral (the bound port is printed)")
    p.add_argument("--python", action="store_true",
                   help="force the pure-Python server instead of the native "
                        "C++ one")

    p = command("mesh-party", cmd_mesh_party,
                "join an SPMD mesh federation as one client process "
                "(torch.distributed)")
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--model", default="mlp")
    p.add_argument("--model-kwargs", default="{}")
    p.add_argument("--samples", type=int, default=256,
                   help="synthetic samples when no --data shard is given")
    p.add_argument("--data", help="this process's private shard (.npz with "
                                  "x, y)")
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--int-bits", type=int, default=20)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="this process's card (default: the current one)")
    p.add_argument("--backend", choices=("nccl", "gloo"),
                   help="the process group's backend (default: nccl on a "
                        "card, gloo on the CPU; gloo where processes share "
                        "a card)")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
