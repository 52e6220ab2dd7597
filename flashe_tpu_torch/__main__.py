"""Package CLI (port of flashe_tpu/__main__.py's `submit`).

    python -m flashe_tpu_torch submit -c examples/configs/cnn_flashe_q16_b1_pad.json
    python -m flashe_tpu_torch submit -c examples/configs/mlp_flashe.json --cpu --json

One JSON config selects the workload (model, scheme, clients, data).  The
job runs in this process: the guest, the hosts and the arbiter one thread
each over the in-memory federation (runtime/simulate.run_roles), every role
on the card, or on the CPU with --cpu.  It prints the arbiter's mean loss
per round and the guest's phase profile, or both as one JSON line with
--json.  The profile is the host's clock and does not synchronize the card:
on the card a phase measures the enqueue of its work, and the device time
lands in whichever later phase waits on it (runtime/tracking.py).
The JAX CLI's other subcommands and options are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys

_LATER = "is not ported yet (ROADMAP.md, queue 1, item 4: the runtime)"


def cmd_submit(args) -> int:
    for flag, name in ((args.processes, "--processes"),
                       (args.publish, "--publish"),
                       (args.checkpoint_dir, "--checkpoint-dir")):
        if flag:
            raise NotImplementedError(f"{name} {_LATER}")
    with open(args.config) as f:
        cfg = json.load(f)

    from flashe_tpu_torch.data import federated_dataset
    from flashe_tpu_torch.device import resolve_device
    from flashe_tpu_torch.nn.homo_nn import (
        HomoNNArbiter, HomoNNGuest, HomoNNHost,
    )
    from flashe_tpu_torch.runtime.config import HomoNNParam
    from flashe_tpu_torch.runtime.simulate import run_roles
    from flashe_tpu_torch.runtime.tracking import tracker

    device = resolve_device("cpu" if args.cpu else "cuda")
    param = HomoNNParam.from_dict(cfg["param"])
    n_clients = cfg.get("n_clients", 3)
    dataset = cfg.get("dataset", param.model)
    if isinstance(dataset, dict):
        raise NotImplementedError(f"a dataset given as a table {_LATER}")
    shards = federated_dataset(dataset, n_clients,
                               cfg.get("samples_per_client", 128),
                               seed=cfg.get("seed", 0))

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

    results = run_roles(n_clients - 1, guest, host, arbiter)
    losses = results["arbiter"]
    phases = results["guest"]["phases"]

    out = {
        "loss_per_round": [round(float(v), 6) for v in losses],
        "phases": {k: {"total_s": round(v["total_s"], 4),
                       "count": v["count"]}
                   for k, v in phases.items()},
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flashe_tpu_torch",
        description="FLASHE secure-aggregation framework, PyTorch on CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_submit = sub.add_parser(
        "submit", help="run a federated training job from a JSON config")
    p_submit.add_argument("-c", "--config", required=True,
                          help="job config JSON (see examples/configs/)")
    p_submit.add_argument("--cpu", action="store_true",
                          help="run every role on the CPU")
    p_submit.add_argument("--json", action="store_true",
                          help="machine-readable result on stdout")
    p_submit.add_argument("--processes", action="store_true",
                          help="one OS process per party (not ported yet)")
    p_submit.add_argument("--checkpoint-dir",
                          help="save each client's final model (not ported "
                               "yet)")
    p_submit.add_argument("--publish",
                          help="register the guest's final model (not "
                               "ported yet)")
    p_submit.set_defaults(fn=cmd_submit)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
