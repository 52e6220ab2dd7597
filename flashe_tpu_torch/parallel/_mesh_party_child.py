"""Child worker: one mesh-party client process (port of
flashe_tpu/parallel/_mesh_party_child.py; see parallel/mesh_party.py).

Started by parallel.multihost.launch_local, or directly on each host:

    python flashe_tpu_torch/parallel/_mesh_party_child.py \
        --coordinator HOST:PORT --num-processes N --process-id I \
        [--rounds R --model mlp --samples S --data shard.npz] \
        [--devices cuda:0 --backend nccl | --devices cpu]

Prints `RESULT {json}` with this process's loss history and the global
model's digest (the same in every process when the round math is right).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--model-kwargs", default="{}")
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--data", default=None)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--int-bits", type=int, default=20)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--devices", default="cuda",
                    help="this process's device (one lane shard)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args()

    from flashe_tpu_torch.parallel.mesh_party import run_mesh_training

    devices = args.devices.split(",")
    if len(devices) != 1:
        raise SystemExit("a mesh party runs on one device")
    out = run_mesh_training(
        args.coordinator, args.num_processes, args.process_id,
        model=args.model, model_kwargs=json.loads(args.model_kwargs),
        rounds=args.rounds, samples=args.samples, data=args.data,
        learning_rate=args.learning_rate, int_bits=args.int_bits,
        verbose=args.verbose, device=devices[0], backend=args.backend)
    print("RESULT " + json.dumps(out))


if __name__ == "__main__":
    main()
