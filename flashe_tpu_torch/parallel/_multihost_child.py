"""Child worker of the multi-process check (port of
flashe_tpu/parallel/_multihost_child.py; started by
parallel.multihost.launch_local).

Each process stands for one party's host: it joins the process group with
the backend and devices it is given, owns one client row of the global
(clients, lanes) grid with its devices as lane shards, supplies only its
own quantized lanes, and runs the encrypted aggregate.  Every process then
checks the whole decrypted aggregate against the plain mod-2^20 sum
computed from the shared seed: a full round, then a round with the last
client dropped.  It prints its backend and devices, a digest of each
round's aggregate, which the single-process grid's must equal, and the
mask kernel's launches by mode.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SEED = bytes(range(32))
INT_BITS = 20


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--devices", default="cuda",
                    help="this process's lane-shard devices, comma-separated")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--elements", type=int, default=4000)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--bench", action="store_true",
                    help="print the steady round's wall time as well")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from flashe_tpu_torch.ops import aes, flashe_mask
    from flashe_tpu_torch.parallel import multihost
    from flashe_tpu_torch.parallel.sharded import padded_lane_count

    devices = args.devices.split(",")
    backend = multihost.init_multihost(args.coordinator, args.num_processes,
                                       args.process_id, args.backend,
                                       devices[0])
    print(f"process {args.process_id}: backend {backend}, devices "
          f"{devices}", flush=True)
    mesh = multihost.make_multihost_mesh(devices=devices)
    n_clients = mesh.shape["clients"]
    n_shards = mesh.shape["lanes"]
    assert n_clients == args.num_processes

    n = padded_lane_count(args.elements, INT_BITS, n_shards)
    rng = np.random.RandomState(0)  # shared seed: every process knows all q
    q_full = rng.randint(0, 1 << 16, (n_clients, n)).astype(np.uint32)
    rows = multihost.local_client_rows(mesh, n_clients)
    q_local = torch.from_numpy(q_full[rows].view(np.int32))
    rk = torch.from_numpy(aes.key_schedule(SEED).astype(np.int32))

    def sync():
        if mesh.devices[rows[0]][0].type == "cuda":
            torch.cuda.synchronize()

    def check(out, want, what):
        got = out.cpu().numpy().astype(np.int64)
        if not np.array_equal(got, want):
            raise AssertionError(f"process {args.process_id}: {what} "
                                 f"decrypt differs from the plain sum at "
                                 f"{int((got != want).sum())} lanes")

    multihost.coordination_barrier("ready")
    # round 0: full participation
    t0 = time.perf_counter()
    out = multihost.multihost_encrypted_aggregate(
        mesh, rk, q_local, 0, INT_BITS, n_clients)
    sync()
    dt0 = time.perf_counter() - t0
    check(out, q_full.astype(np.int64).sum(0) % (1 << INT_BITS), "round 0")
    d0 = digest(out)

    # round 1: dropout, the last client's ciphertext left out
    survivors = tuple(range(n_clients - 1)) if n_clients > 1 else (0,)
    out = multihost.multihost_encrypted_aggregate(
        mesh, rk, q_local, 1, INT_BITS, n_clients, survivors=survivors)
    sync()
    check(out, q_full[list(survivors)].astype(np.int64).sum(0)
          % (1 << INT_BITS), "dropout round")
    d1 = digest(out)

    if args.bench:
        reps = max(args.rounds, 3)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = multihost.multihost_encrypted_aggregate(
                mesh, rk, q_local, 0, INT_BITS, n_clients)
        sync()
        dt = (time.perf_counter() - t0) / reps
        print(f"BENCH process={args.process_id} round_s={dt:.6f} "
              f"elements={n} clients={n_clients}", flush=True)

    print(f"OK process={args.process_id} backend={backend} "
          f"devices={','.join(devices)} mesh={mesh.shape} lanes={n} "
          f"first_round_s={dt0:.3f} digest0={d0} digest1={d1} launches="
          f"{json.dumps(flashe_mask.mode_launches, separators=(',', ':'))}",
          flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
