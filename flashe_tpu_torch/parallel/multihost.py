"""Multi-process encrypted aggregation over torch.distributed (port of
flashe_tpu/parallel/multihost.py).

The replacement for the reference's cluster federation runtime
(arch/api/transfer/cluster.py:154-303: eggroll tables and a gRPC proxy
between parties): each party is one process owning a host's devices,
`torch.distributed` joins the processes, the client axis of the (clients,
lanes) grid maps to processes, and the arbiter's big-int reduce becomes
one `all_reduce` (SUM) on the int32 carrier, followed by the mask.
Counter-offset mask launches (parallel/sharded.py) make every (process,
device) pair encrypt exactly its slice of the mask streams, so the
multi-process aggregate is the single-process grid's and the federated
protocol's, bit for bit.

The JAX package's global array sharded over processes and its
`process_allgather` become a plain result: every process holds the whole
decrypted aggregate.  Nothing here picks a backend or a device by itself:
the caller names them (`init_multihost`: "nccl" for a process on a card,
"gloo" for one on the CPU, unless told otherwise), and `launch_local`
passes each child its devices and backend, "gloo" where more processes
than cards share the host's cards (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from flashe_tpu_torch.crypto.flashe import merge_idx_runs
from flashe_tpu_torch.device import (
    resolve_device, resolve_devices, visible_cards)
from flashe_tpu_torch.parallel.sharded import (
    Mesh, carrier_mask, decrypt_shard, decrypt_shard_runs, encrypt_shard)

__all__ = [
    "init_multihost", "make_multihost_mesh", "local_client_rows",
    "multihost_encrypted_aggregate", "coordination_barrier",
    "launch_local", "wait_group", "free_port", "placement",
]

_REPO = str(Path(__file__).resolve().parents[2])


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, backend: Optional[str] = None,
                   device="cuda",
                   initialization_timeout: float = 600.0) -> str:
    """Join the process group at tcp://coordinator_address as rank
    process_id of num_processes.  backend defaults to "nccl" for a
    process on a card (`device`, made its current card) and "gloo" for one
    on the CPU.  Returns the backend."""
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=initialization_timeout))
    return backend


def make_multihost_mesh(n_lane_shards: Optional[int] = None, devices=None):
    """The global (clients, lanes) grid: one row a process, each row that
    process's devices (every visible card by default) as its lane shards.
    Every process must bring as many devices."""
    devices = resolve_devices(devices)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, [str(d) for d in devices])
    counts = {len(r) for r in rows}
    if len(counts) != 1:
        raise ValueError(f"uneven devices per process: {rows}")
    per = counts.pop()
    if n_lane_shards is None:
        n_lane_shards = per
    if n_lane_shards != per:
        raise ValueError(f"n_lane_shards={n_lane_shards} != devices per "
                         f"process {per}")
    rows[dist.get_rank()] = devices
    return Mesh(rows)


def local_client_rows(mesh, num_clients: int) -> Sequence[int]:
    """Client-axis rows owned by this process (one a process)."""
    return [dist.get_rank()]


def coordination_barrier(name: str, timeout_s: float = 1200.0) -> None:
    """Wait until every process arrives (`name` labels the rendezvous in
    the JAX package's coordination service; torch's barrier needs none).
    """
    dist.barrier()


def _carrier_device() -> torch.device:
    """Where the all_reduce runs: the process's card under NCCL, the host
    under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def multihost_encrypted_aggregate(mesh, rk, q_local, iter_index,
                                  int_bits: int, num_clients: int,
                                  survivors=None) -> torch.Tensor:
    """One encrypted round where each process supplies only its client row
    (q_local: (1, N) int32): the multi-process counterpart of
    parallel.sharded.encrypted_aggregate.

    Each process encrypts its row's lane shards on its devices (zeroed if
    it is not among the survivors), one all_reduce sums every process's
    ciphertexts on the int32 carrier, the sum is masked to int_bits, and
    each process decrypts every lane shard on its device.  Returns the
    whole decrypted aggregate, (N,) int32, on the process's first device.
    """
    if num_clients << int_bits > (1 << 32):
        raise ValueError("num_clients * 2^int_bits must fit in uint32 psum")
    rows = local_client_rows(mesh, num_clients)
    devices = mesh.devices[rows[0]]
    n_shards = mesh.shape["lanes"]
    q_local = torch.as_tensor(q_local)
    n = q_local.shape[-1]
    ns = n // n_shards
    alive = set(range(num_clients) if survivors is None else survivors)
    carrier = _carrier_device()
    local = torch.zeros(n, dtype=torch.int32, device=carrier)
    for r, c in enumerate(rows):
        for s, dev in enumerate(devices):
            ct = encrypt_shard(rk, q_local[r, s * ns:(s + 1) * ns].to(dev),
                               iter_index, c, s, int_bits)
            if c in alive:  # a dropped client's ciphertext is left out
                local[s * ns:(s + 1) * ns] += ct.to(carrier)
    dist.all_reduce(local, op=dist.ReduceOp.SUM)
    agg = local & carrier_mask(int_bits)
    if survivors is not None:
        adds, minuses = merge_idx_runs(list(survivors))
    outs = []
    for s, dev in enumerate(devices):
        shard = agg[s * ns:(s + 1) * ns].to(dev)
        if survivors is None:
            outs.append(decrypt_shard(rk, shard, iter_index, num_clients, s,
                                      int_bits))
        else:
            outs.append(decrypt_shard_runs(rk, shard, iter_index, adds,
                                           minuses, s, int_bits))
    return torch.cat([o.to(devices[0]) for o in outs])


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def placement(n_processes: int, devices_per_process: int, device="cuda"):
    """(each process's devices, the backend) for n_processes on this
    host: on the CPU, the CPU repeated, under gloo; on the cards, process
    p's j-th device cuda:((p + j n_processes) mod cards), under NCCL where
    every process has a card of its own and under gloo where they share."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [["cpu"] * devices_per_process] * n_processes, "gloo"
    cards = len(visible_cards())
    devices = [[f"cuda:{(p + j * n_processes) % cards}"
                for j in range(devices_per_process)]
               for p in range(n_processes)]
    return devices, "nccl" if n_processes <= cards else "gloo"


def wait_group(procs: Sequence[subprocess.Popen],
               timeout: float) -> list:
    """Wait for a group of processes that meet in collectives: a process
    that fails leaves the others waiting in one, so stop them all then,
    or at the deadline.  Returns their exit codes (a negative code is the
    signal that stopped a process)."""
    deadline = time.monotonic() + timeout
    try:
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline
               and not any(p.poll() for p in procs)):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.wait() for p in procs]


def launch_local(n_processes: int, devices_per_process: int, script: str,
                 extra_args: Sequence[str] = (), timeout: float = 600.0,
                 device="cuda"):
    """Run `script` as n_processes coordinated local processes, each with
    --coordinator / --num-processes / --process-id, its --devices and its
    --backend (`placement`), plus extra_args.  Returns the children's
    outputs; raises on any nonzero exit or timeout with their output
    attached, and leaves no child running."""
    devices, backend = placement(n_processes, devices_per_process, device)
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    procs = []
    try:
        for pid in range(n_processes):
            cmd = [sys.executable, script,
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(n_processes),
                   "--process-id", str(pid),
                   "--devices", ",".join(devices[pid]),
                   "--backend", backend, *extra_args]
            log = tempfile.TemporaryFile("w+")
            procs.append((subprocess.Popen(cmd, env=env, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           text=True), log))
    except BaseException:
        wait_group([p for p, _ in procs], 0)
        raise
    wait_group([p for p, _ in procs], timeout)
    outs = []
    for p, log in procs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    failed = [(pid, p.returncode, out) for pid, ((p, _), out)
              in enumerate(zip(procs, outs)) if p.returncode != 0]
    if failed:
        msgs = "\n".join(f"-- process {pid} ({rc}):\n{out}"
                         for pid, rc, out in failed)
        raise RuntimeError(f"multihost children failed (a negative code is "
                           f"the signal that stopped it):\n{msgs}")
    return outs
