"""Torch twins of the entry points of the repository's __graft_entry__.py.

- entry(): the forward step of the flagship model (FEMNIST CNN, the
  reference's headline workload) with its parameters and an input, for a
  single-device check.
- dryrun_multichip(n): one full federated training step on a grid of n
  devices (clients x lane shards): local SGD, quantize, FLASHE encrypt of
  each lane shard, the sum over the clients, the boundary-mask decrypt,
  unquantize, the global model update; then a dropout round on the same
  grid, whose decrypt must equal the survivors' plain sum.

The split and the model follow __graft_entry__.py: 8 devices or more run
FemnistCNN (1,206,590 parameters) on 4 clients x n // 4 shards, fewer run
an MLP on 2 clients (1 below 2).  Divergence: the stochastic rounding's
uniforms come from torch.Generators, not threefry, and the grid may repeat
a device (a host with one card runs dryrun_multichip(8, ["cuda:0"] * 8)).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from flashe_tpu_torch.device import resolve_devices, visible_cards

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """(forward, (params, x)): forward(params, x) loads the flax-layout
    params into FemnistCNN on `device` and returns its eval logits."""
    from flashe_tpu_torch.nn.models import FemnistCNN, init_params

    model = FemnistCNN(device=device).eval()
    x = torch.zeros((8, 28, 28, 1), dtype=torch.float32, device=model.device)
    params = init_params(model, x, seed=0)

    @torch.no_grad()
    def forward(params, x):
        model.params_from_flax(params)
        return model(torch.as_tensor(x).to(model.device))

    return forward, (params, x)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One federated step on n_devices of `devices` (every visible card by
    default, which may repeat); prints one line and raises if a value is
    not finite or the survivor decrypt is off."""
    from flashe_tpu_torch.nn.models import MLP, FemnistCNN, init_params
    from flashe_tpu_torch.nn.weights import WeightsCodec
    from flashe_tpu_torch.ops import aes
    from flashe_tpu_torch.parallel.sharded import (
        encrypted_aggregate, make_mesh, padded_lane_count)

    devices = resolve_devices(devices)[:n_devices]
    int_bits, eb = 20, 16
    # more clients than lane shards: 8 devices = 4 clients x 2 shards
    n_clients = 4 if n_devices >= 8 else (2 if n_devices >= 2 else 1)
    n_shards = max(n_devices // n_clients, 1)
    mesh = make_mesh(n_clients, n_shards, devices)
    home = mesh.devices[0][0]

    def build():
        if n_devices >= 8:
            return FemnistCNN(device=home), (4, 28, 28, 1), 62
        return MLP(features=(32, 8), device=home), (4, 8), 8

    model, x_shape, n_classes = build()
    model.eval()  # flax's apply without train=True: no dropout
    params = init_params(model, torch.zeros(x_shape), seed=0)
    codec = WeightsCodec(params, device=home)
    n_lanes = padded_lane_count(codec.total, int_bits, n_shards)
    rk = torch.from_numpy(aes.key_schedule(bytes(range(32))).astype(np.int32))
    alpha, lr, qscale = 1.0, 0.1, float((1 << eb) - 1)

    flat0 = codec.flatten(params)
    rng = np.random.RandomState(0)
    xs = rng.randn(n_clients, *x_shape).astype(np.float32)
    ys = rng.randint(0, n_classes, (n_clients, x_shape[0])).astype(np.int64)

    # each client: one local SGD step from the global model, then the
    # quantizer's stochastic rounding into eb-bit lanes
    q = torch.zeros((n_clients, n_lanes), dtype=torch.int32, device=home)
    for c in range(n_clients):
        model.params_from_flax(codec.unflatten(flat0))
        model.zero_grad(set_to_none=True)
        logits = model(torch.from_numpy(xs[c]).to(home))
        F.cross_entropy(logits, torch.from_numpy(ys[c]).to(home)).backward()
        g = codec.flatten(model.flax_view(
            {k: p.grad for k, p in model.named_parameters()}))
        local = flat0 - lr * g
        u = torch.rand(codec.total, generator=torch.Generator().manual_seed(
            7 + c)).to(home)
        q[c, :codec.total] = torch.floor(
            (torch.clamp(local, -alpha, alpha) + alpha) * qscale
            / (2 * alpha) + u).int()

    # FLASHE encrypt -> sum over the clients -> decrypt, on the grid
    dec = encrypted_aggregate(mesh, rk, q, 0, int_bits, n_clients)
    a_n = alpha * n_clients
    avg = ((dec[:codec.total].float() * (2 * a_n) / (qscale * n_clients)
            - a_n) / n_clients)
    if not bool(torch.isfinite(avg).all()):
        raise AssertionError("multichip dryrun produced non-finite")
    model.params_from_flax(codec.unflatten(avg.to(home)))

    # dropout on the grid: the survivors' aggregate must equal their
    # plain mod-2^m sum (run-merged boundary decrypt)
    if n_clients > 1:
        survivors = tuple(range(n_clients - 1))
        qd = np.random.RandomState(3).randint(
            0, 1 << eb, (n_clients, n_lanes)).astype(np.int32)
        dec = encrypted_aggregate(mesh, rk, torch.from_numpy(qd), 1,
                                  int_bits, n_clients, survivors=survivors)
        want = qd[list(survivors)].astype(np.int64).sum(0) % (1 << int_bits)
        if not np.array_equal(dec.cpu().numpy().astype(np.int64), want):
            raise AssertionError("mesh survivor decrypt mismatch")

    print(f"dryrun_multichip ok: mesh={mesh.shape} "
          f"model={type(model).__name__} params={codec.total} "
          f"lanes={n_lanes} survivors_checked={n_clients > 1}")


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    dryrun_multichip(len(visible_cards()))
