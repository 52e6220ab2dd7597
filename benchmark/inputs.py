"""The run's inputs from its seed, made by the benchmark and handed alike
to the program and to the reference: the initial model, the clients' rows,
the clients' trainer seeds and the agg traffic's update deltas."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import datasets
from benchmark.cells import derive_seed

__all__ = ["weights", "client_rows", "client_seeds", "delta_seed", "delta"]

# the uses of a run's seed
WEIGHTS, TRAINER, DELTA, SAMPLE = 1, 2, 3, 4


def weights(mod, model_cfg: dict, seed: int, device) -> dict:
    """{leaf name: float32 tensor on device}: one normal draw on the
    device for the whole model, scaled leaf by leaf by the reference
    model's init_scale."""
    shapes = mod.leaves(model_cfg)
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in names]
    gen = torch.Generator(device).manual_seed(derive_seed(seed, WEIGHTS))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([mod.init_scale(k, shapes[k]) for k in names],
                     dtype=torch.float32, device=device),
        torch.tensor(sizes, device=device))
    flat = flat * scale
    out, at = {}, 0
    for k, size in zip(names, sizes):
        out[k] = flat[at:at + size].reshape(shapes[k]).clone()
        at += size
    return out


def client_rows(config: dict, seed: int):
    return datasets.make(config["data"], int(config["n_clients"]),
                         int(config["samples_per_client"]), seed)


def client_seeds(seed: int, n: int):
    """Each client's trainer seed (its shuffling and its dropout)."""
    return [derive_seed(seed, TRAINER, i) for i in range(n)]


def delta_seed(seed: int, client: int, rnd: int) -> int:
    return (derive_seed(seed, DELTA, client) + rnd) % (1 << 63)


def delta(gen: torch.Generator, seed: int, client: int, rnd: int,
          base: torch.Tensor, std: float) -> torch.Tensor:
    """An agg client's update in round rnd: its model plus a seeded normal
    delta of standard deviation std (float32, as the client sends it)."""
    gen.manual_seed(delta_seed(seed, client, rnd))
    return base + torch.randn(base.shape, generator=gen,
                              device=base.device) * std
