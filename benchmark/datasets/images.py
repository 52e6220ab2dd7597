"""Synthetic images in FEMNIST's shape: pixels uniform in [0, 1), labels
uniform over the classes, drawn from the seed (FEMNIST itself is not in the
repository)."""

from __future__ import annotations

import numpy as np

__all__ = ["make"]


def make(spec: dict, n_clients: int, rows: int, seed: int):
    rng = np.random.default_rng([seed % (1 << 64), 11])
    shape = tuple(spec["shape"])
    x = rng.random((n_clients, rows) + shape, dtype=np.float32)
    y = rng.integers(0, spec["classes"], (n_clients, rows), dtype=np.int32)
    return [(x[i], y[i]) for i in range(n_clients)]
