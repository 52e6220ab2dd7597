"""Federated dataset utilities (port of flashe_tpu/data/__init__.py, numpy
only: the same seed gives the same bytes as the JAX package).

The reference ships CSV datasets ingested through eggroll DTables
(fate_flow/utils/upload.py, federatedml/util/data_io.py); large blobs are
stripped from its repo.  Here: deterministic synthetic generators shaped
like the three workloads (femnist 28x28x1/62-way, cifar 32x32x3/10-way,
shakespeare char sequences) plus an IID/shard partitioner, so every
example and test is self-contained.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["synthetic_dataset", "partition_iid", "federated_dataset"]


def synthetic_dataset(kind: str, n: int, seed: int = 0):
    """Returns (x, y) with task-appropriate shapes and learnable signal."""
    rng = np.random.RandomState(seed)
    if kind in ("femnist", "cnn"):
        y = rng.randint(0, 62, n)
        x = rng.randn(n, 28, 28, 1).astype(np.float32) * 0.3
        # class-dependent mean shift so models can learn
        x += (y[:, None, None, None] % 7 - 3) * 0.1
        return x, y.astype(np.int32)
    if kind in ("cifar", "resnet"):
        y = rng.randint(0, 10, n)
        x = rng.randn(n, 32, 32, 3).astype(np.float32) * 0.3
        x += (y[:, None, None, None] - 4.5) * 0.05
        return x, y.astype(np.int32)
    if kind in ("shakespeare", "lstm"):
        vocab, seq = 80, 80
        x = rng.randint(0, vocab, (n, seq)).astype(np.int32)
        y = ((x[:, -1] + 1) % vocab).astype(np.int32)  # learnable rule
        return x, y
    if kind == "mlp":
        y = rng.randint(0, 10, n)
        x = rng.randn(n, 32).astype(np.float32)
        x[np.arange(n), y] += 2.0
        return x, y.astype(np.int32)
    raise ValueError(f"unknown dataset kind {kind}")


def partition_iid(x: np.ndarray, y: np.ndarray, n_clients: int,
                  seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(x))
    shards = np.array_split(perm, n_clients)
    return [(x[s], y[s]) for s in shards]


def federated_dataset(kind: str, n_clients: int, n_per_client: int,
                      seed: int = 0):
    x, y = synthetic_dataset(kind, n_clients * n_per_client, seed)
    return partition_iid(x, y, n_clients, seed)
