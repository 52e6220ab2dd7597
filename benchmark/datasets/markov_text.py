"""A seeded stand-in for LEAF's Shakespeare shards (`shakespeare_10`, not in
the repository), the arithmetic of the program's
data/shakespeare.py::write_markov_corpus without its CSV round trip: each
row a walk of `min_len` to seq_len + 1 tokens of an order-1 Markov chain
over tokens 1..vocab-1 whose transition rows are Dirichlet(`dirichlet`)
draws, zero-padded; x is the first seq_len tokens, y the next.  Every seed
gives the same sizes; the lengths vary from row to row, the work of a
padded row does not."""

from __future__ import annotations

import numpy as np

__all__ = ["make"]


def make(spec: dict, n_clients: int, rows: int, seed: int):
    rng = np.random.default_rng([seed % (1 << 64), 12])
    k = int(spec["vocab"]) - 1
    width = int(spec["seq_len"]) + 1
    cum = np.cumsum(rng.dirichlet(np.full(k, float(spec["dirichlet"])),
                                  size=k), axis=1)
    out = []
    for _ in range(n_clients):
        seq = np.zeros((rows, width), np.int32)
        cur = rng.integers(0, k, rows)
        seq[:, 0] = cur + 1
        for t in range(1, width):
            u = rng.random(rows)[:, None]
            cur = np.minimum((u > cum[cur]).sum(axis=1), k - 1)
            seq[:, t] = cur + 1
        lengths = rng.integers(int(spec["min_len"]), width + 1, rows)
        seq[np.arange(width)[None, :] >= lengths[:, None]] = 0
        out.append((seq[:, :-1].copy(), seq[:, 1:].copy()))
    return out
