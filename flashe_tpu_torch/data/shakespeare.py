"""Shakespeare next-char dataset (port of flashe_tpu/data/shakespeare.py,
numpy only).

The reference ships `examples/dataset/shakespeare_10/`: ten CSVs of
81-token character sequences (82 columns: id + x1..x81, zero-padded,
vocab 83 including pad=0) for the Shakespeare+LSTM workload
(examples/configs/lstm_*).  Files `0_a.csv`..`8_a.csv` are the nine
client training shards; `b.csv` is held out for evaluation (the
reference's committed confs are templates with dataset names rewritten
at deploy time, so the file->party mapping is by filename convention).

Label construction mirrors KerasSequenceData with create_label=True
(jzf_nn_model.py:238-250): x = seq[:-1], y = seq[1:] — per-position
next-token prediction over 80 steps.  The loaders return numpy arrays;
the trainer moves them to its device.

DEFAULT_ROOT is where the reference keeps the dataset, under this
repository's root: `examples/dataset/shakespeare_10` (the JAX package
points at a checkout of the reference instead).  The dataset is not in
the repository; pass another root to read it from elsewhere, or write
a seeded stand-in in its format with `write_markov_corpus`.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from flashe_tpu_torch.data.io import read_dense_csv

__all__ = ["DEFAULT_ROOT", "VOCAB", "SEQ_LEN", "load_shard",
           "load_clients", "load_eval", "write_markov_corpus"]

DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "examples", "dataset", "shakespeare_10")
VOCAB = 83  # nn_define Embedding input_dim (pad token 0 included)
SEQ_LEN = 80


def load_shard(path: str, limit: int | None = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One CSV -> (x, y) int32 arrays of shape (n, 80)."""
    feats, _ids = read_dense_csv(path, label_index=0, label_type="int")
    seq = feats.astype(np.int32)
    if limit:
        seq = seq[:limit]
    return seq[:, :-1], seq[:, 1:]


def load_clients(root: str = DEFAULT_ROOT, n_clients: int = 9,
                 limit: int | None = None
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    return [load_shard(os.path.join(root, f"{i}_a.csv"), limit)
            for i in range(n_clients)]


def load_eval(root: str = DEFAULT_ROOT, limit: int | None = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    return load_shard(os.path.join(root, "b.csv"), limit)


def write_markov_corpus(root: str, n_clients: int = 9, rows: int = 512,
                        seed: int = 0, min_len: int = 20) -> None:
    """A seeded stand-in for shakespeare_10 in its CSV format: files
    `0_a.csv`..`{n_clients - 1}_a.csv` and `b.csv` under `root`, `rows`
    rows each, header `id,x1..x81`.  A row is a walk of `min_len` to 81
    tokens of an order-1 Markov chain over tokens 1..82 whose transitions
    are peaked (each row of the transition matrix a Dirichlet(0.02) draw),
    so that a next-token loss can fall, zero-padded to 81 tokens."""
    rng = np.random.RandomState(seed)
    k = VOCAB - 1
    cum = np.cumsum(rng.dirichlet(np.full(k, 0.02), size=k), axis=1)
    width = SEQ_LEN + 1
    os.makedirs(root, exist_ok=True)
    header = "id," + ",".join(f"x{i}" for i in range(1, width + 1))
    for name in [f"{i}_a.csv" for i in range(n_clients)] + ["b.csv"]:
        seq = np.zeros((rows, width), np.int64)
        cur = rng.randint(0, k, rows)
        seq[:, 0] = cur + 1
        for t in range(1, width):
            u = rng.random_sample(rows)[:, None]
            cur = np.minimum((u > cum[cur]).sum(axis=1), k - 1)
            seq[:, t] = cur + 1
        lengths = rng.randint(min_len, width + 1, rows)
        seq[np.arange(width)[None, :] >= lengths[:, None]] = 0
        with open(os.path.join(root, name), "w") as f:
            f.write(header + "\n")
            for i, row in enumerate(seq):
                f.write(f"{i}," + ",".join(map(str, row)) + "\n")
