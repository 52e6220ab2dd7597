"""Seeded client rows, one module a kind, found by the name a
configuration's `data.kind` gives.  Each has `make(spec, n_clients, rows,
seed) -> [(x, y)]`, numpy arrays on the host, as a job's shards are."""

import importlib

__all__ = ["make"]


def make(spec: dict, n_clients: int, rows: int, seed: int):
    mod = importlib.import_module(f"benchmark.datasets.{spec['kind']}")
    return mod.make(spec, n_clients, rows, seed)
