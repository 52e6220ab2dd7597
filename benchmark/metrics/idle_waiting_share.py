"""The share of the window's device-idle time in which every role still
running was inside a "fed.get", waiting on a message, %
(benchmark/spans.py::idle_split; device layer)."""

from benchmark.spans import idle_split


def read(run):
    split = idle_split(run)
    if split is None or split[2] <= 0:
        return None
    return split[0] / split[2] * 100.0
