"""The share of the window's device-idle time in which at least one role
still running was outside every record of the program, %: work no span
names, the benchmark's own included (benchmark/spans.py::idle_split;
device layer)."""

from benchmark.spans import idle_split


def read(run):
    split = idle_split(run)
    if split is None or split[2] <= 0:
        return None
    return split[1] / split[2] * 100.0
