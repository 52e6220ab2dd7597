"""The guest's "local train" phase a window round, ms (trainer layer)."""

from benchmark.metrics import phase_ms


def read(run):
    return phase_ms(run, "guest", ("local train",))
