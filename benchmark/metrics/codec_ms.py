"""The guest's "encoding" + "decoding" phases a window round, ms (codec
layer: flatten, normalize, ACIQ clip, stochastic rounding, and back)."""

from benchmark.metrics import phase_ms


def read(run):
    return phase_ms(run, "guest", ("encoding", "decoding"))
