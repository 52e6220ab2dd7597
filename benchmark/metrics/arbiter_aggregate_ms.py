"""The arbiter's "aggregate" phase a window round, ms (the mod-2^m sum)."""

from benchmark.metrics import phase_ms


def read(run):
    return phase_ms(run, "arbiter", ("aggregate",))
